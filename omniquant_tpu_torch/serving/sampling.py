"""Token sampling for the serving engine (greedy, temperature, top-k,
top-p), per slot. Counterpart of ``omniquant_tpu/serving/sampling.py``.

Draws come from a ``torch.Generator``; they cannot reproduce
``jax.random.categorical``'s bits, so the two packages agree on the filtered
distribution and on greedy choices, not on raw draws."""
from __future__ import annotations

import torch


def filtered_logits(logits, temperature, top_k, top_p) -> torch.Tensor:
    """Temperature-scaled f32 logits with everything outside each row's
    top-k and nucleus set to -inf. top_k 0 (or >= V) and top_p 1.0
    disable their filters; the nucleus keeps the token that crosses top_p."""
    logits = logits.float()
    V = logits.shape[-1]
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = logits / temp
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where((top_k <= 0) | (top_k >= V), torch.full_like(top_k, V), top_k)
    kth = torch.gather(sorted_desc, -1, (k.long() - 1)[:, None])
    keep = scaled >= kth
    probs_desc = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_desc, dim=-1)
    in_nucleus = (cum - probs_desc) < top_p.float()[:, None]
    inf = torch.full_like(sorted_desc, float("inf"))
    cutoff = torch.where(in_nucleus, sorted_desc, inf).amin(dim=-1, keepdim=True)
    keep = keep & (scaled >= cutoff)
    return torch.where(keep, scaled, torch.full_like(scaled, float("-inf")))


def sample_tokens(logits, generator: torch.Generator, temperature, top_k,
                  top_p) -> torch.Tensor:
    """One token per row of ``logits`` (B, V); (B,) int32. Rows with
    temperature <= 0 take the argmax."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(filtered_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    drawn = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature <= 0.0, greedy, drawn.to(torch.int32))
