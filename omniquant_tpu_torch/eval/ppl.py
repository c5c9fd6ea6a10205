"""Strided-window perplexity, counterpart of ``omniquant_tpu/eval/ppl.py``.

Non-overlapping ``seqlen`` windows of the test stream, each scored by the
family's forward: the shifted cross-entropy with the log-softmax in f32,
times ``seqlen``, summed over the windows; ppl = exp(sum / (nsamples *
seqlen)), the reference OmniQuant's formula, so the numbers compare.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.common import NO_ACT_QUANT, ActQuantSpec, embedding_device
from ..models.registry import ModelFamily


def evaluate_ppl(family: ModelFamily, params: dict, model_cfg, test_tokens,
                 seqlen: int = 2048, spec: ActQuantSpec = NO_ACT_QUANT,
                 limit: Optional[int] = None, logger=None) -> float:
    """Perplexity of ``params`` on ``test_tokens`` ((1, total) integer),
    computed on the device of the token embeddings in their dtype (a
    packed model's linears run its kernels, or the integer route when
    ``spec.act`` is enabled). With ``limit``, the loop stops after window
    ``limit`` but the divisor stays the full ``nsamples``, as in the
    reference (its limited runs compare only with its own)."""
    del logger  # the JAX counterpart takes one and logs nothing either
    device = embedding_device(params)
    test_tokens = np.asarray(test_tokens).reshape(-1)
    nsamples = test_tokens.shape[0] // seqlen
    nlls = []
    with torch.inference_mode():
        for i in range(nsamples):
            window = torch.as_tensor(
                test_tokens[i * seqlen: (i + 1) * seqlen].astype(np.int64),
                device=device)
            logits = family.forward(params, window[None], model_cfg, spec)
            logp = torch.log_softmax(logits[0, :-1].float(), dim=-1)
            nll = -logp.gather(-1, window[1:, None]).mean()
            nlls.append(nll * seqlen)
            if limit is not None and i == limit:
                break
        return float(torch.exp(torch.stack(nlls).sum()
                               / (nsamples * seqlen)))
