"""The port's growing KV cache (``LlamaEngine(auto_grow=True)``) against
the JAX package, in f32 on the CPU, as tests/test_serving.py holds JAX's.

An engine built at a small max_len doubles its cache when a slot would
write past it (a decode, a verify, a prompt longer than the cache), up to
``grow_limit``. Its greedy tokens equal those of an engine built big enough
never to grow, and JAX's; a growth copies every layer's rows, or an int8
cache's codes and scale planes, bit for bit; an ALiBi FalconEngine rebuilds
its bias at the grown length; a SpecDecoder grows both of its engines.
The tiny models are those of tests/test_torch_spec_decode.py.
"""
import numpy as np
import pytest
import torch

from omniquant_tpu_torch.serving import SpecDecoder

from test_torch_spec_decode import jax_greedy, one_torch_thread  # noqa: F401
from test_torch_spec_decode import port_engine

PROMPT = [5, 17, 99, 3]


def _cache_bufs(eng):
    c = eng.cache
    return [t for bufs in (c.k, c.v, c.k_scale, c.v_scale) if bufs
            for t in bufs]


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_grown_tokens_equal_a_big_engine_and_jax(kv):
    """max_len 16 grows to 32 and then 64 during generate (prompt 4 + 40
    tokens): the tokens of an engine built at 64 and of JAX's."""
    n_new = 40
    small = port_engine(max_batch=1, max_len=16, kv_dtype=kv, auto_grow=True)
    got = small.generate(PROMPT, max_new_tokens=n_new)
    big = port_engine(max_batch=1, max_len=64, kv_dtype=kv)
    assert small.max_len == 64
    assert got == big.generate(PROMPT, max_new_tokens=n_new)
    assert got == jax_greedy("llama", PROMPT, n_new, kv=kv, max_len=64)
    assert all(t.shape[2] == 64 for t in _cache_bufs(small))


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_growth_copies_rows_codes_and_planes(kv):
    """_grow keeps each buffer's contents at [:, :, :old max_len] bit for
    bit (codes and f32 planes for int8) and zeros past it."""
    eng = port_engine(max_batch=2, max_len=16, kv_dtype=kv, auto_grow=True)
    slots = eng.add_requests([PROMPT, [9, 8, 7, 6, 5, 4, 3]])
    eng.step_n({s: eng._pending_next[s] for s in slots}, 3)
    before = [t.clone() for t in _cache_bufs(eng)]
    assert any(t.abs().sum() > 0 for t in before)
    eng._check_capacity(slots, 16 - 10 + 1)  # slot 1 at 10 rows: 17 > 16
    assert eng.max_len == 32
    for old, new in zip(before, _cache_bufs(eng)):
        assert new.shape[2] == 32 and new.dtype == old.dtype
        assert torch.equal(new[:, :, :16], old)
        assert not new[:, :, 16:].any()


def test_long_prompt_grows_at_prefill_and_grow_limit_raises():
    """A prompt whose bucket (32) exceeds max_len 16 grows the cache before
    the prefill; growth past grow_limit (cfg.max_position_embeddings, 256,
    or the one given) raises naming it."""
    prompt = list(range(2, 30))
    eng = port_engine(max_batch=1, max_len=16, auto_grow=True)
    got = eng.generate(prompt, max_new_tokens=4)
    assert eng.max_len == 32
    assert got == port_engine(max_batch=1, max_len=64).generate(
        prompt, max_new_tokens=4)
    assert got == jax_greedy("llama", prompt, 4, max_len=64)
    assert eng.grow_limit == 256
    with pytest.raises(RuntimeError, match="grow_limit"):
        eng._grow(4096)
    capped = port_engine(max_batch=1, max_len=16, auto_grow=True,
                         grow_limit=32)
    with pytest.raises(RuntimeError, match="grow_limit=32"):
        capped.generate(PROMPT, max_new_tokens=40)
    assert capped.max_len == 32
    with pytest.raises(RuntimeError, match="enable auto_grow"):
        port_engine(max_batch=1, max_len=16).generate(prompt, 2)


def test_alibi_falcon_grows_its_bias():
    """An ALiBi FalconEngine at max_len 16 grows to 64: its f32 bias is
    rebuilt over the new length, and its tokens are JAX's."""
    eng = port_engine("falcon", "alibi", max_batch=1, max_len=16,
                      auto_grow=True)
    assert eng._bias.shape[-1] == 16
    got = eng.generate(PROMPT, max_new_tokens=40)
    assert eng.max_len == 64 and eng._bias.shape[-1] == 64
    assert got == jax_greedy("falcon", PROMPT, 40, form="alibi", max_len=64)
    big = port_engine("falcon", "alibi", max_batch=1, max_len=64)
    torch.testing.assert_close(eng._bias, big._bias, rtol=0, atol=0)


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_spec_generate_across_growth(kv):
    """SpecDecoder.generate on an auto_grow target at max_len 16: both
    engines grow (spec_steps asks for rounds x (gamma + 1) rows of each),
    and the stream is JAX's greedy stream."""
    sd = SpecDecoder(port_engine(max_len=16, kv_dtype=kv, auto_grow=True),
                     draft_layers=1, gamma=3)
    assert sd.draft.auto_grow and sd.draft.grow_limit == 256
    got = sd.generate(PROMPT, max_new_tokens=40)
    assert sd.target.max_len == sd.draft.max_len == 64
    assert got == jax_greedy("llama", PROMPT, 40, kv=kv, max_len=64)
    assert np.isfinite(sd.acceptance_rate) and sd.proposed > 0
