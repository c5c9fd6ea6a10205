"""The port's token sampling against the JAX package's. A torch.Generator
cannot reproduce jax.random's bits, so the two are held to the same greedy
choices and the same filtered distribution."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.serving.sampling import sample_tokens as j_sample
from omniquant_tpu_torch.serving.sampling import (
    filtered_logits, sample_tokens as t_sample)


def _controls(B, temperature, top_k, top_p):
    return (np.full(B, temperature, np.float32), np.full(B, top_k, np.int32),
            np.full(B, top_p, np.float32))


def _port(logits, gen, controls):
    return t_sample(torch.from_numpy(logits), gen,
                    *(torch.from_numpy(c) for c in controls)).numpy()


def _jax(logits, seed, controls):
    return np.asarray(j_sample(jnp.asarray(logits), jax.random.PRNGKey(seed),
                               *(jnp.asarray(c) for c in controls)))


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (5.0, 1)])
def test_greedy_cases_equal_jax(temperature, top_k):
    """temperature 0, and top-k 1 at any temperature, are the argmax."""
    logits = np.random.default_rng(0).standard_normal((6, 50)).astype(
        np.float32)
    controls = _controls(6, temperature, top_k, 1.0)
    gen = torch.Generator().manual_seed(0)
    got = _port(logits, gen, controls)
    np.testing.assert_array_equal(got, _jax(logits, 0, controls))
    np.testing.assert_array_equal(got, logits.argmax(-1))


def _filtered_probs(logits, temperature, top_k, top_p):
    """numpy oracle: softmax over the top-k and nucleus-filtered logits."""
    z = logits.astype(np.float64) / temperature
    order = np.argsort(-z)
    keep = np.zeros_like(z, bool)
    keep[order[:top_k or len(z)]] = True
    p = np.exp(z[order] - z[order].max())
    p /= p.sum()
    before = np.cumsum(p) - p
    keep[order[before >= top_p]] = False
    out = np.where(keep, np.exp(z - z.max()), 0.0)
    return out / out.sum()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (1.0, 6, 0.9)])
def test_distribution_matches_filtered_softmax(temperature, top_k, top_p):
    """Empirical frequencies of the port's and the JAX package's draws both
    match the filtered softmax within 4 binomial standard deviations."""
    V, n = 12, 40000
    logits = np.random.default_rng(1).standard_normal(V).astype(np.float32)
    want = _filtered_probs(logits, temperature, top_k, top_p)
    f = filtered_logits(torch.from_numpy(logits[None]),
                        torch.tensor([temperature]), torch.tensor([top_k]),
                        torch.tensor([top_p]))
    np.testing.assert_allclose(torch.softmax(f, -1)[0].numpy(), want,
                               rtol=1e-5, atol=1e-7)
    rows = np.broadcast_to(logits, (n, V)).copy()
    controls = _controls(n, temperature, top_k, top_p)
    gen = torch.Generator().manual_seed(1)
    port = np.bincount(_port(rows, gen, controls), minlength=V) / n
    jx = np.bincount(_jax(rows, 1, controls), minlength=V) / n
    sd = np.sqrt(want * (1 - want) / n) + 1e-12
    for freq in (port, jx):
        assert np.all(freq[want == 0] == 0)
        assert np.all(np.abs(freq - want) <= 4 * sd + 1e-9)


def test_mixed_greedy_and_sampled_rows():
    logits = np.random.default_rng(2).standard_normal((4, 30)).astype(
        np.float32)
    temps = np.asarray([0.0, 1.0, 0.0, 1.0], np.float32)
    controls = (temps, np.zeros(4, np.int32), np.ones(4, np.float32))
    got = _port(logits, torch.Generator().manual_seed(3), controls)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[[0, 2]], logits.argmax(-1)[[0, 2]])
