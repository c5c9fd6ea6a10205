"""Calibration data: seeded windows of a token stream.

Counterpart of ``omniquant_tpu/calib/data.py``. ``sample_windows`` draws
window starts with Python's ``random.Random(seed).randint`` in the same
order as the JAX package (and the reference OmniQuant loaders), so the same
tokenized corpus gives the same windows. ``get_synthetic`` is the
network-free corpus; the named corpora (wikitext2, ptb, c4, pile) are read
from the hub by the JAX package and are not ported until local copies of
their files are in the repository.

Each loader returns (train_windows int32 (nsamples, seqlen), test_tokens
int32 (1, total_len)) as numpy arrays.
"""
from __future__ import annotations

import random

import numpy as np

# corpus -> the files a local loader would read
_WAITING = {
    "wikitext2": "wikitext-2-raw-v1 train/test text",
    "ptb": "penn_treebank train/validation/test sentences",
    "c4": "c4 en/c4-train.00000-of-01024.json.gz and "
          "en/c4-validation.00000-of-00008.json.gz",
    "pile": "the Pile's val.jsonl.zst",
    "mix": "the wikitext2, ptb and c4 files",
}


def sample_windows(token_ids, nsamples: int, seed: int,
                   seqlen: int) -> np.ndarray:
    """``nsamples`` windows of ``seqlen`` tokens, each start drawn by
    ``random.Random(seed).randint(0, len - seqlen - 1)`` in order."""
    token_ids = np.asarray(token_ids).reshape(-1)
    rng = random.Random(seed)
    out = np.empty((nsamples, seqlen), dtype=np.int32)
    for s in range(nsamples):
        i = rng.randint(0, token_ids.shape[0] - seqlen - 1)
        out[s] = token_ids[i: i + seqlen]
    return out


def get_synthetic(nsamples, seed, seqlen, vocab_size=256, total_len=200_000,
                  phrase_len=512, noise=0.1):
    """A fixed random phrase tiled with token noise (10 % of tokens by
    default), split 90/10 into train and test; deterministic in (seed,
    sizes). Every window is a noisy, shifted view of the same phrase."""
    rng = np.random.default_rng(seed)
    phrase = rng.integers(0, vocab_size, size=phrase_len)
    reps = total_len // phrase_len + 1
    stream = np.tile(phrase, reps)[:total_len]
    noise_toks = rng.integers(0, vocab_size, size=total_len)
    flip = rng.random(total_len) < noise
    corpus = np.where(flip, noise_toks, stream).astype(np.int32)
    split = int(total_len * 0.9)
    train, test = corpus[:split], corpus[split:]
    return sample_windows(train, nsamples, seed, seqlen), test[None]


def get_loaders(name: str, nsamples=128, seed=0, seqlen=2048, tokenizer=None,
                vocab_size: int = 256):
    """(train_windows, test_tokens) of the corpus ``name``; only
    "synthetic" is available in this package."""
    if "synthetic" in name:
        return get_synthetic(nsamples, seed, seqlen, vocab_size)
    for corpus, files in _WAITING.items():
        if corpus in name:
            raise NotImplementedError(
                f"dataset '{name}' needs a local copy of {files}, which the "
                "repository does not hold; use 'synthetic'")
    raise ValueError(f"unknown dataset {name}")
