"""LM response cache + device-free dummy backend.

CachingLM: sqlite-backed request->response cache wrapping any LM
(reference lm_eval/base.py:783-840 used SqliteDict; stdlib sqlite3 here).
DummyLM: random responses for harness smoke tests with no device
(reference lm_eval/models/dummy.py:5-36).
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import sqlite3
from typing import List, Tuple

from .base import LM


class CachingLM(LM):
    """fingerprint: an identity string for the WRAPPED model + quant
    config. It is mixed into every cache key, so one sqlite file reused
    across different models/schemes can never return another config's
    scores (without it, a --wbits 3 re-run against a --wbits 4 cache
    would silently report the W4 accuracies)."""

    def __init__(self, lm: LM, cache_db: str, fingerprint: str = ""):
        self.lm = lm
        self.fingerprint = fingerprint
        os.makedirs(os.path.dirname(os.path.abspath(cache_db)), exist_ok=True)
        self.conn = sqlite3.connect(cache_db)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS cache (key TEXT PRIMARY KEY, "
            "value TEXT)")
        self.conn.commit()

    def _key(self, reqtype: str, args) -> str:
        payload = json.dumps([self.fingerprint, reqtype, list(args)],
                             sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()

    def _cached_call(self, reqtype: str, requests):
        keys = [self._key(reqtype, args) for args in requests]
        cached = {}
        for k in keys:
            row = self.conn.execute(
                "SELECT value FROM cache WHERE key=?", (k,)).fetchone()
            if row is not None:
                cached[k] = json.loads(row[0])
        missing = [
            (k, args) for k, args in zip(keys, requests) if k not in cached
        ]
        if missing:
            fresh = getattr(self.lm, reqtype)([args for _, args in missing])
            for (k, _), resp in zip(missing, fresh):
                cached[k] = resp
                self.conn.execute(
                    "INSERT OR REPLACE INTO cache VALUES (?, ?)",
                    (k, json.dumps(resp)))
            self.conn.commit()
        out = []
        for k in keys:
            v = cached[k]
            out.append(tuple(v) if isinstance(v, list) else v)
        return out

    def loglikelihood(self, requests):
        return self._cached_call("loglikelihood", requests)

    def loglikelihood_rolling(self, requests):
        return self._cached_call("loglikelihood_rolling", requests)

    def greedy_until(self, requests):
        return self._cached_call("greedy_until", requests)


class DummyLM(LM):
    """Random logprobs / 'lol' generations (reference lm_eval/models/dummy.py)."""

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        return [(-random.random(), False) for _ in requests]

    def loglikelihood_rolling(self, requests) -> List[float]:
        return [-random.random() for _ in requests]

    def greedy_until(self, requests) -> List[str]:
        return ["lol" for _ in requests]
