"""Cross-process serving: data-parallel continuous batching across ranks.

Counterpart of ``omniquant_tpu/serving/dp_serving.py``. Every rank runs a
rank-local engine replica (its own packed weights; tensor parallelism, if
any, inside the rank's engine) and owns the slots of the requests routed
to it. Requests are routed by a deterministic policy that every rank
computes alike from the same request log, so there is no scheduler
protocol: admission is bookkeeping replicated on every rank. The only
traffic between ranks is none during decode (each rank decodes its own
slots) and one all-gather of a few int32 a slot when a caller asks for the
global token streams (``gather_tokens``), over gloo on CPU tensors
(``multihost.cpu_group``).

Rank and world size come from the ``torch.distributed`` process group;
without one the coordinator is rank 0 of a world of 1, a thin wrapper over
one engine.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..parallel import multihost


class DPServingCoordinator:
    """Data-parallel continuous batching across the ranks of the process
    group.

    engine: the rank-local engine (LlamaEngine/OPTEngine/FalconEngine or a
        TP engine over the rank's own devices), built by the caller so all
        engine kwargs (kv_dtype, spec, auto_grow, overlap_chunks) compose;
        the same configuration on every rank.
    Request ids are global; the mapping id -> (rank, local slot) is the
    deterministic ``route`` below, evaluated alike on every rank.
    """

    def __init__(self, engine):
        self.engine = engine
        self.pid = multihost.process_index()
        self.nproc = multihost.process_count()
        self._next_id = 0
        # global bookkeeping, the same on every rank: id -> rank
        self._host_of: Dict[int, int] = {}
        # rank-local: id -> engine slot (only for ids routed here)
        self._slot_of: Dict[int, int] = {}
        self._pending: Dict[int, int] = {}
        # per-id emitted tokens (local ids only; the all-gather merges)
        self._tokens: Dict[int, List[int]] = {}

    # ------------------------------------------------------------------
    def route(self, req_id: int) -> int:
        """Deterministic admission: round-robin over ranks."""
        return req_id % self.nproc

    def submit(self, prompts: List[List[int]], **kw) -> List[int]:
        """Admit a batch of prompts (the same argument on every rank).
        Returns their global request ids. Each rank prefills only the
        prompts routed to it.

        Admission control is the same on every rank: each computes every
        rank's occupancy after the submit from the shared bookkeeping and
        raises the same error on all of them when any rank would exceed
        its engine's capacity (an error on one rank alone would leave the
        others blocked in the next all-gather)."""
        cap = self.engine.max_batch  # the same engine config on every rank
        occupancy = [0] * self.nproc
        for host in self._host_of.values():
            occupancy[host] += 1
        for i in range(len(prompts)):
            host = self.route(self._next_id + i)
            need = occupancy[host] + sum(
                1 for j in range(i + 1)
                if self.route(self._next_id + j) == host)
            if need > cap:
                raise RuntimeError(
                    f"submit of {len(prompts)} prompts would put {need} "
                    f"requests on host {host} (engine capacity {cap}); "
                    "release requests or submit fewer (raised identically "
                    "on every rank)")
        ids, mine = [], []
        for p in prompts:
            rid = self._next_id
            self._next_id += 1
            host = self.route(rid)
            self._host_of[rid] = host
            ids.append(rid)
            if host == self.pid:
                mine.append((rid, p))
        if mine:
            slots = self.engine.add_requests([p for _, p in mine], **kw)
            for (rid, _), slot in zip(mine, slots):
                self._slot_of[rid] = slot
                first = self.engine._pending_next[slot]
                self._pending[rid] = first
                self._tokens[rid] = [first]
        return ids

    def release(self, rid: int) -> None:
        self._host_of.pop(rid, None)
        if rid in self._slot_of:
            self.engine.release(self._slot_of.pop(rid))
            self._pending.pop(rid, None)
        self._tokens.pop(rid, None)

    # ------------------------------------------------------------------
    def step_n(self, n: int = 8) -> None:
        """Every rank advances its live slots by n tokens (rank-local, no
        traffic between ranks); a rank with no live slot skips the call."""
        if self._slot_of:
            last = {self._slot_of[rid]: self._pending[rid]
                    for rid in self._slot_of}
            out = self.engine.step_n(last, n)
            for rid, slot in self._slot_of.items():
                toks = out[slot]
                self._tokens[rid].extend(toks)
                self._pending[rid] = toks[-1]

    def gather_tokens(self) -> Dict[int, List[int]]:
        """The global view of every live request's emitted tokens: one
        all-gather of the padded local (rid, n, tokens...) int32 rows.
        Every rank returns the same dict."""
        if self.nproc == 1:
            return {rid: list(t) for rid, t in self._tokens.items()}
        live = sorted(self._host_of)
        width = max([len(t) for t in self._tokens.values()] or [0])
        width = int(multihost.allgather_host(
            np.asarray([width], np.int32)).max())
        per_host_rows = max(
            (sum(1 for r in live if self._host_of[r] == h)
             for h in range(self.nproc)), default=0)
        local = np.full((per_host_rows, width + 2), -1, np.int32)
        row = 0
        for rid in live:
            if self._host_of[rid] != self.pid:
                continue
            t = self._tokens[rid]
            local[row, 0] = rid
            local[row, 1] = len(t)
            local[row, 2:2 + len(t)] = t
            row += 1
        gathered = multihost.allgather_host(local).reshape(-1, width + 2)
        out: Dict[int, List[int]] = {}
        for r in gathered:
            if r[0] >= 0:
                out[int(r[0])] = r[2:2 + int(r[1])].tolist()
        return out

    # ------------------------------------------------------------------
    def generate_all(self, prompts: List[List[int]],
                     max_new_tokens: int = 16,
                     step: int = 8) -> List[List[int]]:
        """Admit ``prompts``, decode everyone to max_new_tokens (step_n
        batches of ``step`` on each rank), gather, release. Every rank
        returns the same global list, aligned with ``prompts``."""
        ids = self.submit(prompts)
        made = 1
        while made < max_new_tokens:
            n = min(step, max_new_tokens - made)
            self.step_n(n)
            made += n
        global_toks = self.gather_tokens()
        for rid in ids:
            self.release(rid)
        return [global_toks[rid][:max_new_tokens] for rid in ids]
