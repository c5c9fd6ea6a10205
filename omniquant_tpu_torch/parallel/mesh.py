"""The in-process device mesh: n shards, one program each, in threads.

JAX drives the devices of a mesh from one process through ``shard_map``
and joins them with collectives (``psum``, ``pmin``, ``ppermute``). Here a
mesh is a sequence of n ``torch.device``s, which may repeat (n shards on
one card). ``Mesh.run`` runs one program per shard, each in its own thread
with its shard's device current, and the programs meet at collectives that
every shard calls in the same order. One thread runs at a time: it holds
a baton, and hands it to the next shard when it reaches a collective or
ends; the last shard to reach a collective computes its result for all
and runs on, and each other shard reads its own when the baton comes back
to it. So the shards' Python never contends for the interpreter lock,
and on one card every shard launches on the device's default stream, so
their kernels run in stream order and share the kernels' per-device
buffers safely.

``all_reduce`` adds (or takes the min or max of) the shards' tensors in
shard order on shard 0's device, a float narrower than f32 in f32 and
rounded once, and hands every shard the same result: the very tensor on
shard 0's device (nothing is copied between shards on one card), a copy of
it on any other card. So every shard holds bit-identical values, and
replicated hidden states (and every shard's sampling) never diverge.

``make_mesh(dp, tp)`` is JAX's ``parallel.make_mesh``: a tensor-parallel
mesh over the first ``tp`` visible cards. A caller that wants n shards on
one card passes the devices itself.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch

_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def _on(device: torch.device):
    """A context that makes ``device`` current where it is a card (the
    kernels launch on the current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class BrokenMesh(RuntimeError):
    """A shard of the run failed: the others leave their collectives."""


class _Baton:
    """The right to run Python, held by one shard thread at a time and
    handed round-robin to the next shard that is ready (not waiting in a
    collective, not finished)."""

    def __init__(self, n: int):
        self.n = n
        self.go = [threading.Event() for _ in range(n)]
        self.state = ["ready"] * n
        self.lock = threading.Lock()
        self.broken = False
        self.go[0].set()

    def take(self, p: int) -> None:
        self.go[p].wait()
        self.go[p].clear()
        if self.broken:
            raise BrokenMesh("another shard of the run failed")

    def pass_on(self, p: int, state: str) -> None:
        """Shard p stops, "waiting" in a collective or "done"; the next
        ready shard runs."""
        with self.lock:
            self.state[p] = state
            for i in range(1, self.n):
                q = (p + i) % self.n
                if self.state[q] == "ready":
                    self.go[q].set()
                    return

    def ready_all(self) -> None:
        """A collective is complete: every shard waiting in it may run."""
        with self.lock:
            self.state = ["ready" if st == "waiting" else st
                          for st in self.state]

    def break_(self) -> None:
        with self.lock:
            self.broken = True
            for e in self.go:
                e.set()


class Mesh:
    """n shards, shard p on ``devices[p]`` (the devices may repeat). ``run``
    runs one program per shard, each in its own thread (JAX's
    ``shard_map``); the programs meet at the collectives."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self._baton = None
        self._slots = [None] * len(self.devices)
        self._arrived = 0
        self._result = None

    @property
    def n(self) -> int:
        return len(self.devices)

    def run(self, fn, *shard_args) -> list:
        """[fn(p, *(a[p] for a in shard_args)) for each shard p], each call
        in its own thread with the caller's grad and inference modes and,
        on a card, its shard's device current; the threads take turns (the
        baton: module docstring). The first error of any shard is raised
        once every shard has stopped."""
        if self.n == 1:
            return [fn(0, *(a[0] for a in shard_args))]
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        results = [None] * self.n
        errors = []
        self._baton = baton = _Baton(self.n)
        self._slots, self._arrived = [None] * self.n, 0

        def work(p):
            try:
                baton.take(p)
                with torch.inference_mode(inference), \
                        torch.set_grad_enabled(grad), _on(self.devices[p]):
                    results[p] = fn(p, *(a[p] for a in shard_args))
            except BaseException as e:  # handed to the caller below
                errors.append(e)
                baton.break_()  # wake shards waiting in a collective
            finally:
                baton.pass_on(p, "done")

        threads = [threading.Thread(target=work, args=(p,), daemon=True)
                   for p in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._baton, self._slots, self._result = None, [None] * self.n, None
        if errors:
            raise next((e for e in errors if not isinstance(e, BrokenMesh)),
                       errors[0])
        return results

    def _collective(self, p: int, value, combine):
        """Shard p's part of a collective: every shard hands in its
        ``value``; the last to arrive runs ``combine`` on the n values (in
        shard order), which returns one result per shard; shard p gets its
        own."""
        if self.n == 1:
            return combine([value])[0]
        self._slots[p] = value
        self._arrived += 1
        if self._arrived < self.n:
            self._baton.pass_on(p, "waiting")
            self._baton.take(p)
        else:
            self._arrived = 0
            self._result = combine(list(self._slots))
            self._baton.ready_all()
        return self._result[p]

    def all_reduce(self, p: int, x: torch.Tensor, op: str = "sum"):
        """Shard p's ``x`` in, the reduction over every shard's out (JAX's
        ``psum``/``pmin``/``pmax``): combined in shard order on shard 0's
        device, bit-identical on every shard."""
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, not {op!r}")
        return self._collective(p, x, lambda xs: self._reduce(xs, op))

    def _reduce(self, xs: list, op: str) -> list:
        home = self.devices[0]
        dtype = xs[0].dtype
        wide = (torch.float32 if xs[0].is_floating_point()
                and xs[0].element_size() < 4 else dtype)
        acc = xs[0].to(home, wide)
        for x in xs[1:]:
            acc = _OPS[op](acc, x.to(home, wide))
        acc = acc.to(dtype)
        return [acc if d == home else acc.to(d, non_blocking=True)
                for d in self.devices]


def make_mesh(dp: int = 1, tp: int = 1, devices: Optional[Sequence] = None
              ) -> Mesh:
    """A tensor-parallel mesh of ``tp`` shards (JAX's ``make_mesh``): by
    default over the first ``tp`` visible cards, raising when there are
    fewer (a card is never repeated unasked); ``devices`` gives the shards'
    devices instead, and may repeat one (n shards on one card, or on the
    CPU). Only dp = 1: data-parallel replicas are multi-process serving."""
    if dp != 1:
        raise NotImplementedError(
            "dp > 1 (data-parallel serving replicas) needs multi-process "
            "serving (ROADMAP Queue 1 item 3)")
    if tp < 1:
        raise ValueError(f"tp must be at least 1, not {tp}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices="
                "[torch.device('cpu')] * tp to run the shards on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < tp:
        raise RuntimeError(
            f"make_mesh: tp={tp} needs {tp} devices, {len(devices)} given "
            f"({[str(d) for d in devices]}); to put several shards on one "
            "card, pass that card repeated as devices")
    return Mesh(devices[:tp])
