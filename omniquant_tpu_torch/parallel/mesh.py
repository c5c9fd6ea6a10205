"""The device mesh: n shards, one program each, in threads and processes.

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

A mesh may span processes (``ranks``: the rank of the ``torch.distributed``
group that holds each shard, every rank as many;
``parallel/multihost.py::global_mesh`` builds one). A rank places and runs
only its own shards (``local``); with one,
``run`` calls the program in the calling thread. A collective gathers
every rank's values (``all_gather``, not ``all_reduce``, whose sum order
is the library's) and each rank folds all n in shard order on its first
shard's device, exactly as above, so every rank holds the same bits. Gloo
gathers no CUDA tensors, so on gloo the values travel through the host as
raw bytes.

``shift`` is JAX's ``ppermute`` round a row: shard p hands a tensor to the
next shard and gets the previous one's. In one process it is a device copy
(nothing on one card); across ranks each rank posts its receives and sends
to the neighbouring ranks at once and waits for them (gloo: raw bytes
through pinned host buffers), with the group's timeout. A rank's shift is
one autograd node whose backward shifts the gradients back the other way,
so a graph that crosses ranks differentiates on every rank in step.

A (dp, tp) mesh (``dp`` > 1) holds dp rows of tp shards, dp-major (shard p
is row p // tp): its collectives reduce each row on its own (JAX's psum
over the "tp" axis), and the rows are data-parallel replicas.

``make_mesh(dp, tp)`` is JAX's ``parallel.make_mesh``: a mesh over the
first dp * tp visible cards, or, when a process group is up, over every
rank's shards (``global_mesh``). A caller that wants n shards on one card
passes the devices itself.
"""
from __future__ import annotations

import contextlib
import datetime
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
    """n shards, shard p on ``devices[p]`` (the devices may repeat), held
    by rank ``ranks[p]`` of the process group (None: all in this process);
    ``dp`` rows of n // dp. ``run`` runs one program per local shard, each
    in its own thread (JAX's ``shard_map``); the programs meet at the
    collectives."""

    def __init__(self, devices: Sequence, ranks: Optional[Sequence] = None,
                 dp: int = 1):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if dp < 1 or len(self.devices) % dp:
            raise ValueError(f"{len(self.devices)} shards do not form "
                             f"{dp} rows")
        self.dp = dp
        self.ranks = None if ranks is None else [int(r) for r in ranks]
        if self.ranks is None:
            self.local = list(range(self.n))
        else:
            if len(self.ranks) != self.n:
                raise ValueError("one rank a shard")
            rank = torch.distributed.get_rank()
            world = torch.distributed.get_world_size()
            self.local = [p for p, r in enumerate(self.ranks) if r == rank]
            if sorted(set(self.ranks)) != list(range(world)) or len(
                    {self.ranks.count(r) for r in range(world)}) != 1:
                raise ValueError(
                    f"every rank of the group must hold as many shards of "
                    f"the mesh: ranks {self.ranks} in a world of {world}")
        self._baton = None
        self._slots = {}
        self._result = None

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return self.n // self.dp

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None

    def each(self, fn) -> list:
        """[fn(p, devices[p]) for each local shard p], None at the other
        ranks' shards: what a rank places of a per-shard tree."""
        return [fn(p, d) if p in self.local else None
                for p, d in enumerate(self.devices)]

    def first(self, results: list):
        """The first local shard's entry of a per-shard list (after an
        all-reduce, every shard's replicated values are the same bits)."""
        return results[self.local[0]]

    def run(self, fn, *shard_args) -> list:
        """[fn(p, *(a[p] for a in shard_args)) for each local shard p]
        (None at other ranks' shards), each call in its own thread with
        the caller's grad and inference modes and, on a card, its shard's
        device current; the threads take turns (the baton: module
        docstring). One local shard runs in the calling thread. The first
        error of any shard is raised once every shard has stopped."""
        local = self.local
        results = [None] * self.n
        if len(local) == 1:
            p = local[0]
            with _on(self.devices[p]):
                results[p] = fn(p, *(a[p] for a in shard_args))
            return results
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        errors = []
        self._baton = baton = _Baton(len(local))
        self._slots = {}

        def work(i, p):
            try:
                baton.take(i)
                with torch.inference_mode(inference), \
                        torch.set_grad_enabled(grad), _on(self.devices[p]):
                    results[p] = fn(p, *(a[p] for a in shard_args))
            except BaseException as e:  # handed to the caller below
                errors.append(e)
                baton.break_()  # wake shards waiting in a collective
            finally:
                baton.pass_on(i, "done")

        threads = [threading.Thread(target=work, args=(i, p), daemon=True)
                   for i, p in enumerate(local)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._baton, self._slots, self._result = None, {}, None
        if errors:
            raise next((e for e in errors if not isinstance(e, BrokenMesh)),
                       errors[0])
        return results

    def _collective(self, p: int, value, combine, gather: bool = True):
        """Shard p's part of a collective: every shard hands in its
        ``value``; the last local shard to arrive gathers the other ranks'
        values and runs ``combine`` on the n values (in shard order), which
        returns one result per shard; shard p gets its own. With ``gather``
        False, ``combine`` takes the local shards' values ({shard: value})
        and does its own communication."""
        if len(self.local) == 1:
            slots = {p: value}
            return combine(self._gather(slots) if gather else slots)[p]
        self._slots[p] = value
        if len(self._slots) < len(self.local):
            i = self.local.index(p)
            self._baton.pass_on(i, "waiting")
            self._baton.take(i)
        else:
            slots, self._slots = self._slots, {}
            self._result = combine(self._gather(slots) if gather else slots)
            self._baton.ready_all()
        return self._result[p]

    def _gather(self, slots: dict) -> list:
        """The n shards' values in shard order: this rank's from ``slots``,
        the other ranks' gathered from them (same shape and dtype on every
        shard); on gloo through the host, as raw bytes."""
        if not self.spans_processes:
            return [slots[p] for p in range(self.n)]
        dist = torch.distributed
        mine = torch.stack([slots[p] for p in self.local])
        world = dist.get_world_size()
        if dist.get_backend() == "gloo":
            raw = mine.detach().cpu().contiguous().view(torch.uint8)
            got = [torch.empty_like(raw) for _ in range(world)]
            dist.all_gather(got, raw)
            got = [g.view(mine.dtype) for g in got]
        else:
            out = torch.empty((world,) + tuple(mine.shape),
                              dtype=mine.dtype, device=mine.device)
            dist.all_gather_into_tensor(out, mine.contiguous())
            got = list(out.unbind(0))
        values = dict(slots)
        for r, g in enumerate(got):
            owned = [p for p, q in enumerate(self.ranks) if q == r]
            for p, v in zip(owned, g.unbind(0)):
                values.setdefault(p, v)
        return [values[p] for p in range(self.n)]

    def _peer(self, p: int, step: int) -> int:
        """The shard ``step`` places after p round p's row."""
        row = p - p % self.tp
        return row + (p % self.tp + step) % self.tp

    def shift(self, p: int, x: torch.Tensor, step: int = 1) -> torch.Tensor:
        """Shard p's ``x`` goes to shard p + step of its row, and shard p
        gets shard p - step's (JAX's ``ppermute`` round the ring), on its
        device; every shard's tensor has one shape and dtype.
        Differentiable: the gradient goes back the other way."""
        return self._collective(p, x, lambda slots: self._shift(slots, step),
                                gather=False)

    def _shift(self, slots: dict, step: int) -> dict:
        if not self.spans_processes:
            return {p: slots[self._peer(p, -step)].to(self.devices[p],
                                                      non_blocking=True)
                    for p in self.local}
        out = _Shift.apply(self, step, *(slots[p] for p in self.local))
        return dict(zip(self.local, out))

    def _exchange(self, xs: list, step: int) -> list:
        """The local shards' ``xs`` (in ``local`` order) shifted by
        ``step``: a neighbour on this rank copies, a neighbour on another
        rank exchanges point to point (every receive and send posted, then
        waited for, under the group's timeout)."""
        from . import multihost

        dist = torch.distributed
        gloo = dist.get_backend() == "gloo"
        out = [None] * len(self.local)
        works, recvs = [], []
        for i, p in enumerate(self.local):
            src = self._peer(p, -step)
            if src in self.local:
                out[i] = xs[self.local.index(src)].to(self.devices[p],
                                                      copy=True)
                continue
            buf = _host_bytes(xs[i]) if gloo else torch.empty_like(xs[i])
            recvs.append((i, buf))
            works.append(dist.irecv(buf, self.ranks[src], tag=p))
        for i, p in enumerate(self.local):
            dst = self._peer(p, step)
            if dst not in self.local:
                x = xs[i].detach().contiguous()
                if gloo:
                    x = _host_bytes(x).copy_(x.view(torch.uint8).reshape(-1))
                works.append(dist.isend(x, self.ranks[dst], tag=dst))
        timeout = datetime.timedelta(seconds=multihost.timeout_s())
        for w in works:
            w.wait(timeout)
        for i, buf in recvs:
            x = xs[i]
            if gloo:
                buf = buf.to(x.device).view(x.dtype).reshape(x.shape)
            out[i] = buf
        return out

    def all_reduce(self, p: int, x: torch.Tensor, op: str = "sum"):
        """Shard p's ``x`` in, the reduction over its row's shards out
        (JAX's ``psum``/``pmin``/``pmax``): combined in shard order on the
        first local shard's device, bit-identical on every shard."""
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, not {op!r}")
        return self._collective(p, x, lambda xs: self._reduce(xs, op))

    def _reduce(self, xs: list, op: str) -> list:
        home = self.devices[self.local[0]]
        dtype = xs[0].dtype
        wide = (torch.float32 if xs[0].is_floating_point()
                and xs[0].element_size() < 4 else dtype)
        out = [None] * self.n
        for row in range(self.dp):
            shards = range(row * self.tp, (row + 1) * self.tp)
            if not any(p in self.local for p in shards):
                continue
            acc = xs[shards[0]].to(home, wide)
            for q in shards[1:]:
                acc = _OPS[op](acc, xs[q].to(home, wide))
            acc = acc.to(dtype)
            for q in shards:
                if q in self.local:
                    d = self.devices[q]
                    out[q] = acc if d == home else acc.to(d, non_blocking=True)
        return out


def _host_bytes(x: torch.Tensor) -> torch.Tensor:
    """A host buffer of ``x``'s bytes (uint8), pinned where x is on a card."""
    n = x.numel() * x.element_size()
    return torch.empty(n, dtype=torch.uint8, pin_memory=x.is_cuda)


class _Shift(torch.autograd.Function):
    """A rank's shift of its local shards' tensors (``Mesh._exchange``):
    its backward shifts their gradients by the opposite step."""

    @staticmethod
    def forward(ctx, mesh, step, *xs):
        ctx.mesh, ctx.step = mesh, step
        return tuple(mesh._exchange(list(xs), step))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.mesh._exchange(list(grads), -ctx.step))


def make_mesh(dp: int = 1, tp: int = 1, devices: Optional[Sequence] = None
              ) -> Mesh:
    """A (dp, tp) mesh (JAX's ``make_mesh``), dp-major. When a process
    group is up and no ``devices`` are given, over every rank's shards
    (``multihost.global_mesh``: a rank's shards on its card, as many a
    rank as make dp * tp). Else in this process: by default over the first
    dp * tp visible cards, raising when there are fewer (a card is never
    repeated unasked); ``devices`` gives the shards' devices instead, and
    may repeat one (n shards on one card, or on the CPU)."""
    from . import multihost

    if tp < 1 or dp < 1:
        raise ValueError(f"dp and tp must be at least 1, not {dp}, {tp}")
    n = dp * tp
    if devices is None and multihost.initialized():
        world = multihost.process_count()
        if n % world:
            raise ValueError(f"a ({dp}, {tp}) mesh does not split over "
                             f"{world} processes")
        return multihost.global_mesh(tp=tp, dp=dp, local_shards=n // world)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices="
                "[torch.device('cpu')] * tp to run the shards on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n:
        shape = f"tp={tp}" if dp == 1 else f"a ({dp}, {tp}) mesh"
        raise RuntimeError(
            f"make_mesh: {shape} needs {n} devices, {len(devices)} given "
            f"({[str(d) for d in devices]}); to put several shards on one "
            "card, pass that card repeated as devices")
    return Mesh(devices[:n], dp=dp)
