"""Multi-process distribution: the ``torch.distributed`` wiring.

Counterpart of ``omniquant_tpu/parallel/multihost.py``. JAX joins its
processes with ``jax.distributed.initialize`` and lays one global mesh over
every process's devices; here ``init_multihost`` joins them into one
``torch.distributed`` process group, and ``global_mesh`` lays a
``parallel.mesh.Mesh`` over every rank's shards, dp-major, each shard
belonging to the rank that holds its device. A rank runs only its own
shards; the mesh's collectives gather the other ranks' values and fold
them in shard order (``parallel/mesh.py``).

The backend is NCCL where every rank of a host has a card of its own, and
gloo otherwise: on the CPU, and where several ranks share one card (then a
collective stages its tensors through the host). A host's ranks are those
the launcher names (torchrun's ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``);
without them every rank is taken to be on one host. Host-side traffic (the DP
coordinator's token rows, fingerprints, the dp gradient mean) always rides
gloo on CPU tensors (``cpu_group``).

Host-local calibration data becomes this rank's tensor on its device
(``shard_calibration_batch``), each rank loading only its ``process_slice``
of the calibration set; ``dp_mean`` is the gradient mean over the dp rows
that JAX's GSPMD inserts without being asked: an all-gather, then a sum in
row order, so every rank holds the same bits.

Without a coordinator and a process id, ``init_multihost`` finds the
cluster in the launcher's environment (``detect_cluster``), as
``jax.distributed.initialize()`` does with no arguments: torchrun's
``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``, SLURM's ``SLURM_JOB_ID``/``SLURM_STEP_NODELIST``/
``SLURM_NTASKS``/``SLURM_PROCID``/``SLURM_LOCALID`` (the coordinator is the
first host of the node list, at the port JAX's SLURM cluster picks:
``SLURM_JOB_ID % 4096 + 61440``), or Open MPI's ``OMPI_COMM_WORLD_*`` with
``OMPI_MCA_orte_hnp_uri`` (the launcher's address, JAX's port rule). With
none of them it raises, naming what it looked for; it never falls back to
one process.

CPU validation path: N processes on one machine, each calling
``init_multihost(MultihostConfig("localhost:<port>", N, rank), "cpu")``;
the collectives ride gloo over localhost (tests/test_torch_multihost.py).
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import re
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device

_log = logging.getLogger(__name__)
_STATE = {"cpu_group": None, "device": None, "timeout_s": 600.0}


@dataclasses.dataclass
class MultihostConfig:
    coordinator_address: Optional[str] = None  # "host:port" of rank 0
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    timeout_s: float = 600.0  # every collective and the rendezvous


def initialized() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return torch.distributed.get_rank() if initialized() else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if initialized() else 1


@dataclasses.dataclass
class Cluster:
    """A launcher's view of the job: where rank 0 listens, how many ranks,
    this one's rank, and its place among its host's ranks (``local_world``
    None where the launcher does not say)."""

    launcher: str
    coordinator_address: str
    num_processes: int
    process_id: int
    local_rank: int
    local_world: Optional[int]


_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
_SLURM = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
          "SLURM_PROCID", "SLURM_LOCALID")
_OMPI = ("OMPI_MCA_orte_hnp_uri", "OMPI_COMM_WORLD_SIZE",
         "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")


def _port_of_job(job_id: int) -> int:
    """JAX's port rule: one of the 4096 ports at the top of the ephemeral
    range, picked by the job id."""
    return job_id % 2**12 + (65535 - 2**12 + 1)


def slurm_first_host(node_list: str) -> str:
    """The first host of a SLURM node list: ``node001``,
    ``node001,host2``, ``node[001-015],host2`` and ``node[001,007-015]``
    all give ``node001`` (JAX's ``SlurmCluster`` reading)."""
    cut = next((i for i, ch in enumerate(node_list) if ch in ",["),
               len(node_list))
    if cut == len(node_list) or node_list[cut] == ",":
        return node_list[:cut]
    suffix = node_list[cut + 1:]
    end = next((i for i, ch in enumerate(suffix) if ch in ",-"), None)
    return node_list[:cut] + suffix[:end]


def _torchrun(env) -> Cluster:
    local = env.get("LOCAL_WORLD_SIZE")
    return Cluster("torchrun", f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                   int(env["WORLD_SIZE"]), int(env["RANK"]),
                   int(env.get("LOCAL_RANK", env["RANK"])),
                   None if local is None else int(local))


def _slurm(env) -> Cluster:
    addr = (f"{slurm_first_host(env['SLURM_STEP_NODELIST'])}:"
            f"{_port_of_job(int(env['SLURM_JOB_ID']))}")
    n, nodes = int(env["SLURM_NTASKS"]), env.get("SLURM_STEP_NUM_NODES")
    return Cluster("slurm", addr, n, int(env["SLURM_PROCID"]),
                   int(env["SLURM_LOCALID"]),
                   n // int(nodes) if nodes else None)


def _openmpi(env) -> Cluster:
    uri = env["OMPI_MCA_orte_hnp_uri"]
    # the job id is a multiple of 2^12 (JAX's OmpiCluster)
    port = _port_of_job(int(uri.split(".", 1)[0]) // 2**12)
    m = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
    if m is None:
        raise RuntimeError(f"no launcher address in "
                           f"OMPI_MCA_orte_hnp_uri={uri!r}")
    addr = f"{next(g for g in m.groups() if g is not None)}:{port}"
    local = env.get("OMPI_COMM_WORLD_LOCAL_SIZE")
    return Cluster("openmpi", addr, int(env["OMPI_COMM_WORLD_SIZE"]),
                   int(env["OMPI_COMM_WORLD_RANK"]),
                   int(env["OMPI_COMM_WORLD_LOCAL_RANK"]),
                   None if local is None else int(local))


# (the variables a launcher must set, its reader), in the order looked for
_LAUNCHERS = ((_TORCHRUN, _torchrun), (_SLURM, _slurm), (_OMPI, _openmpi))


class NoLauncher(RuntimeError):
    """No launcher's variables are in the environment."""


def detect_cluster(env=None) -> Cluster:
    """The cluster the launcher describes in ``env`` (default
    ``os.environ``): torchrun, SLURM or Open MPI, in that order. Raises
    ``NoLauncher`` naming every variable it looked for when none is
    complete."""
    env = os.environ if env is None else env
    for names, read in _LAUNCHERS:
        if all(k in env for k in names):
            return read(env)
    raise NoLauncher(
        "no coordinator_address and process_id given, and no launcher "
        "found in the environment: looked for torchrun's "
        f"{', '.join(_TORCHRUN)}; SLURM's {', '.join(_SLURM)}; Open MPI's "
        f"{', '.join(_OMPI)}")


def local_layout(cfg: MultihostConfig) -> tuple:
    """(this rank's index among its host's ranks, the ranks on its host):
    the launcher's where it gives both (torchrun's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``; SLURM's ``SLURM_LOCALID`` with ``SLURM_NTASKS``
    over ``SLURM_STEP_NUM_NODES``; Open MPI's local rank and size), else
    every rank on one host."""
    env = os.environ
    if "LOCAL_RANK" in env and "LOCAL_WORLD_SIZE" in env:
        return int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    for names, read in _LAUNCHERS[1:]:
        if all(k in env for k in names):
            c = read(env)
            if c.local_world is not None:
                return c.local_rank, c.local_world
    return cfg.process_id, cfg.num_processes


def init_multihost(cfg: MultihostConfig, device="cuda") -> torch.device:
    """Join this process into the group and return its device: ``device``
    itself on the CPU, else card ``local_rank % device_count``
    (``local_layout``). A no-op (``device`` resolved) when num_processes
    == 1. With neither ``coordinator_address`` nor ``process_id``, the
    cluster comes from the launcher's environment (``detect_cluster``;
    ``num_processes``, when given, must be its count). An init that fails
    raises; nothing carries on as one process."""
    dev = resolve_device(device)
    if cfg.num_processes == 1:
        return dev
    if cfg.coordinator_address is None and cfg.process_id is None:
        found = detect_cluster()
        if cfg.num_processes not in (None, found.num_processes):
            raise ValueError(
                f"num_processes={cfg.num_processes}, but the {found.launcher}"
                f" environment holds {found.num_processes} ranks")
        _log.info(f"{found.launcher} launch: rank {found.process_id} of "
                  f"{found.num_processes}, coordinator "
                  f"{found.coordinator_address}")
        cfg = dataclasses.replace(
            cfg, coordinator_address=found.coordinator_address,
            num_processes=found.num_processes, process_id=found.process_id)
        if cfg.num_processes == 1:
            return dev
    elif (cfg.coordinator_address is None or cfg.process_id is None
          or not cfg.num_processes):
        raise ValueError("init_multihost needs coordinator_address, "
                         "num_processes and process_id together, or none "
                         "of the first and last (the launcher's "
                         "environment then gives them)")
    local_rank, local_n = local_layout(cfg)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    # NCCL when every rank of the host has a card of its own; else gloo
    # (the CPU, or ranks sharing a card)
    backend = "nccl" if count and count >= local_n else "gloo"
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    _log.info(f"rank {cfg.process_id} of {cfg.num_processes}: backend "
              f"{backend} ({local_n} ranks on this host, {count} cards), "
              f"device {dev}")
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{cfg.coordinator_address}",
        world_size=cfg.num_processes, rank=cfg.process_id,
        timeout=datetime.timedelta(seconds=cfg.timeout_s))
    # host-side collectives take CPU tensors, which NCCL does not
    _STATE["cpu_group"] = (torch.distributed.new_group(backend="gloo")
                           if backend == "nccl" else None)
    _STATE["device"] = dev
    _STATE["timeout_s"] = cfg.timeout_s
    return dev


def timeout_s() -> float:
    """The group's collective timeout in seconds (init_multihost's)."""
    return _STATE["timeout_s"]


def cpu_group():
    """The group for collectives of CPU tensors (gloo): the default group
    unless that is NCCL."""
    return _STATE["cpu_group"]


def allgather_host(x: np.ndarray) -> np.ndarray:
    """Every rank's ``x`` (one shape and dtype on every rank), stacked in
    rank order: (world, *x.shape). JAX's ``process_allgather``."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if not initialized():
        return t.numpy()[None]
    out = [torch.empty_like(t) for _ in range(process_count())]
    torch.distributed.all_gather(out, t, group=cpu_group())
    return torch.stack(out).numpy()


def global_mesh(tp: int = 1, dp: Optional[int] = None, local_shards: int = 1,
                device=None):
    """A (dp, tp) mesh over every rank's shards (``local_shards`` a rank,
    on its device), dp-major: shard p = row * tp + column, ranks in order.
    With tp = local_shards the dp axis spans ranks and tp stays inside a
    rank, the layout JAX's global_mesh prescribes. Without a process group:
    this process's ``local_shards`` shards. Called by every rank."""
    from .mesh import Mesh

    dev = resolve_device(device if device is not None
                         else (_STATE["device"] or "cuda"))
    world = process_count()
    n = world * local_shards
    if dp is None:
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {n} shards")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} shards; the "
                         f"ranks hold {n} ({world} x {local_shards})")
    if world == 1:
        return Mesh([dev] * n, dp=dp)
    devs = [None] * world
    torch.distributed.all_gather_object(devs, str(dev), group=cpu_group())
    return Mesh([devs[r] for r in range(world) for _ in range(local_shards)],
                ranks=[r for r in range(world) for _ in range(local_shards)],
                dp=dp)


def shard_calibration_batch(mesh, host_local) -> torch.Tensor:
    """This rank's calibration rows (its ``process_slice``), as a tensor
    on its first shard's device: the rank's part of the dp-split batch."""
    return torch.as_tensor(np.asarray(host_local)).to(
        mesh.devices[mesh.local[0]])


def process_slice(n_samples: int) -> slice:
    """Which rows of the global calibration set this process loads."""
    pid, np_ = process_index(), process_count()
    per = n_samples // np_
    if per * np_ != n_samples:
        raise ValueError(f"{n_samples} samples do not split over {np_} "
                         "processes")
    return slice(pid * per, (pid + 1) * per)


def all_processes_agree(x) -> bool:
    """A cheap cross-rank consistency check: one float64 fingerprint (the
    first element of ``x``) gathered from every rank and compared."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    val = np.asarray(x, np.float64).ravel()[:1]
    gathered = allgather_host(val)
    return bool(np.all(np.isclose(gathered, gathered[0])))


def _row_owners(mesh) -> list:
    """The rank holding each dp row's first shard (every rank of a row
    holds the row's replicated values)."""
    ranks = mesh.ranks or [process_index()] * mesh.n
    return [ranks[i * mesh.tp] for i in range(mesh.dp)]


def dp_mean(mesh, tensors: Sequence[torch.Tensor]) -> list:
    """The mean over the mesh's dp rows of each tensor (a rank passes its
    row's: the gradients of a dp calibration step, or its loss): every
    rank's values gathered, then summed in row order and divided by dp, so
    every rank holds the same bits. Where one process holds every row
    (no process group), the tensors are its one row's and come back as
    they are."""
    if not initialized() or mesh.ranks is None:
        return list(tensors)
    owners = _row_owners(mesh)
    if len(set(owners)) != len(owners):
        raise ValueError(f"dp_mean takes one dp row a rank; the rows' "
                         f"first shards are on ranks {owners}")
    out = []
    for t in tensors:
        flat = t.detach().to("cpu", torch.float32).contiguous()
        got = [torch.empty_like(flat) for _ in range(process_count())]
        torch.distributed.all_gather(got, flat, group=cpu_group())
        acc = got[owners[0]].clone()
        for r in owners[1:]:
            acc = acc + got[r]
        out.append((acc / len(owners)).to(t.device, t.dtype))
    return out
