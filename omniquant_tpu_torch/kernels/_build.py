"""Build and load the hand-written CUDA kernels in ``omniquant_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

into ``build/`` at the root of the checkout, then loaded with ``ctypes``.
The library name carries a hash of its source and of the shared
``csrc/*.cuh`` headers, so an edited source is rebuilt and a stale library
is never loaded. ``build_all`` starts one
``nvcc`` per source, all at once, so a cold start pays for the slowest
source rather than the sum.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises on anything but 0. Nothing here
runs when the module is imported. ``count`` adds one to a wrapper's launch
counters under a lock: the shards of a tensor-parallel mesh launch from
threads of their own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
SOURCES = ("quant_matmul", "kv_update", "flash_attention", "decode_attention",
           "quant_matmul_int")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}
_COUNT_LOCK = threading.Lock()


def count(fn, *attrs: str) -> None:
    """Add one to each of ``fn``'s launch counters ``attrs`` (one kernel
    launch), atomically with respect to other threads."""
    with _COUNT_LOCK:
        for attr in attrs:
            setattr(fn, attr, getattr(fn, attr) + 1)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from source on first use")
    return found


def _target(name: str) -> Path:
    # the shared headers are part of every source's hash
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"{name}-{digest[:12]}.so"


def _start(name: str, extra_flags=()):
    """Start nvcc for one source; None when its library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> str:
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)
    return out


def build_all(extra_flags=()) -> dict:
    """Compile every kernel source in parallel (those not yet built).
    Returns {name: nvcc output} for the sources it compiled."""
    started = {n: _start(n, extra_flags) for n in SOURCES}
    return {n: _finish(n, s) for n, s in started.items() if s is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, compiling it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "b": ctypes.c_char_p}


def fn(name: str, symbol: str, signature: str):
    """ctypes function csrc/<name>.cu::<symbol>. ``signature`` spells its
    arguments before the trailing stream: 'p' pointer, 'i' int, 'f' float,
    'b' a bytes object (passed by the address of its contents).
    Pointers and the stream must be passed as Python ints; a pointer left to
    ctypes' default conversion would be cut to 32 bits."""
    f = getattr(load(name), symbol)
    if f.argtypes is None:
        f.argtypes = [_CTYPES[c] for c in signature] + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def launch(name: str, symbol: str, signature: str, *args) -> None:
    """Call a kernel entry point on PyTorch's current stream and raise if the
    launch was refused."""
    import torch

    # the current stream's handle without building a torch.cuda.Stream
    # (which costs microseconds of host time a launch)
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    err = fn(name, symbol, signature)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}.{symbol}: CUDA error {err} at launch")
