"""Profiling and tracing: the port's counterpart of
``omniquant_tpu/utils/profiling.py``.

  * `phase(name)`: context manager accumulating wall-clock per phase, with a
    report() summary — the structured replacement for the reference's
    scattered time.time() calls.
  * `trace(dir)`: wraps torch.profiler (CPU and CUDA activities) around a
    code region and writes its timeline to ``dir/trace.json``, a chrome
    trace viewable in Perfetto.
  * `device_memory_stats()`: live/peak device memory per card and the
    card's capacity (torch.cuda.memory_stats and mem_get_info); {} where
    there is no card, as JAX's is for a backend without stats.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class Profiler:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase                          total_s   calls   mean_ms"]
        for name, total in sorted(
                self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<30} {total:8.2f} {n:7d} {total / n * 1e3:9.2f}")
        return "\n".join(lines)

    def as_dict(self):
        return {k: {"total_s": v, "calls": self.counts[k]}
                for k, v in self.totals.items()}


PROFILER = Profiler()
phase = PROFILER.phase


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """torch.profiler timeline capture around a code region (CPU and, where
    there is a card, CUDA activity), written to ``log_dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> dict:
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[str(torch.device("cuda", i))] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": total,
        }
    return out
