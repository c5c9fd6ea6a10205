"""The port's profiling module (``omniquant_tpu_torch/utils/profiling.py``)
against the JAX package's: the phase totals, counts, ``as_dict`` and
``report()`` text of both Profilers under one patched clock;
``device_memory_stats()`` on a machine without a card ({} in both); and
``trace`` writing a chrome trace of the region."""
import itertools
import json

import pytest
import torch

from omniquant_tpu.utils import profiling as jprof
from omniquant_tpu_torch import utils as tutils
from omniquant_tpu_torch.utils import profiling as tprof


def _drive(mod, monkeypatch):
    """The same phases, nested and repeated, on a clock that ticks 0.25 s
    a reading."""
    ticks = itertools.count()
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks) * 0.25)
    prof = mod.Profiler()
    for _ in range(3):
        with prof.phase("calibrate"):
            with prof.phase("layer"):
                pass
            with prof.phase("layer"):
                pass
    with prof.phase("eval_ppl"):
        pass
    with pytest.raises(RuntimeError):
        with prof.phase("serve"):
            raise RuntimeError("a failing phase still counts")
    return prof


def test_profiler_matches_jax(monkeypatch):
    want = _drive(jprof, monkeypatch)
    got = _drive(tprof, monkeypatch)
    assert dict(got.totals) == dict(want.totals)
    assert dict(got.counts) == dict(want.counts)
    assert got.as_dict() == want.as_dict()
    assert got.report() == want.report()
    assert got.counts["layer"] == 6 and got.counts["serve"] == 1


def test_exports_match_jax():
    names = ("PROFILER", "Profiler", "device_memory_stats", "phase", "trace")
    for n in names:
        assert getattr(tutils, n) is getattr(tprof, n)
    assert tprof.phase == tprof.PROFILER.phase


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert tprof.device_memory_stats() == jprof.device_memory_stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "t")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert d == str(tmp_path / "t")
    assert any("mm" in e.get("name", "") for e in events)
