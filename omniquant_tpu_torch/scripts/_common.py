"""What the probe drivers share: the card's line and a device timer."""
from __future__ import annotations

import subprocess
from typing import Optional

import numpy as np
import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()


SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's ~2 GHz clock


def per_call_ms(fn, calls: int, device) -> Optional[float]:
    """Device milliseconds a call of ``fn`` over ``calls`` calls queued back
    to back between two CUDA events, after one warm-up call; None on the
    CPU, where no device time exists (``fn`` still runs once). The calls
    and events are queued behind a device sleep, so the host's work per
    call (the wrapper's checks, its allocations) lies outside the window;
    where the device reaches the window before the last call is queued,
    the sleep is lengthened and the run repeated (three times at most)."""
    fn()
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(3):
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        hidden = not start.query()
        end.synchronize()
        if hidden:
            break
        cycles *= 4
    return start.elapsed_time(end) / calls


def chain_ms(call, x, n_chain: int, device) -> Optional[float]:
    """Milliseconds a call of a chain y = call(y) of ``n_chain`` calls from
    x (the scripts' chained dispatches), as ``per_call_ms`` times them."""
    def chain():
        y = x
        for _ in range(n_chain):
            y = call(y)
        return y

    ms = per_call_ms(chain, 1, device)
    return None if ms is None else ms / n_chain


def fmt_us(ms: Optional[float]) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:8.1f} us"


def randn(rng: np.random.Generator, shape, device, dtype=torch.float32,
          scale: float = 1.0) -> torch.Tensor:
    """Standard normal numbers from ``rng`` (times ``scale``), as f32 and
    then ``dtype``, on ``device``."""
    a = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
    return torch.from_numpy(a).to(device=device, dtype=dtype)
