"""Timing helpers (the port of ``neuralampmodelercore_tpu.utils.profiling``).

:class:`BlockTimer` collects per-block times and reports the reference's
percentile set {min, p50, p99, p99.9, max, mean} plus the real-time factor
(reference: tools/bench_a2_fast.cpp:99-163). On a CUDA device it times with
``torch.cuda.Event`` pairs, so the times are the device's; on the CPU it uses
the host clock.
"""

from __future__ import annotations

import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def card_and_power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def sync(device=None) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if torch.device(device or "cpu").type == "cuda":
        torch.cuda.synchronize(device)


class BlockTimer:
    """``with timer: step()`` per block; ``stats()`` after the run. Times are
    in seconds."""

    def __init__(self, deadline_s: float, device=None):
        self.deadline_s = deadline_s
        self.cuda = torch.device(device or "cpu").type == "cuda"
        self._events: List = []
        self._host: List[float] = []
        self._start: Optional[object] = None

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((self._start, end))
        else:
            self._host.append(time.perf_counter() - self._start)
        return False

    @property
    def times(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [s.elapsed_time(e) / 1e3 for s, e in self._events]
        return list(self._host)

    def stats(self) -> Dict[str, float]:
        t = np.asarray(self.times)
        s = {
            "min": float(t.min()),
            "p50": float(np.percentile(t, 50)),
            "p99": float(np.percentile(t, 99)),
            "p99.9": float(np.percentile(t, 99.9)),
            "max": float(t.max()),
            "mean": float(t.mean()),
        }
        s["rtf"] = self.deadline_s / s["p50"] if s["p50"] > 0 else float("inf")
        return s
