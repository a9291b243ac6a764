"""Tracing / profiling helpers (torch twin of
llava_align_tpu/utils/profiling.py).

Per-phase wall timers that are safe around asynchronous CUDA launches
(the device is synchronized on entry and exit), and a torch.profiler
trace context that writes a Chrome trace (chrome://tracing, Perfetto)
where the JAX package writes an xprof trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


def _sync() -> None:
    """Wait for the device's queued work: the current CUDA device once CUDA
    is in use in this process (before that nothing can be queued); the
    CPU has nothing queued."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulates wall time per named phase; device-synchronized."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True) -> Iterator[None]:
        if sync:
            _sync()
        t0 = time.perf_counter()
        yield
        if sync:
            _sync()
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace of the block, written as a Chrome trace to
    <log_dir>/trace.json (the CPU's activity, and the GPU's kernels where
    there is a GPU). No-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
