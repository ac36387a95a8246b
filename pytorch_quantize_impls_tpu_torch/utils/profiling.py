"""Profiling: ``torch.profiler`` traces, labelled regions, and a step timer.

Counterpart of ``pytorch_quantize_impls_tpu/utils/profiling.py``.
:func:`trace` records the CPU and, where there is a card, its CUDA
activity, and writes a Chrome trace (``trace.json``, for Perfetto or
``chrome://tracing``) into ``logdir``; :data:`named_scope` labels a region
in it. :class:`StepTimer` times steps on the host clock after ``warmup``
steps; with ``sync`` (``torch.cuda.synchronize``) each step's time ends when
the card has run it, not when its launches were queued.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(logdir): run_steps()`` -> ``logdir/trace.json``; yields
    the profiler (``key_averages()`` sums by op and kernel)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


named_scope = record_function  # label a region: ``with named_scope("pack"): ...``


@dataclass
class StepTimer:
    """Host-clock step timer that skips ``warmup`` steps; feeds images/s.
    ``with timer: step()`` times one step."""

    warmup: int = 3
    sync: Optional[Callable[[], None]] = None
    _times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None
    _seen: int = 0

    def __enter__(self):
        if self.sync is not None:
            self.sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            self.sync()
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)

    @property
    def mean_s(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean_s if self._times else float("nan")
