"""Tracing and throughput profiling (PyTorch).

Port of :mod:`nylon_amt_tpu.utils.profiling`: a ``torch.profiler`` trace
of a run (a Chrome / Perfetto JSON file, with the card's kernels when CUDA
is available), per-step timing with warm-up discard, the domain
throughput metric (transcribed audio seconds per wall second), and the
device's memory statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

TRACE_FILE = "trace.json"


def activities() -> list:
    """The profiler's activities: the host, and the card when there is one."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/trace'): step()`` writes
    ``/tmp/trace/trace.json`` (open it in Perfetto or chrome://tracing)."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@dataclass
class StepTimer:
    """Accumulates step wall times; discards warmup (first-call) steps."""

    warmup: int = 2
    times: list = field(default_factory=list)
    _seen: int = 0
    _t0: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def steps_per_sec(self) -> float:
        return 1.0 / self.mean if self.mean else 0.0

    def audio_sec_per_sec(self, windows_per_step: int,
                          sec_per_window: float) -> float:
        """Domain throughput: transcribed audio-sec per wall-sec."""
        return (windows_per_step * sec_per_window * self.steps_per_sec())


def device_memory_stats() -> dict:
    """Per-device memory statistics (``torch.cuda.memory_stats``); ``{}``
    without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
