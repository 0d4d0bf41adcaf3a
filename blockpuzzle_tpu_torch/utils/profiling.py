"""Tracing and profiling hooks of the port.

The port of ``blockpuzzle_tpu/utils/profiling.py``: ``device_trace`` is
``torch.profiler`` (CPU activity, plus CUDA activity where a card is
present) writing a Chrome trace, in place of ``jax.profiler``; ``ScopeTimer``
marks its scopes as NVTX ranges, in place of ``jax.named_scope``, where
CUDA is present.  ``device_events``, ``busy_us`` and ``by_name`` read a
profile's device kernels (``scripts/profile_step.py``, ``chip_measure.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed work into ``<log_dir>/trace.json`` (a Chrome
    trace; no-op when ``log_dir`` is None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class ScopeTimer:
    """Accumulating named wall-clock scopes for a coarse host-side
    breakdown (no device sync: a scope times what the host spends)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator[None]:
        nvtx = (torch.cuda.nvtx.range(name) if torch.cuda.is_available()
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with nvtx:
            yield
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> Dict[str, float]:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))


def device_events(prof) -> list:
    """The device (CUDA) events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_us(events) -> float:
    """Length of the union of the events' time ranges, in µs: the time the
    device was busy."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        if s > end:
            busy += e - s
        elif e > end:
            busy += e - end
        end = max(end, e)
    return busy


def by_name(events) -> List[Tuple[str, int, float]]:
    """(name, count, total µs) of each kernel name, the largest total
    first."""
    out: Dict[str, Tuple[int, float]] = {}
    for e in events:
        n, us = out.get(e.name, (0, 0.0))
        out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return sorted(((k, n, us) for k, (n, us) in out.items()), key=lambda r: -r[2])
