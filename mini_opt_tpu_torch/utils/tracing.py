"""Tracing and profiling, the port of ``mini_opt_tpu/utils/tracing.py``:
host-side chrome://tracing scoped timers and a device-profile hook.

As in the JAX package (and the reference's tracing.hpp / tracing.cc), RAII
scoped timers feed a bounded, thread-safe event buffer, ``trace_collector``,
rendered as chrome://tracing "Complete"-event JSON. ``annotate`` couples the
host timer with a ``torch.profiler.record_function`` range (the JAX
package's ``jax.named_scope``), so the solver's phases (linearize, step
direction, line search, ...) are spans both in the collector and in a
``torch.profiler`` trace of the host and the card; ``device_profile`` wraps
``torch.profiler.profile`` and writes such a trace into a directory.

Always on and near free: a ``perf_counter`` pair and a list append per
phase, and one small object for the range outside a profiler.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Iterator, List

import torch

_MAX_EVENTS = 100_000  # the reference's ring-buffer bound (tracing.cc:95-104)


class TraceCollector:
    """Global mutex-guarded event buffer (tracing.cc:77-111 analog); events
    past ``_MAX_EVENTS`` are dropped."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[dict] = []

    def submit(self, name: str, start_us: float, duration_us: float) -> None:
        with self._lock:
            if len(self._events) >= _MAX_EVENTS:
                return
            self._events.append(
                {
                    "name": name,
                    "ph": "X",  # Complete event
                    "ts": start_us,
                    "dur": duration_us,
                    "pid": os.getpid(),
                    "tid": threading.get_native_id(),
                }
            )

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def get_trace_json(self) -> str:
        """chrome://tracing-loadable document (tracing.cc:82-111)."""
        with self._lock:
            return json.dumps({"traceEvents": self._events, "displayTimeUnit": "ms"})

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.get_trace_json())


trace_collector = TraceCollector()


@contextlib.contextmanager
def scoped_trace(name: str) -> Iterator[None]:
    """Host-side RAII timer (tracing.hpp:67-83 analog): one event in
    ``trace_collector``."""
    start = time.perf_counter()
    try:
        yield
    finally:
        end = time.perf_counter()
        trace_collector.submit(name, start * 1e6, (end - start) * 1e6)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Host timer + ``torch.profiler.record_function``: the phase is an
    event in the chrome trace and a labelled range in a profiler trace."""
    with scoped_trace(name):
        with torch.profiler.record_function(name):
            yield


def traced_phase(name: str):
    """Decorator form of :func:`annotate`, the analog of the reference's
    ``MINI_OPT_FUNCTION_TRACE()`` at the top of each solver phase
    (nonlinear.cc:77,173,218,280,355,459)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def device_profile(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed work with ``torch.profiler`` (the host's
    activity, and the card's where CUDA is available) and write its chrome
    trace, the solver's phases among its spans, into ``log_dir`` as
    ``trace_<pid>_<ns>.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
