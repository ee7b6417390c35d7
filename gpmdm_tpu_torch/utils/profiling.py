"""Tracing and profiling: a ``torch.profiler`` trace around any region,
and the program's own spans and counters.

Counterpart of ``gpmdm_tpu/utils/profiling.py``.  ``trace`` writes a
Chrome trace (open it in Perfetto or chrome://tracing).  ``span(name)``
times a named region of the program, ``counter(name)`` counts events
(kernel launches); ``snapshot()`` reads both as plain dicts and
``reset()`` clears them.  The JAX package's ``warm_transport`` initializes
a remote TPU's device-to-host path and has no counterpart here.

A span does one of two things, decided when it is entered:

- no profiler recording (the normal case): it adds to an in-memory record
  on the host clock (``time.perf_counter_ns``): per name the calls, the
  inclusive nanoseconds and a ring of the last ``RING`` inclusive
  durations;
- a ``torch.profiler`` recording: it enters
  ``torch._C._profiler._RecordFunctionFast``, which lands on the
  profiler's host timeline as an ordinary ``cpu_op`` on the clock of the
  device events, and leaves the record alone, so a profiled stretch's
  inflated host times never mix into it.  Never ``record_function``: its
  ranges are user annotations, which the profiler copies onto the
  device's timeline as if they were device operations.

A span's time includes the spans opened inside it, and any wait for the
card inside it.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import threading
import time
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

#: Inclusive durations kept per span name, the newest last.
RING = 1024


class _Record:
    __slots__ = ("calls", "incl_ns", "ring")

    def __init__(self):
        self.calls = 0
        self.incl_ns = 0
        self.ring = collections.deque(maxlen=RING)


_records: dict[str, _Record] = {}
_counters: dict[str, int] = {}
_counter_lock = threading.Lock()


class span:
    """A context manager timing the region it wraps under ``name``:

        with profiling.span("pf.step"):
            ...
    """

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _RecordFunctionFast(self.name)
            self.rf.__enter__()
        else:
            self.rf = None
            self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
            return
        dt = time.perf_counter_ns() - self.t0
        rec = _records.get(self.name)
        if rec is None:
            rec = _records[self.name] = _Record()
        rec.calls += 1
        rec.incl_ns += dt
        rec.ring.append(dt)


def counter(name: str) -> None:
    """Add one to the counter ``name``; always on."""
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + 1


def snapshot() -> dict:
    """The spans and counters as plain dicts: ``{"spans": {name: {"calls",
    "incl_ns", "ring"}}, "counters": {name: n}}``, ``ring`` the last
    ``RING`` inclusive durations in ns, oldest first."""
    spans = {name: {"calls": r.calls, "incl_ns": r.incl_ns, "ring": list(r.ring)}
             for name, r in _records.items()}
    with _counter_lock:
        counters = dict(_counters)
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Clear every span's record and every counter."""
    _records.clear()
    with _counter_lock:
        _counters.clear()


@contextlib.contextmanager
def trace(log_dir: str | None = None) -> Iterator[object]:
    """Profile a region with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write its Chrome trace to
    ``log_dir`` (default: ``gpmdm_tpu_torch_trace`` in the temporary
    directory) as ``trace_<pid>_<time>.json``; the program's spans show
    in it as host operations:

        with profiling.trace("runs/trace"):
            train_step(...)

    Yields the profiler, whose ``key_averages()`` summarize the region."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "gpmdm_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json"))
