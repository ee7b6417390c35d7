"""Tracing and profiling.

Counterpart of ``gpmdm_tpu/utils/profiling.py``: a ``torch.profiler``
trace around any region, written as a Chrome trace (open it in Perfetto
or chrome://tracing), named sub-regions inside it, and a stage timer whose
numbers (steps/s, filter frames/s) are the benchmark's metrics.  The JAX
package's ``warm_transport`` initializes a remote TPU's device-to-host path
and has no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Dict, Iterator


@contextlib.contextmanager
def trace(log_dir: str | None = None) -> Iterator[object]:
    """Profile a region with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write its Chrome trace to
    ``log_dir`` (default: ``gpmdm_tpu_torch_trace`` in the temporary
    directory) as ``trace_<pid>_<time>.json``:

        with profiling.trace("runs/trace"):
            train_step(...)

    Yields the profiler, whose ``key_averages()`` summarize the region."""
    from torch.profiler import ProfilerActivity, profile

    import torch

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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named sub-region inside a trace (``torch.profiler.record_function``)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


@dataclasses.dataclass
class StageTimer:
    """Accumulating wall-clock timer for named pipeline stages.

    Use ``with timer.stage("dynamics"): ...`` around *blocking* host-side
    stages; call ``torch.cuda.synchronize()`` inside the region when timing
    device work, otherwise launch time is measured instead of execution
    time.
    """

    totals: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {n} calls, {total / n * 1e3:.2f} ms/call")
        return "\n".join(lines)

    def rates(self, name: str) -> float:
        """Calls per second for a stage."""
        return self.counts.get(name, 0) / self.totals.get(name, float("inf"))


def throughput(n_items: int, wall_s: float) -> float:
    return n_items / wall_s if wall_s > 0 else float("inf")
