"""The traced stretch: ``torch.profiler`` over a short steady stretch of
the cell's own work, reduced to the summary that the per-layer metrics'
readers read.

- ``window_s``: the stretch on the host's clock, from its first call to
  the synchronise that ends it (a ``record_function`` span).
- ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy or fill) ran, clipped to the stretch: time that no
  operation covers is idle, however many overlap elsewhere.
- ``kernels``: per kernel name, launches and device seconds.
- ``breakdown``: the ten operations with the most device time, and the
  ten longest idle gaps summed by the innermost host operation that was
  running at the gap's middle.
"""

from __future__ import annotations

import numpy as np
import torch

STRETCH = "perfbench.stretch"
_NOT_KERNELS = ("memcpy", "memset")


def profile(run) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            n = run()
            torch.cuda.synchronize()
    events = prof.events()
    # the stretch's own span shows on the device's timeline too: it is an
    # annotation, not an operation
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name != STRETCH]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    stretch = [e for e in host if e.name == STRETCH]
    if not stretch or not dev:
        return {"steps": n, "window_s": None, "busy_s": None, "kernels": {}, "breakdown": None}
    w0, w1 = stretch[0].time_range.start, stretch[0].time_range.end
    iv = np.array([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev],
                  dtype=np.float64)
    order = np.argsort(iv[:, 0])
    iv = iv[order]
    busy, gaps = 0.0, []
    cur0, cur1 = w0, w0
    for a, b in iv:
        if b <= a:
            continue
        if a > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    if w1 > cur1:
        gaps.append((cur1, w1))
    kernels: dict = {}
    for e in dev:
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) * 1e-6
    return {"steps": n, "window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "breakdown": {"device_ops": _top(kernels), "idle_gaps": _gaps_by_host(gaps, host)}}


def is_kernel(name: str) -> bool:
    low = name.lower()
    return not any(t in low for t in _NOT_KERNELS)


def _top(kernels: dict, n: int = 10):
    rows = sorted(((v[1], k) for k, v in kernels.items()), reverse=True)[:n]
    return [[k, s] for s, k in rows]


def _gaps_by_host(gaps, host, n: int = 10):
    """Idle seconds by the innermost host operation at each gap's middle,
    over the longest 200 gaps; the ten largest sums."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:200]
    hs = [e for e in host if e.name != STRETCH]
    starts = np.array([e.time_range.start for e in hs], dtype=np.float64)
    ends = np.array([e.time_range.end for e in hs], dtype=np.float64)
    sums: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = "(no host operation)"
        if cover.size:
            name = hs[int(cover[np.argmin(ends[cover] - starts[cover])])].name
        sums[name] = sums.get(name, 0.0) + (b - a) * 1e-6
    rows = sorted(((s, k) for k, s in sums.items()), reverse=True)[:n]
    return [[k, s] for s, k in rows]
