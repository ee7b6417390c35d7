"""Traffic mode ``live``: a closed loop.  Each bank step hands in one frame
of every stream (copied from the host) and waits for that frame's
readouts (``class_probs``, ``most_likely_class``) on the host before the
next.  Every ``trial_len`` frames each stream's trial ends and a new one
begins: the bank starts again from ``pf_init_bank``, as a tracker does
for a new subject.

The window stops after ``--seconds`` on the host's clock, around work
that ends in a synchronise; the warm-up and the profiled stretch after a
number of steps.  Each bank step's latency is kept for ``frame_p95_ms``.
"""

from __future__ import annotations

import time

from perfbench import bank as bk

#: The kind of work (``work/<family>_<WORK>.py``) of a step of this mode.
WORK = "filter"


def loop(sut, step, init, state, Zh, draws, f0: int, stop, trial_len: int):
    """Closed-loop bank steps from frame ``f0``, the bank started again by
    ``init()`` at every multiple of ``trial_len``.  Returns (state, next
    frame, result) with the frames' latencies, their class probabilities
    (B, C) as read and the states each trial started from and ended in, by
    frame (an end at the frame after the trial's last)."""
    dev = sut.device
    F = Zh.shape[0]
    lat, probs_read, inits, ends, n = [], [], {}, {}, 0
    t_start = time.perf_counter()
    f = f0
    while True:
        t0 = time.perf_counter()
        if f % trial_len == 0:
            if state is not None:
                ends[f] = state
            state = init()
            inits[f] = state
        z = Zh[f % F].to(dev, non_blocking=True)
        d = draws.frame()
        new, out = step(state, z, sut.noise(*d))
        probs = out.class_probs.cpu()
        out.most_likely_class.cpu()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        probs_read.append(probs)
        state, f, n = new, f + 1, n + 1
        if bk.stopped(stop, n, t_start):
            break
    ends[f] = state
    return state, f, {"steps": n, "seconds": t1 - t_start, "latencies_s": lat,
                      "probs": probs_read, "inits": inits, "ends": ends}


def run(model, cfg, asset, mix, seed, seconds, trace_on, device, t0, wrap, reference):
    b = bk.setup(model, cfg, asset, mix, seed, device, wrap, reference)
    sut, L = b.sut, b.trial_len
    step = wrap("step", sut.step)
    loop(sut, step, b.init_warm, None, b.Zh, b.warm, 0, ("steps", mix["warmup_steps"]), L)
    bk.sync(device)
    t_win = time.perf_counter()
    state, f, res = loop(sut, step, b.init, None, b.Zh, b.draws, 0, ("seconds", seconds), L)

    def more(n):
        return loop(sut, step, b.init_warm, state, b.Zh, b.warm, f, ("steps", n), L)[2]["steps"]

    def frames(draws):
        for i in range(res["steps"]):
            yield i, draws.frame()

    return bk.finish(b, res, t_win - t0, bk.p95_ms(res["latencies_s"]),
                     more if trace_on else None, frames, reference)
