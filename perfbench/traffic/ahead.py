"""Traffic mode ``ahead``: recorded clips dispatched ahead through
``pf_scan_bank``, one clip of every stream a chunk, each from
``pf_init_bank``; a chunk's readouts are read on the host while the next
chunk runs.  A clip is ``trial_len`` frames.

The window stops after ``--seconds`` on the host's clock, once the last
chunk's readouts are on the host; the warm-up and the profiled stretch
after a number of chunks.
"""

from __future__ import annotations

import time

import torch

from perfbench import bank as bk

#: The kind of work (``work/<family>_<WORK>.py``) of a step of this mode.
WORK = "filter"


def loop(sut, scan, init, Zc, draws, k0: int, stop):
    """Chunks dispatched ahead from chunk ``k0``: ``Zc`` (n_chunks, B, T,
    D) on the host, each chunk a clip of every stream scanned from
    ``init()``.  A chunk's readouts go to pinned host buffers and are read
    once the next chunk is under way.  Returns (next chunk, result) with
    every frame's class probabilities (B, C) as read, and each chunk's
    initial and final states, by the frame of its first and the frame
    after its last."""
    dev = sut.device
    n_chunks, B, T, _ = Zc.shape
    on_card = torch.device(dev).type == "cuda"
    probs_read, inits, ends, n, k = [], {}, {}, 0, k0
    pending, bufs = None, {}

    def settle(p):
        fence, probs = p
        fence.wait()
        probs_read.extend(probs.clone().unbind(1))

    t_start = time.perf_counter()
    while True:
        Z = Zc[k % n_chunks].to(dev, non_blocking=on_card)
        state = init()
        inits[k * T] = state
        ends[(k + 1) * T], outs = scan(state, Z, sut.noise(*draws.frames(T)))
        if k % 2 not in bufs:  # two sets, one for each chunk in flight
            bufs[k % 2] = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=on_card)
                                for t in (outs.class_probs, outs.most_likely_class))
        probs, mlc = bufs[k % 2]
        probs.copy_(outs.class_probs, non_blocking=on_card)
        mlc.copy_(outs.most_likely_class, non_blocking=on_card)
        cur = (bk.Fence(dev), probs)
        if pending is not None:
            settle(pending)
        pending = cur
        k, n = k + 1, n + 1
        if bk.stopped(stop, n, t_start):
            break
    settle(pending)
    t_end = time.perf_counter()
    return k, {"steps": n * T, "chunks": n, "seconds": t_end - t_start,
               "probs": probs_read, "inits": inits, "ends": ends}


def run(model, cfg, asset, mix, seed, seconds, trace_on, device, t0, wrap, reference):
    b = bk.setup(model, cfg, asset, mix, seed, device, wrap, reference)
    sut, L = b.sut, b.trial_len
    F = b.Zh.shape[0]
    Zc = b.Zh.reshape(F // L, L, mix["streams"], -1).permute(0, 2, 1, 3).contiguous()
    if torch.cuda.is_available():
        Zc = Zc.pin_memory()
    scan = wrap("scan", sut.scan)
    loop(sut, scan, b.init_warm, Zc, b.warm, 0, ("steps", mix["warmup_chunks"]))
    bk.sync(device)
    t_win = time.perf_counter()
    k, res = loop(sut, scan, b.init, Zc, b.draws, 0, ("seconds", seconds))

    def more(n):
        return loop(sut, scan, b.init_warm, Zc, b.warm, k, ("steps", n))[1]["steps"]

    def frames(draws):
        for kk in range(res["chunks"]):
            chunk = draws.frames(L)
            for j in range(L):
                yield kk * L + j, tuple(a[j] for a in chunk)

    return bk.finish(b, res, t_win - t0, None, more if trace_on else None, frames, reference)
