"""What decides ``correct``: the program's outputs on the timed path held
against the plain reference (``perfbench/reference``), each number
beside the limit that the cell's workload file sets.

Filter cells.  The reference filter runs a sample of the banks, drawn
from the seed, through every frame of the window, each trial from the
program's initial particles of those banks, on the same observations and
draws.
A float32 filter's dynamics variance (kdiag minus a quad through an
inverse Gram of condition ~1e7) has few correct digits, so no float32
filter follows a float64 one particle for particle, even for a frame;
what both must agree on is what the filter answers.  Numbers: the share
of bank-frames whose most likely class differs (``class_disagree``) and
the mean over bank-frames of the largest gap in class probability
(``probs_mad``); a frame whose readout is not finite counts as a
disagreement and a gap of 1.  At the end of each trial, and of the
window, the particles' shares by class are compared: the mean over banks
of the largest gap (``class_share_gap``; a filter that does not carry its
state forward still answers each frame well from its prior, but ends its
trials with its prior's shares).  Each trial's start is checked by itself:
every initial particle is a training latent of its class, and each bank
splits its particles evenly over the classes (``init_bad`` counts the
particles that break either).
"""

from __future__ import annotations

import torch

from .reference.gp import class_row_offsets


def filter_numbers(reference, post, inits, ends, banks, frames, probs_read, Zh, T) -> dict:
    """``class_disagree``, ``probs_mad`` and ``class_share_gap`` over every
    frame of the window for the banks ``banks``: the reference filter
    (``reference.step``, the configuration's ``reference/<name>.py``) run,
    trial by trial, from the program's initial particles of those banks
    (``inits``: (x, c) by the frame each trial starts at), on the same
    observations and draws (``frames`` yields each frame's index and draws
    of every bank); ``ends`` holds the program's particle classes by the
    frame after each trial's last."""
    dev = post.h.y_inv_ls.device
    Tm = torch.as_tensor(T, device=dev)
    sel = torch.as_tensor(banks)
    F = Zh.shape[0]
    disagree, mad, n, share, n_ends = 0, 0.0, 0, 0.0, 0
    C = Tm.shape[0]
    for (f, (u_trans, eps, u_res)), probs_p in zip(frames, probs_read):
        if f in inits:
            x, c = (a[sel.to(a.device)].to(dev) for a in inits[f])
        sel_d = sel.to(u_trans.device)
        z = Zh[f % F][sel].to(dev)
        x, c, probs, _ = reference.step(post, x, c, z, u_trans[sel_d].to(dev),
                                     eps[sel_d].to(dev), u_res[sel_d].to(dev), Tm)
        p_prog = probs_p[sel].to(dev, torch.float64)
        bad = ~torch.isfinite(p_prog).all(dim=1)
        disagree += int(((torch.argmax(p_prog, dim=1) != torch.argmax(probs, dim=1)) | bad).sum())
        gap = (p_prog - probs.to(torch.float64)).abs().amax(dim=1)
        mad += float(torch.where(bad, torch.ones_like(gap), gap).sum())
        n += len(banks)
        if f + 1 in ends:
            c_prog = ends[f + 1][sel.to(ends[f + 1].device)].to(dev)
            shares = [(torch.mean((c_prog == k).double(), dim=1)
                       - torch.mean((c == k).double(), dim=1)).abs() for k in range(C)]
            share += float(torch.stack(shares).amax(dim=0).sum())
            n_ends += len(banks)
    return {"class_disagree": disagree / n, "probs_mad": mad / n,
            "class_share_gap": share / max(n_ends, 1), "compared": n}


def init_bad(asset: dict, x0: torch.Tensor, c0: torch.Tensor) -> int:
    """Initial particles that are not a training latent of their class,
    plus each bank's departure from the even split over classes (the
    first P mod C classes one more)."""
    X = torch.as_tensor(asset["params_f32"]["X"]).to(x0.device)
    offs = class_row_offsets(asset)
    B, Pb, d = x0.shape
    C = len(offs) - 1
    bad = 0
    keys = _row_keys(x0.reshape(-1, d).float())
    cls = c0.reshape(-1)
    for k in range(C):
        rows = _row_keys(X[int(offs[k]):int(offs[k + 1])].float())
        sel = cls == k
        bad += int((~torch.isin(keys[sel], rows)).sum())
    base, rem = divmod(Pb, C)
    want = torch.tensor([base + (1 if k < rem else 0) for k in range(C)], device=c0.device)
    counts = torch.stack([(c0 == k).sum(dim=1) for k in range(C)], dim=1)
    return bad + int((counts - want).abs().sum())


def _row_keys(X: torch.Tensor) -> torch.Tensor:
    """One int64 per float32 row, from its bits (equal rows, equal keys)."""
    bits = X.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    for k in range(X.shape[1]):
        key = key * 1000003 + bits[:, k]
    return key


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {'value', 'limit'}}) for every number that has a
    limit; a number missing or over its limit is not correct."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        checks[name] = {"value": v, "limit": limit}
        if v is None or not (v <= limit):
            ok = False
    return ok, checks
