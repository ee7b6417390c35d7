"""What every filter mode shares: the filter bank built from the cell's
files, the streams and the draws made from the seed, the result of a
window, and the check held for after it.

A filter mode (``traffic/<mode>.py``) builds a ``Bank`` with ``setup``,
drives the program's bank through it for the window, and hands what it
read to ``finish``, which profiles the traced stretch and holds the
check.  Every seed gives the same sizes; it changes the classes, phases,
noise, draws and initial particles.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import check, system, trace, traffic
from .reference import gp as ref_gp


class Fence:
    """A point in the stream that the host can wait for (an event on the
    card; nothing to wait for on the CPU)."""

    def __init__(self, device):
        self.ev = None
        if torch.device(device).type == "cuda":
            self.ev = torch.cuda.Event()
            self.ev.record()

    def wait(self):
        if self.ev is not None:
            self.ev.synchronize()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Draws:
    """The filter's randomness, drawn on the device from the run's seed:
    per frame the transition uniforms, the dynamics normals and the
    resampling uniform of every bank."""

    def __init__(self, B, Pb, d, dtype, generator, device):
        self.B, self.Pb, self.d, self.dtype = B, Pb, d, dtype
        self.g, self.dev = generator, device

    def frame(self):
        kw = dict(generator=self.g, dtype=self.dtype, device=self.dev)
        return (torch.rand(self.B, self.Pb, **kw), torch.randn(self.B, self.Pb, self.d, **kw),
                torch.rand(self.B, **kw))

    def frames(self, T):
        kw = dict(generator=self.g, dtype=self.dtype, device=self.dev)
        return (torch.rand(T, self.B, self.Pb, **kw), torch.randn(T, self.B, self.Pb, self.d, **kw),
                torch.rand(T, self.B, **kw))


def stopped(stop, n, t0) -> bool:
    """``stop`` is ('steps', n) or ('seconds', s)."""
    kind, val = stop
    return n >= val if kind == "steps" else time.perf_counter() - t0 >= val


def transition(cfg: dict, mix: dict) -> np.ndarray:
    """The class transition matrix: ``stay_prob`` on the diagonal, the rest
    spread evenly."""
    C = cfg["n_classes"]
    T = np.full((C, C), (1.0 - mix["stay_prob"]) / (C - 1))
    np.fill_diagonal(T, mix["stay_prob"])
    return T


@dataclass
class Bank:
    sut: system.FilterSystem
    cfg: dict
    asset: dict
    mix: dict
    seed: int
    device: object
    T: np.ndarray
    Zh: torch.Tensor  # (frames, streams, D) on the host
    trial_len: int
    warm: Draws  # the warm-up's and the profiled stretch's draws
    draws: Draws  # the window's
    init: object  # the window's bank initialisation, as the wrap gives it
    init_warm: object


def setup(model, cfg, asset, mix, seed, device, wrap, reference) -> Bank:
    """The bank, its streams and draws.  The streams, the warm-up, the
    window's draws and the window's initial particles each come from a
    generator of their own, all from the seed."""
    if cfg["filter"] != reference.FILTER:
        raise RuntimeError(f"{cfg['name']}: reference/{cfg['reference']}.py implements the "
                           f"filter settings {reference.FILTER}, not {cfg['filter']}")
    B, Pb = mix["streams"], mix["particles"]
    shape = {**cfg["streams"], **mix.get("streams_shape", {})}
    L = shape["trial_len"]
    if mix["frames_per_stream"] % L:
        raise ValueError("frames_per_stream must hold whole trials")
    T = transition(cfg, mix)
    sut = system.FilterSystem(model, T, Pb, cfg["filter"])
    # the reference builds the configuration's posterior: the program must
    # serve that one
    got = sut.deployment()
    stated = {k: cfg.get(k) for k in got}
    if got != stated:
        raise RuntimeError(f"{cfg['name']}: the program deployed {got}, not the configuration's "
                           f"{stated}")
    gens = []
    for k in range(4):
        gens.append(torch.Generator(device=device))
        gens[-1].manual_seed(seed + k)
    Z, _ = traffic.make_streams(shape, cfg["n_classes"], B, mix["frames_per_stream"], gens[0],
                                device)
    Zh = traffic.host_frames(Z)
    del Z
    return Bank(sut=sut, cfg=cfg, asset=asset, mix=mix, seed=seed, device=device, T=T, Zh=Zh,
                trial_len=L, warm=Draws(B, Pb, sut.d, sut.dtype, gens[1], device),
                draws=Draws(B, Pb, sut.d, sut.dtype, gens[2], device),
                init=wrap("init", lambda: sut.init(B, gens[3])),
                init_warm=lambda: sut.init(B, gens[1]))


def finish(bank: Bank, res: dict, setup_s: float, frame_p95_ms, more, frames, reference) -> dict:
    """The fields of a filter run's result, from the window's ``res``
    (steps, seconds, the class probabilities as read, the states each
    trial started from and ended in).  ``more(n)`` runs n more steps and
    returns how many it ran (the profiled stretch, with ``--trace 1``);
    ``frames(draws)`` yields each frame of the window, by its index, with
    its draws of every bank as ``draws`` replays them.  The check holds
    neither the program nor its bank."""
    mix, B, Pb = bank.mix, bank.mix["streams"], bank.mix["particles"]
    out = {"e2e": {"agg_fps": B * res["steps"] / res["seconds"], "setup_s": setup_s},
           "attempted": B * res["steps"], "failed": failed_readouts(res["probs"]),
           "timed": {"steps": res["steps"], "seconds": res["seconds"],
                     "frame_p95_ms": frame_p95_ms},
           "posterior": bank.sut.posterior_kind}
    if more is not None:
        out["profile"] = trace.profile(lambda: more(mix["profile_steps"]))
    inits = {f: (s.x, s.c) for f, s in res["inits"].items()}
    ends = {f: s.c for f, s in res["ends"].items()}
    probs_read, Zh, T, cfg, asset, seed, device = (res["probs"], bank.Zh, bank.T, bank.cfg,
                                                  bank.asset, bank.seed, bank.device)
    d, dtype = bank.sut.d, bank.sut.dtype
    banks = sorted(int(b) for b in np.random.default_rng(seed).choice(
        B, size=min(B, mix["check_banks"]), replace=False))

    def run_check():
        post = ref_gp.posterior(asset, device, "float64", cfg)
        g = torch.Generator(device=device)
        g.manual_seed(seed + 2)
        replay = Draws(B, Pb, d, dtype, g, device)
        nums = check.filter_numbers(reference, post, inits, ends, banks, frames(replay),
                                    probs_read, Zh, T)
        nums["init_bad"] = sum(check.init_bad(asset, x, c) for x, c in inits.values())
        return nums

    out["held"] = {"check": run_check}
    return out


def failed_readouts(probs_read) -> int:
    """Bank-frames whose class probabilities are not all finite."""
    return sum(int((~torch.isfinite(p)).any(dim=-1).sum()) for p in probs_read)


def p95_ms(latencies_s) -> float:
    return float(np.percentile(np.asarray(latencies_s) * 1e3, 95))
