"""The one traffic generator: observation streams for the filter cells,
from a mix file's parameters and ``--seed``.

Streams are the synthetic limit-cycle motions that the committed assets
were trained on: a frozen copy of ``gpmdm_tpu_torch/data/synthetic.py``'s
``make_cycle`` (the classic task of ``utils/asset_guard.py``'s ``d4f`` and
``hourlong`` shapes), evaluated on the device in a few large calls.  Each
stream is held-out trials of ``trial_len`` frames back to back, each
trial of a random class and phase, so the class changes from trial to
trial; every stream's trials start on the same frames, where the filter
bank starts again.  A seed changes the classes, phases and noise, never
a size.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: Frame spacing of the generator's time axis (``make_cycle``'s 0.12).
DT = 0.12


def load_mix(name: str) -> dict:
    """The traffic mix ``perfbench/traffic/<name>.json``."""
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def lift(D: int) -> tuple[np.ndarray, np.ndarray]:
    """``make_cycle``'s fixed observation lift (its ``default_rng(1234)``
    draws): the two (2, D) matrices shared by every class."""
    rng = np.random.default_rng(1234)
    W1 = rng.normal(size=(2, D)) / np.sqrt(2)
    W2 = rng.normal(size=(2, D)) / np.sqrt(2)
    return W1, W2


def make_streams(shape: dict, n_classes: int, n_streams: int, n_frames: int,
                 generator: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(Z (n_frames, n_streams, D) float32, labels (n_frames, n_streams)
    int64) on ``device``.  ``shape`` is the configuration's ``streams``
    entry: ``trial_len``, ``D``, ``noise``, ``center_spread``,
    ``class_signature``.  The arithmetic is ``make_cycle``'s, in float64:

        freq = 1 + 0.7 c, wobble = 0.3 c      (classic task)
        freq = 1 + 0.25 c, wobble = 0.15 c    (class_signature > 0)
        theta = freq * 0.12 t + phase, r = 1 + wobble sin(3 theta)
        z = center_c + r (cos theta, sin theta)
        Y = z W1 + sin(z W2) (+ signature_c) + noise * N(0, 1)
    """
    L, D = int(shape["trial_len"]), int(shape["D"])
    sig, spread = float(shape.get("class_signature", 0.0)), float(shape.get("center_spread", 0.0))
    f64 = dict(dtype=torch.float64, device=device)
    pos = torch.arange(n_frames, device=device)[:, None].expand(n_frames, n_streams)
    trial, t_in = pos // L, pos % L
    n_trials = int((n_frames + L - 1) // L)
    cls_t = torch.randint(0, n_classes, (n_trials, n_streams), generator=generator, device=device)
    phase_t = 2 * np.pi * torch.rand(n_trials, n_streams, generator=generator, **f64)
    cols = torch.arange(n_streams, device=device)[None, :].expand_as(trial)
    cls = cls_t[trial, cols]
    phase = phase_t[trial, cols]
    c = cls.to(torch.float64)
    if sig > 0.0:
        freq, wobble = 1.0 + 0.25 * c, 0.15 * c
    else:
        freq, wobble = 1.0 + 0.7 * c, 0.3 * c
    theta = freq * (DT * t_in.to(torch.float64)) + phase
    r = 1.0 + wobble * torch.sin(3.0 * theta)
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)  # (F, B, 2)
    if spread:
        ang = 2.39996 * torch.arange(n_classes, **f64)
        centers = spread * torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
        centers[0] = 0.0
        z = z + centers[cls]
    W1, W2 = (torch.as_tensor(w, **f64) for w in lift(D))
    Y = z @ W1 + torch.sin(z @ W2)
    if sig > 0.0:
        signatures = torch.as_tensor(np.stack([np.random.default_rng(9000 + k).normal(size=(D,))
                                               for k in range(n_classes)]), **f64)
        Y = Y + sig * signatures[cls]
    Y = Y + float(shape["noise"]) * torch.randn(Y.shape, generator=generator, **f64)
    return Y.to(torch.float32), cls


def host_frames(Z: torch.Tensor) -> torch.Tensor:
    """The streams on the host, where frames arrive from: pinned when a
    card is present, so each frame's copy to the card is one DMA."""
    Zh = Z.cpu().contiguous()
    return Zh.pin_memory() if torch.cuda.is_available() else Zh
