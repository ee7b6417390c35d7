"""The reference switching particle filter: one update of B independent
filters, written from the GPMDM filter's description (Markov class
transition, the class's dynamics posterior and a Gaussian draw,
observation weighting, normalisation, the readouts, systematic
resampling), with none of the program's code.

It implements the filter settings the configurations state
(``FILTER``): systematic resampling at every frame, weights not carried
over, the observation scored against the noisy predictive Gaussian, the
log-determinant not doubled.  Randomness is handed in: the transition
uniforms (B, Pb), the standard normals of the draw (B, Pb, d) and one
resampling uniform per bank (B,).
"""

from __future__ import annotations

import math

import torch

#: The filter settings this reference implements (``PFConfig``'s names).
FILTER = {"resampling": "systematic", "accumulate_weights": False,
          "obs_noise_in_weights": True, "compat_double_logdet": False,
          "resample_threshold": 1.0}


def step(post, x: torch.Tensor, c: torch.Tensor, z: torch.Tensor, u_trans: torch.Tensor,
         eps: torch.Tensor, u_res: torch.Tensor, T: torch.Tensor):
    """One update.  ``x`` (B, Pb, d) particles, ``c`` (B, Pb) classes, ``z``
    (B, D) observations, ``T`` (C, C) the class transition matrix, all in
    ``post.dtype``.  Returns (x, c) after resampling and the readouts
    taken before it: class probabilities (B, C) and the weighted mean
    latent state (B, d)."""
    B, Pb, d = x.shape
    C = T.shape[0]
    dt = post.dtype
    x, z, u_trans, eps, u_res = (a.to(dt) for a in (x, z, u_trans, eps, u_res))
    # 1. class transition by the inverse CDF of the particle's row of T
    cum = torch.cumsum(T.to(dt), dim=1)[c]  # (B, Pb, C)
    c_new = torch.clamp(torch.sum(u_trans[..., None] >= cum, dim=-1), max=C - 1)
    # 2. the new class's dynamics posterior, and a draw from it
    means, variances = post.dynamics(x.reshape(-1, d))  # (C, P, d)
    sel = c_new.reshape(-1)
    rows = torch.arange(sel.shape[0], device=x.device)
    mean, var = means[sel, rows], torch.clamp(variances[sel, rows], min=1e-12)
    x_new = (mean + torch.sqrt(var) * eps.reshape(-1, d)).reshape(B, Pb, d)
    # 3. observation weighting; a non-finite likelihood counts as zero
    log_lik = post.log_lik(x_new, z)
    log_lik = torch.where(torch.isfinite(log_lik), log_lik, torch.full_like(log_lik, -math.inf))
    lse = torch.logsumexp(log_lik, dim=1, keepdim=True)
    log_w = torch.where(torch.isfinite(lse), log_lik - lse,
                        torch.full_like(log_lik, -math.log(Pb)))
    w = torch.exp(log_w)
    # 4. readouts: class scores weight each particle by w * likelihood,
    # shifted by the bank's largest; the latent mean by w
    lw = log_lik + log_w
    lw_max = torch.amax(lw, dim=1, keepdim=True)
    elw = torch.where(torch.isfinite(lw_max), torch.exp(lw - lw_max), torch.ones_like(lw))
    scores = torch.stack([torch.sum(elw * (c_new == k), dim=1) for k in range(C)], dim=1)
    probs = scores / torch.sum(scores, dim=1, keepdim=True)
    x_safe = torch.where(torch.isfinite(x_new), x_new, torch.zeros_like(x_new))
    state_mean = torch.sum(x_safe * w[..., None], dim=1)
    # 5. systematic resampling: particle i takes the first j whose
    # cumulative weight passes (u + i) / Pb
    cum_w = torch.cumsum(w, dim=1)
    pos = (u_res[:, None] + torch.arange(Pb, device=x.device, dtype=dt)[None, :]) / Pb
    idx = torch.clamp(torch.searchsorted(cum_w.contiguous(), pos.contiguous(), right=True),
                      max=Pb - 1)
    x_r = torch.gather(x_new, 1, idx[..., None].expand(B, Pb, d))
    c_r = torch.gather(c_new, 1, idx)
    return x_r, c_r, probs, state_mean
