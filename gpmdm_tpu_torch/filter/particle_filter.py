"""Switching-state particle filter over a trained GPMDM.

Counterpart of ``gpmdm_tpu/filter/particle_filter.py``, for one filter
(``pf_init``, ``pf_step``, ``pf_scan``, ``GPMDM_PF``) or a bank of B
independent filters in one call (``pf_init_bank``, ``pf_step_bank``,
``pf_scan_bank``, ``pf_scan_bank_masked``; ``pf_scan_masked`` for one
padded sequence).  One filter is a bank of one.  The GP stages dispatch
on the posterior's type, as the JAX package's do: the exact
``core.Posterior`` runs the fused kernels (the JAX package's
``PFConfig(pallas='on')`` path), the ``compressed.CompressedPosterior``
and the ``sparse.SparsePosterior`` their cuBLAS products and triangular
solves (the JAX package's XLA path).  Each frame runs:

1. Markov class transition, by inverse CDF: one uniform per particle;
2. the per-class dynamics posterior (exact: ``fused_x_posterior_classes``,
   one launch for every class over every bank's particles) and a draw
   from the selected class's predictive Gaussian;
3. observation weighting (exact: ``fused_obs_loglik``, one launch, one
   observation per bank);
4. weight normalisation and the readouts per bank, taken BEFORE
   resampling;
5. systematic resampling (its rank from ``ops.resample.resample_rank``,
   one launch over all banks, whatever the posterior) or multinomial
   resampling.

``GPMDM_PF`` picks the posterior by the JAX package's deployment policy
(``resolve_posterior``): a checkpoint's recommendation first, else the
exact posterior, or the compressed one past ``AUTO_COMPRESS_N`` training
rows; a sparse model deploys its own.

Randomness comes from an explicit ``torch.Generator`` on the state's
device, or is injected per frame as ``PFNoise`` (the parity tests feed the
JAX package's own draws).  The step makes no host round trip: every
branch on data is a ``torch.where``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import GPMDMConfig, PFConfig
from ..models import compressed, core, sparse
from ..ops import gp_posterior as gpk
from ..ops import kernels as K
from ..ops import resample as rs

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass
class PFState:
    """Particle filter state; ``x_prev`` carries x(t-1) for back_step=2.
    A bank of B filters (``pf_init_bank``) puts a leading bank axis on
    every field: x and x_prev (B, Pb, d), the others (B, Pb)."""

    x: torch.Tensor  # (P, d) latent states
    x_prev: torch.Tensor  # (P, d) previous latent states
    c: torch.Tensor  # (P,) int64 class of each particle
    log_w: torch.Tensor  # (P,) normalized log weights
    log_lik: torch.Tensor  # (P,) observation log-likelihood of each particle


@dataclasses.dataclass
class PFOutputs:
    """Per-step readouts (a bank adds a leading bank axis; ``pf_scan``
    stacks frames on a leading axis, ``pf_scan_bank`` after the bank's)."""

    class_probs: torch.Tensor  # (C,) posterior class probabilities
    log_likelihood: torch.Tensor  # () max-shifted weighted likelihood sum
    state_mean: torch.Tensor  # (d,) weighted mean latent state
    most_likely_class: torch.Tensor  # () argmax of class_probs


@dataclasses.dataclass
class PFNoise:
    """One frame's randomness (a leading frame axis when given to a scan):
    transition uniforms, dynamics normals and the systematic resampling
    uniform; a bank adds a bank axis after the frame's.  Multinomial
    resampling draws from the generator."""

    u_trans: torch.Tensor  # (P,) or (B, Pb)
    eps_dyn: torch.Tensor  # (P, d) or (B, Pb, d)
    u_res: torch.Tensor  # () or (B,)


def _map(obj, fn):
    """The same dataclass with ``fn`` applied to every field."""
    return type(obj)(**{f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def _stack(outs: list, dim: int) -> PFOutputs:
    return PFOutputs(**{f.name: torch.stack([getattr(o, f.name) for o in outs], dim=dim)
                        for f in dataclasses.fields(PFOutputs)})


def draw_noise(B: int, Pb: int, d: int, generator: torch.Generator, dtype,
               device) -> PFNoise:
    """One frame of randomness from ``generator`` for B filters of Pb
    particles each."""
    return PFNoise(
        u_trans=torch.rand(B, Pb, generator=generator, dtype=dtype, device=device),
        eps_dyn=torch.randn(B, Pb, d, generator=generator, dtype=dtype, device=device),
        u_res=torch.rand(B, generator=generator, dtype=dtype, device=device),
    )


def _init_classes(num_particles: int, n_classes: int) -> np.ndarray:
    """Split particles evenly across classes; the first ``P mod C`` classes
    get one extra."""
    base, rem = divmod(num_particles, n_classes)
    counts = [base + (1 if i < rem else 0) for i in range(n_classes)]
    return np.repeat(np.arange(n_classes, dtype=np.int64), counts)


def pf_init_bank(post, y_class_offsets: np.ndarray,
                 generator: torch.Generator, pf_cfg: PFConfig,
                 n_banks: int) -> PFState:
    """A bank of ``n_banks`` independent filters of ``num_particles`` each
    over ``post`` (any posterior), every particle sampled (with
    replacement) from its class's training latents; each bank from its own
    draws."""
    Pb = pf_cfg.num_particles
    C = len(y_class_offsets) - 1
    dev = post.X.device
    classes = torch.as_tensor(_init_classes(Pb, C), device=dev).repeat(n_banks, 1)
    offsets = torch.as_tensor(np.asarray(y_class_offsets, dtype=np.int64), device=dev)
    lo = offsets[:-1][classes]
    count = (offsets[1:] - offsets[:-1])[classes]
    u = torch.rand(n_banks, Pb, generator=generator, device=dev)
    idx = lo + torch.floor(u * count).to(torch.int64)
    x = post.X[idx]
    return PFState(
        x=x,
        x_prev=x,
        c=classes,
        log_w=torch.full((n_banks, Pb), -math.log(Pb), dtype=x.dtype, device=dev),
        log_lik=torch.zeros(n_banks, Pb, dtype=x.dtype, device=dev),
    )


def pf_init(post, y_class_offsets: np.ndarray,
            generator: torch.Generator, pf_cfg: PFConfig) -> PFState:
    """One filter: particles sampled (with replacement) from each class's
    training latents."""
    return _map(pf_init_bank(post, y_class_offsets, generator, pf_cfg, 1), lambda a: a[0])


def bucket_length(T: int, min_bucket: int = 64) -> int:
    """Smallest power-of-two bucket >= T (>= min_bucket)."""
    b = min_bucket
    while b < T:
        b *= 2
    return b


def _select_by_class(per_class: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Rows of a (C, P, d) array by particle class, as a one-hot sum (the
    JAX package's form: a non-finite value in an unselected class turns
    the row NaN, which the dead-particle guard then retires)."""
    onehot = torch.nn.functional.one_hot(c, per_class.shape[0]).to(per_class.dtype)
    return torch.sum(per_class * onehot.T[:, :, None], dim=0)


def observation_log_lik(z, mean, var, D: int, compat_double_logdet: bool):
    """Batched diagonal-Gaussian observation log-likelihood."""
    quad = torch.sum((z[None, :] - mean) ** 2 / var, dim=1)
    logdet = torch.sum(torch.log(var), dim=1)
    logdet_coeff = 1.0 if compat_double_logdet else 0.5
    return -0.5 * quad - logdet_coeff * logdet - 0.5 * D * _LOG_2PI


def systematic_counts(u: torch.Tensor, log_w: torch.Tensor,
                      w: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Pb) int32 ``s_j = clip(floor(Pb cum_j - u) + 1, 0, Pb)``: how many
    of the positions ``(u + i) / Pb`` lie strictly below ``cum_j``, for
    ``log_w`` (P,) with ``u`` () (B = 1) or (B, Pb) with ``u`` (B,).
    Weights are taken in at least fp32 (``w``, the readout stage's
    normalised weights, when given)."""
    P = log_w.shape[-1]
    ct = torch.promote_types(log_w.dtype, torch.float32)
    w = torch.softmax(log_w.to(ct), dim=-1) if w is None else w.to(ct)
    cum = torch.cumsum(w, dim=-1)
    s = torch.floor(P * cum - u.to(ct)[..., None]).to(torch.int64) + 1
    return torch.clamp(s, 0, P).to(torch.int32).reshape(-1, P)


def systematic_resample_indices(u: torch.Tensor, log_w: torch.Tensor,
                                w: torch.Tensor | None = None,
                                rank=rs.resample_rank) -> torch.Tensor:
    """Systematic resampling, for one filter (``log_w`` (P,), ``u`` ()) or
    a bank (``log_w`` (B, Pb), ``u`` (B,)): indices into each filter's own
    particles, ``idx_i = #{j : s_j <= i}`` with ``s`` from
    ``systematic_counts``.  That is the rank that the JAX package
    computes with a 0/1 matmul on the TPU; here ``rank`` counts it: the
    kernel K3 (``ops.resample.resample_rank``, its plain version for
    tensors on the CPU) or ``resample_rank_plain``."""
    return rank(systematic_counts(u, log_w, w)).reshape(log_w.shape)


def multinomial_resample_indices(generator: torch.Generator,
                                 log_w: torch.Tensor) -> torch.Tensor:
    """Multinomial resampling (reference parity): P draws from
    softmax(log_w) for each filter, ``log_w`` (P,) or (B, P)."""
    P = log_w.shape[-1]
    w = torch.softmax(log_w.to(torch.promote_types(log_w.dtype, torch.float32)), dim=-1)
    return torch.multinomial(w, P, replacement=True, generator=generator)


def _kernel_fns(pf_cfg: PFConfig):
    """K1, K2 and K3, or their plain versions under ``pallas='off'``."""
    if pf_cfg.pallas == "off":
        return (gpk.fused_x_posterior_classes_plain, gpk.fused_obs_loglik_plain,
                rs.resample_rank_plain)
    return gpk.fused_x_posterior_classes, gpk.fused_obs_loglik, rs.resample_rank


def _effective_quad_precision(pf_cfg: PFConfig, post):
    """The sparse posterior's variance path, as the JAX package chooses it:
    None (the per-frame triangular solves) when ``quad_precision`` is
    'trisolve', or unset on a sparse model's own posterior; otherwise a
    precision name (the hoisted inverses): the one set, or 'high' when it
    is unset on a distilled posterior (the JAX package measured that path
    faster and more accurate on distillations, while the hourlong sparse
    model lost guard accuracy on it).  The port's products are all IEEE
    fp32, so the name picks the algorithm only."""
    if pf_cfg.quad_precision is None and post.distilled:
        return "high"
    return None if pf_cfg.quad_precision in (None, "trisolve") else pf_cfg.quad_precision


def _dynamics(post, params, xin, cfg: GPMDMConfig, pf_cfg: PFConfig):
    """Every class's dynamics posterior at every particle: means and
    per-dimension variances (C, P, d).  Exact: K1, one launch for all
    classes (n_valid = n_max disables its row mask: the precompute's zero
    padding of Axc / Kxc_inv annihilates the padded star-kernel rows),
    the common variance not clamped.  Compressed: its products, the
    common variance clamped at 1e-9.  Sparse: its products or triangular
    solves, clamped at 1e-12."""
    if isinstance(post, compressed.CompressedPosterior):
        return compressed.predict_x_all_classes(post, params, xin, cfg)
    if isinstance(post, sparse.SparsePosterior):
        return sparse.predict_x_all_classes(
            post, params, xin, cfg, quad_precision=_effective_quad_precision(pf_cfg, post))
    x_posterior = _kernel_fns(pf_cfg)[0]
    diag_star = K.x_diag_kernel(
        xin, params.x_log_lin_coeff, params.x_log_sigma_n, cfg.sigma_n_num_X, False
    )
    means, quads = x_posterior(post.Xin_c, xin, post.Axc, post.Kxc_inv,
                               torch.exp(-params.x_log_lengthscales),
                               torch.exp(params.x_log_lin_coeff), post.Xin_c.shape[1])
    var_common = diag_star[None] - quads  # (C, P)
    return means, var_common[:, :, None] * torch.exp(params.x_log_lambdas)[None, :] ** -2


def _observation_log_lik(post, params, x_new, z, cfg: GPMDMConfig, pf_cfg: PFConfig):
    """(P,) log-likelihood of each particle against its own bank's
    observation, ``z`` (B, D).  Exact: K2 returns the variance quad and
    the weighted residual, the log-pdf is elementwise from there.
    Compressed and sparse: their predictions, then the diagonal-Gaussian
    log-pdf."""
    coeff = 1.0 if pf_cfg.compat_double_logdet else 0.5
    if not isinstance(post, core.Posterior):
        if isinstance(post, sparse.SparsePosterior):
            mean_y, var_y = sparse.predict_y(
                post, params, x_new, cfg, with_noise=pf_cfg.obs_noise_in_weights,
                quad_precision=_effective_quad_precision(pf_cfg, post))
        else:
            mean_y, var_y = compressed.predict_y(post, params, x_new, cfg,
                                                 with_noise=pf_cfg.obs_noise_in_weights)
        var_y = torch.clamp(var_y, min=1e-12)
        B, D = z.shape
        resid = z[:, None, :] - mean_y.reshape(B, -1, D)
        quad = torch.sum(resid**2 / var_y.reshape(B, -1, D), dim=2).reshape(-1)
        logdet = torch.sum(torch.log(var_y), dim=1)
        return -0.5 * quad - coeff * logdet - 0.5 * D * _LOG_2PI
    quad, qres = _kernel_fns(pf_cfg)[1](
        post.X, x_new.contiguous(), post.Ay, post.Ky_inv,
        torch.exp(-params.y_log_lengthscales), z.contiguous(),
        torch.exp(2.0 * params.y_log_lambdas),
    )
    diag = K.y_diag_kernel(
        x_new, params.y_log_sigma_n, cfg.sigma_n_num_Y, pf_cfg.obs_noise_in_weights
    )
    var_c = torch.clamp(diag - quad, min=1e-12)
    logdet = cfg.D * torch.log(var_c) - 2.0 * torch.sum(params.y_log_lambdas)
    return -0.5 * qres / var_c - coeff * logdet - 0.5 * cfg.D * _LOG_2PI


def pf_step_bank(states: PFState, z: torch.Tensor, post, params: core.GPMDMParams,
                 log_T: torch.Tensor, cfg: GPMDMConfig, pf_cfg: PFConfig,
                 noise: PFNoise | None = None,
                 generator: torch.Generator | None = None) -> tuple[PFState, PFOutputs]:
    """One update of B independent filters: (states, observations (B, D))
    -> (new states, readouts with a leading bank axis).  ``post`` is an
    exact ``core.Posterior``, a ``compressed.CompressedPosterior`` or a
    ``sparse.SparsePosterior``.

    Counterpart of the JAX package's flat-bank step: the GP stages run on
    the flat (B * Pb, d) particle set as one filter would (exact: one
    launch of K1 for all C classes, one of K2 with one observation per
    bank), and only the O(P) glue is bank-blocked: weight normalisation,
    readouts, the ESS select, the rank K3 over (B, Pb) and one flat
    offset gather.  ``noise`` supplies this frame's randomness; without
    it the step draws from ``generator``.  Multinomial resampling always
    needs ``generator``.
    """
    if not isinstance(post, (core.Posterior, compressed.CompressedPosterior,
                             sparse.SparsePosterior)):
        raise TypeError(f"unknown posterior backend: {type(post)!r}")
    B, Pb, d = states.x.shape
    P = B * Pb
    if noise is None:
        if generator is None:
            raise ValueError("pf_step needs injected noise or a generator")
        noise = draw_noise(B, Pb, d, generator, states.x.dtype, states.x.device)
    rank = _kernel_fns(pf_cfg)[2]

    # 1. Markov class transition by inverse CDF against the particle's row.
    C = log_T.shape[0]
    cum_T = torch.cumsum(torch.exp(log_T), dim=1)  # (C, C), rows end at 1
    row_cum = cum_T[states.c.reshape(P)]  # (P, C)
    u_trans = noise.u_trans.reshape(P).to(cum_T.dtype)
    c = torch.sum(u_trans[:, None] >= row_cum, dim=1)
    c = torch.clamp(c, max=C - 1)

    # 2. Dynamics: every class's GP posterior for every particle, select by
    #    class, sample.
    x_flat = states.x.reshape(P, d)
    xin = x_flat if cfg.dyn_back_step == 1 else torch.cat(
        [x_flat, states.x_prev.reshape(P, d)], dim=1)
    means, variances = _dynamics(post, params, xin.contiguous(), cfg, pf_cfg)
    mean = _select_by_class(means, c)
    var = torch.clamp(_select_by_class(variances, c), min=1e-12)
    prop = mean + torch.sqrt(var) * noise.eps_dyn.reshape(P, d).to(mean.dtype)
    x_new = x_flat + prop if cfg.dyn_target == "delta" else prop

    # 3. Observation weighting against each particle's own bank's
    #    observation.
    log_lik = _observation_log_lik(post, params, x_new, z, cfg, pf_cfg)
    # dead-particle guard: a diverged particle gets likelihood zero
    neg_inf = torch.tensor(-math.inf, dtype=log_lik.dtype, device=log_lik.device)
    log_lik = torch.where(torch.isfinite(log_lik), log_lik, neg_inf).reshape(B, Pb)
    log_w = log_lik + states.log_w if pf_cfg.accumulate_weights else log_lik
    lse = torch.logsumexp(log_w, dim=1, keepdim=True)
    # all-dead fallback: uniform weights instead of NaN
    log_w = torch.where(torch.isfinite(lse), log_w - lse,
                        torch.full_like(log_w, -math.log(Pb)))

    # 4. Readouts before resampling, per bank.
    w = torch.exp(log_w)
    lw = log_lik + log_w
    lw_max = torch.amax(lw, dim=1, keepdim=True)
    lw = torch.where(torch.isfinite(lw_max), lw - lw_max, torch.zeros_like(lw))
    elw = torch.exp(lw)
    onehot = torch.nn.functional.one_hot(c, C).to(w.dtype).reshape(B, Pb, C)
    class_scores = torch.bmm(elw[:, None, :], onehot)[:, 0]  # (B, C)
    class_probs = class_scores / torch.sum(class_scores, dim=1, keepdim=True)
    x_safe = torch.where(torch.isfinite(x_new), x_new, torch.zeros_like(x_new))
    outputs = PFOutputs(
        class_probs=class_probs,
        log_likelihood=torch.sum(elw, dim=1),
        state_mean=torch.sum(x_safe.reshape(B, Pb, d) * w[:, :, None], dim=1),
        most_likely_class=torch.argmax(class_probs, dim=1),
    )

    # 5. Resampling: per-bank indices, then x, x_prev and c gathered
    #    through one packed array by one flat offset gather.
    packed = torch.cat([x_new, x_flat, c.to(x_new.dtype)[:, None]], dim=1)
    if pf_cfg.resampling == "systematic":
        idx = systematic_resample_indices(noise.u_res, log_w, w=w, rank=rank)
    else:
        if generator is None:
            raise ValueError("multinomial resampling needs a generator")
        idx = multinomial_resample_indices(generator, log_w)
    offsets = Pb * torch.arange(B, device=idx.device, dtype=idx.dtype)
    packed_r = packed[(idx + offsets[:, None]).reshape(P)]
    new_log_w = torch.full_like(log_w, -math.log(Pb))
    if pf_cfg.resample_threshold < 1.0:
        ess = 1.0 / torch.clamp(torch.sum(w * w, dim=1), min=1e-38)  # (B,)
        do = ess < pf_cfg.resample_threshold * Pb
        packed_r = torch.where(do[:, None].expand(B, Pb).reshape(P, 1), packed_r, packed)
        new_log_w = torch.where(do[:, None], new_log_w, log_w)
    new_states = PFState(
        x=packed_r[:, :d].reshape(B, Pb, d),
        x_prev=packed_r[:, d:2 * d].reshape(B, Pb, d),
        c=packed_r[:, 2 * d].to(torch.int64).reshape(B, Pb),
        log_w=new_log_w,
        log_lik=log_lik,
    )
    return new_states, outputs


def pf_step(state: PFState, z: torch.Tensor, post,
            params: core.GPMDMParams, log_T: torch.Tensor, cfg: GPMDMConfig,
            pf_cfg: PFConfig, noise: PFNoise | None = None,
            generator: torch.Generator | None = None) -> tuple[PFState, PFOutputs]:
    """One full filter update: (state, observation (D,)) -> (new state,
    readouts); a bank of one filter.

    ``noise`` supplies this frame's randomness; without it the step draws
    from ``generator``.  Multinomial resampling always needs ``generator``.
    """
    new, out = pf_step_bank(
        _map(state, lambda a: a[None]), z[None], post, params, log_T, cfg, pf_cfg,
        noise=None if noise is None else _map(noise, lambda a: a[None]),
        generator=generator)
    return _map(new, lambda a: a[0]), _map(out, lambda a: a[0])


def pf_scan(state: PFState, Z: torch.Tensor, post,
            params: core.GPMDMParams, log_T: torch.Tensor, cfg: GPMDMConfig,
            pf_cfg: PFConfig, generator: torch.Generator | None = None,
            noise: PFNoise | None = None) -> tuple[PFState, PFOutputs]:
    """Stream a (T, D) observation sequence through the filter, frame by
    frame; returns the final state and the readouts stacked over frames.
    ``noise`` (leading frame axis) injects every frame's randomness;
    otherwise each frame draws from ``generator``.  A bank of one."""
    return pf_scan_masked(state, Z, None, post, params, log_T, cfg, pf_cfg,
                          generator=generator, noise=noise)


def pf_scan_masked(state: PFState, Z: torch.Tensor, valid, post,
                   params: core.GPMDMParams, log_T: torch.Tensor, cfg: GPMDMConfig,
                   pf_cfg: PFConfig, generator: torch.Generator | None = None,
                   noise: PFNoise | None = None) -> tuple[PFState, PFOutputs]:
    """``pf_scan`` over a padded (T_pad, D) sequence: on a frame where
    ``valid[t]`` (T_pad,) is False the state passes through unchanged (the
    frame's readouts are computed and meaningless, to be sliced off).
    ``noise`` is indexed by frame position, so a masked frame consumes its
    draws; for the prefix-valid masks of padded trials the valid frames
    see the draws of an unmasked scan.  A bank of one
    (``pf_scan_bank_masked``)."""
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=state.x.device)[None]
    new, outs = pf_scan_bank_masked(
        _map(state, lambda a: a[None]), Z[None], valid, post, params, log_T, cfg, pf_cfg,
        generator=generator,
        noise=None if noise is None else _map(noise, lambda a: a.unsqueeze(1)))
    return _map(new, lambda a: a[0]), _map(outs, lambda a: a[0])


def pf_scan_bank_masked(states: PFState, Z: torch.Tensor, valid: torch.Tensor | None,
                        post, params: core.GPMDMParams,
                        log_T: torch.Tensor, cfg: GPMDMConfig, pf_cfg: PFConfig,
                        generator: torch.Generator | None = None,
                        noise: PFNoise | None = None) -> tuple[PFState, PFOutputs]:
    """B independent filters over B padded sequences: ``Z`` (B, T, D),
    ``valid`` (B, T) bool on the states' device.  On a frame where
    ``valid[b, t]`` is False, bank b's state passes through unchanged (its
    readouts for that frame are computed and meaningless); the kernels
    still run over every bank, so launch counts do not depend on the mask.
    Returns the final states and readouts of shape (B, T, ...).
    ``noise`` (leading frame axis, then bank) injects every frame's
    randomness; otherwise each frame draws from ``generator``."""
    return scan_bank_frames(states, Z, valid, post, params, log_T, cfg, pf_cfg,
                            lambda t: None if noise is None else _map(noise, lambda a: a[t]),
                            generator)


def scan_bank_frames(states: PFState, Z: torch.Tensor, valid: torch.Tensor | None, post,
                     params: core.GPMDMParams, log_T: torch.Tensor, cfg: GPMDMConfig,
                     pf_cfg: PFConfig, frame_noise,
                     generator: torch.Generator | None = None) -> tuple[PFState, PFOutputs]:
    """The frame loop of :func:`pf_scan_bank_masked`, frame t's randomness
    from ``frame_noise(t)`` (a ``PFNoise``, or None to draw from
    ``generator``)."""
    outs = []
    for t in range(Z.shape[1]):
        new, out = pf_step_bank(states, Z[:, t], post, params, log_T, cfg, pf_cfg,
                                noise=frame_noise(t), generator=generator)
        if valid is not None:
            v = valid[:, t]
            keep = lambda a, b: torch.where(v.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
            new = PFState(**{f.name: keep(getattr(new, f.name), getattr(states, f.name))
                             for f in dataclasses.fields(PFState)})
        states = new
        outs.append(out)
    return states, _stack(outs, dim=1)


def pf_scan_bank(states: PFState, Z: torch.Tensor, post,
                 params: core.GPMDMParams, log_T: torch.Tensor, cfg: GPMDMConfig,
                 pf_cfg: PFConfig, generator: torch.Generator | None = None,
                 noise: PFNoise | None = None) -> tuple[PFState, PFOutputs]:
    """B independent filters over (B, T, D) observations, every frame valid;
    readouts of shape (B, T, ...)."""
    return pf_scan_bank_masked(states, Z, None, post, params, log_T, cfg, pf_cfg,
                               generator=generator, noise=noise)


#: Training-set size past which the JAX package measured its exact
#: posterior's f32 variance quad breaking classification on the TPU at
#: its default matmul precision (0.547 frame accuracy at Ny = 5,120).
_EXACT_QUAD_SAFE_N = 4096

#: Training-set size above which ``posterior='auto'`` deploys an exact
#: model through its compressed posterior.
AUTO_COMPRESS_N = 1024

#: FLOP-parity bound of the 'auto' policy: the compressed quad costs two
#: O(N q P) products against the exact quad's one O(N^2 P), so past
#: q = N/2 compression cannot pay and 'auto' deploys the exact posterior.
AUTO_COMPRESS_MAX_Q_FRAC = 0.5

#: Flat-spectrum advisory band: past q/N = 0.20 'auto' still compresses,
#: and warns that a rank this high usually means an early-stopped or
#: drifting model.
AUTO_COMPRESS_FLAT_Q_FRAC = 0.20


def resolve_posterior(gpmdm, posterior="auto"):
    """The JAX package's deployment policy: the posterior that
    ``posterior`` names for ``gpmdm``.

    - ``'auto'`` (the ``GPMDM_PF`` default): a guard-measured deployment
      recommendation that the checkpoint carries wins: 'sparsified' with
      its M, Mx and method (``gpmdm.sparsified_posterior``; a model that
      deploys its own posterior cannot honour it and falls back with a
      warning), 'compressed' with its ranks, or 'exact'.  Without one, the
      model's own posterior; an exact model's is swapped for
      ``gpmdm.compressed_posterior()`` when Ny > ``AUTO_COMPRESS_N``,
      unless its rank is past the FLOP-parity bound
      (``AUTO_COMPRESS_MAX_Q_FRAC``; warns and deploys exact).  A rank in
      the flat-spectrum band warns and compresses.  The decision reads
      the model's family and layout only, so a loaded checkpoint that
      lands on a persisted cache never builds the exact posterior, and a
      sparse model (``_deploys_core_posterior`` False) never builds a
      compressed one: at hourlong's Ny = 108,000 that would be a float64
      eigendecomposition of a 93 GB Gram.
    - ``'exact'`` or ``None``: the model's own posterior.
    - ``'compressed'``: ``gpmdm.compressed_posterior()``.
    - a posterior object: used as it is.
    """
    if posterior is None or (isinstance(posterior, str) and posterior == "exact"):
        gpmdm._require_posterior()
        return gpmdm.posterior
    if not isinstance(posterior, str):
        return posterior
    if posterior == "compressed":
        return gpmdm.compressed_posterior()
    if posterior != "auto":
        raise ValueError(f"posterior={posterior!r}: expected 'auto', 'exact', "
                         "'compressed', or a posterior object")
    rec = gpmdm._deploy_recommendation
    if rec:
        fam = rec.get("family")
        if fam == "sparsified" and gpmdm._deploys_core_posterior:
            return gpmdm.sparsified_posterior(
                int(rec["M"]), n_inducing_x=None if rec.get("Mx") is None else int(rec["Mx"]),
                method=rec.get("method", "stride"))
        if fam == "compressed":
            return gpmdm.compressed_posterior(rank_y=rec.get("rank_y"),
                                              rank_x=rec.get("rank_x"))
        if fam == "exact":
            gpmdm._require_posterior()
            return gpmdm.posterior
        if fam == "sparsified":
            warnings.warn(
                "deploy recommendation 'sparsified' requires an exact-family model "
                f"(GPMDM.sparsified_posterior); {type(gpmdm).__name__} cannot honor it "
                "— check for a checkpoint/model mismatch.  Falling back to the "
                "size-threshold policy.", stacklevel=3)
        else:
            warnings.warn(f"ignoring unknown deploy recommendation {rec!r}; "
                          "falling back to the size-threshold policy", stacklevel=3)
    N = gpmdm.layout.Ny
    if not gpmdm._deploys_core_posterior or N <= AUTO_COMPRESS_N:
        gpmdm._require_posterior()
        return gpmdm.posterior
    cp = gpmdm.compressed_posterior()
    if cp.rank_y > AUTO_COMPRESS_MAX_Q_FRAC * N:
        # the cache entry stays: GPMDM_PF re-resolves 'auto' on every call,
        # and evicting would re-run the eigendecomposition each time;
        # save_model leaves such an entry out instead
        warnings.warn(
            f"posterior='auto': spectral quad rank {cp.rank_y}/{N} is past the "
            "q=N/2 FLOP-parity bound (near-identity Gram); compression cannot "
            "pay — deploying the EXACT posterior.  Pass posterior='compressed' "
            "or a compressed_posterior(rank_y=...) object to override.",
            stacklevel=3)
        gpmdm._require_posterior()
        return gpmdm.posterior
    if cp.rank_y > AUTO_COMPRESS_FLAT_Q_FRAC * N:
        warnings.warn(
            f"posterior='auto': spectral quad rank {cp.rank_y}/{N} is in the "
            f"flat-spectrum band (> {AUTO_COMPRESS_FLAT_Q_FRAC:.0%} of Ny): "
            "compression still deploys (it beat exact on both speed and accuracy "
            "on the measured flat-spectrum asset) but a rank this high usually "
            "means an early-stopped or drifting model — validate with an "
            "accuracy guard (utils.asset_guard.guard_report).",
            stacklevel=3)
    return cp


def warn_if_unsafe_exact(post, pf_cfg: PFConfig) -> None:
    """Warn when an exact posterior is deployed at a size where the JAX
    package measured its quad breaking classification on the TPU.  The
    condition is the JAX package's, on the precision names that the port
    carries and ignores; the message says what the port measured."""
    effective_quad = pf_cfg.quad_precision or pf_cfg.precision
    if (isinstance(post, core.Posterior) and post.X.shape[0] > _EXACT_QUAD_SAFE_N
            and effective_quad != "highest" and post.X.dtype != torch.float64):
        warnings.warn(
            f"exact GP posterior with Ny={post.X.shape[0]} > {_EXACT_QUAD_SAFE_N}: "
            "the JAX package measured its variance quad breaking classification "
            "at this scale on the TPU under its 'high' matmul precision (0.547 "
            "frame accuracy at Ny=5120).  The port computes the quad in full "
            "fp32, where the Ny=5120 asset's exact banked guard read 0.9978 on "
            "an NVIDIA H100 (chip_smoke.py); model.compressed_posterior() serves "
            "this size in less time.",
            stacklevel=3)


class GPMDM_PF:
    """Stateful filter over a trained model (reference ``GPMDM_PF`` API):
    ``update(z)`` per frame or ``run(Z)`` per sequence, the readouts of the
    last frame, and ``reset()`` to restart from ``seed``.  Runs on the
    model's device.

    ``posterior`` picks the deployed posterior through
    :func:`resolve_posterior`: ``'auto'`` (default), ``'exact'`` or
    ``None`` (the model's own), ``'compressed'``, or a posterior object
    (exact, compressed or sparse).  A string stays
    unpinned and is resolved again on every call, so a later
    ``train_adam`` is served at once; an object pins it."""

    def __init__(self, gpmdm, markov_switching_model, num_particles: int,
                 config: Optional[PFConfig] = None, seed: int = 0, posterior="auto"):
        self._gpmdm = gpmdm
        if posterior is None or isinstance(posterior, str):
            self._posterior_mode, self._posterior_override = posterior, None
        else:
            self._posterior_mode, self._posterior_override = None, posterior
        T = np.asarray(markov_switching_model, dtype=np.float64)
        if T.shape != (gpmdm.n_classes, gpmdm.n_classes):
            raise ValueError(
                "Number of classes in the GPMDM model and the Markov model do not match"
            )
        self._log_T = torch.log(torch.as_tensor(T, device=gpmdm.device).to(gpmdm.dtype))
        self.pf_config = dataclasses.replace(config or PFConfig(),
                                             num_particles=num_particles)
        self._seed = seed
        warn_if_unsafe_exact(self._post, self.pf_config)
        self.reset()

    @property
    def _post(self):
        if self._posterior_override is not None:
            return self._posterior_override
        return resolve_posterior(self._gpmdm, self._posterior_mode)

    def reset(self) -> None:
        """Re-initialize the particles and the generator from the seed."""
        self.generator = torch.Generator(device=self._gpmdm.device)
        self.generator.manual_seed(self._seed)
        self.state = pf_init(self._post, self._gpmdm.layout.y_class_offsets,
                             self.generator, self.pf_config)
        self._last_outputs: Optional[PFOutputs] = None

    def _z(self, Z):
        """Observations as a tensor on the model's device in its dtype:
        from numpy, a list, or a tensor on any device."""
        Z = Z if torch.is_tensor(Z) else torch.as_tensor(np.asarray(Z))
        return Z.to(device=self._gpmdm.device, dtype=self._gpmdm.dtype)

    def update(self, z) -> PFOutputs:
        """One per-frame update."""
        m = self._gpmdm
        self.state, out = pf_step(self.state, self._z(z).reshape(-1), self._post,
                                  m.params, self._log_T, m.config, self.pf_config,
                                  generator=self.generator)
        self._last_outputs = out
        return out

    def run(self, Z) -> PFOutputs:
        """Stream a whole (T, D) sequence; returns the stacked readouts."""
        m = self._gpmdm
        Z = self._z(Z)
        if Z.ndim == 1:
            Z = Z[None, :]
        self.state, outs = pf_scan(self.state, Z, self._post, m.params, self._log_T,
                                   m.config, self.pf_config, generator=self.generator)
        self._last_outputs = PFOutputs(**{
            f.name: getattr(outs, f.name)[-1] for f in dataclasses.fields(PFOutputs)
        })
        return outs

    def _require_update(self) -> PFOutputs:
        if self._last_outputs is None:
            raise RuntimeError("no observation processed yet; call update() or run()")
        return self._last_outputs

    def class_probabilities(self) -> np.ndarray:
        return self._require_update().class_probs.cpu().numpy()

    def get_most_likely_class(self) -> int:
        return int(self._require_update().most_likely_class)

    def log_likelihood(self) -> float:
        """Max-shifted weighted likelihood sum (the reference's return value,
        a linear-space sum despite the name)."""
        return float(self._require_update().log_likelihood)

    def current_state_mean(self) -> np.ndarray:
        return self._require_update().state_mean.cpu().numpy()

    @property
    def latent_dim(self) -> int:
        return self._gpmdm.d

    @property
    def observation_dim(self) -> int:
        return self._gpmdm.D

    @property
    def num_classes(self) -> int:
        return self._gpmdm.n_classes

    @property
    def num_particles(self) -> int:
        return self.pf_config.num_particles

    @property
    def dtype(self) -> torch.dtype:
        return self._gpmdm.dtype
