"""Switching-state particle filter over a trained exact GPMDM.

Counterpart of ``gpmdm_tpu/filter/particle_filter.py`` on its fused-kernel
path (``PFConfig(pallas='on')``).  Each frame runs:

1. Markov class transition, by inverse CDF: one uniform per particle;
2. the per-class dynamics posterior (``fused_x_posterior``, one launch per
   class) and a draw from the selected class's predictive Gaussian;
3. observation weighting (``fused_obs_loglik``, one launch);
4. weight normalisation and the readouts, taken BEFORE resampling;
5. systematic (or multinomial) resampling.

Randomness comes from an explicit ``torch.Generator`` on the state's
device, or is injected per frame as ``PFNoise`` (the parity tests feed the
JAX package's own draws).  The step makes no host round trip: every
branch on data is a ``torch.where``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config import GPMDMConfig, PFConfig
from ..models import core
from ..ops import gp_posterior as gpk
from ..ops import kernels as K

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass
class PFState:
    """Particle filter state; ``x_prev`` carries x(t-1) for back_step=2."""

    x: torch.Tensor  # (P, d) latent states
    x_prev: torch.Tensor  # (P, d) previous latent states
    c: torch.Tensor  # (P,) int64 class of each particle
    log_w: torch.Tensor  # (P,) normalized log weights
    log_lik: torch.Tensor  # (P,) observation log-likelihood of each particle


@dataclasses.dataclass
class PFOutputs:
    """Per-step readouts (stacked on a leading frame axis by ``pf_scan``)."""

    class_probs: torch.Tensor  # (C,) posterior class probabilities
    log_likelihood: torch.Tensor  # () max-shifted weighted likelihood sum
    state_mean: torch.Tensor  # (d,) weighted mean latent state
    most_likely_class: torch.Tensor  # () argmax of class_probs


@dataclasses.dataclass
class PFNoise:
    """One frame's randomness (a leading frame axis when given to
    ``pf_scan``): transition uniforms, dynamics normals and the systematic
    resampling uniform.  Multinomial resampling draws from the generator."""

    u_trans: torch.Tensor  # (P,)
    eps_dyn: torch.Tensor  # (P, d)
    u_res: torch.Tensor  # ()


def draw_noise(P: int, d: int, generator: torch.Generator, dtype, device) -> PFNoise:
    """One frame of filter randomness from ``generator``."""
    return PFNoise(
        u_trans=torch.rand(P, generator=generator, dtype=dtype, device=device),
        eps_dyn=torch.randn(P, d, generator=generator, dtype=dtype, device=device),
        u_res=torch.rand((), generator=generator, dtype=dtype, device=device),
    )


def _init_classes(num_particles: int, n_classes: int) -> np.ndarray:
    """Split particles evenly across classes; the first ``P mod C`` classes
    get one extra."""
    base, rem = divmod(num_particles, n_classes)
    counts = [base + (1 if i < rem else 0) for i in range(n_classes)]
    return np.repeat(np.arange(n_classes, dtype=np.int64), counts)


def pf_init(post: core.Posterior, y_class_offsets: np.ndarray,
            generator: torch.Generator, pf_cfg: PFConfig) -> PFState:
    """Particles sampled (with replacement) from each class's training latents."""
    P = pf_cfg.num_particles
    C = len(y_class_offsets) - 1
    dev = post.X.device
    classes = torch.as_tensor(_init_classes(P, C), device=dev)
    offsets = torch.as_tensor(np.asarray(y_class_offsets, dtype=np.int64), device=dev)
    lo = offsets[:-1][classes]
    count = (offsets[1:] - offsets[:-1])[classes]
    u = torch.rand(P, generator=generator, device=dev)
    idx = lo + torch.floor(u * count).to(torch.int64)
    x = post.X[idx]
    return PFState(
        x=x,
        x_prev=x,
        c=classes,
        log_w=torch.full((P,), -math.log(P), dtype=x.dtype, device=dev),
        log_lik=torch.zeros(P, dtype=x.dtype, device=dev),
    )


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


def systematic_resample_indices(u: torch.Tensor, log_w: torch.Tensor,
                                w: torch.Tensor | None = None) -> torch.Tensor:
    """Systematic resampling with one uniform ``u``.

    ``s_j = clip(floor(P cum_j - u) + 1, 0, P)`` counts the positions
    ``(u + i) / P`` strictly below ``cum_j``, and ``idx_i = #{j : s_j <= i}``
    — the rank the JAX package computes with a 0/1 matmul on the TPU,
    here a binary search over the nondecreasing ``s``.  Weights are taken
    in at least fp32 (``w``, the readout stage's normalised weights, when
    given)."""
    P = log_w.shape[0]
    ct = torch.promote_types(log_w.dtype, torch.float32)
    w = torch.softmax(log_w.to(ct), dim=0) if w is None else w.to(ct)
    cum = torch.cumsum(w, dim=0)
    s = torch.clamp(torch.floor(P * cum - u.to(ct)).to(torch.int64) + 1, 0, P)
    ranks = torch.arange(P, device=log_w.device, dtype=torch.int64)
    idx = torch.searchsorted(s, ranks, right=True)
    return torch.clamp(idx, 0, P - 1)


def multinomial_resample_indices(generator: torch.Generator,
                                 log_w: torch.Tensor) -> torch.Tensor:
    """Multinomial resampling (reference parity): P draws from softmax(log_w)."""
    P = log_w.shape[0]
    w = torch.softmax(log_w.to(torch.promote_types(log_w.dtype, torch.float32)), dim=0)
    return torch.multinomial(w, P, replacement=True, generator=generator)


def _posterior_fns(pf_cfg: PFConfig):
    if pf_cfg.pallas == "off":
        return gpk.fused_x_posterior_plain, gpk.fused_obs_loglik_plain
    return gpk.fused_x_posterior, gpk.fused_obs_loglik


def pf_step(state: PFState, z: torch.Tensor, post: core.Posterior,
            params: core.GPMDMParams, log_T: torch.Tensor, cfg: GPMDMConfig,
            pf_cfg: PFConfig, noise: PFNoise | None = None,
            generator: torch.Generator | None = None) -> tuple[PFState, PFOutputs]:
    """One full filter update: (state, observation) -> (new state, readouts).

    ``noise`` supplies this frame's randomness; without it the step draws
    from ``generator``.  Multinomial resampling always needs ``generator``.
    """
    P, d = state.x.shape
    if noise is None:
        if generator is None:
            raise ValueError("pf_step needs injected noise or a generator")
        noise = draw_noise(P, d, generator, state.x.dtype, state.x.device)
    x_posterior, obs_loglik = _posterior_fns(pf_cfg)

    # 1. Markov class transition by inverse CDF against the particle's row.
    C = log_T.shape[0]
    cum_T = torch.cumsum(torch.exp(log_T), dim=1)  # (C, C), rows end at 1
    row_cum = cum_T[state.c]  # (P, C)
    u_trans = noise.u_trans.to(cum_T.dtype)
    c = torch.sum(u_trans[:, None] >= row_cum, dim=1)
    c = torch.clamp(c, max=C - 1)

    # 2. Dynamics: every class's GP posterior for every particle, select by
    #    class, sample.  n_valid = n_max disables the kernel's row mask: the
    #    precompute's zero padding of Axc / Kxc_inv annihilates the padded
    #    star-kernel rows instead.
    xin = state.x if cfg.dyn_back_step == 1 else torch.cat([state.x, state.x_prev], dim=1)
    xin = xin.contiguous()
    inv_ls = torch.exp(-params.x_log_lengthscales)
    lin_w = torch.exp(params.x_log_lin_coeff)
    diag_star = K.x_diag_kernel(
        xin, params.x_log_lin_coeff, params.x_log_sigma_n, cfg.sigma_n_num_X, False
    )
    lam_x = torch.exp(params.x_log_lambdas)[None, :] ** -2
    m_list, v_list = [], []
    for ci in range(post.Xin_c.shape[0]):
        mean_ci, quad_ci = x_posterior(
            post.Xin_c[ci], xin, post.Axc[ci], post.Kxc_inv[ci], inv_ls, lin_w,
            post.Xin_c.shape[1],
        )
        var_common = diag_star - quad_ci  # no clamp on this path
        m_list.append(mean_ci)
        v_list.append(var_common[:, None] * lam_x)
    mean = _select_by_class(torch.stack(m_list), c)
    var = torch.clamp(_select_by_class(torch.stack(v_list), c), min=1e-12)
    prop = mean + torch.sqrt(var) * noise.eps_dyn.to(mean.dtype)
    x_new = state.x + prop if cfg.dyn_target == "delta" else prop

    # 3. Observation weighting: the fused kernel returns the variance quad
    #    and the weighted residual; the log-pdf is elementwise from there.
    quad, qres = obs_loglik(
        post.X, x_new.contiguous(), post.Ay, post.Ky_inv,
        torch.exp(-params.y_log_lengthscales), z,
        torch.exp(2.0 * params.y_log_lambdas),
    )
    diag = K.y_diag_kernel(
        x_new, params.y_log_sigma_n, cfg.sigma_n_num_Y, pf_cfg.obs_noise_in_weights
    )
    var_c = torch.clamp(diag - quad, min=1e-12)
    coeff = 1.0 if pf_cfg.compat_double_logdet else 0.5
    logdet = cfg.D * torch.log(var_c) - 2.0 * torch.sum(params.y_log_lambdas)
    log_lik = -0.5 * qres / var_c - coeff * logdet - 0.5 * cfg.D * _LOG_2PI
    # dead-particle guard: a diverged particle gets likelihood zero
    neg_inf = torch.tensor(-math.inf, dtype=log_lik.dtype, device=log_lik.device)
    log_lik = torch.where(torch.isfinite(log_lik), log_lik, neg_inf)
    log_w = log_lik + state.log_w if pf_cfg.accumulate_weights else log_lik
    lse = torch.logsumexp(log_w, dim=0)
    # all-dead fallback: uniform weights instead of NaN
    log_w = torch.where(torch.isfinite(lse), log_w - lse,
                        torch.full_like(log_w, -math.log(P)))

    # 4. Readouts before resampling.
    w = torch.exp(log_w)
    lw = log_lik + log_w
    lw_max = torch.max(lw)
    lw = torch.where(torch.isfinite(lw_max), lw - lw_max, torch.zeros_like(lw))
    onehot = torch.nn.functional.one_hot(c, C).to(w.dtype)  # (P, C)
    class_scores = torch.exp(lw) @ onehot
    class_probs = class_scores / torch.sum(class_scores)
    x_safe = torch.where(torch.isfinite(x_new), x_new, torch.zeros_like(x_new))
    outputs = PFOutputs(
        class_probs=class_probs,
        log_likelihood=torch.sum(torch.exp(lw)),
        state_mean=torch.sum(x_safe * w[:, None], dim=0),
        most_likely_class=torch.argmax(class_probs),
    )

    # 5. Resampling: x, x_prev and c gathered through one packed array.
    packed = torch.cat([x_new, state.x, c.to(x_new.dtype)[:, None]], dim=1)
    if pf_cfg.resampling == "systematic":
        idx = systematic_resample_indices(noise.u_res, log_w, w=w)
    else:
        if generator is None:
            raise ValueError("multinomial resampling needs a generator")
        idx = multinomial_resample_indices(generator, log_w)
    packed_r = packed[idx]
    new_log_w = torch.full_like(log_w, -math.log(P))
    if pf_cfg.resample_threshold < 1.0:
        ess = 1.0 / torch.clamp(torch.sum(w * w), min=1e-38)
        do = ess < pf_cfg.resample_threshold * P
        packed_r = torch.where(do, packed_r, packed)
        new_log_w = torch.where(do, new_log_w, log_w)
    new_state = PFState(
        x=packed_r[:, :d],
        x_prev=packed_r[:, d:2 * d],
        c=packed_r[:, 2 * d].to(torch.int64),
        log_w=new_log_w,
        log_lik=log_lik,
    )
    return new_state, outputs


def pf_scan(state: PFState, Z: torch.Tensor, post: core.Posterior,
            params: core.GPMDMParams, log_T: torch.Tensor, cfg: GPMDMConfig,
            pf_cfg: PFConfig, generator: torch.Generator | None = None,
            noise: PFNoise | None = None) -> tuple[PFState, PFOutputs]:
    """Stream a (T, D) observation sequence through the filter, frame by
    frame; returns the final state and the readouts stacked over frames.
    ``noise`` (leading frame axis) injects every frame's randomness;
    otherwise each frame draws from ``generator``."""
    outs = []
    for t in range(Z.shape[0]):
        nz = None if noise is None else PFNoise(
            noise.u_trans[t], noise.eps_dyn[t], noise.u_res[t])
        state, out = pf_step(state, Z[t], post, params, log_T, cfg, pf_cfg,
                             noise=nz, generator=generator)
        outs.append(out)
    stacked = PFOutputs(**{
        f.name: torch.stack([getattr(o, f.name) for o in outs])
        for f in dataclasses.fields(PFOutputs)
    })
    return state, stacked


class GPMDM_PF:
    """Stateful filter over a trained model (reference ``GPMDM_PF`` API):
    ``update(z)`` per frame or ``run(Z)`` per sequence, the readouts of the
    last frame, and ``reset()`` to restart from ``seed``.  Runs on the
    model's device."""

    def __init__(self, gpmdm, markov_switching_model, num_particles: int,
                 config: Optional[PFConfig] = None, seed: int = 0):
        self._gpmdm = gpmdm
        T = np.asarray(markov_switching_model, dtype=np.float64)
        if T.shape != (gpmdm.n_classes, gpmdm.n_classes):
            raise ValueError(
                "Number of classes in the GPMDM model and the Markov model do not match"
            )
        self._log_T = torch.log(torch.as_tensor(T, device=gpmdm.device).to(gpmdm.dtype))
        self.pf_config = dataclasses.replace(config or PFConfig(),
                                             num_particles=num_particles)
        self._seed = seed
        self.reset()

    def reset(self) -> None:
        """Re-initialize the particles and the generator from the seed."""
        self.generator = torch.Generator(device=self._gpmdm.device)
        self.generator.manual_seed(self._seed)
        self.state = pf_init(self._gpmdm.posterior, self._gpmdm.layout.y_class_offsets,
                             self.generator, self.pf_config)
        self._last_outputs: Optional[PFOutputs] = None

    def _z(self, Z):
        return torch.as_tensor(np.asarray(Z), device=self._gpmdm.device).to(self._gpmdm.dtype)

    def update(self, z) -> PFOutputs:
        """One per-frame update."""
        m = self._gpmdm
        self.state, out = pf_step(self.state, self._z(z).reshape(-1), m.posterior,
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
        self.state, outs = pf_scan(self.state, Z, m.posterior, m.params, self._log_T,
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
    def num_particles(self) -> int:
        return self.pf_config.num_particles
