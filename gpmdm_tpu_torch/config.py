"""Model and particle-filter configuration for the PyTorch port.

The same fields, defaults and validation as ``gpmdm_tpu.config``
(``GPMDMConfig``, ``PFConfig``), so a checkpoint's JSON config and a filter
configuration mean the same thing in both packages, and ``TrainConfig``,
the optimizer's settings.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class GPMDMConfig:
    """Static configuration of a GPMDM model.

    D / d: observation and latent dimensions; n_classes: one dynamics GP per
    class; dyn_target: 'full' predicts x(t+1), 'delta' predicts
    x(t+1) - x(t); dyn_back_step: 1 uses x(t), 2 uses [x(t), x(t-1)];
    sigma_n_num_Y / sigma_n_num_X: extra noise std on the Gram diagonals;
    class_jitter: jitter on each per-class dynamics Gram before inversion;
    flg_train_*: trainability flags; dtype: 'float32' | 'float64' |
    'bfloat16'; hyperprior_*: the log-space hyperprior of the loss
    (``models.core.hyperprior_penalty``); deflate_x_linear: factor the
    dynamics Gram without its linear term (``x_block_terms_deflated``).
    """

    D: int
    d: int
    n_classes: int
    dyn_target: str = "full"
    dyn_back_step: int = 1
    sigma_n_num_Y: float = 0.0
    sigma_n_num_X: float = 0.0
    class_jitter: float = 1e-6
    flg_train_y_lambdas: bool = True
    flg_train_y_lengthscales: bool = True
    flg_train_y_sigma_n: bool = True
    flg_train_x_lambdas: bool = True
    flg_train_x_lengthscales: bool = True
    flg_train_x_sigma_n: bool = True
    flg_train_x_lin_coeff: bool = True
    balance_fix: bool = True
    dtype: str = "float32"
    back_constraint_ls: float = 0.0
    hyperprior_weight: float = 0.0
    hyperprior_centers: Tuple[float, ...] | None = None
    hyperprior_weights: Tuple[float, ...] | None = None
    deflate_x_linear: bool = True

    # Hyperprior centers when none are given: the log of the GPMDM
    # constructor's default inits (a class attribute, not a field).
    _HYPERPRIOR_DEFAULT_CENTERS = (0.0, 0.0, float(np.log(1e-2)),
                                   0.0, 0.0, float(np.log(1e-2)), 0.0)

    def __post_init__(self):
        if self.dyn_target not in ("full", "delta"):
            raise ValueError("dyn_target must be 'full' or 'delta'")
        if self.dyn_back_step not in (1, 2):
            raise ValueError("dyn_back_step must be 1 or 2")
        if self.n_classes < 1:
            raise ValueError("n_classes must be >= 1")
        if self.dtype not in _TORCH_DTYPES:
            raise ValueError("dtype must be 'float32', 'float64' or 'bfloat16'")
        if self.hyperprior_weight < 0.0:
            raise ValueError("hyperprior_weight must be >= 0")
        if self.hyperprior_centers is not None:
            c = tuple(float(v) for v in self.hyperprior_centers)
            if len(c) != 7:
                raise ValueError(
                    "hyperprior_centers must have 7 entries: (y_ls, y_lam, "
                    "y_sn, x_ls, x_lam, x_sn, x_lin) in log space"
                )
            object.__setattr__(self, "hyperprior_centers", c)
        if self.hyperprior_weights is not None:
            w = tuple(float(v) for v in self.hyperprior_weights)
            if len(w) != 7 or any(v < 0.0 for v in w):
                raise ValueError(
                    "hyperprior_weights must have 7 non-negative entries: "
                    "(y_ls, y_lam, y_sn, x_ls, x_lam, x_sn, x_lin)"
                )
            object.__setattr__(self, "hyperprior_weights", w)

    @property
    def dyn_input_dim(self) -> int:
        """Dimension of the dynamics GP input: d * back_step."""
        return self.d * self.dyn_back_step

    @property
    def np_dtype(self):
        return np.dtype(self.dtype) if self.dtype != "bfloat16" else np.dtype("float32")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    def replace(self, **kw) -> "GPMDMConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "GPMDMConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer configuration (reference ``train_adam`` arguments).

    ``optimizer`` is 'adam' (the reference's) or 'lbfgs' (``optax.lbfgs``
    with its zoom line search, ``train.lbfgs``; ``lr`` is ignored and
    ``lbfgs_memory`` sets the memory of the two-loop recursion).  Each
    L-BFGS step runs a line search of several loss evaluations, so far
    fewer steps are needed than with Adam.  ``print_every`` sets the chunk
    of steps after which the host reads the losses (0: the whole run);
    ``checkpoint_every`` writes a train-state snapshot to
    ``checkpoint_path`` each time that many steps have passed."""

    num_steps: int = 500
    lr: float = 0.01
    balance: float = 1.0
    print_every: int = 0
    checkpoint_every: int = 0
    checkpoint_path: str | None = None
    optimizer: str = "adam"
    lbfgs_memory: int = 10


@dataclasses.dataclass(frozen=True)
class PFConfig:
    """Particle filter configuration (reference GPMDM_PF ctor).

    num_particles: P.  resampling: 'systematic' (default) or 'multinomial'.
    compat_double_logdet: reproduce the reference's doubled log-determinant.
    accumulate_weights: carry the previous weights into the new ones.
    obs_noise_in_weights: score observations against the noisy GP
    posterior (the correct likelihood; False for reference parity).
    resample_threshold: resample only when ESS < threshold * P (< 1 needs
    accumulate_weights).

    precision: 'default' | 'high' | 'highest'.  Every name runs the fused
    kernels in IEEE fp32 in this port: the GPU has no counterpart of the
    TPU's multi-pass bf16 matmuls, and TF32 (the card's reduced-precision
    fp32 matmul) repeats the one-pass-bf16 trap that drove the TPU filter
    to chance-level accuracy.

    pallas: 'auto' | 'on' | 'off'.  In this port 'auto' and 'on' both run
    the fused posterior kernels (``ops.gp_posterior``): the hand-written
    CUDA kernels for tensors on the card, their plain PyTorch versions for
    tensors on the CPU.  'off' runs the plain PyTorch versions on any
    device.

    bank_impl: 'auto' | 'vmap' | 'flat', validated and carried.  The port
    has one bank formulation whatever it says: flat, the GP stages over
    all banks' particles at once with the bank-aware observation kernel
    (one observation per bank).  It computes what the JAX package's vmap
    path computes.

    quad_precision chooses the sparse posterior's variance path, as in the
    JAX package (``filter.particle_filter._effective_quad_precision``):
    'trisolve', or None on a sparse model's own posterior, runs per-frame
    triangular solves; a precision name, or None on a distilled posterior
    (``GPMDM.sparsified_posterior``), runs products by the inverses
    hoisted out of the frame.  Every product is IEEE fp32 here, so the
    name picks the algorithm, not a precision.  The exact and compressed
    posteriors ignore it.

    recon_precision and fuse_mean_quad pick the TPU's matmul passes and
    product split for the JAX package's compressed products; they are
    validated and carried so that configurations round-trip.  The port
    ignores them: the exact and compressed posteriors take the mean and
    the quad from one pass (the exact one's kernels, the compressed one's
    single product).
    """

    num_particles: int = 100
    resampling: str = "systematic"
    compat_double_logdet: bool = False
    accumulate_weights: bool = False
    obs_noise_in_weights: bool = True
    precision: str = "high"
    pallas: str = "auto"
    resample_threshold: float = 1.0
    quad_precision: str | None = None
    recon_precision: str | None = None
    fuse_mean_quad: str = "auto"
    bank_impl: str = "auto"

    def __post_init__(self):
        if self.resampling not in ("systematic", "multinomial"):
            raise ValueError("resampling must be 'systematic' or 'multinomial'")
        if self.num_particles < 1:
            raise ValueError("num_particles must be >= 1")
        if self.precision not in ("default", "high", "highest"):
            raise ValueError("precision must be 'default', 'high' or 'highest'")
        if self.quad_precision not in (None, "default", "high", "highest",
                                       "trisolve"):
            raise ValueError(
                "quad_precision must be None, 'default', 'high', 'highest' "
                "or 'trisolve'"
            )
        if self.recon_precision not in (None, "default", "high", "highest"):
            raise ValueError(
                "recon_precision must be None, 'default', 'high' or 'highest'"
            )
        if self.pallas not in ("auto", "on", "off"):
            raise ValueError("pallas must be 'auto', 'on' or 'off'")
        if self.fuse_mean_quad not in ("auto", "on", "off"):
            raise ValueError("fuse_mean_quad must be 'auto', 'on' or 'off'")
        if self.bank_impl not in ("auto", "vmap", "flat"):
            raise ValueError("bank_impl must be 'auto', 'vmap' or 'flat'")
        if not (0.0 < self.resample_threshold <= 1.0):
            raise ValueError("resample_threshold must be in (0, 1]")
        if self.resample_threshold < 1.0 and not self.accumulate_weights:
            raise ValueError(
                "resample_threshold < 1 (ESS-triggered resampling) requires "
                "accumulate_weights=True — skipped-resample frames must carry "
                "their weights forward"
            )
