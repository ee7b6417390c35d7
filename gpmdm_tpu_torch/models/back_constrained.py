"""Back-constrained GPMDM: a smooth observation -> latent inverse map.

Counterpart of ``gpmdm_tpu/models/back_constrained.py``.  The
back-constraint (Lawrence & Quinonero-Candela, 2006) parameterizes

    X = K_b W,     K_b = the row-normalized RBF kernel k(Y, Y; l_b),

and trains W (Ny, d) in place of X.  Observations close in Y stay close in
latent space, and a new observation projects straight into it:
``map_y_to_x(y*) = k(y*, Y) W``, a warm start for the filter.

K_b is constant while a model trains: ``bc_objective`` builds it once a
``train_adam`` call and ``bc_nll`` applies it with one (Ny, Ny) x (Ny, d)
product a step.  The rest of the loss is the exact model's
(``core.nll``); the Adam state is over ``GPMDMParams`` with W in the X
slot, and so is a checkpoint's ``param_X``.  The model deploys the exact posterior of X = K_b W, as a
``GPMDM`` does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np
import torch

from ..config import GPMDMConfig
from ..ops import kernels as K
from ..ops.layout import DataLayout
from ..train.trainer import trainable_mask
from . import core
from .gpmdm import GPMDM


def back_kernel(Y1: torch.Tensor, Y2: torch.Tensor, back_ls: float,
                dtype: torch.dtype) -> torch.Tensor:
    """The ROW-NORMALIZED RBF kernel over observation space (Nadaraya-Watson
    weights), (N1, N2) in ``dtype`` on Y1's device.  The normalization is
    load-bearing: the raw Gram's top eigenvalue grows with the number of
    neighbours (291 at Ny = 640, measured by the JAX package), which
    multiplies into every step on W and blew fp32 training up; the
    normalized map has spectral norm <= 1."""
    Y1 = torch.as_tensor(Y1).to(dtype)
    Y2 = torch.as_tensor(Y2, device=Y1.device).to(dtype)
    log_ls = torch.log(torch.tensor(back_ls, dtype=dtype, device=Y1.device))
    Kb = K.rbf_kernel(Y1, Y2, log_ls.expand(Y1.shape[1]))
    return Kb / torch.sum(Kb, dim=1, keepdim=True)


def bc_nll(params: core.GPMDMParams, Y: torch.Tensor, cfg: GPMDMConfig, layout: DataLayout,
           balance: float = 1.0, Kb: torch.Tensor | None = None) -> torch.Tensor:
    """The MAP loss of the back-constrained model: ``params.X`` holds W, the
    latents are K_b W, and the rest is ``core.nll``.  ``Kb`` is built here
    from Y when not given."""
    if Kb is None:
        Kb = back_kernel(Y, Y, cfg.back_constraint_ls, Y.dtype)
    return core.nll(dataclasses.replace(params, X=Kb @ params.X), Y, cfg, layout, balance)


def bc_objective(cfg: GPMDMConfig, mode: str, Y: torch.Tensor, layout: DataLayout):
    """The back-constrained family's (mask, loss_fn) for
    ``train.trainer.train_adam``: the exact model's mask, with W in the X
    slot, and ``bc_nll`` over a K_b built once on Y's device."""
    Kb = back_kernel(Y, Y, cfg.back_constraint_ls, Y.dtype)
    return trainable_mask(cfg, mode), functools.partial(bc_nll, Kb=Kb)


def median_lengthscale(Y: np.ndarray) -> float:
    """The median-pairwise-distance heuristic for the back kernel's
    lengthscale, on at most 512 rows drawn by ``default_rng(0)``."""
    Y = np.asarray(Y, dtype=np.float64)
    n = len(Y)
    idx = np.random.default_rng(0).permutation(n)[: min(n, 512)]
    S = Y[idx]
    d2 = np.sum((S[:, None, :] - S[None, :, :]) ** 2, axis=-1)
    med = np.median(d2[np.triu_indices(len(S), k=1)])
    return float(np.sqrt(max(med, 1e-12)))


class BCGPMDM(GPMDM):
    """GPMDM with back-constrained latents: the public surface of GPMDM,
    plus ``map_y_to_x``.  ``back_lengthscale`` (None: the median heuristic
    at ``init_X``) and ``back_ridge`` (the ridge of W's initial solve)."""

    _objective, _train_label = staticmethod(bc_objective), "BC-GPDM"

    def __init__(self, *args, back_lengthscale: float | None = None,
                 back_ridge: float = 1e-4, **kwargs):
        super().__init__(*args, **kwargs)
        self._back_ls_arg = back_lengthscale
        self._back_ridge = float(back_ridge)
        self._W: torch.Tensor | None = None

    def init_X(self) -> None:
        """The PCA latents projected through the back-constraint: W0 solves
        (K_b + ridge I) W = X_pca by least squares on the host in float64,
        so the initial latents match the exact model's PCA init as closely
        as the constraint allows."""
        self._init_params()
        Y = np.asarray(self.get_Y(), dtype=np.float64)
        ls = (float(self._back_ls_arg) if self._back_ls_arg is not None
              else median_lengthscale(Y))
        self.config = self.config.replace(back_constraint_ls=ls)
        Kb = back_kernel(torch.as_tensor(Y), torch.as_tensor(Y), ls, torch.float64).numpy()
        X0 = core.host_f64(self.params, "X")
        W0, *_ = np.linalg.lstsq(Kb + self._back_ridge * np.eye(len(Kb)), X0, rcond=None)
        self._W = core.tensor_from_numpy(W0, self.dtype, self.device)
        self._materialize()

    def _materialize(self) -> None:
        """params.X <- K_b W, then the posterior refresh: everything
        downstream (posterior, filter, losses) sees the effective latents."""
        Y = self._Y()
        Kb = back_kernel(Y, Y, self.config.back_constraint_ls, self.dtype)
        self.params = dataclasses.replace(self.params, X=Kb @ self._W)
        self._precompute_kernel_inverses()

    def train_adam(self, num_opt_steps: int, num_print_steps: int = 0, lr: float = 0.01,
                   balance: float = 1.0, logger=None, optimizer: str = "adam") -> List[float]:
        """Adam on W (in the X slot) and the hyperparameters; then X is
        rematerialized and the posterior refreshed.  See
        :meth:`GPMDM.train_adam`."""
        self._require_init()
        result = self._run_adam(self._params_for_save(), num_opt_steps, num_print_steps, lr,
                                balance, logger, optimizer)
        self._W = result.params.X
        self.params = dataclasses.replace(result.params, X=self.params.X)
        self._opt_state = result.opt_state
        self._materialize()
        return result.losses.cpu().tolist()

    def gpdm_loss(self, balance: float = 1.0) -> float:
        """The MAP loss at the current parameters, through the constraint."""
        self._require_init()
        with torch.no_grad():
            return float(bc_nll(self._params_for_save(), self._Y(), self.config,
                                self.layout.to(self.device), balance))

    def _params_for_save(self) -> core.GPMDMParams:
        """W in the X slot: a load rematerializes X = K_b W from the saved
        observations and the config's lengthscale (``utils.io``)."""
        return dataclasses.replace(self.params, X=self._W)

    def map_y_to_x(self, Ystar) -> torch.Tensor:
        """Observations (N*, D) projected into latent space through the
        learned back-constraint: k_b(y*, Y_train) W, (N*, d)."""
        self._require_init()
        Kb = back_kernel(self._as_points(Ystar), self._Y(), self.config.back_constraint_ls,
                         self.dtype)
        return Kb @ self._W
