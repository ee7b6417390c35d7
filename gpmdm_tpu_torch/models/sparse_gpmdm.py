"""The sparse GPMDM: the GPMDM interface on inducing-point GPs.

Counterpart of ``gpmdm_tpu/models/sparse_gpmdm.py``: the exact model's
``add_data`` / ``init_X`` / ``train_adam`` / ``map_*`` / save and load
surface, trained in O(N M^2) a step (``models.sparse.sparse_nll``) instead
of O(N^3).  Every posterior refresh factors the parameters on the host in
float64 (``sparse.precompute_host``) and deploys them in the model dtype;
the filter runs on that SGPR posterior as it is.
"""

from __future__ import annotations

import torch

from ..ops.layout import xin_xout
from ..train.trainer import sparse_objective
from . import core, sparse
from .gpmdm import GPMDM


class SparseGPMDM(GPMDM):
    """GPMDM with sparse (inducing-point) observation and dynamics GPs.

    Extra constructor arguments: ``n_inducing_y`` (the observation GP's
    inducing inputs) and ``n_inducing_x`` (each class's dynamics GP's).
    The inducing inputs are parameters (``sparse.SparseParams``),
    initialised to an even-stride subset of the PCA latents and trained
    with everything else."""

    #: The sparse posterior deploys as it is: the deployment policy never
    #: swaps it for a compressed or sparsified one.
    _deploys_core_posterior = False
    _objective, _train_label = staticmethod(sparse_objective), "Sparse GPDM"
    # ``rollout`` steps through the sparse dynamics posterior
    _predict_x_for_class = staticmethod(sparse.predict_x_for_class)

    def __init__(self, *args, n_inducing_y: int = 64, n_inducing_x: int = 64, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_inducing_y = int(n_inducing_y)
        self.n_inducing_x = int(n_inducing_x)

    def init_X(self) -> None:
        """PCA-initialize the latents, take the inducing inputs from them
        (``sparse.init_inducing``), create the parameters on the model's
        device and build the posterior."""
        X0 = self._init_params()
        Zy, Zx = sparse.init_inducing(X0, self.layout, self.config, self.n_inducing_y,
                                      self.n_inducing_x)
        self.params = sparse.SparseParams(
            **{f: getattr(self.params, f) for f in core.PARAM_FIELDS},
            Zy=core.tensor_from_numpy(Zy, self.dtype, self.device),
            Zx=core.tensor_from_numpy(Zx, self.dtype, self.device))
        self._precompute_kernel_inverses()

    def _precompute_kernel_inverses(self, host_params=None, lazy: bool = False) -> None:
        """Refresh the sparse posterior: the parameters (``host_params`` in
        float64, else ``self.params``) factored on the host in float64
        (``sparse.precompute_host``, O(N M^2)) and deployed in the model
        dtype, at once: ``lazy`` is taken for the signature and ignored.
        The exact posterior is never built, nor a compressed one."""
        del lazy
        self._require_init()
        self._compressed_cache = {}
        self._deploy_recommendation = None
        self.posterior = sparse.precompute_host(
            host_params if host_params is not None else self.params,
            self.get_Y(), self.config, self.layout, self.device)

    def gpdm_loss(self, balance: float = 1.0) -> float:
        """Current total sparse MAP loss (``sparse.sparse_nll``)."""
        self._require_init()
        with torch.no_grad():
            return float(sparse.sparse_nll(self.params, self._Y(), self.config, self.layout,
                                           balance))

    def map_x_to_y(self, Xstar, flg_noise: bool = False):
        """Latent -> observation posterior: mean and variance (N*, D)."""
        self._require_posterior()
        return sparse.predict_y(self.posterior, self.params, self._as_points(Xstar),
                                self.config, with_noise=flg_noise)

    def map_x_dynamics(self, Xstar, flg_noise: bool = False):
        """All-class dynamics posterior, the class-additive sparse analogue
        of the exact model's (``sparse.predict_x``): mean and variance
        (N*, d)."""
        self._require_posterior()
        return sparse.predict_x(self.posterior, self.params, self._as_points(Xstar),
                                self.config, with_noise=flg_noise)

    def map_x_dynamics_for_class(self, Xstar, class_index: int, flg_noise: bool = False):
        """Single-class dynamics posterior: mean and variance (N*, d)."""
        self._require_posterior()
        return sparse.predict_x_for_class(self.posterior, self.params,
                                          self._as_points(Xstar), class_index, self.config,
                                          with_noise=flg_noise)

    # --------------------------------------------------------- diagnostics

    @staticmethod
    def _nmse_device(truth: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     floored: bool) -> float:
        """The mean squared z-score on the device in the model dtype, as
        the JAX package's sparse diagnostics compute it (the exact model's
        :meth:`GPMDM._nmse` computes on the host)."""
        z2 = (truth - mean) ** 2 / var
        if floored:
            z2 = torch.floor(z2)
        return float(torch.mean(z2))

    def get_latent_map_performance(self, flg_noise: bool = False, floored: bool = False):
        """(mean, var, Y, NMSE) of the latent map on all training data."""
        self._require_posterior()
        Y = self._Y()
        mean, var = self.map_x_to_y(self.params.X, flg_noise)
        return (mean.cpu().numpy(), var.cpu().numpy(), Y.cpu().numpy(),
                self._nmse_device(Y, mean, var, floored))

    def get_dynamics_map_performance_for_class(self, class_index: int,
                                               flg_noise: bool = False,
                                               floored: bool = False):
        """(mean, var, Xout, Xin, NMSE) of one class's dynamics map on that
        class's own training pairs: the rows of ``xin_xout(X)`` between
        its ``x_class_offsets`` (a sparse posterior keeps no ``Xin``)."""
        self._require_posterior()
        Xin, Xout = xin_xout(self.params.X, self.layout.to(self.device), self.config.dyn_target)
        lo = int(self.layout.x_class_offsets[class_index])
        hi = int(self.layout.x_class_offsets[class_index + 1])
        Xin_c, Xout_c = Xin[lo:hi], Xout[lo:hi]
        mean, var = self.map_x_dynamics_for_class(Xin_c, class_index, flg_noise)
        return (mean.cpu().numpy(), var.cpu().numpy(), Xout_c.cpu().numpy(),
                Xin_c.cpu().numpy(), self._nmse_device(Xout_c, mean, var, floored))
