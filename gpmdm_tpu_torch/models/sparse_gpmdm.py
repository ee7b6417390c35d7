"""The sparse GPMDM: the GPMDM interface on inducing-point GPs.

Counterpart of ``gpmdm_tpu/models/sparse_gpmdm.py``, serving half: a model
loaded from a checkpoint (``GPMDM.load`` or ``utils.io.load_model``)
deploys its own SGPR posterior (``models.sparse``), in the filter and
through the ``map_*`` predictions.  Its training (``init_X``,
``gpdm_loss``, ``train_adam``) and ``rollout`` are not ported yet: they
raise ``NotImplementedError``.
"""

from __future__ import annotations

from . import sparse
from .gpmdm import GPMDM

_UNPORTED = "is not ported yet (ROADMAP A.3b, the sparse family's training)"


class SparseGPMDM(GPMDM):
    """GPMDM with sparse (inducing-point) observation and dynamics GPs.

    Extra constructor arguments: ``n_inducing_y`` (the observation GP's
    inducing inputs) and ``n_inducing_x`` (each class's dynamics GP's).
    The inducing inputs are parameters (``sparse.SparseParams``)."""

    #: The sparse posterior deploys as it is: the deployment policy never
    #: swaps it for a compressed or sparsified one.
    _deploys_core_posterior = False

    def __init__(self, *args, n_inducing_y: int = 64, n_inducing_x: int = 64, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_inducing_y = int(n_inducing_y)
        self.n_inducing_x = int(n_inducing_x)

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

    def init_X(self) -> None:
        raise NotImplementedError(f"SparseGPMDM.init_X {_UNPORTED}")

    def gpdm_loss(self, balance: float = 1.0) -> float:
        raise NotImplementedError(f"SparseGPMDM.gpdm_loss {_UNPORTED}")

    def train_adam(self, *args, **kwargs):
        raise NotImplementedError(f"SparseGPMDM.train_adam {_UNPORTED}")

    def rollout(self, *args, **kwargs):
        raise NotImplementedError(f"SparseGPMDM.rollout {_UNPORTED}")

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
