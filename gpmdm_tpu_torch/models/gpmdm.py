"""User-facing GPMDM model: a stateful wrapper over the functional core.

Counterpart of ``gpmdm_tpu.GPMDM`` for the exact family, with the
reference's constructor and method names (``add_data``, ``init_X``,
``train_adam``, ``gpdm_loss``, ``map_x_to_y``, ``map_x_dynamics``,
``map_x_dynamics_for_class``, ``get_next_x``, ``rollout``, ``save`` /
``load`` / ``load_torch`` and the diagnostics).  Observations accumulate on
the host; ``init_X`` freezes the data layout and creates the parameters on
the model's device (``'cuda'`` unless the caller passes ``device='cpu'``);
training runs there, and every posterior refresh factors the trained
parameters on the host in float64 (``core.precompute_host``).  A loaded
checkpoint defers that factorization to the first use of ``posterior``,
so a deployment served from a persisted compressed or sparsified
posterior (``compressed_posterior``, ``sparsified_posterior``,
``filter.particle_filter.resolve_posterior``) never builds the exact one.
The sparse family, ``models.sparse_gpmdm.SparseGPMDM``, derives from it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import GPMDMConfig, TrainConfig
from ..ops import kernels as K
from ..ops.layout import DataLayout, build_layout, class_block_mask, xin_xout
from ..train.trainer import exact_objective, train_adam
from . import core, sparse


def params_from_numpy(arrays: dict, dtype: torch.dtype = torch.float32, device="cuda"):
    """``GPMDMParams`` from numpy arrays keyed by field name: a checkpoint's
    ``param_*`` entries, or the JAX package's parameters converted with
    ``np.asarray``; ``sparse.SparseParams`` when the arrays hold the
    inducing inputs ``Zy`` and ``Zx``.  ``train.trainer.AdamState.from_numpy``
    and ``to_numpy`` carry the Adam state the same way."""
    if "Zy" in arrays:
        return sparse.SparseParams.from_numpy(arrays, dtype, device)
    return core.GPMDMParams(**{f: core.tensor_from_numpy(arrays[f], dtype, device)
                               for f in core.PARAM_FIELDS})


class GPMDM:
    """Gaussian Process Multi-Dynamical Model: one observation GP shared by
    all classes and one dynamics GP per class, trained jointly by MAP."""

    #: The model's own posterior is the exact ``core.Posterior``, which the
    #: deployment policy may swap for a compressed or sparsified one
    #: (``filter.particle_filter.resolve_posterior``); a family that deploys
    #: its own posterior sets it False.
    _deploys_core_posterior = True

    def __init__(
        self,
        D: int,
        d: int,
        n_classes: int,
        dyn_target: str = "full",
        dyn_back_step: int = 1,
        y_lambdas_init=1.0,
        y_lengthscales_init=1.0,
        y_sigma_n_init: float = 1e-2,
        x_lambdas_init=1.0,
        x_lengthscales_init=1.0,
        x_sigma_n_init: float = 1e-2,
        x_lin_coeff_init=1.0,
        flg_train_y_lambdas: bool = True,
        flg_train_y_lengthscales: bool = True,
        flg_train_y_sigma_n: bool = True,
        flg_train_x_lambdas: bool = True,
        flg_train_x_lengthscales: bool = True,
        flg_train_x_sigma_n: bool = True,
        flg_train_x_lin_coeff: bool = True,
        sigma_n_num_Y: float = 0.0,
        sigma_n_num_X: float = 0.0,
        dtype: str = "float32",
        balance_fix: bool = True,
        hyperprior_weight: float = 0.0,
        hyperprior_weights=None,
        device="cuda",
    ):
        # log-space hyperprior centers = the init values (an array init
        # contributes its log-mean), kept whatever the weight
        def _logc(v):
            return float(np.mean(np.log(np.asarray(v, dtype=np.float64))))

        hyperprior_centers = tuple(_logc(v) for v in (
            y_lengthscales_init, y_lambdas_init, y_sigma_n_init, x_lengthscales_init,
            x_lambdas_init, x_sigma_n_init, x_lin_coeff_init))
        self.config = GPMDMConfig(
            D=D, d=d, n_classes=n_classes, dyn_target=dyn_target,
            dyn_back_step=dyn_back_step, sigma_n_num_Y=sigma_n_num_Y,
            sigma_n_num_X=sigma_n_num_X,
            flg_train_y_lambdas=flg_train_y_lambdas,
            flg_train_y_lengthscales=flg_train_y_lengthscales,
            flg_train_y_sigma_n=flg_train_y_sigma_n,
            flg_train_x_lambdas=flg_train_x_lambdas,
            flg_train_x_lengthscales=flg_train_x_lengthscales,
            flg_train_x_sigma_n=flg_train_x_sigma_n,
            flg_train_x_lin_coeff=flg_train_x_lin_coeff,
            dtype=dtype, balance_fix=balance_fix, hyperprior_weight=hyperprior_weight,
            hyperprior_weights=(None if hyperprior_weights is None
                                else tuple(float(v) for v in hyperprior_weights)),
            hyperprior_centers=hyperprior_centers,
        )
        self._init_hypers = dict(
            y_lambdas_init=np.asarray(y_lambdas_init, dtype=np.float64),
            y_lengthscales_init=np.asarray(y_lengthscales_init, dtype=np.float64),
            y_sigma_n_init=float(y_sigma_n_init),
            x_lambdas_init=np.asarray(x_lambdas_init, dtype=np.float64),
            x_lengthscales_init=np.asarray(x_lengthscales_init, dtype=np.float64),
            x_sigma_n_init=float(x_sigma_n_init),
            x_lin_coeff_init=np.asarray(x_lin_coeff_init, dtype=np.float64),
        )
        self.device = torch.device(device)
        self.class_aware_observations_list: List[List[np.ndarray]] = [
            [] for _ in range(n_classes)
        ]
        self.layout: Optional[DataLayout] = None
        self.params: Optional[core.GPMDMParams] = None
        self.posterior = None
        self._compressed_cache: dict = {}
        self._sparsified_cache: dict = {}
        self._opt_state = None
        self._training_mode = "all"
        # a guard-measured deployment verdict ({'family': ...}) and the guard
        # receipt, carried from and to the checkpoint's meta
        self._deploy_recommendation: Optional[dict] = None
        self._guard_receipt: Optional[dict] = None

    @property
    def posterior(self) -> Optional[core.Posterior]:
        """The exact posterior, built on first use when a checkpoint load
        deferred it.  A failed build leaves the load's parameters stashed,
        so the next use tries again."""
        if self._posterior is None and self._posterior_pending:
            self._posterior = core.precompute_host(
                self._lazy_host_params if self._lazy_host_params is not None
                else self.params, self.get_Y(), self.config, self.layout, self.device)
            self._posterior_pending = False
            self._lazy_host_params = None
        return self._posterior

    @posterior.setter
    def posterior(self, value) -> None:
        self._posterior = value
        self._posterior_pending = False
        self._lazy_host_params = None

    @classmethod
    def from_config(cls, config: GPMDMConfig, device="cuda",
                    init_hypers: Optional[dict] = None) -> "GPMDM":
        """A model of ``config`` exactly (fields the constructor does not
        take, such as ``class_jitter``, included), with the constructor's
        keyword ``init_hypers`` (``y_lambdas_init`` ...; its defaults
        where absent)."""
        model = cls(D=config.D, d=config.d, n_classes=config.n_classes,
                    dyn_target=config.dyn_target, dyn_back_step=config.dyn_back_step,
                    dtype=config.dtype, device=device, **(init_hypers or {}))
        model.config = config
        return model

    @classmethod
    def load(cls, file_path, device="cuda") -> "GPMDM":
        """Load a checkpoint written by :meth:`save` or by the JAX package."""
        from ..utils.io import load_model

        return load_model(file_path, device=device)

    @classmethod
    def load_torch(cls, file_path, device="cuda") -> "GPMDM":
        """Import a reference PyTorch ``.pth`` checkpoint."""
        from ..utils.io import load_torch_model

        return load_torch_model(file_path, device=device)

    def save(self, file_path) -> None:
        """Self-contained ``.npz`` checkpoint (format 1 of the JAX package):
        config, parameters, observation sequences and the Adam state."""
        from ..utils.io import save_model

        save_model(self, file_path)

    # ----------------------------------------------------------------- data

    def add_data(self, Y: np.ndarray, class_index: int) -> None:
        """Register one (T, D) observation sequence for a class."""
        Y = np.asarray(Y)
        if Y.ndim != 2 or Y.shape[1] != self.config.D:
            raise ValueError("Y must be a N x D matrix collecting observation data!")
        if not (0 <= class_index < self.config.n_classes):
            raise ValueError(f"class_index out of range [0, {self.config.n_classes})")
        self.class_aware_observations_list[class_index].append(
            Y.astype(self.config.np_dtype)
        )

    @property
    def observations_list(self) -> List[np.ndarray]:
        """All sequences flattened class-major."""
        return [s for cls in self.class_aware_observations_list for s in cls]

    def get_Y(self) -> np.ndarray:
        return np.concatenate(self.observations_list, axis=0)

    def get_Y_for_class(self, class_index: int) -> np.ndarray:
        return np.concatenate(self.class_aware_observations_list[class_index], axis=0)

    # ----------------------------------------------------------- properties

    @property
    def D(self) -> int:
        return self.config.D

    @property
    def d(self) -> int:
        return self.config.d

    @property
    def n_classes(self) -> int:
        return self.config.n_classes

    @property
    def dyn_target(self) -> str:
        return self.config.dyn_target

    @property
    def dyn_back_step(self) -> int:
        return self.config.dyn_back_step

    @property
    def dtype(self) -> torch.dtype:
        return self.config.torch_dtype

    @property
    def X(self) -> torch.Tensor:
        self._require_init()
        return self.params.X

    # ----------------------------------------------------------------- init

    def _build_layout(self) -> DataLayout:
        lengths, classes = [], []
        for c, seqs in enumerate(self.class_aware_observations_list):
            lengths += [s.shape[0] for s in seqs]
            classes += [c] * len(seqs)
        if not lengths:
            raise ValueError("no data added; call add_data first")
        return build_layout(lengths, classes, self.config.n_classes, self.config.dyn_back_step)

    def init_X(self) -> None:
        """PCA-initialize the latent matrix, create the parameters on the
        model's device and build the posterior."""
        self._init_params()
        self._precompute_kernel_inverses()

    def _init_params(self) -> np.ndarray:
        """Freeze the layout, set ``GPMDMParams`` at the initial
        hyperparameters around the PCA latents on the model's device, and
        drop any Adam state.  Returns the PCA latents, (Ny, d) float64."""
        self.layout = self._build_layout()
        X0 = core.pca_init_x(self.get_Y(), self.config.d)
        h = self._init_hypers
        self.params = core.init_params(
            self.config, h["y_lengthscales_init"], h["y_lambdas_init"], h["y_sigma_n_init"],
            h["x_lengthscales_init"], h["x_lambdas_init"], h["x_sigma_n_init"],
            h["x_lin_coeff_init"], X0=X0, device=self.device)
        self._opt_state = None
        return X0

    def set_params(self, host_params: dict, lazy: bool = False) -> None:
        """Freeze the layout, take the parameters and build the posterior
        from float64 ``host_params`` (numpy arrays keyed by field name);
        ``lazy`` defers the build to the posterior's first use."""
        self.layout = self._build_layout()
        self.params = params_from_numpy(host_params, self.dtype, self.device)
        self._precompute_kernel_inverses(host_params, lazy=lazy)

    def _require_init(self):
        if self.params is None:
            raise RuntimeError("model not initialized; call init_X() first")

    def _require_posterior(self) -> None:
        self._require_init()
        if self.posterior is None:
            self._precompute_kernel_inverses()

    def _precompute_kernel_inverses(self, host_params=None, lazy: bool = False) -> None:
        """Refresh the exact posterior: the parameters (``host_params``, when
        the caller already holds them in float64, else ``self.params``
        copied to the host) factored in float64 on the host and deployed in
        the model dtype on the model's device; with ``lazy``, at the
        posterior's first use.  A refresh empties the compressed and
        sparsified caches and drops the deployment verdict, all made from
        the old parameters."""
        self._require_init()
        self._compressed_cache = {}
        self._sparsified_cache = {}
        self._deploy_recommendation = None
        if lazy:
            self._posterior = None
            self._posterior_pending = True
            self._lazy_host_params = host_params
            return
        self.posterior = core.precompute_host(
            host_params if host_params is not None else self.params,
            self.get_Y(), self.config, self.layout, self.device)

    def compressed_posterior(self, rank_y: int | None = None, rank_x: int | None = None,
                             tol: float = 1e-6):
        """The low-rank-quad deployment posterior (``models.compressed``):
        exact mean, variance quad in O(N q P) a frame.  Pass it as
        ``GPMDM_PF(..., posterior=...)``.  Cached per ``(rank_y, rank_x,
        tol)`` until the next posterior refresh, and persisted by
        :meth:`save`, so a loaded checkpoint deploys it with no O(N^3)
        work.  While a load has deferred the exact build, the load's
        float64 parameters are used."""
        from .compressed import compress_host

        self._require_init()
        # built-in types: numpy integers are valid ranks, but the key is
        # written to the checkpoint's JSON
        key = (None if rank_y is None else int(rank_y),
               None if rank_x is None else int(rank_x), float(tol))
        if key not in self._compressed_cache:
            hp = self._lazy_host_params if self._posterior_pending else None
            self._compressed_cache[key] = compress_host(
                hp if hp is not None else self.params, self.get_Y(), self.config,
                self.layout, rank_y=rank_y, rank_x=rank_x, tol=tol, device=self.device)
        return self._compressed_cache[key]

    def sparsified_posterior(self, n_inducing_y: int = 128,
                             n_inducing_x: int | None = None, method: str = "stride"):
        """A post-hoc SGPR distillation of this trained exact model
        (``models.sparse.distill_host``): the filter's star kernel drops from
        (Ny, P) to (M, P) a frame and the variance to O(M^2 P), while mean
        and variance both become M-rank approximations (an accuracy guard
        arbitrates).  Pass it as ``GPMDM_PF(..., posterior=...)``.  Cached
        per ``(n_inducing_y, n_inducing_x)``, with ``method`` appended to
        the key when it is not ``'stride'``, until the next posterior
        refresh, and persisted by :meth:`save`.  While a load has deferred
        the exact build, the load's float64 parameters are used."""
        self._require_init()
        if not self._deploys_core_posterior:
            raise TypeError(
                f"{type(self).__name__} deploys its own posterior family; "
                "post-hoc distillation applies to exact-trained models "
                "(re-train with SparseGPMDM to choose M at training time)")
        key = (int(n_inducing_y), None if n_inducing_x is None else int(n_inducing_x))
        if method != "stride":
            key = key + (str(method),)
        if key not in self._sparsified_cache:
            hp = self._lazy_host_params if self._posterior_pending else None
            self._sparsified_cache[key] = sparse.distill_host(
                hp if hp is not None else self.params, self.get_Y(), self.config,
                self.layout, n_inducing_y=n_inducing_y, n_inducing_x=n_inducing_x,
                method=method, device=self.device)
        return self._sparsified_cache[key]

    # ------------------------------------------------------------- training

    def set_evaluation_mode(self) -> None:
        self._training_mode = None

    def set_training_mode(self, model: str = "all") -> None:
        if model not in ("all", "latent", "dynamics"):
            raise ValueError("model must be 'all', 'latent' or 'dynamics'")
        self._training_mode = model

    def _Y(self) -> torch.Tensor:
        return torch.as_tensor(self.get_Y(), device=self.device).to(self.dtype)

    def gpdm_loss(self, balance: float = 1.0) -> float:
        """Current total MAP loss (reference gpdm_loss)."""
        self._require_init()
        with torch.no_grad():
            return float(core.nll(self.params, self._Y(), self.config,
                                  self.layout.to(self.device), balance))

    def train_adam(self, num_opt_steps: int, num_print_steps: int = 0, lr: float = 0.01,
                   balance: float = 1.0, logger=None, optimizer: str = "adam") -> List[float]:
        """Optimize with Adam on the model's device (reference train_adam)
        and refresh the posterior.  Returns the per-step loss history.  The
        Adam state is kept on the instance, so a second call resumes.
        ``logger`` (``utils.logging.MetricLogger``) receives loss and steps/s
        per chunk of ``num_print_steps``.  ``optimizer='lbfgs'`` is not
        ported and raises."""
        self._require_init()
        result = self._run_adam(self.params, num_opt_steps, num_print_steps, lr, balance,
                                logger, optimizer)
        self.params = result.params
        self._opt_state = result.opt_state
        self._precompute_kernel_inverses()
        return result.losses.cpu().tolist()

    #: The family's objective (``train.trainer.train_adam``'s) and the
    #: label of its progress lines.
    _objective, _train_label = staticmethod(exact_objective), "GPDM"

    def _run_adam(self, params, num_opt_steps, num_print_steps, lr, balance, logger,
                  optimizer):
        """``train.trainer.train_adam`` on ``params`` from the instance's
        Adam state, in the training mode, for this family."""

        def log(step, loss, t):
            print(f"{self._train_label} Opt. step {step}: loss {loss:.4e}  ({t:.1f}s)")

        tc = TrainConfig(num_steps=num_opt_steps, lr=lr, balance=balance,
                         print_every=num_print_steps, optimizer=optimizer)
        return train_adam(params, self._Y(), self.config, self.layout, tc,
                          mode=self._training_mode or "all", opt_state=self._opt_state,
                          log_fn=log if num_print_steps else None, objective=self._objective,
                          logger=logger)

    def _params_for_save(self):
        """The parameters a checkpoint stores (``utils.io.save_model``)."""
        return self.params

    # ----------------------------------------------------------- prediction

    def _as_points(self, Xstar) -> torch.Tensor:
        Xstar = torch.as_tensor(np.asarray(Xstar) if not torch.is_tensor(Xstar) else Xstar,
                                device=self.device).to(self.dtype)
        return Xstar[None, :] if Xstar.ndim == 1 else Xstar

    def map_x_to_y(self, Xstar, flg_noise: bool = False):
        """Latent -> observation posterior: mean and variance (N*, D)."""
        self._require_init()
        return core.predict_y(self.posterior, self.params, self._as_points(Xstar),
                              self.config, with_noise=flg_noise)

    def map_x_dynamics(self, Xstar, flg_noise: bool = False):
        """All-class dynamics posterior: mean and variance (N*, d)."""
        self._require_init()
        return core.predict_x(self.posterior, self.params, self._as_points(Xstar),
                              self.config, with_noise=flg_noise)

    def map_x_dynamics_for_class(self, Xstar, class_index: int, flg_noise: bool = False):
        """Single-class dynamics posterior: mean and variance (N*, d)."""
        self._require_init()
        return core.predict_x_for_class(self.posterior, self.params, self._as_points(Xstar),
                                        class_index, self.config, with_noise=flg_noise)

    def get_next_x(self, gp_mean_out, gp_out_var, Xold, flg_sample: bool = False,
                   generator: Optional[torch.Generator] = None):
        """Dynamics output -> next latent state (reference get_next_x)."""
        t = lambda a: torch.as_tensor(a, device=self.device).to(self.dtype)  # noqa: E731
        return core.next_x(t(gp_mean_out), t(gp_out_var), t(Xold), self.config,
                           sample=flg_sample, generator=generator)

    def rollout(self, x0, n_steps: int, class_index: int, sample: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """Autoregressive latent rollout under one class's dynamics:
        (n_steps, d).  ``noise`` (n_steps, d) holds the standard normal draws
        of each step when ``sample``; else ``generator`` draws them."""
        self._require_posterior()
        x0 = torch.as_tensor(np.asarray(x0), device=self.device).to(self.dtype)
        return core.rollout(self.posterior, self.params, x0, n_steps, class_index,
                            self.config, sample=sample, generator=generator, noise=noise,
                            predict=self._predict_x_for_class)

    #: The single-class dynamics prediction of the model's own posterior.
    _predict_x_for_class = staticmethod(core.predict_x_for_class)

    # ------------------------------------------------- reference API parity

    def get_M(self) -> np.ndarray:
        """Dense class-block mask M over dynamics pairs (the compute path
        never materializes it)."""
        self._require_init()
        return class_block_mask(self.layout, dtype=self.config.np_dtype)

    def get_M_for_class(self, class_index: int) -> np.ndarray:
        """Single-class block mask."""
        self._require_init()
        sel = self.layout.pair_class == class_index
        return (sel[:, None] & sel[None, :]).astype(self.config.np_dtype)

    def get_Xin_Xout_matrices(self):
        """Dynamics regression matrices (Xin, Xout) and the start row of
        each sequence in the latent matrix X."""
        self._require_init()
        Xin, Xout = xin_xout(self.params.X, self.layout.to(self.device),
                             self.config.dyn_target)
        return Xin, Xout, [int(s) for s in self.layout.seq_starts]

    def get_y_kernel(self, X1, X2, flg_noise: bool = True):
        """Observation kernel matrix."""
        p = self.params
        return K.y_kernel(self._as_points(X1), self._as_points(X2), p.y_log_lengthscales,
                          p.y_log_sigma_n, self.config.sigma_n_num_Y, with_noise=flg_noise)

    def get_x_kernel(self, X1, X2, flg_noise: bool = True):
        """Dynamics kernel matrix."""
        p = self.params
        return K.x_kernel(self._as_points(X1), self._as_points(X2), p.x_log_lengthscales,
                          p.x_log_sigma_n, p.x_log_lin_coeff, self.config.sigma_n_num_X,
                          with_noise=flg_noise)

    def get_y_neg_log_likelihood(self) -> float:
        """Observation-map NLL L_y."""
        self._require_init()
        with torch.no_grad():
            return float(core.y_neg_log_likelihood(self.params, self._Y(), self.config))

    def get_x_neg_log_likelihood(self) -> float:
        """Dynamics-map NLL L_x."""
        self._require_init()
        with torch.no_grad():
            return float(core.x_neg_log_likelihood(self.params, self.config,
                                                   self.layout.to(self.device)))

    # ---------------------------------------------------------- inspection

    def get_latent_sequences(self) -> List[np.ndarray]:
        """Per-sequence latent trajectories."""
        self._require_init()
        X = self.params.X.detach().cpu().numpy()
        starts = np.cumsum([0] + [s.shape[0] for s in self.observations_list])
        return [X[a:b] for a, b in zip(starts[:-1], starts[1:])]

    def get_X_for_class(self, class_index: int) -> torch.Tensor:
        """Latent rows of one class."""
        self._require_init()
        lo = int(self.layout.y_class_offsets[class_index])
        hi = int(self.layout.y_class_offsets[class_index + 1])
        return self.params.X[lo:hi]

    # --------------------------------------------------------- diagnostics

    @staticmethod
    def _nmse(truth, mean, var, floored: bool) -> float:
        host = lambda a: a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)  # noqa: E731
        z2 = (host(truth) - host(mean)) ** 2 / host(var)
        if floored:
            z2 = np.floor(z2)
        return float(np.mean(z2))

    def get_latent_map_performance(self, flg_noise: bool = False, floored: bool = False):
        """(mean, var, Y, NMSE) of the latent map on all training data;
        ``floored=True`` reproduces the reference's floor division."""
        self._require_init()
        Y = self.get_Y()
        mean, var = self.map_x_to_y(self.params.X, flg_noise)
        return (mean.cpu().numpy(), var.cpu().numpy(), Y,
                self._nmse(Y, mean, var, floored))

    def get_latent_map_performance_for_class(self, class_index: int, flg_noise: bool = False,
                                             floored: bool = False):
        """Per-class latent map (mean, var, Y, NMSE)."""
        self._require_init()
        Yc = self.get_Y_for_class(class_index)
        mean, var = self.map_x_to_y(self.get_X_for_class(class_index), flg_noise)
        return (mean.cpu().numpy(), var.cpu().numpy(), Yc,
                self._nmse(Yc, mean, var, floored))

    def get_dynamics_map_performance_for_class(self, class_index: int,
                                               flg_noise: bool = False,
                                               floored: bool = False):
        """Per-class dynamics map (mean, var, Xout, Xin, NMSE) over all
        training pairs."""
        self._require_init()
        post = self.posterior
        mean, var = self.map_x_dynamics_for_class(post.Xin, class_index, flg_noise)
        return (mean.cpu().numpy(), var.cpu().numpy(), post.Xout.cpu().numpy(),
                post.Xin.cpu().numpy(), self._nmse(post.Xout, mean, var, floored))
