"""User-facing GPMDM model: a stateful wrapper over the functional core.

Counterpart of ``gpmdm_tpu.GPMDM`` for the exact family, with the
reference's constructor and method names (``add_data``, ``init_X``,
``train_adam``, ``gpdm_loss``, ``map_x_to_y``, ``map_x_dynamics``,
``map_x_dynamics_for_class``, ``get_next_x``, ``rollout``, ``save`` /
``load`` / ``load_torch`` and the diagnostics).  Observations accumulate on
the host; ``init_X`` freezes the data layout and creates the parameters on
the model's device (``'cuda'`` unless the caller passes ``device='cpu'``);
training runs there, and every posterior refresh factors the trained
parameters on the host in float64 (``core.precompute_host``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import GPMDMConfig, TrainConfig
from ..ops import kernels as K
from ..ops.layout import DataLayout, build_layout, class_block_mask, xin_xout
from . import core


def params_from_numpy(arrays: dict, dtype: torch.dtype = torch.float32,
                      device="cuda") -> core.GPMDMParams:
    """``GPMDMParams`` from numpy arrays keyed by field name: a checkpoint's
    ``param_*`` entries, or the JAX package's parameters converted with
    ``np.asarray``.  ``train.trainer.AdamState.from_numpy`` and
    ``to_numpy`` carry the Adam state the same way."""
    return core.GPMDMParams(**{f: core.tensor_from_numpy(arrays[f], dtype, device)
                               for f in core.PARAM_FIELDS})


class GPMDM:
    """Gaussian Process Multi-Dynamical Model: one observation GP shared by
    all classes and one dynamics GP per class, trained jointly by MAP."""

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
        self.posterior: Optional[core.Posterior] = None
        self._opt_state = None
        self._training_mode = "all"

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
        self.layout = self._build_layout()
        X0 = core.pca_init_x(self.get_Y(), self.config.d)
        h = self._init_hypers
        self.params = core.init_params(
            self.config, h["y_lengthscales_init"], h["y_lambdas_init"], h["y_sigma_n_init"],
            h["x_lengthscales_init"], h["x_lambdas_init"], h["x_sigma_n_init"],
            h["x_lin_coeff_init"], X0=X0, device=self.device)
        self._opt_state = None
        self._precompute_kernel_inverses()

    def set_params(self, host_params: dict) -> None:
        """Freeze the layout, take the parameters and build the posterior
        from float64 ``host_params`` (numpy arrays keyed by field name)."""
        self.layout = self._build_layout()
        self.params = params_from_numpy(host_params, self.dtype, self.device)
        self._precompute_kernel_inverses(host_params)

    def _require_init(self):
        if self.params is None:
            raise RuntimeError("model not initialized; call init_X() first")

    def _precompute_kernel_inverses(self, host_params=None) -> None:
        """Refresh the exact posterior: the parameters (``host_params``, when
        the caller already holds them in float64, else ``self.params``
        copied to the host) factored in float64 on the host and deployed in
        the model dtype on the model's device."""
        self._require_init()
        self.posterior = core.precompute_host(
            host_params if host_params is not None else self.params,
            self.get_Y(), self.config, self.layout, self.device)

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
        from ..train.trainer import train_adam as _train

        self._require_init()

        def log(step, loss, t):
            print(f"GPDM Opt. step {step}: loss {loss:.4e}  ({t:.1f}s)")

        tc = TrainConfig(num_steps=num_opt_steps, lr=lr, balance=balance,
                         print_every=num_print_steps, optimizer=optimizer)
        result = _train(self.params, self._Y(), self.config, self.layout, tc,
                        mode=self._training_mode or "all", opt_state=self._opt_state,
                        log_fn=log if num_print_steps else None, logger=logger)
        self.params = result.params
        self._opt_state = result.opt_state
        self._precompute_kernel_inverses()
        return result.losses.cpu().tolist()

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
                generator: Optional[torch.Generator] = None):
        """Autoregressive latent rollout under one class's dynamics:
        (n_steps, d)."""
        self._require_init()
        x0 = torch.as_tensor(np.asarray(x0), device=self.device).to(self.dtype)
        return core.rollout(self.posterior, self.params, x0, n_steps, class_index,
                            self.config, sample=sample, generator=generator)

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
