"""User-facing GPMDM model: the inference subset of ``gpmdm_tpu.GPMDM``.

Holds what the particle filter reads — ``config``, ``layout``, ``params``
and the exact ``posterior`` — on one device, plus the observation
sequences the posterior is built from.  Training stays with the JAX
package until it is ported; a trained model comes in through ``load``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import GPMDMConfig
from ..ops.layout import DataLayout, build_layout
from . import core


def params_from_numpy(arrays: dict, dtype: torch.dtype = torch.float32,
                      device="cuda") -> core.GPMDMParams:
    """``GPMDMParams`` from numpy arrays keyed by field name: a checkpoint's
    ``param_*`` entries, or the JAX package's parameters converted with
    ``np.asarray``."""
    return core.GPMDMParams(**{
        f: torch.as_tensor(np.ascontiguousarray(arrays[f]), device=device).to(dtype)
        for f in core.PARAM_FIELDS
    })


class GPMDM:
    """A trained exact GPMDM on ``device`` (``'cuda'`` unless the caller
    asks for ``'cpu'``)."""

    def __init__(self, config: GPMDMConfig, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.class_aware_observations_list: List[List[np.ndarray]] = [
            [] for _ in range(config.n_classes)
        ]
        self.layout: DataLayout | None = None
        self.params: core.GPMDMParams | None = None
        self.posterior: core.Posterior | None = None

    @classmethod
    def load(cls, file_path, device="cuda") -> "GPMDM":
        from ..utils.io import load_model

        return load_model(file_path, device=device)

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

    def set_params(self, host_params: dict) -> None:
        """Freeze the layout, take the parameters and build the posterior
        from float64 ``host_params`` (numpy arrays keyed by field name)."""
        lengths, classes = [], []
        for c, seqs in enumerate(self.class_aware_observations_list):
            lengths += [s.shape[0] for s in seqs]
            classes += [c] * len(seqs)
        if not lengths:
            raise ValueError("no data added; call add_data first")
        self.layout = build_layout(lengths, classes, self.config.n_classes,
                                   self.config.dyn_back_step)
        self.params = params_from_numpy(host_params, self.dtype, self.device)
        self.posterior = core.precompute_host(
            host_params, self.get_Y(), self.config, self.layout, self.device)

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
    def dtype(self) -> torch.dtype:
        return self.config.torch_dtype
