"""gpmdm_tpu_torch: GPMDM training and the switching particle filter in
PyTorch, with the filter's fused GP-posterior kernels written in CUDA for
the H100 (sm_90a).

A port of ``gpmdm_tpu`` (JAX/Pallas on TPU), which stays the reference.
Entry points run on ``'cuda'`` unless the caller passes ``device='cpu'``;
on the CPU the fused kernels are replaced by their plain PyTorch versions.
The package imports neither JAX nor ``gpmdm_tpu``.
"""

from .config import GPMDMConfig, PFConfig, TrainConfig
from .filter.particle_filter import GPMDM_PF
from .models.gpmdm import GPMDM

__all__ = ["GPMDM", "GPMDMConfig", "GPMDM_PF", "PFConfig", "TrainConfig"]
