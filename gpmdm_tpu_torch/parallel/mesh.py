"""Device meshes over the ranks of the default process group.

Counterpart of ``gpmdm_tpu/parallel/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over every rank, with the
JAX package's axis names:

- ``ep``: expert parallelism over the per-class dynamics GPs;
- ``tp``: tensor parallelism over the observation dimensions (or, with the
  distributed Cholesky, the observation rows);
- ``dp``: data parallelism over independent filter banks;
- ``sp``: the training rows of a row-sharded prediction.

An axis's process group is ``mesh.get_group(name)``; a rank's place on
it, ``mesh.get_local_rank(name)``, replaces ``jax.lax.axis_index``.
The default process group must be started first
(``parallel.launch.init_distributed``); the mesh's devices are CUDA under
NCCL and the CPU under gloo.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(axis_sizes: dict[str, int] | None = None) -> DeviceMesh:
    """A mesh from {axis_name: size} over every rank, in rank order.  With
    no spec, all ranks go on one ``dp`` axis."""
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"dp": n}
    sizes = tuple(int(v) for v in axis_sizes.values())
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {axis_sizes} needs {np.prod(sizes)} ranks, have {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, sizes, mesh_dim_names=tuple(axis_sizes))


def train_mesh_shape(n_devices: int, n_classes: int | None = None) -> dict[str, int]:
    """The ('ep', 'tp') shape of :func:`make_train_mesh` on ``n_devices``:
    with ``n_classes`` the expert axis takes ``gcd(n_classes, n)``, the
    largest class-count factor that divides the device count (8 classes on
    8 devices: a pure ep = 8 mesh; on one card (1, 1)), and the rest go to
    ``tp``; without it, ep = 2 when n is even, else 1."""
    n = int(n_devices)
    if n_classes is not None and n_classes >= 1:
        ep = math.gcd(n_classes, n)
    else:
        ep = 2 if n % 2 == 0 and n >= 2 else 1
    return {"ep": ep, "tp": n // ep}


def make_train_mesh(n_devices: int | None = None, n_classes: int | None = None) -> DeviceMesh:
    """The ('ep', 'tp') training mesh over every rank, shape-aware
    (:func:`train_mesh_shape`).  ``n_devices``, when given, must be the
    world size: torch builds a mesh over the ranks that run."""
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_train_mesh({n_devices}) on a world of {n} ranks")
    return make_mesh(train_mesh_shape(n, n_classes))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def replicated(mesh: DeviceMesh):
    """The process group of the whole mesh: what a value replicated over
    every axis is summed over (a mesh spans every rank)."""
    return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
