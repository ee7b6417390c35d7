"""Batched forward kinematics for ASF skeletons.

The reference computes FK one frame at a time with a recursive Python walk
over the joint tree (`reference/amc_parser/amc_parser.py:58-74`,
``Joint.set_motion``).  Here FK is *vectorized over frames*: one pass over
the joints in topological order, each doing a (T, 3, 3) batched matmul —
orders of magnitude faster for whole-trial processing, and the same math:

    M_root(t) = C_root R(root_rot(t)) C_root^-1
    M_j(t)    = M_parent(t) C_j R(rot_j(t)) C_j^-1
    p_j(t)    = p_parent(t) + length_j * M_j(t) direction_j

with C_j = euler(axis_j) and all euler matrices in static-xyz convention
``R = Rz @ Ry @ Rx`` (the reference's transforms3d ``euler2mat`` default).

A numpy-only copy of ``gpmdm_tpu/data/fk.py`` for the port, which imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .amc_asf import Motion, Skeleton, _ROT_DOFS


def euler_xyz_mat(angles_rad: np.ndarray) -> np.ndarray:
    """Batched static-xyz euler rotation matrices.

    angles_rad: (..., 3) with (ax, ay, az).  Returns (..., 3, 3) equal to
    ``Rz(az) @ Ry(ay) @ Rx(ax)``.
    """
    a = np.asarray(angles_rad, dtype=np.float64)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    R = np.empty(a.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = cz * cy
    R[..., 0, 1] = cz * sy * sx - sz * cx
    R[..., 0, 2] = cz * sy * cx + sz * sx
    R[..., 1, 0] = sz * cy
    R[..., 1, 1] = sz * sy * sx + cz * cx
    R[..., 1, 2] = sz * sy * cx - cz * sx
    R[..., 2, 0] = -sy
    R[..., 2, 1] = cy * sx
    R[..., 2, 2] = cy * cx
    return R


def _rotation_angles(skel: Skeleton, motion: Motion) -> np.ndarray:
    """Assemble per-joint per-frame (rx, ry, rz) angle arrays in degrees.

    Channels are mapped to x/y/z slots by dof name (see the parity note in
    :mod:`gpmdm_tpu.data.amc_asf`).  Joints with no motion data stay at zero.
    Shape (J, T, 3).
    """
    T = motion.n_frames
    out = np.zeros((skel.n_joints, T, 3))
    for j, name in enumerate(skel.names):
        ch = motion.channels.get(name)
        if ch is None:
            continue
        dofs = skel.dof[j]
        for k, d in enumerate(dofs):
            if d in _ROT_DOFS:
                out[j, :, _ROT_DOFS.index(d)] = ch[:, k]
    return out


def forward_kinematics(skel: Skeleton, motion: Motion) -> Dict[str, np.ndarray]:
    """Compute world-space joint positions for all frames at once.

    Returns ``{"positions": (T, J, 3), "matrices": (T, J, 3, 3)}`` in the
    skeleton's (topological) joint order.  Equivalent to running the
    reference's ``Joint.set_motion`` per frame and reading ``coordinate`` /
    ``matrix`` per joint.
    """
    T, J = motion.n_frames, skel.n_joints
    C = euler_xyz_mat(np.deg2rad(skel.axis_deg))  # (J, 3, 3)
    Cinv = np.swapaxes(C, -1, -2)  # rotation matrices: inverse == transpose
    angles = np.deg2rad(_rotation_angles(skel, motion))  # (J, T, 3)

    mats = np.zeros((T, J, 3, 3))
    pos = np.zeros((T, J, 3))

    # root: translation channels are tx, ty, tz (already meters)
    root_ch = motion.channels.get("root")
    if root_ch is not None:
        pos[:, 0, :] = root_ch[:, :3]
    R_root = euler_xyz_mat(angles[0])  # (T, 3, 3)
    mats[:, 0] = C[0] @ R_root @ Cinv[0]

    for j in range(1, J):
        p = int(skel.parent[j])
        local = C[j] @ euler_xyz_mat(angles[j]) @ Cinv[j]  # (T, 3, 3)
        mats[:, j] = mats[:, p] @ local
        pos[:, j] = pos[:, p] + skel.length[j] * np.einsum(
            "tab,b->ta", mats[:, j], skel.direction[j]
        )
    return {"positions": pos, "matrices": mats}
