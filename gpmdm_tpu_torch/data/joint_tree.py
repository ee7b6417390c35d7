"""Reference-compatible ``Joint`` tree facade over :class:`Skeleton`.

The reference's public parser API exposes a recursive ``Joint`` tree with
per-frame ``set_motion`` FK and matplotlib ``draw``
(`reference/amc_parser/amc_parser.py:12-123`).  The native
representation here is the vectorized :class:`~gpmdm_tpu_torch.data.amc_asf.Skeleton`
+ :func:`~gpmdm_tpu.data.fk.forward_kinematics`; this facade provides the
same per-frame object API for notebook-style exploration and the viewers.

A numpy-only copy of ``gpmdm_tpu/data/joint_tree.py`` for the port, which imports
nothing of the JAX package; ``draw`` imports the port's viz when called.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .amc_asf import Skeleton
from .fk import euler_xyz_mat, forward_kinematics, _rotation_angles
from .amc_asf import Motion


class Joint:
    """One joint of the skeleton tree (reference Joint, amc_parser.py:12).

    ``set_motion(frame_dict)`` runs single-frame recursive FK filling
    ``coordinate`` (3, 1) and ``matrix`` (3, 3), like the reference
    (amc_parser.py:58-74).
    """

    def __init__(self, name, direction, length, axis_deg, dof, limits_deg):
        self.name = name
        self.direction = np.reshape(np.asarray(direction, dtype=np.float64), (3, 1))
        self.length = float(length)
        self.dof = list(dof)
        self.limits = np.asarray(limits_deg, dtype=np.float64)
        self.C = euler_xyz_mat(np.deg2rad(np.asarray(axis_deg, dtype=np.float64)))
        self.Cinv = self.C.T
        self.parent: "Joint | None" = None
        self.children: List["Joint"] = []
        self.coordinate: np.ndarray | None = None
        self.matrix: np.ndarray | None = None

    def set_motion(self, motion: Dict[str, List[float]]) -> None:
        """Single-frame recursive FK (reference amc_parser.py:58-74).
        ``motion`` maps joint name -> channel values (root: 3 translations in
        meters + 3 rotations in degrees; others: rotation dofs in degrees)."""
        if self.name == "root":
            vals = motion.get("root", [0.0] * 6)
            self.coordinate = np.reshape(np.asarray(vals[:3], dtype=np.float64), (3, 1))
            rot = np.deg2rad(np.asarray(vals[3:6], dtype=np.float64))
            self.matrix = self.C @ euler_xyz_mat(rot) @ self.Cinv
        else:
            rot = np.zeros(3)
            vals = motion.get(self.name, [])
            k = 0
            for d in self.dof:
                if d in ("rx", "ry", "rz") and k < len(vals):
                    rot[("rx", "ry", "rz").index(d)] = vals[k]
                k += 1
            rot = np.deg2rad(rot)
            local = self.C @ euler_xyz_mat(rot) @ self.Cinv
            self.matrix = self.parent.matrix @ local
            self.coordinate = self.parent.coordinate + self.length * (
                self.matrix @ self.direction
            )
        for child in self.children:
            child.set_motion(motion)

    def to_dict(self) -> Dict[str, "Joint"]:
        out = {self.name: self}
        for child in self.children:
            out.update(child.to_dict())
        return out

    def draw(self, ax=None, show: bool = True):
        """Scatter + bone segments on a 3D matplotlib axis (reference
        amc_parser.py:76-108; same plot axis permutation z, x, y)."""
        from ..viz.skeleton_plot import draw_joint_tree

        return draw_joint_tree(self, ax=ax, show=show)

    def pretty_print(self) -> None:
        print(f"joint: {self.name} dof={self.dof} length={self.length:.4f}")


def build_joint_tree(skel: Skeleton) -> Dict[str, Joint]:
    """Build a {name: Joint} tree from a Skeleton (root included)."""
    joints = {
        name: Joint(
            name,
            skel.direction[j],
            skel.length[j],
            skel.axis_deg[j],
            skel.dof[j],
            skel.limits_deg[j],
        )
        for j, name in enumerate(skel.names)
    }
    for j, name in enumerate(skel.names):
        p = int(skel.parent[j])
        if p >= 0:
            joints[name].parent = joints[skel.names[p]]
            joints[skel.names[p]].children.append(joints[name])
    return joints
