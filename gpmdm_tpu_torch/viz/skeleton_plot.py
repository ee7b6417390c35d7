"""Matplotlib skeleton drawing primitives.

Counterpart of the reference's ``Joint.draw``
(`reference/amc_parser/amc_parser.py:76-108`): blue joint markers, red
bone segments, and the same (z, x, y) axis permutation so renders are
visually identical.  Native path draws straight from a precomputed
``(J, 3)`` position array (one frame of the batched FK) instead of walking a
Joint tree.

A numpy-only copy of ``gpmdm_tpu/viz/skeleton_plot.py`` for the port.
"""

from __future__ import annotations

import numpy as np

from ..data.amc_asf import CMU_MOCAP_LENGTH_TO_METERS, Skeleton

_SCALE = CMU_MOCAP_LENGTH_TO_METERS


def _default_ax():
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    return ax


def set_limits(ax) -> None:
    """Reference plot extents (amc_parser.py:87-89)."""
    ax.set_xlim3d(-50 * _SCALE, 10 * _SCALE)
    ax.set_ylim3d(-20 * _SCALE, 40 * _SCALE)
    ax.set_zlim3d(-20 * _SCALE, 40 * _SCALE)


def draw_positions(positions: np.ndarray, parent: np.ndarray, ax=None, show: bool = False):
    """Draw one skeleton frame from world positions.

    positions: (J, 3); parent: (J,) parent indices (-1 for root).
    Plots (z, x, y) like the reference so the figure orientation matches.
    """
    if ax is None:
        ax = _default_ax()
    set_limits(ax)
    xs, ys, zs = positions[:, 0], positions[:, 1], positions[:, 2]
    ax.plot(zs, xs, ys, "b.")
    for j, p in enumerate(parent):
        if p < 0:
            continue
        seg = positions[[j, int(p)]]
        ax.plot(seg[:, 2], seg[:, 0], seg[:, 1], "r")
    if show:
        import matplotlib.pyplot as plt

        plt.show()
    return ax


def draw_skeleton_frame(skel: Skeleton, positions: np.ndarray, ax=None, show: bool = False):
    """Draw one frame of a skeleton given its (J, 3) positions."""
    return draw_positions(np.asarray(positions), skel.parent, ax=ax, show=show)


def draw_joint_tree(root_joint, ax=None, show: bool = True):
    """Draw from a reference-style Joint tree after ``set_motion``
    (the facade behind ``Joint.draw``)."""
    joints = root_joint.to_dict()
    names = list(joints)
    positions = np.stack([joints[n].coordinate[:, 0] for n in names])
    parent = np.array(
        [names.index(joints[n].parent.name) if joints[n].parent is not None else -1 for n in names]
    )
    return draw_positions(positions, parent, ax=ax, show=show)
