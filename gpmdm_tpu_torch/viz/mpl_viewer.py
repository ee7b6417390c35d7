"""Headless matplotlib skeleton animation (FuncAnimation).

Counterpart of the reference ``MPLViewer``
(`reference/amc_parser/mpl_viewer.py:4`): same API surface
(``set_joints`` / ``set_motion`` / ``draw`` / ``update_frame`` /
``animate(downsample)``), used to render demo GIFs.  Native difference: all
frames' joint positions are computed once with the batched FK
(:func:`gpmdm_tpu_torch.data.fk.forward_kinematics`) before animating, so each
animation frame is a redraw, not an FK recompute.

A copy of ``gpmdm_tpu/viz/mpl_viewer.py`` for the port, on its numpy FK.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.amc_asf import Motion, Skeleton
from ..data.fk import forward_kinematics
from .skeleton_plot import draw_positions


class MPLViewer:
    """Animate a motion sequence in a 3D matplotlib figure."""

    def __init__(self, skeleton: Optional[Skeleton] = None, motion: Optional[Motion] = None):
        import matplotlib.pyplot as plt

        self.skeleton = skeleton
        self.motion = motion
        self.frame = 0
        self.fps = 120
        self._downsample = 1
        self._positions: np.ndarray | None = None
        self.fig, self.ax = plt.subplots(subplot_kw={"projection": "3d"})

    def set_joints(self, skeleton: Skeleton) -> None:
        self.skeleton = skeleton
        self._positions = None

    def set_motion(self, motion: Motion) -> None:
        self.motion = motion
        self._positions = None

    def _ensure_positions(self) -> np.ndarray:
        if self._positions is None:
            self._positions = forward_kinematics(self.skeleton, self.motion)["positions"]
        return self._positions

    def draw(self) -> None:
        """Draw the current frame (reference mpl_viewer.py:52-58)."""
        self.ax.clear()
        pos = self._ensure_positions()
        draw_positions(pos[self.frame], self.skeleton.parent, ax=self.ax, show=False)

    def update_frame(self, index: int) -> None:
        self.frame = index * self._downsample
        self.draw()

    def animate(self, downsample: int = 1):
        """Build the FuncAnimation (reference mpl_viewer.py:71-87).  Save with
        ``anim.save(path, writer='pillow')`` for a GIF."""
        from matplotlib.animation import FuncAnimation

        self._downsample = downsample
        num_frames = self.motion.n_frames // downsample
        interval = 1000 / (self.fps / downsample)
        self.anim = FuncAnimation(
            self.fig, self.update_frame, frames=num_frames, interval=interval
        )
        return self.anim
