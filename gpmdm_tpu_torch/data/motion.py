"""MotionCapture: one (asf, amc) trial as tabular joint-angle time series.

API-parity layer for the reference ``MotionCapture``
(`reference/amc_parser/motion.py:7`): same constructor shape
(asf_path, amc_path, fps, subject, trial), same ``as_dataframe`` column
scheme (``frame``, ``time``, then ``{joint}_{dof}`` per declared dof), same
``get_columns_for_joint(s)`` helpers, plus ``view()``.

Differences (intentional):
- ``as_dataframe`` is vectorized — one column assignment per joint instead
  of the reference's per-frame per-joint ``df.at`` loop
  (motion.py:35-43, the slowest part of its data path).
- ``as_numpy`` drops the time/frame *columns* — the reference calls
  ``.drop(['time','frame'])`` without axis and would raise (motion.py:51,
  a latent bug; its notebooks never call it).
- joints absent from the AMC produce zero-filled columns instead of None.

A numpy-only copy of ``gpmdm_tpu/data/motion.py`` for the port, which imports
nothing of the JAX package.
``select_joints`` reads the channel arrays without pandas; ``view()``
imports the port's viewer when called.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .amc_asf import Motion, Skeleton, parse_amc, parse_asf


class MotionCapture:
    """One mocap trial: parsed skeleton + motion + tabular exports."""

    def __init__(
        self,
        asf_path,
        amc_path,
        fps: int = 120,
        subject: Optional[int] = None,
        trial: Optional[int] = None,
    ):
        self.skeleton: Skeleton = parse_asf(asf_path)
        self.motion: Motion = parse_amc(amc_path, self.skeleton)
        self._fps = fps
        self.subject = subject
        self.trial = trial

    # ----------------------------------------------------------- tabular api

    def as_dataframe(self):
        """Motion as a pandas DataFrame: frame, time, then one column per
        declared joint dof (reference motion.py:18-45)."""
        import pandas as pd

        T = self.motion.n_frames
        data = {"frame": np.arange(T), "time": np.arange(T) / self._fps}
        for j, name in enumerate(self.skeleton.names):
            dofs = self.skeleton.dof[j]
            if not dofs:
                continue
            ch = self.motion.channels.get(name)
            for k, dof in enumerate(dofs):
                col = f"{name}_{dof}"
                data[col] = ch[:, k] if ch is not None else np.zeros(T)
        return pd.DataFrame(data)

    def as_numpy(self) -> np.ndarray:
        """All dof columns as a (T, n_dofs) float32 array (reference
        motion.py:47-51, with its missing-axis drop bug fixed)."""
        df = self.as_dataframe()
        return df.drop(columns=["time", "frame"]).to_numpy().astype(np.float32)

    def get_columns_for_joint(self, joint_name: str) -> List[str]:
        """Column names for one joint (reference motion.py:53-58)."""
        j = self.skeleton.index(joint_name)
        return [f"{joint_name}_{dof}" for dof in self.skeleton.dof[j]]

    def get_columns_for_joints(self, joint_names) -> List[str]:
        """Column names for several joints, concatenated in order
        (reference motion.py:60-67)."""
        cols: List[str] = []
        for name in joint_names:
            cols.extend(self.get_columns_for_joint(name))
        return cols

    def select_joints(self, joint_names) -> np.ndarray:
        """(T, sum dofs) float32 array of the given joints' channels —
        the one-call version of the notebooks'
        ``df[mc.get_columns_for_joints(...)].to_numpy()`` pattern, taken
        from the channel arrays without pandas (the same values)."""
        T = self.motion.n_frames
        cols = []
        for name in joint_names:
            n_dof = len(self.skeleton.dof[self.skeleton.index(name)])
            ch = self.motion.channels.get(name)
            cols.append(np.asarray(ch, dtype=np.float64)[:, :n_dof] if ch is not None
                        else np.zeros((T, n_dof)))
        if not cols:
            return np.zeros((T, 0), dtype=np.float32)
        return np.concatenate(cols, axis=1).astype(np.float32)

    # ------------------------------------------------------------ properties

    @property
    def joints(self):
        """Reference-style {name: Joint} tree view (reference motion.py:70)."""
        from .joint_tree import build_joint_tree

        return build_joint_tree(self.skeleton)

    @property
    def fps(self) -> int:
        return self._fps

    @property
    def n_frames(self) -> int:
        return self.motion.n_frames

    def positions(self) -> np.ndarray:
        """World-space joint positions (T, J, 3) via batched FK."""
        from .fk import forward_kinematics

        return forward_kinematics(self.skeleton, self.motion)["positions"]

    def view(self):
        """Interactive skeleton animation (reference motion.py:81-88)."""
        from ..viz.viewer import Viewer

        Viewer(self.skeleton, self.motion).run()
