"""CMU skeleton joint subsets for DOF reduction.

Same constants as the reference (`reference/dataset_utils/
select_joints.py:5-61`): the full 31-joint list, digit joints, the reduced
set, and the walking-simplified set (35 DOFs) used for all published GPMDM
experiments.

These are DATA, not code: the joint names are the CMU mocap skeleton's
standard bone names and the subsets must match the reference exactly for
experiment parity — any 'rewrite' would be wrong.

A numpy-only copy of ``gpmdm_tpu/data/joints.py`` for the port, which imports
nothing of the JAX package.
"""

from __future__ import annotations

ALL_JOINTS = [
    "root",
    "lhipjoint",
    "lfemur",
    "ltibia",
    "lfoot",
    "ltoes",
    "rhipjoint",
    "rfemur",
    "rtibia",
    "rfoot",
    "rtoes",
    "lowerback",
    "upperback",
    "thorax",
    "lowerneck",
    "upperneck",
    "head",
    "lclavicle",
    "lhumerus",
    "lradius",
    "lwrist",
    "lhand",
    "lfingers",
    "lthumb",
    "rclavicle",
    "rhumerus",
    "rradius",
    "rwrist",
    "rhand",
    "rfingers",
    "rthumb",
]

DIGIT_JOINTS = ["lthumb", "rthumb", "lfingers", "rfingers", "lthumb", "rthumb"]

REDUCED_JOINTS = [j for j in ALL_JOINTS if j not in DIGIT_JOINTS]

_NON_WALKING_SIMPLIFIED = [
    "root",
    "lowerneck",
    "upperneck",
    "head",
    "lwrist",
    "lhand",
    "rwrist",
    "rhand",
] + DIGIT_JOINTS

#: 23 joints / 35 DOFs used by the published walk-vs-run experiments
#: (reference select_joints.py:50-61; train_gpmdm.ipynb cell 1).
WALKING_SIMPLIFIED_JOINTS = [j for j in ALL_JOINTS if j not in _NON_WALKING_SIMPLIFIED]
