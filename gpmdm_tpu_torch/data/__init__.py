"""Data layer: synthetic benchmark data, CMU ASF/AMC parsing, FK, registry."""

from . import synthetic
from .amc_asf import CMU_MOCAP_LENGTH_TO_METERS, Motion, Skeleton, parse_amc, parse_asf
from .joint_tree import Joint, build_joint_tree
from .joints import ALL_JOINTS, DIGIT_JOINTS, REDUCED_JOINTS, WALKING_SIMPLIFIED_JOINTS
from .motion import MotionCapture

__all__ = [
    "synthetic",
    "CMU_MOCAP_LENGTH_TO_METERS",
    "Motion",
    "Skeleton",
    "parse_amc",
    "parse_asf",
    "Joint",
    "build_joint_tree",
    "MotionCapture",
    "ALL_JOINTS",
    "DIGIT_JOINTS",
    "REDUCED_JOINTS",
    "WALKING_SIMPLIFIED_JOINTS",
]
