"""CMU walk/run trial registry and frozen train/test split.

Same subject/trial ids and split as the reference
(`reference/dataset_utils/mocap_labels.py:7-30`; split generated once
by its ``test_train.ipynb`` and frozen).  The id tables are DATA — they
must match the reference verbatim or the published train/test split (and
every number derived from it) changes.  Design difference: the reference
parses all 58 trials eagerly at *import time* (mocap_labels.py:56-62); here
loading is lazy and cached — importing this module costs nothing, and the
mocap directory is resolved at load time from ``mocap_dir`` /
``$GPMDM_TPU_MOCAP_DIR`` / ``<repo>/mocap``.

The CMU dataset is not redistributed (reference README.md:24 asks for a
manual download); :func:`available` reports whether the data directory is
present.

A numpy-only copy of ``gpmdm_tpu/data/registry.py`` for the port, which imports
nothing of the JAX package.
:func:`default_mocap_dir` resolves the same ``<repo>/mocap`` from the
port's location.
"""

from __future__ import annotations

import os
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Sequence

from .motion import MotionCapture

#: Walk trials by subject (reference mocap_labels.py:7-14).
WALK_TRIAL_IDS: Dict[int, Sequence[int]] = {
    2: [1, 2],
    5: [1],
    6: [1],
    7: range(1, 13),
    8: range(1, 12),
    10: [4],
    12: [1, 2, 3],
}

#: Frozen train/test split (reference mocap_labels.py:18-19).
WALK_TRIAL_IDS_TRAIN: Dict[int, Sequence[int]] = {
    2: [2], 5: [1], 6: [1], 7: [12, 7, 11], 8: [9], 10: [4], 12: [2, 1],
}
WALK_TRIAL_IDS_TEST: Dict[int, Sequence[int]] = {
    2: [1],
    7: [1, 2, 3, 4, 5, 6, 8, 9, 10],
    8: [1, 2, 3, 4, 5, 6, 7, 8, 10, 11],
    12: [3],
}

#: Run trials by subject (reference mocap_labels.py:21-26).
RUN_TRIAL_IDS: Dict[int, Sequence[int]] = {
    2: [3],
    9: range(1, 12),
    16: [35, 36, 45, 46, 55, 56],
    35: range(17, 26),
}

#: Frozen train/test split (reference mocap_labels.py:29-30).
RUN_TRIAL_IDS_TRAIN: Dict[int, Sequence[int]] = {
    2: [3], 9: [3, 8, 2, 10], 16: [45, 46], 35: [20, 25],
}
RUN_TRIAL_IDS_TEST: Dict[int, Sequence[int]] = {
    9: [1, 4, 5, 6, 7, 9, 11],
    16: [35, 36, 55, 56],
    35: [17, 18, 19, 21, 22, 23, 24],
}


def default_mocap_dir() -> Path:
    env = os.environ.get("GPMDM_TPU_MOCAP_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "mocap"


def asf_path(subject: int, mocap_dir: Path | None = None) -> Path:
    """Path of a subject's skeleton file (reference mocap_labels.py:38-40)."""
    root = Path(mocap_dir or default_mocap_dir())
    s = str(subject).zfill(2)
    return root / "subjects" / s / f"{s}.asf"


def amc_path(subject: int, trial: int, mocap_dir: Path | None = None) -> Path:
    """Path of one trial's motion file (reference mocap_labels.py:32-36)."""
    root = Path(mocap_dir or default_mocap_dir())
    s, t = str(subject).zfill(2), str(trial).zfill(2)
    return root / "subjects" / s / f"{s}_{t}.amc"


def available(mocap_dir: Path | None = None) -> bool:
    """Whether the CMU mocap data is actually present.

    Checks for a skeleton file, not just the directory: an aborted
    tools/fetch_cmu.py run (e.g. offline) leaves empty subject directories
    behind, and a bare is_dir() check would then send every loader into
    FileNotFoundError instead of the synthetic fallback."""
    subjects = Path(mocap_dir or default_mocap_dir()) / "subjects"
    return subjects.is_dir() and any(subjects.glob("*/*.asf"))


def load_trials(
    trial_ids: Dict[int, Sequence[int]], mocap_dir: Path | None = None, fps: int = 120
) -> List[MotionCapture]:
    """Parse all (subject, trial) pairs into MotionCapture objects
    (reference __get_mocaps, mocap_labels.py:43-53)."""
    out = []
    for subject, trials in trial_ids.items():
        for trial in trials:
            out.append(
                MotionCapture(
                    asf_path(subject, mocap_dir),
                    amc_path(subject, trial, mocap_dir),
                    fps=fps,
                    subject=subject,
                    trial=trial,
                )
            )
    return out


@lru_cache(maxsize=None)
def _cached(name: str):
    ids = {
        "WALK_TRIALS": WALK_TRIAL_IDS,
        "WALK_TRIALS_TRAIN": WALK_TRIAL_IDS_TRAIN,
        "WALK_TRIALS_TEST": WALK_TRIAL_IDS_TEST,
        "RUN_TRIALS": RUN_TRIAL_IDS,
        "RUN_TRIALS_TRAIN": RUN_TRIAL_IDS_TRAIN,
        "RUN_TRIALS_TEST": RUN_TRIAL_IDS_TEST,
    }[name]
    return load_trials(ids)


def __getattr__(name: str):
    """Lazy module attributes WALK_TRIALS[_TRAIN/_TEST], RUN_TRIALS[...] —
    the reference's module-level lists (mocap_labels.py:56-62) without the
    eager import-time parse."""
    if name in (
        "WALK_TRIALS",
        "WALK_TRIALS_TRAIN",
        "WALK_TRIALS_TEST",
        "RUN_TRIALS",
        "RUN_TRIALS_TRAIN",
        "RUN_TRIALS_TEST",
    ):
        return _cached(name)
    raise AttributeError(name)


def gen_test_train_split(
    trial_dict: Dict[int, Sequence[int]], train_fraction: float = 1 / 3, seed: int = 0
) -> tuple[Dict[int, List[int]], Dict[int, List[int]]]:
    """Random split guaranteeing >= 1 trial per subject in train (the
    reference's split generator, dataset_utils/test_train.ipynb cells 3-5)."""
    import random

    rng = random.Random(seed)
    flat = [(s, t) for s, ts in trial_dict.items() for t in ts]
    n_train = max(len(trial_dict), round(len(flat) * train_fraction))
    train: Dict[int, List[int]] = {}
    test: Dict[int, List[int]] = {}
    # one guaranteed trial per subject
    for s, ts in trial_dict.items():
        ts = list(ts)
        pick = rng.choice(ts)
        train[s] = [pick]
    remaining = [(s, t) for s, t in flat if t not in train.get(s, [])]
    rng.shuffle(remaining)
    for s, t in remaining:
        if sum(len(v) for v in train.values()) < n_train:
            train.setdefault(s, []).append(t)
        else:
            test.setdefault(s, []).append(t)
    return train, test
