"""The port's data layer (``gpmdm_tpu_torch.data``, numpy-only copies)
against the JAX package's, on the CPU: the ASF / AMC fixtures of
tests/fixtures, batched FK, the joint tree, ``MotionCapture``, the joint
subsets and the CMU registry (paths, ``available()``, the split).  The CMU
data itself is not in the repo; nothing here reads it.  Every comparison
is exact: the same numpy code on the same input.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import gpmdm_tpu.data as jdata
import gpmdm_tpu_torch.data as tdata
from gpmdm_tpu.data import fk as jfk
from gpmdm_tpu.data import registry as jreg
from gpmdm_tpu_torch.data import fk as tfk
from gpmdm_tpu_torch.data import registry as treg

FIX = Path(__file__).parent / "fixtures"
ROOT = Path(__file__).resolve().parents[1]


def _both(fn):
    return fn(jdata), fn(tdata)


def _assert_same(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_exports_and_joint_subsets_match():
    assert tdata.__all__ == jdata.__all__
    for name in ("ALL_JOINTS", "DIGIT_JOINTS", "REDUCED_JOINTS", "WALKING_SIMPLIFIED_JOINTS",
                 "CMU_MOCAP_LENGTH_TO_METERS"):
        assert getattr(tdata, name) == getattr(jdata, name), name


def test_asf_amc_fk_and_joint_tree_match_jax():
    """parse_asf, parse_amc, forward_kinematics and the joint tree's
    per-frame coordinates equal the JAX package's."""
    jskel, tskel = _both(lambda d: d.parse_asf(FIX / "tiny.asf"))
    _assert_same(jskel, tskel)
    jmot, tmot = jdata.parse_amc(FIX / "tiny.amc", jskel), tdata.parse_amc(FIX / "tiny.amc",
                                                                           tskel)
    _assert_same(jmot, tmot)
    _assert_same(jfk.forward_kinematics(jskel, jmot), tfk.forward_kinematics(tskel, tmot))
    angles = np.random.default_rng(0).uniform(-np.pi, np.pi, size=(6, 3))
    np.testing.assert_array_equal(tfk.euler_xyz_mat(angles), jfk.euler_xyz_mat(angles))
    jtree, ttree = jdata.build_joint_tree(jskel), tdata.build_joint_tree(tskel)
    assert list(ttree) == list(jtree)
    for t in range(tmot.n_frames):
        jtree["root"].set_motion(jmot.frame(t))
        ttree["root"].set_motion(tmot.frame(t))
        for name in jtree:
            np.testing.assert_array_equal(ttree[name].coordinate, jtree[name].coordinate)
            np.testing.assert_array_equal(ttree[name].matrix, jtree[name].matrix)


def test_motioncapture_select_joints_matches_jax():
    """select_joints (numpy-only in the port) and the other exports equal
    the JAX package's pandas-backed ones."""
    jmc, tmc = _both(lambda d: d.MotionCapture(FIX / "tiny.asf", FIX / "tiny.amc", fps=120,
                                               subject=7, trial=3))
    for joints in (["lowerleg"], ["upperleg", "foot"], ["foot", "root", "lowerleg"], []):
        got, want = tmc.select_joints(joints), jmc.select_joints(joints)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert tmc.get_columns_for_joints(["upperleg", "foot"]) == jmc.get_columns_for_joints(
        ["upperleg", "foot"])
    np.testing.assert_array_equal(tmc.positions(), jmc.positions())
    assert (tmc.fps, tmc.n_frames, tmc.subject, tmc.trial) == (120, 3, 7, 3)
    assert list(tmc.joints) == list(jmc.joints)


def test_registry_paths_and_split_match_jax(monkeypatch, tmp_path):
    """The trial tables, the split generator, the path helpers, the
    default directory (<repo>/mocap, or $GPMDM_TPU_MOCAP_DIR) and
    ``available()``, which needs a skeleton file, not only the directory."""
    for name in ("WALK_TRIAL_IDS", "WALK_TRIAL_IDS_TRAIN", "WALK_TRIAL_IDS_TEST",
                 "RUN_TRIAL_IDS", "RUN_TRIAL_IDS_TRAIN", "RUN_TRIAL_IDS_TEST"):
        assert ({k: list(v) for k, v in getattr(treg, name).items()}
                == {k: list(v) for k, v in getattr(jreg, name).items()}), name
    assert (treg.gen_test_train_split(treg.RUN_TRIAL_IDS, 1 / 3, seed=2)
            == jreg.gen_test_train_split(jreg.RUN_TRIAL_IDS, 1 / 3, seed=2))
    monkeypatch.delenv("GPMDM_TPU_MOCAP_DIR", raising=False)
    assert treg.default_mocap_dir() == jreg.default_mocap_dir() == ROOT / "mocap"
    assert treg.available() == jreg.available()
    monkeypatch.setenv("GPMDM_TPU_MOCAP_DIR", str(tmp_path))
    assert treg.default_mocap_dir() == tmp_path
    assert treg.asf_path(35) == jreg.asf_path(35) == tmp_path / "subjects" / "35" / "35.asf"
    assert treg.amc_path(7, 3) == tmp_path / "subjects" / "07" / "07_03.amc"
    assert not treg.available()
    (tmp_path / "subjects" / "07").mkdir(parents=True)
    assert not treg.available()  # an empty subject directory is no data
    (tmp_path / "subjects" / "07" / "07.asf").write_text((FIX / "tiny.asf").read_text())
    (tmp_path / "subjects" / "07" / "07_03.amc").write_text((FIX / "tiny.amc").read_text())
    assert treg.available() and jreg.available()
    (trial,) = treg.load_trials({7: [3]})
    (jtrial,) = jreg.load_trials({7: [3]})
    assert (trial.subject, trial.trial, trial.n_frames) == (7, 3, 3)
    np.testing.assert_array_equal(trial.select_joints(["lowerleg", "foot"]),
                                  jtrial.select_joints(["lowerleg", "foot"]))
    with pytest.raises(AttributeError):
        treg.NOT_A_TABLE  # noqa: B018
