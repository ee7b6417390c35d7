"""The port's viz layer (``gpmdm_tpu_torch.viz``) against the JAX package's
``gpmdm_tpu.viz`` on the same inputs, on the CPU with matplotlib's Agg
backend.

- The latent plots on ``bench_assets/bench_model.npz`` (d = 2) and
  ``bench_model_d4.npz`` (d = 4, the 3D branch), loaded by each package:
  the data of every artist that ``plot_latent_space``, ``plot_pf_trajectory``
  (one seeded trajectory, given to the port as a tensor) and
  ``plot_loss_history`` draw is equal exactly (the same fp32 values, no
  arithmetic on them), with the same labels and title.
- The skeleton plots on ``tests/fixtures/tiny.asf`` / ``tiny.amc``:
  ``draw_positions``, ``draw_skeleton_frame``, ``draw_joint_tree`` (and
  ``Joint.draw``) and ``MPLViewer.update_frame`` draw the same segments to
  1e-12.
- ``write_latent_html``: the two files are equal byte for byte.
"""

import os

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402,F401  (the test files import both packages)
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gpmdm_tpu import GPMDM as JGPMDM  # noqa: E402
from gpmdm_tpu.data import amc_asf as j_amc  # noqa: E402
from gpmdm_tpu.data import fk as j_fk  # noqa: E402
from gpmdm_tpu.data import joint_tree as j_jt  # noqa: E402
from gpmdm_tpu.viz import html3d as j_html  # noqa: E402
from gpmdm_tpu.viz import latent as j_lat  # noqa: E402
from gpmdm_tpu.viz import mpl_viewer as j_mv  # noqa: E402
from gpmdm_tpu.viz import skeleton_plot as j_sk  # noqa: E402
from gpmdm_tpu_torch import GPMDM  # noqa: E402
from gpmdm_tpu_torch import viz  # noqa: E402
from gpmdm_tpu_torch.data import amc_asf as t_amc  # noqa: E402
from gpmdm_tpu_torch.data import fk as t_fk  # noqa: E402
from gpmdm_tpu_torch.data import joint_tree as t_jt  # noqa: E402
from gpmdm_tpu_torch.viz import html3d as t_html  # noqa: E402
from gpmdm_tpu_torch.viz import latent as t_lat  # noqa: E402
from gpmdm_tpu_torch.viz import mpl_viewer as t_mv  # noqa: E402
from gpmdm_tpu_torch.viz import skeleton_plot as t_sk  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
ASSETS = ("bench_model.npz", "bench_model_d4.npz")


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.fixture(scope="module", params=ASSETS)
def models(request):
    path = os.path.join(ROOT, "bench_assets", request.param)
    return JGPMDM.load(path), GPMDM.load(path, device="cpu")


def artists(ax):
    """Every line and scatter of an axis as (kind, data) with its label, and
    the axis' title and legend texts."""
    out = []
    for line in ax.get_lines():
        data = line.get_data_3d() if hasattr(line, "get_data_3d") else line.get_xydata().T
        out.append(("line", line.get_label(), [np.asarray(a) for a in data]))
    for coll in ax.collections:
        data = coll._offsets3d if hasattr(coll, "_offsets3d") else coll.get_offsets().T
        out.append(("scatter", coll.get_label(), [np.asarray(a) for a in data]))
    legend = ax.get_legend()
    texts = [t.get_text() for t in legend.get_texts()] if legend else []
    return out, ax.get_title(), texts


def assert_same_artists(got_ax, want_ax, atol=None):
    got, got_title, got_legend = artists(got_ax)
    want, want_title, want_legend = artists(want_ax)
    assert (got_title, got_legend) == (want_title, want_legend)
    assert [(k, lab, len(d)) for k, lab, d in got] == [(k, lab, len(d)) for k, lab, d in want]
    for (_, lab, g), (_, _, w) in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape, lab
            if atol is None:
                assert np.array_equal(a, b), lab
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=lab)


def test_viz_exports_the_jax_packages_six():
    from gpmdm_tpu import viz as j_viz

    assert sorted(viz.__all__) == sorted(j_viz.__all__)
    assert all(callable(getattr(viz, name)) for name in viz.__all__)


def test_plot_latent_space_matches_jax(models):
    jm, tm = models
    want = j_lat.plot_latent_space(jm, class_names=["walk", "run"])
    got = t_lat.plot_latent_space(tm, class_names=["walk", "run"])
    assert got.name == want.name  # "3d" past d = 2
    assert_same_artists(got, want)


def test_plot_pf_trajectory_matches_jax(models):
    jm, tm = models
    traj = np.random.default_rng(7).standard_normal((40, jm.d)).astype(np.float32)
    want = j_lat.plot_pf_trajectory(jm, traj)
    got = t_lat.plot_pf_trajectory(tm, torch.from_numpy(traj))
    assert_same_artists(got, want)
    assert got.get_lines()[-1].get_label() == "PF state mean"


def test_plot_loss_history_matches_jax():
    losses = list(np.cumsum(np.random.default_rng(3).standard_normal(60)) * 1e3)
    want = j_lat.plot_loss_history(losses)
    got = t_lat.plot_loss_history(losses)
    assert_same_artists(got, want)
    assert (got.get_xlabel(), got.get_ylabel(), got.get_yscale()) == (
        want.get_xlabel(), want.get_ylabel(), want.get_yscale())


def test_write_latent_html_matches_jax_byte_for_byte(models, tmp_path):
    jm, tm = models
    traj = np.random.default_rng(11).standard_normal((25, jm.d)).astype(np.float32)
    want = j_html.write_latent_html(jm, tmp_path / "jax.html", class_names=["walk", "run"],
                                    trajectory=traj)
    got = t_html.write_latent_html(tm, tmp_path / "torch.html", class_names=["walk", "run"],
                                   trajectory=torch.from_numpy(traj))
    assert got.read_bytes() == want.read_bytes()
    plain = t_html.write_latent_html(tm, tmp_path / "plain.html")
    assert plain.read_bytes() == j_html.write_latent_html(jm, tmp_path / "jplain.html").read_bytes()


@pytest.fixture(scope="module")
def skeletons():
    """The tiny fixture parsed by each package, and each one's FK positions."""
    out = []
    for amc, fk in ((j_amc, j_fk), (t_amc, t_fk)):
        skel = amc.parse_asf(os.path.join(FIX, "tiny.asf"))
        motion = amc.parse_amc(os.path.join(FIX, "tiny.amc"), skel)
        out.append((skel, motion, fk.forward_kinematics(skel, motion)["positions"]))
    return out


def test_draw_positions_and_skeleton_frame_match_jax(skeletons):
    (js, _, jpos), (ts, _, tpos) = skeletons
    np.testing.assert_allclose(tpos, jpos, rtol=0, atol=1e-12)
    for f in range(len(jpos)):
        assert_same_artists(t_sk.draw_positions(tpos[f], ts.parent),
                            j_sk.draw_positions(jpos[f], js.parent), atol=1e-12)
        assert_same_artists(t_sk.draw_skeleton_frame(ts, tpos[f]),
                            j_sk.draw_skeleton_frame(js, jpos[f]), atol=1e-12)
        plt.close("all")


def _frame_pose(motion, f):
    """The channels of frame f as the Joint tree's set_motion takes them."""
    return {name: list(np.asarray(ch)[f]) for name, ch in motion.channels.items()}


def test_draw_joint_tree_and_joint_draw_match_jax(skeletons):
    (js, jmo, _), (ts, tmo, _) = skeletons
    jroot, troot = j_jt.build_joint_tree(js)["root"], t_jt.build_joint_tree(ts)["root"]
    for f in range(jmo.n_frames):
        jroot.set_motion(_frame_pose(jmo, f))
        troot.set_motion(_frame_pose(tmo, f))
        want = j_sk.draw_joint_tree(jroot, show=False)
        assert_same_artists(t_sk.draw_joint_tree(troot, show=False), want, atol=1e-12)
        assert_same_artists(troot.draw(show=False), want, atol=1e-12)
        plt.close("all")


def test_mpl_viewer_update_frame_matches_jax(skeletons):
    (js, jmo, _), (ts, tmo, _) = skeletons
    jv, tv = j_mv.MPLViewer(js, jmo), t_mv.MPLViewer(ts, tmo)
    for i in range(jmo.n_frames):
        jv.update_frame(i)
        tv.update_frame(i)
        assert_same_artists(tv.ax, jv.ax, atol=1e-12)
    jv.animate(downsample=2)
    tv.animate(downsample=2)
    jv.update_frame(1)
    tv.update_frame(1)
    assert tv.frame == jv.frame == 2
    assert_same_artists(tv.ax, jv.ax, atol=1e-12)
