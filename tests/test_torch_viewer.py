"""The port's interactive viewer (``gpmdm_tpu_torch.viz.viewer.Viewer``) on
the SDL dummy driver, as tests/test_viewer.py drives the JAX package's:
pygame runs for real and the GL calls go to a recording stub (no GL context
exists headless).  Beside tests/test_viewer.py's four tests, the port's
positions equal the JAX Viewer's to 1e-12 and both emit the same GL calls
over two frames.
"""

import os
import types

import jax  # noqa: F401  (the test files import both packages)
import numpy as np
import pytest

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _viewer(pkg):
    """A Viewer of ``pkg`` (the port or the JAX package) on the tiny fixture."""
    import importlib

    amc = importlib.import_module(f"{pkg}.data.amc_asf")
    viewer = importlib.import_module(f"{pkg}.viz.viewer")
    skel = amc.parse_asf(os.path.join(FIX, "tiny.asf"))
    return viewer.Viewer(skel, amc.parse_amc(os.path.join(FIX, "tiny.amc"), skel), fps=30)


@pytest.fixture(scope="module")
def pygame():
    pygame = pytest.importorskip("pygame")
    pygame.init()
    yield pygame
    pygame.quit()


@pytest.fixture(scope="module")
def viewer(pygame):
    return _viewer("gpmdm_tpu_torch")


class _RecordingGL(types.SimpleNamespace):
    """A stand-in for OpenGL.GL: constants are 0, every call is recorded."""

    def __init__(self):
        super().__init__()
        self.__dict__["calls"] = []

    def __getattr__(self, name):
        if name.isupper() or name.startswith("GL_"):
            return 0

        def record(*args):
            self.calls.append((name, args))

        return record


def test_viewer_precomputes_all_frames(viewer):
    assert viewer.positions.ndim == 3  # (frames, joints, 3)
    assert len(viewer.positions) > 0
    assert np.isfinite(viewer.positions).all()


def test_viewer_event_surface(viewer, pygame):
    """Drive every control through synthetic pygame events."""
    from pygame.locals import (
        K_ESCAPE, K_RIGHT, K_SPACE, K_e, K_r, K_w, KEYDOWN,
        MOUSEBUTTONDOWN, MOUSEBUTTONUP, MOUSEMOTION, QUIT,
    )

    def key(k):
        return pygame.event.Event(KEYDOWN, key=k)

    assert viewer.playing
    assert viewer.process_event(key(K_SPACE)) and not viewer.playing

    f0 = viewer.frame
    viewer.process_event(key(K_RIGHT))
    assert viewer.frame == (f0 + 1) % len(viewer.positions)

    t0 = viewer.trans.copy()
    viewer.process_event(key(K_w))
    viewer.process_event(key(K_e))
    assert viewer.trans[1] == t0[1] - 0.2 and viewer.trans[2] == t0[2] - 0.4

    # mouse-drag rotation
    r0 = viewer.rot.copy()
    viewer.process_event(pygame.event.Event(MOUSEBUTTONDOWN, button=1))
    viewer.process_event(pygame.event.Event(MOUSEMOTION, rel=(10, -5)))
    viewer.process_event(pygame.event.Event(MOUSEBUTTONUP, button=1))
    assert viewer.rot[1] == pytest.approx(r0[1] + 3.0)
    assert viewer.rot[0] == pytest.approx(r0[0] - 1.5)

    # reset restores the camera
    viewer.process_event(key(K_r))
    assert tuple(viewer.rot) == (20.0, -30.0)
    assert tuple(viewer.trans) == (0.0, -1.0, -6.0)

    # escape / window-close quit
    assert not viewer.process_event(key(K_ESCAPE))
    assert not viewer.process_event(pygame.event.Event(QUIT))


def test_viewer_step_and_speed(viewer):
    viewer.playing = True
    viewer.speed = 2.0
    f0 = viewer.frame
    viewer.step()
    assert viewer.frame == (f0 + 2) % len(viewer.positions)
    viewer.playing = False
    f1 = viewer.frame
    viewer.step()
    assert viewer.frame == f1


def test_viewer_draw_sequence(viewer):
    """Render two frames against a recording GL stub: the draw path must
    emit a point per joint and a line segment per bone, with valid
    coordinates."""
    gl = _RecordingGL()
    for _ in range(2):
        viewer.step()
        viewer._draw_frame(gl)

    names = [n for n, _ in gl.calls]
    n_joints = viewer.positions.shape[1]
    n_bones = int(np.sum(np.asarray(viewer.skeleton.parent) >= 0))
    assert names.count("glVertex3f") == 2 * (n_joints + 2 * n_bones)
    verts = [a for n, a in gl.calls if n == "glVertex3f"]
    assert np.isfinite(np.asarray(verts, dtype=float)).all()


def test_viewer_matches_the_jax_viewer(pygame):
    """Fresh viewers of both packages: the same positions to 1e-12 and the
    same GL calls, argument for argument, over two played frames."""
    want, got = _viewer("gpmdm_tpu"), _viewer("gpmdm_tpu_torch")
    np.testing.assert_allclose(got.positions, want.positions, rtol=0, atol=1e-12)
    calls = []
    for v in (want, got):
        gl = _RecordingGL()
        for _ in range(2):
            v.step()
            v._draw_frame(gl)
        calls.append(gl.calls)
    assert [n for n, _ in calls[1]] == [n for n, _ in calls[0]]
    assert len(calls[1]) > 0
    for (name, a), (_, b) in zip(calls[1], calls[0]):
        np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float),
                                   rtol=0, atol=1e-12, err_msg=name)


def test_motion_capture_view_runs_the_viewer(monkeypatch):
    """``MotionCapture.view`` plays its own skeleton and motion in the
    viewer (reference motion.py:81-88)."""
    from gpmdm_tpu_torch.data.motion import MotionCapture
    from gpmdm_tpu_torch.viz import viewer

    ran = []
    monkeypatch.setattr(viewer.Viewer, "run", lambda self: ran.append(self))
    mc = MotionCapture(os.path.join(FIX, "tiny.asf"), os.path.join(FIX, "tiny.amc"))
    mc.view()
    assert len(ran) == 1 and ran[0].skeleton is mc.skeleton and ran[0].motion is mc.motion
    np.testing.assert_array_equal(ran[0].positions, mc.positions())
