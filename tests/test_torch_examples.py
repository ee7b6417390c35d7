"""The port's example scripts (``python -m gpmdm_tpu_torch.examples.<name>``)
on the synthetic fallback, on the CPU (``GPMDM_TPU_PLATFORM=cpu``), as
tests/test_examples.py runs the JAX package's: a 25-step training run, then
evaluation (looped and banked), the PF demo GIF, the model inspection and
the skeleton walkthrough, each in a subprocess with the same printed
markers and files.  The subprocesses that need the checkpoint start
together once it is written, beside the one that does not.

Also: ``load_gpmdm``'s printed loss and class counts against the JAX
package's ``GPMDM.load(ckpt)``; the command line's ``demo``, ``rollout
--plot`` and ``view`` through ``main([...])``; and, with neither a card nor
the pin, exit code 2.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402,F401  (the test files import both packages)
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gpmdm_tpu import GPMDM as JGPMDM  # noqa: E402
from gpmdm_tpu_torch import GPMDM  # noqa: E402
from gpmdm_tpu_torch.__main__ import main  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIX = ROOT / "tests" / "fixtures"
TIMEOUT_S = 300


def _env(pin=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT), MPLBACKEND="Agg", OMP_NUM_THREADS="2")
    env.pop("GPMDM_TPU_MOCAP_DIR", None)
    if pin:
        env["GPMDM_TPU_PLATFORM"] = "cpu"
    else:
        env.pop("GPMDM_TPU_PLATFORM", None)
    return env


def _start(name, *args, cwd, pin=True):
    return subprocess.Popen([sys.executable, "-m", f"gpmdm_tpu_torch.examples.{name}", *args],
                            cwd=cwd, env=_env(pin), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT_S)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every example's run: the walkthrough beside the training, then the
    four that read its checkpoint, all at once."""
    d = tmp_path_factory.mktemp("examples")
    ckpt = d / "m.npz"
    procs = {"joints": _start("joints", "--out-dir", str(d / "joints"), cwd=d)}
    try:
        done = {"train_gpmdm": _finish(_start("train_gpmdm", "--steps", "25",
                                              "--out", str(ckpt), cwd=d))}
        if done["train_gpmdm"].returncode == 0:
            procs.update({
                "test_gpmdm_pf": _start("test_gpmdm_pf", str(ckpt), "--particles", "40", cwd=d),
                "test_gpmdm_pf --banked": _start("test_gpmdm_pf", str(ckpt), "--particles",
                                                 "40", "--banked", cwd=d),
                "view_gpmdm_pf": _start("view_gpmdm_pf", str(ckpt), "--particles", "30",
                                        "--out", str(d / "demo.gif"), cwd=d),
                "load_gpmdm": _start("load_gpmdm", str(ckpt), "--save", str(d / "latent.png"),
                                     "--html", str(d / "latent.html"), cwd=d),
            })
        done.update({k: _finish(p) for k, p in procs.items()})
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    train = done["train_gpmdm"]
    assert train.returncode == 0, f"train_gpmdm: {train.stderr[-2000:]}"
    return d, ckpt, done


# each example's printed marker and the files it must write
EXPECTED = {
    "train_gpmdm": ("latent map NMSE", ["m.npz"]),
    "test_gpmdm_pf": ("frame confusion", []),
    "test_gpmdm_pf --banked": ("frame confusion", []),
    "view_gpmdm_pf": ("wrote", ["demo.gif"]),
    "load_gpmdm": ("latent points", ["latent.png", "latent.html"]),
    "joints": ("joints:", ["joints/zero_pose.png", "joints/perturbed_pose.png",
                           "joints/joints_animation.gif"]),
}


@pytest.mark.parametrize("name", list(EXPECTED))
def test_example_runs(runs, name):
    d, _, done = runs
    r = done[name]
    marker, files = EXPECTED[name]
    assert r.returncode == 0, r.stderr[-2000:]
    assert marker in r.stdout
    for f in files:
        assert (d / f).stat().st_size > 0, f
    if name == "view_gpmdm_pf":
        assert (d / "demo.gif").stat().st_size > 1000
        assert "(80 frames)" in r.stdout
    if name == "train_gpmdm":
        loss = float(re.search(r"final loss (\S+)", r.stdout).group(1))
        assert np.isfinite(loss)
    if name.startswith("test_gpmdm_pf"):
        assert re.search(r"trials: acc=[0-9.]+", r.stdout)


def _as_float64(src, dst):
    """A copy of checkpoint ``src`` in float64: its arrays cast, its config's
    dtype set."""
    with np.load(src) as z:
        arrays = {k: z[k].astype(np.float64) if z[k].dtype == np.float32 else z[k]
                  for k in z.files}
    meta = json.loads(bytes(arrays["meta_json"]).decode())
    meta["config"]["dtype"] = "float64"
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(dst, **arrays)


def test_load_gpmdm_matches_the_jax_package(runs, tmp_path, monkeypatch, capsys):
    """``load_gpmdm`` against the JAX package's ``GPMDM.load(ckpt)``.

    On the trained fp32 checkpoint the printed loss is the port's
    ``gpdm_loss`` and the class counts are the JAX package's; the two fp32
    evaluations lie within 3e-4 relative of each other (measured 2.0e-5 and
    7.1e-5) and closer together than the JAX one lies to the float64 loss
    of the same parameters (this model's fp32 loss is ~6e-3 from it, so
    neither fp32 evaluation holds 1e-5).  On a float64 copy of the
    checkpoint the printed loss is the JAX package's, and the port's loss is
    within 1e-9 relative of it."""
    from gpmdm_tpu_torch.examples import load_gpmdm

    _, ckpt, done = runs
    out = done["load_gpmdm"].stdout
    port32 = GPMDM.load(ckpt, device="cpu").gpdm_loss()
    assert re.search(r"^loss: (\S+)$", out, re.M).group(1) == f"{port32:.4e}"
    jm = JGPMDM.load(str(ckpt))
    counts = [int(n) for n in re.findall(r"^class \d+: (\d+) latent points$", out, re.M)]
    assert counts == [int(jm.get_X_for_class(c).shape[0]) for c in range(jm.n_classes)]
    assert f"GPMDM: D={jm.D} d={jm.d} classes={jm.n_classes}" in out

    ckpt64 = tmp_path / "m64.npz"
    _as_float64(ckpt, ckpt64)
    jax32, jax64 = float(jm.gpdm_loss()), float(JGPMDM.load(str(ckpt64)).gpdm_loss())
    assert abs(port32 - jax32) <= 3e-4 * abs(jax32)
    assert abs(port32 - jax32) < abs(jax32 - jax64)
    monkeypatch.setenv("GPMDM_TPU_PLATFORM", "cpu")
    assert load_gpmdm.main([str(ckpt64), "--save", str(tmp_path / "latent64.png")]) == 0
    printed = re.search(r"^loss: (\S+)$", capsys.readouterr().out, re.M).group(1)
    assert printed == f"{jax64:.4e}"
    port64 = GPMDM.load(ckpt64, device="cpu").gpdm_loss()
    assert abs(port64 - jax64) <= 1e-9 * abs(jax64)


def test_cli_demo(runs, monkeypatch, tmp_path, capsys):
    """``demo`` runs the view_gpmdm_pf example: the filter over the 80-frame
    trial and its GIF."""
    _, ckpt, _ = runs
    monkeypatch.setenv("GPMDM_TPU_PLATFORM", "cpu")
    out = tmp_path / "demo.gif"
    assert main(["demo", str(ckpt), "--out", str(out), "--particles", "30"]) == 0
    assert out.stat().st_size > 1000
    assert f"wrote {out} (80 frames)" in capsys.readouterr().out


def test_cli_rollout_plot(runs, monkeypatch, capsys):
    """``rollout --plot`` prints the rollout and draws it over the latent
    space (plot_pf_trajectory)."""
    import matplotlib.pyplot as plt

    _, ckpt, _ = runs
    monkeypatch.setenv("GPMDM_TPU_PLATFORM", "cpu")
    plt.close("all")
    assert main(["rollout", str(ckpt), "--steps", "5", "--cls", "1", "--plot"]) == 0
    m = GPMDM.load(ckpt, device="cpu")
    want = m.rollout(m.get_X_for_class(1)[0].numpy(), 5, 1).numpy()
    line = plt.gcf().axes[0].get_lines()[-1]
    assert line.get_label() == "PF state mean"
    np.testing.assert_array_equal(line.get_xydata(), want[:, :2])
    assert len(capsys.readouterr().out.strip().splitlines()) == 5
    plt.close("all")


def test_cli_view_needs_neither_card_nor_pin(monkeypatch):
    """``view`` reads no model: it runs the viewer with the pin unset and
    with no card."""
    from gpmdm_tpu_torch.viz import viewer

    ran = []
    monkeypatch.delenv("GPMDM_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(viewer.Viewer, "run", lambda self: ran.append((self.fps, self.positions.shape)))
    assert main(["view", str(FIX / "tiny.asf"), str(FIX / "tiny.amc"), "--fps", "30"]) == 0
    assert ran and ran[0][0] == 30 and ran[0][1][0] > 0


@pytest.mark.parametrize("argv", [
    ["train_gpmdm", "--steps", "1"],
    ["test_gpmdm_pf", "m.npz"],
    ["load_gpmdm", "m.npz"],
    ["view_gpmdm_pf", "m.npz"],
    ["demo", "m.npz"],
], ids=lambda a: a[0])
def test_no_card_and_no_pin_exits_2(argv, monkeypatch, capsys):
    import importlib

    monkeypatch.delenv("GPMDM_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = main if argv[0] == "demo" else importlib.import_module(
        f"gpmdm_tpu_torch.examples.{argv[0]}").main
    assert fn(argv if argv[0] == "demo" else argv[1:]) == 2
    assert "no CUDA card" in capsys.readouterr().err


def test_python_m_example_without_a_card_exits_2(runs):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    d, ckpt, _ = runs
    r = _finish(_start("test_gpmdm_pf", str(ckpt), cwd=d, pin=False))
    assert r.returncode == 2
    assert "no CUDA card" in r.stderr and "frame confusion" not in r.stdout
