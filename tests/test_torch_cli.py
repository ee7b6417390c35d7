"""The port's command line (``python -m gpmdm_tpu_torch``), driven in-process
through ``main([...])`` on the CPU (``GPMDM_TPU_PLATFORM=cpu``), as
tests/test_cli.py drives the JAX package's: ``train`` with each optimizer
and family, ``eval`` looped and banked, ``deploy`` with a pinned rank and
with ``--sparsify`` and its exit-code-2 checks, ``rollout``, ``--jsonl``,
``--trace`` and the platform pin.  Small shapes: the synthetic fallback at
a few steps, a float64 model of 2 x 2 x 40 frames (D = 8) for the rest.
"""

import json

import numpy as np
import pytest
import threadpoolctl
import torch

from gpmdm_tpu_torch import GPMDM, BCGPMDM, SparseGPMDM
from gpmdm_tpu_torch.__main__ import main
from gpmdm_tpu_torch.data import synthetic
from gpmdm_tpu_torch.models.compressed import CompressedPosterior


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU pin, and one BLAS thread (small shapes)."""
    monkeypatch.setenv("GPMDM_TPU_PLATFORM", "cpu")
    monkeypatch.delenv("GPMDM_TPU_MOCAP_DIR", raising=False)
    with threadpoolctl.threadpool_limits(1):
        yield


def _small_model(cls=GPMDM, **kw):
    tr, tl, _, _ = synthetic.make_dataset(n_classes=2, n_train_seqs=2, n_test_seqs=1,
                                          seq_len=40, D=8, seed=3)
    m = cls(D=8, d=2, n_classes=2, dtype="float64", y_sigma_n_init=0.1, x_sigma_n_init=0.1,
            device="cpu", **kw)
    for Y, c in zip(tr, tl):
        m.add_data(Y, c)
    m.init_X()
    return m


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A small exact model, trained 5 Adam steps and saved."""
    with threadpoolctl.threadpool_limits(1):
        m = _small_model()
        m.train_adam(5)
        path = tmp_path_factory.mktemp("cli") / "m.npz"
        m.save(path)
    return path


@pytest.mark.parametrize("flags,cls,opt", [
    ([], GPMDM, "adam"),
    (["--optimizer", "lbfgs"], GPMDM, "lbfgs"),
    (["--sparse", "--inducing", "16"], SparseGPMDM, "adam"),
    (["--back-constrained", "--optimizer", "lbfgs"], BCGPMDM, "lbfgs"),
], ids=["adam", "lbfgs", "sparse", "bc_lbfgs"])
def test_cli_train_each_family_and_optimizer(tmp_path, capsys, flags, cls, opt):
    """train on the synthetic fallback writes a checkpoint of the family,
    with the optimizer's state, and logs one JSON record a chunk."""
    out, log = tmp_path / "t.npz", tmp_path / "train.jsonl"
    rc = main(["train", "--out", str(out), "--latent-dim", "2", "--steps", "2",
               "--jsonl", str(log), *flags])
    assert rc == 0
    text = capsys.readouterr().out
    assert "using synthetic limit cycles" in text and "final loss" in text
    m = GPMDM.load(out, device="cpu")
    assert type(m) is cls and m._opt_name == opt and m._opt_state is not None
    assert m.D == 12 and m.d == 2 and m.layout.Ny == 640
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2] and np.isfinite(records[-1]["loss"])
    assert ("evals_per_step" in records[-1]) == (opt == "lbfgs")


def test_cli_train_deploy_flag(tmp_path, capsys, monkeypatch):
    """--deploy resolves the 'auto' policy before the save: past the
    (lowered) compression threshold the compressed posterior is persisted
    under the default key."""
    from gpmdm_tpu_torch.filter import particle_filter as pf

    monkeypatch.setattr(pf, "AUTO_COMPRESS_N", 10)
    out = tmp_path / "t.npz"
    assert main(["train", "--out", str(out), "--latent-dim", "2", "--steps", "2",
                 "--deploy"]) == 0
    assert "deployed posterior: compressed" in capsys.readouterr().out
    assert (None, None, 1e-6) in GPMDM.load(out, device="cpu")._compressed_cache


def test_cli_train_rejects_two_families(tmp_path, capsys):
    rc = main(["train", "--out", str(tmp_path / "t.npz"), "--sparse", "--back-constrained",
               "--steps", "1"])
    assert rc == 2 and "mutually exclusive" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [[], ["--banked"], ["--banked", "--sparsify", "16"],
                                   ["--compress-rank", "9"]],
                         ids=["looped", "banked", "banked_sparsified", "compressed"])
def test_cli_eval_prints_the_report(saved, capsys, flags):
    rc = main(["eval", str(saved), "--particles", "20", "--burn-in", "2", *flags])
    assert rc == 0
    text = capsys.readouterr().out
    assert "frames: acc=" in text and "trial confusion" in text
    if "--sparsify" in flags:
        assert "sparsified posterior: M_y=16 (of Ny=160)" in text
    if "--compress-rank" in flags:
        assert "compressed posterior: quad rank 9/160" in text


def test_cli_eval_trace_writes_a_chrome_trace(saved, tmp_path, capsys):
    """--trace wraps the command in torch.profiler and writes its Chrome
    trace (JSON with trace events) into the directory."""
    trace_dir = tmp_path / "trace"
    rc = main(["eval", str(saved), "--particles", "20", "--burn-in", "2", "--banked",
               "--trace", str(trace_dir)])
    assert rc == 0
    assert "profiler trace written" in capsys.readouterr().out
    (trace,) = trace_dir.glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_cli_deploy_bakes_a_pinned_rank_as_the_auto_deployment(saved, tmp_path, capsys):
    out = tmp_path / "deployed.npz"
    rc = main(["deploy", str(saved), "--out", str(out), "--rank-y", "9", "--rank-x", "7"])
    assert rc == 0
    msg = capsys.readouterr().out
    assert "rank_y=9" in msg and str(out) in msg
    m = GPMDM.load(out, device="cpu")
    cp = m._compressed_cache[(9, 7, 1e-6)]
    assert isinstance(cp, CompressedPosterior) and cp.rank_y == 9
    assert m._compressed_cache[(None, None, 1e-6)] is cp
    ref = GPMDM.load(saved, device="cpu").compressed_posterior(rank_y=9, rank_x=7)
    np.testing.assert_allclose(cp.Uy.numpy(), ref.Uy.numpy(), rtol=0, atol=1e-12)


def test_cli_deploy_sparsify_records_the_recommendation(saved, tmp_path, capsys):
    out = tmp_path / "sparsified.npz"
    rc = main(["deploy", str(saved), "--out", str(out), "--sparsify", "16"])
    assert rc == 0
    assert "deployed posterior: sparsified (M_y=16" in capsys.readouterr().out
    m = GPMDM.load(out, device="cpu")
    assert m._deploy_recommendation["family"] == "sparsified"
    assert (16, None) in m._sparsified_cache
    from gpmdm_tpu_torch.filter.particle_filter import resolve_posterior

    assert resolve_posterior(m, "auto") is m._sparsified_cache[(16, None)]


def test_cli_deploy_default_policy_small_model(saved, tmp_path, capsys):
    out = tmp_path / "d.npz"
    assert main(["deploy", str(saved), "--out", str(out)]) == 0
    assert "deployed posterior: Posterior" in capsys.readouterr().out
    assert GPMDM.load(out, device="cpu")._compressed_cache == {}


def test_cli_deploy_and_eval_exit_2_on_bad_flags(saved, tmp_path, capsys):
    sm = _small_model(SparseGPMDM, n_inducing_y=8, n_inducing_x=8)
    sparse_path = tmp_path / "s.npz"
    sm.save(sparse_path)
    cases = [
        (["deploy", str(sparse_path), "--rank-y", "8"], "exact family only"),
        (["deploy", str(sparse_path), "--sparsify", "8"], "exact family only"),
        (["deploy", str(saved), "--sparsify", "8", "--rank-y", "4"], "mutually exclusive"),
        (["deploy", str(saved), "--sparsify-x", "4"], "require --sparsify"),
        (["eval", str(saved), "--sparsify-method", "kmeans"], "require --sparsify"),
        (["eval", str(sparse_path), "--sparsify", "8"], "exact family only"),
    ]
    for argv, msg in cases:
        assert main(argv) == 2, argv
        assert msg in capsys.readouterr().out, argv


def test_cli_rollout_prints_the_trajectory(saved, capsys):
    assert main(["rollout", str(saved), "--cls", "1", "--steps", "5"]) == 0
    text = capsys.readouterr().out.strip()
    m = GPMDM.load(saved, device="cpu")
    want = m.rollout(m.get_X_for_class(1)[0].numpy(), 5, 1).numpy()
    assert text == str(want)


def test_cli_platform_pin(monkeypatch, saved, capsys):
    """An unknown pin is an error (exit 2); unset or 'gpu' means the card,
    and without one the command fails at once instead of running on the
    CPU."""
    monkeypatch.setenv("GPMDM_TPU_PLATFORM", "tpu")
    assert main(["rollout", str(saved), "--steps", "2"]) == 2
    assert "GPMDM_TPU_PLATFORM='tpu'" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    for value in ("gpu", None):
        if value is None:
            monkeypatch.delenv("GPMDM_TPU_PLATFORM")
        else:
            monkeypatch.setenv("GPMDM_TPU_PLATFORM", value)
        assert main(["rollout", str(saved), "--steps", "2"]) == 2
        captured = capsys.readouterr()
        assert "no CUDA card" in captured.err and captured.out == ""
