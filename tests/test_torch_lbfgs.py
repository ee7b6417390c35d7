"""The port's L-BFGS (``TrainConfig(optimizer='lbfgs')``, ``train.lbfgs``)
against the JAX trainer's ``optax.lbfgs``, on the CPU in float64, and its
state in checkpoints and train-state snapshots.

Small models of the synthetic task (C = 2 classes of 2 x 25 frames, Ny =
100, D = 8, d = 2): exact, exact with y_log_sigma_n frozen, sparse (My = Mx
= 8) and back-constrained.  Tolerances: over 5 steps, losses rtol 1e-8,
parameters and every optimizer-state leaf rtol 1e-7 (the same float64
algebra in another summation order; atol that rtol x the leaf's largest
magnitude, for entries near zero, as in test_torch_train.py), the line
search's step counts equal; a resumed or reloaded run against an
uninterrupted one in the same package rtol 1e-12; loaded leaves bit for
bit.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import threadpoolctl
import torch

from gpmdm_tpu import BCGPMDM as JBCGPMDM
from gpmdm_tpu import GPMDM as JGPMDM
from gpmdm_tpu import SparseGPMDM as JSparseGPMDM
from gpmdm_tpu.utils import checkpoint as jckpt
from gpmdm_tpu.utils import io as jio
from gpmdm_tpu_torch import BCGPMDM, GPMDM, SparseGPMDM, TrainConfig
from gpmdm_tpu_torch.data import synthetic
from gpmdm_tpu_torch.models import core
from gpmdm_tpu_torch.train import trainer
from gpmdm_tpu_torch.train.lbfgs import LBFGSState
from gpmdm_tpu_torch.utils import checkpoint as ckpt
from gpmdm_tpu_torch.utils import io as tio

ASSETS = Path(__file__).resolve().parents[1] / "bench_assets"
LOSS_RTOL, LEAF_RTOL, SAME_RTOL = 1e-8, 1e-7, 1e-12
STEPS = 5
TR, TL, _, _ = synthetic.make_dataset(n_classes=2, n_train_seqs=2, n_test_seqs=1, seq_len=25,
                                      D=8, seed=3)

FAMILIES = {
    "exact": ((JGPMDM, GPMDM), {}),
    "exact_frozen_y_sigma_n": ((JGPMDM, GPMDM), {"flg_train_y_sigma_n": False}),
    "sparse": ((JSparseGPMDM, SparseGPMDM), {"n_inducing_y": 8, "n_inducing_x": 8}),
    "bc": ((JBCGPMDM, BCGPMDM), {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS and OpenMP thread: these shapes are small, and idle pool
    threads spinning between calls would take cores from the suite's other
    workers."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _model(cls, **kw):
    """A float64 model on the small dataset, PCA-initialized."""
    extra = {"device": "cpu"} if cls.__module__.startswith("gpmdm_tpu_torch") else {}
    m = cls(D=8, d=2, n_classes=2, dtype="float64", y_sigma_n_init=0.1, x_sigma_n_init=0.1,
            **extra, **kw)
    for Y, c in zip(TR, TL):
        m.add_data(Y, c)
    m.init_X()
    return m


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rtol, msg=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=msg)


def _jax_lbfgs_start(jm):
    """Start the JAX model's L-BFGS from optax's initial state with its
    weakly typed line-search info made strong, as every later state is:
    one compile of the JAX step serves every call of this file."""
    jm._opt_state = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                                 optax.lbfgs(memory_size=10).init(_trained_params(jm)))
    jm._opt_name = "lbfgs"
    return jm


def _trained_params(m):
    """The leaves the optimizer trains: W in the X slot for the
    back-constrained model."""
    if hasattr(m, "_W"):
        return dataclasses.replace(m.params, X=m._W)
    return m.params


def _assert_state(tstate, jleaves, rtol):
    """The port's L-BFGS state against optax's leaves (or a file's)."""
    tleaves = tstate.to_numpy()
    assert len(tleaves) == len(jleaves)
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        assert a.shape == np.shape(b), i
        if np.issubdtype(np.asarray(b).dtype, np.integer):
            assert a.dtype == np.int32 and int(a) == int(b), i
        elif rtol == 0:
            np.testing.assert_array_equal(a, b, err_msg=f"opt leaf {i}")
        else:
            _close(a, b, rtol, f"opt leaf {i}")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lbfgs_matches_optax_through_the_jax_trainer(family):
    """Five one-step ``train_lbfgs`` calls in each package from the same
    initialization: after every step the loss, the parameters, every one of
    the 47 (57 for the sparse family) state leaves and the line search's
    step count agree."""
    (jcls, tcls), kw = FAMILIES[family]
    jm, tm = _jax_lbfgs_start(_model(jcls, **kw)), _model(tcls, **kw)
    n_leaves = 57 if family == "sparse" else 47
    counts = []
    for _ in range(STEPS):
        jl, tl = jm.train_lbfgs(1), tm.train_lbfgs(1)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        jp, tp = _trained_params(jm), _trained_params(tm)
        for f in dataclasses.fields(jp):
            _close(getattr(tp, f.name), getattr(jp, f.name), LEAF_RTOL, f.name)
        jleaves = [np.asarray(x) for x in jax.tree.leaves(jm._opt_state)]
        assert len(jleaves) == n_leaves
        _assert_state(tm._opt_state, jleaves, LEAF_RTOL)
        counts.append(int(tm._opt_state.num_linesearch_steps))
    assert int(tm._opt_state.count) == STEPS
    assert tm._opt_name == "lbfgs" and tm._lbfgs_memory == 10
    if family == "exact_frozen_y_sigma_n":
        np.testing.assert_array_equal(_np(tm.params.y_log_sigma_n),
                                      _np(_model(tcls, **kw).params.y_log_sigma_n))
    if family == "exact":
        assert max(counts) > 1  # the zoom ran: the interval search and the interpolation


def _poisoned(kind):
    """The exact loss plus a NaN (on the loss, or on X's gradient only)."""
    def loss(p, Y, cfg, layout, balance):
        base = core.nll(p, Y, cfg, layout, balance)
        if kind == "loss_nan":
            return base + torch.log(p.y_log_sigma_n * 0 - 1.0)
        x = p.X.reshape(-1)[0]
        return base + torch.where(x > 1e30, torch.sqrt(x - x - 1.0), 0.0)
    return loss


@pytest.mark.parametrize("kind", ["loss_nan", "grad_nan"])
def test_nan_freeze_keeps_every_leaf(kind):
    """Two plain steps, then one whose loss or gradient is not finite: the
    parameters and all 47 leaves of the state stay as they were, and the
    step's loss is returned."""
    m = _model(GPMDM)
    mask = trainer.trainable_mask(m.config)
    plain = trainer.make_lbfgs_step(m.config, m.layout, 1.0, mask)
    poison = trainer.make_lbfgs_step(m.config, m.layout, 1.0, mask, loss_fn=_poisoned(kind))
    Y = torch.as_tensor(m.get_Y())
    p, s = m.params, LBFGSState.init(m.params)
    for _ in range(2):
        p, s, _ = plain(p, s, Y)
    p2, s2, loss = poison(p, s, Y)
    assert np.isfinite(float(loss)) == (kind == "grad_nan")
    for f in core.PARAM_FIELDS:
        assert torch.equal(getattr(p2, f), getattr(p, f)), f
    assert all(np.array_equal(a, b) for a, b in zip(s2.to_numpy(), s.to_numpy()))
    assert int(s2.count) == 2


def test_wrong_state_raises_and_lr_is_ignored():
    """A state of the other optimizer, of another parameter class or of
    another memory raises ValueError, as the JAX trainer's does; L-BFGS
    ignores ``lr``."""
    m, sm = _model(GPMDM), _model(SparseGPMDM, n_inducing_y=8, n_inducing_x=8)
    Y = m.get_Y()
    lb = TrainConfig(num_steps=2, optimizer="lbfgs")
    adam = trainer.train_adam(m.params, Y, m.config, m.layout, TrainConfig(num_steps=1))
    with pytest.raises(ValueError):
        trainer.train_adam(m.params, Y, m.config, m.layout, lb, opt_state=adam.opt_state)
    res = trainer.train_adam(m.params, Y, m.config, m.layout, lb)
    with pytest.raises(ValueError):
        trainer.train_adam(m.params, Y, m.config, m.layout, TrainConfig(num_steps=1),
                           opt_state=res.opt_state)
    with pytest.raises(ValueError):
        trainer.train_adam(m.params, Y, m.config, m.layout,
                           dataclasses.replace(lb, lbfgs_memory=5), opt_state=res.opt_state)
    sres = trainer.train_adam(sm.params, Y, sm.config, sm.layout, lb,
                              objective=trainer.sparse_objective)
    with pytest.raises(ValueError):
        trainer.train_adam(m.params, Y, m.config, m.layout, lb, opt_state=sres.opt_state)
    with pytest.raises(ValueError):
        trainer.train_adam(m.params, Y, m.config, m.layout, TrainConfig(optimizer="sgd"))
    big_lr = trainer.train_adam(m.params, Y, m.config, m.layout,
                                dataclasses.replace(lb, lr=123.0))
    assert torch.equal(big_lr.losses, res.losses)
    assert res.loss_evals >= 2 and res.host_reads >= res.loss_evals


@pytest.mark.parametrize("backend", ["npz", "orbax_names"])
def test_snapshot_resume_equals_uninterrupted_run(tmp_path, backend):
    """4 steps, a snapshot (written by the trainer's ``checkpoint_every``, or
    through the names of the JAX package's orbax pair), 3 more from the
    snapshot: the same trajectory as 3 more from the state in memory.  The
    snapshot also loads in the JAX package with an ``optax.lbfgs``
    template, with the same leaves."""
    m = _model(GPMDM)
    Y = m.get_Y()
    path = tmp_path / "state.npz"
    tc = TrainConfig(num_steps=4, optimizer="lbfgs", checkpoint_every=4,
                     checkpoint_path=str(path) if backend == "npz" else None)
    res = trainer.train_adam(m.params, Y, m.config, m.layout, tc)
    load = ckpt.load_train_state if backend == "npz" else ckpt.load_train_state_orbax
    if backend == "orbax_names":  # a second save replaces the first whole
        for _ in range(2):
            ckpt.save_train_state_orbax(path, res.params, res.opt_state, 4, res.losses)
        assert sorted(p.name for p in tmp_path.iterdir()) == ["state.npz"]
    params, opt, step, losses = load(path, m.params)
    assert step == 4 and isinstance(opt, LBFGSState)
    np.testing.assert_array_equal(losses, _np(res.losses))
    _assert_state(opt, res.opt_state.to_numpy(), 0)
    more = TrainConfig(num_steps=3, optimizer="lbfgs")
    cont = trainer.train_adam(res.params, Y, m.config, m.layout, more, opt_state=res.opt_state)
    resumed = trainer.train_adam(params, Y, m.config, m.layout, more, opt_state=opt)
    np.testing.assert_allclose(_np(resumed.losses), _np(cont.losses), rtol=SAME_RTOL)
    for f in core.PARAM_FIELDS:
        _close(getattr(resumed.params, f), getattr(cont.params, f), SAME_RTOL, f)
    jm = _model(JGPMDM)
    jp, jo, jstep, _ = jckpt.load_train_state(
        path, jm.params, optax.lbfgs(memory_size=10).init(jm.params))
    assert jstep == 4
    _assert_state(opt, [np.asarray(x) for x in jax.tree.leaves(jo)], 0)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_carries_lbfgs_state_across_packages(tmp_path, direction):
    """3 L-BFGS steps in one package, save, load in the other (the
    optimizer's name, its memory and the 47 leaves kept) and 2 more steps:
    the same losses and parameters as the first package's own 2 more (one
    step a call, the calls of the first test)."""
    path = tmp_path / "model.npz"
    src = (_jax_lbfgs_start(_model(JGPMDM)) if direction == "jax_to_port"
           else _model(GPMDM))
    for _ in range(3):
        src.train_lbfgs(1)
    src.save(path)
    meta = json.loads(bytes(np.load(path)["meta_json"]).decode())
    assert meta["optimizer_name"] == "lbfgs" and meta["lbfgs_memory"] == 10
    assert meta["n_opt_leaves"] == 47
    if direction == "jax_to_port":
        dst = GPMDM.load(path, device="cpu")
        _assert_state(dst._opt_state, [np.asarray(x) for x in jax.tree.leaves(src._opt_state)],
                      0)
    else:
        dst = jio.load_model(JGPMDM, path)
        _assert_state(src._opt_state, [np.asarray(x) for x in jax.tree.leaves(dst._opt_state)],
                      0)
        assert np.asarray(jax.tree.leaves(dst._opt_state)[0]).dtype == np.int32
    for _ in range(2):
        np.testing.assert_allclose(dst.train_lbfgs(1), src.train_lbfgs(1), rtol=LOSS_RTOL)
    for f in core.PARAM_FIELDS:
        _close(getattr(dst.params, f), getattr(src.params, f), LEAF_RTOL, f)


def test_hourlongh_lbfgs_state_survives_load_save_load(tmp_path):
    """C9: bench_model_hourlongh.npz's optax L-BFGS state (57 leaves,
    memory 10) is read into the port bit for bit, and a save and a second
    load keep it so, with its optimizer's name and memory."""
    src = ASSETS / "bench_model_hourlongh.npz"
    with np.load(src) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        leaves = [z[f"opt_{i}"] for i in range(meta["n_opt_leaves"])]
    assert meta["optimizer_name"] == "lbfgs" and len(leaves) == 57
    m = tio.load_model(src, "cpu")
    assert isinstance(m._opt_state, LBFGSState) and m._opt_state.memory_size == 10
    _assert_state(m._opt_state, leaves, 0)
    out = tmp_path / "hourlongh.npz"
    m.save(out)
    with np.load(out) as z:
        meta2 = json.loads(bytes(z["meta_json"]).decode())
        for i, leaf in enumerate(leaves):
            assert z[f"opt_{i}"].dtype == leaf.dtype, i
            np.testing.assert_array_equal(z[f"opt_{i}"], leaf, err_msg=f"opt_{i}")
    assert (meta2["optimizer_name"], meta2["lbfgs_memory"], meta2["n_opt_leaves"]) == (
        "lbfgs", 10, 57)
    again = tio.load_model(out, "cpu")
    _assert_state(again._opt_state, leaves, 0)


def test_load_model_takes_both_call_forms(tmp_path):
    """C4: ``load_model(file_path, device)`` and the JAX package's
    ``load_model(cls, file_path)`` with ``device=``: the checkpoint's own
    class either way."""
    m = _model(SparseGPMDM, n_inducing_y=8, n_inducing_x=8)
    path = tmp_path / "sparse.npz"
    m.save(path)
    for loaded in (tio.load_model(path, "cpu"), tio.load_model(path, device="cpu"),
                   tio.load_model(GPMDM, path, device="cpu")):
        assert type(loaded) is SparseGPMDM
        for f in dataclasses.fields(m.params):
            assert torch.equal(getattr(loaded.params, f.name), getattr(m.params, f.name))
    with pytest.raises(TypeError):
        tio.load_model()
    # the JAX package's own call, for comparison: the same class rule
    assert type(jio.load_model(JGPMDM, path)).__name__ == "SparseGPMDM"
