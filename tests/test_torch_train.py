"""The port's trainer, train-state checkpoints, model I/O and prediction
helpers against the JAX package, on the CPU in float64.

Mirrors tests/test_train.py and the checkpoint and logger tests of
tests/test_utils.py.  Tolerances: Adam against ``optax.adam`` through the
JAX trainer, losses, parameters and Adam state rtol 1e-8 over 25 steps (the
same float64 algebra in a different order; atol that rtol x the leaf's
largest magnitude, for entries near zero); a resumed or reloaded run
against an uninterrupted one in the same package rtol 1e-12; predictions
rtol 1e-10 (one float64 posterior, the same algebra); NMSE on the training
points rtol 1e-6 (their variance is the cancellation 1 - quad, of the
order of sigma_n^2, which leaves float64 about 8 digits).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import threadpoolctl
import torch

from gpmdm_tpu import GPMDM as JGPMDM
from gpmdm_tpu.models import core as jcore
from gpmdm_tpu.train import trainer as jtrainer
from gpmdm_tpu.utils import checkpoint as jckpt
from gpmdm_tpu_torch import GPMDM, GPMDM_PF, TrainConfig
from gpmdm_tpu_torch.data import synthetic
from gpmdm_tpu_torch.models import core
from gpmdm_tpu_torch.train import trainer
from gpmdm_tpu_torch.utils import checkpoint as ckpt
from gpmdm_tpu_torch.utils.logging import MetricLogger
from gpmdm_tpu_torch.utils.metrics import evaluate_pf

FIELDS = core.PARAM_FIELDS
ADAM_RTOL, SAME_RTOL, PRED_RTOL, NMSE_RTOL = 1e-8, 1e-12, 1e-10, 1e-6
TR, TL, TE, TEL = synthetic.make_dataset(n_classes=2, n_train_seqs=2, n_test_seqs=2,
                                         seq_len=25, D=8, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS and OpenMP thread: these shapes are small, and idle pool
    threads spinning between calls would take cores from the suite's other
    workers (this file's CPU time falls by a factor of 2-5)."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _model(cls, **kw):
    """A float64 model on the small dataset, PCA-initialized."""
    extra = {} if cls is JGPMDM else {"device": "cpu"}
    m = cls(D=8, d=2, n_classes=2, dtype="float64", **extra, **kw)
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


def _assert_params(tparams, jparams, rtol):
    for f in FIELDS:
        _close(getattr(tparams, f), getattr(jparams, f), rtol, f)


def _assert_adam_state(tstate, jstate, rtol):
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    tleaves = tstate.to_numpy()
    assert len(tleaves) == len(jleaves) == 1 + 2 * len(FIELDS)
    assert int(tleaves[0]) == int(jleaves[0])
    for i, (a, b) in enumerate(zip(tleaves[1:], jleaves[1:])):
        _close(a, b, rtol, f"opt leaf {i + 1}")


# ------------------------------------------------------------------- masks


@pytest.mark.parametrize("mode", ["all", "latent", "dynamics"])
def test_trainable_mask_matches_jax(mode):
    kw = dict(flg_train_y_sigma_n=False, flg_train_x_lin_coeff=False)
    jm, tm = _model(JGPMDM, **kw), _model(GPMDM, **kw)
    jmask, tmask = jtrainer.trainable_mask(jm.config, mode), trainer.trainable_mask(tm.config, mode)
    for f in FIELDS:
        assert float(getattr(tmask, f)) == float(getattr(jmask, f)), f
    with pytest.raises(ValueError):
        trainer.trainable_mask(tm.config, "bogus")


def test_flags_and_training_mode_freeze_leaves():
    m = _model(GPMDM, flg_train_y_sigma_n=False)
    before = m.params.y_log_sigma_n.clone()
    m.train_adam(num_opt_steps=10, lr=0.05)
    assert torch.equal(m.params.y_log_sigma_n, before)
    m = _model(GPMDM)
    m.set_training_mode("latent")
    x_ls, y_ls = m.params.x_log_lengthscales.clone(), m.params.y_log_lengthscales.clone()
    m.train_adam(num_opt_steps=10, lr=0.05)
    assert torch.equal(m.params.x_log_lengthscales, x_ls)
    assert not torch.equal(m.params.y_log_lengthscales, y_ls)
    with pytest.raises(ValueError):
        m.set_training_mode("bogus")


# -------------------------------------------------------------------- Adam


@pytest.mark.parametrize("mode", ["all", "latent"])
def test_adam_matches_optax_through_the_jax_trainer(mode):
    """25 steps of the port's Adam against ``optax.adam`` in the JAX
    trainer from the same initialization: losses, parameters and the Adam
    state (count, mu, nu)."""
    jm, tm = _model(JGPMDM), _model(GPMDM)
    np.testing.assert_allclose(tm.gpdm_loss(), jm.gpdm_loss(), rtol=1e-10)
    tc = dict(num_steps=25, lr=0.01, print_every=10)
    jres = jtrainer.train_adam(jm.params, jm.get_Y(), jm.config, jm.layout,
                               jtrainer.TrainConfig(**tc), mode=mode)
    tres = trainer.train_adam(tm.params, tm.get_Y(), tm.config, tm.layout, TrainConfig(**tc),
                              mode=mode)
    assert tres.losses.shape == (25,)
    np.testing.assert_allclose(_np(tres.losses), np.asarray(jres.losses), rtol=ADAM_RTOL)
    _assert_params(tres.params, jres.params, ADAM_RTOL)
    _assert_adam_state(tres.opt_state, jres.opt_state, ADAM_RTOL)


def _loss_nan(mod):
    def loss(p, Y, cfg, layout, balance):
        log = jnp.log if mod is jcore else torch.log
        return mod.nll(p, Y, cfg, layout, balance) + log(p.y_log_sigma_n * 0 - 1.0)
    return loss


def _grad_nan(field):
    def make(mod):
        def loss(p, Y, cfg, layout, balance):
            x = getattr(p, field).reshape(-1)[0]
            if mod is jcore:
                trap = jnp.where(x > 1e30, jnp.sqrt(x - x - 1.0), 0.0)
            else:
                trap = torch.where(x > 1e30, torch.sqrt(x - x - 1.0), 0.0)
            return mod.nll(p, Y, cfg, layout, balance) + trap
        return loss
    return make


FREEZES = {
    "loss_nan": (_loss_nan, {}, True),
    "grad_nan": (_grad_nan("X"), {}, True),
    "grad_nan_on_frozen_leaf": (_grad_nan("x_log_lin_coeff"),
                                {"flg_train_x_lin_coeff": False}, False),
}


@pytest.mark.parametrize("case", sorted(FREEZES))
def test_finite_step_freeze_matches_jax(case):
    """Three plain steps, then one whose loss or gradient is not finite.
    A NaN loss or a NaN gradient on a trained leaf keeps the parameters
    and the whole Adam state (moments and count) exactly; a NaN gradient
    on a frozen leaf does not veto the step.  Both packages end in the
    same state."""
    make_loss, kw, frozen = FREEZES[case]
    jm, tm = _model(JGPMDM, **kw), _model(GPMDM, **kw)
    jopt = optax.adam(0.01)
    jmask = jtrainer.trainable_mask(jm.config)
    jplain = jax.jit(jtrainer.make_update_step(jm.config, jm.layout, jopt, 1.0, jmask))
    jpoison = jax.jit(jtrainer.make_update_step(jm.config, jm.layout, jopt, 1.0, jmask,
                                                loss_fn=make_loss(jcore)))
    tmask = trainer.trainable_mask(tm.config)
    tplain = trainer.make_update_step(tm.config, tm.layout, 0.01, 1.0, tmask)
    tpoison = trainer.make_update_step(tm.config, tm.layout, 0.01, 1.0, tmask,
                                       loss_fn=make_loss(core))
    jY, tY = jnp.asarray(jm.get_Y()), torch.as_tensor(tm.get_Y())
    jcarry = (jm.params, jopt.init(jm.params), jY)
    tp, ts = tm.params, trainer.AdamState.init(tm.params)
    for _ in range(3):
        jcarry, _ = jplain(jcarry, None)
        tp, ts, _ = tplain(tp, ts, tY)
    (jp, jstate, _), jloss = jpoison(jcarry, None)
    tp2, ts2, tloss = tpoison(tp, ts, tY)

    assert np.isfinite(float(tloss)) == np.isfinite(float(jloss)) == (case != "loss_nan")
    _assert_params(tp2, jp, ADAM_RTOL)
    _assert_adam_state(ts2, jstate, ADAM_RTOL)
    if frozen:
        assert all(torch.equal(getattr(tp2, f), getattr(tp, f)) for f in FIELDS)
        assert all(np.array_equal(a, b) for a, b in zip(ts2.to_numpy(), ts.to_numpy()))
    else:
        assert torch.equal(tp2.x_log_lin_coeff, tp.x_log_lin_coeff)
        assert not torch.equal(tp2.X, tp.X) and torch.isfinite(tp2.X).all()
        assert int(ts2.count) == 4


def test_divergent_lr_freezes_and_stops():
    """A divergent learning rate leaves every parameter finite, and the run
    stops at the chunk whose last loss is not finite."""
    m = _model(GPMDM)
    res = trainer.train_adam(m.params, m.get_Y(), m.config, m.layout,
                             TrainConfig(num_steps=20, lr=1e9, print_every=5))
    assert not torch.isfinite(res.losses).all()
    assert res.losses.shape[0] < 20 and res.losses.shape[0] % 5 == 0
    assert all(torch.isfinite(getattr(res.params, f)).all() for f in FIELDS)


def test_unported_optimizer_raises():
    """'adam' and 'lbfgs' are the optimizers (tests/test_torch_lbfgs.py);
    any other name raises ValueError, as in the JAX trainer."""
    m = _model(GPMDM)
    with pytest.raises(ValueError, match="unknown optimizer"):
        m.train_adam(num_opt_steps=2, optimizer="sgd")


# ------------------------------------------------------ resume / checkpoints


def test_resume_equals_uninterrupted_run():
    a, b = _model(GPMDM), _model(GPMDM)
    la = a.train_adam(num_opt_steps=10, lr=0.01) + a.train_adam(num_opt_steps=10, lr=0.01)
    lb = b.train_adam(num_opt_steps=20, lr=0.01)
    np.testing.assert_allclose(la, lb, rtol=SAME_RTOL)
    _assert_params(a.params, b.params, SAME_RTOL)
    np.testing.assert_array_equal(a.posterior.X.numpy(), a.params.X.numpy())


def test_checkpoint_every_resume_matches_uninterrupted(tmp_path):
    """Train 10 steps with a snapshot every 5; resume from it for 5 more and
    land where one 15-step run lands.  The snapshot also loads in the JAX
    package, with the same leaves."""
    m = _model(GPMDM)
    path = tmp_path / "train_state.npz"
    tc = TrainConfig(num_steps=10, lr=0.01, checkpoint_every=5, checkpoint_path=str(path))
    full = trainer.train_adam(m.params, m.get_Y(), m.config, m.layout, tc)
    params, opt, step, losses = ckpt.load_train_state(path, m.params)
    assert step == 10
    _assert_params(params, full.params, SAME_RTOL)
    np.testing.assert_array_equal(losses, _np(full.losses))
    resumed = trainer.train_adam(params, m.get_Y(), m.config, m.layout,
                                 TrainConfig(num_steps=5, lr=0.01), opt_state=opt)
    run15 = trainer.train_adam(m.params, m.get_Y(), m.config, m.layout,
                               TrainConfig(num_steps=15, lr=0.01))
    _assert_params(resumed.params, run15.params, SAME_RTOL)

    jm = _model(JGPMDM)
    jp, jo, jstep, _ = jckpt.load_train_state(path, jm.params, optax.adam(0.01).init(jm.params))
    assert jstep == 10
    _assert_params(params, jp, 0.0)
    _assert_adam_state(opt, jo, 0.0)


def test_checkpoint_cadence_with_misaligned_chunks(tmp_path):
    """A snapshot is written whenever a checkpoint boundary is crossed
    inside a chunk (print_every 30, checkpoint_every 50: at step 60)."""
    m = _model(GPMDM)
    path = tmp_path / "ck.npz"
    tc = TrainConfig(num_steps=90, lr=0.01, print_every=30, checkpoint_every=50,
                     checkpoint_path=str(path))
    trainer.train_adam(m.params, m.get_Y(), m.config, m.layout, tc)
    assert ckpt.load_train_state(path, m.params)[2] == 60


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_carries_adam_state_across_packages(tmp_path, direction):
    """10 steps in one package, save, load in the other and train 5 more:
    the same losses and parameters as the first package's own 5 more."""
    path = tmp_path / "model.npz"
    src = _model(JGPMDM if direction == "jax_to_port" else GPMDM)
    src.train_adam(num_opt_steps=10, lr=0.01)
    src.save(path)
    meta = json.loads(bytes(np.load(path)["meta_json"]).decode())
    assert meta["has_opt_state"] and meta["n_opt_leaves"] == 17
    dst = (GPMDM.load(path, device="cpu") if direction == "jax_to_port"
           else JGPMDM.load(path))
    _assert_params(dst.params, src.params, 0.0)
    if direction == "jax_to_port":
        _assert_adam_state(dst._opt_state, src._opt_state, 0.0)
    else:
        _assert_adam_state(src._opt_state, dst._opt_state, 0.0)
    assert dst.config.to_dict() == src.config.to_dict()
    np.testing.assert_allclose(dst.train_adam(num_opt_steps=5, lr=0.01),
                               src.train_adam(num_opt_steps=5, lr=0.01), rtol=ADAM_RTOL)
    _assert_params(dst.params, src.params, ADAM_RTOL)


def test_save_load_keeps_path_config_and_init_hypers(tmp_path):
    """save('x.ckpt') writes exactly there; a config field the constructor
    does not take (class_jitter) and the initial hyperparameters survive."""
    m = _model(GPMDM, y_sigma_n_init=0.1, hyperprior_weight=3.0)
    m.config = m.config.replace(class_jitter=3e-5)
    path = tmp_path / "model.ckpt"
    m.save(path)
    assert path.exists() and not (tmp_path / "model.ckpt.npz").exists()
    m2 = GPMDM.load(path, device="cpu")
    assert m2.config == m.config
    assert m2._init_hypers["y_sigma_n_init"] == 0.1
    assert m2._opt_state is None
    _assert_params(m2.params, m.params, 0.0)


def test_loaded_tensors_are_c_contiguous_and_keep_their_shapes():
    """The committed asset stores X in Fortran order; every tensor a load
    makes (parameters, Adam state, posterior) is C-contiguous, as the CUDA
    kernels require, and 0-d parameters stay 0-d."""
    import dataclasses
    from pathlib import Path

    asset = Path(__file__).resolve().parents[1] / "bench_assets" / "bench_model.npz"
    assert np.load(asset)["param_X"].flags["F_CONTIGUOUS"]
    m = GPMDM.load(asset, device="cpu")
    for f in dataclasses.fields(core.Posterior):
        assert getattr(m.posterior, f.name).is_contiguous(), f.name
    for f in FIELDS:
        assert getattr(m.params, f).is_contiguous(), f
    assert m.params.y_log_sigma_n.shape == () and m.params.x_log_sigma_n.shape == ()
    assert m._opt_state is not None
    assert all(t.is_contiguous() for t in trainer._leaves(m._opt_state.mu))
    assert m._opt_state.mu.y_log_sigma_n.shape == ()


def test_load_torch_model_matches_jax(tmp_path):
    from test_io_torch import _make_reference_checkpoint

    path = tmp_path / "ref.pth"
    _make_reference_checkpoint(path)
    jm, tm = JGPMDM.load_torch(path), GPMDM.load_torch(path, device="cpu")
    assert tm.config.to_dict() == jm.config.to_dict()
    _assert_params(tm.params, jm.params, 0.0)
    for f in ("Ky_inv", "Ay", "Kxc_inv", "Axc"):
        np.testing.assert_allclose(_np(getattr(tm.posterior, f)),
                                   _np(getattr(jm.posterior, f)), rtol=PRED_RTOL, atol=1e-12)
    np.testing.assert_allclose(tm.gpdm_loss(), jm.gpdm_loss(), rtol=PRED_RTOL)


# ------------------------------------------------------------------ logging


def test_metric_logger_records_training_and_evaluation(tmp_path):
    m = _model(GPMDM)
    path = tmp_path / "train.jsonl"
    logger = MetricLogger(stream=None, jsonl_path=str(path))
    m.train_adam(num_opt_steps=6, num_print_steps=2, lr=0.01, logger=logger)
    steps, losses = logger.series("loss")
    assert list(steps) == [2, 4, 6] and losses[-1] < losses[0]
    assert logger.last("steps_per_sec") > 0
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(records) == 3 and "loss" in records[0]

    flt = GPMDM_PF(m, [[0.9, 0.1], [0.1, 0.9]], num_particles=32, seed=0)
    logger = MetricLogger(stream=None)
    report = evaluate_pf(flt, TE, TEL, n_classes=2, logger=logger)
    assert len(logger.history["trial_frame_acc"]) == len(TE)
    assert logger.last("fps") > 0
    assert logger.last("frame_acc") == report.frame_metrics["accuracy"]


# -------------------------------------------------------------- prediction


@pytest.mark.parametrize("back_step,target", [(1, "full"), (2, "delta")])
def test_prediction_helpers_match_jax(back_step, target):
    """map_x_*, get_next_x (injected noise), rollout (sample=False) and the
    NMSE helpers on one trained state in both packages."""
    kw = dict(dyn_back_step=back_step, dyn_target=target)
    jm = _model(JGPMDM, **kw)
    jm.train_adam(num_opt_steps=5, lr=0.01)
    tm = _model(GPMDM, **kw)
    tm.set_params({f: np.asarray(getattr(jm.params, f)) for f in FIELDS})
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(7, 2 * back_step))
    pairs = [(tm.map_x_to_y(xs[:, :2], True), jm.map_x_to_y(xs[:, :2], True)),
             (tm.map_x_dynamics(xs), jm.map_x_dynamics(xs)),
             (tm.map_x_dynamics_for_class(xs, 1), jm.map_x_dynamics_for_class(xs, 1))]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), rtol=PRED_RTOL, atol=1e-12)

    mean, var = jm.map_x_dynamics_for_class(xs, 0)
    key = jax.random.PRNGKey(4)
    want = jm.get_next_x(mean, var, xs[:, :2], flg_sample=True, key=key)
    noise = jax.random.normal(key, mean.shape, dtype=mean.dtype)
    got = core.next_x(torch.tensor(np.asarray(mean)), torch.tensor(np.asarray(var)),
                      torch.as_tensor(xs[:, :2]), tm.config, sample=True,
                      noise=torch.tensor(np.asarray(noise)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=PRED_RTOL)

    x0 = _np(jm.params.X)[3] if back_step == 1 else _np(jm.params.X)[[3, 2]]
    np.testing.assert_allclose(_np(tm.rollout(x0, 6, 1)), _np(jm.rollout(x0, 6, 1)),
                               rtol=PRED_RTOL, atol=1e-12)
    for c in range(2):
        np.testing.assert_allclose(tm.get_latent_map_performance_for_class(c)[3],
                                   jm.get_latent_map_performance_for_class(c)[3],
                                   rtol=NMSE_RTOL)
        np.testing.assert_allclose(tm.get_dynamics_map_performance_for_class(c)[4],
                                   jm.get_dynamics_map_performance_for_class(c)[4],
                                   rtol=NMSE_RTOL)
    np.testing.assert_allclose(
        _np(core.latent_map_nmse(tm.posterior, tm.params, tm.config, tm.params.X,
                                 torch.as_tensor(tm.get_Y()))),
        _np(jcore.latent_map_nmse(jm.posterior, jm.params, jm.config, jm.params.X,
                                  jnp.asarray(jm.get_Y()))), rtol=NMSE_RTOL)
    np.testing.assert_allclose(tm.get_y_neg_log_likelihood(), jm.get_y_neg_log_likelihood(),
                               rtol=PRED_RTOL)
    np.testing.assert_allclose(tm.get_x_neg_log_likelihood(), jm.get_x_neg_log_likelihood(),
                               rtol=PRED_RTOL)
    np.testing.assert_array_equal(tm.get_M(), jm.get_M())
    for a, b in zip(tm.get_latent_sequences(), jm.get_latent_sequences()):
        np.testing.assert_array_equal(a, b)
