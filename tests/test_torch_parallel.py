"""The port's distribution layer (gpmdm_tpu_torch.parallel) against the JAX
package's, on 4 gloo ranks on the CPU, in float64.

One group of 4 ranks runs every check of this file once
(``tests/torch_dist_ranks.parallel_checks``, through ``parallel.launch``
with a 60 s wall limit); the parent computes the JAX side and compares.
The model is tests/test_parallel.py's synthetic one: C = 3, D = 9, d = 2,
Ny = 120, so D pads to 12 at tp = 4, C to 4 at ep = 4 (and at ep = 2),
and n_max = 38 pads to 40 over 4 prediction ranks.

- The MAP loss of both forms (replicated Cholesky; ``shard_chol``, the
  distributed Cholesky) on the meshes (ep, tp) = (2, 2), (4, 1), (1, 4),
  without and with the log-hyperprior: the loss against ``core.nll`` to
  1e-10 relative, every gradient leaf against ``jax.grad`` to 1e-8
  relative (atol 1e-10).  A replicated term summed by a differentiable
  all-reduce would count its gradient |tp| or |ep| times over; these
  tolerances see that.
- 5 steps of ``train_adam_sharded``, both forms, against JAX's
  ``train_adam``: losses to 1e-9, X to rtol 1e-7 and atol 1e-9
  (tests/test_parallel.py's); the back-constrained model through
  ``latent_map`` the same way.
- Both row-sharded predictions against JAX's ``core.predict_y`` /
  ``predict_x_all_classes``.
- The sharded bank scans, masked and not, on JAX's states with JAX's own
  draws injected (the port's plain kernel versions): equal to the port's
  unsharded scans to rtol 1e-10 (the same arithmetic over differently
  shaped batches), and against JAX's sharded scans on a 4-device dp mesh
  the same most likely class and class probabilities within 1e-6 on every
  valid frame (the dynamics variance kdiag - quad cancels, which leaves
  ~1e-8 between the two packages' summation orders here even in float64:
  tests/test_torch_pf.py); ``evaluate_pf_banked(mesh=...)`` on 6 trials
  padded to 8 equal to the unsharded port's for the same seed.
- The collectives of one training step of each form on each mesh, of the
  bank scan (none), the gather, the predictions and the sharded
  evaluation are pinned.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from gpmdm_tpu import GPMDM, BCGPMDM
from gpmdm_tpu.config import PFConfig as JPFConfig
from gpmdm_tpu.config import TrainConfig as JTrainConfig
from gpmdm_tpu.data import synthetic
from gpmdm_tpu.filter import particle_filter as jpf
from gpmdm_tpu.models import core as jcore
from gpmdm_tpu.ops.layout import padded_class_indices as j_padded_class_indices
from gpmdm_tpu.parallel import make_mesh as j_make_mesh
from gpmdm_tpu.parallel import make_train_mesh as j_make_train_mesh
from gpmdm_tpu.parallel import pf_scan_bank_sharded as j_scan_bank_sharded
from gpmdm_tpu.parallel import pf_scan_bank_sharded_masked as j_scan_bank_sharded_masked
from gpmdm_tpu.train.trainer import train_adam as j_train_adam
from gpmdm_tpu_torch import parallel as par
from gpmdm_tpu_torch.models import core as tcore
from gpmdm_tpu_torch.ops import layout as tlayout
from gpmdm_tpu_torch.parallel import mesh as tmesh

FIELDS = tcore.PARAM_FIELDS
WALL_LIMIT_S = 60
LOSS_CFGS = {
    "plain": {},
    "hyperprior": {"hyperprior_weight": 37.0},
    "hyperprior_groups": {"hyperprior_weights": (1.0, 2.0, 300.0, 4.0, 5.0, 600.0, 7.0)},
}
BANKS, BANK_FRAMES, BANK_PARTICLES = 8, 8, 16


def _spec_of(m) -> dict:
    return {"cfg": m.config.to_dict(), "lengths": list(m.layout.seq_lengths),
            "classes": list(m.layout.seq_classes),
            "params": {f: np.asarray(getattr(m.params, f), np.float64) for f in FIELDS},
            "Y": np.asarray(m.get_Y(), np.float64)}


def _jax_model():
    train_seqs, train_labels, test_seqs, test_labels = synthetic.make_dataset(
        n_classes=3, n_train_seqs=2, n_test_seqs=2, seq_len=20, D=9, seed=11)
    m = GPMDM(D=9, d=2, n_classes=3, dtype="float64")
    for Y, c in zip(train_seqs, train_labels):
        m.add_data(Y, c)
    m.init_X()
    return m, [np.asarray(s) for s in test_seqs], list(test_labels)


def _jax_bc_model():
    train_seqs, train_labels, _, _ = synthetic.make_dataset(
        n_classes=2, n_train_seqs=2, n_test_seqs=1, seq_len=20, D=9, seed=12)
    m = BCGPMDM(D=9, d=2, n_classes=2, dtype="float64")
    for Y, c in zip(train_seqs, train_labels):
        m.add_data(Y, c)
    m.init_X()
    return m


def _jax_banks(m):
    """Bank states, JAX's own draws of every bank and frame, the padded
    observations and their prefix masks (tests/test_parallel.py's)."""
    pfc = JPFConfig(num_particles=BANK_PARTICLES)
    states = jpf.pf_init_bank(m.posterior, m.layout.y_class_offsets, jax.random.PRNGKey(1),
                              pfc, BANKS)
    draws = [jpf._pregen_noise(k, BANK_FRAMES, BANK_PARTICLES, 2, jnp.float64, jnp.float64)
             for k in states.key]
    u_res = [[jax.random.uniform(k, (), dtype=jnp.float64) for k in nz.k_res] for nz in draws]
    noise = {"u_trans": np.stack([np.asarray(nz.u_trans) for nz in draws], axis=1),
             "eps_dyn": np.stack([np.asarray(nz.eps_dyn) for nz in draws], axis=1),
             "u_res": np.asarray(u_res).T}
    lens = [3 + (b % 5) for b in range(BANKS)]
    Z = np.zeros((BANKS, BANK_FRAMES, 9))
    valid = np.zeros((BANKS, BANK_FRAMES), dtype=bool)
    for b in range(BANKS):
        Z[b, :lens[b]] = np.asarray(synthetic.make_cycle(lens[b], b % 3, 9))
        valid[b, :lens[b]] = True
    log_T = np.log(np.full((3, 3), 1.0 / 3.0))
    return pfc, states, noise, Z, valid, log_T


@pytest.fixture(scope="module")
def setup():
    """The JAX models, the spec the ranks get, and the ranks' results."""
    m, test_seqs, test_labels = _jax_model()
    bc = _jax_bc_model()
    pfc, states, noise, Z, valid, log_T = _jax_banks(m)
    spec = {
        "model": _spec_of(m),
        "loss_cfgs": {k: m.config.replace(**v).to_dict() for k, v in LOSS_CFGS.items()},
        "bc_model": {**_spec_of(bc), "params": {
            **{f: np.asarray(getattr(bc.params, f), np.float64) for f in FIELDS},
            "X": np.asarray(bc._W, np.float64)}},
        "Xstar": np.random.default_rng(0).normal(size=(13, 2)),
        "banks": {"particles": BANK_PARTICLES, "log_T": log_T, "Z": Z, "valid": valid,
                  "noise": noise,
                  "states": {"x": np.asarray(states.x), "x_prev": np.asarray(states.x_prev),
                             "c": np.asarray(states.c).astype(np.int64),
                             "log_w": np.asarray(states.log_w),
                             "log_lik": np.asarray(states.log_lik)}},
        "eval": {"seqs": test_seqs, "labels": test_labels, "particles": 32,
                 "T": np.full((3, 3), 1.0 / 3.0)},
    }
    results = par.launch(ranks.parallel_checks, 4, spec, device="cpu", timeout_s=WALL_LIMIT_S)
    return {"m": m, "bc": bc, "spec": spec, "results": results, "pfc": pfc, "states": states,
            "Z": Z, "valid": valid, "log_T": log_T}


@pytest.mark.parametrize("n_class_pad,n_max_pad", [(None, None), (4, None), (None, 40),
                                                   (8, 44)])
def test_padded_class_indices_match_jax(n_class_pad, n_max_pad):
    lengths, classes = [21, 18, 22, 19, 20], [0, 0, 1, 2, 2]
    from gpmdm_tpu.ops.layout import build_layout as j_build_layout

    want = j_padded_class_indices(j_build_layout(lengths, classes, 3), n_class_pad, n_max_pad)
    got = tlayout.padded_class_indices(tlayout.build_layout(lengths, classes, 3), n_class_pad,
                                       n_max_pad)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError):
        tlayout.padded_class_indices(tlayout.build_layout(lengths, classes, 3), n_class_pad=2)


@pytest.mark.parametrize("n,n_classes", [(8, 8), (8, 4), (8, 3), (8, 6), (8, None), (4, 3),
                                         (1, 8)])
def test_train_mesh_shape_matches_jax(n, n_classes):
    want = dict(j_make_train_mesh(n, n_classes=n_classes).shape)
    assert tmesh.train_mesh_shape(n, n_classes) == want


def test_ranks_import_neither_jax_nor_the_jax_package(setup):
    assert [r["jax_imported"] for r in setup["results"]] == [False] * 4


def test_entry_points_do_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        par.init_distributed()


@pytest.mark.parametrize("shard_chol", [False, True], ids=["replicated", "shard_chol"])
@pytest.mark.parametrize("ep,tp", ranks.TRAIN_MESHES)
@pytest.mark.parametrize("cfg_name", list(LOSS_CFGS))
def test_sharded_loss_and_grads_match_jax(setup, cfg_name, ep, tp, shard_chol):
    m = setup["m"]
    cfg = m.config.replace(**LOSS_CFGS[cfg_name])
    Y = jnp.asarray(m.get_Y(), dtype=jnp.float64)
    want, g = jax.value_and_grad(lambda p: jcore.nll(p, Y, cfg, m.layout))(m.params)
    for r in setup["results"]:  # every rank holds the same loss and gradient
        loss, value, grads = r["loss"][(cfg_name, ep, tp, shard_chol)]
        np.testing.assert_allclose(loss, float(want), rtol=1e-10)
        np.testing.assert_allclose(value, float(want), rtol=1e-10)
        for f, got in zip(FIELDS, grads):
            np.testing.assert_allclose(got, np.asarray(getattr(g, f)), rtol=1e-8, atol=1e-10,
                                       err_msg=f)


@pytest.mark.parametrize("shard_chol", [False, True], ids=["replicated", "shard_chol"])
def test_train_adam_sharded_matches_jax(setup, shard_chol):
    m = setup["m"]
    res = j_train_adam(m.params, m.get_Y(), m.config, m.layout,
                       JTrainConfig(num_steps=5, lr=0.01))
    for r in setup["results"]:
        X, losses, count = r["train"][shard_chol]
        assert count == 5
        np.testing.assert_allclose(losses, np.asarray(res.losses), rtol=1e-9)
        np.testing.assert_allclose(X, np.asarray(res.params.X), rtol=1e-7, atol=1e-9)


def test_bc_sharded_training_matches_jax(setup):
    bc = setup["bc"]
    params_w = dataclasses.replace(bc.params, X=bc._W)
    res = j_train_adam(params_w, bc.get_Y(), bc.config, bc.layout,
                       JTrainConfig(num_steps=5, lr=0.01), kind="bc")
    for r in setup["results"]:
        X, losses, shape = r["train"]["bc"]
        assert shape == {"ep": 2, "tp": 2}  # gcd(2 classes, 4 ranks)
        np.testing.assert_allclose(losses, np.asarray(res.losses), rtol=1e-9)
        np.testing.assert_allclose(X, np.asarray(res.params.X), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("which", ["y", "x"])
def test_rowsharded_predictions_match_jax(setup, which):
    m = setup["m"]
    Xstar = jnp.asarray(setup["spec"]["Xstar"])
    fn = jcore.predict_y if which == "y" else jcore.predict_x_all_classes
    want = fn(m.posterior, m.params, Xstar, m.config)
    for r in setup["results"]:
        mean, var = r["predict"][which]
        np.testing.assert_allclose(mean, np.asarray(want[0]), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(var, np.asarray(want[1]), rtol=1e-8, atol=1e-12)
    assert "not divisible" in setup["results"][0]["predict"]["guard"]


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_sharded_banks_match_jax(setup, masked):
    m, pfc, states = setup["m"], setup["pfc"], setup["states"]
    Z, valid, log_T = jnp.asarray(setup["Z"]), setup["valid"], jnp.asarray(setup["log_T"])
    mesh = j_make_mesh({"dp": 4}, devices=jax.devices()[:4])
    if masked:
        _, want = j_scan_bank_sharded_masked(states, Z, jnp.asarray(valid), m.posterior,
                                             m.params, log_T, m.config, pfc, mesh)
    else:
        _, want = j_scan_bank_sharded(states, Z, m.posterior, m.params, log_T, m.config, pfc,
                                      mesh)
        valid = np.ones_like(valid)
    want = np.asarray(want.class_probs)
    for r in setup["results"]:
        got = r["banks"]["masked" if masked else "unmasked"]
        assert got.shape == want.shape == (BANKS, BANK_FRAMES, 3)
        np.testing.assert_allclose(got, r["banks"]["unsharded_masked" if masked else "unsharded"],
                                   rtol=1e-10, atol=1e-14)
        # readouts of a masked frame are meaningless in both packages
        np.testing.assert_allclose(got[valid], want[valid], atol=1e-6)
        np.testing.assert_array_equal(got[valid].argmax(-1), want[valid].argmax(-1))
    if not masked:  # each rank scanned its own two banks
        for r in setup["results"]:
            i, local, x = r["banks"]["unmasked_local"]
            np.testing.assert_array_equal(local, r["banks"]["unmasked"][2 * i:2 * i + 2])
            assert x.shape == (2, BANK_PARTICLES, 2)


def test_evaluate_pf_banked_on_a_mesh_equals_unsharded(setup):
    for r in setup["results"]:
        sharded, plain = r["banks"]["eval"]["mesh"], r["banks"]["eval"]["plain"]
        assert sharded[2] == plain[2] == 6 * 20
        assert len(sharded[0]) == 6
        for a, b in zip(sharded[0], plain[0]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sharded[1], plain[1])


@pytest.mark.parametrize("shard_chol", [False, True], ids=["replicated", "shard_chol"])
@pytest.mark.parametrize("ep,tp", ranks.TRAIN_MESHES)
def test_collectives_of_a_training_step_pinned(setup, ep, tp, shard_chol):
    """One training step: forward, backward and the gradient reduction.

    - Replicated Cholesky: ONE all-reduce (``psum``) of the flat
      [loss share, gradient] over the mesh, on every mesh.  The JAX
      package's step traces to 11 psums (3 forward, over tp and ep, and
      their transposes and shard_map's replication sums); the port's local
      shares leave only the final sum.
    - Distributed Cholesky: the factorization all-gathers one column panel
      a block step (tp); the forward triangular solve and the backward's
      solve against I broadcast one block a step each (2 tp
      ``pbroadcast``); the backward all-gathers Z = L^-1, Y and K^-1 Y (3);
      then the one all-reduce.  The JAX package writes the broadcasts as
      masked psums and sums the shards' partials in its transpose: its
      table is {"psum": 2 tp + 8, "all_gather": tp + 3}.
    """
    want = ({"psum": 1} if not shard_chol
            else {"all_gather": tp + 3, "pbroadcast": 2 * tp, "psum": 1})
    for r in setup["results"]:
        assert r["counts"][(ep, tp, shard_chol)] == want


def test_collectives_of_banks_and_predictions_pinned(setup):
    """The dp bank scan makes no collective (banks are independent; any
    collective would be a cross-bank sync); the readouts are gathered once
    after it, and the sharded evaluation gathers the most likely classes
    once.  A row-sharded prediction makes one all-gather of the star
    kernel and one all-reduce of the packed mean and quad."""
    for r in setup["results"]:
        assert r["banks"]["scan_counts"] == {}
        assert r["banks"]["gather_counts"] == {"all_gather": 1}
        assert r["banks"]["eval_counts"] == {"all_gather": 1}
        assert r["predict"]["counts"] == {"y": {"all_gather": 1, "psum": 1},
                                          "x": {"all_gather": 1, "psum": 1}}
