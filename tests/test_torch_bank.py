"""The port's filter banks (B independent filters in one call) against the
JAX package's, and against the port's own single filter, on the CPU, on
bench_assets/bench_model.npz.

- One banked fp32 frame (B = 3, Pb = 64) against ``jax.vmap`` of JAX
  ``pf_step`` with ``pallas='on'`` (Pallas kernels in interpret mode) and
  ``precision='highest'``, with JAX's own draws injected: readouts within
  rtol 1e-4; resample indices equal away from ambiguous positions (as in
  tests/test_torch_pf.py, whose tolerances these are).
- The bank-aware observation function with z (B, D), Pb = 50 (not a
  multiple of any particle tile), against ``jax.vmap`` of the Pallas
  ``fused_obs_loglik``: rtol 1e-5, atol 1e-6, as
  tests/test_torch_gp_posterior.py holds the single-z version.
- A bank equals independent single filters fed each bank's noise, in
  float64 (rtol 1e-10: the same arithmetic over differently shaped
  batches).
- A masked bank passes an invalid bank's state through unchanged.
- ``evaluate_pf_banked`` at P = 256 against the JAX package's: both at or
  above 0.90 frame accuracy and within 0.05 of each other.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmdm_tpu import GPMDM as JGPMDM
from gpmdm_tpu.config import PFConfig as JPFConfig
from gpmdm_tpu.data import synthetic as jsynthetic
from gpmdm_tpu.filter import particle_filter as jpf
from gpmdm_tpu.ops.pallas import gp_posterior as jgp
from gpmdm_tpu.utils.metrics import evaluate_pf_banked as j_evaluate_pf_banked
from gpmdm_tpu_torch import GPMDMConfig, PFConfig
from gpmdm_tpu_torch.filter import particle_filter as tpf
from gpmdm_tpu_torch.models import core as tcore
from gpmdm_tpu_torch.models.gpmdm import params_from_numpy
from gpmdm_tpu_torch.ops import gp_posterior as tgp
from gpmdm_tpu_torch.utils.io import load_model
from gpmdm_tpu_torch.utils.metrics import evaluate_pf_banked

ASSET = Path(__file__).resolve().parents[1] / "bench_assets" / "bench_model.npz"
TRANS = [[0.9, 0.1], [0.1, 0.9]]
B, PB = 3, 64


@pytest.fixture(scope="module")
def models():
    return JGPMDM.load(ASSET), load_model(ASSET, device="cpu")


@pytest.fixture(scope="module")
def stream():
    _, _, test_seqs, _ = jsynthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=1, seq_len=60, D=35, seed=0)
    return np.concatenate(test_seqs, axis=0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _to_torch_state(s) -> tpf.PFState:
    return tpf.PFState(x=_t(s.x), x_prev=_t(s.x_prev), c=_t(s.c).long(),
                       log_w=_t(s.log_w), log_lik=_t(s.log_lik))


def _bank_indices(log_lik, u):
    """Per-bank systematic indices from a step's log_lik (B, Pb) in numpy
    float32, the JAX package's way, and the positions P cum_j - u."""
    lw = log_lik - jax.scipy.special.logsumexp(log_lik, axis=1, keepdims=True)
    cum = jnp.cumsum(jnp.exp(lw), axis=1)
    v = PB * cum - u[:, None]
    s = jnp.clip(jnp.floor(v).astype(jnp.int32) + 1, 0, PB)
    idx = jax.vmap(lambda r: jnp.searchsorted(r, jnp.arange(PB), side="right"))(s)
    return np.asarray(jnp.clip(idx, 0, PB - 1)), np.asarray(v)


def test_banked_frame_matches_jax_vmap_pallas_f32(models, stream):
    from jax.experimental.pallas import tpu as pltpu

    jm, tm = models
    jcfg = JPFConfig(num_particles=PB, pallas="on", precision="highest")
    tcfg = PFConfig(num_particles=PB, pallas="on")
    log_T = jnp.log(jnp.asarray(TRANS, dtype=jnp.float32))
    s0 = jpf.pf_init_bank(jm.posterior, jm.layout.y_class_offsets, jax.random.PRNGKey(0),
                          jcfg, B)
    nz = jax.vmap(lambda k: jax.tree.map(lambda a: a[0], jpf._pregen_noise(
        k, 1, PB, 2, jnp.float32, jnp.float32)))(s0.key)
    u_res = jax.vmap(lambda k: jax.random.uniform(k, (), dtype=jnp.float32))(nz.k_res)
    z = np.asarray(stream[[0, 20, 40]], np.float32)  # one observation per bank
    with pltpu.force_tpu_interpret_mode():
        js, jo = jax.vmap(lambda s, zz, n: jpf.pf_step(
            s, zz, jm.posterior, jm.params, log_T, jm.config, jcfg, noise=n))(
                s0, jnp.asarray(z), nz)
    tnz = tpf.PFNoise(u_trans=_t(nz.u_trans), eps_dyn=_t(nz.eps_dyn), u_res=_t(u_res))
    ts, to = tpf.pf_step_bank(_to_torch_state(s0), torch.as_tensor(z), tm.posterior,
                              tm.params, _t(log_T), tm.config, tcfg, noise=tnz)

    assert to.class_probs.shape == (B, 2) and to.state_mean.shape == (B, 2)
    for f in ("class_probs", "log_likelihood", "state_mean"):
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                   rtol=1e-4, atol=1e-7, err_msg=f)
    assert to.most_likely_class.tolist() == np.asarray(jo.most_likely_class).tolist()

    j_idx, v = _bank_indices(js.log_lik, np.asarray(u_res))
    ts_log_w = ts.log_lik - torch.logsumexp(ts.log_lik, 1, keepdim=True)
    t_idx = tpf.systematic_resample_indices(tnz.u_res, ts_log_w, w=torch.exp(ts_log_w)).numpy()
    for b in range(B):
        keep = np.ones(PB, bool)
        for vj in v[b][np.abs(v[b] - np.round(v[b])) <= 1e-3]:
            keep[max(int(np.floor(vj)), 0):int(np.floor(vj)) + 2] = False
        np.testing.assert_array_equal(t_idx[b][keep], j_idx[b][keep])
        same = t_idx[b] == j_idx[b]
        np.testing.assert_allclose(ts.x[b].numpy()[same], np.asarray(js.x[b])[same],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(ts.c[b].numpy()[same], np.asarray(js.c[b])[same])


def test_banked_obs_loglik_plain_matches_jax_vmap_pallas():
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(5)
    f32 = np.float32
    N, d, D, nb, pb = 130, 2, 5, 3, 50
    M = rng.normal(size=(N, N))
    Xt = rng.normal(size=(N, d)).astype(f32)
    Xs = rng.normal(size=(nb * pb, d)).astype(f32)
    A = rng.normal(size=(N, D)).astype(f32)
    Kinv = (M @ M.T / N + np.eye(N)).astype(f32)
    ils = np.exp(0.3 * rng.normal(size=d)).astype(f32)
    z = rng.normal(size=(nb, D)).astype(f32)
    lam2 = np.exp(rng.normal(size=D)).astype(f32)
    with pltpu.force_tpu_interpret_mode():
        wq, wr = jax.vmap(lambda xs, zz: jgp.fused_obs_loglik(
            jnp.asarray(Xt), xs, jnp.asarray(A), jnp.asarray(Kinv), jnp.asarray(ils), zz,
            jnp.asarray(lam2)))(jnp.asarray(Xs.reshape(nb, pb, d)), jnp.asarray(z))
    gq, gr = tgp.fused_obs_loglik_plain(*map(torch.as_tensor, (Xt, Xs, A, Kinv, ils, z, lam2)))
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq).reshape(-1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr).reshape(-1), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def f64_model(models):
    """The bench model's parameters deployed in float64 in the port."""
    jm, _ = models
    host = {f: np.asarray(getattr(jm.params, f), np.float64) for f in tcore.PARAM_FIELDS}
    from gpmdm_tpu_torch.ops.layout import build_layout

    cfg = GPMDMConfig.from_dict(jm.config.replace(dtype="float64").to_dict())
    layout = build_layout(jm.layout.seq_lengths, jm.layout.seq_classes, 2)
    post = tcore.precompute_host(host, jm.get_Y(), cfg, layout, "cpu")
    return cfg, params_from_numpy(host, torch.float64, "cpu"), post, layout


def _bank_noise(rng, T, nb, d=2):
    return tpf.PFNoise(u_trans=torch.as_tensor(rng.random((T, nb, PB))),
                       eps_dyn=torch.as_tensor(rng.normal(size=(T, nb, PB, d))),
                       u_res=torch.as_tensor(rng.random((T, nb))))


@pytest.mark.parametrize("variant", [
    {},
    {"accumulate_weights": True, "resample_threshold": 0.5},
])
def test_bank_equals_independent_single_filters(f64_model, stream, variant):
    cfg, params, post, layout = f64_model
    pfc = PFConfig(num_particles=PB, pallas="on", **variant)
    log_T = torch.log(torch.tensor(TRANS, dtype=torch.float64))
    states = tpf.pf_init_bank(post, layout.y_class_offsets,
                              torch.Generator().manual_seed(0), pfc, B)
    assert not torch.equal(states.x[0], states.x[1])  # each bank its own draws
    nz = _bank_noise(np.random.default_rng(6), 1, B)
    nz = dataclasses.replace(nz, **{f.name: getattr(nz, f.name)[0]
                                    for f in dataclasses.fields(nz)})
    z = torch.as_tensor(stream[[3, 30, 50]])
    bank, bank_out = tpf.pf_step_bank(states, z, post, params, log_T, cfg, pfc, noise=nz)
    for b in range(B):
        single, out = tpf.pf_step(
            tpf._map(states, lambda a: a[b]), z[b], post, params, log_T, cfg, pfc,
            noise=tpf._map(nz, lambda a: a[b]))
        for f in dataclasses.fields(tpf.PFOutputs):
            torch.testing.assert_close(getattr(bank_out, f.name)[b], getattr(out, f.name),
                                       rtol=1e-10, atol=1e-12, msg=f.name)
        for f in dataclasses.fields(tpf.PFState):
            torch.testing.assert_close(getattr(bank, f.name)[b], getattr(single, f.name),
                                       rtol=1e-10, atol=1e-12, msg=f.name)
    # a bank of one is the single filter
    one, one_out = tpf.pf_step_bank(tpf._map(states, lambda a: a[:1]), z[:1], post, params,
                                    log_T, cfg, pfc, noise=tpf._map(nz, lambda a: a[:1]))
    single, out = tpf.pf_step(tpf._map(states, lambda a: a[0]), z[0], post, params, log_T,
                              cfg, pfc, noise=tpf._map(nz, lambda a: a[0]))
    for f in dataclasses.fields(tpf.PFOutputs):
        assert torch.equal(getattr(one_out, f.name)[0], getattr(out, f.name)), f.name
    for f in dataclasses.fields(tpf.PFState):
        assert torch.equal(getattr(one, f.name)[0], getattr(single, f.name)), f.name


def test_masked_bank_passes_invalid_state_through(f64_model, stream):
    cfg, params, post, layout = f64_model
    pfc = PFConfig(num_particles=PB, pallas="on")
    log_T = torch.log(torch.tensor(TRANS, dtype=torch.float64))
    states = tpf.pf_init_bank(post, layout.y_class_offsets,
                              torch.Generator().manual_seed(1), pfc, B)
    T = 4
    nz = _bank_noise(np.random.default_rng(7), T, B)
    Z = torch.as_tensor(np.stack([stream[:T], stream[10:10 + T], stream[20:20 + T]]))
    valid = torch.ones(B, T, dtype=torch.bool)
    valid[1, 2:] = False  # bank 1 ends after two frames
    valid[2] = False      # bank 2 never starts
    masked, outs = tpf.pf_scan_bank_masked(states, Z, valid, post, params, log_T, cfg, pfc,
                                           noise=nz)
    full, _ = tpf.pf_scan_bank(states, Z, post, params, log_T, cfg, pfc, noise=nz)
    two, _ = tpf.pf_scan_bank(states, Z[:, :2], post, params, log_T, cfg, pfc,
                              noise=tpf._map(nz, lambda a: a[:2]))
    assert outs.class_probs.shape == (B, T, 2)
    for f in dataclasses.fields(tpf.PFState):
        m, s0 = getattr(masked, f.name), getattr(states, f.name)
        assert torch.equal(m[2], s0[2]), f.name
        assert torch.equal(m[1], getattr(two, f.name)[1]), f.name
        assert torch.equal(m[0], getattr(full, f.name)[0]), f.name


def test_bucket_length_matches_jax():
    for T in (1, 60, 64, 65, 300):
        assert tpf.bucket_length(T) == jpf.bucket_length(T)


def test_evaluate_pf_banked_matches_jax(models):
    jm, tm = models
    _, _, seqs, labels = jsynthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=6, seq_len=60, D=35, seed=0)
    seqs = [np.asarray(s) for s in seqs]
    want = j_evaluate_pf_banked(jm, TRANS, seqs, labels, num_particles=256, burn_in=5)
    got = evaluate_pf_banked(tm, TRANS, seqs, labels, num_particles=256, burn_in=5)
    chunked = evaluate_pf_banked(tm, TRANS, seqs, labels, num_particles=256, burn_in=5,
                                 max_banks=5)
    assert got.total_frames == want.total_frames == chunked.total_frames == 12 * 60
    for rep in (want, got, chunked):
        assert rep.frame_metrics["accuracy"] >= 0.90
        assert rep.frame_confusion.shape == rep.trial_confusion.shape == (2, 2)
    assert abs(got.frame_metrics["accuracy"] - want.frame_metrics["accuracy"]) <= 0.05
    assert abs(chunked.frame_metrics["accuracy"] - want.frame_metrics["accuracy"]) <= 0.05
    assert chunked.frame_confusion.sum() == got.frame_confusion.sum() == 12 * 55


def test_multinomial_bank_draws_each_bank_from_its_own_weights():
    """Banks with disjoint supports: every index of bank b lands in b's
    support, and the shapes are per bank."""
    g = torch.Generator().manual_seed(0)
    w = torch.zeros(3, 8, dtype=torch.float64)
    w[0, :2], w[1, 3], w[2, 5:] = 0.5, 1.0, 1.0 / 3
    idx = tpf.multinomial_resample_indices(g, torch.log(w))
    assert idx.shape == (3, 8)
    assert set(idx[0].tolist()) <= {0, 1} and set(idx[1].tolist()) == {3}
    assert set(idx[2].tolist()) <= {5, 6, 7}
