"""The PyTorch port's particle filter against the JAX package's, on the CPU,
on bench_assets/bench_model.npz with the JAX package's own random draws
injected as per-frame noise.

- One step in float32 against JAX ``pf_step`` with ``pallas='on'`` (the
  Pallas kernels in interpret mode) from the same state: readouts within
  rtol 1e-4; resample indices equal wherever ``P cum_j - u`` is more than
  1e-3 from an integer.  JAX runs at ``precision='highest'``: the port's
  kernels compute every precision name in IEEE fp32, which is JAX's
  'highest'; JAX's 'high' is a bf16x3 emulation that alone moves
  log-likelihoods by ~1% (tests/test_pallas.py).
- Ten frames in float64 against the same JAX ``pallas='on'`` branch, with
  its two fused calls swapped for jnp bodies of the same functions (the
  Pallas kernels take fp32 only), so both sides run that branch's own
  details on every frame: the dynamics variance without the 1e-9 clamp and
  ``n_valid = n_max`` over the zero-padded class blocks.  Class
  probabilities within 1e-3 and the same most likely class on every
  frame.  In fp32 the frame-by-frame comparison is not
  meaningful past two or three frames on this asset: the fp32-deployed
  dynamics posterior has no correct digits in its variance for many
  particles (quad errors up to ~230 on values up to ~430 against a
  float64 evaluation of the same fp32 posterior), so two fp32
  implementations that sum in different orders draw different particle
  clouds.  Even in float64 the large linear dynamics kernel leaves the
  dynamics variance with ~1e-3 relative error, which the sharp
  observation likelihood amplifies, so the particle states themselves are
  compared only after one step.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmdm_tpu import GPMDM as JGPMDM
from gpmdm_tpu import GPMDM_PF as JGPMDM_PF
from gpmdm_tpu.config import PFConfig as JPFConfig
from gpmdm_tpu.data import synthetic as jsynthetic
from gpmdm_tpu.filter import particle_filter as jpf
from gpmdm_tpu.models import core as jcore
from gpmdm_tpu_torch import GPMDM_PF, PFConfig
from gpmdm_tpu_torch.filter import particle_filter as tpf
from gpmdm_tpu_torch.models import core as tcore
from gpmdm_tpu_torch.models.gpmdm import params_from_numpy
from gpmdm_tpu_torch.utils.io import load_model
from gpmdm_tpu_torch.utils.metrics import evaluate_pf

ASSET = Path(__file__).resolve().parents[1] / "bench_assets" / "bench_model.npz"
TRANS = [[0.9, 0.1], [0.1, 0.9]]
P = 256


@pytest.fixture(scope="module")
def models():
    return JGPMDM.load(ASSET), load_model(ASSET, device="cpu")


@pytest.fixture(scope="module")
def stream():
    _, _, test_seqs, _ = jsynthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=1, seq_len=60, D=35, seed=0)
    return np.concatenate(test_seqs, axis=0)


def _to_torch_state(s) -> tpf.PFState:
    t = lambda a: torch.as_tensor(np.array(a))
    return tpf.PFState(x=t(s.x), x_prev=t(s.x_prev), c=t(s.c).long(),
                       log_w=t(s.log_w), log_lik=t(s.log_lik))


def _jax_noise(key, T, dtype):
    """JAX's own per-frame draws: what T sequential pf_steps would draw."""
    nz = jpf._pregen_noise(key, T, P, 2, dtype, dtype)
    u_res = jnp.stack([jax.random.uniform(k, (), dtype=dtype) for k in nz.k_res])
    t = lambda a: torch.as_tensor(np.array(a))
    torch_nz = tpf.PFNoise(u_trans=t(nz.u_trans), eps_dyn=t(nz.eps_dyn), u_res=t(u_res))
    return nz, torch_nz


def _frame(nz, t):
    return jax.tree.map(lambda a: a[t], nz)


def _indices(log_lik, u, module):
    """Systematic resample indices from a step's (non-accumulated) log_lik."""
    if module is tpf:
        log_w = log_lik - torch.logsumexp(log_lik, 0)
        return tpf.systematic_resample_indices(u, log_w, w=torch.exp(log_w)).numpy()
    log_w = log_lik - jax.scipy.special.logsumexp(log_lik)
    ct = log_w.dtype
    cum = jnp.cumsum(jnp.exp(log_w))
    s = jnp.clip(jnp.floor(P * cum - u.astype(ct)).astype(jnp.int32) + 1, 0, P)
    return np.asarray(jnp.clip(jnp.searchsorted(s, jnp.arange(P), side="right"), 0, P - 1)), \
        np.asarray(P * cum - u.astype(ct))


def test_pf_step_matches_jax_pallas_f32(models, stream):
    from jax.experimental.pallas import tpu as pltpu

    jm, tm = models
    jcfg = JPFConfig(num_particles=P, pallas="on", precision="highest")
    tcfg = PFConfig(num_particles=P, pallas="on")
    log_T = jnp.log(jnp.asarray(TRANS, dtype=jnp.float32))
    s0 = jpf.pf_init(jm.posterior, jm.layout.y_class_offsets, jax.random.PRNGKey(0), jcfg)
    nz, tnz = _jax_noise(s0.key, 1, jnp.float32)
    z = np.asarray(stream[0], np.float32)
    with pltpu.force_tpu_interpret_mode():
        js, jo = jpf.pf_step(s0, jnp.asarray(z), jm.posterior, jm.params, log_T,
                             jm.config, jcfg, noise=_frame(nz, 0))
    ts, to = tpf.pf_step(_to_torch_state(s0), torch.as_tensor(z), tm.posterior, tm.params,
                         torch.as_tensor(np.array(log_T)), tm.config, tcfg,
                         noise=tpf.PFNoise(tnz.u_trans[0], tnz.eps_dyn[0], tnz.u_res[0]))

    for f in ("class_probs", "log_likelihood", "state_mean"):
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                   rtol=1e-4, atol=1e-7, err_msg=f)
    assert int(to.most_likely_class) == int(jo.most_likely_class)

    j_idx, v = _indices(js.log_lik, tnz.u_res[0].numpy(), jpf)
    t_idx = _indices(ts.log_lik, tnz.u_res[0], tpf)
    ambiguous = np.abs(v - np.round(v)) <= 1e-3
    keep = np.ones(P, bool)
    for vj in v[ambiguous]:
        keep[max(int(np.floor(vj)), 0):int(np.floor(vj)) + 2] = False
    np.testing.assert_array_equal(t_idx[keep], j_idx[keep])
    same = t_idx == j_idx
    np.testing.assert_allclose(ts.x.numpy()[same], np.asarray(js.x)[same], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(ts.c.numpy()[same], np.asarray(js.c)[same])


def _jnp_star(xt, xs, n_valid, lt=None, ls=None, bias=None):
    """(N, P) star kernel from pre-scaled inputs; rows >= n_valid are 0."""
    sq = sum((xt[:, None, k] - xs[None, :, k]) ** 2 for k in range(xt.shape[1]))
    ks = jnp.exp(-sq)
    if lt is not None:
        ks = ks + jnp.matmul(lt, ls.T, precision="highest") + bias
    return jnp.where(jnp.arange(xt.shape[0])[:, None] < n_valid, ks, 0.0)


def _jnp_mean_quad(ks, A, Kinv):
    dot = lambda a, b: jnp.matmul(a, b, precision="highest")
    return dot(ks.T, A), jnp.sum(ks * dot(Kinv, ks), axis=0)


def _jnp_fused_x_posterior(Xin_c, Xstar, Axc, Kxc_inv, inv_lengthscales, lin_w,
                           n_valid, **_):
    """fused_x_posterior's function in jnp, in its inputs' dtype."""
    w = lin_w[:-1]
    ks = _jnp_star(Xin_c * inv_lengthscales, Xstar * inv_lengthscales, n_valid,
                   Xin_c * w, Xstar * w, lin_w[-1] ** 2)
    return _jnp_mean_quad(ks, Axc, Kxc_inv)


def _jnp_fused_obs_loglik(Xtrain, Xstar, Ay, Kinv, inv_lengthscales, z, lam2, **_):
    """fused_obs_loglik's function in jnp, in its inputs' dtype."""
    ks = _jnp_star(Xtrain * inv_lengthscales, Xstar * inv_lengthscales, Xtrain.shape[0])
    mean, quad = _jnp_mean_quad(ks, Ay, Kinv)
    return quad, jnp.sum(lam2[None, :] * (mean - z[None, :]) ** 2, axis=1)


@pytest.fixture
def jax_fused_in_f64(monkeypatch):
    """JAX's pf_step imports the fused functions when it runs its 'on'
    branch: give it the jnp bodies, which keep float64."""
    from gpmdm_tpu.ops.pallas import gp_posterior as jgp

    monkeypatch.setattr(jgp, "fused_x_posterior", _jnp_fused_x_posterior)
    monkeypatch.setattr(jgp, "fused_obs_loglik", _jnp_fused_obs_loglik)


def _f64_models(jm):
    """The bench model's float32 parameters, deployed in float64 in both
    packages (the same host factorization, without the fp32 cast)."""
    cfg64 = jm.config.replace(dtype="float64")
    host = {f: np.asarray(getattr(jm.params, f), np.float64) for f in tcore.PARAM_FIELDS}
    jparams = jcore.GPMDMParams(**{f: jnp.asarray(v) for f, v in host.items()})
    jpost = jcore.precompute_host(jparams, jm.get_Y(), cfg64, jm.layout)
    from gpmdm_tpu_torch import GPMDMConfig
    from gpmdm_tpu_torch.ops.layout import build_layout

    tcfg = GPMDMConfig.from_dict(cfg64.to_dict())
    tl = build_layout(jm.layout.seq_lengths, jm.layout.seq_classes, 2)
    tpost = tcore.precompute_host(host, jm.get_Y(), tcfg, tl, "cpu")
    return (cfg64, jparams, jpost), (tcfg, params_from_numpy(host, torch.float64, "cpu"), tpost)


@pytest.mark.parametrize("variant", [
    {},
    {"accumulate_weights": True, "resample_threshold": 0.5},
    {"compat_double_logdet": True, "obs_noise_in_weights": False},
])
def test_ten_frames_match_jax_f64(models, stream, jax_fused_in_f64, variant):
    jm, _ = models
    (jcfg64, jparams, jpost), (tcfg64, tparams, tpost) = _f64_models(jm)
    jcfg = JPFConfig(num_particles=P, pallas="on", precision="highest", **variant)
    tcfg = PFConfig(num_particles=P, pallas="on", **variant)
    log_T = jnp.log(jnp.asarray(TRANS, dtype=jnp.float64))
    T = 10
    s = jpf.pf_init(jpost, jm.layout.y_class_offsets, jax.random.PRNGKey(1), jcfg)
    nz, tnz = _jax_noise(s.key, T, jnp.float64)
    ts = _to_torch_state(s)
    Z = np.asarray(stream[:T], np.float64)
    step = jax.jit(lambda s, z, n: jpf.pf_step(s, z, jpost, jparams, log_T, jcfg64, jcfg, noise=n))
    jprobs, jmlc = [], []
    for t in range(T):
        s, o = step(s, jnp.asarray(Z[t]), _frame(nz, t))
        jprobs.append(np.asarray(o.class_probs))
        jmlc.append(int(o.most_likely_class))
    _, to = tpf.pf_scan(ts, torch.as_tensor(Z), tpost, tparams,
                        torch.as_tensor(np.array(log_T)), tcfg64, tcfg, noise=tnz)
    np.testing.assert_allclose(to.class_probs.numpy(), np.stack(jprobs), atol=1e-3)
    assert to.most_likely_class.tolist() == jmlc


def test_pf_scan_masked_matches_jax_f64(models, stream, jax_fused_in_f64):
    """A padded sequence, four valid frames then two masked, in float64:
    the valid frames' readouts match JAX ``pf_scan_masked`` (its in-scan
    draws, which the port gets injected by frame position, as in
    test_ten_frames_match_jax_f64), and the masked frames leave the port's
    state exactly where the four valid frames put it."""
    jm, _ = models
    (jcfg64, jparams, jpost), (tcfg64, tparams, tpost) = _f64_models(jm)
    jcfg = JPFConfig(num_particles=P, pallas="on", precision="highest")
    tcfg = PFConfig(num_particles=P, pallas="on")
    log_T = jnp.log(jnp.asarray(TRANS, dtype=jnp.float64))
    T, T_valid = 6, 4
    s = jpf.pf_init(jpost, jm.layout.y_class_offsets, jax.random.PRNGKey(2), jcfg)
    _, tnz = _jax_noise(s.key, T, jnp.float64)
    Z = np.asarray(stream[:T], np.float64)
    valid = np.arange(T) < T_valid
    _, jo = jpf.pf_scan_masked(s, jnp.asarray(Z), jnp.asarray(valid), jpost, jparams, log_T,
                               jcfg64, jcfg, pregen=False)
    tlog_T = torch.as_tensor(np.array(log_T))
    ts, to = tpf.pf_scan_masked(_to_torch_state(s), torch.as_tensor(Z), valid, tpost, tparams,
                                tlog_T, tcfg64, tcfg, noise=tnz)
    assert to.class_probs.shape == (T, 2)
    np.testing.assert_allclose(to.class_probs.numpy()[:T_valid],
                               np.asarray(jo.class_probs)[:T_valid], atol=1e-3)
    assert (to.most_likely_class.tolist()[:T_valid]
            == np.asarray(jo.most_likely_class).tolist()[:T_valid])
    first = tpf._map(tnz, lambda a: a[:T_valid])
    want, _ = tpf.pf_scan(_to_torch_state(s), torch.as_tensor(Z[:T_valid]), tpost, tparams,
                          tlog_T, tcfg64, tcfg, noise=first)
    for f in dataclasses.fields(tpf.PFState):
        assert torch.equal(getattr(ts, f.name), getattr(want, f.name)), f.name


def test_gpmdm_pf_properties_match_jax(models):
    jm, tm = models
    jflt = JGPMDM_PF(jm, TRANS, 100, seed=0)
    tflt = GPMDM_PF(tm, TRANS, 100, seed=0)
    for name in ("latent_dim", "observation_dim", "num_classes", "num_particles"):
        assert getattr(tflt, name) == getattr(jflt, name), name
    assert (tflt.latent_dim, tflt.observation_dim, tflt.num_classes) == (2, 35, 2)
    assert str(tflt.dtype).removeprefix("torch.") == np.dtype(jflt.dtype).name


@pytest.mark.parametrize("compat", [False, True])
def test_observation_log_lik_matches_jax(compat):
    rng = np.random.default_rng(4)
    z, mean = rng.normal(size=35), rng.normal(size=(50, 35))
    var = np.exp(rng.normal(size=(50, 35)))
    want = jpf.observation_log_lik(jnp.asarray(z), jnp.asarray(mean), jnp.asarray(var), 35, compat)
    got = tpf.observation_log_lik(torch.as_tensor(z), torch.as_tensor(mean),
                                  torch.as_tensor(var), 35, compat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_systematic_resample_rank_matches_jax():
    """Weights with an exact fp32 cumsum in any order (multiples of 2^-10):
    the port's binary search and JAX's 0/1-matmul rank agree exactly."""
    rng = np.random.default_rng(0)
    for n in (7, 256, 1000):
        counts = rng.multinomial(1024, rng.dirichlet(np.ones(n) * 0.3))
        w = (counts / 1024.0).astype(np.float32)
        log_w = np.log(np.maximum(w, 1e-30)).astype(np.float32)
        key = jax.random.PRNGKey(n)
        u = jax.random.uniform(key, (), dtype=jnp.float32)
        want = jpf.systematic_resample_indices(key, jnp.asarray(log_w), w=jnp.asarray(w))
        got = tpf.systematic_resample_indices(torch.as_tensor(np.array(u)),
                                              torch.as_tensor(log_w), w=torch.as_tensor(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_multinomial_resample_distribution():
    g = torch.Generator().manual_seed(0)
    w = torch.tensor([0.1, 0.6, 0.3])
    assert tpf.multinomial_resample_indices(g, torch.log(w)).shape == (3,)
    counts = torch.zeros(3)
    for _ in range(2000):
        counts += torch.bincount(tpf.multinomial_resample_indices(g, torch.log(w)), minlength=3)
    np.testing.assert_allclose((counts / counts.sum()).numpy(), w.numpy(), atol=0.02)


def test_pf_init_samples_from_own_class(models):
    _, tm = models
    cfg = PFConfig(num_particles=301)
    s = tpf.pf_init(tm.posterior, tm.layout.y_class_offsets,
                    torch.Generator().manual_seed(0), cfg)
    assert torch.bincount(s.c).tolist() == [151, 150]
    X = tm.posterior.X
    off = tm.layout.y_class_offsets
    for c in range(2):
        rows = X[off[c]:off[c + 1]]
        for x in s.x[s.c == c][:20]:
            assert (rows == x).all(1).any()
    torch.testing.assert_close(s.log_w.exp().sum(), torch.tensor(1.0))


def test_dead_particles_and_all_dead_fallback(models, stream):
    _, tm = models
    cfg = PFConfig(num_particles=64)
    g = torch.Generator().manual_seed(0)
    s = tpf.pf_init(tm.posterior, tm.layout.y_class_offsets, g, cfg)
    z = torch.as_tensor(stream[0])
    log_T = torch.log(torch.tensor(TRANS))
    s.x[:5] = float("inf")
    s2, o = tpf.pf_step(s, z, tm.posterior, tm.params, log_T, tm.config, cfg, generator=g)
    assert torch.isfinite(o.class_probs).all() and torch.isfinite(o.state_mean).all()
    s.x[:] = float("nan")
    s3, o = tpf.pf_step(s, z, tm.posterior, tm.params, log_T, tm.config, cfg, generator=g)
    assert torch.isneginf(s3.log_lik).all()
    torch.testing.assert_close(o.class_probs.sum(), torch.tensor(1.0))
    assert torch.isfinite(o.state_mean).all()


def test_wrapper_run_matches_updates_and_classifies(models):
    _, tm = models
    _, _, seqs, labels = jsynthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=2, seq_len=60, D=35, seed=0)
    flt = GPMDM_PF(tm, TRANS, 200, seed=3)
    outs = flt.run(seqs[0][:8])
    flt.reset()
    for t in range(8):
        o = flt.update(seqs[0][t])
        torch.testing.assert_close(o.class_probs, outs.class_probs[t])
    assert flt.get_most_likely_class() == int(outs.most_likely_class[-1])
    assert flt.class_probabilities().shape == (2,)
    rep = evaluate_pf(GPMDM_PF(tm, TRANS, 300, seed=0), seqs, labels, 2, burn_in=5)
    assert rep.total_frames == 4 * 60
    assert rep.frame_metrics["accuracy"] >= 0.9
