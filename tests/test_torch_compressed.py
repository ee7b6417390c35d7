"""The port's compressed posterior (``gpmdm_tpu_torch.models.compressed``)
against the JAX package's, on the CPU, on ``bench_assets/bench_model.npz``
(Ny = 480, two classes of 236 dynamics rows).

- ``compress_host`` in float64 at the tol-selected ranks and at pinned
  ranks: every field within rtol 1e-12 of the JAX package's, the
  eigenvectors after aligning each column's sign (both run numpy's
  ``eigh`` on the same float64 Gram).
- ``predict_y`` and ``predict_x_all_classes`` (one product for the mean
  and the projection) against the JAX package's fused and unfused
  variants, in float64 on seeded points around the training latents:
  rtol 1e-10, the
  variances also within 64 eps of ``kdiag / lambda^2``, the float64
  floor of ``(kdiag - quad) / lambda^2`` (a few of the smallest, near
  1e-11, differ by ~1e-14 from the summation order alone).  At
  full rank both equal the port's exact predictions to the JAX package's
  own bounds (its ``test_full_rank_is_exact``).
- One ``pf_step`` in float32 from the same state with the JAX package's
  own draws injected: readouts within rtol 1e-4, the resampled classes
  equal and the states within rtol 1e-4.  Each particle's log-likelihood
  within rtol 1e-2: calibrated on seeds 0-2, where it differs by 2.0e-3
  to 3.5e-3, because fp32 keeps 3-4 digits of the variance
  ``kdiag - quad`` (~1e-4 against terms near 1) and the log-likelihood
  divides by it.
- Ten frames in float64: every frame's classes equal and its states,
  class probabilities and state mean within 1e-9 (measured: states within
  2e-11).  The likelihood sum within rtol 1e-8 (measured up to 2.1e-9):
  it exponentiates log-likelihoods near 1e5 that divide by that same
  cancelled variance, which float64 keeps to ~1e-11 relative.
- ``evaluate_pf_banked(posterior=cp)`` on the headline guard's trials at
  P = 200: the port's frame accuracy lies inside the band of the JAX
  package's over four seeds, widened by one frame a trial.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from gpmdm_tpu import GPMDM as JGPMDM
from gpmdm_tpu.config import PFConfig as JPFConfig
from gpmdm_tpu.filter import particle_filter as jpf
from gpmdm_tpu.models import compressed as jcomp
from gpmdm_tpu.utils.metrics import evaluate_pf_banked as j_evaluate_pf_banked
from gpmdm_tpu_torch import GPMDM as TGPMDM
from gpmdm_tpu_torch import PFConfig
from gpmdm_tpu_torch.data import synthetic
from gpmdm_tpu_torch.filter import particle_filter as tpf
from gpmdm_tpu_torch.models import compressed as tcomp
from gpmdm_tpu_torch.models import core as tcore
from gpmdm_tpu_torch.models.gpmdm import params_from_numpy
from gpmdm_tpu_torch.ops import kernels as tK
from gpmdm_tpu_torch.utils.io import load_model
from gpmdm_tpu_torch.utils.metrics import evaluate_pf_banked

ASSET = Path(__file__).resolve().parents[1] / "bench_assets" / "bench_model.npz"
TRANS = [[0.9, 0.1], [0.1, 0.9]]
P = 256
EPS64 = np.finfo(np.float64).eps
FIELDS = [f.name for f in dataclasses.fields(tcomp.CompressedPosterior)]



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS and OpenMP thread: idle pool threads spinning between
    calls would take cores from the suite's other workers."""
    with threadpoolctl.threadpool_limits(1):
        yield

@pytest.fixture(scope="module")
def models():
    """The asset in both packages, with float64 configs and parameters
    beside the float32 ones: (jax model, port model, jax f64 config, jax
    f64 params, port f64 config, port f64 params)."""
    jm, tm = JGPMDM.load(ASSET), load_model(ASSET, device="cpu")
    jcfg64 = jm.config.replace(dtype="float64")
    jp64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jm.params)
    tcfg64 = dataclasses.replace(tm.config, dtype="float64")
    tp64 = params_from_numpy({f: np.asarray(getattr(jm.params, f), np.float64)
                              for f in tcore.PARAM_FIELDS}, torch.float64, "cpu")
    return jm, tm, jcfg64, jp64, tcfg64, tp64


def _compress_both(models, dtype="float64", **ranks):
    jm, tm, jcfg64, _, tcfg64, _ = models
    jcfg, tcfg = (jcfg64, tcfg64) if dtype == "float64" else (jm.config, tm.config)
    jc = jcomp.compress_host(jm.params, jnp.asarray(jm.get_Y()), jcfg, jm.layout, **ranks)
    tc = tcomp.compress_host(tm.params, tm.get_Y(), tcfg, tm.layout, device="cpu", **ranks)
    return jc, tc


def _queries(m, n=150, seed=1):
    """Points around the training latents, and a few far from them."""
    rng = np.random.default_rng(seed)
    X = np.asarray(m.params.X, np.float64)
    near = X[rng.integers(0, X.shape[0], n)] + 0.05 * rng.normal(size=(n, X.shape[1]))
    far = 1.5 * rng.normal(size=(n // 5, X.shape[1]))
    return np.concatenate([near, far])


def _assert_fields(tc, jc, dtype, rtol):
    for f in FIELDS:
        got, want = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        assert got.shape == want.shape and got.dtype == dtype, f
        assert getattr(tc, f).is_contiguous(), f
        if f in ("Uy", "Uxc"):
            # each eigenvector's sign is arbitrary: align it on JAX's
            sign = np.sign(np.sum(got * want, axis=-2, keepdims=True))
            got = got * np.where(sign == 0, 1.0, sign)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=f)


@pytest.mark.parametrize("ranks", [{}, {"rank_y": 40, "rank_x": 25}], ids=["tol", "pinned"])
def test_compress_host_matches_jax(models, ranks):
    jc, tc = _compress_both(models, **ranks)
    assert (tc.rank_y, tc.rank_x) == (jc.rank_y, jc.rank_x)
    if ranks:
        assert (tc.rank_y, tc.rank_x) == (40, 25)
    _assert_fields(tc, jc, np.float64, rtol=1e-12)


def test_compressed_posterior_is_cast_to_the_model_dtype(models):
    """In the model's float32: the JAX package's values, C-contiguous,
    0-d fields 0-d."""
    jc, tc = _compress_both(models, dtype="float32")
    _assert_fields(tc, jc, np.float32, rtol=0)
    assert tc.inv_s2y.dim() == 0 and tc.inv_s2x.dim() == 0


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("ranks", [{}, {"rank_y": 40, "rank_x": 25}], ids=["tol", "pinned"])
def test_predictions_match_jax_f64(models, fused, ranks):
    jm, tm, jcfg64, jp64, tcfg64, tp64 = models
    jc, tc = _compress_both(models, **ranks)
    q = _queries(jm)
    tq = torch.as_tensor(q)
    hi = jax.lax.Precision.HIGHEST
    # var = (kdiag - quad) / lambda^2 cancels: float64 leaves it an absolute
    # error of a few eps * kdiag / lambda^2, whatever the summation order
    p = tp64
    floors = {
        "predict_y": tK.y_diag_kernel(tq, p.y_log_sigma_n, tcfg64.sigma_n_num_Y, True)[:, None]
        * torch.exp(p.y_log_lambdas) ** -2,
        "predict_x_all_classes": tK.x_diag_kernel(tq, p.x_log_lin_coeff, p.x_log_sigma_n,
                                                  tcfg64.sigma_n_num_X, True)[:, None]
        * torch.exp(p.x_log_lambdas) ** -2,
    }
    for name in ("predict_y", "predict_x_all_classes"):
        jmean, jvar = getattr(jcomp, name)(jc, jp64, jnp.asarray(q), jcfg64, with_noise=True,
                                           precision=hi, fused=fused)
        tmean, tvar = getattr(tcomp, name)(tc, tp64, tq, tcfg64, with_noise=True)
        np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-10, atol=1e-12,
                                   err_msg=name)
        err = np.abs(tvar.numpy() - np.asarray(jvar))
        bound = 1e-10 * np.abs(np.asarray(jvar)) + 64 * EPS64 * floors[name].numpy()
        assert np.all(err <= bound), (name, np.max(err / bound))


def test_full_rank_is_exact():
    """Every eigenpair kept, the compressed quad is the exact quad: on the
    JAX package's own fixture for this check (a float64 model trained 120
    Adam steps on 3 x 50 frames a class), the port's compressed
    predictions equal its exact ones to that test's bounds (the trained
    dynamics Grams' conditioning leaves ~1e-4 relative on the smallest
    variances)."""
    tr, tl, _, _ = synthetic.make_dataset(n_classes=2, n_train_seqs=3, n_test_seqs=4,
                                          seq_len=50, D=12, seed=0)
    m = TGPMDM(D=12, d=2, n_classes=2, dtype="float64", y_sigma_n_init=0.1,
               x_sigma_n_init=0.1, device="cpu")
    for Y, c in zip(tr, tl):
        m.add_data(Y, c)
    m.init_X()
    m.train_adam(num_opt_steps=120, lr=0.01)
    q = torch.as_tensor(np.random.RandomState(1).randn(150, m.d) * 1.2)
    cp = m.compressed_posterior(rank_y=m.layout.Ny, rank_x=m.layout.n_max)
    my, vy = tcore.predict_y(m.posterior, m.params, q, m.config)
    cy, cvy = tcomp.predict_y(cp, m.params, q, m.config)
    np.testing.assert_allclose(cy.numpy(), my.numpy(), atol=1e-9)
    np.testing.assert_allclose(cvy.numpy(), vy.numpy(), rtol=1e-5, atol=1e-11)
    mx, vx = tcore.predict_x_all_classes(m.posterior, m.params, q, m.config)
    cx, cvx = tcomp.predict_x_all_classes(cp, m.params, q, m.config)
    np.testing.assert_allclose(cx.numpy(), mx.numpy(), atol=1e-9)
    np.testing.assert_allclose(cvx.numpy(), vx.numpy(), rtol=1e-3, atol=1e-11)


def _to_torch_state(s) -> tpf.PFState:
    t = lambda a: torch.as_tensor(np.array(a))
    return tpf.PFState(x=t(s.x), x_prev=t(s.x_prev), c=t(s.c).long(),
                       log_w=t(s.log_w), log_lik=t(s.log_lik))


def _jax_noise(key, T, dtype):
    """JAX's own draws for T sequential pf_steps, and the port's copy."""
    nz = jpf._pregen_noise(key, T, P, 2, dtype, dtype)
    u_res = jnp.stack([jax.random.uniform(k, (), dtype=dtype) for k in nz.k_res])
    t = lambda a: torch.as_tensor(np.array(a))
    return nz, tpf.PFNoise(u_trans=t(nz.u_trans), eps_dyn=t(nz.eps_dyn), u_res=t(u_res))


@pytest.fixture(scope="module")
def stream():
    _, _, test_seqs, _ = synthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=1, seq_len=60, D=35, seed=0)
    return np.concatenate(test_seqs, axis=0)


def _compare_outputs(to, jo, rtol, lik_rtol):
    for f, tol in (("class_probs", rtol), ("log_likelihood", lik_rtol),
                   ("state_mean", rtol)):
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                   rtol=tol, atol=rtol, err_msg=f)
    assert int(to.most_likely_class) == int(jo.most_likely_class)


def test_pf_step_matches_jax_f32(models, stream):
    jm, tm = models[:2]
    jc, tc = _compress_both(models, dtype="float32")
    jcfg = JPFConfig(num_particles=P, precision="highest")
    tcfg = PFConfig(num_particles=P)
    log_T = jnp.log(jnp.asarray(TRANS, dtype=jnp.float32))
    s0 = jpf.pf_init(jc, jm.layout.y_class_offsets, jax.random.PRNGKey(0), jcfg)
    nz, tnz = _jax_noise(s0.key, 1, jnp.float32)
    z = np.asarray(stream[0], np.float32)
    js, jo = jpf.pf_step(s0, jnp.asarray(z), jc, jm.params, log_T, jm.config, jcfg,
                         noise=jax.tree.map(lambda a: a[0], nz))
    ts, to = tpf.pf_step(_to_torch_state(s0), torch.as_tensor(z), tc, tm.params,
                         torch.as_tensor(np.array(log_T)), tm.config, tcfg,
                         noise=tpf.PFNoise(tnz.u_trans[0], tnz.eps_dyn[0], tnz.u_res[0]))
    _compare_outputs(to, jo, rtol=1e-4, lik_rtol=1e-4)
    np.testing.assert_allclose(ts.log_lik.numpy(), np.asarray(js.log_lik), rtol=1e-2)
    np.testing.assert_array_equal(ts.c.numpy(), np.asarray(js.c))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-4, atol=1e-6)


def test_ten_frames_match_jax_f64(models, stream):
    jm, tm, jcfg64, jp64, tcfg64, tp64 = models
    jc, tc = _compress_both(models)
    jcfg = JPFConfig(num_particles=P, precision="highest")
    tcfg = PFConfig(num_particles=P)
    log_T = jnp.log(jnp.asarray(TRANS, dtype=jnp.float64))
    tlog_T = torch.as_tensor(np.array(log_T))
    js = jpf.pf_init(jc, jm.layout.y_class_offsets, jax.random.PRNGKey(3), jcfg)
    ts = _to_torch_state(js)
    nz, tnz = _jax_noise(js.key, 10, jnp.float64)
    for t in range(10):
        z = np.asarray(stream[t], np.float64)
        js, jo = jpf.pf_step(js, jnp.asarray(z), jc, jp64, log_T, jcfg64, jcfg,
                             noise=jax.tree.map(lambda a: a[t], nz))
        ts, to = tpf.pf_step(ts, torch.as_tensor(z), tc, tp64, tlog_T, tcfg64, tcfg,
                             noise=tpf.PFNoise(tnz.u_trans[t], tnz.eps_dyn[t],
                                               tnz.u_res[t]))
        _compare_outputs(to, jo, rtol=1e-9, lik_rtol=1e-8)
        np.testing.assert_array_equal(ts.c.numpy(), np.asarray(js.c))
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-9, atol=1e-9)


def test_evaluate_pf_banked_in_jax_seed_band(models):
    jm, tm = models[:2]
    jc, tc = _compress_both(models, dtype="float32")
    _, _, seqs, labels = synthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=6, seq_len=60, D=35, seed=0)
    kw = dict(num_particles=200, burn_in=5)
    jax_acc = [j_evaluate_pf_banked(jm, TRANS, seqs, labels, seed=s, posterior=jc, **kw)
               .frame_metrics["accuracy"] for s in range(4)]
    rep = evaluate_pf_banked(tm, TRANS, seqs, labels, seed=0, posterior=tc, **kw)
    frame = 1.0 / (len(seqs[0]) - 5)
    acc = rep.frame_metrics["accuracy"]
    assert min(jax_acc) - frame <= acc <= max(jax_acc) + frame, (acc, jax_acc)
    assert rep.total_frames == sum(len(s) for s in seqs)
