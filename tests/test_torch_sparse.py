"""The port's sparse posteriors (``gpmdm_tpu_torch.models.sparse``) against
the JAX package's, on the CPU in float64, on small seeded models: the
synthetic task at C = 2 and 3 classes of 2 x 30 frames (Ny = 120 and
180), D = 8, d = 2, ``dyn_back_step`` 1 and 2, PCA latents and seeded
hyperparameters, My = 16 and Mx = 8 inducing inputs.

- ``precompute_host``: every factor within rtol 1e-10 of the JAX
  package's (both run the same float64 numpy).
- ``predict_y``, ``predict_x_all_classes`` and ``predict_x`` on both
  variance paths (triangular solves, hoisted inverses), with and without
  noise: rtol 1e-10.
- ``distill_host`` for 'stride' and 'kmeans', with Mx clamped to the
  smallest class: every factor within rtol 1e-10, ``distilled`` set.
- ``bench_model_c8.npz``'s persisted kmeans-128 distillation is rebuilt
  from the checkpoint to float32 rounding.
- Ten injected-noise ``pf_step`` frames at C = 2 with one back step and
  C = 3 with two, a native posterior and a distilled one (each on its
  default variance path), one filter and a bank of 3 against
  ``jax.vmap`` of JAX's ``pf_step``: the classes equal on every frame,
  the states and readouts within 1e-9, the likelihood sum within 1e-8.
- ``_effective_quad_precision`` picks JAX's variance path for every
  (``quad_precision``, ``distilled``) pair.
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
from gpmdm_tpu.data import synthetic as jsynthetic
from gpmdm_tpu.filter import particle_filter as jpf
from gpmdm_tpu.models import core as jcore
from gpmdm_tpu.models import sparse as jsp
from gpmdm_tpu_torch import PFConfig
from gpmdm_tpu_torch.config import GPMDMConfig
from gpmdm_tpu_torch.filter import particle_filter as tpf
from gpmdm_tpu_torch.models import sparse as tsp
from gpmdm_tpu_torch.models.core import PARAM_FIELDS
from gpmdm_tpu_torch.models.gpmdm import params_from_numpy
from gpmdm_tpu_torch.ops.layout import build_layout
from gpmdm_tpu_torch.utils.io import load_model

ASSETS = Path(__file__).resolve().parents[1] / "bench_assets"
MY, MX = 16, 8
P, B = 64, 3
FRAMES = 10
RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS and OpenMP thread: idle pool threads spinning between
    calls would take cores from the suite's other workers."""
    with threadpoolctl.threadpool_limits(1):
        yield


class Pair:
    """One seeded model in both packages: float64 configs, layouts, the
    exact parameters as numpy arrays, the observations, a stream of test
    frames and the inducing inputs of ``init_inducing``."""

    def __init__(self, C: int, back_step: int):
        tr, tl, te, _ = jsynthetic.make_dataset(n_classes=C, n_train_seqs=2, n_test_seqs=1,
                                                seq_len=30, D=8, seed=5)
        jm = JGPMDM(D=8, d=2, n_classes=C, dyn_back_step=back_step, dtype="float64",
                    sigma_n_num_Y=1e-3, sigma_n_num_X=1e-3)
        for Y, c in zip(tr, tl):
            jm.add_data(Y, c)
        jm.init_X()
        rng = np.random.default_rng(10 * C + back_step)
        self.arrays = {f: np.asarray(getattr(jm.params, f), np.float64) for f in PARAM_FIELDS}
        for f in PARAM_FIELDS[:-1]:  # seeded hyperparameters around the inits
            a = self.arrays[f]
            self.arrays[f] = a + 0.3 * rng.standard_normal(a.shape)
        self.jcfg, self.jlayout = jm.config, jm.layout
        self.tcfg = GPMDMConfig.from_dict(jm.config.to_dict())
        lengths = [len(s) for s in tr]
        self.tlayout = build_layout(lengths, list(tl), C, back_step)
        self.Y = jm.get_Y().astype(np.float64)
        self.stream = np.concatenate(te, axis=0)
        self.Zy, self.Zx = jsp.init_inducing(self.arrays["X"], self.jlayout, self.jcfg, MY, MX)
        self.Zy = self.Zy + 0.01 * rng.standard_normal(self.Zy.shape)
        self.sparse_arrays = {**self.arrays, "Zy": self.Zy, "Zx": self.Zx}
        self.jparams = jsp.SparseParams(**{k: jnp.asarray(v)
                                           for k, v in self.sparse_arrays.items()})
        self.tparams = params_from_numpy(self.sparse_arrays, torch.float64, "cpu")
        self.jpost = jsp.precompute_host(jsp.SparseParams(**self.sparse_arrays), self.Y,
                                         self.jcfg, self.jlayout)
        self.tpost = tsp.precompute_host(self.sparse_arrays, self.Y, self.tcfg, self.tlayout,
                                         device="cpu")

    def distilled(self, **kw):
        return (jsp.distill_host(jcore.GPMDMParams(**self.arrays), self.Y, self.jcfg,
                                 self.jlayout, **kw),
                tsp.distill_host(self.arrays, self.Y, self.tcfg, self.tlayout, device="cpu",
                                 **kw))


CASES = [(2, 1), (3, 1), (2, 2), (3, 2)]
_PAIRS = {}


def _pair(case):
    if case not in _PAIRS:
        _PAIRS[case] = Pair(*case)
    return _PAIRS[case]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"C{c[0]}-back{c[1]}")
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module", params=[CASES[0], CASES[-1]],
                ids=lambda c: f"C{c[0]}-back{c[1]}")
def pf_pair(request):
    """The filter's cases: C = 2 with one back step, C = 3 with two."""
    return _pair(request.param)


def _assert_posterior(tp, jp, rtol=RTOL):
    assert tp.distilled == jp.distilled
    for f in tsp.POSTERIOR_FIELDS:
        got, want = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        assert got.shape == want.shape and got.dtype == want.dtype, f
        assert getattr(tp, f).is_contiguous(), f
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-300, err_msg=f)


def test_fields_are_jax_order():
    assert tsp.SPARSE_PARAM_FIELDS == tuple(f.name for f in dataclasses.fields(jsp.SparseParams))
    assert tsp.POSTERIOR_FIELDS == tuple(f.name for f in dataclasses.fields(jsp.SparsePosterior)
                                         if not f.metadata.get("static"))
    assert tsp._JITTER == jsp._JITTER
    for dt in ("float32", "float64", "bfloat16"):
        assert tsp._kuu_jitter(dt) == jsp._kuu_jitter(dt)


def test_precompute_host_matches_jax(pair):
    _assert_posterior(pair.tpost, pair.jpost)


def test_kuu_jitter_follows_the_deploy_dtype(pair):
    """float64 copies of a float32 model's parameters factor with the
    float32 jitter, and the posterior deploys in float32, in both
    packages."""
    jcfg32 = pair.jcfg.replace(dtype="float32")
    tcfg32 = dataclasses.replace(pair.tcfg, dtype="float32")
    jp = jsp.precompute_host(jsp.SparseParams(**pair.sparse_arrays), pair.Y, jcfg32,
                             pair.jlayout)
    tp = tsp.precompute_host(pair.sparse_arrays, pair.Y, tcfg32, pair.tlayout, device="cpu")
    _assert_posterior(tp, jp, rtol=0)
    assert not np.allclose(tp.Ly.double().numpy(), pair.tpost.Ly.numpy(), rtol=1e-6)


def _queries(pair, n=60, seed=1):
    rng = np.random.default_rng(seed)
    X = pair.arrays["X"]
    din = pair.tpost.Zx.shape[2]
    near = X[rng.integers(0, X.shape[0], n)] + 0.05 * rng.standard_normal((n, X.shape[1]))
    near_x = np.concatenate([near] * (din // X.shape[1]), axis=1)
    near_x += 0.05 * rng.standard_normal(near_x.shape)
    far = 1.5 * rng.standard_normal((n // 5, din))
    return near, np.concatenate([near_x, far])


@pytest.mark.parametrize("with_noise", [False, True], ids=["no-noise", "noise"])
@pytest.mark.parametrize("hoisted", [False, True], ids=["trisolve", "hoisted"])
def test_predictions_match_jax(pair, hoisted, with_noise):
    qy, qx = _queries(pair)
    jq = jax.lax.Precision.HIGHEST if hoisted else None
    tq = "highest" if hoisted else None
    hi = jax.lax.Precision.HIGHEST
    calls = (
        ("predict_y", qy, dict(quad_precision=jq), dict(quad_precision=tq)),
        ("predict_x_all_classes", qx, dict(quad_precision=jq), dict(quad_precision=tq)),
        ("predict_x", qx, dict(quad_precision=jq), dict(quad_precision=tq)),
    )
    for name, q, jkw, tkw in calls:
        jmean, jvar = getattr(jsp, name)(pair.jpost, pair.jparams, jnp.asarray(q), pair.jcfg,
                                         with_noise=with_noise, precision=hi, **jkw)
        tmean, tvar = getattr(tsp, name)(pair.tpost, pair.tparams, torch.as_tensor(q),
                                         pair.tcfg, with_noise=with_noise, **tkw)
        np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=RTOL, atol=1e-12,
                                   err_msg=name)
        np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=RTOL, atol=0,
                                   err_msg=name)


def test_predict_x_for_class_matches_jax(pair):
    _, qx = _queries(pair)
    for c in range(pair.tcfg.n_classes):
        jm, jv = jsp.predict_x_for_class(pair.jpost, pair.jparams, jnp.asarray(qx), c, pair.jcfg)
        tm, tv = tsp.predict_x_for_class(pair.tpost, pair.tparams, torch.as_tensor(qx), c,
                                         pair.tcfg)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)


@pytest.mark.parametrize("method", ["stride", "kmeans"])
@pytest.mark.parametrize("mx", [None, 500], ids=["Mx-default", "Mx-clamped"])
def test_distill_host_matches_jax(pair, method, mx):
    jp, tp = pair.distilled(n_inducing_y=MY, n_inducing_x=mx, method=method)
    assert tp.distilled and jp.distilled
    want_mx = MY if mx is None else int(np.min(pair.tlayout.class_x_counts))
    assert tp.Zx.shape[1] == want_mx and tp.Zy.shape[0] == MY
    _assert_posterior(tp, jp)


def test_distill_rejects_unknown_method(pair):
    with pytest.raises(ValueError, match="'stride' or 'kmeans'"):
        tsp.distill_host(pair.arrays, pair.Y, pair.tcfg, pair.tlayout, method="random",
                         device="cpu")


def test_c8_kmeans_entry_is_reproduced():
    """The committed c8 asset's baked kmeans-128 distillation, rebuilt
    from the checkpoint's parameters, to float32 rounding (the JAX package
    rebuilds it with a maximum difference of 0.0)."""
    m = load_model(ASSETS / "bench_model_c8.npz", device="cpu")
    baked = m._sparsified_cache[(128, None, "kmeans")]
    got = tsp.distill_host(m._lazy_host_params, m.get_Y(), m.config, m.layout, 128,
                           method="kmeans", device="cpu")
    assert got.distilled and baked.distilled
    for f in tsp.POSTERIOR_FIELDS:
        g, w = getattr(got, f), getattr(baked, f)
        assert g.dtype == w.dtype == torch.float32, f
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2 ** -23, atol=0, err_msg=f)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_noise(key, T, n):
    """JAX's own draws for T frames of n particles, and the port's copy."""
    nz = jpf._pregen_noise(key, T, n, 2, jnp.float64, jnp.float64)
    u_res = jnp.stack([jax.random.uniform(k, (), dtype=jnp.float64) for k in nz.k_res])
    return nz, tpf.PFNoise(u_trans=_t(nz.u_trans), eps_dyn=_t(nz.eps_dyn), u_res=_t(u_res))


def _to_torch_state(s) -> tpf.PFState:
    return tpf.PFState(x=_t(s.x), x_prev=_t(s.x_prev), c=_t(s.c).long(), log_w=_t(s.log_w),
                       log_lik=_t(s.log_lik))


def _transitions(C):
    T = np.full((C, C), 0.1 / (C - 1))
    np.fill_diagonal(T, 0.9)
    return np.log(T)


def _compare(ts, to, js, jo):
    np.testing.assert_array_equal(ts.c.numpy(), np.asarray(js.c))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ts.x_prev.numpy(), np.asarray(js.x_prev), rtol=1e-9, atol=1e-9)
    for f in ("class_probs", "state_mean"):
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                   rtol=1e-9, atol=1e-9, err_msg=f)
    np.testing.assert_allclose(to.log_likelihood.numpy(), np.asarray(jo.log_likelihood),
                               rtol=1e-8, err_msg="log_likelihood")
    np.testing.assert_array_equal(to.most_likely_class.numpy(),
                                  np.asarray(jo.most_likely_class))


@pytest.mark.parametrize("kind", ["native", "distilled"])
def test_ten_frames_match_jax(pf_pair, kind):
    pair = pf_pair
    if kind == "native":
        jpost, tpost = pair.jpost, pair.tpost
    else:
        jpost, tpost = pair.distilled(n_inducing_y=MY, n_inducing_x=MX, method="kmeans")
    jcfg, tcfg = JPFConfig(num_particles=P, precision="highest"), PFConfig(num_particles=P)
    assert (tpf._effective_quad_precision(tcfg, tpost) is None) == (kind == "native")
    log_T = _transitions(pair.tcfg.n_classes)
    js = jpf.pf_init(jpost, pair.jlayout.y_class_offsets, jax.random.PRNGKey(3), jcfg)
    ts = _to_torch_state(js)
    nz, tnz = _jax_noise(js.key, FRAMES, P)
    for t in range(FRAMES):
        z = pair.stream[t]
        js, jo = jpf.pf_step(js, jnp.asarray(z), jpost, pair.jparams, jnp.asarray(log_T),
                             pair.jcfg, jcfg, noise=jax.tree.map(lambda a: a[t], nz))
        ts, to = tpf.pf_step(ts, torch.as_tensor(z), tpost, pair.tparams, torch.as_tensor(log_T),
                             pair.tcfg, tcfg, noise=tpf.PFNoise(tnz.u_trans[t], tnz.eps_dyn[t],
                                                                tnz.u_res[t]))
        _compare(ts, to, js, jo)


@pytest.mark.parametrize("kind", ["native", "distilled"])
def test_ten_banked_frames_match_jax_vmap(pf_pair, kind):
    """A bank of 3 filters, one observation each, against ``jax.vmap`` of
    JAX's single-filter step."""
    pair = pf_pair
    if kind == "native":
        jpost, tpost = pair.jpost, pair.tpost
    else:
        jpost, tpost = pair.distilled(n_inducing_y=MY, n_inducing_x=MX, method="stride")
    jcfg, tcfg = JPFConfig(num_particles=P, precision="highest"), PFConfig(num_particles=P)
    log_T = jnp.asarray(_transitions(pair.tcfg.n_classes))
    js = jpf.pf_init_bank(jpost, pair.jlayout.y_class_offsets, jax.random.PRNGKey(4), jcfg, B)
    ts = _to_torch_state(js)
    noise = [_jax_noise(k, FRAMES, P) for k in js.key]
    step = jax.vmap(lambda s, z, n: jpf.pf_step(s, z, jpost, pair.jparams, log_T, pair.jcfg,
                                                jcfg, noise=n))
    for t in range(FRAMES):
        z = pair.stream[[t, t + 20, t + 40]]
        nz_t = jax.tree.map(lambda *a: jnp.stack(a), *[jax.tree.map(lambda a: a[t], n)
                                                        for n, _ in noise])
        js, jo = step(js, jnp.asarray(z), nz_t)
        tnz = tpf.PFNoise(*(torch.stack([getattr(n, f)[t] for _, n in noise])
                            for f in ("u_trans", "eps_dyn", "u_res")))
        ts, to = tpf.pf_step_bank(ts, torch.as_tensor(z), tpost, pair.tparams, _t(log_T),
                                  pair.tcfg, tcfg, noise=tnz)
        _compare(ts, to, js, jo)


@pytest.mark.parametrize("distilled", [False, True], ids=["native", "distilled"])
@pytest.mark.parametrize("quad", [None, "trisolve", "default", "high", "highest"])
def test_variance_path_choice_matches_jax(quad, distilled):
    post = tsp.SparsePosterior(*([torch.zeros(1)] * len(tsp.POSTERIOR_FIELDS)),
                               distilled=distilled)
    jpost = jsp.SparsePosterior(*([jnp.zeros(1)] * len(tsp.POSTERIOR_FIELDS)),
                                distilled=distilled)
    got = tpf._effective_quad_precision(PFConfig(quad_precision=quad), post)
    want = jpf._effective_quad_precision(JPFConfig(quad_precision=quad), jpost)
    assert (got is None) == (want is None)
    assert got is None or got == {None: "high"}.get(quad, quad)
