"""The reference against the program's plain path on the CPU: the
program's float64 path computes the same mathematics, so the two agree to
rounding; the float32 model's jitters are put into the program's float64
path where its dtype would drop them."""

import math

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import gp as ref_gp
from perfbench.reference import pf as ref_pf

ASSETS = "bench_assets/bench_model_{}.npz"


def _asset(name):
    return ref_gp.load_asset(harness.REPO / ASSETS.format(name))


def _model64(name):
    from gpmdm_tpu_torch.utils.io import load_model

    return load_model(harness.REPO / ASSETS.format(name), "cpu")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.fixture(scope="module")
def d4():
    from gpmdm_tpu_torch.models import core

    asset = _asset("d4")
    model = _model64("d4")
    cfg64 = model.config.replace(dtype="float64")
    hp = {f: asset["params"][f] for f in core.PARAM_FIELDS}
    post = core.precompute_host(hp, model.get_Y(), cfg64, model.layout, "cpu")
    params = core.GPMDMParams(**{f: torch.as_tensor(asset["params"][f])
                                 for f in core.PARAM_FIELDS})
    return asset, model, cfg64, post, params


def test_exact_posterior_matches_program(d4):
    from gpmdm_tpu_torch.config import PFConfig
    from gpmdm_tpu_torch.filter import particle_filter as pf

    asset, model, cfg64, post, params = d4
    g = torch.Generator().manual_seed(0)
    x = post.X[torch.randint(0, post.X.shape[0], (64,), generator=g)] \
        + 0.01 * torch.randn(64, 4, generator=g, dtype=torch.float64)
    ref = ref_gp.posterior(asset, "cpu")
    m_p, v_p = pf._dynamics(post, params, x.contiguous(), cfg64, PFConfig(pallas="off"))
    m_r, v_r = ref.dynamics(x)
    # the variance is a difference of terms ~20 that leaves ~1e-7..1e-3
    assert _rel(m_p, m_r) < 1e-9 and _rel(v_p, v_r) < 1e-5
    z = torch.as_tensor(np.asarray(model.get_Y()[:2]), dtype=torch.float64)
    ll_p = pf._observation_log_lik(post, params, x, z, cfg64, PFConfig(pallas="off"))
    ll_r = ref.log_lik(x.reshape(2, 32, 4), z)
    assert _rel(ll_p.reshape(2, 32), ll_r) < 1e-9


def test_filter_step_matches_program(d4):
    from gpmdm_tpu_torch.config import PFConfig
    from gpmdm_tpu_torch.filter import particle_filter as pf

    asset, model, cfg64, post, params = d4
    B, Pb = 3, 200
    pf_cfg = PFConfig(num_particles=Pb, pallas="off")
    g = torch.Generator().manual_seed(1)
    state = pf.pf_init_bank(post, model.layout.y_class_offsets, g, pf_cfg, B)
    T = np.array([[0.9, 0.1], [0.1, 0.9]])
    log_T = torch.log(torch.as_tensor(T))
    ref = ref_gp.posterior(asset, "cpu")
    Y = torch.as_tensor(np.asarray(model.get_Y()), dtype=torch.float64)
    for t in range(4):
        d = (torch.rand(B, Pb, generator=g, dtype=torch.float64),
             torch.randn(B, Pb, 4, generator=g, dtype=torch.float64),
             torch.rand(B, generator=g, dtype=torch.float64))
        z = Y[[10 + t, 130 + t, 250 + t]]
        # each step from the program's state before it: apart, two float64
        # filters drift through the draws' square roots of variances ~3e-7
        x, c, probs, mean = ref_pf.step(ref, state.x, state.c, z, *d, torch.as_tensor(T))
        state, out = pf.pf_step_bank(state, z, post, params, log_T, cfg64, pf_cfg,
                                     noise=pf.PFNoise(*d))
        # the dynamics variance is ~3e-7 as a difference of terms ~20: its
        # float64 rounding, through the draw's square root, reaches ~1e-8
        assert _rel(out.class_probs, probs) < 1e-6
        assert _rel(out.state_mean, mean) < 1e-6
        # resampling picks the same particles but for a rare boundary case,
        # where two neighbours both copy one parent and differ by its draw
        moved = (state.x - x).abs().amax(-1) > 1e-5
        assert torch.equal(state.c, c) and float(moved.double().mean()) < 0.01


def test_sparse_posterior_matches_program(monkeypatch):
    from gpmdm_tpu_torch.models import sparse

    # the float32 model's Kuu jitter in the program's float64 path
    monkeypatch.setitem(sparse._KUU_JITTER, "float64", 1e-4)
    asset = _asset("sparse10240")
    model = _model64("sparse10240")
    cfg64 = model.config.replace(dtype="float64")
    hp = {f: asset["params"][f] for f in sparse.SPARSE_PARAM_FIELDS}
    post = sparse.precompute_host(hp, model.get_Y(), cfg64, model.layout, "cpu")
    params = sparse.SparseParams.from_numpy(hp, torch.float64, "cpu")
    ref = ref_gp.posterior(asset, "cpu")
    g = torch.Generator().manual_seed(2)
    x = post.X[torch.randint(0, post.X.shape[0], (40,), generator=g)]
    m_p, v_p = sparse.predict_x_all_classes(post, params, x, cfg64)
    m_r, v_r = ref.dynamics(x)
    assert _rel(m_p, m_r) < 1e-7 and _rel(torch.clamp(v_p, min=1e-12),
                                          torch.clamp(v_r, min=1e-12)) < 1e-6
    z = torch.as_tensor(np.asarray(model.get_Y()[:2]), dtype=torch.float64)
    mean, var = sparse.predict_y(post, params, x, cfg64, with_noise=True)
    var = torch.clamp(var, min=1e-12).reshape(2, 20, -1)
    resid = z[:, None, :] - mean.reshape(2, 20, -1)
    ll_p = (-0.5 * torch.sum(resid ** 2 / var, 2) - 0.5 * torch.sum(torch.log(var), 2)
            - 0.5 * z.shape[1] * math.log(2 * math.pi))
    assert _rel(ll_p, ref.log_lik(x.reshape(2, 20, 2), z)) < 1e-7
