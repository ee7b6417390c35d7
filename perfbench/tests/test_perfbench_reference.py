"""The reference against the program's plain path on the CPU: the
program's float64 path computes the same mathematics, so the two agree to
rounding; the float32 model's jitters are put into the program's float64
path where its dtype would drop them.  And the posterior the reference
builds for a configuration's family against the one the program deploys
from the same asset."""

import dataclasses
import json
import math
import warnings

import numpy as np
import pytest
import torch

from perfbench import bank, harness, system
from perfbench.reference import gp as ref_gp
from perfbench.reference import pf as ref_pf

ASSETS = "bench_assets/bench_model_{}.npz"
D4 = {"name": "walkrun_d4", "family": "exact"}


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
    ref = ref_gp.posterior(asset, "cpu", "float64", D4)
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
    ref = ref_gp.posterior(asset, "cpu", "float64", D4)
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
    ref = ref_gp.posterior(asset, "cpu", "float64", {"name": "sparse10240", "family": "sparse"})
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


#: One case per family: the asset, the configuration's deployment, and
#: whether the reference must agree with what the program deploys.  The
#: last case is the mismatch that the family removes: the exact reference
#: held to the distillation that c8's recommendation deploys.
FAMILIES = {
    "exact": ("d4", {"family": "exact"}, True),
    "sparse": ("sparse10240", {"family": "sparse", "My": 128, "Mx": 128}, True),
    "sparsified": ("c8", {"family": "sparsified", "My": 128, "Mx": 118, "method": "kmeans"},
                   True),
    "compressed": ("n2048", {"family": "compressed", "rank_y": 148, "rank_x": 113}, True),
    "exact_held_to_distilled": ("c8", {"family": "exact"}, False),
}
#: Means: the largest gap over the largest mean.  Variances: the largest
#: gap over the prior variance k(x, x) / lambda^2 at the same point, the
#: scale of the terms whose difference the variance is.  The persisted
#: float32 factors, widened, carry their rounding (6e-8), raised by their
#: conditioning: read at <= 6.3e-6 and <= 1.4e-6, and the observations'
#: log-likelihoods (largest gap over the largest) at <= 3.8e-5; the exact
#: posterior, factored in float64, reads 3e-12, 2e-9 and 3e-11; the exact
#: reference held to c8's distillation reads 1.4e-2 and 2.8e-2.
TOL_MEAN, TOL_VAR = 1e-4, 1e-4


def _widened(post):
    """The deployed posterior's factors as float64 tensors."""
    fields = {f.name: getattr(post, f.name) for f in dataclasses.fields(post)}
    return type(post)(**{k: v.double() if torch.is_tensor(v) else v for k, v in fields.items()})


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_family_posterior_is_the_programs(case, monkeypatch):
    """What ``io.load_model`` and ``resolve_posterior(model, 'auto')``
    deploy, against what the reference builds for the family."""
    from gpmdm_tpu_torch.config import PFConfig
    from gpmdm_tpu_torch.filter import particle_filter as pf
    from gpmdm_tpu_torch.models import core, sparse

    name, dep, agree = FAMILIES[case]
    cfg = {"name": name, **dep}
    asset = _asset(name)
    model = _model64(name)
    cfg64 = model.config.replace(dtype="float64")
    if case == "exact":
        # the exact posterior is factored in float64 and then cast; cast to
        # float32, its dynamics variance has no correct digits, so it is
        # compared as it is factored, before the cast (set before its
        # deferred build)
        model.config = cfg64
    if case == "sparse":
        # sparse10240's (and hourlong's) persisted factors were made at
        # float64's Kuu jitter, not the float32 model's that the reference
        # takes; PERF.md's open questions hold the gap
        monkeypatch.setattr(ref_gp, "KUU_JITTER_F32", 1e-6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sut = system.FilterSystem(model, np.eye(asset["cfg"]["n_classes"]), 100, {})
    if agree:
        assert sut.deployment() == {k: cfg.get(k) for k in sut.deployment()}
    post = _widened(sut.post)
    fields = sparse.SPARSE_PARAM_FIELDS if dep["family"] == "sparse" else core.PARAM_FIELDS
    params = type(model.params)(**{f: torch.as_tensor(asset["params"][f]) for f in fields})
    ref = ref_gp.posterior(asset, "cpu", "float64", cfg)

    g = torch.Generator().manual_seed(3)
    X = torch.as_tensor(asset["params"]["X"])
    x = X[torch.randint(0, X.shape[0], (120,), generator=g)] \
        + 0.05 * torch.randn(120, X.shape[1], generator=g, dtype=torch.float64)
    m_p, v_p = pf._dynamics(post, params, x.contiguous(), cfg64, PFConfig(pallas="off"))
    m_r, v_r = ref.dynamics(x)
    prior = ref_gp.x_diag(x, ref.h.x_lin_w2)[None, :, None] / ref.h.x_lam2
    gaps = (_rel(m_p, m_r), float(((v_p - v_r).abs() / prior).max()))
    if agree:
        assert gaps[0] < TOL_MEAN and gaps[1] < TOL_VAR, gaps
        # the observation GP: the log-likelihood of observations near x
        Y = torch.as_tensor(np.concatenate([s for q in asset["seqs"] for s in q]),
                            dtype=torch.float64)
        z = Y[torch.randint(0, Y.shape[0], (4,), generator=g)]
        ll_p = pf._observation_log_lik(post, params, x, z, cfg64, PFConfig(pallas="off"))
        assert _rel(ll_p.reshape(4, 30), ref.log_lik(x.reshape(4, 30, -1), z)) < TOL_MEAN
    else:
        assert gaps[0] > 10 * TOL_MEAN and gaps[1] > 10 * TOL_VAR, gaps


def _c8_as_exact(tmp_path, monkeypatch) -> dict:
    """A temporary configuration that states 'exact' for the c8 asset,
    whose recommendation deploys a distillation."""
    path = harness.REPO / ASSETS.format("c8")
    asset = _asset("c8")
    cfg = {**harness.load_json("configs", "walkrun_d4"), "name": "c8_exact", "family": "exact",
           "asset": ASSETS.format("c8"), "asset_sha256": harness.sha256(path), "D": 10, "d": 3,
           "n_classes": 8, "Ny": int(ref_gp.class_row_offsets(asset)[-1]), "n_max": 118,
           "streams": {"trial_len": 60, "D": 10, "noise": 0.02, "center_spread": 3.0,
                       "class_signature": 1.0}}
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "c8_exact.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    return cfg


@pytest.mark.parametrize("where", ["load_config", "setup"])
def test_refuses_a_family_the_asset_does_not_deploy(where, tmp_path, monkeypatch):
    cfg = _c8_as_exact(tmp_path, monkeypatch)
    if where == "load_config":
        with pytest.raises(RuntimeError, match="recommendation"):
            harness.load_config("c8_exact")
        return
    mix = {"streams": 2, "particles": 16, "stay_prob": 0.9, "frames_per_stream": 60}
    model = system.load_model(harness.REPO / cfg["asset"], "cpu")
    with pytest.raises(RuntimeError, match="deployed"):
        bank.setup(model, cfg, _asset("c8"), mix, 5, "cpu", lambda kind, fn: fn, ref_pf)
