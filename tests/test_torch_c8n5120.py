"""The c8n5120 deployment against the benchmark's plain reference, on the
CPU at a small seeded size.

c8n5120 (``perfbench/configs/c8n5120.json``) is an exact GPMDM of C = 8
classes, D = 35, d = 4, served by the persisted k-means SGPR distillation
that its checkpoint's deployment recommendation names, on the hoisted
variance path (the filter's default for a distilled posterior).  Here the
same model at a small size: 8 classes x 1 sequence of 16 frames of the
class-signature generator (Ny = 128, 15 dynamics pairs a class), seeded
random hyperparameters and latents, My = Mx = 12.  The reference is
``perfbench/reference/gp.py``'s SGPR posterior on the distillation's
inducing inputs and ``perfbench/reference/pf.py``, both in float64.

- float64: ``distill_host(method='kmeans')`` with its hoisted
  ``predict_y`` and ``predict_x_all_classes``, and four ``pf_step_bank``
  frames with injected ``PFNoise``, each from the program's state.
- float32: the checkpoint saved with its distillation and recommendation
  and loaded as the benchmark loads it (``perfbench/system.py``: 'auto'
  serves the persisted distillation, no exact posterior is built), the
  same comparisons against the float64 reference.
- the span ``sgpr.hoisted`` counts 2 calls a bank step on the distillation
  and 0 on a sparse model's own posterior (the per-frame solve path);
  under ``torch.profiler`` it is a host operation inside ``pf.dynamics``
  and ``pf.observation``.
"""

import dataclasses
import types

import numpy as np
import pytest
import threadpoolctl
import torch
from torch.profiler import ProfilerActivity, profile

from gpmdm_tpu_torch import GPMDM, PFConfig
from gpmdm_tpu_torch.data import synthetic
from gpmdm_tpu_torch.filter import particle_filter as tpf
from gpmdm_tpu_torch.models import core, sparse
from gpmdm_tpu_torch.utils import profiling
from gpmdm_tpu_torch.utils.io import load_model
from perfbench import harness, system
from perfbench.reference import gp as ref_gp
from perfbench.reference import pf as ref_pf

CFG = harness.load_json("configs", "c8n5120")
C, D, d = CFG["n_classes"], CFG["D"], CFG["d"]
SEQ_LEN, M = 16, 12
B, PB, FRAMES = 3, 200, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS and OpenMP thread: idle pool threads spinning between
    calls would take cores from the suite's other workers."""
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def c8(tmp_path_factory):
    """The small model trained nowhere: seeded hyperparameters around the
    initial ones and seeded latents around PCA's, saved as a float32
    checkpoint with its k-means distillation and the recommendation that
    names it; the checkpoint read as the reference reads it; the program's
    float64 distillation of the same parameters."""
    tr, tl, _, _ = synthetic.make_dataset(
        n_classes=C, n_train_seqs=1, n_test_seqs=1, seq_len=SEQ_LEN, D=D,
        center_spread=CFG["streams"]["center_spread"],
        class_signature=CFG["streams"]["class_signature"], seed=21)
    m = GPMDM(D=D, d=d, n_classes=C, y_sigma_n_init=0.1, x_sigma_n_init=0.1,
              sigma_n_num_Y=1e-3, sigma_n_num_X=1e-3, device="cpu")
    for Y, c in zip(tr, tl):
        m.add_data(Y, c)
    m.init_X()
    rng = np.random.default_rng(21)
    host = {f: getattr(m.params, f).detach().double().numpy() for f in core.PARAM_FIELDS}
    for f in core.PARAM_FIELDS[:-1]:
        host[f] = host[f] + rng.normal(0.0, 0.2, np.shape(host[f]))
    host["X"] = host["X"] + 0.05 * rng.normal(size=host["X"].shape)
    m.set_params(host)
    m.sparsified_posterior(M, method="kmeans")
    m._deploy_recommendation = {"family": "sparsified", "M": M, "method": "kmeans"}
    path = tmp_path_factory.mktemp("c8") / "model.npz"
    m.save(str(path))
    asset = ref_gp.load_asset(path)
    cfg64 = m.config.replace(dtype="float64")
    with pytest.MonkeyPatch.context() as mp:
        # the float32 model's Kuu jitter, which the reference takes, in the
        # program's float64 path
        mp.setitem(sparse._KUU_JITTER, "float64", sparse._KUU_JITTER["float32"])
        post64 = sparse.distill_host(asset["params"], m.get_Y(), cfg64, m.layout,
                                     n_inducing_y=M, method="kmeans", device="cpu")
    params64 = core.GPMDMParams(**{f: torch.as_tensor(asset["params"][f])
                                   for f in core.PARAM_FIELDS})
    ref = ref_gp.SparsePosterior(asset, "cpu", "float64",
                                 inducing=(post64.Zy.numpy(), post64.Zx.numpy()))
    Y = torch.as_tensor(np.asarray(m.get_Y()), dtype=torch.float64)
    T = np.full((C, C), 0.1 / (C - 1))
    np.fill_diagonal(T, 0.9)
    return types.SimpleNamespace(path=path, asset=asset, layout=m.layout, cfg64=cfg64,
                                 post64=post64, params64=params64, ref=ref, Y=Y, T=T)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _queries(c8, n=120, seed=3):
    """Points near the latents, where the filter's particles live."""
    g = torch.Generator().manual_seed(seed)
    X = c8.post64.X
    return (X[torch.randint(0, X.shape[0], (n,), generator=g)]
            + 0.05 * torch.randn(n, d, generator=g, dtype=torch.float64))


def _gaps(c8, post, params, cfg, x):
    """The program's hoisted predictions at x against the reference's:
    the means' largest gap over the largest mean; the variances' largest
    gap over the prior variance k(x, x) / lambda^2 at the same point, the
    scale of the terms whose difference the variance is."""
    ref, h = c8.ref, c8.ref.h
    xp = x.to(post.Zy.dtype)
    m_y, v_y = sparse.predict_y(post, params, xp, cfg, with_noise=True, quad_precision="high")
    kss_y = torch.full((x.shape[0],), 1.0 + h.y_sn2, dtype=torch.float64)
    mr_y, vc_y = ref._predict(ref_gp.rbf(ref.Zy, x, h.y_inv_ls), kss_y, *ref.y)
    prior_y = kss_y[:, None] / h.y_lam2
    m_x, v_x = sparse.predict_x_all_classes(post, params, xp, cfg, quad_precision="high")
    mr_x, vr_x = ref.dynamics(x)
    prior_x = ref_gp.x_diag(x, h.x_lin_w2)[None, :, None] / h.x_lam2
    return {"y_mean": _rel(m_y, mr_y),
            "y_var": float(((v_y.double() - vc_y[:, None] / h.y_lam2).abs() / prior_y).max()),
            "x_mean": _rel(m_x, mr_x),
            "x_var": float(((v_x.double() - vr_x).abs() / prior_x).max())}


def test_distillation_is_the_persisted_kmeans_entry(c8):
    """The checkpoint's persisted entry is the program's float64 k-means
    distillation of the same parameters, rounded to float32."""
    (entry,) = c8.asset["entries"]["sparsified"]
    assert entry["key"] == (M, None, "kmeans")
    assert c8.post64.distilled and c8.post64.Zx.shape == (C, M, d)
    for got, want in ((entry["Zy"], c8.post64.Zy), (entry["Zx"], c8.post64.Zx)):
        assert np.abs(got - want.numpy()).max() <= 1e-6 * np.abs(want.numpy()).max()


def test_hoisted_predictions_match_reference_float64(c8):
    gaps = _gaps(c8, c8.post64, c8.params64, c8.cfg64, _queries(c8))
    # the same float64 mathematics on both sides: the variance is a
    # difference of terms of the prior's size, so it keeps ~1e-12 of it
    assert max(gaps.values()) < 1e-9, gaps


def _deployed(c8):
    """The float32 checkpoint as the benchmark deploys it."""
    model = load_model(c8.path, "cpu")
    sut = system.FilterSystem(model, c8.T, PB, CFG["filter"])
    return model, sut


def test_auto_serves_the_persisted_distillation(c8):
    model, sut = _deployed(c8)
    assert sut.deployment() == {"family": "sparsified", "My": M, "Mx": M}
    assert sut.post is model._sparsified_cache[(M, None, "kmeans")]
    assert model._posterior is None  # no exact posterior was built
    assert tpf._effective_quad_precision(sut.pf_cfg, sut.post) == "high"


def test_hoisted_predictions_match_reference_float32(c8):
    model, sut = _deployed(c8)
    gaps = _gaps(c8, sut.post, model.params, model.config, _queries(c8))
    # float32 factors and products: float32's 6e-8, raised by the
    # dynamics Kuu's condition (3e3..7.3e4 here), read <= 6.6e-5 in the
    # means and <= 6.1e-5 of the prior in the variances; TF32's 4.9e-4
    # would not pass
    assert gaps["y_mean"] < 2e-4 and gaps["x_mean"] < 2e-4, gaps
    assert gaps["y_var"] < 2e-4 and gaps["x_var"] < 2e-4, gaps


def _frames(c8, state, step, post_dtype, tol, moved_at):
    """FRAMES bank steps by ``step`` against the float64 reference filter,
    each from the program's state before it (apart, two filters drift
    through the draws).  Each bank sees frames halfway between two
    classes' training frames, so that its class probabilities are spread
    and not saturated at 0 and 1; ``tol`` bounds the class probabilities'
    and the latent mean's gaps, ``moved_at`` a particle's distance that
    counts as another particle."""
    T = torch.as_tensor(c8.T)
    g = torch.Generator().manual_seed(11)
    offs = c8.layout.y_class_offsets
    for t in range(FRAMES):
        draws = (torch.rand(B, PB, generator=g, dtype=torch.float64),
                 torch.randn(B, PB, d, generator=g, dtype=torch.float64),
                 torch.rand(B, generator=g, dtype=torch.float64))
        z = 0.5 * (c8.Y[[int(offs[k]) + 2 + t for k in (0, 3, 6)]]
                   + c8.Y[[int(offs[k + 1]) + 2 + t for k in (0, 3, 6)]])
        x, c, probs, mean = ref_pf.step(c8.ref, state.x, state.c, z, *draws, T)
        state, out = step(state, z.to(post_dtype),
                          tpf.PFNoise(*(a.to(post_dtype) for a in draws)))
        assert _rel(out.class_probs, probs) < tol
        assert _rel(out.state_mean, mean) < tol
        # resampling picks the same particles but for a rare boundary case,
        # where two neighbours both copy one parent and differ by its draw
        moved = (state.x.double() - x).abs().amax(-1) > moved_at
        assert torch.equal(state.c, c) and float(moved.double().mean()) < 0.02


def test_filter_frames_match_reference_float64(c8):
    pf_cfg = PFConfig(num_particles=PB, **CFG["filter"])
    g = torch.Generator().manual_seed(5)
    state = tpf.pf_init_bank(c8.post64, c8.layout.y_class_offsets, g, pf_cfg, B)
    log_T = torch.log(torch.as_tensor(c8.T))

    def step(s, z, noise):
        return tpf.pf_step_bank(s, z, c8.post64, c8.params64, log_T, c8.cfg64, pf_cfg,
                                noise=noise)

    # float64 on both sides: probabilities and means read <= 1.6e-12,
    # particles <= 1e-11 apart (the draws' square roots carry the rounding)
    _frames(c8, state, step, torch.float64, 1e-9, 1e-6)


def test_filter_frames_match_reference_float32(c8):
    model, sut = _deployed(c8)
    state = sut.init(B, torch.Generator().manual_seed(5))
    # the float32 predictions' gaps (above) move each particle's
    # likelihood: class probabilities read <= 4.2e-5 of the largest, the
    # latent mean <= 1.8e-4; particles lie <= 9.6e-4 apart at the 99th
    # percentile (the float32 latents' and draws' rounding), and <= 0.5%
    # of them move past 1e-2
    _frames(c8, state, sut.step, torch.float32, 1e-3, 1e-2)


@pytest.mark.parametrize("distilled", [True, False], ids=["distilled", "own"])
def test_step_counts_hoisted_calls(c8, distilled):
    """Two hoisted predictions a bank step on a distillation (the
    observation GP once, every class's dynamics GP once), none on a sparse
    model's own posterior, which takes the per-frame solve path."""
    post = dataclasses.replace(c8.post64, distilled=distilled)
    pf_cfg = PFConfig(num_particles=PB, **CFG["filter"])
    g = torch.Generator().manual_seed(7)
    state = tpf.pf_init_bank(post, c8.layout.y_class_offsets, g, pf_cfg, B)
    profiling.reset()
    tpf.pf_step_bank(state, c8.Y[:B], post, c8.params64, torch.log(torch.as_tensor(c8.T)),
                     c8.cfg64, pf_cfg, generator=g)
    calls = profiling.snapshot()["spans"].get("sgpr.hoisted", {"calls": 0})["calls"]
    assert calls == (2 if distilled else 0)


def test_hoisted_span_is_a_cpu_op_inside_its_stages(c8):
    pf_cfg = PFConfig(num_particles=PB, **CFG["filter"])
    g = torch.Generator().manual_seed(9)
    state = tpf.pf_init_bank(c8.post64, c8.layout.y_class_offsets, g, pf_cfg, B)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tpf.pf_step_bank(state, c8.Y[:B], c8.post64, c8.params64,
                         torch.log(torch.as_tensor(c8.T)), c8.cfg64, pf_cfg, generator=g)
    hoisted = [e for e in prof.events() if e.name == "sgpr.hoisted"]
    assert len(hoisted) == 2
    assert all(e.device_type == torch.autograd.DeviceType.CPU and not e.is_user_annotation
               for e in hoisted)
    assert sorted(e.cpu_parent.name for e in hoisted) == ["pf.dynamics", "pf.observation"]
