"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``gpu`` marker and skips inside its body when no
CUDA card is present.  The file imports no JAX, so it also runs on the
machine with the card, which has none:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
Tolerance rtol 1e-4, atol 1e-4: both sides run in fp32 and sum in
different orders over up to 530 terms.  Past that (N up to 5,120), each
output is held against the plain version run in float64, within the
bound ``_fp32_bounds`` puts on any fp32 evaluation's error (2 N u times
the sum of the terms' magnitudes).  The resampling rank counts
integers, so kernel and plain version must agree exactly.
"""

import numpy as np
import pytest
import torch

from gpmdm_tpu_torch.ops import gp_posterior as tgp
from gpmdm_tpu_torch.ops import resample as rs

D_OUT = 5
CASES = [(37, 50, 2), (130, 300, 3), (37, 300, 3), (300, 50, 2), (480, 10_000, 2),
         (530, 70, 2)]


def _inputs(N, P, d, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    M = rng.normal(size=(N, N))
    return dict(
        Xt=rng.normal(size=(N, d)).astype(f32),
        Xs=rng.normal(size=(P, d)).astype(f32),
        A=rng.normal(size=(N, D_OUT)).astype(f32),
        Kinv=(M @ M.T / N + np.eye(N)).astype(f32),
        inv_ls=np.exp(0.3 * rng.normal(size=d)).astype(f32),
        lin_w=np.exp(0.3 * rng.normal(size=d + 1)).astype(f32),
        z=rng.normal(size=D_OUT).astype(f32),
        lam2=np.exp(rng.normal(size=D_OUT)).astype(f32),
    )


def _t(a, device):
    return torch.as_tensor(a, device=device)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("N,P,d", CASES)
def test_cuda_kernels_match_plain(N, P, d):
    dev = _cuda_or_skip()
    x = _inputs(N, P, d, seed=7)
    t = {k: _t(v, dev) for k, v in x.items()}
    tgp.reset_launches()
    pairs = [
        (tgp.fused_rbf_posterior, tgp.fused_rbf_posterior_plain, ("Xt", "Xs", "A", "Kinv", "inv_ls"), ()),
        (tgp.fused_x_posterior, tgp.fused_x_posterior_plain,
         ("Xt", "Xs", "A", "Kinv", "inv_ls", "lin_w"), (N - 3,)),
        (tgp.fused_obs_loglik, tgp.fused_obs_loglik_plain,
         ("Xt", "Xs", "A", "Kinv", "inv_ls", "z", "lam2"), ()),
    ]
    for kernel, plain, keys, extra in pairs:
        args = [t[k] for k in keys] + list(extra)
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    assert tgp.LAUNCHES == {"fused_x_posterior": 1, "fused_rbf_posterior": 1,
                            "fused_obs_loglik": 1}


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_inputs():
    dev = _cuda_or_skip()
    x = _inputs(20, 10, 2, seed=8)
    t = {k: _t(v, dev) for k, v in x.items()}
    keys = ("Xt", "Xs", "A", "Kinv", "inv_ls")
    with pytest.raises(TypeError, match="float32"):
        tgp.fused_rbf_posterior(*(t[k].double() for k in keys))
    with pytest.raises(ValueError, match="contiguous"):
        tgp.fused_rbf_posterior(t["Xt"], t["Xs"], t["A"], t["Kinv"].T, t["inv_ls"])


def _fp32_bounds(Xt, Xs, A, Kinv, inv_ls, lin_w=None, n_valid=None, z=None, lam2=None):
    """Elementwise bounds on any fp32 evaluation's error, in any order of
    summation: 2 N u sum|terms| for the mean and the quad (N terms a sum,
    plus the star kernel's own rounding), u = 2^-24, and what the mean's
    bound does to qres."""
    d = lambda t: t.double()  # noqa: E731
    N = Xt.shape[0]
    if lin_w is None:
        ks = tgp._star_plain(d(Xt * inv_ls), d(Xs * inv_ls), N)
    else:
        w = d(lin_w[:-1])
        ks = tgp._star_plain(d(Xt) * d(inv_ls), d(Xs) * d(inv_ls), n_valid, d(Xt) * w,
                             d(Xs) * w, d(lin_w[-1]) ** 2)
    ks = ks.abs()
    g = 2 * N * 2.0 ** -24
    mean_b = g * (ks.T @ d(A).abs())
    quad_b = g * torch.sum(ks * (d(Kinv).abs() @ ks), dim=0)
    if z is None:
        return mean_b, quad_b
    mean = tgp.fused_rbf_posterior_plain(*(d(t) for t in (Xt, Xs, A, Kinv, inv_ls)))[0]
    qres_b = torch.sum(d(lam2) * (2 * (mean - d(z)).abs() + mean_b) * mean_b, dim=1)
    return quad_b, qres_b


@pytest.mark.gpu
@pytest.mark.parametrize("N", [236, 1100, 2048, 5120])
def test_cuda_wrappers_refuse_only_star_tiles_that_do_not_fit(N):
    """No star tile is held any more, so both wrappers take every N, up to
    the n5120 asset's Ny, and match their plain versions run in float64:
    each output within the fp32 summation bound of ``_fp32_bounds``."""
    dev = _cuda_or_skip()
    x = _inputs(N, 40, 2, seed=9)
    t = {k: _t(v, dev) for k, v in x.items()}
    base = [t[k] for k in ("Xt", "Xs", "A", "Kinv", "inv_ls")]
    calls = [
        (tgp.fused_x_posterior, tgp.fused_x_posterior_plain, base + [t["lin_w"], N - 5],
         dict(lin_w=t["lin_w"], n_valid=N - 5)),
        (tgp.fused_obs_loglik, tgp.fused_obs_loglik_plain, base + [t["z"], t["lam2"]],
         dict(z=t["z"], lam2=t["lam2"])),
    ]
    for kernel, plain, args, extra in calls:
        got = kernel(*args)
        ref64 = plain(*[a.double() if torch.is_tensor(a) else a for a in args])
        bounds = _fp32_bounds(*base, **extra)
        torch.cuda.synchronize()
        for g, r64, b in zip(got, ref64, bounds):
            assert torch.isfinite(g).all()
            assert torch.all((g.double() - r64).abs() <= b + 1e-6)


def _systematic_s(rng, B, Pb, alpha=0.3):
    """s of systematic resampling from seeded Dirichlet weights."""
    w = rng.dirichlet(np.full(Pb, alpha), size=B).astype(np.float32)
    cum = np.cumsum(w, axis=1, dtype=np.float32)
    u = rng.random((B, 1)).astype(np.float32)
    return np.clip(np.floor(Pb * cum - u).astype(np.int64) + 1, 0, Pb).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Pb", [(1, 10_000), (12, 10_000), (64, 1000), (1, 100_000),
                                  (3, 50_001)])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_cuda_resample_rank_matches_plain(B, Pb, order):
    dev = _cuda_or_skip()
    rng = np.random.default_rng(B * Pb)
    s = _systematic_s(rng, B, Pb)
    if order == "unsorted":
        s = rng.permuted(s, axis=1)
    st = torch.as_tensor(s, device=dev)
    rs.reset_launches()
    got = rs.resample_rank(st)
    want = rs.resample_rank_plain(st)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == (B, Pb)
    assert torch.equal(got, want)
    assert rs.LAUNCHES == {"resample_rank": 1}


@pytest.mark.gpu
def test_cuda_banked_obs_loglik_matches_plain():
    dev = _cuda_or_skip()
    nb, pb = 3, 10_000
    x = _inputs(480, nb * pb, 2, seed=10)
    t = {k: _t(v, dev) for k, v in x.items()}
    z = _t(np.random.default_rng(11).normal(size=(nb, D_OUT)).astype(np.float32), dev)
    args = [t[k] for k in ("Xt", "Xs", "A", "Kinv", "inv_ls")] + [z, t["lam2"]]
    got = tgp.fused_obs_loglik(*args)
    want = tgp.fused_obs_loglik_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    # each bank against its own observation, one bank at a time
    for b in range(nb):
        sl = slice(b * pb, (b + 1) * pb)
        one = tgp.fused_obs_loglik(*args[:1], t["Xs"][sl].contiguous(), *args[2:5], z[b],
                                   t["lam2"])
        torch.testing.assert_close(got[1][sl], one[1], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_wrappers_take_unaligned_views():
    """Contiguous views whose data start off a 16-byte boundary (N and Pb
    multiples of 4, so only the base pointer is off) take the kernels'
    scalar loads and match the plain versions."""
    dev = _cuda_or_skip()
    N, P, d = 128, 300, 2
    x = _inputs(N, P, d, seed=12)
    t = {k: _t(v, dev) for k, v in x.items()}
    kinv = torch.empty(N * N + 1, device=dev)[1:].view(N, N)
    kinv.copy_(t["Kinv"])
    assert kinv.is_contiguous() and kinv.data_ptr() % 16
    t["Kinv"] = kinv
    pairs = [
        (tgp.fused_rbf_posterior, tgp.fused_rbf_posterior_plain, ("Xt", "Xs", "A", "Kinv", "inv_ls"), ()),
        (tgp.fused_x_posterior, tgp.fused_x_posterior_plain,
         ("Xt", "Xs", "A", "Kinv", "inv_ls", "lin_w"), (N,)),
        (tgp.fused_obs_loglik, tgp.fused_obs_loglik_plain,
         ("Xt", "Xs", "A", "Kinv", "inv_ls", "z", "lam2"), ()),
    ]
    for kernel, plain, keys, extra in pairs:
        args = [t[k] for k in keys] + list(extra)
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    B, Pb = 2, 4096
    s = torch.as_tensor(_systematic_s(np.random.default_rng(13), B, Pb), device=dev)
    s_view = torch.empty(B * Pb + 1, dtype=torch.int32, device=dev)[1:].view(B, Pb)
    s_view.copy_(s)
    assert s_view.is_contiguous() and s_view.data_ptr() % 16
    assert torch.equal(rs.resample_rank(s_view), rs.resample_rank_plain(s))


@pytest.mark.gpu
def test_cuda_split_passes_repeat_exactly():
    """At 480 rows and 10,000 particles the launcher splits the passes over
    blocks, whose tickets the kernel sets back to 0: repeated calls reuse
    them and give the same bits."""
    dev = _cuda_or_skip()
    from gpmdm_tpu_torch.ops._build import library

    N, P, d = 480, 10_000, 2
    x = _inputs(N, P, d, seed=14)
    t = {k: _t(v, dev) for k, v in x.items()}
    dev = t["Xs"].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert tgp._plan(library(), "fused_obs_loglik", N, D_OUT, P, 0, dev, stream)[1] > 1
    calls = [
        (tgp.fused_obs_loglik, [t[k] for k in ("Xt", "Xs", "A", "Kinv", "inv_ls", "z", "lam2")]),
        (tgp.fused_x_posterior, [t[k] for k in ("Xt", "Xs", "A", "Kinv", "inv_ls", "lin_w")]
         + [N]),
    ]
    for kernel, args in calls:
        first = kernel(*args)
        for _ in range(4):
            again = kernel(*args)
            for a, b in zip(first, again):
                assert torch.equal(a, b)


def _class_inputs(C, N, P, d, seed):
    """C class blocks of training rows, weights and Kinv, stacked, with
    shared particles and hyperparameters, on the card."""
    dev = _cuda_or_skip()
    blocks = [_inputs(N, P if c == 0 else 1, d, seed=seed + c) for c in range(C)]
    t = {k: _t(np.stack([b[k] for b in blocks]), dev) for k in ("Xt", "A", "Kinv")}
    t.update({k: _t(blocks[0][k], dev) for k in ("Xs", "inv_ls", "lin_w")})
    return t


def _check_classes_against_f64(t, got, n_valid):
    """Each class of a class-batched K1 call within the fp32 summation
    bound of its plain version run in float64."""
    for c in range(t["Xt"].shape[0]):
        base = [t["Xt"][c], t["Xs"], t["A"][c], t["Kinv"][c], t["inv_ls"]]
        ref64 = tgp.fused_x_posterior_plain(*(a.double() for a in base), t["lin_w"].double(),
                                            n_valid)
        bounds = _fp32_bounds(*base, lin_w=t["lin_w"], n_valid=n_valid)
        for g, r64, b in zip((got[0][c], got[1][c]), ref64, bounds):
            assert torch.isfinite(g).all()
            assert torch.all((g.double() - r64).abs() <= b + 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("C,N,P,d", [
    (2, 236, 10_000, 2),    # the path: the headline's two classes, one filter
    (2, 236, 120_000, 2),   # the banked guard's 12 x 10,000
    (2, 236, 64_000, 2),    # the fleet's 64 x 1,000
    (8, 118, 10_000, 3),    # c8: eight classes, 121 columns
    (2, 236, 10_000, 4),    # d4: 240 columns
    (3, 254, 1000, 2),      # N + Dout exactly at the one-pass limit
    (2, 255, 1000, 2),      # one past it: the streamed core
])
def test_cuda_x_posterior_classes_match_plain(C, N, P, d):
    """K1 over C classes in one launch: each class within the fp32 bound of
    its float64 plain version, the same bits on a repeat call, and (on the
    one-pass design, whose plan does not depend on C) the same bits as the
    per-class call."""
    from gpmdm_tpu_torch.ops._build import library

    t = _class_inputs(C, N, P, d, seed=20)
    args = (t["Xt"], t["Xs"], t["A"], t["Kinv"], t["inv_ls"], t["lin_w"], N - 3)
    tgp.reset_launches()
    got = tgp.fused_x_posterior_classes(*args)
    assert tgp.LAUNCHES["fused_x_posterior"] == 1
    assert got[0].shape == (C, P, D_OUT) and got[1].shape == (C, P)
    _check_classes_against_f64(t, got, N - 3)
    again = tgp.fused_x_posterior_classes(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = tgp.fused_x_posterior_classes_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, plain):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    dev = t["Xs"].device
    one = tgp._plan(library(), "fused_x_posterior", N, D_OUT, P, 0, dev,
                    torch.cuda.current_stream(dev).cuda_stream, C, True)[2]
    if one:
        for c in range(C):
            one = tgp.fused_x_posterior(t["Xt"][c], t["Xs"], t["A"][c], t["Kinv"][c],
                                        t["inv_ls"], t["lin_w"], N - 3)
            assert torch.equal(one[0], got[0][c]) and torch.equal(one[1], got[1][c])


@pytest.mark.gpu
@pytest.mark.parametrize("one_pass", [True, False])
def test_cuda_x_posterior_classes_take_offset_views(one_pass):
    """Stacked class blocks whose Kinv starts off a 16-byte boundary take
    the scalar loads, on both designs, and match the aligned call."""
    C, N, P, d = 3, 128, 700, 2
    t = _class_inputs(C, N, P, d, seed=30)
    kinv = torch.empty(C * N * N + 1, device=t["Kinv"].device)[1:].view(C, N, N)
    kinv.copy_(t["Kinv"])
    assert kinv.is_contiguous() and kinv.data_ptr() % 16
    args = [t["Xt"], t["Xs"], t["A"], t["Kinv"], t["inv_ls"], t["lin_w"], N]
    want = tgp._posterior_cuda("fused_x_posterior", *args, True, one_pass=one_pass)
    args[3] = kinv
    got = tgp._posterior_cuda("fused_x_posterior", *args, True, one_pass=one_pass)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    _check_classes_against_f64(t, got, N)


def _f64(obj):
    """A dataclass of tensors copied to the CPU in float64."""
    import dataclasses

    return type(obj)(**{f.name: getattr(obj, f.name).detach().cpu().double()
                        for f in dataclasses.fields(obj)})


@pytest.mark.gpu
@pytest.mark.parametrize("asset", ["bench_model_n2048.npz", "bench_model_c8n5120.npz"])
def test_cuda_compressed_predictions_match_f64(asset):
    """The compressed posterior's predictions, all cuBLAS fp32 products on
    the card (TF32 off), against the same posterior and points in float64
    on the CPU: each output's max error within 4 x the CPU's fp32 error
    against the same float64 values, + 1e-6 x its largest magnitude.  The
    assets' own persisted caches, at their initial clouds of 4,096."""
    from pathlib import Path

    from gpmdm_tpu_torch.filter import particle_filter as pf
    from gpmdm_tpu_torch.models import compressed
    from gpmdm_tpu_torch.utils.io import load_model

    dev = _cuda_or_skip()
    assert not torch.backends.cuda.matmul.allow_tf32
    path = Path(__file__).resolve().parents[1] / "bench_assets" / asset
    m = load_model(path, device=dev)
    cp = pf.resolve_posterior(m, "compressed")
    g = torch.Generator(device=dev).manual_seed(0)
    x = pf.pf_init(cp, m.layout.y_class_offsets, g, pf.PFConfig(num_particles=4096)).x
    cfg = m.config
    cpu_cp, cpu_params = cp.to("cpu"), type(m.params)(**{
        k: v.cpu() for k, v in vars(m.params).items()})
    for name in ("predict_y", "predict_x_all_classes"):
        fn = getattr(compressed, name)
        got = fn(cp, m.params, x, cfg, with_noise=True)
        cpu32 = fn(cpu_cp, cpu_params, x.cpu(), cfg, with_noise=True)
        want = fn(_f64(cp), _f64(m.params), x.cpu().double(), cfg, with_noise=True)
        torch.cuda.synchronize()
        assert m._posterior is None
        for label, gg, c32, w in zip(("mean", "var"), got, cpu32, want):
            assert torch.isfinite(gg).all(), (name, label)
            err = (gg.cpu().double() - w).abs().max().item()
            ref = (c32.double() - w).abs().max().item()
            assert err <= 4 * ref + 1e-6 * w.abs().max().item(), (name, label, err, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("quad", [None, "high"], ids=["trisolve", "hoisted"])
@pytest.mark.parametrize("asset", ["bench_model_hourlong.npz", "bench_model_c8n5120.npz"])
def test_cuda_sparse_predictions_match_f64(asset, quad):
    """The sparse posterior's predictions on the card (cuBLAS fp32
    products and triangular solves, TF32 off) on both variance paths,
    against the same posterior and points in float64 on the CPU, to the
    rule above: 4 x the CPU's fp32 error + 1e-6 x the largest magnitude.
    hourlong's own posterior (Ny = 108,000, M = 128) and c8n5120's
    persisted distillation (M = 384, 8 classes), as 'auto' serves them,
    at their initial clouds of 4,096."""
    from pathlib import Path

    from gpmdm_tpu_torch.filter import particle_filter as pf
    from gpmdm_tpu_torch.models import sparse
    from gpmdm_tpu_torch.utils.io import load_model

    dev = _cuda_or_skip()
    assert not torch.backends.cuda.matmul.allow_tf32
    m = load_model(Path(__file__).resolve().parents[1] / "bench_assets" / asset, device=dev)
    sp = pf.resolve_posterior(m, "auto")
    assert isinstance(sp, sparse.SparsePosterior)
    g = torch.Generator(device=dev).manual_seed(0)
    x = pf.pf_init(sp, m.layout.y_class_offsets, g, pf.PFConfig(num_particles=4096)).x

    def post_as(dtype, device):
        return sparse.SparsePosterior(**{f: getattr(sp, f).to(device, dtype)
                                         for f in sparse.POSTERIOR_FIELDS},
                                      distilled=sp.distilled)

    params32 = type(m.params)(**{k: v.cpu() for k, v in vars(m.params).items()})
    cases = ((sp, m.params, x), (post_as(torch.float32, "cpu"), params32, x.cpu()),
             (post_as(torch.float64, "cpu"), _f64(m.params), x.cpu().double()))
    for name in ("predict_y", "predict_x_all_classes"):
        fn = getattr(sparse, name)
        got, cpu32, want = (fn(p, prm, xx, m.config, with_noise=True, quad_precision=quad)
                            for p, prm, xx in cases)
        torch.cuda.synchronize()
        for label, gg, c32, w in zip(("mean", "var"), got, cpu32, want):
            assert torch.isfinite(gg).all(), (name, label)
            err = (gg.cpu().double() - w).abs().max().item()
            ref = (c32.double() - w).abs().max().item()
            assert err <= 4 * ref + 1e-6 * w.abs().max().item(), (name, label, err, ref)
