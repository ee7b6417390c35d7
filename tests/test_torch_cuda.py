"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``gpu`` marker and skips inside its body when no
CUDA card is present.  The file imports no JAX, so it also runs on the
machine with the card, which has none:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
Tolerance rtol 1e-4, atol 1e-4: both sides run in fp32 and sum in
different orders over up to 480 terms.  The resampling rank counts
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


@pytest.mark.gpu
@pytest.mark.parametrize("N,fits", [(236, True), (480, True), (1100, True), (2048, False)])
def test_cuda_wrappers_refuse_only_star_tiles_that_do_not_fit(N, fits):
    dev = _cuda_or_skip()
    x = _inputs(N, 40, 2, seed=9)
    t = {k: _t(v, dev) for k, v in x.items()}
    calls = [
        lambda: tgp.fused_x_posterior(*(t[k] for k in ("Xt", "Xs", "A", "Kinv", "inv_ls",
                                                      "lin_w")), N),
        lambda: tgp.fused_obs_loglik(*(t[k] for k in ("Xt", "Xs", "A", "Kinv", "inv_ls",
                                                     "z", "lam2"))),
    ]
    for call in calls:
        if fits:
            assert all(torch.isfinite(o).all() for o in call())
        else:
            with pytest.raises(ValueError, match="shared memory"):
                call()


def _systematic_s(rng, B, Pb, alpha=0.3):
    """s of systematic resampling from seeded Dirichlet weights."""
    w = rng.dirichlet(np.full(Pb, alpha), size=B).astype(np.float32)
    cum = np.cumsum(w, axis=1, dtype=np.float32)
    u = rng.random((B, 1)).astype(np.float32)
    return np.clip(np.floor(Pb * cum - u).astype(np.int64) + 1, 0, Pb).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Pb", [(1, 10_000), (12, 10_000), (64, 1000), (1, 100_000)])
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
