"""``ops.sgpr``'s plain version against the SGPR prediction it replaced, on the CPU.

``sgpr_predict_plain`` is the per-frame solve path of
``models/sparse.py`` as it was before K4: the star block by
``ops.kernels``, two ``torch.linalg.solve_triangular`` calls, squares,
column sums and the clamp.  Moved unchanged, it must give the same bits
as that code (``_reference`` below, a verbatim copy), and
``sgpr_predict`` must take it for tensors on the CPU.  K4 itself runs
under the CPU emulation (``test_torch_cuda_emulation.py``) and on the
card (``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from gpmdm_tpu_torch.ops import kernels as K
from gpmdm_tpu_torch.ops import sgpr


def _reference(Z, Xstar, Lm, LB, beta, log_ls, log_sn, num, with_noise, log_lin):
    """The solve path of ``models/sparse.py`` before K4, verbatim."""
    if log_lin is None:
        Kstar = K.rbf_kernel(Z, Xstar, log_ls)
        kss = K.y_diag_kernel(Xstar, log_sn, num, with_noise)
    else:
        kss = K.x_diag_kernel(Xstar, log_lin, log_sn, num, with_noise)
        Kstar = K.x_kernel(Z, Xstar, log_ls, log_sn, log_lin, with_noise=False)
    mean = Kstar.mT @ beta
    v1 = torch.linalg.solve_triangular(Lm, Kstar, upper=False)
    v2 = torch.linalg.solve_triangular(LB, v1, upper=False)
    s1, s2 = torch.sum(v1.square_(), dim=-2), torch.sum(v2.square_(), dim=-2)
    return mean, torch.clamp(kss - s1 + s2, min=1e-12)


def _inputs(dtype, M, P, din, Dout, C, lin, seed):
    rng = np.random.default_rng(seed)
    lead = (C,) if C else ()
    A = rng.normal(size=lead + (2, M, M)) / np.sqrt(M)
    L = np.linalg.cholesky(A @ np.swapaxes(A, -1, -2) + np.eye(M))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    return dict(Z=t(rng.normal(size=lead + (M, din))), Xstar=t(rng.normal(size=(P, din))),
                Lm=t(L[..., 0, :, :]), LB=t(L[..., 1, :, :]),
                beta=t(rng.normal(size=lead + (M, Dout))),
                log_ls=t(0.3 * rng.normal(size=din)), log_sn=t(-1.5),
                num=0.1, with_noise=not lin,
                log_lin=t(0.3 * rng.normal(size=din + 1) - 1.0) if lin else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("M,P,din,Dout,C,lin", [
    (37, 90, 2, 35, 0, False),  # the observation GP, one GP
    (37, 90, 2, 2, 2, True),    # the dynamics GPs, two classes
    (20, 40, 4, 4, 3, True),    # d4's width, three classes
])
def test_plain_equals_the_solve_path_it_replaced_bit_for_bit(dtype, M, P, din, Dout, C, lin):
    x = _inputs(dtype, M, P, din, Dout, C, lin, seed=M + P + C)
    args = (x["Z"], x["Xstar"], x["Lm"], x["LB"], x["beta"], x["log_ls"], x["log_sn"])
    want = _reference(*args, x["num"], x["with_noise"], x["log_lin"])
    for fn in (sgpr.sgpr_predict_plain, sgpr.sgpr_predict):
        got = fn(*args, x["num"], x["with_noise"], x["log_lin"])
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w), fn.__name__
