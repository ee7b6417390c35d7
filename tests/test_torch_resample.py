"""The port's resampling rank (gpmdm_tpu_torch.ops.resample, the plain
version of kernel K3) against the JAX package's, on the CPU.

- ``resample_rank_plain`` against ``rank_pallas`` (the TPU kernel, in
  interpret mode) and ``rank_xla`` (the 0/1 matmul of the JAX main path),
  both from tools/exp_resample_rank_pallas.py, on sorted and unsorted
  ``s`` at P = 1,000 and 10,000.
- The banked ``systematic_resample_indices`` against ``jax.vmap`` of the
  JAX function, on weights whose fp32 cumulative sum is exact in any
  order.
- ``systematic_counts`` on the plain cumsum of the weights at every P,
  up to 100,000.

Every check is bit-identical: the ranks are integer counts.  The CUDA
kernel itself is tested on the card (tests/test_torch_cuda.py) and under
a CPU emulation (tests/test_torch_cuda_emulation.py).
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmdm_tpu.filter import particle_filter as jpf
from gpmdm_tpu_torch.filter import particle_filter as tpf
from gpmdm_tpu_torch.ops import resample as rs
from gpmdm_tpu_torch.utils import profiling

TOOL = Path(__file__).resolve().parents[1] / "tools" / "exp_resample_rank_pallas.py"


@pytest.fixture(scope="module")
def tool():
    """The experiment module; it parses ``sys.argv`` when imported."""
    spec = importlib.util.spec_from_file_location("exp_resample_rank_pallas", TOOL)
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["exp_resample_rank_pallas.py", "--corr-only"])
        spec.loader.exec_module(mod)
    return mod


def _systematic_s(rng, P, alpha=0.3):
    """s of systematic resampling from seeded Dirichlet weights."""
    w = rng.dirichlet(np.full(P, alpha)).astype(np.float32)
    cum = np.cumsum(w, dtype=np.float32)
    return np.clip(np.floor(P * cum - np.float32(rng.random())).astype(np.int64) + 1,
                   0, P).astype(np.int32)


@pytest.mark.parametrize("P", [1000, 10_000])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_rank_plain_matches_rank_pallas_and_rank_xla(tool, P, order):
    rng = np.random.default_rng(P)
    s = _systematic_s(rng, P)
    if order == "unsorted":
        s = rng.permutation(s)
    got = rs.resample_rank_plain(torch.as_tensor(s)[None])[0].numpy()
    want_pallas = np.asarray(tool.rank_pallas(jnp.asarray(s), P, interpret=True))
    want_xla = np.asarray(tool.rank_xla(jnp.asarray(s), P))
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_xla)


def test_rank_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(1)
    s = torch.as_tensor(np.stack([_systematic_s(rng, 300) for _ in range(3)]))
    profiling.reset()
    torch.testing.assert_close(rs.resample_rank(s), rs.resample_rank_plain(s))
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_rank_plain_clamps_like_the_comparison():
    """A value below 0 counts for every i, one above Pb - 1 for none."""
    s = torch.tensor([[-3, 9, 2, 2], [4, 4, 4, 4]], dtype=torch.int32)
    want = [[min(int((s[b] <= i).sum()), 3) for i in range(4)] for b in range(2)]
    assert rs.resample_rank_plain(s).tolist() == want


def test_banked_systematic_indices_match_jax_vmap():
    """Weights that are multiples of 2^-10 (an exact fp32 cumsum in any
    order): each bank's indices equal JAX's, bank by bank."""
    rng = np.random.default_rng(2)
    B, Pb = 3, 500
    w = np.stack([rng.multinomial(1024, rng.dirichlet(np.full(Pb, 0.3))) / 1024.0
                  for _ in range(B)]).astype(np.float32)
    log_w = np.log(np.maximum(w, 1e-30)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    u = jax.vmap(lambda k: jax.random.uniform(k, (), dtype=jnp.float32))(keys)
    want = jax.vmap(lambda k, lw, ww: jpf.systematic_resample_indices(k, lw, w=ww))(
        keys, jnp.asarray(log_w), jnp.asarray(w))
    for rank in (rs.resample_rank, rs.resample_rank_plain):
        got = tpf.systematic_resample_indices(torch.as_tensor(np.array(u)),
                                              torch.as_tensor(log_w),
                                              w=torch.as_tensor(w), rank=rank)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("P", [10_000, 32_767, 100_000])
def test_counts_use_the_plain_cumsum(P):
    """The counts from ``torch.cumsum`` at every P.  The JAX package blocks
    its cumsum from 32,768 particles, a speed-up for the TPU's vector
    units; on the card ``torch.cumsum`` is one launch."""
    rng = np.random.default_rng(P)
    w = torch.as_tensor(rng.dirichlet(np.full(P, 0.5)).astype(np.float32))
    u = torch.tensor(0.61)
    manual = torch.clamp(torch.floor(P * torch.cumsum(w, 0) - u).to(torch.int64) + 1, 0, P)
    assert torch.equal(tpf.systematic_counts(u, torch.log(w), w)[0], manual.to(torch.int32))
