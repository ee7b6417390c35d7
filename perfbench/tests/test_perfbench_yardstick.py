"""The work and FLOP counts against hand sums at small shapes."""

from perfbench import yardstick as ys


def test_posterior_and_obs_work():
    # N 3, P 5, d 2, Dout 2, linear, 2 classes: per pair 3*2+1+2*2+2 = 13
    f, b = ys.posterior_work(3, 5, 2, 2, True, 2)
    assert f == 2 * (3 * 5 * 13 + 2 * 3 * 2 * 5 + 2 * 9 * 5 + 2 * 3 * 5)
    assert b == 4 * (2 * (6 + 6 + 9 + 10 + 5) + 10 + 2 + 3)
    f, b = ys.obs_work(4, 6, 2, 3, n_z=2)
    assert f == 4 * 6 * 7 + 2 * 4 * 3 * 6 + 2 * 16 * 6 + 2 * 4 * 6 + 4 * 3 * 6
    assert b == 4 * (8 + 12 + 2 + 12 + 16 + 9 + 12)
    assert ys.rank_work(2, 5) == (20, 120)


def test_bound_picks_the_longer():
    ms, by = ys.bound(67e9, 1.0)
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    ms, by = ys.bound(1.0, 3.35e9)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12


def test_filter_flops():
    B, Pb, d, D, C, n, N = 2, 3, 2, 4, 2, 5, 7
    P = B * Pb
    glue = P * (C + 2 * C * d + 3 * d + 8 + D + 12 + C + 2 * d + 6)
    assert ys.glue_flops(P, d, C, D) == glue
    assert ys.exact_filter_flops(B, Pb, d, D, C, n, N) == (
        ys.posterior_work(n, P, d, d, True, C)[0] + ys.obs_work(N, P, d, D, B)[0] + glue)
    M, Mx = 4, 3
    def pred(M_, din, dout, lin):
        pair = 3 * din + 1 + (2 * din + 2 if lin else 0)
        return P * (M_ * pair + 2 * M_ * dout + 2 * M_ * M_ + 4 * M_ + 2)
    assert ys.sparse_filter_flops(B, Pb, d, D, C, M, Mx) == (
        pred(M, d, D, False) + C * pred(Mx, d, d, True) + glue)
    qy, qx = 3, 2
    def comp(N_, din, dout, q, lin):
        pair = 3 * din + 1 + (2 * din + 2 if lin else 0)
        return P * (N_ * pair + 2 * N_ * dout + 4 * N_ * q + 2 * N_ + 3 * q + 1)
    assert ys.compressed_filter_flops(B, Pb, d, D, C, n, N, qy, qx) == (
        comp(N, d, D, qy, False) + C * comp(n, d, d, qx, True) + glue)


def test_kernel_names():
    assert ys.KERNEL_NAMES["k1"].search("void (anonymous namespace)::x_onepass<128, 512>(float)")
    assert ys.KERNEL_NAMES["k1"].search("posterior_core<64, 1>(float const*)")
    assert ys.KERNEL_NAMES["k2"].search("posterior_core<128, 2>(float const*)")
    assert not ys.KERNEL_NAMES["k1"].search("posterior_core<128, 2>(float const*)")
    assert ys.kind_of("void kernel_trsm_l_mul32<float, 8>") == "triangular solve"
    assert ys.kind_of("batched_geqrf_warp_based") == "qr (geqrf)"
