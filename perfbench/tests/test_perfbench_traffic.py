"""The generator: the same seed gives the same streams, another seed other
streams of the same sizes, and each trial is ``make_cycle``'s motion."""

import numpy as np
import pytest
import torch

from perfbench import traffic

SHAPE = {"trial_len": 60, "D": 35, "noise": 0.02, "center_spread": 0.0, "class_signature": 0.0}


def streams(seed, shape=SHAPE, B=3, F=240):
    g = torch.Generator()
    g.manual_seed(seed)
    return traffic.make_streams(shape, 2, B, F, g, "cpu")


def test_same_seed_same_streams():
    (Z1, c1), (Z2, c2) = streams(2**31 + 7), streams(2**31 + 7)
    assert torch.equal(Z1, Z2) and torch.equal(c1, c2)


def test_other_seed_other_streams_same_sizes():
    (Z1, c1), (Z2, c2) = streams(11), streams(12)
    assert Z1.shape == Z2.shape == (240, 3, 35) and Z1.dtype == torch.float32
    assert not torch.equal(Z1, Z2)
    assert set(c1.unique().tolist()) <= {0, 1}


def test_trials_are_constant_class_blocks():
    _, c = streams(5)
    blocks = c.reshape(4, 60, 3)
    assert torch.equal(blocks, blocks[:, :1].expand_as(blocks))


#: Stream shapes: the classic task and the signature task at 2 classes, and
#: c8n5120's 8-class signature streams (D 10, 80-frame trials).
SHAPES = {"0.0": (2, SHAPE),
          "1.0": (2, {**SHAPE, "class_signature": 1.0, "center_spread": 3.0}),
          "c8n5120": (8, {"trial_len": 80, "D": 10, "noise": 0.02, "center_spread": 3.0,
                          "class_signature": 1.0})}


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_trial_is_make_cycles_motion(case):
    """Without noise, a trial equals the program's generator at the class
    and phase the seed drew."""
    from gpmdm_tpu_torch.data import synthetic

    C, shape = SHAPES[case]
    shape = {**shape, "noise": 0.0}
    L, D, B, n_trials = shape["trial_len"], shape["D"], 4, 4
    g = torch.Generator()
    g.manual_seed(3)
    Z, c = traffic.make_streams(shape, C, B, n_trials * L, g, "cpu")
    # the phases: the second draw after the classes, as make_streams makes them
    g.manual_seed(3)
    torch.randint(0, C, (n_trials, B), generator=g)
    phase = 2 * np.pi * torch.rand(n_trials, B, generator=g, dtype=torch.float64)
    for t in range(n_trials):
        for b in range(B):
            want = synthetic.make_cycle(L, int(c[L * t, b]), D, noise=0.0,
                                        phase=float(phase[t, b]),
                                        center_spread=shape["center_spread"],
                                        class_signature=shape["class_signature"])
            np.testing.assert_allclose(Z[L * t:L * (t + 1), b].numpy(), want, atol=2e-6)
    if C == 8:
        assert len(c.unique()) > 4
