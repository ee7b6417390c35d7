"""A run with the timed path broken underneath comes out not correct, for
every fault a cell can have, and so does the control (the reference at
TF32 in the program's place); the sound path comes out correct.  The look
for a card is skipped: the runs are on the CPU, at small sizes."""

import time

import pytest
import torch

from perfbench import bank, faults, harness, traffic

FILTER_SMALL = {
    "d4_live_b32_p10k": {"streams": 2, "particles": 1000, "frames_per_stream": 240,
                         "check_banks": 2},
    "d4_ahead_b256_p1k": {"streams": 4, "particles": 500, "frames_per_stream": 256,
                          "check_banks": 4},
}


def _filter_wrap(cell, kind):
    c = harness.cell_entry(harness.load_spec(), cell)
    cfg, asset, _ = harness.load_config(c["config"])
    T = bank.transition(cfg, traffic.load_mix(c["traffic"]))
    return faults.filter_wrap(kind, cfg, asset, T, "cpu")


@pytest.mark.parametrize("kind", (None,) + faults.KINDS)
@pytest.mark.parametrize("cell", sorted(FILTER_SMALL))
def test_filter_faults(cell, kind):
    torch.set_num_threads(2)
    wrap = None if kind is None else _filter_wrap(cell, kind)
    # long enough for whole trials: a trial's first frames are where small banks differ
    out = harness.run_cell(cell, 987654321987, 4.0, False, "cpu", time.perf_counter(),
                           overrides=FILTER_SMALL[cell], wrap=wrap)
    assert out["correct"] is (kind is None), out["numbers"]
