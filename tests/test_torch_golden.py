"""The port's golden run: train on the frozen synthetic dataset of
tests/golden/e2e_synthetic.json, then filter, as tests/test_golden_e2e.py
does for the JAX package (float64, CPU, 200 Adam steps at lr 0.01, the
same constructor), and hold the port to the reference's own numbers.

- Loss: the final loss within 5% of the reference's (the JAX test's
  bound); the first 20 losses within rtol 1e-8 of the JAX trainer's on the
  same data and its final loss within rtol 1e-2 (200-step trajectories
  drift apart by round-off; the generation recorded 1e-2 for the JAX
  package against the reference).
- Filter: the port's ``GPMDM_PF`` with the golden ``pf`` block's settings
  inside the reference's seed band, as the JAX test holds the JAX package:
  frame accuracy and F1 >= the band's minimum - 0.02, and at most one
  trial fewer correct than the reference's seed-0 run.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import threadpoolctl

from gpmdm_tpu import GPMDM as JGPMDM
from gpmdm_tpu_torch import GPMDM, GPMDM_PF, PFConfig
from gpmdm_tpu_torch.data import synthetic
from gpmdm_tpu_torch.utils.metrics import evaluate_pf

GOLDEN = json.loads((Path(__file__).parent / "golden" / "e2e_synthetic.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS and OpenMP thread: these shapes are small, and idle pool
    threads spinning between calls would take cores from the suite's other
    workers (this file's CPU time falls by a factor of 2-5)."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _train(cls, tr, tl, **extra):
    mk = GOLDEN["model"]
    m = cls(dtype="float64", **mk, **extra, y_lambdas_init=np.ones(mk["D"]),
            y_lengthscales_init=np.ones(mk["d"]), x_lambdas_init=np.ones(mk["d"]),
            x_lengthscales_init=np.ones(mk["d"]), x_lin_coeff_init=np.ones(mk["d"] + 1))
    for Y, c in zip(tr, tl):
        m.add_data(np.asarray(Y, dtype=np.float64), c)
    m.init_X()
    losses = m.train_adam(num_opt_steps=GOLDEN["train"]["steps"], lr=GOLDEN["train"]["lr"])
    return m, np.asarray(losses)


@pytest.fixture(scope="module")
def runs():
    tr, tl, te, tel = synthetic.make_dataset(**GOLDEN["dataset"])
    port, port_losses = _train(GPMDM, tr, tl, device="cpu")
    _, jax_losses = _train(JGPMDM, tr, tl)
    return port, port_losses, jax_losses, te, tel


def test_port_training_reaches_reference_loss(runs):
    _, port_losses, jax_losses, _, _ = runs
    ref_final = GOLDEN["reference"]["loss_final"]
    assert len(port_losses) == GOLDEN["train"]["steps"]
    assert abs(port_losses[-1] - ref_final) / abs(ref_final) < 0.05
    np.testing.assert_allclose(port_losses[:20], jax_losses[:20], rtol=1e-8)
    np.testing.assert_allclose(port_losses[-1], jax_losses[-1], rtol=1e-2)


def test_port_filter_inside_reference_seed_band(runs):
    model, _, _, te, tel = runs
    pf = GOLDEN["pf"]
    pfc = PFConfig(num_particles=pf["particles"], resampling=pf["resampling"],
                   compat_double_logdet=pf["compat_double_logdet"],
                   obs_noise_in_weights=False)
    flt = GPMDM_PF(model, pf["T"], num_particles=pf["particles"], config=pfc, seed=0)
    rep = evaluate_pf(flt, te, tel, n_classes=2)
    ref = GOLDEN["reference"]
    assert rep.frame_metrics["accuracy"] >= min(ref["frame_acc_per_seed"]) - 0.02
    assert rep.frame_metrics["f1"] >= min(ref["frame_f1_per_seed"]) - 0.02
    assert rep.frame_confusion.sum() == np.asarray(ref["frame_confusion"]).sum()
    assert np.trace(rep.trial_confusion) >= np.trace(np.asarray(ref["trial_confusion"])) - 1
