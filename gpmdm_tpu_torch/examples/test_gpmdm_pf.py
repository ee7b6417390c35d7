"""Particle-filter evaluation — script form of the reference's
``notebooks/test_gpmdm_pf.ipynb``.

Streams every held-out trial through GPMDM_PF (T = [[.9,.1],[.1,.9]], 100
particles by default), printing per-frame / per-trial confusion matrices,
accuracy / precision / recall / F1, and throughput (reference cells 4-5).

Usage: python -m gpmdm_tpu_torch.examples.test_gpmdm_pf models/gpmdm.npz
                                                        [--particles 100]

The filter runs on the CUDA card (K1-K3) unless ``GPMDM_TPU_PLATFORM=cpu``.
"""

import argparse
import sys

import numpy as np

from gpmdm_tpu_torch import GPMDM, GPMDM_PF
from gpmdm_tpu_torch.__main__ import _device
from gpmdm_tpu_torch.data import registry, synthetic
from gpmdm_tpu_torch.data.joints import WALKING_SIMPLIFIED_JOINTS
from gpmdm_tpu_torch.utils.metrics import evaluate_pf

DOWNSAMPLE = 4


def load_test_data():
    if registry.available():
        walk = registry.load_trials(registry.WALK_TRIAL_IDS_TEST)
        run = registry.load_trials(registry.RUN_TRIAL_IDS_TEST)
        seqs, labels = [], []
        for label, trials in ((0, walk), (1, run)):
            for mc in trials:
                seqs.append(mc.select_joints(WALKING_SIMPLIFIED_JOINTS)[::DOWNSAMPLE])
                labels.append(label)
        return seqs, labels
    print("CMU mocap not found - using synthetic limit cycles")
    _, _, te, tel = synthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=6, seq_len=80, D=12, seed=0
    )
    return te, tel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--banked", action="store_true",
                    help="stream ALL trials at once (one filter bank per trial)")
    args = ap.parse_args(argv)
    device = _device()
    if device is None:
        return 2

    model = GPMDM.load(args.ckpt, device=device)
    seqs, labels = load_test_data()
    T = [[0.9, 0.1], [0.1, 0.9]]
    if args.banked:
        from gpmdm_tpu_torch.utils.metrics import evaluate_pf_banked

        report = evaluate_pf_banked(
            model, T, [np.asarray(s) for s in seqs], labels,
            num_particles=args.particles,
        )
    else:
        flt = GPMDM_PF(model, T, num_particles=args.particles)
        report = evaluate_pf(
            flt, [np.asarray(s) for s in seqs], labels, n_classes=2
        )
    print(report.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
