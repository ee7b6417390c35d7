"""Training walkthrough — script form of the reference's
``notebooks/train_gpmdm.ipynb``.

Loads CMU walk/run training trials (35 DOFs, downsampled 120->30 fps) when
the mocap directory exists, otherwise the synthetic limit-cycle stand-in;
builds a GPMDM(d=4, 2 classes), trains 500 Adam steps at lr=0.01, saves the
checkpoint, prints NMSE diagnostics, plots the latent space and an
autoregressive rollout (reference cells 0-8).

Usage: python -m gpmdm_tpu_torch.examples.train_gpmdm [--steps 500]
                                                      [--out models/gpmdm.npz]

Trains on the CUDA card unless ``GPMDM_TPU_PLATFORM=cpu``.
"""

import argparse
import sys

from gpmdm_tpu_torch import GPMDM
from gpmdm_tpu_torch.__main__ import _device
from gpmdm_tpu_torch.data import registry, synthetic
from gpmdm_tpu_torch.data.joints import WALKING_SIMPLIFIED_JOINTS

DOWNSAMPLE = 4  # 120 fps -> 30 fps (reference train_gpmdm.ipynb cell 1)


def load_training_data():
    """Returns (data, D, d): d=4 on CMU (the reference's published config);
    d=2 on the synthetic stand-in, whose underlying manifold is 2-D — a
    4-D latent on it overfits and wrecks PF generalization."""
    if registry.available():
        walk = registry.load_trials(registry.WALK_TRIAL_IDS_TRAIN)
        run = registry.load_trials(registry.RUN_TRIAL_IDS_TRAIN)
        data = []
        for label, trials in ((0, walk), (1, run)):
            for mc in trials:
                arr = mc.select_joints(WALKING_SIMPLIFIED_JOINTS)[::DOWNSAMPLE]
                data.append((arr, label))
        return data, data[0][0].shape[1], 4
    print("CMU mocap not found - using synthetic limit cycles (d=2)")
    tr, tl, _, _ = synthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=1, seq_len=80, D=12, seed=0
    )
    return list(zip(tr, tl)), 12, 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--out", default="models/gpmdm.npz")
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args(argv)
    device = _device()
    if device is None:
        return 2

    data, D, d = load_training_data()
    model = GPMDM(
        D=D, d=d, n_classes=2, dyn_target="full", dyn_back_step=1,
        y_sigma_n_init=1e-2, x_sigma_n_init=1e-2, device=device,
    )
    for arr, label in data:
        model.add_data(arr, label)
    model.init_X()
    losses = model.train_adam(
        num_opt_steps=args.steps, num_print_steps=max(1, args.steps // 50), lr=args.lr
    )
    model.save(args.out)
    print(f"saved {args.out}; final loss {losses[-1]:.4e}")

    # diagnostics (reference cell 7)
    *_, nmse = model.get_latent_map_performance()
    print(f"latent map NMSE: {nmse:.3f}")
    for c in range(2):
        *_, nm = model.get_dynamics_map_performance_for_class(c)
        print(f"dynamics map NMSE class {c}: {nm:.3f}")

    # autoregressive rollout demo (reference cell 8)
    x0 = model.get_X_for_class(0)[0].cpu().numpy()
    traj = model.rollout(x0, 100, 0).cpu().numpy()
    print(f"rollout: {traj.shape}, final point {traj[-1]}")

    if args.plot:
        import matplotlib.pyplot as plt

        from gpmdm_tpu_torch.viz import plot_latent_space, plot_loss_history

        plot_loss_history(losses)
        plot_latent_space(model, class_names=["walk", "run"])
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
