"""PF demo animation — script form of the reference's
``notebooks/view_gpmdm_pf.ipynb``.

Runs the particle filter over one trial, records the latent state-mean
trajectory, and renders a side-by-side animation: skeleton (when CMU data is
present) next to the latent-space trajectory over the training manifold
(reference cells 7-8).  Writes a GIF.

Usage: python -m gpmdm_tpu_torch.examples.view_gpmdm_pf models/gpmdm.npz
           [--out pf_demo.gif] [--particles 100]

The work is split in two: :func:`track` runs the filter on the model's
device (the CUDA card, through K1-K3, unless ``GPMDM_TPU_PLATFORM=cpu``)
and returns numpy arrays; :func:`render` draws them with matplotlib.
"""

import argparse
import sys

import numpy as np

from gpmdm_tpu_torch import GPMDM, GPMDM_PF
from gpmdm_tpu_torch.__main__ import _device
from gpmdm_tpu_torch.data import registry, synthetic
from gpmdm_tpu_torch.data.joints import WALKING_SIMPLIFIED_JOINTS

DOWNSAMPLE = 4
TRANSITIONS = [[0.9, 0.1], [0.1, 0.9]]


def load_trial(D):
    """(Z, positions, parent): subject 02 trial 01 (walk) with its joint
    positions and skeleton when CMU data is present, else the first
    synthetic test trial with D observation dims and no skeleton."""
    if registry.available():
        mc = registry.load_trials({2: [1]})[0]  # subject 02 trial 01 (walk)
        Z = mc.select_joints(WALKING_SIMPLIFIED_JOINTS)[::DOWNSAMPLE]
        return Z, mc.positions()[::DOWNSAMPLE], mc.skeleton.parent
    print("CMU mocap not found - latent-only animation on synthetic data")
    _, _, te, _ = synthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=1, seq_len=80, D=D, seed=0,
    )
    return te[0], None, None


def track(model, Z, particles=100, seed=0):
    """Stream Z (T, D) through GPMDM_PF, seeded ``seed``, on the model's
    device; returns the state-mean trajectory (T, d) and the class
    probabilities (T, C) as numpy."""
    outs = GPMDM_PF(model, TRANSITIONS, num_particles=particles, seed=seed).run(np.asarray(Z))
    return outs.state_mean.cpu().numpy(), outs.class_probs.cpu().numpy()


def render(model, traj, probs, out, positions=None, parent=None) -> None:
    """The side-by-side animation GIF of ``traj`` and ``probs`` over the
    latent manifold (and the skeleton's ``positions`` when given)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    from gpmdm_tpu_torch.viz.latent import plot_latent_space
    from gpmdm_tpu_torch.viz.skeleton_plot import draw_positions

    ncols = 2 if positions is not None else 1
    fig = plt.figure(figsize=(6 * ncols, 5))
    ax_lat = fig.add_subplot(1, ncols, ncols, projection="3d" if model.d >= 3 else None)
    ax_sk = fig.add_subplot(1, 2, 1, projection="3d") if positions is not None else None

    def update(t):
        ax_lat.clear()
        plot_latent_space(model, ax=ax_lat, class_names=["walk", "run"])
        seg = traj[: t + 1]
        if model.d >= 3 and hasattr(ax_lat, "plot3D"):
            ax_lat.plot(seg[:, 0], seg[:, 1], seg[:, 2], "k-", lw=2)
        else:
            ax_lat.plot(seg[:, 0], seg[:, 1], "k-", lw=2)
        ax_lat.set_title(
            f"frame {t}  P(walk)={probs[t][0]:.2f} P(run)={probs[t][1]:.2f}"
        )
        if ax_sk is not None:
            ax_sk.clear()
            draw_positions(positions[t], parent, ax=ax_sk)

    anim = FuncAnimation(fig, update, frames=len(traj), interval=33)
    anim.save(out, writer="pillow")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--out", default="pf_demo.gif")
    ap.add_argument("--particles", type=int, default=100)
    args = ap.parse_args(argv)
    device = _device()
    if device is None:
        return 2

    model = GPMDM.load(args.ckpt, device=device)
    Z, positions, parent = load_trial(model.D)
    traj, probs = track(model, Z, args.particles)
    render(model, traj, probs, args.out, positions, parent)
    print(f"wrote {args.out} ({len(traj)} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
