"""Skeleton exploration walkthrough — script form of the reference's
``notebooks/joints.ipynb``.

Steps (reference cells 0-5):
  1. parse an ASF skeleton + AMC motion (CMU subject 02 when the mocap dir
     is present, else the bundled test fixture),
  2. list the joints and their degrees of freedom,
  3. render the all-zeros pose,
  4. perturb one joint (the notebook sets lowerback rx = 45 degrees) and
     render the changed pose,
  5. export the motion animation as a GIF (MPLViewer).

Usage: python -m gpmdm_tpu_torch.examples.joints [--out-dir .] [--downsample 2]

Parsing, FK and drawing are numpy and matplotlib: no model and no device.
"""

import argparse
import copy
import sys
from pathlib import Path

import numpy as np

from gpmdm_tpu_torch.data import registry
from gpmdm_tpu_torch.data.amc_asf import parse_amc, parse_asf
from gpmdm_tpu_torch.data.joint_tree import build_joint_tree
from gpmdm_tpu_torch.viz.mpl_viewer import MPLViewer

REPO = Path(__file__).resolve().parents[2]


def find_data():
    """Subject 02 trial 02_02 like the notebook, else the test fixture."""
    mocap = registry.default_mocap_dir()
    asf = Path(mocap) / "subjects" / "02" / "02.asf"
    amc = Path(mocap) / "subjects" / "02" / "02_02.amc"
    if asf.exists() and amc.exists():
        return asf, amc
    print("CMU mocap not found - using the bundled fixture skeleton")
    return REPO / "tests/fixtures/tiny.asf", REPO / "tests/fixtures/tiny.amc"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--downsample", type=int, default=2)
    args = ap.parse_args(argv)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    asf_path, amc_path = find_data()
    skel = parse_asf(asf_path)
    motion = parse_amc(amc_path, skel)
    joints = build_joint_tree(skel)
    root = joints["root"]

    # --- joint listing (notebook cell 2) ---
    print(f"{len(joints)} joints:")
    for j in joints.values():
        j.pretty_print()

    # --- zero pose (cells 1, 3) ---
    zero_pose = {name: [0.0] * max(1, len(j.dof)) for name, j in joints.items()}
    zero_pose["root"] = [0.0] * 6
    root.set_motion(zero_pose)
    ax = root.draw(show=False)
    ax.figure.savefig(out / "zero_pose.png", dpi=80)
    print(f"wrote {out / 'zero_pose.png'}")

    # --- perturbed pose (cell 4: lowerback rx = 45) ---
    turned = copy.deepcopy(zero_pose)
    target = "lowerback" if "lowerback" in joints else next(
        n for n, j in joints.items() if n != "root" and j.dof
    )
    turned[target][0] = 45.0
    root.set_motion(turned)
    zero_coord = {n: joints[n].coordinate.copy() for n in joints}
    ax = root.draw(show=False)
    ax.set_title(f"{target} +45 deg")
    ax.figure.savefig(out / "perturbed_pose.png", dpi=80)
    print(f"wrote {out / 'perturbed_pose.png'} (perturbed joint: {target})")

    # sanity: the perturbation moved some descendant joint
    root.set_motion(zero_pose)
    moved = any(
        not np.allclose(joints[n].coordinate, zero_coord[n]) for n in joints
    )
    assert moved, "perturbing a joint must move the skeleton"

    # --- animation GIF (cell 5) ---
    gif = out / "joints_animation.gif"
    anim = MPLViewer(skel, motion).animate(downsample=args.downsample)
    anim.save(gif, writer="pillow", fps=30)
    print(f"wrote {gif}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
