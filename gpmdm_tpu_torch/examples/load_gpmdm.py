"""Model inspection — script form of the reference's
``notebooks/load_gpmdm.ipynb``: load a checkpoint and plot the per-class
latent embeddings (matplotlib static plot and/or the interactive 3D HTML
widget, the plotly-parity artifact of the reference's cell 2).

Usage: python -m gpmdm_tpu_torch.examples.load_gpmdm models/gpmdm.npz
           [--save latent.png] [--html latent.html]

The model is loaded on the CUDA card unless ``GPMDM_TPU_PLATFORM=cpu``.
"""

import argparse
import sys

from gpmdm_tpu_torch import GPMDM
from gpmdm_tpu_torch.__main__ import _device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--save", default=None)
    ap.add_argument("--html", default=None,
                    help="write an interactive 3D latent plot (standalone HTML)")
    args = ap.parse_args(argv)
    device = _device()
    if device is None:
        return 2

    model = GPMDM.load(args.ckpt, device=device)
    print(f"{type(model).__name__}: D={model.D} d={model.d} classes={model.n_classes}")
    print(f"loss: {model.gpdm_loss():.4e}")
    for c in range(model.n_classes):
        print(f"class {c}: {model.get_X_for_class(c).shape[0]} latent points")

    if args.html:
        from gpmdm_tpu_torch.viz.html3d import write_latent_html

        write_latent_html(model, args.html)
        print(f"wrote {args.html}")

    import matplotlib

    if args.save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from gpmdm_tpu_torch.viz import plot_latent_space

    plot_latent_space(model)
    if args.save:
        plt.savefig(args.save, dpi=120)
        print(f"wrote {args.save}")
    else:
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
