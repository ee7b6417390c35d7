"""Train the ``c8n5120`` benchmark asset with the PyTorch port, on the card.

The 8-class signature task at BASELINE.md's N~5k scale (8 classes x 8
sequences x 80 frames: Ny = 5,120) at the source's published widths,
D = 35 and d = 4 (Priyanshu4/gpmdm ``train_gpmdm.ipynb`` cell 2).  The
recipe is the committed D = 10 asset's (``bench_model_c8n5120.npz``'s
meta): float32 Adam at lr 0.01, sigma_n inits 0.1, every hyperparameter
trainable and bounded by the log-space hyperprior (weight 1,000, 100,000
on the two noise scales).  At each cut the k-means-384 SGPR distillation
is built and scored by the banked guard (6 held-out trials a class, 0.9 to
stay, burn-in 5); the best cut is saved with that distillation persisted,
the deployment recommendation naming it and the guard receipt, so
``posterior='auto'`` serves it with no exact build and no k-means run;
its exact posterior's guard is reported beside it.

Nothing here imports JAX.  One JSON line a cut, then one for the saved
asset, on stdout.

    python3 tools/train_c8n5120_torch.py --out bench_assets/bench_model_c8n5120d35.npz

``--n-seqs``, ``--seq-len``, ``--m`` and ``--particles`` shrink it for a
check on the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

NAME = "c8n5120d35"
C, D, d = 8, 35, 4
DATA = dict(center_spread=3.0, class_signature=1.0, seed=21)
HYPERPRIOR = (1e3, 1e3, 1e5, 1e3, 1e3, 1e5, 1e3)
LR = 0.01
CUTS = (20, 40, 60, 90, 120)  # Adam step counts at which a cut is scored


def guard(model, posterior, seq_len: int, particles: int, seed: int = 0):
    """The banked guard of ``utils/asset_guard.py`` on this generator:
    6 held-out trials a class of ``seq_len`` frames, 16 filters a call."""
    from gpmdm_tpu_torch.config import PFConfig
    from gpmdm_tpu_torch.data import synthetic
    from gpmdm_tpu_torch.utils.metrics import evaluate_pf_banked

    _, _, seqs, labels = synthetic.make_dataset(
        n_classes=C, n_train_seqs=1, n_test_seqs=6, seq_len=seq_len, D=D, **DATA)
    T = np.full((C, C), 0.1 / (C - 1))
    np.fill_diagonal(T, 0.9)
    return evaluate_pf_banked(model, T, [np.asarray(s) for s in seqs], labels,
                              num_particles=particles, burn_in=5, seed=seed,
                              config=PFConfig(), max_banks=16, posterior=posterior)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--m", type=int, default=384, help="inducing inputs a GP")
    ap.add_argument("--particles", type=int, default=10_000)
    ap.add_argument("--n-seqs", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=80)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gpmdm_tpu_torch import GPMDM
    from gpmdm_tpu_torch.data import synthetic
    from gpmdm_tpu_torch.utils.asset_guard import make_receipt

    tr, lb, _, _ = synthetic.make_dataset(n_classes=C, n_train_seqs=args.n_seqs, n_test_seqs=1,
                                          seq_len=args.seq_len, D=D, **DATA)
    m = GPMDM(D=D, d=d, n_classes=C, y_sigma_n_init=0.1, x_sigma_n_init=0.1,
              hyperprior_weight=HYPERPRIOR[0], hyperprior_weights=HYPERPRIOR, device=args.device)
    for Y, c in zip(tr, lb):
        m.add_data(Y, c)
    m.init_X()

    best, done, t0 = None, 0, time.time()
    for cut in CUTS:
        losses = m.train_adam(cut - done, lr=LR)
        done = cut
        if not np.isfinite(losses[-1]):
            print(json.dumps({"cut": cut, "loss": None}), flush=True)
            break
        post = m.sparsified_posterior(args.m, method="kmeans")
        rep = guard(m, post, args.seq_len, args.particles)
        acc, f1 = rep.frame_metrics["accuracy"], rep.frame_metrics["f1"]
        print(json.dumps({"cut": cut, "loss": losses[-1], "frame_acc": acc, "frame_f1": f1,
                          "trial_acc": rep.trial_metrics["accuracy"],
                          "y_sigma_n": float(np.exp(float(m.params.y_log_sigma_n))),
                          "seconds": time.time() - t0}), flush=True)
        m._deploy_recommendation = {"family": "sparsified", "M": args.m, "method": "kmeans",
                                    "guard_frame_acc": acc, "guard_particles": args.particles}
        m._guard_receipt = {**make_receipt(m, NAME, args.particles, acc, f1),
                            "posterior": "SparsePosterior"}
        path = f"{args.out[:-4]}_s{cut}.npz"
        m.save(path)
        if best is None or acc > best[0]:
            best = (acc, cut, path)
    if best is None:
        print(json.dumps({"saved": None}), flush=True)
        return 1
    shutil.copyfile(best[2], args.out)
    for cut in CUTS:
        path = f"{args.out[:-4]}_s{cut}.npz"
        if os.path.exists(path):
            os.remove(path)
    ex = GPMDM.load(args.out, device=args.device)
    rep = guard(ex, ex.posterior, args.seq_len, args.particles)
    print(json.dumps({"saved": args.out, "cut": best[1], "frame_acc": best[0],
                      "exact_frame_acc": rep.frame_metrics["accuracy"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
