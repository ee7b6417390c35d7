"""Command-line entry points: ``python -m gpmdm_tpu_torch <command>``.

The JAX package's CLI (``python -m gpmdm_tpu``) on the port, with its
commands' flags, defaults, exit codes and printed summaries:

view <asf> <amc>      interactive skeleton animation (pygame + OpenGL)
train [...]           train a GPMDM (CMU walk/run if the data is present,
                      else synthetic limit cycles) and save a checkpoint
eval <ckpt> [...]     stream test trials through the particle filter and
                      print confusion matrices / F1 / fps
rollout <ckpt> [...]  autoregressive latent rollout, printed (and plotted
                      over the latent space with --plot)
deploy <ckpt> [...]   bake the deployment posterior into the checkpoint
                      (later loads skip the O(N^3) host precompute)
demo <ckpt> [...]     render the PF demo animation (GIF) through
                      ``gpmdm_tpu_torch.examples.view_gpmdm_pf``

Everything that reads a model runs on the CUDA card unless
``GPMDM_TPU_PLATFORM=cpu``, the JAX package's platform pin: unset or
``gpu`` means the card, and a run with no card fails at once (exit 2)
instead of carrying on on the CPU.  ``view`` reads no model and touches no
device, so it needs neither.  The JAX package's ``bench`` runs its own
benchmark, which the port does not have yet.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}


def _device() -> str | None:
    """The device ``GPMDM_TPU_PLATFORM`` pins: 'cuda' (unset or 'gpu') or
    'cpu'; None, with the reason on stderr, for another value, and for
    'cuda' when no card is present."""
    plat = os.environ.get("GPMDM_TPU_PLATFORM") or "gpu"
    if plat not in PLATFORMS:
        print(f"GPMDM_TPU_PLATFORM={plat!r}: expected one of {sorted(PLATFORMS)}",
              file=sys.stderr)
        return None
    if PLATFORMS[plat] == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA card is available; set GPMDM_TPU_PLATFORM=cpu to run on the CPU",
                  file=sys.stderr)
            return None
    return PLATFORMS[plat]


def _cmd_view(args) -> int:
    from .data.amc_asf import parse_amc, parse_asf
    from .viz.viewer import Viewer

    skel = parse_asf(args.asf)
    motion = parse_amc(args.amc, skel)
    Viewer(skel, motion, fps=args.fps).run()
    return 0


def _load_dataset(args, D=None, C=None):
    """CMU walk/run (the reference experiment: 35 DOFs, 120 -> 30 fps) when
    the mocap directory holds the data, else the synthetic limit-cycle
    stand-in.  ``D`` / ``C`` pin the synthetic fallback's observation
    dimensions and class count (eval passes the loaded model's)."""
    from .data import registry, synthetic
    from .data.joints import WALKING_SIMPLIFIED_JOINTS

    if registry.available(args.mocap_dir):
        def arrays(trials):
            return [mc.select_joints(WALKING_SIMPLIFIED_JOINTS)[:: args.downsample]
                    for mc in trials]

        walk_tr = registry.load_trials(registry.WALK_TRIAL_IDS_TRAIN, args.mocap_dir)
        run_tr = registry.load_trials(registry.RUN_TRIAL_IDS_TRAIN, args.mocap_dir)
        walk_te = registry.load_trials(registry.WALK_TRIAL_IDS_TEST, args.mocap_dir)
        run_te = registry.load_trials(registry.RUN_TRIAL_IDS_TEST, args.mocap_dir)
        train = [(a, 0) for a in arrays(walk_tr)] + [(a, 1) for a in arrays(run_tr)]
        test = [(a, 0) for a in arrays(walk_te)] + [(a, 1) for a in arrays(run_te)]
        cmu_D = train[0][0].shape[1]
        # refuse to stream trials of another shape into a loaded model
        if (D is not None and D != cmu_D) or (C is not None and C != 2):
            raise SystemExit(
                f"checkpoint expects D={D}, C={C} but the CMU walk/run "
                f"dataset provides D={cmu_D}, C=2 — evaluate with a "
                "matching checkpoint or point --mocap-dir elsewhere")
        print(f"CMU walk/run: {len(train)} train / {len(test)} test trials, D={cmu_D}")
        return train, test, cmu_D
    print("mocap data not found; using synthetic limit cycles")
    if (C or 2) != 2:
        print(f"note: synthetic fallback generates a DEFAULT {C}-class "
              "task; a checkpoint trained with custom synthetic kwargs "
              "needs its own guard (utils.asset_guard)")
    D = D or 12
    tr_s, tr_l, te_s, te_l = synthetic.make_dataset(
        n_classes=C or 2, n_train_seqs=4, n_test_seqs=6, seq_len=80, D=D, seed=0)
    return list(zip(tr_s, tr_l)), list(zip(te_s, te_l)), D


def _make_logger(args):
    """MetricLogger writing JSON lines to --jsonl (None when unset)."""
    if not getattr(args, "jsonl", None):
        return None
    from .utils.logging import MetricLogger

    return MetricLogger(stream=None, jsonl_path=args.jsonl)


def _sparsify_args_ok(args) -> bool:
    if not args.sparsify and (args.sparsify_x or args.sparsify_method != "stride"):
        print("--sparsify-x/--sparsify-method require --sparsify M")
        return False
    return True


def _exact_family_only(model, flags: str) -> bool:
    if not model._deploys_core_posterior:
        print(f"{flags} applies to the exact family only; "
              f"{type(model).__name__} deploys its own posterior")
        return False
    return True


def _cmd_train(args, device) -> int:
    from . import BCGPMDM, GPMDM, SparseGPMDM

    train, _, D = _load_dataset(args)
    if args.sparse and args.back_constrained:
        print("--sparse and --back-constrained are mutually exclusive")
        return 2
    cls = SparseGPMDM if args.sparse else BCGPMDM if args.back_constrained else GPMDM
    extra = ({"n_inducing_y": args.inducing, "n_inducing_x": args.inducing}
             if args.sparse else {})
    model = cls(**extra, D=D, d=args.latent_dim, n_classes=2, dyn_target=args.dyn_target,
                dyn_back_step=args.back_step, y_sigma_n_init=1e-2, x_sigma_n_init=1e-2,
                dtype=args.dtype, hyperprior_weight=args.hyperprior, device=device)
    for Y, c in train:
        model.add_data(np.asarray(Y), c)
    model.init_X()
    losses = model.train_adam(num_opt_steps=args.steps,
                              num_print_steps=max(1, args.steps // 10), lr=args.lr,
                              logger=_make_logger(args), optimizer=args.optimizer)
    print(f"final loss {losses[-1]:.4e}")
    if args.deploy:
        from .filter.particle_filter import resolve_posterior

        post = resolve_posterior(model, "auto")
        if hasattr(post, "rank_y"):
            print(f"deployed posterior: compressed "
                  f"(rank_y={post.rank_y}, rank_x={post.rank_x})")
    model.save(args.out)
    print(f"saved {args.out}")
    return 0


def _cmd_eval(args, device) -> int:
    from . import GPMDM, GPMDM_PF, PFConfig
    from .filter.particle_filter import resolve_posterior
    from .utils.metrics import evaluate_pf, evaluate_pf_banked

    model = GPMDM.load(args.ckpt, device=device)
    _, test, _ = _load_dataset(args, D=model.D, C=model.n_classes)
    C = model.n_classes
    T = np.full((C, C), 0.1 / max(C - 1, 1))
    np.fill_diagonal(T, 0.9)
    seqs = [np.asarray(Z) for Z, _ in test]
    labels = [c for _, c in test]
    if not _sparsify_args_ok(args):
        return 2
    if args.sparsify:
        if not _exact_family_only(model, "--sparsify"):
            return 2
        post = model.sparsified_posterior(n_inducing_y=args.sparsify,
                                          n_inducing_x=args.sparsify_x or None,
                                          method=args.sparsify_method)
        print(f"sparsified posterior: M_y={post.Zy.shape[0]} "
              f"(of Ny={model.layout.Ny}), M_x={post.Zx.shape[1]}, "
              f"method={args.sparsify_method}")
    elif args.compress_rank:
        post = model.compressed_posterior(rank_y=args.compress_rank,
                                          rank_x=args.compress_rank)
    else:
        # the deployment policy: auto-compress past AUTO_COMPRESS_N unless
        # --exact pins the exact posterior
        mode = "compressed" if args.compressed else "exact" if args.exact else "auto"
        post = resolve_posterior(model, mode)
    if hasattr(post, "Uy"):
        print(f"compressed posterior: quad rank {post.rank_y}/{model.layout.Ny}")
    pf_kw = dict(resampling=args.resampling, recon_precision=args.recon_precision,
                 fuse_mean_quad=args.fuse_mean_quad)
    if args.banked:
        report = evaluate_pf_banked(model, T, seqs, labels, burn_in=args.burn_in,
                                    seed=args.seed,
                                    config=PFConfig(num_particles=args.particles, **pf_kw),
                                    logger=_make_logger(args), posterior=post)
    else:
        flt = GPMDM_PF(model, T, num_particles=args.particles, config=PFConfig(**pf_kw),
                       seed=args.seed, posterior=post)
        report = evaluate_pf(flt, seqs, labels, n_classes=C, burn_in=args.burn_in,
                             logger=_make_logger(args))
    print(report.summary())
    return 0


def _cmd_rollout(args, device) -> int:
    from . import GPMDM

    model = GPMDM.load(args.ckpt, device=device)
    x0 = model.get_X_for_class(args.cls)[0].cpu().numpy()
    if model.dyn_back_step == 2:
        x0 = np.stack([x0, x0])
    traj = model.rollout(x0, args.steps, args.cls).cpu().numpy()
    print(traj)
    if args.plot:
        from .viz.latent import plot_pf_trajectory

        plot_pf_trajectory(model, traj, show=True)
    return 0


def _cmd_deploy(args, device) -> int:
    """Bake the deployment posterior into a checkpoint: the 'auto' policy's
    posterior, a pinned-rank compressed one or a sparsified one, saved with
    the checkpoint so later loads deploy it with no O(N^3) / O(N M^2) host
    precompute.  A sparse model is only re-saved (its posterior is
    persisted by save())."""
    from . import GPMDM
    from .filter.particle_filter import AUTO_COMPRESS_MAX_Q_FRAC, resolve_posterior

    model = GPMDM.load(args.ckpt, device=device)
    if not _sparsify_args_ok(args):
        return 2
    out = args.out or args.ckpt
    if args.sparsify:
        if args.rank_y or args.rank_x:
            print("--sparsify and --rank-y/--rank-x are mutually exclusive")
            return 2
        if not _exact_family_only(model, "--sparsify"):
            return 2
        post = model.sparsified_posterior(n_inducing_y=args.sparsify,
                                          n_inducing_x=args.sparsify_x or None,
                                          method=args.sparsify_method)
        kind = (f"sparsified (M_y={post.Zy.shape[0]}, "
                f"M_x={post.Zx.shape[1]}, method={args.sparsify_method})")
        # an explicit deploy --sparsify is the deployment decision:
        # posterior='auto' now resolves to these factors
        model._deploy_recommendation = {
            "family": "sparsified", "M": int(args.sparsify),
            "Mx": int(args.sparsify_x) if args.sparsify_x else None,
            "method": args.sparsify_method, "source": "deploy-cli",
        }
        model.save(out)
        print(f"deployed posterior: {kind}\nsaved {out}")
        return 0
    if args.rank_y or args.rank_x:
        if not _exact_family_only(model, "--rank-y/--rank-x"):
            return 2
        post = model.compressed_posterior(rank_y=args.rank_y or None,
                                          rank_x=args.rank_x or None)
        # the pinned factors are the deployment: aliased under the default
        # key, posterior='auto' picks them from the persisted cache
        model._compressed_cache[(None, None, 1e-6)] = post
        if post.rank_y > AUTO_COMPRESS_MAX_Q_FRAC * post.Uy.shape[0]:
            print(f"note: rank_y={post.rank_y} is past the q=N/2 "
                  "FLOP-parity bound — posterior='auto' deploys exact "
                  "there, so only an explicit posterior='compressed' / "
                  "compressed_posterior(rank_y=...) deployment uses "
                  "these factors (save also drops the auto alias)")
        kind = f"compressed (rank_y={post.rank_y}, rank_x={post.rank_x})"
    else:
        post = resolve_posterior(model, "auto")
        kind = (f"compressed (rank_y={post.rank_y}, rank_x={post.rank_x})"
                if hasattr(post, "rank_y") else type(post).__name__)
    model.save(out)
    print(f"deployed posterior: {kind}\nsaved {out}")
    return 0


def _cmd_demo(args, device) -> int:
    """Render the PF demo animation (the view_gpmdm_pf example)."""
    from .examples import view_gpmdm_pf

    return view_gpmdm_pf.main([args.ckpt, "--out", args.out,
                               "--particles", str(args.particles)])


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpmdm_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    pv = sub.add_parser("view", help="interactive skeleton viewer")
    pv.add_argument("asf")
    pv.add_argument("amc")
    pv.add_argument("--fps", type=int, default=120)
    pv.set_defaults(fn=_cmd_view, needs_device=False)

    def add_data_args(sp):
        sp.add_argument("--mocap-dir", default=None)
        sp.add_argument("--downsample", type=int, default=4)
        sp.add_argument("--jsonl", default=None,
                        help="write structured metric records (JSON lines) here")
        sp.add_argument("--trace", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of the run into DIR "
                             "(a Chrome trace: open it in Perfetto)")

    pt = sub.add_parser("train", help="train a GPMDM and save a checkpoint")
    add_data_args(pt)
    pt.add_argument("--out", default="gpmdm.npz")
    pt.add_argument("--latent-dim", type=int, default=4)
    pt.add_argument("--dyn-target", default="full", choices=["full", "delta"])
    pt.add_argument("--back-step", type=int, default=1, choices=[1, 2])
    pt.add_argument("--steps", type=int, default=500)
    pt.add_argument("--lr", type=float, default=0.01)
    pt.add_argument("--hyperprior", type=float, default=0.0, metavar="W",
                    help="log-space Gaussian hyperprior weight (centered at the init "
                         "hyperparameters); 0 = reference parity")
    pt.add_argument("--optimizer", default="adam", choices=["adam", "lbfgs"],
                    help="adam (reference parity) or lbfgs (second-order, "
                         "linesearch per step: use ~5-10x fewer --steps)")
    pt.add_argument("--dtype", default="float32")
    pt.add_argument("--sparse", action="store_true",
                    help="sparse inducing-point model (O(N M^2) training)")
    pt.add_argument("--inducing", type=int, default=64,
                    help="inducing points per GP (with --sparse)")
    pt.add_argument("--back-constrained", action="store_true",
                    help="back-constrained latents: X = k(Y,Y) W, smooth "
                         "observation->latent inverse map")
    pt.add_argument("--deploy", action="store_true",
                    help="also bake the auto-policy deployment posterior "
                         "into the checkpoint (see the deploy command)")
    pt.set_defaults(fn=_cmd_train)

    pe = sub.add_parser("eval", help="evaluate the particle filter on test trials")
    add_data_args(pe)
    pe.add_argument("ckpt")
    pe.add_argument("--particles", type=int, default=100)
    pe.add_argument("--resampling", default="systematic",
                    choices=["systematic", "multinomial"])
    pe.add_argument("--burn-in", type=int, default=0)
    pe.add_argument("--seed", type=int, default=0)
    post_group = pe.add_mutually_exclusive_group()
    post_group.add_argument("--compressed", action="store_true",
                            help="deploy the low-rank-quad compressed posterior")
    post_group.add_argument("--compress-rank", type=int, default=0,
                            help="pin the compressed quad rank (implies --compressed)")
    post_group.add_argument("--exact", action="store_true",
                            help="force the exact posterior even past the "
                                 "auto-compress size threshold")
    post_group.add_argument("--sparsify", type=int, default=0, metavar="M",
                            help="deploy a post-hoc SGPR distillation of the exact "
                                 "model with M inducing points")
    pe.add_argument("--sparsify-x", type=int, default=0, metavar="MX",
                    help="per-class dynamics inducing count for --sparsify "
                         "(default: same as M)")
    pe.add_argument("--sparsify-method", default="stride", choices=["stride", "kmeans"],
                    help="inducing-input selection for --sparsify")
    pe.add_argument("--banked", action="store_true",
                    help="stream ALL trials at once (one filter bank per trial)")
    pe.add_argument("--recon-precision", default=None,
                    choices=["default", "high", "highest"],
                    help="carried for the JAX package's compressed backend; the "
                         "port's products are IEEE fp32 whatever it says")
    pe.add_argument("--fuse-mean-quad", default="auto", choices=["auto", "on", "off"],
                    help="carried for the JAX package's compressed backend")
    pe.set_defaults(fn=_cmd_eval)

    pr = sub.add_parser("rollout", help="autoregressive latent rollout")
    pr.add_argument("ckpt")
    pr.add_argument("--cls", type=int, default=0)
    pr.add_argument("--steps", type=int, default=100)
    pr.add_argument("--plot", action="store_true")
    pr.set_defaults(fn=_cmd_rollout)

    pp = sub.add_parser("deploy", help="bake the deployment posterior into a checkpoint "
                                       "(skips the O(N^3) host precompute on later loads)")
    pp.add_argument("ckpt")
    pp.add_argument("--out", default=None, help="output path (default: overwrite ckpt)")
    pp.add_argument("--rank-y", type=int, default=0,
                    help="pin the observation quad rank (0 = spectral)")
    pp.add_argument("--rank-x", type=int, default=0,
                    help="pin the dynamics quad rank (0 = spectral)")
    pp.add_argument("--sparsify", type=int, default=0, metavar="M",
                    help="bake a post-hoc SGPR distillation with M inducing points "
                         "instead (exact family only)")
    pp.add_argument("--sparsify-x", type=int, default=0, metavar="MX",
                    help="per-class dynamics inducing count for --sparsify "
                         "(default: same as M)")
    pp.add_argument("--sparsify-method", default="stride", choices=["stride", "kmeans"],
                    help="inducing-input selection for --sparsify")
    pp.set_defaults(fn=_cmd_deploy)

    pd = sub.add_parser("demo", help="render the PF demo animation (GIF)")
    pd.add_argument("ckpt")
    pd.add_argument("--out", default="pf_demo.gif")
    pd.add_argument("--particles", type=int, default=100)
    pd.set_defaults(fn=_cmd_demo)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if not getattr(args, "needs_device", True):  # view: no model, no device
        return args.fn(args)
    device = _device()
    if device is None:
        return 2
    if getattr(args, "trace", None):
        from .utils.profiling import trace

        with trace(args.trace):
            rc = args.fn(args, device)
        print(f"profiler trace written to {args.trace}")
        return rc
    return args.fn(args, device)


if __name__ == "__main__":
    sys.exit(main())
