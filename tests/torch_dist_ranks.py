"""Rank bodies of the distribution layer's CPU tests.

``tests/test_torch_parallel.py`` and ``tests/test_torch_dist_chol.py``
each start one group of 4 gloo ranks through ``parallel.launch``, which
runs a function of this module on every rank.  A spawned rank imports
this module and nothing of the test's: so it imports only torch
and the port, never jax or gpmdm_tpu.  The functions take and return
numpy arrays; the tests compare them with the JAX package in the parent.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import types

import torch

from gpmdm_tpu_torch import GPMDMConfig, PFConfig, TrainConfig
from gpmdm_tpu_torch import parallel as par
from gpmdm_tpu_torch.filter import particle_filter as pf
from gpmdm_tpu_torch.models import core
from gpmdm_tpu_torch.models.back_constrained import back_kernel
from gpmdm_tpu_torch.models.gpmdm import params_from_numpy
from gpmdm_tpu_torch.ops.layout import build_layout
from gpmdm_tpu_torch.parallel import sharded as SH
from gpmdm_tpu_torch.train.trainer import AdamState, trainable_mask
from gpmdm_tpu_torch.utils.metrics import evaluate_pf_banked

F64 = torch.float64
#: the ('ep', 'tp') meshes of the loss checks
TRAIN_MESHES = ((2, 2), (4, 1), (1, 4))


def _numpy(t):
    return t.detach().cpu().numpy()


def _model(spec: dict):
    """(config, layout, float64 params, Y) of a model spec from the parent."""
    cfg = GPMDMConfig.from_dict(spec["cfg"])
    layout = build_layout(spec["lengths"], spec["classes"], cfg.n_classes, cfg.dyn_back_step)
    return cfg, layout, params_from_numpy(spec["params"], F64, "cpu"), torch.as_tensor(spec["Y"])


def _losses_and_grads(spec: dict, meshes: dict) -> dict:
    """Loss and gradient of both loss forms, on each mesh and config."""
    _, layout, params, Y = _model(spec["model"])
    out = {}
    for name, cfg_dict in spec["loss_cfgs"].items():
        cfg = GPMDMConfig.from_dict(cfg_dict)
        for (ep, tp), mesh in meshes.items():
            for sc in (False, True):
                ctx = SH.make_context(cfg, layout, mesh, shard_chol=sc)
                Yp = SH.pad_Y(Y, ctx)
                loss, grads = SH.nll_sharded_value_and_grad(params, Yp, ctx)
                value = SH.nll_sharded(params, Yp, ctx)
                out[(name, ep, tp, sc)] = (float(loss), float(value), [_numpy(g) for g in grads])
    return out


def _collective_table(spec: dict, meshes: dict) -> dict:
    """Collectives of one training step (forward, backward, the gradient
    reduction) of each form on each mesh."""
    cfg, layout, params, Y = _model(spec["model"])
    out = {}
    for (ep, tp), mesh in meshes.items():
        for sc in (False, True):
            ctx = SH.make_context(cfg, layout, mesh, shard_chol=sc)
            step = SH.make_sharded_update_step(ctx, 0.01, 1.0,
                                               trainable_mask(cfg, "all"))
            out[(ep, tp, sc)] = par.count_collectives(step, params, AdamState.init(params),
                                                      SH.pad_Y(Y, ctx))
    return out


def _training(spec: dict) -> dict:
    """5 sharded Adam steps of each form on (ep, tp) = (2, 2), and the
    back-constrained model through ``latent_map`` on its class-aware mesh."""
    cfg, layout, params, Y = _model(spec["model"])
    tc = TrainConfig(num_steps=5, lr=0.01)
    mesh = par.make_mesh({"ep": 2, "tp": 2})
    out = {}
    for sc in (False, True):
        p, st, losses = par.train_adam_sharded(params, Y, cfg, layout, mesh, tc, shard_chol=sc)
        out[sc] = (_numpy(p.X), _numpy(losses), int(st.count))
    bcfg, blayout, bparams, bY = _model(spec["bc_model"])
    Kb = back_kernel(bY, bY, bcfg.back_constraint_ls, F64)
    latent_map = lambda q: dataclasses.replace(q, X=Kb @ q.X)  # noqa: E731
    bmesh = par.make_train_mesh(n_classes=bcfg.n_classes)
    p, _, losses = par.train_adam_sharded(bparams, bY, bcfg, blayout, bmesh, tc,
                                          latent_map=latent_map)
    out["bc"] = (_numpy(p.X), _numpy(losses), dict(zip(("ep", "tp"), bmesh.shape)))
    return out


def _predictions(spec: dict) -> dict:
    cfg, layout, params, Y = _model(spec["model"])
    post = core.precompute_host(spec["model"]["params"], spec["model"]["Y"], cfg, layout, "cpu")
    mesh = par.make_mesh({"sp": 4})
    Xstar = torch.as_tensor(spec["Xstar"])
    out = {}
    counts = {}
    for name, fn in (("y", par.predict_y_rowsharded),
                     ("x", par.predict_x_all_classes_rowsharded)):
        out[name] = [_numpy(a) for a in fn(post, params, Xstar, cfg, mesh)]
        counts[name] = par.count_collectives(fn, post, params, Xstar, cfg, mesh)
    try:
        par.predict_y_rowsharded(dataclasses.replace(post, X=post.X[:-2]), params, Xstar, cfg,
                                 mesh)
        out["guard"] = None
    except ValueError as e:
        out["guard"] = str(e)
    out["counts"] = counts
    return out


def _banks(spec: dict) -> dict:
    """The sharded bank scans on JAX's states and draws; the scan's
    collectives; evaluate_pf_banked with and without a mesh."""
    cfg, layout, params, Y = _model(spec["model"])
    post = core.precompute_host(spec["model"]["params"], spec["model"]["Y"], cfg, layout, "cpu")
    b = spec["banks"]
    pfc = PFConfig(num_particles=b["particles"], pallas="on")
    log_T = torch.as_tensor(b["log_T"])
    states = pf.PFState(**{k: torch.as_tensor(v) for k, v in b["states"].items()})
    noise = pf.PFNoise(**{k: torch.as_tensor(v) for k, v in b["noise"].items()})
    Z, valid = torch.as_tensor(b["Z"]), torch.as_tensor(b["valid"])
    mesh = par.make_mesh({"dp": 4})
    out = {}
    _, o = par.pf_scan_bank_sharded_masked(states, Z, valid, post, params, log_T, cfg, pfc,
                                           mesh, noise=noise, gather=True)
    out["masked"] = _numpy(o.class_probs)
    out["unsharded_masked"] = _numpy(pf.pf_scan_bank_masked(
        states, Z, valid, post, params, log_T, cfg, pfc, noise=noise)[1].class_probs)
    out["unsharded"] = _numpy(pf.pf_scan_bank(states, Z, post, params, log_T, cfg, pfc,
                                              noise=noise)[1].class_probs)
    local_states, local = par.pf_scan_bank_sharded(states, Z, post, params, log_T, cfg, pfc,
                                                   mesh, noise=noise)
    out["unmasked_local"] = (mesh.get_local_rank("dp"), _numpy(local.class_probs),
                             _numpy(local_states.x))
    out["unmasked"] = _numpy(par.gather_outputs(local, mesh).class_probs)
    out["scan_counts"] = par.count_collectives(
        par.pf_scan_bank_sharded, states, Z, post, params, log_T, cfg, pfc, mesh, noise=noise)
    out["gather_counts"] = par.count_collectives(par.gather_outputs, local, mesh)

    e = spec["eval"]
    model = types.SimpleNamespace(n_classes=cfg.n_classes, posterior=post, dtype=F64, D=cfg.D,
                                  layout=layout, params=params, config=cfg)
    kw = dict(num_particles=e["particles"], burn_in=2, seed=5)
    reps = {"mesh": evaluate_pf_banked(model, e["T"], e["seqs"], e["labels"], mesh=mesh, **kw),
            "plain": evaluate_pf_banked(model, e["T"], e["seqs"], e["labels"], **kw)}
    out["eval"] = {k: (r.frame_predictions, r.frame_confusion, r.total_frames)
                   for k, r in reps.items()}
    out["eval_counts"] = par.count_collectives(
        evaluate_pf_banked, model, e["T"], e["seqs"], e["labels"], mesh=mesh, **kw)
    return out


def parallel_checks(spec: dict) -> dict:
    """Every check of tests/test_torch_parallel.py, on this rank."""
    torch.set_num_threads(1)
    meshes = {shape: par.make_mesh({"ep": shape[0], "tp": shape[1]}) for shape in TRAIN_MESHES}
    out = {"loss": _losses_and_grads(spec, meshes),
           "counts": _collective_table(spec, meshes),
           "train": _training(spec),
           "predict": _predictions(spec),
           "banks": _banks(spec)}
    out["jax_imported"] = any(m.split(".")[0] in ("jax", "gpmdm_tpu") for m in sys.modules)
    return out


def dist_chol_checks(spec: dict) -> dict:
    """Every check of tests/test_torch_dist_chol.py, on this rank: its row
    panels of L, of the triangular solve, and its share of y_nll_dist's
    value and gradients."""
    torch.set_num_threads(1)
    mesh = par.make_mesh({"sp": 4})
    group = mesh.get_group("sp")
    K, Y, w2 = (torch.as_tensor(spec[k]) for k in ("K", "Y", "w2"))
    nb = K.shape[0] // 4
    rows = slice(mesh.get_local_rank("sp") * nb, (mesh.get_local_rank("sp") + 1) * nb)
    L = torch.linalg.cholesky(K)
    out = {"L": _numpy(par.chol_rowblock(K[rows], group)),
           "X": _numpy(par.tri_solve_lower_rowblock(L[rows], Y[rows], group))}
    K_i, Y_i, w2_ = (t.clone().requires_grad_(True) for t in (K[rows], Y[rows], w2))
    share = par.y_nll_dist(K_i, Y_i, w2_, group)
    share.backward()
    out["value"] = float(share)
    out["grads"] = [_numpy(t.grad) for t in (K_i, Y_i, w2_)]
    out["counts"] = {
        "chol": par.count_collectives(par.chol_rowblock, K[rows], group),
        "solve": par.count_collectives(par.tri_solve_lower_rowblock, L[rows], Y[rows], group),
        "value_and_grad": par.count_collectives(
            lambda: par.y_nll_dist(K[rows].clone().requires_grad_(True), Y[rows], w2,
                                   group).backward())}
    out["jax_imported"] = any(m.split(".")[0] in ("jax", "gpmdm_tpu") for m in sys.modules)
    return out


def fails(tag):
    """A rank body that raises (the launcher's error path)."""
    raise RuntimeError(f"rank failure {tag}")


def hangs():
    """A rank body that never returns (the launcher's wall limit)."""
    time.sleep(3600)
