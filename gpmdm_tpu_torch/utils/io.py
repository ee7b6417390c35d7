"""Model persistence: the JAX package's ``.npz`` format, version 1, both
ways, and the reference's torch pickle.

A checkpoint holds the config and the constructor's initial
hyperparameters as JSON (``meta_json``), the model class (``'GPMDM'``,
``'SparseGPMDM'`` with ``n_inducing_*``, or ``'BCGPMDM'``), the trained
parameters (``param_<field>``; a back-constrained model's W in the X
slot), the raw observation sequences (``obs_<class>_<i>``), the optimizer
state (``opt_<i>`` in optax's leaf order, with ``optimizer_name`` and
``lbfgs_memory`` in the meta: Adam's count, then its first and second
moments in the parameters' field order; or ``optax.lbfgs``'s 5 n + 7
leaves, ``train.lbfgs.LBFGSState``), the compressed-posterior cache
(``comp_<j>_<field>``, keyed by ``compressed_keys`` and
``compressed_entry_idx`` in the meta), the sparsified cache
(``sparsified_<j>_<field>``, keyed by ``sparsified_keys`` and
``sparsified_entry_idx``), a sparse model's own posterior
(``post_<field>``, with ``posterior_class``), the deployment
recommendation and the guard receipt.  Either package reads what the
other writes, and training of every family resumes from the saved Adam or
L-BFGS state; its integer leaves stay int32.  Loading defers the exact posterior's float64 factorization to its
first use, so a deployment served from a persisted cache never builds it;
a sparse model's posterior comes from its ``post_*`` arrays, or from an
O(N M^2) host build; a back-constrained model rematerializes X = K_b W
and builds its exact posterior at once, as the JAX package does.

``load_model`` takes the port's call ``load_model(file_path, device)`` and
the JAX package's ``load_model(cls, file_path, device=...)``, whose class
the checkpoint's ``model_class`` overrides, as there.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from ..config import GPMDMConfig
from ..models import core, sparse
from ..models.back_constrained import BCGPMDM
from ..models.compressed import CompressedPosterior
from ..models.gpmdm import GPMDM, params_from_numpy
from ..models.sparse_gpmdm import SparseGPMDM
from ..train.trainer import AdamState, LBFGSState
from .profiling import span

FORMAT_VERSION = 1

_CLASSES = {"GPMDM": GPMDM, "SparseGPMDM": SparseGPMDM, "BCGPMDM": BCGPMDM}
_COMP_FIELDS = [f.name for f in dataclasses.fields(CompressedPosterior)]


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _write_cache(arrays: dict, meta: dict, cache: dict, prefix: str, name: str,
                 fields) -> None:
    """A posterior cache as ``<prefix>_<j>_<field>`` arrays and the meta's
    ``<name>_keys`` / ``<name>_entry_idx`` lists: an entry cached under
    several keys is written once."""
    keys, entry_idx, seen = [], [], {}
    for key, post in cache.items():
        keys.append(list(key))
        j = seen.get(id(post))
        if j is None:
            j = seen[id(post)] = len(seen)
            for f in fields:
                arrays[f"{prefix}_{j}_{f}"] = _to_numpy(getattr(post, f))
        entry_idx.append(j)
    if keys:
        meta[f"{name}_keys"] = keys
        meta[f"{name}_entry_idx"] = entry_idx


def _read_cache(data, meta: dict, prefix: str, name: str, fields, build) -> dict:
    """The cache written by :func:`_write_cache`, each entry made once by
    ``build`` from its arrays keyed by field and shared by the keys that
    map to it (1:1 in checkpoints written before aliases)."""
    keys = meta.get(f"{name}_keys") or []
    idx = meta.get(f"{name}_entry_idx", list(range(len(keys))))
    built = {j: build({f: data[f"{prefix}_{j}_{f}"] for f in fields}) for j in set(idx)}
    return {tuple(k): built[j] for k, j in zip(keys, idx)}


def save_model(model: GPMDM, file_path) -> None:
    """Write ``model`` (a ``GPMDM``, ``SparseGPMDM`` or ``BCGPMDM``) as a
    format-1 checkpoint at exactly ``file_path``, with its compressed-posterior
    cache (an 'auto'-rank entry past the q = N/2 FLOP-parity bound, which
    ``resolve_posterior('auto')`` would not deploy, left out), its
    sparsified cache, a sparse model's own posterior, its deployment
    recommendation and its guard receipt; an entry cached under several
    keys is written once.
    """
    file_path = Path(file_path)
    meta = {
        "format_version": FORMAT_VERSION,
        "config": model.config.to_dict(),
        "model_class": type(model).__name__,
        "n_sequences_per_class": [len(s) for s in model.class_aware_observations_list],
        "initialized": model.params is not None,
        "has_opt_state": model._opt_state is not None,
        "optimizer_name": model._opt_name,
        "lbfgs_memory": model._lbfgs_memory,
        "init_hypers": {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                        for k, v in model._init_hypers.items()},
    }
    if isinstance(model, SparseGPMDM):
        meta["n_inducing_y"] = model.n_inducing_y
        meta["n_inducing_x"] = model.n_inducing_x
    arrays = {f"obs_{c}_{i}": np.asarray(s)
              for c, seqs in enumerate(model.class_aware_observations_list)
              for i, s in enumerate(seqs)}
    if model.params is not None:
        params = model._params_for_save()
        meta["param_fields"] = [f.name for f in dataclasses.fields(params)]
        for f in meta["param_fields"]:
            arrays[f"param_{f}"] = _to_numpy(getattr(params, f))
    if model._opt_state is not None:
        leaves = model._opt_state.to_numpy()
        meta["n_opt_leaves"] = len(leaves)
        arrays.update({f"opt_{i}": leaf for i, leaf in enumerate(leaves)})
    from ..filter.particle_filter import AUTO_COMPRESS_MAX_Q_FRAC

    comp = {key: post for key, post in model._compressed_cache.items()
            if not (key[0] is None
                    and post.rank_y > AUTO_COMPRESS_MAX_Q_FRAC * post.Uy.shape[0])}
    _write_cache(arrays, meta, comp, "comp", "compressed", _COMP_FIELDS)
    _write_cache(arrays, meta, model._sparsified_cache, "sparsified", "sparsified",
                 sparse.POSTERIOR_FIELDS)
    built = model._posterior
    if isinstance(built, sparse.SparsePosterior):
        meta["posterior_class"] = "SparsePosterior"
        for f in sparse.POSTERIOR_FIELDS:
            arrays[f"post_{f}"] = _to_numpy(getattr(built, f))
    if model._deploy_recommendation:
        meta["deploy_recommendation"] = model._deploy_recommendation
    if model._guard_receipt:
        meta["guard_receipt"] = model._guard_receipt
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    file_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(file_path, **arrays)
    # np.savez appends '.npz' to any other suffix: move the file to the
    # requested path, so load(path) finds what save(path) wrote
    if file_path.suffix != ".npz":
        written = file_path.with_name(file_path.name + ".npz")
        if written.exists():
            os.replace(written, file_path)


def load_model(*args, device="cuda") -> GPMDM:
    """Load a ``GPMDM``, ``SparseGPMDM`` or ``BCGPMDM`` checkpoint onto
    ``device``, with its Adam or L-BFGS state when it has one: an exact
    model with the exact posterior built at its first use, a sparse model
    with its persisted posterior (or one built on the host now), a
    back-constrained model with X = K_b W rematerialized and its exact
    posterior built; each with its compressed and sparsified caches.

    Called as ``load_model(file_path, device)`` or, as the JAX package's
    is, ``load_model(cls, file_path, device=...)``: the class a checkpoint
    loads as is its ``model_class``, whatever ``cls`` says."""
    with span("io.load_model"):
        if len(args) == 2 and isinstance(args[0], type):
            file_path = args[1]
        elif len(args) in (1, 2):
            file_path = args[0]
            if len(args) == 2:
                device = args[1]
        else:
            raise TypeError("load_model(file_path, device='cuda') or "
                            "load_model(cls, file_path, device='cuda')")
        file_path = Path(file_path)
        with np.load(file_path) as data:
            meta = json.loads(bytes(data["meta_json"]).decode("utf-8"))
            if meta.get("format_version") != FORMAT_VERSION:
                raise ValueError(
                    f"{file_path}: checkpoint format {meta.get('format_version')!r}, "
                    f"this reader takes {FORMAT_VERSION}"
                )
            model_class = meta.get("model_class", "GPMDM")
            if model_class not in _CLASSES:
                raise ValueError(f"{file_path}: unknown model_class {model_class!r}")
            if not meta["initialized"]:
                raise ValueError(f"{file_path}: checkpoint holds an untrained model")
            cfg = GPMDMConfig.from_dict(meta["config"])
            model = _CLASSES[model_class].from_config(cfg, device=device,
                                                      init_hypers=meta.get("init_hypers"))
            fields = meta.get("param_fields", list(core.PARAM_FIELDS))
            want = sparse.SPARSE_PARAM_FIELDS if model_class == "SparseGPMDM" else core.PARAM_FIELDS
            if tuple(fields) != want:
                raise ValueError(f"{file_path}: unexpected parameter fields {fields} "
                                 f"for {model_class!r}")
            if isinstance(model, SparseGPMDM):
                model.n_inducing_y = int(meta["n_inducing_y"])
                model.n_inducing_x = int(meta["n_inducing_x"])
            if isinstance(model, BCGPMDM):
                model._back_ls_arg = cfg.back_constraint_ls
            for c, n_seq in enumerate(meta["n_sequences_per_class"]):
                for i in range(n_seq):
                    model.add_data(data[f"obs_{c}_{i}"], c)
            host_params = {f: np.asarray(data[f"param_{f}"], dtype=np.float64) for f in fields}
            opt_leaves = None
            opt_name = meta.get("optimizer_name", "adam")
            if meta.get("has_opt_state"):
                if opt_name not in ("adam", "lbfgs"):
                    raise ValueError(f"{file_path}: unknown optimizer_name {opt_name!r}")
                opt_leaves = [data[f"opt_{i}"] for i in range(meta["n_opt_leaves"])]
            post_arrays = None
            if meta.get("posterior_class") == "SparsePosterior":
                post_arrays = {f: data[f"post_{f}"] for f in sparse.POSTERIOR_FIELDS}
            comp = _read_cache(
                data, meta, "comp", "compressed", _COMP_FIELDS,
                lambda a: CompressedPosterior.from_numpy(a, model.dtype, model.device))
            # the sparsified cache holds distillations of an exact model by
            # construction
            spc = _read_cache(data, meta, "sparsified", "sparsified", sparse.POSTERIOR_FIELDS,
                              lambda a: sparse.SparsePosterior.from_numpy(
                                  a, model.dtype, model.device, distilled=True))
        if isinstance(model, BCGPMDM):
            # the X slot holds W: X = K_b W, and the exact posterior of it
            model.layout = model._build_layout()
            model.params = params_from_numpy(host_params, model.dtype, model.device)
            model._W = model.params.X
            model._materialize()
        elif post_arrays is None:
            model.set_params(host_params, lazy=True)
        else:
            # the persisted factors: no O(N M^2) host build
            model.layout = model._build_layout()
            model.params = params_from_numpy(host_params, model.dtype, model.device)
            model.posterior = sparse.SparsePosterior.from_numpy(post_arrays, model.dtype,
                                                                model.device)
        # after the refresh, which empties the caches and drops the verdict:
        # all were made from these parameters
        model._compressed_cache, model._sparsified_cache = comp, spc
        model._deploy_recommendation = meta.get("deploy_recommendation") or None
        model._guard_receipt = meta.get("guard_receipt") or None
        if opt_leaves is not None:
            state_cls = LBFGSState if opt_name == "lbfgs" else AdamState
            model._opt_state = state_cls.from_numpy(opt_leaves, model.dtype, model.device,
                                                    type(model.params))
            model._opt_name = opt_name
            model._lbfgs_memory = int(meta.get("lbfgs_memory", 10))
        return model


def load_torch_model(file_path, device="cuda") -> GPMDM:
    """Import a reference-format torch checkpoint: a pickle holding
    ``{'state_dict', 'config_dict'}``, where ``config_dict`` carries the raw
    observation sequences and the linear-space initial hyperparameters.
    Unpickling runs code: load only files this program or the reference
    wrote."""
    save_dict = torch.load(file_path, map_location="cpu", weights_only=False)
    config_dict = save_dict["config_dict"]
    state_dict = save_dict["state_dict"]
    dtype = {"torch.float64": "float64", "torch.float32": "float32"}.get(
        str(config_dict.get("dtype", "torch.float64")), "float32")

    model = GPMDM(
        D=config_dict["D"], d=config_dict["d"], n_classes=config_dict["n_classes"],
        dyn_target=config_dict["dyn_target"], dyn_back_step=config_dict["dyn_back_step"],
        y_lambdas_init=np.asarray(config_dict["y_lambdas_init"]),
        y_lengthscales_init=np.asarray(config_dict["y_lengthscales_init"]),
        y_sigma_n_init=config_dict["y_sigma_n_init"],
        x_lambdas_init=np.asarray(config_dict["x_lambdas_init"]),
        x_lengthscales_init=np.asarray(config_dict["x_lengthscales_init"]),
        x_sigma_n_init=config_dict["x_sigma_n_init"],
        x_lin_coeff_init=np.asarray(config_dict["x_lin_coeff_init"]),
        sigma_n_num_Y=config_dict.get("sigma_n_num_Y", 0.0),
        sigma_n_num_X=config_dict.get("sigma_n_num_X", 0.0),
        dtype=dtype, device=device,
    )

    def to_np(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    for c, seqs in enumerate(config_dict["class_aware_observations_list"]):
        for s in seqs:
            model.add_data(to_np(s), c)
    # the posterior is built from the parameters in the model dtype, as the
    # JAX package builds it
    model.set_params({f: to_np(state_dict[f]).astype(model.config.np_dtype).astype(np.float64)
                      for f in core.PARAM_FIELDS})
    return model
