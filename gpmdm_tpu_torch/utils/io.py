"""Model persistence: the JAX package's ``.npz`` format, version 1, both
ways, and the reference's torch pickle.

A checkpoint holds the config and the constructor's initial
hyperparameters as JSON (``meta_json``), the trained parameters
(``param_<field>``), the raw observation sequences (``obs_<class>_<i>``)
and the Adam state (``opt_<i>``, optax's leaf order: count, then the first
and second moments in ``PARAM_FIELDS`` order).  Either package reads what
the other writes, and training resumes from the saved Adam state.  This
reader takes the exact ``GPMDM`` family only.  The JAX package's posterior
caches (``comp_*``, ``sparsified_*``) are neither read nor written, and an
L-BFGS state is not read: the exact posterior is rebuilt from the
parameters in float64 on the host.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from ..config import GPMDMConfig
from ..models import core
from ..models.gpmdm import GPMDM
from ..train.trainer import AdamState

FORMAT_VERSION = 1


def save_model(model: GPMDM, file_path) -> None:
    """Write ``model`` as a format-1 checkpoint at exactly ``file_path``.

    The posterior caches of the JAX package (``comp_*``, ``sparsified_*``)
    are not written: the port builds neither.
    """
    file_path = Path(file_path)
    meta = {
        "format_version": FORMAT_VERSION,
        "config": model.config.to_dict(),
        "model_class": "GPMDM",
        "n_sequences_per_class": [len(s) for s in model.class_aware_observations_list],
        "initialized": model.params is not None,
        "has_opt_state": model._opt_state is not None,
        "optimizer_name": "adam",
        "init_hypers": {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                        for k, v in model._init_hypers.items()},
    }
    arrays = {f"obs_{c}_{i}": np.asarray(s)
              for c, seqs in enumerate(model.class_aware_observations_list)
              for i, s in enumerate(seqs)}
    if model.params is not None:
        meta["param_fields"] = list(core.PARAM_FIELDS)
        for f in core.PARAM_FIELDS:
            arrays[f"param_{f}"] = getattr(model.params, f).detach().cpu().numpy()
    if model._opt_state is not None:
        leaves = model._opt_state.to_numpy()
        meta["n_opt_leaves"] = len(leaves)
        arrays.update({f"opt_{i}": leaf for i, leaf in enumerate(leaves)})
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    file_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(file_path, **arrays)
    # np.savez appends '.npz' to any other suffix: move the file to the
    # requested path, so load(path) finds what save(path) wrote
    if file_path.suffix != ".npz":
        written = file_path.with_name(file_path.name + ".npz")
        if written.exists():
            os.replace(written, file_path)


def load_model(file_path, device="cuda") -> GPMDM:
    """Load an exact GPMDM checkpoint onto ``device``, with its Adam state
    when it has one."""
    file_path = Path(file_path)
    with np.load(file_path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode("utf-8"))
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"{file_path}: checkpoint format {meta.get('format_version')!r}, "
                f"this reader takes {FORMAT_VERSION}"
            )
        model_class = meta.get("model_class", "GPMDM")
        if model_class != "GPMDM":
            raise ValueError(
                f"{file_path}: model_class {model_class!r} is not ported; "
                "this reader takes the exact 'GPMDM' family only"
            )
        if not meta["initialized"]:
            raise ValueError(f"{file_path}: checkpoint holds an untrained model")
        cfg = GPMDMConfig.from_dict(meta["config"])
        model = GPMDM.from_config(cfg, device=device, init_hypers=meta.get("init_hypers"))
        for c, n_seq in enumerate(meta["n_sequences_per_class"]):
            for i in range(n_seq):
                model.add_data(data[f"obs_{c}_{i}"], c)
        fields = meta.get("param_fields", list(core.PARAM_FIELDS))
        if tuple(fields) != core.PARAM_FIELDS:
            raise ValueError(f"{file_path}: unexpected parameter fields {fields}")
        host_params = {f: np.asarray(data[f"param_{f}"], dtype=np.float64) for f in fields}
        opt_leaves = None
        if meta.get("has_opt_state") and meta.get("optimizer_name", "adam") == "adam":
            opt_leaves = [data[f"opt_{i}"] for i in range(meta["n_opt_leaves"])]
    model.set_params(host_params)
    if opt_leaves is not None:
        model._opt_state = AdamState.from_numpy(opt_leaves, model.dtype, model.device)
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
