"""Checkpoint loading: the JAX package's ``.npz`` format, version 1.

A checkpoint holds the config as JSON (``meta_json``), the trained
parameters (``param_<field>``) and the raw observation sequences
(``obs_<class>_<i>``).  This reader takes the exact ``GPMDM`` family only.
Optimizer state (``opt_*``) and the JAX package's posterior caches
(``sparsified_*``, ``comp_*``) are not read: the exact posterior is rebuilt
from the parameters in float64 on the host.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..config import GPMDMConfig
from ..models import core
from ..models.gpmdm import GPMDM

FORMAT_VERSION = 1


def load_model(file_path, device="cuda") -> GPMDM:
    """Load a trained exact GPMDM onto ``device``."""
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
        model = GPMDM(cfg, device=device)
        for c, n_seq in enumerate(meta["n_sequences_per_class"]):
            for i in range(n_seq):
                model.add_data(data[f"obs_{c}_{i}"], c)
        fields = meta.get("param_fields", list(core.PARAM_FIELDS))
        if tuple(fields) != core.PARAM_FIELDS:
            raise ValueError(f"{file_path}: unexpected parameter fields {fields}")
        host_params = {f: np.asarray(data[f"param_{f}"], dtype=np.float64)
                       for f in fields}
    model.set_params(host_params)
    return model
