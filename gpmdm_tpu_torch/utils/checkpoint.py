"""Mid-training checkpoints with atomic writes.

The npz pair of ``gpmdm_tpu/utils/checkpoint.py``, in the same file
format: the parameters' leaves (``p_<i>``, in the field order of their
class: ``GPMDMParams`` or ``SparseParams``), the Adam state's leaves
(``o_<i>``: count, then the first and second moments), the step and the
loss history, written to a temporary file and renamed, so a run killed
mid-write leaves the previous snapshot whole.  A snapshot written by
either package loads in the other.  The JAX package's orbax pair is not
ported.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..train.trainer import AdamState, _leaves, _like


def save_train_state(path, params, opt_state: AdamState, step: int, losses=None) -> None:
    """Atomically write {params, opt_state, step, losses} as one .npz."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    p_leaves = _leaves(params)
    arrays = {f"p_{i}": t.detach().cpu().numpy() for i, t in enumerate(p_leaves)}
    o_leaves = opt_state.to_numpy()
    arrays.update({f"o_{i}": leaf for i, leaf in enumerate(o_leaves)})
    meta = {"step": int(step), "n_params": len(p_leaves), "n_opt": len(o_leaves)}
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    if losses is not None:
        arrays["losses"] = (losses.detach().cpu().numpy() if torch.is_tensor(losses)
                            else np.asarray(losses))
    tmp = path.with_suffix(path.suffix + ".tmp")
    np.savez_compressed(tmp, **arrays)
    # numpy appends .npz to the tmp name
    tmp_actual = tmp if tmp.exists() else Path(str(tmp) + ".npz")
    os.replace(tmp_actual, path)


def load_train_state(path, params_template) -> Tuple[object, AdamState, int,
                                                     Optional[np.ndarray]]:
    """Load a snapshot into the template parameters' class, onto their
    device and dtypes (the Adam moments take X's dtype).  The JAX
    package's version also takes an optimizer-state template; the port has
    one optimizer state, so it needs none.

    Returns (params, opt_state, step, losses-or-None)."""
    dev = params_template.X.device
    template = _leaves(params_template)
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
        if meta["n_params"] != len(template):
            raise ValueError(f"{path}: {meta['n_params']} parameter leaves, expected "
                             f"{len(template)} of {type(params_template).__name__}")
        params = _like(params_template, [
            torch.as_tensor(data[f"p_{i}"], device=dev).to(t.dtype)
            for i, t in enumerate(template)])
        opt_state = AdamState.from_numpy([data[f"o_{i}"] for i in range(meta["n_opt"])],
                                         params.X.dtype, dev, type(params_template))
        losses = np.asarray(data["losses"]) if "losses" in data else None
    return params, opt_state, meta["step"], losses
