"""Mid-training checkpoints with atomic writes.

The npz pair of ``gpmdm_tpu/utils/checkpoint.py``, in the same file
format: the parameters' leaves (``p_<i>``, in the field order of their
class: ``GPMDMParams`` or ``SparseParams``), the optimizer state's leaves
(``o_<i>``, optax's order: Adam's count, then its first and second moments;
or ``optax.lbfgs``'s 5 n + 7 leaves), the step and the loss history,
written to a temporary file and renamed, so a run killed mid-write leaves
the previous snapshot whole.  A snapshot written by either package loads
in the other.

``save_train_state_orbax`` / ``load_train_state_orbax`` keep the names of
the JAX package's orbax pair, for its callers: they write and read this
npz.  Orbax imports JAX, so the port cannot write orbax's format, and the
JAX package's orbax loader cannot read what these names write.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..train.trainer import AdamState, LBFGSState, _leaves, _like


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _state_cls(n_opt: int, params_template, opt_state_template):
    """The optimizer state class of a snapshot of ``n_opt`` leaves: the
    template's when given, else the one whose leaf count it is (Adam's
    1 + 2 n, L-BFGS's 5 n + 7, for n parameter fields)."""
    if opt_state_template is not None:
        return type(opt_state_template)
    n = len(_leaves(params_template))
    by_count = {1 + 2 * n: AdamState, 5 * n + 7: LBFGSState}
    if n_opt not in by_count:
        raise ValueError(f"{n_opt} optimizer leaves: neither an Adam ({1 + 2 * n}) nor an "
                         f"L-BFGS ({5 * n + 7}) state over {type(params_template).__name__}")
    return by_count[n_opt]


def _restore(p_leaves, o_leaves, params_template, opt_state_template):
    """(params, opt_state) on the template parameters' device and dtypes."""
    dev = params_template.X.device
    template = _leaves(params_template)
    if len(p_leaves) != len(template):
        raise ValueError(f"{len(p_leaves)} parameter leaves, expected {len(template)} of "
                         f"{type(params_template).__name__}")
    params = _like(params_template, [torch.as_tensor(np.array(a, order="C"), device=dev)
                                     .to(t.dtype) for a, t in zip(p_leaves, template)])
    state_cls = _state_cls(len(o_leaves), params_template, opt_state_template)
    opt_state = state_cls.from_numpy(o_leaves, params.X.dtype, dev, type(params_template))
    return params, opt_state


def save_train_state(path, params, opt_state, step: int, losses=None) -> None:
    """Atomically write {params, opt_state, step, losses} as one .npz;
    ``opt_state`` an ``AdamState`` or an ``LBFGSState``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    p_leaves = _leaves(params)
    arrays = {f"p_{i}": _numpy(t) for i, t in enumerate(p_leaves)}
    o_leaves = opt_state.to_numpy()
    arrays.update({f"o_{i}": leaf for i, leaf in enumerate(o_leaves)})
    meta = {"step": int(step), "n_params": len(p_leaves), "n_opt": len(o_leaves)}
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    if losses is not None:
        arrays["losses"] = _numpy(losses)
    tmp = path.with_suffix(path.suffix + ".tmp")
    np.savez_compressed(tmp, **arrays)
    # numpy appends .npz to the tmp name
    tmp_actual = tmp if tmp.exists() else Path(str(tmp) + ".npz")
    os.replace(tmp_actual, path)


def load_train_state(path, params_template, opt_state_template=None
                     ) -> Tuple[object, object, int, Optional[np.ndarray]]:
    """Load a snapshot into the template parameters' class, onto their
    device and dtypes (the optimizer state's floating leaves take X's
    dtype).  The state is of ``opt_state_template``'s class when one is
    given, as in the JAX package's call, else of the optimizer whose leaf
    count the snapshot holds.

    Returns (params, opt_state, step, losses-or-None)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
        params, opt_state = _restore([data[f"p_{i}"] for i in range(meta["n_params"])],
                                     [data[f"o_{i}"] for i in range(meta["n_opt"])],
                                     params_template, opt_state_template)
        losses = np.asarray(data["losses"]) if "losses" in data else None
    return params, opt_state, meta["step"], losses


# The names of the JAX package's orbax pair, on the npz pair: the port
# cannot write orbax's format (orbax imports JAX).
save_train_state_orbax = save_train_state
load_train_state_orbax = load_train_state
