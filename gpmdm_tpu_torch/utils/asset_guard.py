"""The deployment assets' accuracy guard: the held-out banked protocol that
wrote the committed assets' guard receipts, for the port.

Counterpart of ``gpmdm_tpu/utils/asset_guard.py`` (``SHAPES``,
``guard_trials``, ``params_fingerprint``; ``guard_report`` returns the
whole report, whose frame accuracy and F1 are the JAX package's
``guard_score``): synthetic trials from the generator configuration each
asset was trained on, streamed through
:func:`gpmdm_tpu_torch.utils.metrics.evaluate_pf_banked`.
The same trials and the same fingerprint as the JAX package's, so a score
on the card sits beside the receipt a checkpoint carries
(``model._guard_receipt``).  It takes either family: the ``'sparse'``
shapes are the ``SparseGPMDM`` assets' (``hourlong``, whose receipt also
stands for ``hourlongh``, and ``sparse10240``).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

# config name -> guard shape, as the asset scripts trained each asset.
# guard_len overrides the test-trial length (the class-cycle parameters
# are deterministic in the class index, so shorter trials draw from the
# same distribution); guard_banks caps the filters a call.
SHAPES = {
    "headlinef": dict(family="exact", n_seqs=4, seq_len=60),
    "d4f": dict(family="exact", n_seqs=4, seq_len=60, d=4),
    "c8f": dict(family="exact", n_seqs=2, seq_len=60, C=8, D=10,
                data=dict(center_spread=3.0, class_signature=1.0, seed=21)),
    "c8": dict(family="exact", n_seqs=2, seq_len=60, C=8, D=10,
               data=dict(center_spread=3.0, class_signature=1.0, seed=21)),
    "n2048": dict(family="exact", n_seqs=16, seq_len=64),
    "n5120": dict(family="exact", n_seqs=32, seq_len=80),
    "sparse10240": dict(family="sparse", n_seqs=64, seq_len=80),
    "c8n5120": dict(family="exact", n_seqs=8, seq_len=80, C=8, D=10, guard_banks=16,
                    data=dict(center_spread=3.0, class_signature=1.0, seed=21)),
    "hourlong": dict(family="sparse", n_seqs=2, seq_len=27_000, guard_len=600),
}


def guard_trials(config_name: str):
    """``(seqs, labels, T_matrix)``: 6 held-out test sequences a class from
    the config's generator, and the transition matrix (0.9 to stay)."""
    from ..data import synthetic

    shape = SHAPES[config_name]
    C = shape.get("C", 2)
    _, _, q_seqs, q_labels = synthetic.make_dataset(
        n_classes=C, n_train_seqs=1, n_test_seqs=6,
        seq_len=shape.get("guard_len", shape["seq_len"]), D=shape.get("D", 35),
        **shape.get("data", dict(seed=0)))
    T = np.full((C, C), 0.1 / (C - 1), dtype=np.float64)
    np.fill_diagonal(T, 0.9)
    return [np.asarray(s) for s in q_seqs], q_labels, T


def guard_report(model, config_name: str, particles: int = 500, posterior=None,
                 seed: int = 0):
    """The ``EvalReport`` of ``model`` under the guard protocol (burn-in 5,
    ``guard_banks`` filters a call).  ``posterior=None`` scores the
    model's own posterior; pass ``resolve_posterior(model, 'auto')`` to
    score what a deployment serves."""
    from ..config import PFConfig
    from .metrics import evaluate_pf_banked

    seqs, labels, T = guard_trials(config_name)
    return evaluate_pf_banked(
        model, T, seqs, labels, num_particles=particles, burn_in=5, seed=seed,
        config=PFConfig(), max_banks=SHAPES[config_name].get("guard_banks"),
        posterior=posterior)


def params_fingerprint(params) -> str:
    """sha256 over the parameters in field order (name, shape, bytes) of a
    ``GPMDMParams`` or a ``SparseParams``: the JAX package's fingerprint,
    which binds a guard receipt to the exact parameters it was measured
    on."""
    h = hashlib.sha256()
    for f in dataclasses.fields(params):
        leaf = getattr(params, f.name).detach().cpu().numpy()
        h.update(f.name.encode())
        h.update(str(leaf.shape).encode())
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()
