"""Classification metrics for particle-filter evaluation.

A numpy copy of ``gpmdm_tpu/utils/metrics.py``: per-frame and per-trial
confusion matrices, accuracy / precision / recall / F1, and throughput,
for a filter run trial by trial (``evaluate_pf``) or for every trial at
once in a bank of filters (``evaluate_pf_banked``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def confusion_matrix(pred: np.ndarray, true: np.ndarray, n_classes: int) -> np.ndarray:
    """Counts[p, t] = #frames predicted p with actual class t (the reference
    notebook's pred x actual orientation)."""
    pred = np.asarray(pred).astype(int).ravel()
    true = np.asarray(true).astype(int).ravel()
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (pred, true), 1)
    return cm


def binary_prf(cm: np.ndarray, positive: int = 0) -> Dict[str, float]:
    """Accuracy / precision / recall / F1 from a 2-class pred x actual
    confusion matrix, treating ``positive`` as the positive class."""
    tp = cm[positive, positive]
    fp = cm[positive].sum() - tp
    fn = cm[:, positive].sum() - tp
    total = cm.sum()
    acc = float(np.trace(cm) / total) if total else 0.0
    prec = float(tp / (tp + fp)) if (tp + fp) else 0.0
    rec = float(tp / (tp + fn)) if (tp + fn) else 0.0
    f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
    return {"accuracy": acc, "precision": prec, "recall": rec, "f1": f1}


def macro_prf(cm: np.ndarray) -> Dict[str, float]:
    """Macro-averaged precision/recall/F1 for >2 classes."""
    C = cm.shape[0]
    per = [binary_prf(cm, c) for c in range(C)]
    total = cm.sum()
    return {
        "accuracy": float(np.trace(cm) / total) if total else 0.0,
        "precision": float(np.mean([m["precision"] for m in per])),
        "recall": float(np.mean([m["recall"] for m in per])),
        "f1": float(np.mean([m["f1"] for m in per])),
    }


@dataclasses.dataclass
class EvalReport:
    """Aggregate PF evaluation over a set of labeled trials."""

    frame_confusion: np.ndarray  # (C, C) pred x actual, all frames
    trial_confusion: np.ndarray  # (C, C) pred x actual, one vote per trial
    frame_metrics: Dict[str, float]
    trial_metrics: Dict[str, float]
    total_frames: int
    total_wall_s: float

    @property
    def fps(self) -> float:
        return self.total_frames / self.total_wall_s if self.total_wall_s > 0 else 0.0

    def summary(self) -> str:
        f, t = self.frame_metrics, self.trial_metrics
        return (
            f"frames: acc={f['accuracy']:.4f} prec={f['precision']:.4f} "
            f"rec={f['recall']:.4f} f1={f['f1']:.4f}\n"
            f"trials: acc={t['accuracy']:.4f} f1={t['f1']:.4f}\n"
            f"throughput: {self.fps:.1f} fps ({self.total_frames} frames in "
            f"{self.total_wall_s:.2f}s)\n"
            f"frame confusion (pred x actual):\n{self.frame_confusion}\n"
            f"trial confusion (pred x actual):\n{self.trial_confusion}"
        )


def evaluate_pf(
    flt,
    test_seqs: Sequence[np.ndarray],
    test_labels: Sequence[int],
    n_classes: int,
    burn_in: int = 0,
    logger=None,
) -> EvalReport:
    """Stream every labeled trial through the filter (resetting between
    trials, as the reference notebook does) and aggregate metrics.

    A trial's vote is the majority frame prediction (reference: trial correct
    if >50% of frames correct, test_gpmdm_pf.ipynb cell 4).  The wall time
    of each trial ends when its predictions reach the host.  ``logger``
    (``utils.logging.MetricLogger``) gets one record per trial (frame
    accuracy, frames/s, predicted and true label) and one for the set.
    """
    frame_pred: List[np.ndarray] = []
    frame_true: List[np.ndarray] = []
    trial_pred: List[int] = []
    total_frames = 0
    wall = 0.0
    for i, (Z, label) in enumerate(zip(test_seqs, test_labels)):
        flt.reset()
        t0 = time.perf_counter()
        outs = flt.run(Z)
        preds = outs.most_likely_class.cpu().numpy()  # waits for the device
        trial_wall = time.perf_counter() - t0
        wall += trial_wall
        total_frames += len(preds)
        preds_eval = preds[burn_in:]
        frame_pred.append(preds_eval)
        frame_true.append(np.full(len(preds_eval), label))
        # trial vote from post-burn-in frames only, consistent with the
        # frame metrics
        counts = np.bincount(preds_eval, minlength=n_classes)
        trial_pred.append(int(np.argmax(counts)))
        if logger is not None:
            logger.log(step=i, trial_frame_acc=float(np.mean(preds_eval == label)),
                       trial_fps=len(preds) / trial_wall if trial_wall > 0 else 0.0,
                       pred_label=trial_pred[-1], true_label=int(label))

    rep = _report(frame_pred, frame_true, trial_pred, test_labels, n_classes,
                  total_frames, wall)
    if logger is not None:
        logger.log(step=len(trial_pred), frame_acc=rep.frame_metrics["accuracy"],
                   frame_f1=rep.frame_metrics["f1"], fps=rep.fps)
    return rep


def _report(frame_pred, frame_true, trial_pred, test_labels, n_classes: int,
            total_frames: int, wall: float) -> EvalReport:
    fcm = confusion_matrix(np.concatenate(frame_pred), np.concatenate(frame_true), n_classes)
    tcm = confusion_matrix(np.asarray(trial_pred), np.asarray(test_labels), n_classes)
    metric = binary_prf if n_classes == 2 else macro_prf
    return EvalReport(
        frame_confusion=fcm,
        trial_confusion=tcm,
        frame_metrics=metric(fcm),
        trial_metrics=metric(tcm),
        total_frames=total_frames,
        total_wall_s=wall,
    )


def evaluate_pf_banked(
    model,
    T_matrix,
    test_seqs: Sequence[np.ndarray],
    test_labels: Sequence[int],
    num_particles: Optional[int] = None,
    burn_in: int = 0,
    seed: int = 0,
    config=None,
    logger=None,
    posterior=None,
    max_banks: Optional[int] = None,
) -> EvalReport:
    """Evaluate every trial at once, one independent filter per trial.

    The banked counterpart of :func:`evaluate_pf`: sequences are
    zero-padded to one length bucket (``bucket_length``) with prefix
    validity masks, and the whole set streams through one
    ``pf_scan_bank_masked`` call on the model's device.  Metrics match
    :func:`evaluate_pf` in distribution; the random streams differ (the
    banks draw from one generator seeded with ``seed``).

    An explicit ``num_particles`` wins over ``config``'s.  ``posterior``
    overrides the model's own and must be an exact posterior
    (``models.core.Posterior``), the only kind the port has.
    ``max_banks`` caps the filters per call: chunks are padded to exactly
    ``max_banks`` rows (invalid, sliced off), and the random streams then
    depend on the chunking.  ``logger`` (``utils.logging.MetricLogger``)
    gets one record per trial and one for the set.  The JAX
    package's ``mesh`` (banks spread over devices) is not ported yet.
    """
    import torch

    from ..config import PFConfig
    from ..filter import particle_filter as pf
    from ..models import core

    B = len(test_seqs)
    n_classes = model.n_classes
    if config is not None and num_particles is not None:
        pfc = dataclasses.replace(config, num_particles=num_particles)
    elif config is not None:
        pfc = config
    else:
        pfc = PFConfig(num_particles=num_particles or 100)
    post = posterior if posterior is not None else model.posterior
    if not isinstance(post, core.Posterior):
        raise TypeError("evaluate_pf_banked: the port has only the exact posterior "
                        f"(models.core.Posterior), got {type(post).__name__}")
    dev = post.X.device
    log_T = torch.log(torch.as_tensor(np.asarray(T_matrix, dtype=np.float64),
                                      device=dev).to(model.dtype))

    lengths = [len(Z) for Z in test_seqs]
    T_pad = pf.bucket_length(max(lengths))
    Bc = B if max_banks is None else min(max_banks, B)
    n_chunks = -(-B // Bc)
    Zb = np.zeros((n_chunks * Bc, T_pad, model.D), dtype=np.float64)
    valid = np.zeros((n_chunks * Bc, T_pad), dtype=bool)
    for i, Z in enumerate(test_seqs):
        Zb[i, : lengths[i]] = np.asarray(Z)
        valid[i, : lengths[i]] = True
    Zb = torch.as_tensor(Zb, device=dev).to(model.dtype)
    valid_t = torch.as_tensor(valid, device=dev)

    generator = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    pred_chunks = []
    for lo in range(0, n_chunks * Bc, Bc):
        states = pf.pf_init_bank(post, model.layout.y_class_offsets, generator, pfc, Bc)
        _, outs = pf.pf_scan_bank_masked(states, Zb[lo:lo + Bc], valid_t[lo:lo + Bc],
                                         post, model.params, log_T, model.config, pfc,
                                         generator=generator)
        pred_chunks.append(outs.most_likely_class.cpu().numpy())  # waits for the device
    wall = time.perf_counter() - t0
    preds_all = np.concatenate(pred_chunks, axis=0)[:B]  # (B, T_pad)

    frame_pred, frame_true, trial_pred = [], [], []
    total_frames = 0
    for i, label in enumerate(test_labels):
        preds = preds_all[i, : lengths[i]]
        total_frames += len(preds)
        pe = preds[burn_in:]
        frame_pred.append(pe)
        frame_true.append(np.full(len(pe), label))
        trial_pred.append(int(np.argmax(np.bincount(pe, minlength=n_classes))))
        if logger is not None:
            logger.log(step=i, trial_frame_acc=float(np.mean(pe == label)),
                       pred_label=trial_pred[-1], true_label=int(label))
    rep = _report(frame_pred, frame_true, trial_pred, test_labels, n_classes,
                  total_frames, wall)
    if logger is not None:
        logger.log(step=B, frame_acc=rep.frame_metrics["accuracy"],
                   frame_f1=rep.frame_metrics["f1"], fps=rep.fps)
    return rep
