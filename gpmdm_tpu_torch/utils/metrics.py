"""Classification metrics for particle-filter evaluation.

A numpy copy of the looped half of ``gpmdm_tpu/utils/metrics.py``:
per-frame and per-trial confusion matrices, accuracy / precision / recall /
F1, and throughput.  The banked evaluation waits for the filter banks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

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
) -> EvalReport:
    """Stream every labeled trial through the filter (resetting between
    trials, as the reference notebook does) and aggregate metrics.

    A trial's vote is the majority frame prediction (reference: trial correct
    if >50% of frames correct, test_gpmdm_pf.ipynb cell 4).  The wall time
    of each trial ends when its predictions reach the host.
    """
    frame_pred: List[np.ndarray] = []
    frame_true: List[np.ndarray] = []
    trial_pred: List[int] = []
    total_frames = 0
    wall = 0.0
    for Z, label in zip(test_seqs, test_labels):
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
