"""Semantic segmentation metrics (seggroup_tpu/eval/semantic.py):
confusion-matrix mIoU and per-class average precision.

`average_precision` computes scikit-learn's `average_precision_score` in
numpy, so the port needs no scikit-learn: the step-wise sum of
(R_n - R_{n-1}) * P_n over the distinct score thresholds, tied scores
counted together."""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
                     ignore: int = 255) -> torch.Tensor:
    """(C, C) int64 counts; rows = ground truth, columns = prediction.
    Ignored rows count into a spare bin, so nothing waits for the device."""
    ok = (label != ignore) & (label >= 0) & (label < num_classes)
    cc = num_classes * num_classes
    idx = torch.where(ok, label.long() * num_classes
                      + torch.clamp(pred.long(), 0, num_classes - 1), cc)
    flat = torch.zeros(cc + 1, dtype=torch.int64, device=idx.device)
    flat.index_add_(0, idx, torch.ones_like(idx))
    return flat[:cc].reshape(num_classes, num_classes)


def miou_from_confusion(hist: np.ndarray) -> tuple[float, np.ndarray]:
    hist = np.asarray(hist, np.float64)
    inter = np.diag(hist)
    union = hist.sum(0) + hist.sum(1) - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = np.where(union > 0, inter / union, np.nan)
    return float(np.nanmean(iou)), iou


def _binary_average_precision(positive: np.ndarray, score: np.ndarray) -> float:
    order = np.argsort(score, kind="mergesort")[::-1]
    s, t = score[order], positive[order]
    # the last position of each run of equal scores is one threshold
    idx = np.r_[np.flatnonzero(np.diff(s)), len(s) - 1]
    tps = np.cumsum(t, dtype=np.float64)[idx]
    precision = tps / (idx + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def average_precision(probs: np.ndarray, labels: np.ndarray,
                      num_classes: int, ignore: int = 255) -> np.ndarray:
    """Per-class average precision from softmax probs; classes absent from
    `labels` yield NaN."""
    ok = (labels != ignore) & (labels >= 0) & (labels < num_classes)
    probs, labels = probs[ok], labels[ok]
    out = np.full(num_classes, np.nan)
    for c in range(num_classes):
        pos = labels == c
        if pos.any():
            out[c] = _binary_average_precision(pos, probs[:, c])
    return out
