"""Evaluation metrics: classification accuracy and part-seg instance mIoU.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/utils/
metrics.py``: the numpy functions are copies, ``shape_ious_device`` is
its tensor form (same dense-table protocol and float32 arithmetic, so
the same values).

The mIoU protocol follows the PointNet eval convention the reference
inherits (SURVEY.md §3.5, hard part #6): for each *shape*, compute IoU per
part class **restricted to the parts of that shape's category**; a part
absent from both prediction and ground truth counts as IoU 1; average the
parts -> shape IoU; average shapes -> instance mIoU. Per-category mIoU
averages shape IoUs within each category.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from adversarial_learning_on_pointclouds_tpu_torch.data.shapenet_part import (
    CATEGORY_NAMES, CATEGORY_PART_RANGES, NUM_PARTS,
)

_MAX_PARTS = int(CATEGORY_PART_RANGES[:, 1].max())  # 6 (Motorbike)


def accuracy(log_probs: np.ndarray, labels: np.ndarray,
             mask: Optional[np.ndarray] = None) -> float:
    """Overall accuracy from ``[B, k]`` (log-)probabilities."""
    pred = np.argmax(np.asarray(log_probs), axis=-1)
    correct = (pred == np.asarray(labels))
    if mask is not None:
        return float(correct[mask].mean()) if mask.any() else 0.0
    return float(correct.mean())


def class_accuracies(pred: np.ndarray, labels: np.ndarray, num_classes: int,
                     ) -> Tuple[float, float]:
    """(overall acc, average per-class acc) — the reference's eval pair."""
    pred, labels = np.asarray(pred), np.asarray(labels)
    overall = float((pred == labels).mean())
    per_class = [
        float((pred[labels == c] == c).mean())
        for c in range(num_classes) if np.any(labels == c)
    ]
    return overall, float(np.mean(per_class))


def shape_ious(pred_parts: np.ndarray, gt_parts: np.ndarray,
               categories: np.ndarray) -> np.ndarray:
    """Per-shape IoU, category-restricted. All args numpy; returns [B]."""
    pred_parts = np.asarray(pred_parts)
    gt_parts = np.asarray(gt_parts)
    categories = np.asarray(categories)
    out = np.empty(len(categories), np.float64)
    for i, cat in enumerate(categories):
        start, count = CATEGORY_PART_RANGES[cat]
        ious = []
        for part in range(start, start + count):
            inter = np.sum((pred_parts[i] == part) & (gt_parts[i] == part))
            union = np.sum((pred_parts[i] == part) | (gt_parts[i] == part))
            ious.append(1.0 if union == 0 else inter / union)
        out[i] = float(np.mean(ious))
    return out


def instance_miou(pred_parts: np.ndarray, gt_parts: np.ndarray,
                  categories: np.ndarray) -> float:
    """Instance mIoU: mean of per-shape IoUs over all shapes."""
    return float(shape_ious(pred_parts, gt_parts, categories).mean())


def category_miou(pred_parts: np.ndarray, gt_parts: np.ndarray,
                  categories: np.ndarray) -> Dict[str, float]:
    """Per-category table (mean shape IoU within each present category)."""
    return category_miou_from_ious(
        shape_ious(pred_parts, gt_parts, categories), categories)


def category_miou_from_ious(ious: np.ndarray, categories: np.ndarray,
                            ) -> Dict[str, float]:
    """The per-category table from precomputed per-shape IoUs — used by
    the device eval path, which reads back only the [B] IoU vector
    (computed on device by ``shape_ious_device``) instead of the full
    per-point prediction tensor."""
    ious, categories = np.asarray(ious), np.asarray(categories)
    return {
        CATEGORY_NAMES[c]: float(ious[categories == c].mean())
        for c in np.unique(categories)
    }


def shape_ious_device(pred_parts: torch.Tensor, gt_parts: torch.Tensor,
                      categories: torch.Tensor) -> torch.Tensor:
    """Per-shape IoU on the tensors' device (same protocol), ``[B]``
    float32.

    Uses the dense ``CATEGORY_PART_RANGES`` table: for each shape, part
    slot j in [0, max_parts) maps to global part id start+j; slots beyond
    the category's part count are masked out of the mean. Each slot's IoU
    is a float32 quotient of integer counts, summed over the slots in
    order and divided by the count, as the JAX function computes it.
    """
    ranges = torch.as_tensor(CATEGORY_PART_RANGES, device=pred_parts.device)
    cats = categories.long()
    start = ranges[cats, 0][:, None]                    # [B, 1]
    count = ranges[cats, 1][:, None]                    # [B, 1]
    slots = torch.arange(_MAX_PARTS, device=pred_parts.device)[None, :]
    part_ids = start + slots                            # [B, P]
    valid = slots < count                               # [B, P]

    pred_onehot = pred_parts[:, :, None] == part_ids[:, None, :]  # [B, N, P]
    gt_onehot = gt_parts[:, :, None] == part_ids[:, None, :]
    inter = (pred_onehot & gt_onehot).sum(1, dtype=torch.int32)   # [B, P]
    union = (pred_onehot | gt_onehot).sum(1, dtype=torch.int32)
    iou = torch.where(union == 0, 1.0,
                      inter.float() / union.clamp(min=1).float())
    iou = torch.where(valid, iou, 0.0)
    total = iou[:, 0]
    for j in range(1, _MAX_PARTS):
        total = total + iou[:, j]
    return total / count[:, 0].float()


def confusion_matrix(pred: np.ndarray, labels: np.ndarray,
                     num_classes: int = NUM_PARTS) -> np.ndarray:
    flat = np.asarray(labels).reshape(-1) * num_classes + \
        np.asarray(pred).reshape(-1)
    return np.bincount(flat, minlength=num_classes ** 2).reshape(
        num_classes, num_classes)
