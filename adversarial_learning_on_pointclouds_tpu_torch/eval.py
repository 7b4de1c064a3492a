"""Evaluation loops of the classifier and the part segmenter (SURVEY.md
§2.6, §3.5).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/eval.py``.
Classification: overall and average per-class accuracy (the reference's
eval pair). Segmentation: per-shape category-restricted IoU averaged
over shapes (instance mIoU), point accuracy and the per-category table.
The eval forward is the model's eval mode (``train/classify.py`` and
``train/segment.py``: ``eval_step``, ``eval_scan``), on a card the
serving kernels.

The ``*_device`` forms read device-resident test pools in one loop of
forwards and read back one or two ``[S, B]`` vectors per pass; the
others stream host batches (pad + mask for the ragged last one) and
read back each batch's predictions. Both give the same summary (and
table).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from adversarial_learning_on_pointclouds_tpu_torch import attacks

from adversarial_learning_on_pointclouds_tpu_torch.data.loader import (
    host_batch_iterator, to_device,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    classify, segment,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import metrics
from adversarial_learning_on_pointclouds_tpu_torch.utils.logging import (
    HostFetch,
)


def _eval_indices(n: int, batch_size: int):
    """Sequential batch index plan for a device-resident test pool:
    ``[S, B]`` int32 rows covering 0..n-1 in order (final batch padded by
    wrapping) + the flat validity mask selecting the first n outputs —
    the device twin of ``batch_iterator(shuffle=False, drop_last=False)``'s
    pad+mask protocol."""
    s = -(-n // batch_size)
    flat = np.arange(s * batch_size) % n
    mask = np.arange(s * batch_size) < n
    return flat.reshape(s, batch_size).astype(np.int32), mask


def _eval_plan(n: int, batch_size: int, device):
    """``_eval_indices`` with the ``[S, B]`` plan sent to ``device``
    (pinned, non-blocking on a card) and the mask kept on the host."""
    idx, mask = _eval_indices(n, batch_size)
    return to_device((idx,), device)[0], mask


def summarize_classifier_preds(preds, labels: np.ndarray, mask: np.ndarray,
                               num_classes: int = 40) -> Dict[str, float]:
    """Host-side reduction of a ``classify.eval_scan``-shaped ``[S, B]``
    prediction array (a tensor or an array) into the accuracy summary."""
    pred = HostFetch({"pred": preds}).get()["pred"].reshape(-1)[mask]
    overall, avg_class = metrics.class_accuracies(pred, labels, num_classes)
    return {"accuracy": overall, "avg_class_accuracy": avg_class,
            "num_examples": float(len(labels))}


def evaluate_classifier_device(model, pool_x: torch.Tensor,
                               labels: np.ndarray, batch_size: int = 32,
                               num_classes: int = 40) -> Dict[str, float]:
    """``evaluate_classifier`` against a device-resident test pool through
    ``classify.eval_scan``: one ``[S, B]`` readback per pass."""
    idx, mask = _eval_plan(len(labels), batch_size, pool_x.device)
    preds = classify.eval_scan(model, pool_x, idx)
    return summarize_classifier_preds(preds, labels, mask, num_classes)


def evaluate_classifier(model, points: np.ndarray, labels: np.ndarray,
                        batch_size: int = 32, num_classes: int = 40
                        ) -> Dict[str, float]:
    """Overall and average per-class accuracy, streaming host batches to
    the model's device: every batch's forward is queued first and the
    predictions read back afterwards."""
    device = next(model.parameters()).device
    pending = []
    for (pts, lab), mask in _eval_batches((points, labels), batch_size,
                                          device):
        out = classify.eval_step(model, pts, lab)
        pending.append((HostFetch({"pred": out["pred"], "lab": lab}), mask))
    preds, gts = [], []
    for fetch, mask in pending:
        h = fetch.get()
        preds.append(h["pred"][mask])
        gts.append(h["lab"][mask])
    gt = np.concatenate(gts)
    overall, avg_class = metrics.class_accuracies(np.concatenate(preds), gt,
                                                  num_classes)
    return {"accuracy": overall, "avg_class_accuracy": avg_class,
            "num_examples": float(len(gt))}


def evaluate_robustness(model, points: np.ndarray, labels: np.ndarray,
                        epsilons: Sequence[float], batch_size: int = 32,
                        pgd_steps: int = 0) -> Dict[float, float]:
    """Accuracy under attack at each ``epsilon`` (the JAX package's
    ``scripts/eval_robustness.py``): per batch, FGSM (``pgd_steps`` 0) or
    PGD with ``pgd_steps`` steps on the eval-mode loss (``attacks.attack``,
    no eval kernel inside), then the eval forward on the perturbed
    clouds; ``epsilon`` 0 is the clean accuracy. The ragged last batch is
    padded and its pad rows masked out, so every test cloud counts once.
    Returns ``{epsilon: accuracy}``."""
    device = next(model.parameters()).device
    batches = list(_eval_batches((points, labels), batch_size, device))
    out = {}
    for eps in epsilons:
        pending = []
        for (pts, lab), mask in batches:
            x = pts
            if eps > 0:
                x = attacks.attack(model, pts, lab, eps, pgd_steps)
            ok = classify.eval_step(model, x, lab)["pred"] == lab
            pending.append((HostFetch({"ok": ok}), mask))
        correct = sum(int(f.get()["ok"][m].sum()) for f, m in pending)
        out[eps] = correct / max(len(labels), 1)
    return out


def summarize_segmenter_outs(outs, part_labels: np.ndarray,
                             categories: np.ndarray, mask: np.ndarray,
                             ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Host-side reduction of a ``segment.eval_scan``-shaped output
    (``{"ious": [S,B], "correct": [S,B]}``, tensors or arrays) into the
    eval summary + the per-category mIoU table."""
    host = HostFetch(outs).get()
    n = len(part_labels)
    npts = part_labels.shape[-1]
    iou_all = host["ious"].reshape(-1)[mask]
    correct = host["correct"].reshape(-1)[mask]
    summary = {
        "instance_miou": float(iou_all.mean()),
        "point_accuracy": float(correct.sum() / (n * npts)),
        "num_shapes": float(n),
    }
    table = metrics.category_miou_from_ious(iou_all, categories)
    return summary, table


def evaluate_segmenter_device(model, pool_x: torch.Tensor,
                              pool_s: torch.Tensor, pool_c: torch.Tensor,
                              part_labels: np.ndarray,
                              categories: np.ndarray, batch_size: int = 32,
                              ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """``evaluate_segmenter`` against device-resident test pools through
    ``segment.eval_scan``: only per-shape reductions (IoU and
    correct-point counts) come back to the host, once per pass; the
    per-category table derives from the IoU vector and the host
    ``categories`` copy (``part_labels`` supplies point count and n)."""
    idx, mask = _eval_plan(len(part_labels), batch_size, pool_x.device)
    outs = segment.eval_scan(model, pool_x, pool_s, pool_c, idx)
    return summarize_segmenter_outs(outs, part_labels, categories, mask)


def _eval_batches(arrays, batch_size: int, device):
    """Eval-order batches, ``(data_batch, mask)``: ``host_batch_iterator``
    at ``shuffle=False, drop_last=False`` (the final ragged batch padded),
    its data sent to ``device`` and its validity mask kept on the host."""
    for *data, mask in host_batch_iterator(arrays, batch_size,
                                           shuffle=False, drop_last=False):
        yield to_device(data, device), mask


def evaluate_segmenter(model, points: np.ndarray, part_labels: np.ndarray,
                       categories: np.ndarray, batch_size: int = 32,
                       ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Returns (summary, per-category mIoU table), streaming host batches
    to the model's device. Every batch's forward is queued first and the
    outputs are read back afterwards (non-blocking copies started per
    batch), so the readbacks do not serialize the forwards."""
    device = next(model.parameters()).device
    pending = []
    for batch, mask in _eval_batches((points, part_labels, categories),
                                     batch_size, device):
        pts, lab, cat = batch
        out = segment.eval_step(model, pts, lab, cat)
        pending.append((HostFetch({"ious": out["ious"], "pred": out["pred"],
                                   "lab": lab, "cat": cat}), mask))
    ious, accs, preds, gts, cats = [], [], [], [], []
    for fetch, mask in pending:
        h = fetch.get()
        iou, pred, labn, catn = (h["ious"][mask], h["pred"][mask],
                                 h["lab"][mask], h["cat"][mask])
        ious.append(iou)
        accs.append((pred == labn).mean(axis=1))
        preds.append(pred)
        gts.append(labn)
        cats.append(catn)
    iou_all = np.concatenate(ious)
    summary = {
        "instance_miou": float(iou_all.mean()),
        "point_accuracy": float(np.concatenate(accs).mean()),
        "num_shapes": float(len(iou_all)),
    }
    table = metrics.category_miou(np.concatenate(preds), np.concatenate(gts),
                                  np.concatenate(cats))
    return summary, table
