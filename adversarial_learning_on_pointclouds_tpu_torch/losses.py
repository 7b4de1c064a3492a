"""Losses of the segmentation step.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/losses.py``
(``nll_loss``, ``orthogonality_reg``); the adversarial objectives come
with the adversarial step.
"""

from __future__ import annotations

from typing import Optional

import torch

# Weight of the feature-transform regularizer in the training loss (the
# JAX package's train/classify.py FT_REG_WEIGHT, the PointNet paper's).
FT_REG_WEIGHT = 0.001


def _pick_class(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``log_probs[..., labels]`` as a one-hot contraction, as the JAX
    package picks (the zero terms add exactly nothing)."""
    one_hot = torch.nn.functional.one_hot(labels.long(), log_probs.shape[-1])
    return (log_probs * one_hot.to(log_probs.dtype)).sum(-1)


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over every leading axis (torch
    ``NLLLoss`` with mean reduction): ``log_probs [..., k]``, ``labels
    [...]``."""
    return -_pick_class(log_probs, labels).mean()


def orthogonality_reg(trans: Optional[torch.Tensor]) -> torch.Tensor:
    """``mean_b || I - A_b A_b^T ||_F`` over a batch of ``k x k``
    transforms (the reference's ``feature_transform_regularizer``)."""
    if trans is None:
        return torch.zeros(())
    eye = torch.eye(trans.shape[-1], dtype=trans.dtype, device=trans.device)
    gram = torch.matmul(trans, trans.transpose(-1, -2))
    return torch.linalg.norm(eye - gram, dim=(-2, -1)).mean()
