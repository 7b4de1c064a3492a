"""Losses of the segmentation and adversarial steps.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/losses.py``:
``nll_loss`` and ``orthogonality_reg``, and Hung et al.'s adversarial
objectives (arXiv:1802.07934): the generator's adversarial loss (eq. 3),
the discriminator's real/fake loss (eq. 2) and the confidence-masked
semi-supervised loss (eq. 4-5), with its D-free control
``self_train_loss``.

Under data parallelism and point sharding (``parallel/dist.py``) each
rank's loss is its share of the global loss (``dist.mean_share``), so
that the ranks' losses, and their gradients, sum to the global ones: a
mean over the batch or the points is the local sum over the global
count, and a term computed on replicated values (the orthogonality
regularizer of a point-sharded step's transforms) enters once. At world
size 1 every loss is the plain mean.
"""

from __future__ import annotations

from typing import Optional

import torch

from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist

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
    [...]``; the rank's share of it at world size above 1."""
    return -dist.mean_share(_pick_class(log_probs, labels))


def orthogonality_reg(trans: Optional[torch.Tensor]) -> torch.Tensor:
    """``mean_b || I - A_b A_b^T ||_F`` over a batch of ``k x k``
    transforms (the reference's ``feature_transform_regularizer``)."""
    if trans is None:
        return torch.zeros(())
    eye = torch.eye(trans.shape[-1], dtype=trans.dtype, device=trans.device)
    gram = torch.matmul(trans, trans.transpose(-1, -2))
    return dist.mean_share(torch.linalg.norm(eye - gram, dim=(-2, -1)))


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross-entropy on logits (torch ``BCEWithLogitsLoss``)
    in the JAX package's stable form ``max(z, 0) - z t + log(1 +
    exp(-|z|))``; the rank's share of it at world size above 1."""
    z = logits
    return dist.mean_share(torch.clamp(z, min=0) - z * target
                           + torch.log1p(torch.exp(-z.abs())))


def adv_g_loss(d_logits: torch.Tensor) -> torch.Tensor:
    """The generator's adversarial loss: ``BCE(D(softmax(G(x))), real)``."""
    return bce_with_logits(d_logits, 1.0)


def d_loss(d_logits_real: torch.Tensor,
           d_logits_fake: torch.Tensor) -> torch.Tensor:
    """The discriminator's loss: real on one-hot labels, fake on
    predictions."""
    return bce_with_logits(d_logits_real, 1.0) + bce_with_logits(
        d_logits_fake, 0.0)


def _masked_pseudo_label_nll(log_probs: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """Mean NLL of the argmax pseudo-labels over the masked points (0 on
    an empty mask); mask and pseudo-labels carry no gradient. At world
    size above 1 the count of masked points is every rank's."""
    pseudo = log_probs.detach().argmax(-1)
    mask = mask.detach().to(log_probs.dtype)
    denom = mask.sum()
    if dist.spans(True):
        denom = dist.all_reduce_(denom.clone(), "sum", "stats")
    denom = torch.clamp(denom, min=1.0)
    return -(_pick_class(log_probs, pseudo) * mask).sum() / denom


def semi_loss(log_probs: torch.Tensor, d_logits: torch.Tensor,
              threshold: float) -> torch.Tensor:
    """Self-training on unlabeled points where ``sigmoid(D) >
    threshold``: ``log_probs [B, N, k]``, ``d_logits [B, N, 1]``."""
    return _masked_pseudo_label_nll(
        log_probs, torch.sigmoid(d_logits[..., 0]) > threshold)


def self_train_loss(log_probs: torch.Tensor,
                    threshold: float) -> torch.Tensor:
    """``semi_loss`` with the generator's own confidence (max softmax >
    threshold) as the mask: the D-free control."""
    return _masked_pseudo_label_nll(
        log_probs, log_probs.detach().amax(-1).exp() > threshold)
