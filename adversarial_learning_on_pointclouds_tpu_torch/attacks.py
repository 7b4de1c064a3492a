"""Adversarial input perturbations (config 5 and the robustness eval).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/attacks.py``:
FGSM on the point coordinates, ``x_adv = x + eps * sign(dL/dx)``, and
its iterated form with an L-inf projection (PGD). ``loss_fn`` maps the
points to a scalar loss, closing over the model and the labels; the
gradient is taken with respect to the points alone (the parameters'
``.grad`` stays untouched), and the perturbed cloud comes back detached,
as data, like the reference's detached attack tensor. ``attack`` runs
either on a classifier's eval-mode loss: config 5's training step and
the robustness eval both call it.

The attacks run the model's eval forward (BN running statistics,
nothing updated) under ``ops.dispatch.use_kernels(False)``, where the
eval-mode blocks take their plain versions, which autograd can
differentiate: the JAX package's attack runs its XLA path under
``use_pallas(False)`` for the same reason (its eval kernels have no
VJP). So no eval kernel launches inside an attack.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from adversarial_learning_on_pointclouds_tpu_torch import losses
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch


def input_grad(loss_fn: Callable[[torch.Tensor], torch.Tensor],
               points: torch.Tensor) -> torch.Tensor:
    """``dL/dx`` at ``points`` (detached), under ``use_kernels(False)``."""
    x = points.detach().requires_grad_(True)
    with torch.enable_grad(), dispatch.use_kernels(False):
        (g,) = torch.autograd.grad(loss_fn(x), x)
    return g


def fgsm_points(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                points: torch.Tensor, epsilon: float) -> torch.Tensor:
    """One-step FGSM on point coordinates: the perturbed cloud, detached."""
    g = input_grad(loss_fn, points)
    return (points + epsilon * torch.sign(g)).detach()


def iterated_fgsm_points(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                         points: torch.Tensor, epsilon: float, steps: int,
                         step_size: Optional[float] = None) -> torch.Tensor:
    """PGD-style iterated FGSM: ``steps`` steps of ``step_size`` (default
    ``epsilon / steps``), each projected back into the L-inf ball of
    radius ``epsilon`` around ``points``; the result detached."""
    alpha = step_size if step_size is not None else epsilon / max(steps, 1)
    x0 = points.detach()
    x = x0
    for _ in range(steps):
        x = x + alpha * torch.sign(input_grad(loss_fn, x))
        x = x0 + torch.clamp(x - x0, -epsilon, epsilon)
    return x


def attack(model: torch.nn.Module, points: torch.Tensor,
           labels: torch.Tensor, epsilon: float, steps: int = 0
           ) -> torch.Tensor:
    """The perturbed clouds (detached) of an attack on the eval-mode loss
    ``nll(model(x)[0], labels)``: FGSM at ``steps`` 0, else PGD with
    ``steps`` iterations. The model runs in eval mode (its BatchNorm
    running statistics read, not updated); its mode is restored after."""
    was_training = model.training
    model.eval()
    try:
        def loss(x):
            return losses.nll_loss(model(x)[0], labels)

        if steps > 0:
            return iterated_fgsm_points(loss, points, epsilon, steps)
        return fgsm_points(loss, points, epsilon)
    finally:
        model.train(was_training)
