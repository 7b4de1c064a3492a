"""The eval building blocks the models call.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/dispatch.py``
for the eval path. The JAX package chooses between its jnp ops and its
Pallas kernels with the ``use_pallas`` context; here the choice is the
device of the tensor alone (``ops/launch.on_cpu``): every call below that
reaches a kernel wrapper runs the kernel on a CUDA tensor and the
kernel's plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import shared_mlp


def folded_affine(layer: nn.Module, bn: nn.BatchNorm1d
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold eval BN into ``(w, shift, scale)`` with ``act((x @ w) * scale
    + shift) == act(bn(x @ w + b))``; ``w`` is the ``[in, out]`` view of
    the layer's weight (no copy)."""
    scale, shift = core.bn_affine(bn)
    return core.weight_in_out(layer), layer.bias * scale + shift, scale


def linear_bn_act(layer: nn.Module, bn: nn.BatchNorm1d, x: torch.Tensor,
                  act: Optional[str] = "relu") -> torch.Tensor:
    """Eval ``act(bn(x @ w + b))``. Per-point ``[B, N, C]`` input runs the
    fused kernel (``fused_linear_affine_act``); ``[B, C]`` rows (the T-Net
    fc heads) stay plain ``torch.matmul``, as the JAX package leaves them
    to XLA."""
    w, shift, scale = folded_affine(layer, bn)
    if x.dim() == 3:
        return shared_mlp.fused_linear_affine_act(x, w, shift, scale, act)
    return core.activation(torch.matmul(x, w) * scale + shift, act)


def max_points(x: torch.Tensor) -> torch.Tensor:
    """Symmetric max over the point axis: ``[B, N, C] -> [B, C]``."""
    return x.amax(dim=1)


def batched_transform(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-cloud ``x @ T`` (the reference's ``torch.bmm(points, trans)``)."""
    return torch.bmm(x, t)
