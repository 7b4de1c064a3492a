"""Pointwise FCN discriminator of the adversarial trainer.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/models/
discriminator.py`` (Hung et al.'s ``FCDiscriminator`` on points): a
per-point class-probability map ``[B, N, k]`` (``softmax(G(x))`` or
one-hot labels) through 1x1 convolutions k -> 64 -> 128 -> 256 -> 512 ->
1 with LeakyReLU(0.2) between them and no BatchNorm, to per-point
real/fake logits ``[B, N, 1]``. Parameter names are the reference's
(``conv1``..``conv4``, ``classifier``), so its ``.pth`` loads with
``strict=True``.

Every method runs the whole stack as one fused pass (``ops/kernels/
disc_fused.py``): the kernels on a CUDA tensor, their plain versions on
a CPU tensor. The methods differ in their backward, as the JAX package's
four custom VJPs do.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    disc_fused,
)


class FCDiscriminator(nn.Module):
    def __init__(self, num_parts: int = 50, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Conv1d(num_parts, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 256, 1)
        self.conv4 = nn.Conv1d(256, 512, 1)
        self.classifier = nn.Conv1d(512, 1, 1)
        core.finish_init(self, device, generator)

    def _params(self):
        layers = (self.conv1, self.conv2, self.conv3, self.conv4,
                  self.classifier)
        return (tuple(core.weight_in_out(m) for m in layers),
                tuple(m.bias for m in layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits; the backward reaches the input and the parameters."""
        return disc_fused.disc_forward(x, *self._params())

    def frozen(self, x: torch.Tensor) -> torch.Tensor:
        """Logits whose backward reaches the input only (the generator
        step): the parameters' ``.grad`` stays untouched."""
        return disc_fused.disc_forward_frozen(x, *self._params())

    def detached(self, x: torch.Tensor) -> torch.Tensor:
        """Logits whose backward reaches the parameters only (the
        discriminator step on one-hot labels): no input gradient."""
        return disc_fused.disc_forward_detached(x, *self._params())

    def with_known_logits(self, x: torch.Tensor,
                          logits: torch.Tensor) -> torch.Tensor:
        """``logits`` (a copy), which these parameters made from ``x``,
        with the parameters-only backward from ``x``: the discriminator
        step's fakes, whose forward the generator step already ran."""
        return disc_fused.disc_with_known_logits(x, logits, *self._params())
