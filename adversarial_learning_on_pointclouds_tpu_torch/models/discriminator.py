"""Pointwise FCN discriminator of the adversarial trainer.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/models/
discriminator.py`` (Hung et al.'s ``FCDiscriminator`` on points): a
per-point class-probability map ``[B, N, k]`` (``softmax(G(x))`` or
one-hot labels) through 1x1 convolutions k -> 64 -> 128 -> 256 -> 512 ->
1 with LeakyReLU(0.2) between them and no BatchNorm, to per-point
real/fake logits ``[B, N, 1]``. Parameter names are the reference's
(``conv1``..``conv4``, ``classifier``), so its ``.pth`` loads with
``strict=True``.

The training methods run the whole stack as one fused pass (``ops/
kernels/disc_fused.py``): the kernels on a CUDA tensor, their plain
versions on a CPU tensor. They differ in their backward, as the JAX
package's four custom VJPs do. Under ``ops.dispatch.use_pallas_train``
at a point count the JAX package's fused kernels cannot tile
(``ops.dispatch.layer_by_layer``), ``forward``, ``frozen`` and
``detached`` run the stack layer by layer instead, through
``pointwise_matmul`` and LeakyReLU, as the JAX package's
``apply_discriminator`` does there. ``infer`` is the inference-only
stack, one ``fused_mlp_stack`` chain (the JAX package's
``apply_discriminator_fused``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch as ops
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    disc_fused, shared_mlp,
)

_ACTS = ("leaky_relu",) * 4 + (None,)


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

    def _layers(self):
        return (self.conv1, self.conv2, self.conv3, self.conv4,
                self.classifier)

    def _params(self):
        return (tuple(core.weight_in_out(m) for m in self._layers()),
                tuple(m.bias for m in self._layers()))

    def _layerwise(self, x: torch.Tensor,
                   frozen: bool = False) -> torch.Tensor:
        for m, act in zip(self._layers(), _ACTS):
            x = ops.linear_act(m, x, act, frozen)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits; the backward reaches the input and the parameters."""
        if ops.layer_by_layer(x.shape[1]):
            return self._layerwise(x)
        return disc_fused.disc_forward(x, *self._params())

    def frozen(self, x: torch.Tensor) -> torch.Tensor:
        """Logits whose backward reaches the input only (the generator
        step): the parameters' ``.grad`` stays untouched."""
        if ops.layer_by_layer(x.shape[1]):
            return self._layerwise(x, frozen=True)
        return disc_fused.disc_forward_frozen(x, *self._params())

    def detached(self, x: torch.Tensor) -> torch.Tensor:
        """Logits whose backward reaches the parameters only (the
        discriminator step on one-hot labels): no input gradient."""
        if ops.layer_by_layer(x.shape[1]):
            return self._layerwise(x.detach())
        return disc_fused.disc_forward_detached(x, *self._params())

    @torch.no_grad()
    def infer(self, x: torch.Tensor) -> torch.Tensor:
        """Logits for inference, with no autograd: the five layers as one
        ``fused_mlp_stack`` chain (biases as shifts, unit scales, LeakyReLU
        on the first four), the kernel on a CUDA tensor and its plain
        version on a CPU tensor; bf16 operands under
        ``core.mixed_precision``. Counterpart of the JAX package's
        ``apply_discriminator_fused``."""
        ws, bs = self._params()
        scales = [torch.ones_like(b) for b in bs]
        return shared_mlp.fused_mlp_stack(x, ws, bs, scales, _ACTS)

    def with_known_logits(self, x: torch.Tensor,
                          logits: torch.Tensor) -> torch.Tensor:
        """``logits`` (a copy), which these parameters made from ``x``,
        with the parameters-only backward from ``x``: the discriminator
        step's fakes, whose forward the generator step already ran."""
        return disc_fused.disc_with_known_logits(x, logits, *self._params())
