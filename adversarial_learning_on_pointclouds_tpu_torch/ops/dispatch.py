"""The building blocks the models call, eval and train.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/dispatch.py``.
The JAX package chooses between its jnp ops and its
Pallas kernels with the ``use_pallas`` context; here the choice is the
device of the tensor alone (``ops/launch.on_cpu``): every call below that
reaches a kernel wrapper runs the kernel on a CUDA tensor and the
kernel's plain version on a CPU tensor.

The train-mode blocks (``linear_bn_act`` with a BN in train mode,
``linear_act``, ``max_points``, ``batched_transform``) are plain PyTorch
under autograd, as the JAX package runs them outside Pallas, unless the
per-layer training kernels are switched on: ``use_pallas_train()`` is
the counterpart of the JAX package's ``use_pallas(training=True)``
(``bench.py --pallas_train``). Under it every 3-D training matmul runs
``pointwise_matmul``, every max over points ``maxpool_points`` and every
``x @ T`` ``tnet_apply``; the models also send the single-stream T-Net
fc head to ``fc_head_train`` and, at a point count the fused training
kernels of the JAX package cannot tile (``train_tiling_ok``), run the
trunks, the seg head and the discriminator layer by layer
(``layer_by_layer``). Off the
switch the port runs its fused kernels at every point count.

The eval-mode blocks (``linear_bn_act`` with a BN in eval mode on ``[B,
N, C]``, ``stack_maxpool``, ``seg_head``) run the eval kernels, which
have no backward: on the card a forward that autograd records raises
there. ``use_kernels(False)`` is the counterpart of the JAX package's
``use_pallas(False)``: within it every block runs its kernel's plain
version on a CUDA tensor too (``plain``): the eval blocks, so that an
eval-mode forward can be differentiated with respect to its input (the
attacks, ``attacks.py``, enter it), and the training forward, which then
runs layer by layer (``layer_by_layer``) with the T-Net heads in plain
PyTorch; the switch's per-layer kernels are off. Point sharding
(``parallel/point.py``) enters it too, as the JAX package forces its XLA
path there, and ``max_points`` then reduces over every rank's points
(``parallel.dist.all_reduce_max_points``). Every eval block honours the
mixed-precision scope (``core.mixed_precision``): bf16 matmul operands
with fp32 sums, in the kernels and in the plain versions.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
from torch import nn

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    encoder_fused, maxpool_points, shared_mlp, tnet_apply,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist

_state = threading.local()


def pallas_train_enabled() -> bool:
    """Whether the per-layer training kernels are on (off by default, and
    off within ``use_kernels(False)``)."""
    return getattr(_state, "pallas_train", False) and kernels_enabled()


@contextlib.contextmanager
def use_pallas_train(enabled: bool = True):
    """Within the context, training runs the per-layer kernels, as the JAX
    package's ``use_pallas(training=True)``. Read when a forward runs, per
    thread; the autograd functions keep what their forward chose."""
    prev = getattr(_state, "pallas_train", False)
    _state.pallas_train = enabled
    try:
        yield
    finally:
        _state.pallas_train = prev


def kernels_enabled() -> bool:
    """Whether the blocks run the kernels (on by default)."""
    return not getattr(_state, "no_kernels", False)


@contextlib.contextmanager
def use_kernels(enabled: bool = True):
    """``use_kernels(False)``: within the context every block runs its
    kernel's plain PyTorch version on every device, which autograd can
    differentiate, and the per-layer training kernels of
    ``use_pallas_train`` are off, as the JAX package's ``use_pallas(
    False)``. Read when a forward runs, per thread."""
    prev = kernels_enabled()
    _state.no_kernels = not enabled
    try:
        yield
    finally:
        _state.no_kernels = not prev


def plain() -> bool:
    """Whether the blocks run their plain versions: within
    ``use_kernels(False)``, or where the point axis is sharded across
    ranks (no kernel reduces over another rank's points)."""
    return not kernels_enabled() or dist.points_sharded()


def _tile_n(n: int, cap: int = 512) -> int:
    """The JAX kernels' point tile: the largest of cap, 256, ..., 8
    dividing ``n``, else ``n`` (``shared_mlp.py:62-66`` there)."""
    for t in (cap, 256, 128, 64, 32, 16, 8):
        if t <= cap and n % t == 0:
            return t
    return n


def train_tiling_ok(n: int, cap: int = 512) -> bool:
    """Whether the JAX package's fused training kernels tile ``n`` points
    (``dispatch.py:40-60`` there); where they do not (N = 2500, say) it
    trains layer by layer."""
    return n <= cap or _tile_n(n, cap=cap) != n


def layer_by_layer(n: int) -> bool:
    """Whether the trunks, the seg head and the discriminator run layer by
    layer: on the plain path (``plain``), and under ``use_pallas_train`` at
    a point count the JAX package's fused training kernels cannot tile,
    where they run through ``pointwise_matmul`` and ``maxpool_points``, as
    the JAX package runs them there."""
    return plain() or (pallas_train_enabled() and not train_tiling_ok(n))


def folded_affine(layer: nn.Module, bn: nn.BatchNorm1d
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold eval BN into ``(w, shift, scale)`` with ``act((x @ w) * scale
    + shift) == act(bn(x @ w + b))``; ``w`` is the ``[in, out]`` view of
    the layer's weight (no copy)."""
    scale, shift = core.bn_affine(bn)
    return core.weight_in_out(layer), layer.bias * scale + shift, scale


def _matmul(layer: nn.Module, x: torch.Tensor,
            frozen: bool = False) -> torch.Tensor:
    """``x @ w + b`` of a training layer: ``pointwise_matmul`` on a 3-D
    ``x`` under the switch, else ``core.matmul`` (as ``core.dense``).
    ``frozen``: the weight and bias enter detached, so the
    backward reaches ``x`` alone (no dW pass; their ``.grad`` stays
    untouched)."""
    w, b = core.weight_in_out(layer), layer.bias
    if frozen:
        w, b = w.detach(), b.detach()
    if pallas_train_enabled() and x.dim() == 3:
        return shared_mlp.pointwise_matmul(x, w, b)
    return core.matmul(x, w) + b


def linear_bn_act(layer: nn.Module, bn: nn.BatchNorm1d, x: torch.Tensor,
                  act: Optional[str] = "relu") -> torch.Tensor:
    """``act(bn(x @ w + b))``, by ``bn``'s mode.

    Train: ``_matmul`` and ``core.batch_norm_train`` (batch moments,
    running statistics updated in place), differentiable.
    Eval: BN folded; per-point ``[B, N, C]`` input runs the fused kernel
    (``fused_linear_affine_act``); ``[B, C]`` rows (the T-Net and
    classifier fc heads), and every input on the plain path (``plain``),
    run as the JAX package's XLA path runs them, the scale folded into the
    weight: ``core.matmul(x, w * scale) + shift`` (the folded weight the
    bf16 operand under ``core.mixed_precision``)."""
    if bn.training:
        return core.activation(core.batch_norm_train(bn, _matmul(layer, x)),
                               act)
    w, shift, scale = folded_affine(layer, bn)
    if x.dim() == 3 and not plain():
        return shared_mlp.fused_linear_affine_act(x, w, shift, scale, act)
    return core.activation(core.matmul(x, w * scale) + shift, act)


def linear_bn_act_pair(layer: nn.Module, bn: nn.BatchNorm1d,
                       x_a: torch.Tensor, x_b: torch.Tensor,
                       act: Optional[str] = "relu"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode ``linear_bn_act`` of two same-shape streams as one
    ``[2B, N, C]`` matmul (``_matmul``: ``pointwise_matmul`` under the
    switch) with per-stream BN statistics (``batch_norm_train_grouped``,
    the running statistics chained a -> b), as the JAX package's
    ``linear_bn_act_pair`` (``--paired_conv1``)."""
    z = core.batch_norm_train_grouped(
        bn, _matmul(layer, torch.cat([x_a, x_b])), 2)
    h = core.activation(z, act)
    return h[:x_a.shape[0]], h[x_a.shape[0]:]


def stack_maxpool(x: torch.Tensor, layers, acts) -> torch.Tensor:
    """An eval-mode pointwise stack and its max over points, ``[B, N, c0]
    -> [B, c_out]``: ``layers`` are ``(w, shift, scale)`` of
    ``folded_affine``, one activation per layer. ``fused_stack_maxpool``,
    or its plain version on the plain path (bf16 operands under
    ``core.mixed_precision``), whose max under point sharding spans every
    rank's points."""
    ws, shifts, scales = zip(*layers)
    if plain():
        bf16 = core.compute_dtype() is not None
        if dist.points_sharded():
            return encoder_fused.fused_stack_maxpool_plain(
                x, ws, shifts, scales, acts, bf16,
                pool=dist.all_reduce_max_points)
        return encoder_fused.fused_stack_maxpool_plain(x, ws, shifts, scales,
                                                       acts, bf16)
    return encoder_fused.fused_stack_maxpool(x, ws, shifts, scales, acts)


def seg_head(pf: torch.Tensor, g: torch.Tensor, *params) -> torch.Tensor:
    """The eval-mode seg head, ``seg_head_fused``'s arguments:
    ``seg_head_fused``, or its plain version on the plain path (bf16
    operands under ``core.mixed_precision``)."""
    if plain():
        return encoder_fused.seg_head_fused_plain(
            pf, g, *params, core.compute_dtype() is not None)
    return encoder_fused.seg_head_fused(pf, g, *params)


def linear_act(layer: nn.Module, x: torch.Tensor,
               act: Optional[str] = None,
               frozen: bool = False) -> torch.Tensor:
    """``act(x @ w + b)``, no BN (the seg head's last layer, the
    discriminator's layers), through ``_matmul``; ``frozen``: the layer's
    parameters get no gradient (the discriminator inside the generator
    step)."""
    return core.activation(_matmul(layer, x, frozen), act)


def max_points(x: torch.Tensor) -> torch.Tensor:
    """Symmetric max over the point axis: ``[B, N, C] -> [B, C]``; over
    every rank's points under point sharding
    (``dist.all_reduce_max_points``), ``maxpool_points`` under the switch
    (the gradient to the first point attaining each max)."""
    if dist.points_sharded():
        return dist.all_reduce_max_points(x)
    if pallas_train_enabled() and x.dim() == 3:
        return maxpool_points.maxpool_points(x)
    return x.amax(dim=1)


def batched_transform(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-cloud ``x @ T`` (the reference's ``torch.bmm(points, trans)``):
    ``tnet_apply`` under the switch (fp32), else ``core.matmul`` (bf16
    operands under the mixed-precision scope)."""
    if pallas_train_enabled() and x.dim() == 3:
        return tnet_apply.tnet_apply(x, t)
    return core.matmul(x, t)
