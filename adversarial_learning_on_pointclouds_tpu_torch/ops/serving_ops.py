"""The three eval kernels as registered operators: what a kernels serving
artifact (``utils/serving.py``, ``kernels=True``) holds in its graph.

Counterpart of the Mosaic custom calls that the JAX package's
``use_pallas_kernels=True`` artifact carries (``utils/serving.py``
there). Each op is a ``torch.library.custom_op`` with a CUDA
implementation only, the launch into ``csrc/`` that the live wrappers
also make; a CPU tensor handed to an op raises (no kernel for the CPU
backend), so a kernels artifact never runs a plain version. Each op has
a fake implementation that gives its output's shape, through which a
symbolic batch passes when ``torch.export`` traces.

* ``pointtpu::linear_affine_act``: ``act((x @ w^T) * scale + shift)``,
  ``fused_linear_affine_act`` (``csrc/shared_mlp.cu``);
* ``pointtpu::stack_maxpool``: the pointwise stack and its max over
  points, ``fused_stack_maxpool`` (``csrc/encoder_fused.cu``);
* ``pointtpu::seg_head``: the concat-free seg head with its log_softmax,
  ``seg_head_fused`` (``csrc/encoder_fused.cu``).

Every weight enters in its storage layout, row-major ``[out, in]`` and
contiguous, so a kernel never depends on an ``[in, out]`` view
surviving an exported graph. ``bf16`` selects the kernels' bf16 operands
(the wrappers read it from ``core.compute_dtype()``). Each op counts its
launch on its wrapper's ``launches`` (``ops/kernels/shared_mlp.py``,
``encoder_fused.py``) where it launches, so an artifact's replay counts
and its tracing does not.

A process that loads a kernels artifact imports this module first:
``torch.export.load`` cannot resolve an op that is not registered.
"""

from __future__ import annotations

import importlib
from typing import List

import torch

from adversarial_learning_on_pointclouds_tpu_torch.ops import launch

_KERNELS = "adversarial_learning_on_pointclouds_tpu_torch.ops.kernels"
OPS = ("linear_affine_act", "stack_maxpool", "seg_head")


def _count(module: str, wrapper: str) -> None:
    getattr(importlib.import_module(f"{_KERNELS}.{module}"),
            wrapper).launches += 1


def _f32(device: torch.device, *shape) -> torch.Tensor:
    return torch.empty(shape, device=device, dtype=torch.float32)


@torch.library.custom_op("pointtpu::linear_affine_act", mutates_args=(),
                         device_types="cuda")
def linear_affine_act(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                      scale: torch.Tensor, act: int, bf16: bool
                      ) -> torch.Tensor:
    """``x [B, N, c_in]``, ``w [c_out, c_in]`` -> ``[B, N, c_out]``."""
    bsz, n, c_in = x.shape
    c_out = w.shape[0]
    dev = x.device
    launch.expect("x", x, (bsz, n, c_in), dev)
    launch.expect("w", w, (c_out, c_in), dev)
    launch.expect("shift", shift, (c_out,), dev)
    launch.expect("scale", scale, (c_out,), dev)
    out = _f32(dev, bsz, n, c_out)
    p = launch.ptr
    launch.call("pt_linear_affine_act", dev, p(x), p(w), p(shift), p(scale),
                p(out), bsz * n, c_in, c_out, act, launch.prec(bf16))
    _count("shared_mlp", "fused_linear_affine_act")
    return out


@linear_affine_act.register_fake
def _(x, w, shift, scale, act, bf16):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[0]))


@torch.library.custom_op("pointtpu::stack_maxpool", mutates_args=(),
                         device_types="cuda")
def stack_maxpool(x: torch.Tensor, weights: List[torch.Tensor],
                  shifts: List[torch.Tensor], scales: List[torch.Tensor],
                  acts: List[int], bf16: bool) -> torch.Tensor:
    """``x [B, N, c0]``, ``weights[l] [c_{l+1}, c_l]`` -> ``[B, c_L]``."""
    n_layers = len(weights)
    if not n_layers == len(shifts) == len(scales) == len(acts):
        raise ValueError("need one shift, scale and activation per layer")
    bsz, n, c0 = x.shape
    dev = x.device
    launch.expect("x", x, (bsz, n, c0), dev)
    widths = [c0]
    for i, (w, sh, sc) in enumerate(zip(weights, shifts, scales)):
        c_out = w.shape[0]
        launch.expect(f"weights[{i}]", w, (c_out, widths[-1]), dev)
        launch.expect(f"shifts[{i}]", sh, (c_out,), dev)
        launch.expect(f"scales[{i}]", sc, (c_out,), dev)
        widths.append(c_out)
    out = _f32(dev, bsz, widths[-1])
    launch.call("pt_stack_maxpool", dev, launch.ptr(x), launch.ptr(out),
                launch.pointers(weights), launch.pointers(shifts),
                launch.pointers(scales), launch.ints(widths),
                launch.ints(acts), n_layers, bsz, n, launch.prec(bf16))
    _count("encoder_fused", "fused_stack_maxpool")
    return out


@stack_maxpool.register_fake
def _(x, weights, shifts, scales, acts, bf16):
    return x.new_empty((x.shape[0], weights[-1].shape[0]))


@torch.library.custom_op("pointtpu::seg_head", mutates_args=(),
                         device_types="cuda")
def seg_head(point_feat: torch.Tensor, global_feat: torch.Tensor,
             w1: torch.Tensor, shift1: torch.Tensor, scale1: torch.Tensor,
             w2: torch.Tensor, shift2: torch.Tensor, scale2: torch.Tensor,
             w3: torch.Tensor, shift3: torch.Tensor, scale3: torch.Tensor,
             w4: torch.Tensor, b4: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``point_feat [B, N, c_pf]``, ``global_feat [B, c_g]``, ``w1 [c1,
    c_pf + c_g]``, ``w2 [c2, c1]``, ``w3 [c3, c2]``, ``w4 [k, c3]`` ->
    log-probabilities ``[B, N, k]``."""
    bsz, n, c_pf = point_feat.shape
    c_g = global_feat.shape[-1]
    c1, c2, c3, k = w1.shape[0], w2.shape[0], w3.shape[0], w4.shape[0]
    dev = point_feat.device
    launch.expect("point_feat", point_feat, (bsz, n, c_pf), dev)
    launch.expect("global_feat", global_feat, (bsz, c_g), dev)
    layers = ((w1, shift1, scale1, c_pf + c_g, c1),
              (w2, shift2, scale2, c1, c2), (w3, shift3, scale3, c2, c3))
    for i, (w, sh, sc, c_in, c_out) in enumerate(layers, start=1):
        launch.expect(f"w{i}", w, (c_out, c_in), dev)
        launch.expect(f"shift{i}", sh, (c_out,), dev)
        launch.expect(f"scale{i}", sc, (c_out,), dev)
    launch.expect("w4", w4, (k, c3), dev)
    launch.expect("b4", b4, (k,), dev)
    g_row, out = _f32(dev, bsz, c1), _f32(dev, bsz, n, k)
    p = launch.ptr
    launch.call("pt_seg_head", dev, p(point_feat), p(global_feat), p(w1),
                p(shift1), p(scale1), p(w2), p(shift2), p(scale2), p(w3),
                p(shift3), p(scale3), p(w4), p(b4), p(g_row), p(out), bsz, n,
                c_pf, c_g, c1, c2, c3, k, launch.prec(bf16))
    _count("encoder_fused", "seg_head_fused")
    return out


@seg_head.register_fake
def _(point_feat, global_feat, w1, shift1, scale1, w2, shift2, scale2, w3,
      shift3, scale3, w4, b4, bf16):
    return point_feat.new_empty((point_feat.shape[0], point_feat.shape[1],
                                 w4.shape[0]))
