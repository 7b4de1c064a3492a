"""Encoder megakernels: the pointwise stack with its max over points, and
the concat-free seg head with its log_softmax (eval).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
encoder_fused.py``. Both kernels are in ``csrc/encoder_fused.cu``, whose
header says what bounds each on the card and what the design does about
it. Unlike the TPU kernels they pad nothing: the ragged tail of the
point axis is masked inside the kernel. Both launch as registered ops
(``ops/serving_ops.py``), and both take bf16 operands under
``core.mixed_precision``, as the JAX package's ``_mxu_dot``. The
``*_plain`` functions are the same computations in plain PyTorch, which
CPU tensors run.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import (
    launch, serving_ops,
)


# ---------------------------------------------------------------------------
# fused_stack_maxpool: pointwise stack with a max-pool epilogue
# ---------------------------------------------------------------------------

def fused_stack_maxpool_plain(x: torch.Tensor,
                              weights: Sequence[torch.Tensor],
                              shifts: Sequence[torch.Tensor],
                              scales: Sequence[torch.Tensor],
                              acts: Sequence[Optional[str]],
                              bf16: bool = False) -> torch.Tensor:
    """The stack layer by layer and its max over points, with bf16 matmul
    operands and fp32 sums under ``bf16``."""
    h = x
    for w, sh, sc, act in zip(weights, shifts, scales, acts):
        z = torch.matmul(core.operand(h, bf16), core.operand(w, bf16))
        h = core.activation(z * sc + sh, act)
    return h.amax(dim=1)


def fused_stack_maxpool(x: torch.Tensor,
                        weights: Sequence[torch.Tensor],
                        shifts: Sequence[torch.Tensor],
                        scales: Sequence[torch.Tensor],
                        acts: Sequence[Optional[str]]) -> torch.Tensor:
    """``[B, N, c0] -> max over N of the chained stack -> [B, c_out]``.

    Layer ``l`` is ``act_l((h @ w_l) * scale_l + shift_l)`` with ``w_l``
    ``[in, out]`` (on a CUDA device, the view of a row-major ``[out, in]``
    weight); bf16 operands under ``core.mixed_precision``. ``[B, N,
    c_out]`` never reaches device memory. The kernel runs as the
    registered op ``pointtpu::stack_maxpool``."""
    bf16 = core.compute_dtype() is not None
    if launch.eval_plain(x):
        return fused_stack_maxpool_plain(x, weights, shifts, scales, acts,
                                         bf16)
    n_layers = len(weights)
    if not n_layers == len(shifts) == len(scales) == len(acts):
        raise ValueError("need one shift, scale and activation per layer")
    bsz, n, c0 = x.shape
    dev = x.device
    launch.expect("x", x, (bsz, n, c0), dev)
    widths = [c0]
    for i, w in enumerate(weights):
        launch.expect(f"weights[{i}]", w, (widths[-1], w.shape[1]), dev,
                      weight=True)
        widths.append(w.shape[1])
    launch.no_grad(x, *weights, *shifts, *scales)
    return serving_ops.stack_maxpool(
        x, [w.t() for w in weights], list(shifts), list(scales),
        [launch.act_code(a) for a in acts], bf16)


fused_stack_maxpool.launches = 0


# ---------------------------------------------------------------------------
# seg_head_fused: the 1088-wide concat head without the concat
# ---------------------------------------------------------------------------

def seg_head_fused_plain(point_feat: torch.Tensor, global_feat: torch.Tensor,
                         w1, shift1, scale1, w2, shift2, scale2,
                         w3, shift3, scale3, w4, b4,
                         bf16: bool = False) -> torch.Tensor:
    """The head layer by layer, the global half of layer 1 as one row a
    cloud, with bf16 matmul operands and fp32 sums under ``bf16``."""
    def mm(a, b):
        return torch.matmul(core.operand(a, bf16), core.operand(b, bf16))

    c_pf = point_feat.shape[-1]
    g_row = mm(global_feat, w1[c_pf:])[:, None, :]
    h = torch.relu((mm(point_feat, w1[:c_pf]) + g_row) * scale1 + shift1)
    h = torch.relu(mm(h, w2) * scale2 + shift2)
    h = torch.relu(mm(h, w3) * scale3 + shift3)
    return torch.log_softmax(mm(h, w4) + b4, dim=-1)


def seg_head_fused(point_feat: torch.Tensor, global_feat: torch.Tensor,
                   w1: torch.Tensor, shift1, scale1, w2, shift2, scale2,
                   w3, shift3, scale3, w4, b4) -> torch.Tensor:
    """Per-point seg head on the implicit ``[point_feat | global]`` concat.

    ``point_feat [B, N, c_pf]``, ``global_feat [B, c_g]``; ``w1`` is the
    whole ``[c_pf + c_g, c1]`` first-layer weight, ``w4 [c3, k]`` and
    ``b4 [k]`` the last layer's (on a CUDA device each the ``[in, out]``
    view of a row-major ``[out, in]`` weight). Returns log-probabilities
    ``[B, N, k]``; ``[B, N, c_pf + c_g]`` never exists. bf16 operands under
    ``core.mixed_precision``. The kernel runs as the registered op
    ``pointtpu::seg_head``."""
    bf16 = core.compute_dtype() is not None
    args = (point_feat, global_feat, w1, shift1, scale1, w2, shift2, scale2,
            w3, shift3, scale3, w4, b4)
    if launch.eval_plain(point_feat):
        return seg_head_fused_plain(*args, bf16)
    dev = point_feat.device
    for name, w in (("w1", w1), ("w2", w2), ("w3", w3), ("w4", w4)):
        launch.expect(name, w, tuple(w.shape), dev, weight=True)
    launch.no_grad(*args)
    return serving_ops.seg_head(
        point_feat, global_feat, w1.t(), shift1, scale1, w2.t(), shift2,
        scale2, w3.t(), shift3, scale3, w4.t(), b4, bf16)


seg_head_fused.launches = 0
