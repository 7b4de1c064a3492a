"""Encoder megakernels: the pointwise stack with its max over points, and
the concat-free seg head with its log_softmax (eval).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
encoder_fused.py``. Both kernels are in ``csrc/encoder_fused.cu``, whose
header says what bounds each on the card and what the design does about
it. Unlike the TPU kernels they pad nothing: the ragged tail of the
point axis is masked inside the kernel. The ``*_plain`` functions are the
same computations in plain PyTorch, which CPU tensors run.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch, launch


# ---------------------------------------------------------------------------
# fused_stack_maxpool: pointwise stack with a max-pool epilogue
# ---------------------------------------------------------------------------

def fused_stack_maxpool_plain(x: torch.Tensor,
                              weights: Sequence[torch.Tensor],
                              shifts: Sequence[torch.Tensor],
                              scales: Sequence[torch.Tensor],
                              acts: Sequence[Optional[str]]) -> torch.Tensor:
    h = x
    for w, sh, sc, act in zip(weights, shifts, scales, acts):
        h = core.activation(torch.matmul(h, w) * sc + sh, act)
    return dispatch.max_points(h)


def fused_stack_maxpool(x: torch.Tensor,
                        weights: Sequence[torch.Tensor],
                        shifts: Sequence[torch.Tensor],
                        scales: Sequence[torch.Tensor],
                        acts: Sequence[Optional[str]]) -> torch.Tensor:
    """``[B, N, c0] -> max over N of the chained stack -> [B, c_out]``.

    Layer ``l`` is ``act_l((h @ w_l) * scale_l + shift_l)`` with ``w_l``
    ``[in, out]`` (on a CUDA device, the view of a row-major ``[out, in]``
    weight). ``[B, N, c_out]`` never reaches device memory."""
    if launch.on_cpu(x):
        return fused_stack_maxpool_plain(x, weights, shifts, scales, acts)
    n_layers = len(weights)
    if not n_layers == len(shifts) == len(scales) == len(acts):
        raise ValueError("need one shift, scale and activation per layer")
    bsz, n, c0 = x.shape
    dev = x.device
    launch.expect("x", x, (bsz, n, c0), dev)
    widths = [c0]
    for i, (w, sh, sc) in enumerate(zip(weights, shifts, scales)):
        c_out = w.shape[1]
        launch.expect(f"weights[{i}]", w, (widths[-1], c_out), dev,
                      weight=True)
        launch.expect(f"shifts[{i}]", sh, (c_out,), dev)
        launch.expect(f"scales[{i}]", sc, (c_out,), dev)
        widths.append(c_out)
    launch.no_grad(x, *weights, *shifts, *scales)
    codes = [launch.act_code(a) for a in acts]
    out = torch.empty((bsz, widths[-1]), device=dev, dtype=torch.float32)
    launch.call("pt_stack_maxpool", dev, launch.ptr(x), launch.ptr(out),
                launch.pointers([w.t() for w in weights]),
                launch.pointers(shifts), launch.pointers(scales),
                launch.ints(widths), launch.ints(codes), n_layers, bsz, n)
    fused_stack_maxpool.launches += 1
    return out


fused_stack_maxpool.launches = 0


# ---------------------------------------------------------------------------
# seg_head_fused: the 1088-wide concat head without the concat
# ---------------------------------------------------------------------------

def seg_head_fused_plain(point_feat: torch.Tensor, global_feat: torch.Tensor,
                         w1, shift1, scale1, w2, shift2, scale2,
                         w3, shift3, scale3, w4, b4) -> torch.Tensor:
    c_pf = point_feat.shape[-1]
    g_row = torch.matmul(global_feat, w1[c_pf:])[:, None, :]
    h = torch.relu((torch.matmul(point_feat, w1[:c_pf]) + g_row) * scale1
                   + shift1)
    h = torch.relu(torch.matmul(h, w2) * scale2 + shift2)
    h = torch.relu(torch.matmul(h, w3) * scale3 + shift3)
    return torch.log_softmax(torch.matmul(h, w4) + b4, dim=-1)


def seg_head_fused(point_feat: torch.Tensor, global_feat: torch.Tensor,
                   w1: torch.Tensor, shift1, scale1, w2, shift2, scale2,
                   w3, shift3, scale3, w4, b4) -> torch.Tensor:
    """Per-point seg head on the implicit ``[point_feat | global]`` concat.

    ``point_feat [B, N, c_pf]``, ``global_feat [B, c_g]``; ``w1`` is the
    whole ``[c_pf + c_g, c1]`` first-layer weight, ``w4 [c3, k]`` and
    ``b4 [k]`` the last layer's. Returns log-probabilities ``[B, N, k]``;
    ``[B, N, c_pf + c_g]`` never exists."""
    if launch.on_cpu(point_feat):
        return seg_head_fused_plain(point_feat, global_feat, w1, shift1,
                                    scale1, w2, shift2, scale2, w3, shift3,
                                    scale3, w4, b4)
    bsz, n, c_pf = point_feat.shape
    c_g = global_feat.shape[-1]
    c1, c2, c3, k = w1.shape[1], w2.shape[1], w3.shape[1], w4.shape[1]
    dev = point_feat.device
    launch.expect("point_feat", point_feat, (bsz, n, c_pf), dev)
    launch.expect("global_feat", global_feat, (bsz, c_g), dev)
    layers = ((w1, shift1, scale1, c_pf + c_g, c1), (w2, shift2, scale2, c1, c2),
              (w3, shift3, scale3, c2, c3))
    for i, (w, sh, sc, c_in, c_out) in enumerate(layers, start=1):
        launch.expect(f"w{i}", w, (c_in, c_out), dev, weight=True)
        launch.expect(f"shift{i}", sh, (c_out,), dev)
        launch.expect(f"scale{i}", sc, (c_out,), dev)
    launch.expect("w4", w4, (c3, k), dev, weight=True)
    launch.expect("b4", b4, (k,), dev)
    launch.no_grad(point_feat, global_feat, w1, shift1, scale1, w2, shift2,
                   scale2, w3, shift3, scale3, w4, b4)
    g_row = torch.empty((bsz, c1), device=dev, dtype=torch.float32)
    out = torch.empty((bsz, n, k), device=dev, dtype=torch.float32)
    p, wp = launch.ptr, launch.weight_ptr
    launch.call("pt_seg_head", dev, p(point_feat), p(global_feat),
                wp(w1), p(shift1), p(scale1), wp(w2), p(shift2), p(scale2),
                wp(w3), p(shift3), p(scale3), wp(w4), p(b4), p(g_row), p(out),
                bsz, n, c_pf, c_g, c1, c2, c3, k)
    seg_head_fused.launches += 1
    return out


seg_head_fused.launches = 0
