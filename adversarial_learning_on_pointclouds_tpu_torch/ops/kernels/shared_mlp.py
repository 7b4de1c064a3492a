"""Fused pointwise conv + folded BatchNorm + activation (eval).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
shared_mlp.py::fused_linear_affine_act``. The kernel is
``csrc/shared_mlp.cu`` (its header says what bounds it on the card and
what the design does about that); ``fused_linear_affine_act_plain`` is
the same function in plain PyTorch, which CPU tensors run.
"""

from __future__ import annotations

from typing import Optional

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import launch


def fused_linear_affine_act_plain(x: torch.Tensor, w: torch.Tensor,
                                  shift: torch.Tensor, scale: torch.Tensor,
                                  act: Optional[str]) -> torch.Tensor:
    return core.activation(torch.matmul(x, w) * scale + shift, act)


def fused_linear_affine_act(x: torch.Tensor, w: torch.Tensor,
                            shift: torch.Tensor, scale: torch.Tensor,
                            act: Optional[str]) -> torch.Tensor:
    """``act((x @ w) * scale + shift)``: ``x [B, N, Cin]``, ``w [Cin,
    Cout]``, ``shift``/``scale [Cout]`` -> ``[B, N, Cout]``.

    ``shift`` already holds the conv bias folded through the BN scale
    (``ops/dispatch.folded_affine``). On a CUDA device ``w`` must be the
    ``[in, out]`` view of a row-major ``[out, in]`` weight."""
    if launch.on_cpu(x):
        return fused_linear_affine_act_plain(x, w, shift, scale, act)
    bsz, n, c_in = x.shape
    c_out = w.shape[1]
    dev = x.device
    launch.expect("x", x, (bsz, n, c_in), dev)
    launch.expect("w", w, (c_in, c_out), dev, weight=True)
    launch.expect("shift", shift, (c_out,), dev)
    launch.expect("scale", scale, (c_out,), dev)
    launch.no_grad(x, w, shift, scale)
    code = launch.act_code(act)
    out = torch.empty((bsz, n, c_out), device=dev, dtype=torch.float32)
    launch.call("pt_linear_affine_act", dev, launch.ptr(x), launch.weight_ptr(w),
                launch.ptr(shift), launch.ptr(scale), launch.ptr(out),
                bsz * n, c_in, c_out, code)
    fused_linear_affine_act.launches += 1
    return out


fused_linear_affine_act.launches = 0
