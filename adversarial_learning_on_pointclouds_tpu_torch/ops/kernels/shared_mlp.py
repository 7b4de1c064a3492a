"""Pointwise shared-MLP kernels: the eval conv + folded BatchNorm +
activation, and the per-layer training matmul.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
shared_mlp.py``:

* ``fused_linear_affine_act`` (eval), ``csrc/shared_mlp.cu``;
* ``pointwise_matmul`` (training, under ``dispatch.use_pallas_train``):
  ``x @ w + b`` with its backward ``dx = g @ w^T``, ``dw = x^T g``,
  ``db = sum g``, three passes in ``csrc/pointwise_matmul.cu`` (``pm_fwd``,
  ``pm_dx``, ``pm_dwdb``). Under ``core.mixed_precision`` the forward and
  ``dx`` take bf16 operands and ``dw``/``db`` stay fp32, as the JAX
  package's ``_mxu_dot`` and its HIGHEST-precision ``_dwdb_call``.

Each source's header says what bounds it on the card and what the design
does about that; each ``*_plain`` function is the same computation in
plain PyTorch, which CPU tensors run.
"""

from __future__ import annotations

import ctypes
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


# ---------------------------------------------------------------------------
# pointwise_matmul: y = x @ w + b with its backward (training)
# ---------------------------------------------------------------------------

def pm_fwd_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 bf16: bool = False) -> torch.Tensor:
    """``x @ w + b`` (bf16 operands under ``bf16``), fp32."""
    return torch.matmul(core.operand(x, bf16), core.operand(w, bf16)) + b


def pm_dx_plain(g: torch.Tensor, w: torch.Tensor,
                bf16: bool = False) -> torch.Tensor:
    """``g @ w^T`` (bf16 operands under ``bf16``), fp32."""
    return torch.matmul(core.operand(g, bf16), core.operand(w, bf16).t())


def pm_dwdb_plain(x: torch.Tensor, g: torch.Tensor):
    """``(x^T g, sum g)`` over every row, fp32 operands."""
    xr, gr = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])
    return torch.matmul(xr.t(), gr), gr.sum(0)


def _pm_args(**fields):
    return launch.args(launch.PmArgs, **fields)


def pm_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           bf16: bool = False) -> torch.Tensor:
    """The forward pass: ``x [B, N, Cin]``, ``w [Cin, Cout]`` (on the card,
    the ``[in, out]`` view of a row-major ``[out, in]`` weight), ``b
    [Cout]`` -> ``[B, N, Cout]``."""
    if launch.on_cpu(x):
        return pm_fwd_plain(x, w, b, bf16)
    bsz, n, c_in = x.shape
    c_out = w.shape[1]
    dev = x.device
    launch.expect("x", x, (bsz, n, c_in), dev)
    launch.expect("w", w, (c_in, c_out), dev, weight=True)
    launch.expect("b", b, (c_out,), dev)
    y = torch.empty((bsz, n, c_out), device=dev, dtype=torch.float32)
    a = _pm_args(rows=bsz * n, c_in=c_in, c_out=c_out, prec=launch.prec(bf16),
                 x=x, w=w.t(), bias=b, y=y)
    launch.call("pt_pm_fwd", dev, ctypes.addressof(a))
    pm_fwd.launches += 1
    return y


def pm_dx(g: torch.Tensor, w: torch.Tensor, bf16: bool = False
          ) -> torch.Tensor:
    """The input-gradient pass: ``g [B, N, Cout]`` -> ``[B, N, Cin]``."""
    if launch.on_cpu(g):
        return pm_dx_plain(g, w, bf16)
    bsz, n, c_out = g.shape
    c_in = w.shape[0]
    dev = g.device
    launch.expect("g", g, (bsz, n, c_out), dev)
    launch.expect("w", w, (c_in, c_out), dev, weight=True)
    dx = torch.empty((bsz, n, c_in), device=dev, dtype=torch.float32)
    a = _pm_args(rows=bsz * n, c_in=c_in, c_out=c_out, prec=launch.prec(bf16),
                 w=w.t(), g=g, dx=dx)
    launch.call("pt_pm_dx", dev, ctypes.addressof(a))
    pm_dx.launches += 1
    return dx


def pm_dwdb(x: torch.Tensor, g: torch.Tensor):
    """The weight-gradient pass: ``(dw [Cin, Cout], db [Cout])`` summed over
    every row of ``x [B, N, Cin]`` and ``g [B, N, Cout]``, fp32; ``dw`` is
    the ``[in, out]`` view of a row-major ``[out, in]`` tensor, the
    weight's own layout."""
    if launch.on_cpu(x):
        return pm_dwdb_plain(x, g)
    bsz, n, c_in = x.shape
    c_out = g.shape[-1]
    dev = x.device
    launch.expect("x", x, (bsz, n, c_in), dev)
    launch.expect("g", g, (bsz, n, c_out), dev)
    rows = bsz * n
    splits = launch.row_splits(rows, -(-c_out // 64) * -(-c_in // 64), dev)
    f32 = dict(device=dev, dtype=torch.float32)
    dw, db = torch.empty((c_out, c_in), **f32), torch.empty((c_out,), **f32)
    part = torch.empty((splits * c_out * (c_in + 1),), **f32)
    a = _pm_args(rows=rows, c_in=c_in, c_out=c_out, splits=splits, x=x, g=g,
                 dw=dw, db=db, part=part)
    launch.call("pt_pm_dwdb", dev, ctypes.addressof(a))
    pm_dwdb.launches += 1
    return dw.t(), db


pm_fwd.launches = pm_dx.launches = pm_dwdb.launches = 0
PM_PASSES = {"fwd": pm_fwd, "dx": pm_dx, "dW": pm_dwdb}


class _PointwiseMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.bf16 = core.compute_dtype() is not None
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        return pm_fwd(x, w, b, ctx.bf16)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        # The input's gradient only where it has one: the first layer of
        # the input T-Net sees the points, whose dx the JAX package
        # computes and drops.
        dx = pm_dx(g, w, ctx.bf16) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = pm_dwdb(x, g)
        return dx, dw, db


def pointwise_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                     ) -> torch.Tensor:
    """``x [B, N, Cin] @ w [Cin, Cout] + b`` under autograd, through the
    three passes (``w``: the ``[in, out]`` view of the layer's weight)."""
    return _PointwiseMatmul.apply(x, w, b)
