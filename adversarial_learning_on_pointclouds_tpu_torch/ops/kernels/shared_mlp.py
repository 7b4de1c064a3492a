"""Pointwise shared-MLP kernels: the eval conv + folded BatchNorm +
activation, and the per-layer training matmul.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
shared_mlp.py``:

* ``fused_linear_affine_act`` (eval), ``csrc/shared_mlp.cu``, launched as
  the registered op ``pointtpu::linear_affine_act``
  (``ops/serving_ops.py``); bf16 operands under ``core.mixed_precision``;
* ``fused_mlp_stack`` (inference: ``FCDiscriminator.infer``), a chain of
  ``act((h @ w) * scale + shift)`` layers in one kernel on the tensor
  cores, ``csrc/mlp_stack.cu`` (fp32 as 3xTF32); bf16 operands with fp32
  sums under ``core.mixed_precision``, as the JAX package's ``_mxu_dot``;
* ``pointwise_matmul`` (training, under ``dispatch.use_pallas_train``):
  ``x @ w + b`` with its backward ``dx = g @ w^T``, ``dw = x^T g``,
  ``db = sum g``, three passes in ``csrc/pointwise_matmul.cu`` (``pm_fwd``,
  ``pm_dx``, ``pm_dwdb``) on the GEMM core ``csrc/strided_gemm.cu``
  (tensor cores; fp32 as 3xTF32). Under ``core.mixed_precision`` the forward and
  ``dx`` take bf16 operands and ``dw``/``db`` stay fp32, as the JAX
  package's ``_mxu_dot`` and its HIGHEST-precision ``_dwdb_call``.

Each source's header says what bounds it on the card and what the design
does about that; each ``*_plain`` function is the same computation in
plain PyTorch, which CPU tensors run.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import (
    launch, serving_ops,
)


def fused_linear_affine_act_plain(x: torch.Tensor, w: torch.Tensor,
                                  shift: torch.Tensor, scale: torch.Tensor,
                                  act: Optional[str],
                                  bf16: bool = False) -> torch.Tensor:
    """``act((x @ w) * scale + shift)``, with bf16 matmul operands and an
    fp32 sum under ``bf16``."""
    z = torch.matmul(core.operand(x, bf16), core.operand(w, bf16))
    return core.activation(z * scale + shift, act)


def fused_linear_affine_act(x: torch.Tensor, w: torch.Tensor,
                            shift: torch.Tensor, scale: torch.Tensor,
                            act: Optional[str]) -> torch.Tensor:
    """``act((x @ w) * scale + shift)``: ``x [B, N, Cin]``, ``w [Cin,
    Cout]``, ``shift``/``scale [Cout]`` -> ``[B, N, Cout]``; bf16 operands
    under ``core.mixed_precision``, as the JAX package's ``_mxu_dot``.

    ``shift`` already holds the conv bias folded through the BN scale
    (``ops/dispatch.folded_affine``). On a CUDA device ``w`` must be the
    ``[in, out]`` view of a row-major ``[out, in]`` weight; the kernel runs
    as the registered op ``pointtpu::linear_affine_act``
    (``ops/serving_ops.py``), which counts the launch."""
    bf16 = core.compute_dtype() is not None
    if launch.eval_plain(x):
        return fused_linear_affine_act_plain(x, w, shift, scale, act, bf16)
    bsz, n, c_in = x.shape
    c_out = w.shape[1]
    dev = x.device
    launch.expect("x", x, (bsz, n, c_in), dev)
    launch.expect("w", w, (c_in, c_out), dev, weight=True)
    launch.expect("shift", shift, (c_out,), dev)
    launch.expect("scale", scale, (c_out,), dev)
    launch.no_grad(x, w, shift, scale)
    return serving_ops.linear_affine_act(x, w.t(), shift, scale,
                                         launch.act_code(act), bf16)


fused_linear_affine_act.launches = 0


# ---------------------------------------------------------------------------
# fused_mlp_stack: a chain of pointwise layers in one kernel (inference)
# ---------------------------------------------------------------------------

def fused_mlp_stack_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          shifts: Sequence[torch.Tensor],
                          scales: Sequence[torch.Tensor],
                          acts: Sequence[Optional[str]],
                          bf16: bool = False) -> torch.Tensor:
    """The chain layer by layer, ``h = act_i((h @ w_i) * scale_i +
    shift_i)``, with bf16 matmul operands under ``bf16``."""
    h = x
    for w, shift, scale, act in zip(weights, shifts, scales, acts):
        z = torch.matmul(core.operand(h, bf16), core.operand(w, bf16))
        h = core.activation(z * scale + shift, act)
    return h


def fused_mlp_stack(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    shifts: Sequence[torch.Tensor],
                    scales: Sequence[torch.Tensor],
                    acts: Sequence[Optional[str]]) -> torch.Tensor:
    """``x [B, N, C0]`` through the chain ``h = act_i((h @ w_i) * scale_i
    + shift_i)``, ``w_i [C_i, C_i+1]`` (on a CUDA device the ``[in, out]``
    view of a row-major ``[out, in]`` weight), ``shift_i``/``scale_i
    [C_i+1]``, ``acts`` in ``None``/``"relu"``/``"leaky_relu"`` -> ``[B,
    N, C_L]`` fp32; bf16 operands under ``core.mixed_precision``. Any N.

    Forward only: with grad enabled, an input or weight that requires grad
    raises. On the card a chain of more than ``launch.MAX_STACK`` layers
    raises, and so does one that a block's shared memory cannot hold at 64
    rows a tile: its activations in slots of 128 columns (two where a
    layer's input and output each fit one; a layer's output chunks take
    free slots but the last, which may overwrite its input; a last layer
    narrower than 8 columns folds into the layer before and needs none),
    fp32 or, under mixed precision, bf16; a ring of 3 weight slices of 18
    KB; and a folded layer's partials (2 KB a column at 128 rows). At 128
    rows the discriminator (k 50 or 53 -> 64 -> 128 -> 256 -> 512 -> 1)
    takes 188 KB in fp32 and 124 KB in bf16, the 3 -> 64 -> 128 -> 1024
    chain 120 / 88 KB, of the H100's 227 KB."""
    n_layers = len(weights)
    if not n_layers or not len(shifts) == len(scales) == len(acts) == \
            n_layers:
        raise ValueError(f"fused_mlp_stack takes one shift, scale and act "
                         f"per weight, got {n_layers} weights, "
                         f"{len(shifts)} shifts, {len(scales)} scales and "
                         f"{len(acts)} acts")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights, *shifts, *scales)):
        raise RuntimeError("fused_mlp_stack has no backward: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    codes = [launch.act_code(a) for a in acts]
    bf16 = core.compute_dtype() is not None
    if launch.on_cpu(x):
        return fused_mlp_stack_plain(x, weights, shifts, scales, acts, bf16)
    if n_layers > launch.MAX_STACK:
        raise ValueError(f"fused_mlp_stack takes at most {launch.MAX_STACK} "
                         f"layers, got {n_layers}")
    bsz, n, c0 = x.shape
    dev = x.device
    launch.expect("x", x, (bsz, n, c0), dev)
    if bsz * n >= 2 ** 31:
        raise ValueError(f"fused_mlp_stack takes fewer than 2^31 rows, got "
                         f"{bsz * n}")
    widths = [c0]
    a = launch.StackArgs(rows=bsz * n, layers=n_layers,
                         prec=launch.prec(bf16), x=x.data_ptr())
    for i, (w, shift, scale) in enumerate(zip(weights, shifts, scales)):
        c_out = w.shape[-1]
        launch.expect(f"weights[{i}]", w, (widths[-1], c_out), dev,
                      weight=True)
        launch.expect(f"shifts[{i}]", shift, (c_out,), dev)
        launch.expect(f"scales[{i}]", scale, (c_out,), dev)
        a.w[i], a.shift[i], a.scale[i] = (w.t().data_ptr(), shift.data_ptr(),
                                          scale.data_ptr())
        widths.append(c_out)
    a.width[:n_layers + 1] = widths
    a.act[:n_layers] = codes
    out = torch.empty((bsz, n, widths[-1]), device=dev, dtype=torch.float32)
    a.out = out.data_ptr()
    launch.call("pt_mlp_stack", dev, ctypes.addressof(a))
    fused_mlp_stack.launches += 1
    return out


fused_mlp_stack.launches = 0


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
    splits = launch.row_splits(rows, c_out, c_in, dev)
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
