"""Batched T-Net transform apply: ``y[b] = x[b] @ T[b]`` (training).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
tnet_apply.py::tnet_apply``, which the JAX package's ``batched_transform``
runs under ``use_pallas(training=True)`` (here ``dispatch.use_pallas_train``).
Three CUDA passes in ``csrc/tnet_apply.cu`` (its header says what bounds
them on the card): ``tnet_fwd`` (``x @ T`` per cloud), ``tnet_dx`` (``g @
T^T``) and ``tnet_dt`` (``x^T g`` per cloud, the point ranges added in
fp64); at k = 3 streaming kernels in fp32 FMA, at k = 64 the GEMM core
(``csrc/strided_gemm.cu``, 3xTF32). All three are fp32 under ``core.mixed_precision`` too, as the JAX
kernels pin HIGHEST precision (the default path's ``core.matmul`` takes
bf16 operands there). Each pass has a plain twin (``*_plain``) that CPU
tensors run.
"""

from __future__ import annotations

import ctypes

import torch

from adversarial_learning_on_pointclouds_tpu_torch.ops import launch


def tnet_fwd_plain(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, t)


def tnet_dx_plain(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.matmul(g, t.transpose(1, 2))


def tnet_dt_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.transpose(1, 2), g)


def _check(rows: torch.Tensor, mat: torch.Tensor):
    bsz, n, k = rows.shape
    dev = rows.device
    launch.expect("rows", rows, (bsz, n, k), dev)
    launch.expect("T", mat, (bsz, k, k), dev)
    return bsz, n, k, dev


def tnet_fwd(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``x [B, N, k] @ t [B, k, k] -> [B, N, k]``."""
    if launch.on_cpu(x):
        return tnet_fwd_plain(x, t)
    bsz, n, k, dev = _check(x, t)
    y = torch.empty_like(x)
    a = launch.args(launch.TnetArgs, batch=bsz, n=n, k=k, x=x, t=t, y=y)
    launch.call("pt_tnet_fwd", dev, ctypes.addressof(a))
    tnet_fwd.launches += 1
    return y


def tnet_dx(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``g [B, N, k] @ t^T -> [B, N, k]``."""
    if launch.on_cpu(g):
        return tnet_dx_plain(g, t)
    bsz, n, k, dev = _check(g, t)
    dx = torch.empty_like(g)
    a = launch.args(launch.TnetArgs, batch=bsz, n=n, k=k, t=t, g=g, dx=dx)
    launch.call("pt_tnet_dx", dev, ctypes.addressof(a))
    tnet_dx.launches += 1
    return dx


def tnet_dt(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``x[b]^T g[b]`` of every cloud: ``[B, k, k]``."""
    if launch.on_cpu(x):
        return tnet_dt_plain(x, g)
    bsz, n, k = x.shape
    dev = x.device
    launch.expect("x", x, (bsz, n, k), dev)
    launch.expect("g", g, (bsz, n, k), dev)
    splits = launch.row_splits(n, k, k, dev, bsz)
    dt = torch.empty((bsz, k, k), device=dev, dtype=torch.float32)
    part = torch.empty((bsz * splits * k * k,), device=dev,
                       dtype=torch.float32)
    a = launch.args(launch.TnetArgs, batch=bsz, n=n, k=k, splits=splits, x=x,
                    g=g, dt=dt, part=part)
    launch.call("pt_tnet_dt", dev, ctypes.addressof(a))
    tnet_dt.launches += 1
    return dt


tnet_fwd.launches = tnet_dx.launches = tnet_dt.launches = 0
PASSES = {"fwd": tnet_fwd, "dx": tnet_dx, "dT": tnet_dt}


class _TnetApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, t):
        x, t = x.contiguous(), t.contiguous()
        ctx.save_for_backward(x, t)
        return tnet_fwd(x, t)

    @staticmethod
    def backward(ctx, g):
        x, t = ctx.saved_tensors
        g = g.contiguous()
        # dx only where the input takes a gradient (not the points).
        dx = tnet_dx(g, t) if ctx.needs_input_grad[0] else None
        dt = tnet_dt(x, g) if ctx.needs_input_grad[1] else None
        return dx, dt


def tnet_apply(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``x [B, N, k] @ t [B, k, k] -> [B, N, k]`` under autograd."""
    return _TnetApply.apply(x, t)
