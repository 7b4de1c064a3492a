"""Symmetric max over the point axis with a first-occurrence backward
(training).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
maxpool_points.py::maxpool_points``, which the JAX package's
``max_points`` runs under ``use_pallas(training=True)`` (here
``dispatch.use_pallas_train``). Two CUDA passes in
``csrc/maxpool_points.cu`` (its header says what bounds them on the
card): ``maxpool_fwd`` (``[B, N, C] -> [B, C]`` and, per cloud and
channel, the first point attaining the max) and ``maxpool_bwd`` (the
cotangent to that point, zero elsewhere). The winner is the first point,
as the JAX kernel's, not a share per tied point as ``amax``'s gradient
would give. Each pass has a plain twin (``*_plain``, an explicit
first-argmax and scatter) that CPU tensors run.
"""

from __future__ import annotations

import ctypes

import torch

from adversarial_learning_on_pointclouds_tpu_torch.ops import launch


def maxpool_fwd_plain(x: torch.Tensor):
    """``(max over N [B, C], the first point attaining it, int32)``."""
    y = x.amax(dim=1)
    n = x.shape[1]
    pos = torch.arange(n, device=x.device, dtype=torch.int32)[None, :, None]
    win = torch.where(x == y[:, None], pos, n).amin(dim=1)
    return y, win.to(torch.int32)


def maxpool_bwd_plain(g: torch.Tensor, win: torch.Tensor, n: int
                      ) -> torch.Tensor:
    """``dx [B, n, C]``: ``g`` at each winner, zero elsewhere."""
    dx = torch.zeros((g.shape[0], n, g.shape[1]), device=g.device,
                     dtype=g.dtype)
    return dx.scatter_(1, win.long()[:, None, :], g[:, None, :])


def maxpool_fwd(x: torch.Tensor):
    """The forward pass: ``(y [B, C], winners [B, C] int32)``."""
    if launch.on_cpu(x):
        return maxpool_fwd_plain(x)
    bsz, n, c = x.shape
    dev = x.device
    launch.expect("x", x, (bsz, n, c), dev)
    y = torch.empty((bsz, c), device=dev, dtype=torch.float32)
    win = torch.empty((bsz, c), device=dev, dtype=torch.int32)
    a = launch.args(launch.MaxpoolArgs, batch=bsz, n=n, c=c, x=x, y=y,
                    idx=win)
    launch.call("pt_maxpool_fwd", dev, ctypes.addressof(a))
    maxpool_fwd.launches += 1
    return y, win


def maxpool_bwd(g: torch.Tensor, win: torch.Tensor, n: int) -> torch.Tensor:
    """The backward pass: ``g [B, C]`` to the winners of ``[B, n, C]``."""
    if launch.on_cpu(g):
        return maxpool_bwd_plain(g, win, n)
    bsz, c = g.shape
    dev = g.device
    launch.expect("g", g, (bsz, c), dev)
    launch.expect("winners", win, (bsz, c), dev, dtype=torch.int32)
    dx = torch.empty((bsz, n, c), device=dev, dtype=torch.float32)
    a = launch.args(launch.MaxpoolArgs, batch=bsz, n=n, c=c, g=g, win=win,
                    dx=dx)
    launch.call("pt_maxpool_bwd", dev, ctypes.addressof(a))
    maxpool_bwd.launches += 1
    return dx


maxpool_fwd.launches = maxpool_bwd.launches = 0
PASSES = {"fwd": maxpool_fwd, "bwd": maxpool_bwd}


class _MaxpoolPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y, win = maxpool_fwd(x.contiguous())
        ctx.save_for_backward(win)
        ctx.n = x.shape[1]
        return y

    @staticmethod
    def backward(ctx, g):
        (win,) = ctx.saved_tensors
        return maxpool_bwd(g.contiguous(), win, ctx.n)


def maxpool_points(x: torch.Tensor) -> torch.Tensor:
    """``[B, N, C] -> [B, C]`` max over the points under autograd; the
    gradient goes to the first point attaining each max."""
    return _MaxpoolPoints.apply(x)


def maxpool_points_reference(x: torch.Tensor) -> torch.Tensor:
    """The same function as a plain composition under torch autograd (a
    gather at the first-argmax), for gradient checks."""
    _, win = maxpool_fwd_plain(x.detach())
    return torch.gather(x, 1, win.long()[:, None, :])[:, 0]
