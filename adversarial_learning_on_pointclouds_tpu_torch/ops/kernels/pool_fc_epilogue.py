"""Trunk-exit epilogue: pooled feature -> ReLU -> fc1 -> batch-BN -> ReLU
(train).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
pool_fc_epilogue.py``. The forward is one CUDA launch
(``csrc/pool_fc_epilogue.cu`` on ``csrc/small_fc.cuh``: a split-K
tensor-core product across thread-block clusters, whose header says what
bounds it on the card); ``pool_fc_fwd_plain`` is the same pass in plain
PyTorch, which CPU tensors run. The backward is plain PyTorch, as the JAX
VJP is plain XLA: the batch-BN backward with gradients through the batch
statistics, the matmul backward and the pool-affine backward. The
returned ``mu``/``var`` are non-differentiable auxiliaries for the
running-statistic update. Under ``core.mixed_precision`` the fc1 product
takes bf16 operands in the kernel (``bf16``) and ``dw1`` in the
backward; ``dh`` stays fp32, as in the JAX VJP. ``relu_fc_bn_relu`` runs
the identity fold (``s3c``, ``t3`` and ``mn`` None: ``h = relu(g)``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import launch


def pool_fc_fwd_plain(mx, mn, s3c, t3, w1, b1, g1, be1, rm1, groups: int,
                      bf16: bool = False):
    """``(h1, h, z1, mu, var, inv)``: ``h = relu(where(s3c >= 0, mx, mn)
    * s3c + t3)`` (``relu(mx)`` with ``s3c`` None, the identity fold),
    ``z1 = h @ w1 + b1`` (bf16 operands under ``bf16``; ``h`` is returned
    unrounded), moments of ``z1`` per group of ``B // groups`` rows
    about ``rm1`` (``core.rows_moments``, as the kernel takes them), ``h1
    = relu(bn(z1))``."""
    if s3c is None:
        h = torch.relu(mx)
    else:
        h = torch.relu(torch.where(s3c >= 0, mx, mn) * s3c + t3)
    z1 = torch.matmul(core.operand(h, bf16), core.operand(w1, bf16)) + b1
    bsz, c1 = z1.shape
    b = bsz // groups
    mu, var, inv = core.rows_moments(z1, rm1, groups)
    zhat = (z1.reshape(groups, b, c1) - mu[:, None]) * inv[:, None]
    h1 = torch.relu(zhat * g1 + be1).reshape(bsz, c1)
    return h1, h, z1, mu, var, inv


def pool_fc_fwd(mx, mn, s3c, t3, w1, b1, g1, be1, rm1, groups: int,
                bf16: bool = False):
    """The forward pass: the kernel on a CUDA tensor, the plain version
    on a CPU tensor. ``w1`` is ``[c3, c1]`` (on the card, the view of a
    row-major ``[c1, c3]`` weight); ``mn``, ``s3c`` and ``t3`` all None is
    the identity fold."""
    if launch.on_cpu(mx):
        return pool_fc_fwd_plain(mx, mn, s3c, t3, w1, b1, g1, be1, rm1,
                                 groups, bf16)
    bsz, c3 = mx.shape
    c1 = w1.shape[1]
    dev = mx.device
    if groups < 1 or bsz % groups:
        raise ValueError(f"batch {bsz} does not split into {groups} groups")
    fold = (("mn", mn, (bsz, c3)), ("s3c", s3c, (c3,)), ("t3", t3, (c3,)))
    if any(t is None for _, t, _ in fold):
        if any(t is not None for _, t, _ in fold):
            raise ValueError("mn, s3c and t3 are all given or all None (the "
                             "identity fold)")
        fold = ()
    for name, t, shape in (("mx", mx, (bsz, c3)), *fold,
                           ("b1", b1, (c1,)), ("g1", g1, (c1,)),
                           ("be1", be1, (c1,)), ("rm1", rm1, (c1,))):
        launch.expect(name, t, shape, dev)
    launch.expect("w1", w1, (c3, c1), dev, weight=True)
    f32 = dict(device=dev, dtype=torch.float32)
    h1, z1 = torch.empty((bsz, c1), **f32), torch.empty((bsz, c1), **f32)
    h = torch.empty((bsz, c3), **f32)
    mu, var, inv = (torch.empty((groups, c1), **f32) for _ in range(3))
    a = launch.args(launch.PoolFcArgs, batch=bsz, c3=c3, c1=c1,
                    groups=groups, prec=launch.prec(bf16), mx=mx, mn=mn,
                    s3c=s3c, t3=t3, w1=w1.t(), b1=b1, g1=g1, be1=be1, rm1=rm1,
                    h1=h1, h=h, z1=z1, mu=mu, var=var, inv=inv)
    launch.call("pt_pool_fc_fwd", dev, ctypes.addressof(a))
    pool_fc_fwd.launches += 1
    return h1, h, z1, mu, var, inv


pool_fc_fwd.launches = 0


class _PoolFc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, mx, mn, s3c, t3, w1, b1, g1, be1, rm1):
        ctx.bf16 = core.compute_dtype() is not None
        with torch.no_grad():
            h1, h, z1, mu, var, inv = pool_fc_fwd(
                mx, mn, s3c, t3, w1, b1, g1, be1, rm1.detach(), groups,
                ctx.bf16)
        ctx.groups = groups
        ctx.save_for_backward(mx, mn, s3c, h, z1, w1, g1, be1, mu, inv)
        ctx.mark_non_differentiable(mu, var)
        return h1, h, mu, var

    @staticmethod
    def backward(ctx, dh1, dh_extra, _dmu, _dvar):
        mx, mn, s3c, h, z1, w1, g1, be1, mu, inv = ctx.saved_tensors
        groups = ctx.groups
        gb, c1 = z1.shape
        b = gb // groups
        if dh1 is None:
            dh1 = torch.zeros_like(z1)
        # Batch-BN backward, per group, through the batch statistics.
        invg = inv.reshape(groups, 1, c1)
        zhat = (z1.reshape(groups, b, c1) - mu.reshape(groups, 1, c1)) * invg
        h1 = torch.relu(zhat * g1 + be1)
        dy = dh1.reshape(groups, b, c1) * (h1 > 0)
        t1 = dy.sum(1, keepdim=True)
        t2 = (dy * zhat).sum(1, keepdim=True)
        dz1 = ((g1 * invg) * (dy - t1 / b - zhat * (t2 / b))).reshape(gb, c1)
        dw1 = torch.matmul(core.operand(h, ctx.bf16).t(),
                           core.operand(dz1, ctx.bf16))
        dh = torch.matmul(dz1, w1.t())
        if dh_extra is not None:
            dh = dh + dh_extra
        # Pool-affine backward.
        dg = dh * (h > 0)
        if s3c is None:       # the identity fold: mx is relu's input
            return (None, dg, None, None, None, dw1, dz1.sum(0),
                    t2.sum((0, 1)), t1.sum((0, 1)), None)
        pos = s3c >= 0
        sel = torch.where(pos, mx, mn)
        dsel = dg * s3c
        zero = torch.zeros_like(dsel)
        return (None, torch.where(pos, dsel, zero), torch.where(pos, zero, dsel),
                (dg * sel).sum(0), dg.sum(0), dw1, dz1.sum(0),
                t2.sum((0, 1)), t1.sum((0, 1)), None)


def pool_fc_epilogue(mx, mn, s3c, t3, w1, b1, g1, be1,
                     rm1: Optional[torch.Tensor] = None, groups: int = 1):
    """``(mx, mn) [B, c3]`` trunk extrema and the BN3 fold ``(s3c, t3)``
    (``mn``, ``s3c``, ``t3`` None: the identity fold, ``h = relu(mx)``)
    -> pooled feature -> ReLU -> fc1 -> batch-BN (``g1``, ``be1``, moments
    about ``rm1``: ``core.rows_moments``) -> ReLU. Returns ``(h1 [B, c1],
    h [B, c3], mu1, var1_biased)``; ``mu1``/``var1`` are ``[c1]``
    (``[groups, c1]`` for ``groups > 1``: statistics per contiguous block
    of ``B // groups`` rows) and carry no gradient."""
    if rm1 is None:
        rm1 = torch.zeros_like(b1)
    h1, h, mu, var = _PoolFc.apply(groups, mx, mn, s3c, t3, w1, b1, g1, be1,
                                   rm1)
    if groups == 1:
        mu, var = mu.reshape(-1), var.reshape(-1)
    return h1, h, mu, var


def relu_fc_bn_relu(g, w1, b1, g1, be1, rm1: Optional[torch.Tensor] = None,
                    groups: int = 1):
    """``relu(bn(relu(g) @ w1 + b1))`` through the same kernel in its
    identity fold (the JAX package's ``g`` as both extrema with ``s3c =
    1``, ``t3 = 0``: ``h = relu(g)``), which reads ``g`` once and
    allocates nothing but the outputs. Returns ``(h1, mu1,
    var1_biased)``."""
    h1, _, mu, var = pool_fc_epilogue(g, None, None, None, w1, b1, g1, be1,
                                      rm1, groups)
    return h1, mu, var


def pool_fc_epilogue_reference(mx, mn, s3c, t3, w1, b1, g1, be1,
                               rm1: Optional[torch.Tensor] = None,
                               groups: int = 1):
    """The whole function as a plain composition under torch autograd,
    for gradient checks: same outputs as ``pool_fc_epilogue``."""
    if rm1 is None:
        rm1 = torch.zeros_like(b1)
    h1, h, _, mu, var, _ = pool_fc_fwd_plain(mx, mn, s3c, t3, w1, b1, g1,
                                             be1, rm1.detach(), groups)
    if groups == 1:
        mu, var = mu.reshape(-1), var.reshape(-1)
    return h1, h, mu.detach(), var.detach()
