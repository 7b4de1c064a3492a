"""Fused training trunk: conv2 + BN2 + ReLU -> conv3 + BN3 -> max-pool.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
trunk_train.py::trunk2_train`` (groups = 1). Three CUDA passes
(``csrc/trunk_train.cu``, whose header says what bounds them on the card):

* **F1** ``z2 = x @ w2 + b2`` and its column sum / sum of squares;
* **F2** ``z3 = relu(bn2(z2)) @ w3 + b3`` tile by tile, never stored: its
  column sum / sum of squares and each cloud's channel max and min with
  the first point that attains them;
* **B1** the backward through conv3 + BN3 + pool: ``dy2``, ``dw3``,
  ``db3`` and BN2's two reduction sums ``t1``/``t2``.

Each pass has a plain PyTorch twin of the same signature (``f1_plain``,
``f2_plain``, ``b1_plain``) that CPU tensors run. The glue between the
passes is plain PyTorch, as the JAX custom VJP's is XLA: the moments,
the max/min choice by the sign of BN3's scale, the BN3 channel scalars
from the pooled output, BN2's elementwise backward and ``dx``/``dw2``.
The returned batch statistics carry no gradient (running-statistic
updates); everything the forward normalizes with is differentiated.
"""

from __future__ import annotations

import ctypes

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models.core import (
    BN_EPS, batch_moments,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import launch


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


# ---------------------------------------------------------------------------
# The three passes and their plain versions
# ---------------------------------------------------------------------------

def f1_plain(x, w2, b2):
    """``(z2 [B, N, c2], sum, sum of squares)`` of ``z2 = x @ w2 + b2``."""
    z2 = torch.matmul(x, w2) + b2
    return z2, z2.sum((0, 1)), (z2 * z2).sum((0, 1))


def f1(x, w2, b2):
    if launch.on_cpu(x):
        return f1_plain(x, w2, b2)
    bsz, n, c_in = x.shape
    c2 = w2.shape[1]
    dev = x.device
    launch.expect("x", x, (bsz, n, c_in), dev)
    ldw = launch.weight_ld("w2", w2, (c_in, c2), dev)
    launch.expect("b2", b2, (c2,), dev)
    f32 = dict(device=dev, dtype=torch.float32)
    z2 = torch.empty((bsz, n, c2), **f32)
    s, ss = torch.empty(c2, **f32), torch.empty(c2, **f32)
    part = torch.empty((2, launch.row_blocks(bsz, n), c2), **f32)
    a = launch.args(launch.RowFwdArgs, batch=bsz, n=n, c_in=c_in, c_out=c2,
                    ldw=ldw, x=x, w=w2.t(), bias=b2, z=z2, sum=s, ssq=ss,
                    part=part)
    launch.call("pt_trunk_f1", dev, ctypes.addressof(a))
    f1.launches += 1
    return z2, s, ss


def f2_plain(z2, sc2, sh2, w3, b3):
    """``(sum, sum of squares, max, min, argmax, argmin)`` of ``z3 =
    relu(z2 * sc2 + sh2) @ w3 + b3``; the extrema are per cloud ``[B,
    c3]``, their indices the first point attaining them (int32)."""
    h2 = torch.relu(z2 * sc2 + sh2)
    z3 = torch.matmul(h2, w3) + b3
    mx, imax = z3.max(dim=1)
    mn, imin = z3.min(dim=1)
    return (z3.sum((0, 1)), (z3 * z3).sum((0, 1)), mx, mn,
            imax.to(torch.int32), imin.to(torch.int32))


def f2(z2, sc2, sh2, w3, b3):
    if launch.on_cpu(z2):
        return f2_plain(z2, sc2, sh2, w3, b3)
    bsz, n, c2 = z2.shape
    c3 = w3.shape[1]
    dev = z2.device
    launch.expect("z2", z2, (bsz, n, c2), dev)
    launch.expect("sc2", sc2, (c2,), dev)
    launch.expect("sh2", sh2, (c2,), dev)
    ldw = launch.weight_ld("w3", w3, (c2, c3), dev)
    launch.expect("b3", b3, (c3,), dev)
    f32 = dict(device=dev, dtype=torch.float32)
    s, ss = torch.empty(c3, **f32), torch.empty(c3, **f32)
    mx, mn = torch.empty((bsz, c3), **f32), torch.empty((bsz, c3), **f32)
    imax = torch.empty((bsz, c3), device=dev, dtype=torch.int32)
    imin = torch.empty((bsz, c3), device=dev, dtype=torch.int32)
    part = torch.empty((2, launch.row_blocks(bsz, n), c3), **f32)
    keys = torch.empty((2, bsz, c3), device=dev, dtype=torch.int64)
    a = launch.args(launch.RowFwdArgs, batch=bsz, n=n, c_in=c2, c_out=c3,
                    ldw=ldw, x=z2, sc=sc2, sh=sh2, w=w3.t(), bias=b3, sum=s,
                    ssq=ss, part=part, keys=keys, mx=mx, mn=mn, imax=imax,
                    imin=imin)
    launch.call("pt_trunk_f2", dev, ctypes.addressof(a))
    f2.launches += 1
    return s, ss, mx, mn, imax, imin


def b1_plain(z2, sc2, sh2, w3, b3, mu3, inv3, coef1, coef2, s3dg, idx,
             mu2, inv2):
    """Backward through conv3 + BN3 + pool. ``coef1``/``coef2``/``s3dg``
    ``[B, c3]`` are BN3's per-cloud channel terms, ``idx [B, c3]`` the
    pooled winners. ``dz3 = [n == idx] * s3dg - coef1 - zhat3 * coef2``;
    returns ``(dy2 [B, N, c2], dw3 [c2, c3], db3, t1, t2)`` with ``dy2``
    the cotangent of ``bn2``'s output after the ReLU mask, ``t1 = sum
    dy2`` and ``t2 = sum dy2 * zhat2``."""
    h2 = torch.relu(z2 * sc2 + sh2)
    z3 = torch.matmul(h2, w3) + b3
    zhat3 = (z3 - mu3) * inv3
    points = torch.arange(z2.shape[1], device=z2.device)[None, :, None]
    sparse = torch.where(points == idx[:, None, :], s3dg[:, None, :],
                         torch.zeros((), device=z2.device))
    dz3 = sparse - coef1[:, None, :] - zhat3 * coef2[:, None, :]
    dw3 = torch.matmul(_rows(h2).t(), _rows(dz3))
    dy2 = torch.matmul(dz3, w3.t()) * (h2 > 0)
    zhat2 = (z2 - mu2) * inv2
    return (dy2, dw3, dz3.sum((0, 1)), dy2.sum((0, 1)),
            (dy2 * zhat2).sum((0, 1)))


def b1(z2, sc2, sh2, w3, b3, mu3, inv3, coef1, coef2, s3dg, idx, mu2, inv2):
    if launch.on_cpu(z2):
        return b1_plain(z2, sc2, sh2, w3, b3, mu3, inv3, coef1, coef2, s3dg,
                        idx, mu2, inv2)
    bsz, n, c2 = z2.shape
    c3 = w3.shape[1]
    dev = z2.device
    launch.expect("z2", z2, (bsz, n, c2), dev)
    for name, t in (("sc2", sc2), ("sh2", sh2), ("mu2", mu2), ("inv2", inv2)):
        launch.expect(name, t, (c2,), dev)
    ldw = launch.weight_ld("w3", w3, (c2, c3), dev)
    for name, t in (("b3", b3), ("mu3", mu3), ("inv3", inv3)):
        launch.expect(name, t, (c3,), dev)
    for name, t in (("coef1", coef1), ("coef2", coef2), ("s3dg", s3dg)):
        launch.expect(name, t, (bsz, c3), dev)
    launch.expect("idx", idx, (bsz, c3), dev, dtype=torch.int32)
    f32 = dict(device=dev, dtype=torch.float32)
    dy2 = torch.empty((bsz, n, c2), **f32)
    dw3 = torch.empty((c3, c2), **f32)
    db3, t1, t2 = (torch.empty(c, **f32) for c in (c3, c2, c2))
    splits = launch.weight_grad_splits(bsz * n, c3, c2, dev)
    part = torch.empty((launch.row_blocks(bsz, n), 2 * c2 + c3), **f32)
    part_w = torch.empty((splits, c3 * c2), **f32)
    a = launch.args(launch.BwdArgs, mode=launch.DZ_TRUNK, batch=bsz, n=n,
                    c_in=c2, c_out=c3, ldw=ldw, splits=splits, zp=z2,
                    scp=sc2, shp=sh2, mup=mu2, invp=inv2, w=w3.t(), bias=b3,
                    mu=mu3, inv=inv3, coef1=coef1, coef2=coef2, s3dg=s3dg,
                    idx=idx, dyp=dy2, t1=t1, t2=t2, db=db3, dw=dw3, part=part,
                    part_w=part_w)
    launch.call("pt_trunk_b1", dev, ctypes.addressof(a))
    b1.launches += 1
    return dy2, dw3.t(), db3, t1, t2


f1.launches = f2.launches = b1.launches = 0
PASSES = {"F1": f1, "F2": f2, "B1": b1}


# ---------------------------------------------------------------------------
# The autograd function
# ---------------------------------------------------------------------------

class _Trunk2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w2, b2, g2, be2, w3, b3, g3, be3):
        bsz, n, _ = x.shape
        m = bsz * n
        z2, s2, ss2 = f1(x, w2, b2)
        mu2, var2, inv2 = batch_moments(s2, ss2, m)
        sc2 = g2 * inv2
        sh2 = be2 - mu2 * sc2
        s3, ss3, mx, mn, imax, imin = f2(z2, sc2, sh2, w3, b3)
        mu3, var3, inv3 = batch_moments(s3, ss3, m)
        s3c = g3 * inv3
        t3 = be3 - mu3 * s3c
        pos = s3c >= 0
        g = torch.where(pos, mx, mn) * s3c + t3
        idx = torch.where(pos, imax, imin)
        ctx.save_for_backward(x, z2, mu2, inv2, sc2, sh2, w2, w3, b3, mu3,
                              inv3, g3, be3, g, idx)
        ctx.mark_non_differentiable(mu2, var2, mu3, var3)
        return g, mu2, var2, mu3, var3

    @staticmethod
    def backward(ctx, dg, *_stats):
        (x, z2, mu2, inv2, sc2, sh2, w2, w3, b3, mu3, inv3, g3, be3, g,
         idx) = ctx.saved_tensors
        bsz, n, _ = x.shape
        m = bsz * n
        s3c = g3 * inv3
        # BN3's channel terms: zhat at the winners comes back from the
        # pooled output (g3 == 0 guarded, as in the JAX VJP).
        safe_g3 = torch.where(g3 == 0, torch.ones_like(g3), g3)
        zhat_win = (g - be3) / safe_g3
        s1 = dg.sum(0)
        s2 = (dg * zhat_win).sum(0)
        coef1 = (s3c * s1 / m).expand(bsz, -1).contiguous()
        coef2 = (s3c * s2 / m).expand(bsz, -1).contiguous()
        s3dg = (s3c * dg).contiguous()
        dy2, dw3, db3, t1, t2 = b1(z2, sc2, sh2, w3, b3, mu3, inv3, coef1,
                                   coef2, s3dg, idx, mu2, inv2)
        # BN2's elementwise backward; dx and dw2 are plain matmuls.
        zhat2 = (z2 - mu2) * inv2
        dz2 = sc2 * (dy2 - t1 / m - zhat2 * (t2 / m))
        dx = torch.matmul(dz2, w2.t())
        dw2 = torch.matmul(_rows(x).t(), _rows(dz2))
        return dx, dw2, dz2.sum((0, 1)), t2, t1, dw3, db3, s2, s1


def trunk2_train(x, w2, b2, g2, be2, w3, b3, g3, be3, groups: int = 1):
    """``x [B, N, c1]`` -> ``(pooled [B, c3], mu2, var2, mu3, var3)``: the
    max over points of ``bn3(relu(bn2(x @ w2 + b2)) @ w3 + b3)`` with
    batch statistics; the variances are biased and the four statistics
    carry no gradient. Weights are ``[in, out]`` (on a CUDA device, views
    of row-major ``[out, in]`` storage)."""
    if groups != 1:
        raise NotImplementedError(
            "trunk2_train(groups > 1), the --paired_trunks path, is not "
            "ported yet (ROADMAP, Queue 2)")
    return _Trunk2.apply(x, w2, b2, g2, be2, w3, b3, g3, be3)


def trunk2_train_reference(x, w2, b2, g2, be2, w3, b3, g3, be3):
    """The whole function as a plain composition under torch autograd
    (two-pass moments, ``max`` over points), for gradient checks."""
    z2 = torch.matmul(x, w2) + b2
    mu2, var2 = z2.mean((0, 1)), z2.var((0, 1), unbiased=False)
    h2 = torch.relu((z2 - mu2) * torch.rsqrt(var2 + BN_EPS) * g2 + be2)
    z3 = torch.matmul(h2, w3) + b3
    mu3, var3 = z3.mean((0, 1)), z3.var((0, 1), unbiased=False)
    y3 = (z3 - mu3) * torch.rsqrt(var3 + BN_EPS) * g3 + be3
    return (y3.max(dim=1).values, mu2.detach(), var2.detach(), mu3.detach(),
            var3.detach())
