"""Fused training trunk: conv2 + BN2 + ReLU -> conv3 + BN3 -> max-pool.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
trunk_train.py::trunk2_train``. Three CUDA passes (``csrc/
trunk_train.cu``, whose header says what bounds them on the card):

* **F1** ``z2 = x @ w2 + b2`` and its column sum / sum of squares;
* **F2** ``z3 = relu(bn2(z2)) @ w3 + b3`` tile by tile, never stored: its
  column sum / sum of squares and each cloud's channel max and min with
  the first point that attains them;
* **B1** the backward through conv3 + BN3 + pool: ``dy2``, ``dw3``,
  ``db3`` and BN2's two reduction sums ``t1``/``t2``.

All three run on the tensor cores (``csrc/train_bwd_tc.cu``; F2 and B1
share their prologue and first GEMM; F1 at ``c_in <= 4``, trunk3's raw
points, as exact fp32 FMAs).

Each pass has a plain PyTorch twin of the same signature (``f1_plain``,
``f2_plain``, ``b1_plain``) that CPU tensors run. The glue between the
passes is plain PyTorch, as the JAX custom VJP's is XLA: the moments,
the max/min choice by the sign of BN3's scale, the BN3 channel scalars
from the pooled output, BN2's elementwise backward and ``dx``/``dw2``.
The returned batch statistics carry no gradient (running-statistic
updates); everything the forward normalizes with is differentiated.

Under data parallelism (``parallel/dist.py``) every statistic is the
global batch's, and only the glue changes: the forward all-reduces each
pass's column sums before ``batch_moments`` and counts the global rows
(per stream with ``groups``); the backward all-reduces BN3's channel
sums ``s1``/``s2`` before ``coef1``/``coef2`` and B1's ``t1``/``t2``
before BN2's elementwise backward, while the gradients it returns for
the BN parameters stay the rank's own (``all_reduce_grads`` sums them).
The passes are unchanged. Each all-reduce sits between two passes.

``trunk3_train`` (the JAX package's, ``trunk_train.py:515``) puts conv1 +
BN1 + ReLU in front: the whole T-Net conv stack, composed of the passes
the port already has, in the JAX package's order: F1 on the raw input,
the seg head's Pmid, F2; backward B1, the seg head's Bmid and B1
(``seg_head_train.py``). Nothing in the models calls it, as in the JAX
package.

Two switches, on every pass and its twin:

* ``groups``: the batch is ``groups`` stacked same-size streams (the
  ``--paired_trunks`` path) and every BN statistic is per stream: the
  sums and the BN2/BN3 terms the passes take are ``[groups, C]``; a
  block of a pass never spans two clouds, so each stream's statistics
  add the same partial sums in the same order as a call on that stream
  alone, and the pooled values are bit-identical to it. (A twin runs
  each stream through its ``groups == 1`` self and adds the weight
  gradients.)
* ``bf16`` (the mixed-precision scope): every matmul operand, the
  cotangents included, is rounded to bf16 and summed in fp32; the z2
  stash is bf16, while the statistics come from the unrounded z.
"""

from __future__ import annotations

import ctypes

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.models.core import (
    BN_EPS, batch_moments,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import launch
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    seg_head_train,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist

_op = core.operand
global_sums = seg_head_train.global_sums



def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _stat(t: torch.Tensor, groups: int) -> torch.Tensor:
    """A per-stream statistic as the passes return it: ``[C]`` for one
    group, ``[groups, C]`` otherwise."""
    return t[0] if groups == 1 else t


def _per_group(plain, groups, tensors, stats, per_cloud=(), rest=()):
    """``plain`` on each stream: ``tensors`` split by clouds, ``stats``
    (``[groups, C]`` or ``[C]``) by rows, ``per_cloud`` by clouds."""
    bpg = tensors[0].shape[0] // groups
    outs = []
    for g in range(groups):
        cut = slice(g * bpg, (g + 1) * bpg)
        outs.append(plain(*(t[cut] for t in tensors),
                          *(s.reshape(groups, -1)[g] for s in stats),
                          *(t[cut] for t in per_cloud), *rest))
    return outs


# ---------------------------------------------------------------------------
# The three passes and their plain versions
# ---------------------------------------------------------------------------

def _f1_one(x, w2, b2, bf16):
    z2 = torch.matmul(_op(x, bf16), _op(w2, bf16)) + b2
    return core.stash(z2, bf16), z2.sum((0, 1)), (z2 * z2).sum((0, 1))


def f1_plain(x, w2, b2, groups: int = 1, bf16: bool = False):
    """``(z2 [B, N, c2], sum, sum of squares)`` of ``z2 = x @ w2 + b2``
    (bf16 under ``bf16``; the sums of the unrounded z2)."""
    outs = _per_group(lambda x_: _f1_one(x_, w2, b2, bf16), groups, (x,), ())
    return (torch.cat([o[0] for o in outs]),
            _stat(torch.stack([o[1] for o in outs]), groups),
            _stat(torch.stack([o[2] for o in outs]), groups))


def f1(x, w2, b2, groups: int = 1, bf16: bool = False):
    if launch.on_cpu(x):
        return f1_plain(x, w2, b2, groups, bf16)
    bsz, n, c_in = x.shape
    c2 = w2.shape[1]
    dev = x.device
    launch.check_groups(bsz, groups)
    launch.expect("x", x, (bsz, n, c_in), dev)
    ldw = launch.weight_ld("w2", w2, (c_in, c2), dev)
    launch.expect("b2", b2, (c2,), dev)
    f32 = dict(device=dev, dtype=torch.float32)
    z2 = torch.empty((bsz, n, c2), device=dev,
                     dtype=launch.stash_dtype(bf16))
    s, ss = torch.empty((groups, c2), **f32), torch.empty((groups, c2), **f32)
    # F1 runs on the tensor cores: per-block partials of TC_TILE points.
    part = torch.empty((2, launch.row_blocks(bsz, n, launch.TC_TILE), c2),
                       **f32)
    a = launch.args(launch.RowFwdArgs, batch=bsz, n=n, c_in=c_in, c_out=c2,
                    ldw=ldw, groups=groups, prec=launch.prec(bf16, z=z2),
                    x=x, w=w2.t(), bias=b2, z=z2, sum=s, ssq=ss, part=part)
    launch.call("pt_trunk_f1", dev, ctypes.addressof(a))
    f1.launches += 1
    return z2, _stat(s, groups), _stat(ss, groups)


def _f2_one(z2, sc2, sh2, w3, b3, bf16):
    h2 = torch.relu(z2.float() * sc2 + sh2)
    z3 = torch.matmul(_op(h2, bf16), _op(w3, bf16)) + b3
    mx, imax = z3.max(dim=1)
    mn, imin = z3.min(dim=1)
    return (z3.sum((0, 1)), (z3 * z3).sum((0, 1)), mx, mn,
            imax.to(torch.int32), imin.to(torch.int32))


def f2_plain(z2, sc2, sh2, w3, b3, groups: int = 1, bf16: bool = False):
    """``(sum, sum of squares, max, min, argmax, argmin)`` of ``z3 =
    relu(z2 * sc2 + sh2) @ w3 + b3``; the extrema are per cloud ``[B,
    c3]``, their indices the first point attaining them (int32)."""
    outs = _per_group(
        lambda z, sc, sh: _f2_one(z, sc, sh, w3, b3, bf16), groups, (z2,),
        (sc2, sh2))
    return (_stat(torch.stack([o[0] for o in outs]), groups),
            _stat(torch.stack([o[1] for o in outs]), groups),
            *(torch.cat([o[i] for o in outs]) for i in range(2, 6)))


def f2(z2, sc2, sh2, w3, b3, groups: int = 1, bf16: bool = False):
    if launch.on_cpu(z2):
        return f2_plain(z2, sc2, sh2, w3, b3, groups, bf16)
    bsz, n, c2 = z2.shape
    c3 = w3.shape[1]
    dev = z2.device
    launch.check_groups(bsz, groups)
    launch.expect_stash("z2", z2, (bsz, n, c2), dev)
    for name, t in (("sc2", sc2), ("sh2", sh2)):
        launch.expect(name, t, (c2,) if groups == 1 else (groups, c2), dev)
    ldw = launch.weight_ld("w3", w3, (c2, c3), dev)
    launch.expect("b3", b3, (c3,), dev)
    f32 = dict(device=dev, dtype=torch.float32)
    s, ss = torch.empty((groups, c3), **f32), torch.empty((groups, c3), **f32)
    mx, mn = torch.empty((bsz, c3), **f32), torch.empty((bsz, c3), **f32)
    imax = torch.empty((bsz, c3), device=dev, dtype=torch.int32)
    imin = torch.empty((bsz, c3), device=dev, dtype=torch.int32)
    # F2 runs on the tensor cores: per-block partials of TC_TILE points.
    part = torch.empty((2, launch.row_blocks(bsz, n, launch.TC_TILE), c3),
                       **f32)
    keys = torch.empty((2, bsz, c3), device=dev, dtype=torch.int64)
    a = launch.args(launch.RowFwdArgs, batch=bsz, n=n, c_in=c2, c_out=c3,
                    ldw=ldw, groups=groups, prec=launch.prec(bf16, x=z2),
                    x=z2, sc=sc2, sh=sh2, w=w3.t(), bias=b3, sum=s, ssq=ss,
                    part=part, keys=keys, mx=mx, mn=mn, imax=imax, imin=imin)
    launch.call("pt_trunk_f2", dev, ctypes.addressof(a))
    f2.launches += 1
    return _stat(s, groups), _stat(ss, groups), mx, mn, imax, imin


def _b1_one(z2, sc2, sh2, mu3, inv3, mu2, inv2, coef1, coef2, s3dg, idx, w3,
            b3, bf16):
    z2f = z2.float()
    h2 = torch.relu(z2f * sc2 + sh2)
    z3 = torch.matmul(_op(h2, bf16), _op(w3, bf16)) + b3
    zhat3 = (z3 - mu3) * inv3
    points = torch.arange(z2.shape[1], device=z2.device)[None, :, None]
    sparse = torch.where(points == idx[:, None, :], s3dg[:, None, :],
                         torch.zeros((), device=z2.device))
    dz3 = sparse - coef1[:, None, :] - zhat3 * coef2[:, None, :]
    dw3 = torch.matmul(_rows(_op(h2, bf16)).t(), _rows(_op(dz3, bf16)))
    dy2 = torch.matmul(_op(dz3, bf16), _op(w3, bf16).t()) * (h2 > 0)
    zhat2 = (z2f - mu2) * inv2
    return (dy2, dw3, dz3.sum((0, 1)), dy2.sum((0, 1)),
            (dy2 * zhat2).sum((0, 1)))


def b1_plain(z2, sc2, sh2, w3, b3, mu3, inv3, coef1, coef2, s3dg, idx,
             mu2, inv2, groups: int = 1, bf16: bool = False):
    """Backward through conv3 + BN3 + pool. ``coef1``/``coef2``/``s3dg``
    ``[B, c3]`` are BN3's per-cloud channel terms, ``idx [B, c3]`` the
    pooled winners. ``dz3 = [n == idx] * s3dg - coef1 - zhat3 * coef2``;
    returns ``(dy2 [B, N, c2], dw3 [c2, c3], db3, t1, t2)`` with ``dy2``
    (fp32) the cotangent of ``bn2``'s output after the ReLU mask, ``t1 =
    sum dy2`` and ``t2 = sum dy2 * zhat2`` per stream."""
    outs = _per_group(
        lambda *a: _b1_one(*a, w3, b3, bf16), groups, (z2,),
        (sc2, sh2, mu3, inv3, mu2, inv2), (coef1, coef2, s3dg, idx))
    return (torch.cat([o[0] for o in outs]), sum(o[1] for o in outs),
            sum(o[2] for o in outs),
            _stat(torch.stack([o[3] for o in outs]), groups),
            _stat(torch.stack([o[4] for o in outs]), groups))


def b1(z2, sc2, sh2, w3, b3, mu3, inv3, coef1, coef2, s3dg, idx, mu2, inv2,
       groups: int = 1, bf16: bool = False):
    if launch.on_cpu(z2):
        return b1_plain(z2, sc2, sh2, w3, b3, mu3, inv3, coef1, coef2, s3dg,
                        idx, mu2, inv2, groups, bf16)
    bsz, n, c2 = z2.shape
    c3 = w3.shape[1]
    dev = z2.device
    launch.check_groups(bsz, groups)
    launch.expect_stash("z2", z2, (bsz, n, c2), dev)
    for name, t in (("sc2", sc2), ("sh2", sh2), ("mu2", mu2), ("inv2", inv2)):
        launch.expect(name, t, (c2,) if groups == 1 else (groups, c2), dev)
    ldw = launch.weight_ld("w3", w3, (c2, c3), dev)
    launch.expect("b3", b3, (c3,), dev)
    for name, t in (("mu3", mu3), ("inv3", inv3)):
        launch.expect(name, t, (c3,) if groups == 1 else (groups, c3), dev)
    for name, t in (("coef1", coef1), ("coef2", coef2), ("s3dg", s3dg)):
        launch.expect(name, t, (bsz, c3), dev)
    launch.expect("idx", idx, (bsz, c3), dev, dtype=torch.int32)
    f32 = dict(device=dev, dtype=torch.float32)
    dy2 = torch.empty((bsz, n, c2), **f32)
    dw3 = torch.empty((c3, c2), **f32)
    db3 = torch.empty(c3, **f32)
    t1, t2 = torch.empty((groups, c2), **f32), torch.empty((groups, c2), **f32)
    # The tensor-core pass writes dz3 and h2 for dW3 = dz3^T h2 on the
    # GEMM core, split over row ranges.
    rows = bsz * n
    splits = launch.row_splits(rows, c3, c2, dev)
    part = torch.empty((launch.row_blocks(bsz, n, launch.TC_TILE),
                        2 * c2 + c3), **f32)
    part_w = torch.empty((splits, c3 * c2), **f32)
    dzs, hs = torch.empty((rows, c3), **f32), torch.empty((rows, c2), **f32)
    a = launch.args(launch.BwdArgs, mode=launch.DZ_TRUNK, batch=bsz, n=n,
                    c_in=c2, c_out=c3, ldw=ldw, splits=splits, groups=groups,
                    prec=launch.prec(bf16, zp=z2), zp=z2, scp=sc2, shp=sh2,
                    mup=mu2, invp=inv2, w=w3.t(), bias=b3, mu=mu3, inv=inv3,
                    coef1=coef1, coef2=coef2, s3dg=s3dg, idx=idx, dyp=dy2,
                    t1=t1, t2=t2, db=db3, dw=dw3, part=part, part_w=part_w,
                    dzs=dzs, hs=hs)
    launch.call("pt_trunk_b1", dev, ctypes.addressof(a))
    b1.launches += 1
    return dy2, dw3.t(), db3, _stat(t1, groups), _stat(t2, groups)


f1.launches = f2.launches = b1.launches = 0
PASSES = {"F1": f1, "F2": f2, "B1": b1}


# ---------------------------------------------------------------------------
# The autograd function
# ---------------------------------------------------------------------------

def _g4(t: torch.Tensor, groups: int) -> torch.Tensor:
    """``[B, N, C]`` as ``[groups, B // groups, N, C]``."""
    return t.reshape(groups, -1, *t.shape[1:])


def _gv(v: torch.Tensor, groups: int) -> torch.Tensor:
    """A ``[C]`` or ``[groups, C]`` statistic against ``_g4``."""
    return v.reshape(groups, 1, 1, -1)


def _per_cloud(v: torch.Tensor, groups: int, bpg: int) -> torch.Tensor:
    """A ``[groups, C]`` statistic as ``[B, C]`` rows; one group's ``[C]``
    stays as it is (it broadcasts)."""
    if groups == 1:
        return v
    return v.reshape(groups, -1).repeat_interleave(bpg, 0)


class _Trunk2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, x, w2, b2, g2, be2, w3, b3, g3, be3):
        bf16 = core.compute_dtype() is not None
        bsz, n, _ = x.shape
        bpg = bsz // groups
        m = dist.count(bpg * n, True)                 # rows per stream
        z2, s2, ss2 = f1(x, w2, b2, groups, bf16)
        mu2, var2, inv2 = batch_moments(*global_sums(s2, ss2), m)
        sc2 = g2 * inv2
        sh2 = be2 - mu2 * sc2
        s3, ss3, mx, mn, imax, imin = f2(z2, sc2, sh2, w3, b3, groups, bf16)
        mu3, var3, inv3 = batch_moments(*global_sums(s3, ss3), m)
        s3c = g3 * inv3
        t3 = _per_cloud(be3 - mu3 * s3c, groups, bpg)
        s3c = _per_cloud(s3c, groups, bpg)
        pos = s3c >= 0
        g = torch.where(pos, mx, mn) * s3c + t3
        idx = torch.where(pos, imax, imin)
        ctx.groups, ctx.bf16 = groups, bf16
        ctx.save_for_backward(x, z2, mu2, inv2, sc2, sh2, w2, w3, b3, mu3,
                              inv3, g3, be3, g, idx)
        ctx.mark_non_differentiable(mu2, var2, mu3, var3)
        return g, mu2, var2, mu3, var3

    @staticmethod
    def backward(ctx, dg, *_stats):
        (x, z2, mu2, inv2, sc2, sh2, w2, w3, b3, mu3, inv3, g3, be3, g,
         idx) = ctx.saved_tensors
        groups, bf16 = ctx.groups, ctx.bf16
        bsz, n, _ = x.shape
        bpg = bsz // groups
        m = dist.count(bpg * n, True)
        s3c = g3 * inv3                               # [C] or [G, C]
        # BN3's channel terms per stream: zhat at the winners comes back
        # from the pooled output (g3 == 0 guarded, as in the JAX VJP).
        safe_g3 = torch.where(g3 == 0, torch.ones_like(g3), g3)
        zhat_win = (g - be3) / safe_g3
        dgg = dg.reshape(groups, bpg, -1)
        s1 = dgg.sum(1).reshape(s3c.shape)
        s2 = (dgg * zhat_win.reshape(groups, bpg, -1)).sum(1).reshape(
            s3c.shape)
        coef1, coef2 = (_per_cloud(s3c * t / m, groups, bpg).expand(
            bsz, -1).contiguous() for t in global_sums(s1, s2))
        s3dg = (_per_cloud(s3c, groups, bpg) * dg).contiguous()
        dy2, dw3, db3, t1, t2 = b1(z2, sc2, sh2, w3, b3, mu3, inv3, coef1,
                                   coef2, s3dg, idx, mu2, inv2, groups, bf16)
        # BN2's elementwise backward per stream; dx and dw2 are plain
        # matmuls (bf16 operands under the scope, as the JAX VJP's).
        t1g, t2g = global_sums(t1, t2)
        zhat2 = (_g4(z2.float(), groups) - _gv(mu2, groups)) * _gv(inv2,
                                                                   groups)
        dz2 = (_gv(sc2, groups) * (_g4(dy2, groups) - _gv(t1g, groups) / m
                                   - zhat2 * (_gv(t2g, groups) / m))
               ).reshape(dy2.shape)
        dx = torch.matmul(_op(dz2, bf16), _op(w2, bf16).t())
        dw2 = torch.matmul(_rows(_op(x, bf16)).t(), _rows(_op(dz2, bf16)))
        if groups > 1:    # the affine parameters are shared by the streams
            t1, t2, s1, s2 = (v.sum(0) for v in (t1, t2, s1, s2))
        return (None, dx, dw2, dz2.sum((0, 1)), t2, t1, dw3, db3, s2, s1)


def trunk2_train(x, w2, b2, g2, be2, w3, b3, g3, be3, groups: int = 1):
    """``x [B, N, c1]`` -> ``(pooled [B, c3], mu2, var2, mu3, var3)``: the
    max over points of ``bn3(relu(bn2(x @ w2 + b2)) @ w3 + b3)`` with
    batch statistics; the variances are biased and the four statistics
    carry no gradient. ``groups > 1``: ``x`` is ``groups`` stacked
    streams, every statistic is per stream and ``[groups, C]``, and the
    pooled values equal ``groups`` separate calls bit for bit. Weights
    are ``[in, out]`` (on a CUDA device, views of row-major ``[out, in]``
    storage); bf16 operands under ``core.mixed_precision``."""
    launch.check_groups(x.shape[0], groups)
    return _Trunk2.apply(groups, x, w2, b2, g2, be2, w3, b3, g3, be3)


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


# ---------------------------------------------------------------------------
# trunk3: conv1 + BN1 + ReLU folded in front (the whole T-Net conv stack)
# ---------------------------------------------------------------------------

class _Trunk3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, g3, be3):
        bf16 = ctx.bf16 = core.compute_dtype() is not None
        bsz, n, _ = x.shape
        m = dist.count(bsz * n, True)
        z1, s1, ss1 = f1(x, w1, b1, 1, bf16)
        mu1, var1, inv1 = batch_moments(*global_sums(s1, ss1), m)
        sc1 = g1 * inv1
        sh1 = be1 - mu1 * sc1
        z2, s2, ss2 = seg_head_train.pmid(z1, sc1, sh1, w2, b2, bf16)
        mu2, var2, inv2 = batch_moments(*global_sums(s2, ss2), m)
        sc2 = g2 * inv2
        sh2 = be2 - mu2 * sc2
        s3, ss3, mx, mn, imax, imin = f2(z2, sc2, sh2, w3, b3, 1, bf16)
        mu3, var3, inv3 = batch_moments(*global_sums(s3, ss3), m)
        s3c = g3 * inv3
        pos = s3c >= 0
        g = torch.where(pos, mx, mn) * s3c + (be3 - mu3 * s3c)
        idx = torch.where(pos, imax, imin)
        ctx.save_for_backward(x, z1, z2, w1, w2, w3, b3, mu1, inv1, sc1, sh1,
                              mu2, inv2, sc2, sh2, mu3, inv3, g3, be3, g, idx)
        ctx.mark_non_differentiable(mu1, var1, mu2, var2, mu3, var3)
        return g, mu1, var1, mu2, var2, mu3, var3

    @staticmethod
    def backward(ctx, dg, *_stats):
        (x, z1, z2, w1, w2, w3, b3, mu1, inv1, sc1, sh1, mu2, inv2, sc2, sh2,
         mu3, inv3, g3, be3, g, idx) = ctx.saved_tensors
        bf16 = ctx.bf16
        bsz, n, _ = x.shape
        m = dist.count(bsz * n, True)
        s3c = g3 * inv3
        # BN3's channel terms: zhat at the winners comes back from the
        # pooled output (g3 == 0 guarded, as in the JAX VJP).
        safe_g3 = torch.where(g3 == 0, torch.ones_like(g3), g3)
        zhat_win = (g - be3) / safe_g3
        s1 = dg.sum(0)
        s2 = (dg * zhat_win).sum(0)
        coef1, coef2 = ((s3c * t / m).expand(bsz, -1).contiguous()
                        for t in global_sums(s1, s2))
        s3dg = (s3c * dg).contiguous()
        dy2, dw3, db3, t1_2, t2_2 = b1(z2, sc2, sh2, w3, b3, mu3, inv3, coef1,
                                       coef2, s3dg, idx, mu2, inv2, 1, bf16)
        # Each BN's reduction sums come from the pass after it, scaled to
        # the coefficients of its dz = dy * sc - coef1 - zhat * coef2.
        t1g, t2g = global_sums(t1_2, t2_2)
        dy1, dw2, db2, t1_1, t2_1 = seg_head_train.bmid(
            z2, dy2, sc2, mu2, inv2, sc2 * t1g / m, sc2 * t2g / m, z1, sc1,
            sh1, w2, mu1, inv1, bf16)
        t1g, t2g = global_sums(t1_1, t2_1)
        dx, dw1, db1, _ = seg_head_train.b1(z1, dy1, sc1, mu1, inv1,
                                            sc1 * t1g / m, sc1 * t2g / m, x,
                                            w1, bf16)
        return (dx, dw1, db1, t2_1, t1_1, dw2, db2, t2_2, t1_2, dw3, db3, s2,
                s1)


def trunk3_train(x, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, g3, be3):
    """``x [B, N, c0]`` -> ``(pooled [B, c3], mu1, var1, mu2, var2, mu3,
    var3)``: the max over points of ``bn3(relu(bn2(relu(bn1(x @ w1 + b1))
    @ w2 + b2)) @ w3 + b3)`` with batch statistics (biased variances; the
    six statistics carry no gradient, while everything the forward
    normalizes with is differentiated). The caller applies the
    reference's post-pool ReLU. Weights are ``[in, out]`` (on a CUDA
    device, views of row-major ``[out, in]`` storage); bf16 operands and
    stashes under ``core.mixed_precision``, as the passes take them."""
    return _Trunk3.apply(x, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, g3,
                         be3)


def trunk3_train_reference(x, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, g3,
                           be3):
    """The whole function as a plain composition under torch autograd
    (two-pass moments, ``max`` over points), for gradient checks."""
    h, stats = x, []
    for w, b, ga, be in ((w1, b1, g1, be1), (w2, b2, g2, be2),
                         (w3, b3, g3, be3)):
        if stats:
            h = torch.relu(h)
        z = torch.matmul(h, w) + b
        mu, var = z.mean((0, 1)), z.var((0, 1), unbiased=False)
        h = (z - mu) * torch.rsqrt(var + BN_EPS) * ga + be
        stats += [mu.detach(), var.detach()]
    return (h.max(dim=1).values, *stats)
