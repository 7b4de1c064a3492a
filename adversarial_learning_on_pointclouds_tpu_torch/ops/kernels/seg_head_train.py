"""Fused training segmentation head: [point | global] -> 512 -> 256 -> 128
-> k with batch-statistic BatchNorms and a per-point log_softmax.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
seg_head_train.py::seg_head_train``. Six CUDA passes, all on the tensor
cores (entry points in ``csrc/seg_head_train.cu``, kernels in
``csrc/train_bwd_tc.cu``, whose headers say what bounds them on the
card); each forward pass stashes only the pre-BN ``z`` of its layer and
applies the previous layer's BN + ReLU as it reads:

* **P1** ``z1 = pf @ W1[:64] + g_row + b1`` (``g_row = g @ W1[64:]``, one
  row per cloud: the 1088-wide concat never exists) and its statistics
  (trunk F1's tile, ``pf`` fp32);
* **Pmid** (x2) ``z = relu(bn(z_prev)) @ W + b`` and its statistics;
* **P4** ``log_softmax(relu(bn3(z3)) @ W4 + b4)`` per point (B4's first
  half, the same arithmetic);
* **B4** the softmax and conv4 backward, ``dy3`` and BN3's sums;
* **Bmid** (x2) a BN backward and the matmul backward to the layer
  before, with its BN sums;
* **B1** BN1's backward, ``dw1a``, ``db1``, ``dpf`` and the per-cloud row
  sum ``r`` of ``dz1`` (the cotangent of ``g_row``; ``pf`` fp32).

Each pass has a plain PyTorch twin of the same signature that CPU
tensors run. ``g_row``, ``dg`` and ``dw1b`` are plain fp32 matmuls, as
they are XLA at HIGHEST precision in the JAX package. Each BN's
reduction sums come from the pass after it, one pass behind, as in the
JAX VJP.

Under data parallelism (``parallel/dist.py``) the glue all-reduces each
forward pass's column sums before ``batch_moments`` (the global count of
rows) and each backward pass's ``t1``/``t2`` before they become the
coefficients of the BN before them; the BN parameters' gradients stay
the rank's own (``all_reduce_grads`` sums them). The passes are
unchanged.

Every pass and twin takes a ``bf16`` switch (the mixed-precision scope):
each matmul operand, cotangents included, is rounded to bf16 and summed
in fp32, and the stashes ``z1``, the mid ``z``s, ``dy3`` and the Bmid
``dy_prev`` are bf16; statistics and the BN sums come from the unrounded
values of the pass that makes them, and the later passes read the
rounded stashes.
"""

from __future__ import annotations

import ctypes

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.models.core import (
    BN_EPS, batch_moments,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import launch
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist

_op = core.operand


def global_sums(*sums: torch.Tensor):
    """Per-point column sums as the global batch's: one all-reduce of the
    stacked sums at world size above 1 (no autograd: the callers are
    autograd functions' bodies), the tensors themselves at 1."""
    if not dist.spans(True):
        return sums
    return tuple(dist.all_reduce_(torch.stack(sums), "sum", "stats").unbind(0))


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _f32(dev):
    return dict(device=dev, dtype=torch.float32)


def _stats(z):
    return z.sum((0, 1)), (z * z).sum((0, 1))


def _bn_relu(z, sc, sh):
    return torch.relu(z.float() * sc + sh)


def _mm(a, b, bf16):
    return torch.matmul(_op(a, bf16), _op(b, bf16))


def _fwd(symbol, x, sc, sh, w, b, bf16, addend=None, logp=False):
    """One forward pass on the card (``csrc/train_bwd_tc.cu``): ``[B, N,
    c_in]`` in, the pre-BN ``z`` (a stash) and its statistics out (or,
    with ``logp``, log-probabilities); the statistics from per-block
    partials, a block per ``launch.TC_TILE`` points."""
    bsz, n, c_in = x.shape
    c_out = w.shape[1]
    dev = x.device
    launch.expect_stash("x", x, (bsz, n, c_in), dev)
    if sc is not None:
        launch.expect("sc", sc, (c_in,), dev)
        launch.expect("sh", sh, (c_in,), dev)
    ldw = launch.weight_ld("w", w, (c_in, c_out), dev)
    launch.expect("b", b, (c_out,), dev)
    if addend is not None:
        launch.expect("g_row", addend, (bsz, c_out), dev)
    out = torch.empty((bsz, n, c_out), device=dev,
                      dtype=torch.float32 if logp else launch.stash_dtype(bf16))
    fields = dict(batch=bsz, n=n, c_in=c_in, c_out=c_out, ldw=ldw, x=x,
                  sc=sc, sh=sh, w=w.t(), bias=b, addend=addend,
                  prec=launch.prec(bf16, x=x, z=None if logp else out))
    if logp:
        fields.update(logp=out)
        stats = ()
    else:
        stats = (torch.empty(c_out, **_f32(dev)),
                 torch.empty(c_out, **_f32(dev)))
        part = torch.empty(
            (2, launch.row_blocks(bsz, n, launch.TC_TILE), c_out), **_f32(dev))
        fields.update(z=out, sum=stats[0], ssq=stats[1], part=part)
    a = launch.args(launch.RowFwdArgs, **fields)
    launch.call(symbol, dev, ctypes.addressof(a))
    return (out, *stats) if stats else out


def _bwd(symbol, mode, zp, scp, shp, mup, invp, w, bf16, r=False,
         dyp_stash=False, **dz):
    """One backward pass on the card (``csrc/train_bwd_tc.cu``): ``dz``
    of the current layer (from ``mode``'s inputs), then ``dy_prev = dz @
    W^T`` (masked by the previous ReLU; a stash under ``dyp_stash``), the
    previous BN's sums, ``dW`` and ``db``. Bmid and B1 write ``dz`` and
    (behind a previous BN) ``h`` for ``dW = dz^T h`` on the GEMM core;
    head B1's ``h`` is ``z_prev`` itself. B4 takes ``dW`` on its tiles in
    shared memory, a partial per block (at most ``splits`` blocks)."""
    bsz, n, c_in = zp.shape
    c_out = w.shape[1]
    dev = zp.device
    launch.expect_stash("z_prev", zp, (bsz, n, c_in), dev)
    for name, t in (("scp", scp), ("shp", shp), ("mup", mup),
                    ("invp", invp)):
        if t is not None:
            launch.expect(name, t, (c_in,), dev)
    ldw = launch.weight_ld("w", w, (c_in, c_out), dev)
    for name, t in dz.items():
        if name in ("zc", "dy"):
            launch.expect_stash(name, t, (bsz, n, c_out), dev)
        else:
            launch.expect(name, t, (bsz, n, c_out) if name == "dlp"
                          else (c_out,), dev)
    f32 = _f32(dev)
    dyp = torch.empty((bsz, n, c_in), device=dev,
                      dtype=launch.stash_dtype(bf16 and dyp_stash))
    t1, t2 = ((torch.empty(c_in, **f32), torch.empty(c_in, **f32))
              if mup is not None else (None, None))
    db = torch.empty(c_out, **f32)
    rr = torch.empty((bsz, c_out), **f32) if r else None
    dw = torch.empty((c_out, c_in), **f32)
    rows = bsz * n
    splits = launch.row_splits(rows, c_out, c_in, dev)
    part = torch.empty((launch.row_blocks(bsz, n, launch.TC_TILE),
                        2 * c_in + c_out), **f32)
    if mode != launch.DZ_SOFTMAX:
        dz.update(dzs=torch.empty((rows, c_out), **f32),
                  hs=None if scp is None else torch.empty((rows, c_in),
                                                          **f32))
    part_w = torch.empty((splits, c_out * c_in), **f32)
    prec = launch.prec(bf16, zp=zp, zc=dz.get("zc"), dy=dz.get("dy"),
                       dyp=dyp)
    a = launch.args(launch.BwdArgs, mode=mode, batch=bsz, n=n, c_in=c_in,
                    c_out=c_out, ldw=ldw, splits=splits, prec=prec, zp=zp,
                    scp=scp,
                    shp=shp, mup=mup, invp=invp, w=w.t(), dyp=dyp, t1=t1,
                    t2=t2, db=db, r=rr, dw=dw, part=part, part_w=part_w,
                    **dz)
    launch.call(symbol, dev, ctypes.addressof(a))
    return dyp, dw.t(), db, t1, t2, rr


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def p1_plain(pf, g_row, w1a, b1, bf16: bool = False):
    """``(z1, sum, sum of squares)``: ``z1 = pf @ w1a + g_row[:, None] +
    b1``."""
    z1 = _mm(pf, w1a, bf16) + g_row[:, None, :] + b1
    return (core.stash(z1, bf16), *_stats(z1))


def p1(pf, g_row, w1a, b1, bf16: bool = False):
    if launch.on_cpu(pf):
        return p1_plain(pf, g_row, w1a, b1, bf16)
    out = _fwd("pt_head_p1", pf, None, None, w1a, b1, bf16, addend=g_row)
    p1.launches += 1
    return out


def pmid_plain(z_prev, sc, sh, w, b, bf16: bool = False):
    """``(z, sum, sum of squares)``: ``z = relu(z_prev * sc + sh) @ w +
    b``."""
    z = _mm(_bn_relu(z_prev, sc, sh), w, bf16) + b
    return (core.stash(z, bf16), *_stats(z))


def pmid(z_prev, sc, sh, w, b, bf16: bool = False):
    if launch.on_cpu(z_prev):
        return pmid_plain(z_prev, sc, sh, w, b, bf16)
    out = _fwd("pt_head_pmid", z_prev, sc, sh, w, b, bf16)
    pmid.launches += 1
    return out


def p4_plain(z3, sc3, sh3, w4, b4, bf16: bool = False):
    """Per-point ``log_softmax(relu(z3 * sc3 + sh3) @ w4 + b4)``."""
    return torch.log_softmax(_mm(_bn_relu(z3, sc3, sh3), w4, bf16) + b4,
                             dim=-1)


def p4(z3, sc3, sh3, w4, b4, bf16: bool = False):
    if launch.on_cpu(z3):
        return p4_plain(z3, sc3, sh3, w4, b4, bf16)
    out = _fwd("pt_head_p4", z3, sc3, sh3, w4, b4, bf16, logp=True)
    p4.launches += 1
    return out


# ---------------------------------------------------------------------------
# Backward passes
# ---------------------------------------------------------------------------

def _prev_terms(dhp, zp, scp, shp, mup, invp):
    """``dy_prev`` behind the previous BN + ReLU and that BN's sums."""
    dyp = dhp * (_bn_relu(zp, scp, shp) > 0)
    zhatp = (zp.float() - mup) * invp
    return dyp, dyp.sum((0, 1)), (dyp * zhatp).sum((0, 1))


def _wgrad(h, dz, bf16):
    return _mm(_rows(h).t(), _rows(dz), bf16)


def b4_plain(z3, sc3, sh3, w4, b4, mu3, inv3, dlogp, bf16: bool = False):
    """Softmax + conv4 backward: ``(dy3, dw4, db4, t1, t2)``, ``dy3`` a
    stash."""
    h3 = _bn_relu(z3, sc3, sh3)
    p = torch.softmax(_mm(h3, w4, bf16) + b4, dim=-1)
    dz4 = dlogp - p * dlogp.sum(-1, keepdim=True)
    dw4 = _wgrad(h3, dz4, bf16)
    dy3, t1, t2 = _prev_terms(_mm(dz4, w4.t(), bf16), z3, sc3, sh3, mu3,
                              inv3)
    return core.stash(dy3, bf16), dw4, dz4.sum((0, 1)), t1, t2


def b4(z3, sc3, sh3, w4, b4_, mu3, inv3, dlogp, bf16: bool = False):
    if launch.on_cpu(z3):
        return b4_plain(z3, sc3, sh3, w4, b4_, mu3, inv3, dlogp, bf16)
    dy3, dw4, db4, t1, t2, _ = _bwd("pt_head_b4", launch.DZ_SOFTMAX, z3, sc3,
                                    sh3, mu3, inv3, w4, bf16, dyp_stash=True,
                                    bias=b4_, dlp=dlogp)
    b4.launches += 1
    return dy3, dw4, db4, t1, t2


def _bn_dz(zc, dy, sc, mu, inv, coef1, coef2):
    return dy.float() * sc - coef1 - ((zc.float() - mu) * inv) * coef2


def bmid_plain(zc, dy, sc, mu, inv, coef1, coef2, zp, scp, shp, w, mup,
               invp, bf16: bool = False):
    """BN backward at the current layer (``dz = dy * sc - coef1 - zhat *
    coef2``, the coefficients from the pass before) and the matmul
    backward to the previous one: ``(dy_prev, dw, db, t1, t2)``,
    ``dy_prev`` a stash."""
    dz = _bn_dz(zc, dy, sc, mu, inv, coef1, coef2)
    dw = _wgrad(_bn_relu(zp, scp, shp), dz, bf16)
    dyp, t1, t2 = _prev_terms(_mm(dz, w.t(), bf16), zp, scp, shp, mup, invp)
    return core.stash(dyp, bf16), dw, dz.sum((0, 1)), t1, t2


def bmid(zc, dy, sc, mu, inv, coef1, coef2, zp, scp, shp, w, mup, invp,
         bf16: bool = False):
    if launch.on_cpu(zc):
        return bmid_plain(zc, dy, sc, mu, inv, coef1, coef2, zp, scp, shp, w,
                          mup, invp, bf16)
    dyp, dw, db, t1, t2, _ = _bwd("pt_head_bmid", launch.DZ_BN, zp, scp, shp,
                                  mup, invp, w, bf16, dyp_stash=True,
                                  zc=zc, dy=dy, sc=sc, mu=mu, inv=inv,
                                  c1=coef1, c2=coef2)
    bmid.launches += 1
    return dyp, dw, db, t1, t2


def b1_plain(z1, dy1, sc1, mu1, inv1, coef1, coef2, pf, w1a,
             bf16: bool = False):
    """BN1 backward and the point half of layer 1: ``(dpf, dw1a, db1, r)``
    with ``r [B, c1]`` each cloud's sum of ``dz1`` (``dpf`` fp32)."""
    dz = _bn_dz(z1, dy1, sc1, mu1, inv1, coef1, coef2)
    dw1a = _wgrad(pf, dz, bf16)
    r = dz.sum(1)
    return _mm(dz, w1a.t(), bf16), dw1a, r.sum(0), r


def b1(z1, dy1, sc1, mu1, inv1, coef1, coef2, pf, w1a, bf16: bool = False):
    if launch.on_cpu(z1):
        return b1_plain(z1, dy1, sc1, mu1, inv1, coef1, coef2, pf, w1a, bf16)
    dpf, dw1a, db1, _, _, r = _bwd("pt_head_b1", launch.DZ_BN, pf, None, None,
                                   None, None, w1a, bf16, r=True, zc=z1,
                                   dy=dy1, sc=sc1, mu=mu1, inv=inv1,
                                   c1=coef1, c2=coef2)
    b1.launches += 1
    return dpf, dw1a, db1, r


for _pass in (p1, pmid, p4, b4, bmid, b1):
    _pass.launches = 0
PASSES = {"P1": p1, "Pmid": pmid, "P4": p4, "B4": b4, "Bmid": bmid, "B1": b1}


# ---------------------------------------------------------------------------
# The autograd function
# ---------------------------------------------------------------------------

class _SegHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pf, g, w1, b1_, g1, be1, w2, b2, g2, be2, w3, b3, g3,
                be3, w4, b4_):
        bf16 = ctx.bf16 = core.compute_dtype() is not None
        bsz, n, c_pf = pf.shape
        m = dist.count(bsz * n, True)
        w1a, w1b = w1[:c_pf], w1[c_pf:]
        g_row = torch.matmul(g, w1b)
        z1, s1, ss1 = p1(pf, g_row, w1a, b1_, bf16)
        mu1, var1, inv1 = batch_moments(*global_sums(s1, ss1), m)
        sc1 = g1 * inv1
        sh1 = be1 - mu1 * sc1
        z2, s2, ss2 = pmid(z1, sc1, sh1, w2, b2, bf16)
        mu2, var2, inv2 = batch_moments(*global_sums(s2, ss2), m)
        sc2 = g2 * inv2
        sh2 = be2 - mu2 * sc2
        z3, s3, ss3 = pmid(z2, sc2, sh2, w3, b3, bf16)
        mu3, var3, inv3 = batch_moments(*global_sums(s3, ss3), m)
        sc3 = g3 * inv3
        sh3 = be3 - mu3 * sc3
        logp = p4(z3, sc3, sh3, w4, b4_, bf16)
        ctx.save_for_backward(pf, g, z1, z2, z3, w1, w2, w3, w4, b4_, mu1,
                              inv1, sc1, sh1, mu2, inv2, sc2, sh2, mu3, inv3,
                              sc3, sh3)
        ctx.mark_non_differentiable(mu1, var1, mu2, var2, mu3, var3)
        return logp, mu1, var1, mu2, var2, mu3, var3

    @staticmethod
    def backward(ctx, dlogp, *_stats):
        (pf, g, z1, z2, z3, w1, w2, w3, w4, b4_, mu1, inv1, sc1, sh1, mu2,
         inv2, sc2, sh2, mu3, inv3, sc3, sh3) = ctx.saved_tensors
        bsz, n, c_pf = pf.shape
        m = dist.count(bsz * n, True)
        bf16 = ctx.bf16
        dy3, dw4, db4, t1_3, t2_3 = b4(z3, sc3, sh3, w4, b4_, mu3, inv3,
                                       dlogp.contiguous(), bf16)
        t1g, t2g = global_sums(t1_3, t2_3)
        dy2, dw3, db3, t1_2, t2_2 = bmid(z3, dy3, sc3, mu3, inv3,
                                         sc3 * t1g / m, sc3 * t2g / m,
                                         z2, sc2, sh2, w3, mu2, inv2, bf16)
        t1g, t2g = global_sums(t1_2, t2_2)
        dy1, dw2, db2, t1_1, t2_1 = bmid(z2, dy2, sc2, mu2, inv2,
                                         sc2 * t1g / m, sc2 * t2g / m,
                                         z1, sc1, sh1, w2, mu1, inv1, bf16)
        w1a, w1b = w1[:c_pf], w1[c_pf:]
        t1g, t2g = global_sums(t1_1, t2_1)
        dpf, dw1a, db1, r = b1(z1, dy1, sc1, mu1, inv1, sc1 * t1g / m,
                               sc1 * t2g / m, pf, w1a, bf16)
        # The global half of layer 1 ran as a per-cloud row g @ w1b.
        dg = torch.matmul(r, w1b.t())
        dw1 = torch.cat([dw1a, torch.matmul(g.t(), r)], dim=0)
        return (dpf, dg, dw1, db1, t2_1, t1_1, dw2, db2, t2_2, t1_2, dw3,
                db3, t2_3, t1_3, dw4, db4)


def seg_head_train(pf, g, w1, b1_, g1, be1, w2, b2, g2, be2, w3, b3, g3, be3,
                   w4, b4_):
    """``pf [B, N, c_pf]``, ``g [B, c_g]`` -> ``(logp [B, N, k], mu1,
    var1, mu2, var2, mu3, var3)``: the head on the implicit ``[pf | g]``
    concat with batch-statistic BNs (biased variances; the statistics
    carry no gradient). ``w1`` is the whole ``[c_pf + c_g, c1]`` first
    weight; weights are ``[in, out]`` (on a CUDA device, views of
    row-major ``[out, in]`` storage); bf16 operands and stashes under
    ``core.mixed_precision``."""
    return _SegHead.apply(pf, g, w1, b1_, g1, be1, w2, b2, g2, be2, w3, b3,
                          g3, be3, w4, b4_)


def seg_head_train_reference(pf, g, w1, b1_, g1, be1, w2, b2, g2, be2, w3,
                             b3, g3, be3, w4, b4_):
    """The whole function as a plain composition under torch autograd
    (the explicit concat, two-pass moments), for gradient checks."""
    bsz, n, _ = pf.shape
    h = torch.cat([pf, g[:, None, :].expand(bsz, n, -1)], dim=-1)
    stats = []
    for w, b, ga, be in ((w1, b1_, g1, be1), (w2, b2, g2, be2),
                         (w3, b3, g3, be3)):
        z = torch.matmul(h, w) + b
        mu, var = z.mean((0, 1)), z.var((0, 1), unbiased=False)
        h = torch.relu((z - mu) * torch.rsqrt(var + BN_EPS) * ga + be)
        stats += [mu.detach(), var.detach()]
    return (torch.log_softmax(torch.matmul(h, w4) + b4_, dim=-1), *stats)
