"""The T-Net fc head in training: fc1 + batch-BN + ReLU -> fc2 + batch-BN
+ ReLU -> fc3 on the pooled ``[B, 1024]`` rows.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
fc_head_train.py::fc_head_train``, which the JAX package's single-stream
T-Net head runs under ``use_pallas(training=True)`` (here
``dispatch.use_pallas_train``). Two CUDA passes in
``csrc/fc_head_train.cu``, three launches each of ``csrc/small_fc.cuh``'s
split-K tensor-core product across thread-block clusters (its header
says what bounds them on the card):

* ``fc_head_fwd``: the forward, with batch-axis moments about the
  running means ``rm1``/``rm2`` (``core.rows_moments``); it stashes
  ``z1``/``z2`` and returns the statistics;
* ``fc_head_bwd``: both BN layers' backward from the stashes, with the
  full batch-statistic terms, given the cotangent of ``h2``.

fc3's affine backward runs between the two in plain PyTorch (fp32), as
the JAX VJP runs it in XLA. The batch statistics are stop-gradient
auxiliaries for the running-statistic update. Under
``core.mixed_precision`` the three forward products and ``dw1``/``dw2``
take bf16 operands and the cotangents of ``h1`` and ``h`` stay fp32, as
in the JAX kernels. Each pass has a plain twin (``*_plain``) that CPU
tensors run; it rounds as the JAX lines do (the forward normalizes as
``(z - mu) * (inv * g) + be``, the backward recomputes ``relu(((z - mu)
* inv) * g + be)``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import launch

_op = core.operand


def _moments(z: torch.Tensor, c: torch.Tensor):
    """Batch-axis ``(mean, biased var, 1/sqrt(var + eps))`` of ``z`` about
    ``c`` (``core.rows_moments``, ``csrc/small_fc.cuh``'s BN epilogue)."""
    return tuple(t[0] for t in core.rows_moments(z, c))


def fc_head_fwd_plain(h, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, rm1, rm2,
                      bf16: bool = False):
    """``(out, z1, z2, mu1, var1, inv1, mu2, var2, inv2)``."""
    z1 = torch.matmul(_op(h, bf16), _op(w1, bf16)) + b1
    mu1, var1, inv1 = _moments(z1, rm1)
    h1 = torch.relu((z1 - mu1) * (inv1 * g1) + be1)
    z2 = torch.matmul(_op(h1, bf16), _op(w2, bf16)) + b2
    mu2, var2, inv2 = _moments(z2, rm2)
    h2 = torch.relu((z2 - mu2) * (inv2 * g2) + be2)
    out = torch.matmul(_op(h2, bf16), _op(w3, bf16)) + b3
    return out, z1, z2, mu1, var1, inv1, mu2, var2, inv2


def recompute_h(z, mu, inv, g, be):
    """``relu(bn(z))`` as the backward recomputes it from the stash."""
    return torch.relu(((z - mu) * inv) * g + be)


def _bn_bwd(dh, z, mu, inv, g, be, prev, bf16):
    """One BN layer's backward: ``(dz, dw, db, dg, dbe)``."""
    b = z.shape[0]
    zhat = (z - mu) * inv
    dy = dh * (torch.relu(zhat * g + be) > 0)
    t1, t2 = dy.sum(0), (dy * zhat).sum(0)
    dz = (g * inv) * (dy - t1 / b - zhat * (t2 / b))
    dw = torch.matmul(_op(prev, bf16).t(), _op(dz, bf16))
    return dz, dw, dz.sum(0), t2, t1


def fc_head_bwd_plain(dh2, h, z1, z2, w1, w2, g1, be1, g2, be2, mu1, inv1,
                      mu2, inv2, bf16: bool = False):
    """``(dh, dw1, db1, dg1, dbe1, dw2, db2, dg2, dbe2)`` from ``dh2``, the
    cotangent of ``h2``."""
    h1 = recompute_h(z1, mu1, inv1, g1, be1)
    dz2, dw2, db2, dg2, dbe2 = _bn_bwd(dh2, z2, mu2, inv2, g2, be2, h1, bf16)
    dh1 = torch.matmul(dz2, w2.t())
    dz1, dw1, db1, dg1, dbe1 = _bn_bwd(dh1, z1, mu1, inv1, g1, be1, h, bf16)
    return (torch.matmul(dz1, w1.t()), dw1, db1, dg1, dbe1, dw2, db2, dg2,
            dbe2)


def _fc_args(h, w1, w2, g1, be1, g2, be2, **fields):
    """The shapes every pass checks, and the argument struct."""
    bsz, c0 = h.shape
    c1, c2 = w1.shape[1], w2.shape[1]
    dev = h.device
    launch.expect("h", h, (bsz, c0), dev)
    launch.expect("w1", w1, (c0, c1), dev, weight=True)
    launch.expect("w2", w2, (c1, c2), dev, weight=True)
    for name, t, c in (("g1", g1, c1), ("be1", be1, c1), ("g2", g2, c2),
                       ("be2", be2, c2)):
        launch.expect(name, t, (c,), dev)
    return launch.args(launch.FcHeadArgs, batch=bsz, c0=c0, c1=c1, c2=c2,
                       h=h, w1=w1.t(), w2=w2.t(), g1=g1, be1=be1, g2=g2,
                       be2=be2, **fields)


def fc_head_fwd(h, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, rm1, rm2,
                bf16: bool = False):
    """The forward pass: ``h [B, c0]``, weights ``[in, out]`` (on the card,
    views of row-major ``[out, in]`` weights) -> ``(out [B, c3], z1, z2,
    mu1, var1, inv1, mu2, var2, inv2)``."""
    if launch.on_cpu(h):
        return fc_head_fwd_plain(h, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3,
                                 rm1, rm2, bf16)
    bsz = h.shape[0]
    c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
    dev = h.device
    launch.expect("w3", w3, (c2, c3), dev, weight=True)
    for name, t, c in (("b1", b1, c1), ("rm1", rm1, c1), ("b2", b2, c2),
                       ("rm2", rm2, c2), ("b3", b3, c3)):
        launch.expect(name, t, (c,), dev)
    f32 = dict(device=dev, dtype=torch.float32)
    out = torch.empty((bsz, c3), **f32)
    z1, h1 = (torch.empty((bsz, c1), **f32) for _ in range(2))
    z2, h2 = (torch.empty((bsz, c2), **f32) for _ in range(2))
    mu1, var1, inv1 = (torch.empty((c1,), **f32) for _ in range(3))
    mu2, var2, inv2 = (torch.empty((c2,), **f32) for _ in range(3))
    a = _fc_args(h, w1, w2, g1, be1, g2, be2, c3=c3, prec=launch.prec(bf16),
                 b1=b1, rm1=rm1, b2=b2, rm2=rm2, w3=w3.t(), b3=b3, out=out,
                 z1=z1, z2=z2, mu1=mu1, var1=var1, inv1=inv1, mu2=mu2,
                 var2=var2, inv2=inv2, h1=h1, h2=h2)
    launch.call("pt_fc_head_fwd", dev, ctypes.addressof(a))
    fc_head_fwd.launches += 1
    return out, z1, z2, mu1, var1, inv1, mu2, var2, inv2


def fc_head_bwd(dh2, h, z1, z2, w1, w2, g1, be1, g2, be2, mu1, inv1, mu2,
                inv2, bf16: bool = False):
    """The backward of both BN layers: ``(dh, dw1, db1, dg1, dbe1, dw2, db2,
    dg2, dbe2)``, the weight gradients as ``[in, out]`` views of row-major
    ``[out, in]`` tensors."""
    if launch.on_cpu(dh2):
        return fc_head_bwd_plain(dh2, h, z1, z2, w1, w2, g1, be1, g2, be2,
                                 mu1, inv1, mu2, inv2, bf16)
    bsz, c0 = h.shape
    c1, c2 = w1.shape[1], w2.shape[1]
    dev = h.device
    for name, t, shape in (("dh2", dh2, (bsz, c2)), ("z1", z1, (bsz, c1)),
                           ("z2", z2, (bsz, c2)), ("mu1", mu1, (c1,)),
                           ("inv1", inv1, (c1,)), ("mu2", mu2, (c2,)),
                           ("inv2", inv2, (c2,))):
        launch.expect(name, t, shape, dev)
    f32 = dict(device=dev, dtype=torch.float32)
    dh = torch.empty((bsz, c0), **f32)
    dw1, dw2 = torch.empty((c1, c0), **f32), torch.empty((c2, c1), **f32)
    db1, dg1, dbe1 = (torch.empty((c1,), **f32) for _ in range(3))
    db2, dg2, dbe2 = (torch.empty((c2,), **f32) for _ in range(3))
    dz1, dz2 = torch.empty((bsz, c1), **f32), torch.empty((bsz, c2), **f32)
    a = _fc_args(h, w1, w2, g1, be1, g2, be2, c3=1, prec=launch.prec(bf16),
                 z1=z1, z2=z2, mu1=mu1, inv1=inv1, mu2=mu2, inv2=inv2,
                 dh2=dh2, dh=dh, dw1=dw1, db1=db1, dg1=dg1, dbe1=dbe1,
                 dw2=dw2, db2=db2, dg2=dg2, dbe2=dbe2, dz1=dz1, dz2=dz2)
    launch.call("pt_fc_head_bwd", dev, ctypes.addressof(a))
    fc_head_bwd.launches += 1
    return dh, dw1.t(), db1, dg1, dbe1, dw2.t(), db2, dg2, dbe2


fc_head_fwd.launches = fc_head_bwd.launches = 0
PASSES = {"fwd": fc_head_fwd, "bwd": fc_head_bwd}


class _FcHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, rm1, rm2):
        ctx.bf16 = core.compute_dtype() is not None
        h = h.contiguous()
        out, z1, z2, mu1, var1, inv1, mu2, var2, inv2 = fc_head_fwd(
            h, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, rm1, rm2, ctx.bf16)
        ctx.save_for_backward(h, z1, z2, w1, w2, w3, g1, be1, g2, be2, mu1,
                              inv1, mu2, inv2)
        ctx.mark_non_differentiable(mu1, var1, mu2, var2)
        return out, mu1, var1, mu2, var2

    @staticmethod
    def backward(ctx, dout, *_stats):
        (h, z1, z2, w1, w2, w3, g1, be1, g2, be2, mu1, inv1, mu2,
         inv2) = ctx.saved_tensors
        # fc3's affine backward, fp32, as the JAX VJP's XLA part.
        h2 = recompute_h(z2, mu2, inv2, g2, be2)
        dw3 = torch.matmul(h2.t(), dout)
        dh2 = torch.matmul(dout, w3.t()).contiguous()
        grads = fc_head_bwd(dh2, h, z1, z2, w1, w2, g1, be1, g2, be2, mu1,
                            inv1, mu2, inv2, ctx.bf16)
        return (*grads, dw3, dout.sum(0), None, None)


def fc_head_train(h, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3,
                  rm1: Optional[torch.Tensor] = None,
                  rm2: Optional[torch.Tensor] = None):
    """fc1 + BN1 + ReLU -> fc2 + BN2 + ReLU -> fc3 on ``h [B, c0]`` under
    autograd (weights: the ``[in, out]`` views of the layers' weights;
    ``rm1``/``rm2`` the BN running means the moments centre on, zeros by
    default). Returns ``(out [B, c3], mu1, var1_biased, mu2,
    var2_biased)``; the statistics carry no gradient. The caller adds
    fc3's identity bias."""
    if rm1 is None:
        rm1 = torch.zeros_like(b1)
    if rm2 is None:
        rm2 = torch.zeros_like(b2)
    return _FcHead.apply(h, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3,
                         rm1.detach(), rm2.detach())


def fc_head_train_reference(h, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3,
                            rm1: Optional[torch.Tensor] = None,
                            rm2: Optional[torch.Tensor] = None):
    """The whole function as a plain composition under torch autograd
    (gradients through the batch statistics), for gradient checks: same
    outputs as ``fc_head_train``."""
    if rm1 is None:
        rm1 = torch.zeros_like(b1)
    if rm2 is None:
        rm2 = torch.zeros_like(b2)
    out, _, _, mu1, var1, _, mu2, var2, _ = fc_head_fwd_plain(
        h, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, rm1.detach(),
        rm2.detach())
    return out, mu1.detach(), var1.detach(), mu2.detach(), var2.detach()
