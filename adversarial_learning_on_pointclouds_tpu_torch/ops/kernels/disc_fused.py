"""Fused discriminator: the pointwise k -> 64 -> 128 -> 256 -> 512 -> 1
stack with LeakyReLU(0.2), forward and backward.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
disc_fused.py``. Four CUDA passes over ``x [B, N, k]``, each recomputing
the hidden activations from ``x``, all on the tensor cores in one source,
``csrc/disc_tc.cu`` (its header says what bounds them on the card):

* ``disc_fwd``: the logits ``[B, N, 1]`` (the forward kernel, 128 rows a
  block);
* ``disc_bwd_dx``: the input gradient only (D frozen, the generator
  step): the backward's row pass without scratch or partials;
* ``disc_bwd_dw``: the weight and bias gradients only (a detached input,
  the discriminator step): the row pass writes each layer's ``dz`` and
  ``h`` to scratch, then ``dW = dz^T h`` on the GEMM core;
* ``disc_bwd``: both (the full backward: ``disc_bwd_dw``'s pass with dx,
  which equals ``disc_bwd_dx``'s bit for bit).

Each has a plain PyTorch twin of the same signature (``*_plain``) that
CPU tensors run. Weights are ``[in, out]`` (on a CUDA device, views of
row-major ``[out, in]`` storage, as ``core.weight_in_out`` gives them);
biases ``[out]``. Every pass and twin takes a ``bf16`` switch (the
mixed-precision scope): each matmul operand, the cotangents included, is
rounded to bf16 and summed in fp32; the bias gradients sum the unrounded
cotangents. The four functions at the end are the JAX package's four
custom VJPs: ``disc_forward`` (full backward),
``disc_forward_frozen`` (input gradient only, no weight gradients),
``disc_forward_detached`` (weight gradients only) and
``disc_with_known_logits`` (returns given logits and installs the
weight-gradient backward from ``x``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import launch

WIDTHS = (64, 128, 256, 512, 1)
SLOPE = 0.2
MAX_K = 64                # input width the kernels take
# The weight-gradient pass's scratch a row (csrc/disc_tc.cu: kDzCols,
# kHCols): dz1..dz4 and h1..h3, the GEMM core's dW operands.
DZ_COLS, H_COLS = sum(WIDTHS[:4]), sum(WIDTHS[:3])

Tensors = Sequence[torch.Tensor]


def leaky(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, SLOPE * z)


def _dleaky(h: torch.Tensor) -> torch.Tensor:
    """LeakyReLU' from the sign of the output (the sign of the input)."""
    return torch.where(h >= 0, torch.ones_like(h), torch.full_like(h, SLOPE))


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


# ---------------------------------------------------------------------------
# The plain twins
# ---------------------------------------------------------------------------

def _mm(a, b, bf16):
    return torch.matmul(core.operand(a, bf16), core.operand(b, bf16))


def _hidden(x, ws, bs, bf16):
    hs = [x]
    for w, b in zip(ws[:4], bs[:4]):
        hs.append(leaky(_mm(hs[-1], w, bf16) + b))
    return hs


def disc_fwd_plain(x, ws, bs, bf16: bool = False):
    """Logits ``[B, N, 1]`` of ``x [B, N, k]``."""
    return _mm(_hidden(x, ws, bs, bf16)[-1], ws[4], bf16) + bs[4]


def _backward_plain(x, g, ws, bs, want_dx: bool, want_dw: bool, bf16):
    hs = _hidden(x, ws, bs, bf16)
    dh, dws, dbs = g, [], []
    for i in reversed(range(5)):
        dz = dh if i == 4 else dh * _dleaky(hs[i + 1])
        if want_dw:
            dws.insert(0, _mm(_rows(hs[i]).t(), _rows(dz), bf16))
            dbs.insert(0, dz.sum((0, 1)))
        if i > 0 or want_dx:
            dh = _mm(dz, ws[i].t(), bf16)
    return dh, tuple(dws), tuple(dbs)


def disc_bwd_dx_plain(x, g, ws, bs, bf16: bool = False):
    """``dx [B, N, k]`` from the logits' cotangent ``g [B, N, 1]``."""
    return _backward_plain(x, g, ws, bs, True, False, bf16)[0]


def disc_bwd_dw_plain(x, g, ws, bs, bf16: bool = False):
    """``(dws, dbs)``: the five weight gradients (``[in, out]``) and bias
    gradients; the chain stops at layer 2 (no input gradient)."""
    return _backward_plain(x, g, ws, bs, False, True, bf16)[1:]


def disc_bwd_plain(x, g, ws, bs, bf16: bool = False):
    """``(dx, dws, dbs)``, the full backward."""
    return _backward_plain(x, g, ws, bs, True, True, bf16)


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, ws: Tensors, bs: Tensors) -> Tuple[int, int]:
    bsz, n, k = x.shape
    dev = x.device
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the discriminator kernels take 1..{MAX_K} input "
                         f"channels, got {k}")
    launch.expect("x", x, (bsz, n, k), dev)
    c_in = k
    for i, (w, b, c_out) in enumerate(zip(ws, bs, WIDTHS), start=1):
        launch.expect(f"w{i}", w, (c_in, c_out), dev, weight=True)
        launch.expect(f"b{i}", b, (c_out,), dev)
        c_in = c_out
    return bsz * n, k


def _params(ws: Tensors, bs: Tensors) -> dict:
    out = {f"w{i}": w.t() for i, w in enumerate(ws, start=1)}
    out.update({f"b{i}": b for i, b in enumerate(bs, start=1)})
    return out


def grad_layout(k: int):
    """``[(offset, shape)]`` of dW1..dW5 (``[out, in]``) and db1..db5 in
    the kernel's gradient buffer (``GradLayout`` in the CUDA source), and
    its size."""
    shapes = []
    c_in = k
    for c_out in WIDTHS:
        shapes.append((c_out, c_in))
        c_in = c_out
    shapes += [(c,) for c in WIDTHS]
    out, at = [], 0
    for s in shapes:
        out.append((at, s))
        at += math.prod(s)
    return out, at


def disc_fwd(x, ws, bs, bf16: bool = False):
    """The forward pass: the kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    if launch.on_cpu(x):
        return disc_fwd_plain(x, ws, bs, bf16)
    m, k = _check(x, ws, bs)
    logits = torch.empty(x.shape[:2] + (1,), device=x.device,
                         dtype=torch.float32)
    a = launch.args(launch.DiscArgs, m=m, k=k, prec=launch.prec(bf16), x=x,
                    logits=logits, **_params(ws, bs))
    launch.call("pt_disc_fwd", x.device, ctypes.addressof(a))
    disc_fwd.launches += 1
    return logits


def disc_bwd_dx(x, g, ws, bs, bf16: bool = False):
    if launch.on_cpu(x):
        return disc_bwd_dx_plain(x, g, ws, bs, bf16)
    m, k = _check(x, ws, bs)
    launch.expect("g", g, x.shape[:2] + (1,), x.device)
    dx = torch.empty_like(x)
    a = launch.args(launch.DiscArgs, m=m, k=k, prec=launch.prec(bf16), x=x,
                    g=g, dx=dx, **_params(ws, bs))
    launch.call("pt_disc_bwd_dx", x.device, ctypes.addressof(a))
    disc_bwd_dx.launches += 1
    return dx


def _bwd_dw_launch(x, g, ws, bs, dx, bf16, scratch=None):
    """The weight-gradient pass (with ``dx`` given, the full backward).
    ``scratch``, a dict, receives the row pass's ``dzs [m, DZ_COLS]``,
    ``hs [m, H_COLS]`` and per-tile partials ``part`` (dW5 in its first
    512 columns), on which ``chip_smoke.py`` holds the pass product by
    product."""
    m, k = _check(x, ws, bs)
    dev = x.device
    launch.expect("g", g, x.shape[:2] + (1,), dev)
    layout, size = grad_layout(k)
    f32 = dict(device=dev, dtype=torch.float32)
    # dW1..dW4 = dz^T h on the GEMM core, each split over row ranges.
    shapes = [s for _, s in layout[:4]]
    splits = [launch.row_splits(m, o, i, dev) for o, i in shapes]
    grad = torch.empty(size, **f32)
    # The row pass's per-block partials of dW5 and db1..db4 (db5 is
    # summed from g).
    part = torch.empty((-(-m // launch.DISC_TILE),
                        layout[9][0] - layout[4][0]), **f32)
    part_w = torch.empty(sum(s * o * i for s, (o, i) in zip(splits, shapes)),
                         **f32)
    dzs, hs = torch.empty((m, DZ_COLS), **f32), torch.empty((m, H_COLS), **f32)
    a = launch.args(launch.DiscArgs, m=m, k=k, prec=launch.prec(bf16),
                    split1=splits[0], split2=splits[1], split3=splits[2],
                    split4=splits[3], x=x, g=g, dx=dx, grad=grad, part=part,
                    dzs=dzs, hs=hs, part_w=part_w, **_params(ws, bs))
    launch.call("pt_disc_bwd_dw", dev, ctypes.addressof(a))
    if scratch is not None:
        scratch.update(dzs=dzs, hs=hs, part=part)
    views = [grad[at:at + math.prod(s)].view(s) for at, s in layout]
    return tuple(w.t() for w in views[:5]), tuple(views[5:])


def disc_bwd_dw(x, g, ws, bs, bf16: bool = False):
    if launch.on_cpu(x):
        return disc_bwd_dw_plain(x, g, ws, bs, bf16)
    out = _bwd_dw_launch(x, g, ws, bs, None, bf16)
    disc_bwd_dw.launches += 1
    return out


def disc_bwd(x, g, ws, bs, bf16: bool = False):
    if launch.on_cpu(x):
        return disc_bwd_plain(x, g, ws, bs, bf16)
    dx = torch.empty_like(x)
    dws, dbs = _bwd_dw_launch(x, g, ws, bs, dx, bf16)
    disc_bwd.launches += 1
    return dx, dws, dbs


disc_fwd.launches = disc_bwd_dx.launches = disc_bwd_dw.launches = 0
disc_bwd.launches = 0
PASSES = {"fwd": disc_fwd, "bwd_dx": disc_bwd_dx, "bwd_dw": disc_bwd_dw,
          "bwd": disc_bwd}


# ---------------------------------------------------------------------------
# The autograd function
# ---------------------------------------------------------------------------

class _Disc(torch.autograd.Function):
    """The stack on ``x`` (or, given ``logits``, those logits) with one of
    the JAX package's four backward rules: ``full`` (input, weight and
    bias gradients), ``frozen`` (the input's only), ``detached`` and
    ``known`` (the weights' and biases' only)."""

    @staticmethod
    def forward(ctx, mode, logits, x, *params):
        ctx.mode = mode
        ctx.bf16 = core.compute_dtype() is not None
        ctx.save_for_backward(x, *params)
        if logits is not None:
            return logits.clone()
        return disc_fwd(x, params[:5], params[5:], ctx.bf16)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        ws, bs, g = params[:5], params[5:], g.contiguous()
        dx, dws, dbs = None, (None,) * 5, (None,) * 5
        if ctx.mode == "full":
            dx, dws, dbs = disc_bwd(x, g, ws, bs, ctx.bf16)
        elif ctx.mode == "frozen":
            dx = disc_bwd_dx(x, g, ws, bs, ctx.bf16)
        else:
            dws, dbs = disc_bwd_dw(x, g, ws, bs, ctx.bf16)
        return (None, None, dx, *dws, *dbs)


def disc_forward(x, ws, bs):
    """Logits of ``x [B, N, k]``; the backward gives the input, weight and
    bias gradients."""
    return _Disc.apply("full", None, x, *ws, *bs)


def disc_forward_frozen(x, ws, bs):
    """Logits whose backward reaches the input only: the weights and
    biases get no gradient (their ``.grad`` stays as it was)."""
    return _Disc.apply("frozen", None, x, *ws, *bs)


def disc_forward_detached(x, ws, bs):
    """Logits whose backward gives the weight and bias gradients only: the
    input gets none (it must need none, as one-hot labels or detached
    predictions do)."""
    return _Disc.apply("detached", None, x, *ws, *bs)


def disc_with_known_logits(x, logits, ws, bs):
    """``logits`` (a copy), already computed from the same ``x`` with the
    same weights, whose backward is the weight-and-bias-gradient pass from
    ``x``: no forward runs. Exact only while the weights are those that
    made ``logits``."""
    return _Disc.apply("known", logits, x, *ws, *bs)
