"""The numerics of the discriminator's tensor-core passes
(``csrc/disc_tc.cu``: ``disc_bwd_dw``, ``disc_bwd`` with dx, the dx-only
``disc_bwd_dx`` and the forward ``disc_fwd``), emulated in plain PyTorch
on the CPU.

The card's kernels cannot run here; their arithmetic can. The row pass
recomputes ``h1..h4 = leaky(h W^T + b)``, forms ``dz4 = g w5 leaky'(h4)``
and runs the chain ``dh = dz W``, ``dz = dh leaky'(h)`` down to dz1 (and
``dx = dz1 W1``; the dx-only pass is the same chain without the dW
products, so the same dx); the forward computes the same h1..h4 and
folds ``h4 w5`` into the logit with one fp32 FMA a term (bf16 operands
under mixed precision); every product is 3xTF32 in fp32 (``mm_3xtf32`` of
``tests/test_torch_gemm_numerics.py``: per 8-deep k step ``a_lo b_hi +
a_hi b_lo + a_hi b_hi`` added to an fp32 accumulator; dh3's accumulator
runs on across the layer-4 chunks, which is one product over the whole
depth in the same order) and bf16 operands with fp32 sums under the
mixed-precision scope. ``dW5`` and db1..db4 are fp32 column sums of each
64-row tile (the unrounded cotangents) added in float64, db5 a float64
sum of g;
``dW1..dW4 = dz^T h`` run on the GEMM core, split over row ranges whose
partials add in float64.

Held at the path's widths (k = 50 -> 64 -> 128 -> 256 -> 512 -> 1) on 2
clouds of a ragged N = 300 (no 64-row tile divides it): fp32 within
``BOUND`` (1e-4 scale-relative) of float64 (every product and sum in
float64, LeakyReLU's branches taken from the fp32 pass, whose sign a
pre-activation within rounding of zero may flip), of the port's plain
twins and of the JAX package's ``_bwd_dw_call`` / ``_bwd_call`` /
``_bwd_dx_call`` / ``_fwd_call`` (HIGHEST precision, Pallas in interpret
mode as its own tests run it); bf16 within ``BF16_BOUND`` of the JAX
kernels under their mixed-precision scope. The
control: one TF32 product instead of three misses ``BOUND``. These tests
document the contract the kernel is built to and run no kernel;
``chip_smoke.py`` holds the kernel on the card to its plain twin from x
(with the kernel's LeakyReLU branch at each pre-activation within
rounding of zero where the two differ) and, product by product, to
float64.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import core as jax_core
from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    disc_fused as jax_disc,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    disc_fused,
)
from tests.test_torch_gemm_numerics import mm_3xtf32

BOUND = 1e-4
BF16_BOUND = 1e-3      # chip_smoke.py's bound for a bf16 pass's fp32 outputs
BSZ, N, K = 2, 300, 50  # ragged: no tile of 64 rows divides 600
TILE = 64              # rows a block of the row pass (csrc/disc_tc.cu)
ROWS_PER_SPLIT = 256   # the dW products' row ranges (ops/launch.py)
SLOPE = 0.2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _mm(a, b, prec):
    """``a @ b`` as the kernel computes it: ``3xtf32``, ``tf32`` (one
    product, the control), ``bf16`` (bf16 operands, fp32 sums) or
    ``f64``."""
    if prec == "f64":
        return a.double() @ b.double()
    if prec == "bf16":
        return _bf(a) @ _bf(b)
    return mm_3xtf32(a.contiguous(), b.contiguous(),
                     terms=3 if prec == "3xtf32" else 1)


def _leaky(z):
    return torch.where(z >= 0, z, SLOPE * z)


def _dleaky(h):
    return torch.where(h >= 0, 1.0, SLOPE).to(h.dtype)


def _tile_sums(t, prec):
    """Column sums of ``[M, C]``: fp32 sums of each 64-row tile added in
    float64 (the row pass's partials and ``colsum``)."""
    if prec == "f64":
        return t.double().sum(0)
    return sum(t[r:r + TILE].sum(0).double()
               for r in range(0, t.shape[0], TILE))


def _dw(dz, h, prec):
    """``h^T dz`` (``[in, out]``) over row ranges, the ranges' partials
    added in float64 (``split_sum``)."""
    if prec == "f64":
        return h.double().t() @ dz.double()
    out = sum(_mm(dz[r:r + ROWS_PER_SPLIT].t(), h[r:r + ROWS_PER_SPLIT],
                  prec).double()
              for r in range(0, dz.shape[0], ROWS_PER_SPLIT))
    return out.t()


def disc_emulated(x, g, ws, bs, prec, branches=None):
    """``(dx, dws, dbs)`` as ``disc_tc.cu`` computes them (``dws``
    ``[in, out]``); with ``prec="f64"`` the float64 control, LeakyReLU's
    branches taken from ``branches`` (the fp32 pass's hidden
    activations). Returns the hidden activations too."""
    f = torch.float64 if prec == "f64" else torch.float32
    x, g = x.reshape(-1, x.shape[-1]).to(f), g.reshape(-1, 1).to(f)
    ws, bs = [w.to(f) for w in ws], [b.to(f) for b in bs]
    hs = [x]
    for w, b in zip(ws[:4], bs[:4]):
        hs.append(_leaky(_mm(hs[-1], w, prec).to(f) + b))
    signs = branches or hs
    bf = prec == "bf16"
    gv = _bf(g) if bf else g
    w5 = _bf(ws[4][:, 0]) if bf else ws[4][:, 0]
    dz = (gv * w5) * _dleaky(signs[4]).to(f)
    dw5 = _tile_sums((_bf(hs[4]) if bf else hs[4]) * gv, prec)[:, None]
    dws, dbs = [dw5], [g.double().sum(0)]   # db5: sum_g_kernel
    for i in (3, 2, 1, 0):
        dws.insert(0, _dw(dz, hs[i], prec))
        dbs.insert(0, _tile_sums(dz, prec))
        dh = _mm(dz, ws[i].t(), prec).to(f)
        dz = dh * _dleaky(signs[i]).to(f) if i else dh
    return dz, dws, dbs, hs


def fwd_emulated(x, ws, bs, prec):
    """The logits ``[B, N, 1]`` as the forward kernel computes them: h1..h4
    as ``disc_emulated``'s, then ``sum h4 w5`` in fp32 (bf16 operands
    under ``bf16``) plus b5; float64 throughout with ``prec="f64"``."""
    f = torch.float64 if prec == "f64" else torch.float32
    h = x.reshape(-1, x.shape[-1]).to(f)
    for w, b in zip(ws[:4], bs[:4]):
        h = _leaky(_mm(h, w.to(f), prec).to(f) + b.to(f))
    op = _bf if prec == "bf16" else (lambda t: t)
    logit = (op(h) * op(ws[4][:, 0].to(f))).sum(-1, keepdim=True)
    return (logit + bs[4].to(f)).reshape(*x.shape[:2], 1)


def _rel(a, b) -> float:
    a = np.asarray(a.detach().double() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach().double() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


@functools.lru_cache(maxsize=None)
def _args():
    """Probability maps with every fifth row one-hot (the D step's
    reals), the logits' cotangent, and the stack's weights ``[in, out]``
    at PyTorch's default bounds."""
    rng = np.random.default_rng(9)
    f = np.float32
    z = rng.normal(0, 3, (BSZ, N, K))
    x = np.exp(z - z.max(-1, keepdims=True))
    x /= x.sum(-1, keepdims=True)
    x[:, ::5] = np.eye(K)[rng.integers(0, K, (BSZ, len(range(0, N, 5))))]
    g = rng.normal(size=(BSZ, N, 1))
    ws, bs, c = [], [], K
    for o in disc_fused.WIDTHS:
        ws.append(rng.uniform(-1, 1, (c, o)) / np.sqrt(c))
        bs.append(rng.uniform(-1, 1, o) / np.sqrt(c))
        c = o
    return (x.astype(f), g.astype(f), tuple(w.astype(f) for w in ws),
            tuple(b.astype(f) for b in bs))


def _torch_args():
    x, g, ws, bs = _args()
    return (torch.from_numpy(x), torch.from_numpy(g),
            [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs])


@functools.lru_cache(maxsize=None)
def _jax(pas, bf16=False):
    """The JAX package's kernel of the pass ``pas``: ``_bwd_call``
    (``bwd``), ``_bwd_dw_call``, ``_bwd_dx_call`` or ``_fwd_call``;
    ``(dx or logits or None, dws, dbs)`` as numpy (the last two empty
    for ``fwd`` and ``bwd_dx``)."""
    x, g, ws, bs = _args()
    call = {"bwd": jax_disc._bwd_call, "bwd_dw": jax_disc._bwd_dw_call,
            "bwd_dx": jax_disc._bwd_dx_call, "fwd": jax_disc._fwd_call}[pas]
    operands = ((jnp.asarray(x),) + (() if pas == "fwd" else
                                      (jnp.asarray(g),))
                + ([jnp.asarray(w) for w in ws],
                   [jnp.asarray(b) for b in bs]))
    if bf16:
        with jax_core.mixed_precision():
            out = call(*operands)
    else:
        out = call(*operands)
    dx, dws, dbs = {"bwd": lambda: out, "bwd_dw": lambda: (None, *out)}.get(
        pas, lambda: (out, [], []))()
    return (None if dx is None else np.asarray(dx, np.float32),
            [np.asarray(w, np.float32) for w in dws],
            [np.asarray(b, np.float32).reshape(-1) for b in dbs])


NAMES = [f"dw{i}" for i in range(1, 6)] + [f"db{i}" for i in range(1, 6)]


PASSES = ["bwd_dw", "bwd", "fwd", "bwd_dx"]


def _plain(pas, x, g, ws, bs, bf16=False):
    """The port's plain twin of ``pas``: ``(dx or logits or None, dws,
    dbs)``."""
    if pas == "fwd":
        return disc_fused.disc_fwd_plain(x, ws, bs, bf16), [], []
    if pas == "bwd_dx":
        return disc_fused.disc_bwd_dx_plain(x, g, ws, bs, bf16), [], []
    if pas == "bwd":
        return disc_fused.disc_bwd_plain(x, g, ws, bs, bf16)
    return (None, *disc_fused.disc_bwd_dw_plain(x, g, ws, bs, bf16))


@functools.lru_cache(maxsize=None)
def _backward_emulated(prec):
    """``disc_emulated`` on ``_args()`` at ``prec``, made once for the
    module (the three backward passes share it); float64 takes the
    3xTF32 pass's LeakyReLU branches."""
    x, g, ws, bs = _torch_args()
    branches = _backward_emulated("3xtf32")[3] if prec == "f64" else None
    return disc_emulated(x, g, ws, bs, prec, branches)


def _emulated(pas, x, g, ws, bs, prec, branches=None):
    """The kernel's ``(dx or logits or None, dws, dbs)`` for ``pas``, and
    the hidden activations (the float64 control's LeakyReLU branches: on
    ``_args()`` those of the 3xTF32 pass, ``_backward_emulated``)."""
    if pas == "fwd":
        return fwd_emulated(x, ws, bs, prec), [], [], None
    dx, dws, dbs, hs = _backward_emulated(prec)
    dx = dx.reshape(x.shape)
    if pas == "bwd_dx":
        return dx, [], [], hs
    return (dx if pas == "bwd" else None), dws, dbs, hs


@pytest.mark.parametrize("pas", PASSES)
def test_3xtf32_matches_float64_plain_and_jax(pas):
    """fp32: every weight and bias gradient, dx where the pass gives it,
    and the forward's logits within ``BOUND`` of float64, of the plain
    twin and of the JAX kernel."""
    x, g, ws, bs = _torch_args()
    out, dws, dbs, hs = _emulated(pas, x, g, ws, bs, "3xtf32")
    rout, rws, rbs, _ = _emulated(pas, x, g, ws, bs, "f64")
    pout, pws, pbs = _plain(pas, x, g, ws, bs)
    jout, jws, jbs = _jax(pas)
    assert len(dws) == (5 if pas.startswith("bwd") and pas != "bwd_dx"
                        else 0)
    for nm, e, r, p, j in zip(NAMES, dws + dbs, rws + rbs, list(pws) +
                              list(pbs), jws + jbs):
        assert _rel(e, r) <= BOUND, (nm, _rel(e, r))
        assert _rel(e, p) <= BOUND, (nm, _rel(e, p))
        assert _rel(e, j) <= BOUND, (nm, _rel(e, j))
    assert (out is None) == (pas == "bwd_dw")
    if out is not None:
        assert _rel(out, rout) <= BOUND
        assert _rel(out, pout) <= BOUND
        assert _rel(out, jout) <= BOUND


@pytest.mark.parametrize("pas", PASSES)
def test_bf16_matches_jax_mixed_precision(pas):
    """bf16 operands at the places the JAX kernel's ``_mxu_dot`` and
    ``_mxu_dot_t`` cast, fp32 sums, the bias gradients from the unrounded
    cotangents: within ``BF16_BOUND`` of it and of the port's bf16 plain
    twin; and the rounding did happen (fp32 lands elsewhere)."""
    x, g, ws, bs = _torch_args()
    out, dws, dbs, _ = _emulated(pas, x, g, ws, bs, "bf16")
    fout, fws, _, _ = _emulated(pas, x, g, ws, bs, "3xtf32")
    pout, pws, pbs = _plain(pas, x, g, ws, bs, bf16=True)
    jout, jws, jbs = _jax(pas, bf16=True)
    for nm, e, p, j in zip(NAMES, dws + dbs, list(pws) + list(pbs),
                           jws + jbs):
        assert _rel(e, j) <= BF16_BOUND, (nm, _rel(e, j))
        assert _rel(e, p) <= BF16_BOUND, (nm, _rel(e, p))
    if out is not None:
        assert _rel(out, jout) <= BF16_BOUND
        assert _rel(out, pout) <= BF16_BOUND
    if dws:
        assert max(_rel(e, f) for e, f in zip(dws, fws)) > 10 * BOUND
    else:   # the logits or dx alone, at their own scale (below 1)
        assert ((out - fout).abs().max() / fout.abs().max()).item() \
            > 10 * BOUND


def test_one_tf32_product_misses_the_bound():
    """Control: with one TF32 product (no ``lo``) in place of three the
    emulation misses ``BOUND`` of float64 on the weight gradients, which
    3xTF32 meets (the tests above)."""
    x, g, ws, bs = _torch_args()
    _, dws, _, hs = disc_emulated(x, g, ws, bs, "tf32")
    _, rws, _, _ = disc_emulated(x, g, ws, bs, "f64", branches=hs)
    assert max(_rel(e, r) for e, r in zip(dws, rws)) > BOUND


def test_ragged_rows_add_nothing():
    """Rows past m in the last 64-row tile are zero in x with g = 0: the
    tile-by-tile sums equal those of the rows alone (no padding term)."""
    x, g, ws, bs = _torch_args()
    _, dws, dbs, _ = _backward_emulated("3xtf32")
    pad = lambda t: torch.cat(  # noqa: E731
        [t, torch.zeros(t.shape[0], 20, t.shape[-1])], 1)
    _, pws, pbs, _ = disc_emulated(pad(x), pad(g), ws, bs, "3xtf32")
    for nm, a, b in zip(NAMES, dws + dbs, pws + pbs):
        assert _rel(a, b) <= BOUND, nm
