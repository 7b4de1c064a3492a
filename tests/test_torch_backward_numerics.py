"""The numerics of the generator's tensor-core passes
(``csrc/train_bwd_tc.cu``: trunk F1, F2 and B1 and the seg head's Pmid,
B4, Bmid and B1), emulated in plain PyTorch on the CPU.

The card's kernels cannot run here; their arithmetic can. Trunk B1
recomputes ``h2 = relu(bn2(z2))`` in fp32 (the ReLU mask every pass
takes), then chunk by chunk of c3 ``z3 = h2 W3^T + b3`` (GEMM 1), ``dz3``
in fp32 and ``dy2 += dz3 W3`` (GEMM 2); Bmid builds ``dz`` elementwise
and takes ``dyp = dz W``; both write ``dz`` and ``h`` for ``dW = dz^T h``
on the GEMM core, split over row ranges whose partials add in float64.
In fp32 every product is 3xTF32 (``mm_3xtf32`` of
``tests/test_torch_gemm_numerics.py``: per 8-deep k step ``a_lo b_hi +
a_hi b_lo + a_hi b_hi`` added to an fp32 accumulator; GEMM 2's
accumulator runs on across the chunks, which is one product over the
whole depth in the same order), in bf16 the operands are rounded to bf16
and summed in fp32. Sums (db, t1, t2) are fp32 values added in float64.

F2 shares B1's prologue and first GEMM: the same h2 and 3xTF32 z3 = h2 W3^T
+ b3, reduced per 128-point tile of one cloud to fp32 column sums and sums
of squares (added per group in float64) and to each cloud's max and min
with the first point attaining them. Pmid is F2 at any width without the
extrema: h = relu(bn(x)) in fp32 (bn_affine's roundings), z = h W^T + b
by 32-deep chunks of c_in (the accumulator runs on across them: one
product), z's column sums per 128-point tile. The seg head's B1 is Bmid
without the previous BN: dz by 64-channel chunks (elementwise, so the
chunks change nothing), dpf = dz W1a^T unmasked in fp32, dW1a = dz^T pf
by row splits, db and each cloud's r from per-tile fp32 sums added in
float64. Trunk F1 is z = x W^T + b with its column sums per 128-point
tile (fp32, added per group in float64); at c_in <= 4 (trunk3_train's
raw points) the product is plain fp32, as the kernel's FMAs are. B4
recomputes z4 = h3 W4^T + b4, takes dz = dlp - softmax(z4) sum(dlp) in
fp32, dy3 = dz W4 masked by h3 > 0, and dW4 = h3^T dz, db, t1 and t2 from
per-tile fp32 sums added in float64 (the kernel adds a block's tiles in
one fp32 accumulator before float64: another order of the same sums).
The seg head's P1 is F1 with a per-cloud addend, z1 = (pf W1a^T +
g_row[cloud]) + b1, the JAX kernel's order, with z1's column sums per
128-point tile; P4 is B4's first half (the same z4 = h3 W4^T + b4,
``_z4``), then logp = z4 - (log(sum exp(z4 - m)) + m) in fp32.

Held at narrow widths (B1 c_in 32, c_out 256; F2 128 -> 256; Bmid 64 ->
128 and 128 -> 64; Pmid 128 -> 64 and 64 -> 128; the head's B1 128 -> 32
and 64 -> 3; F1 16 -> 32 and 3 -> 16; B4 32 -> 50 and 32 -> 13, an odd
k that pads; P1 16 -> 256, two of the kernel's 128-column slices, and 64
-> 128; P4 32 -> 50 and 32 -> 13), a ragged N = 300, groups 1 and 2:
fp32 within ``BOUND``
(1e-4 scale-relative) of float64, of the port's plain twins and of the
JAX package's ``_b1_call`` / ``_f1_call`` / ``_f2_call`` / ``_pmid_call``
/ ``_b4_call`` / ``_bmid_call`` / ``_p1_call`` / ``_p4_call`` and the seg
head's ``_b1_call``
(HIGHEST precision,
Pallas in interpret mode as its own tests run it);
bf16 within ``BF16_BOUND`` of the JAX kernels under their
mixed-precision scope. The control: one TF32 product instead of three
misses ``BOUND`` (P4 on its logits z4 as on logp). These tests document the contract the kernels are built
to and run no kernel; ``chip_smoke.py`` holds the kernels to their plain
twins and to float64 on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import core as jax_core
from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    seg_head_train as jax_head,
    trunk_train as jax_trunk,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    seg_head_train, trunk_train,
)
from tests.test_torch_gemm_numerics import mm_3xtf32

BOUND = 1e-4
BF16_BOUND = 1e-3      # chip_smoke.py's bound for a bf16 pass's fp32 outputs
N = 300                # ragged: no tile of 128 divides it
ROWS_PER_SPLIT = 256   # the dW product's row ranges (ops/launch.py: row_splits)
B1_WIDTHS = (32, 256)  # (c_in, c_out)
BMID_WIDTHS = ((64, 128), (128, 64))   # (c_out, c_in): dz width -> dyp width
F2_WIDTHS = (128, 256)                 # (c2, c3)
PMID_WIDTHS = ((128, 64), (64, 128))   # (c_in, c_out)
HEAD_B1_WIDTHS = ((128, 32), (64, 3))  # (c_out, c_in): dz width -> dpf width
F1_WIDTHS = ((16, 32), (3, 16))        # (c_in, c2); depth 3 as plain fp32
B4_C3, B4_PARTS = 32, (50, 13)         # B4 and P4: c3, k (13 pads to 16)
P1_WIDTHS = ((16, 256), (64, 128))     # (c_in, c1); 256: two column slices
TC_TILE = 128          # points a tile of F1, F2, Pmid, B4, the head's B1
                       # (kTcRows in csrc/train_bwd_tc.cu)


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
    """``a @ b`` as the kernels compute it: ``3xtf32``, ``tf32`` (one
    product, the control), ``bf16`` (bf16 operands, fp32 sums) or ``f64``."""
    if prec == "f64":
        return a.double() @ b.double()
    if prec == "bf16":
        return _bf(a) @ _bf(b)
    return mm_3xtf32(a, b, terms=3 if prec == "3xtf32" else 1)


def _dw(dz, h, prec):
    """``dz^T h`` over row ranges, the ranges' partials added in float64
    (``split_sum``), as ``[c_in, c_out]``."""
    parts = [_mm(dz[r:r + ROWS_PER_SPLIT].t(), h[r:r + ROWS_PER_SPLIT],
                 prec).double()
             for r in range(0, dz.shape[0], ROWS_PER_SPLIT)]
    out = sum(parts)
    return (out if prec == "f64" else out.float()).t()


def _sums(t, groups):
    """Per-group column sums of ``[B, N, C]`` in float64 (``[C]`` for one
    group)."""
    s = t.double().reshape(groups, -1, t.shape[-1]).sum(1)
    return s[0] if groups == 1 else s


def _f(t, prec):
    return t.double() if prec == "f64" else t


def b1_emulated(args, groups, prec):
    """Trunk B1 as ``train_bwd_tc.cu`` computes it: ``(dy2, dw3, db3, t1,
    t2)``; ``prec="f64"`` is the float64 control (h2 and its mask from
    fp32, everything after in float64)."""
    z2, sc2, sh2, w3, b3, mu3, inv3, coef1, coef2, s3dg, idx, mu2, inv2 = args
    bsz, n, c2 = z2.shape
    c3 = w3.shape[1]

    def cloud(v):            # [C] or [G, C] statistic -> [B, 1, C]
        return _f(v, prec).reshape(groups, -1).repeat_interleave(
            bsz // groups, 0)[:, None, :]

    h2 = torch.relu(z2 * cloud(sc2).float() + cloud(sh2).float())
    mask = h2 > 0
    h2 = _f(h2, prec)
    z3 = _mm(h2.reshape(-1, c2), w3, prec).reshape(bsz, n, c3) + _f(b3, prec)
    zhat3 = (z3 - cloud(mu3)) * cloud(inv3)
    points = torch.arange(n)[None, :, None]
    sparse = torch.where(points == idx[:, None, :],
                         _f(s3dg, prec)[:, None, :], _f(torch.zeros(()), prec))
    dz3 = sparse - _f(coef1, prec)[:, None, :] - zhat3 * _f(coef2,
                                                           prec)[:, None, :]
    dy2 = _mm(dz3.reshape(-1, c3), w3.t(), prec).reshape(bsz, n, c2) * mask
    zhat2 = (_f(z2, prec) - cloud(mu2)) * cloud(inv2)
    return (dy2, _dw(dz3.reshape(-1, c3), h2.reshape(-1, c2), prec),
            dz3.double().sum((0, 1)), _sums(dy2, groups),
            _sums(dy2 * zhat2, groups))


def bmid_emulated(args, prec):
    """Bmid as ``train_bwd_tc.cu`` computes it: ``(dyp, dw, db, t1, t2)``
    (``dyp`` before its bf16 stash)."""
    zc, dy, sc, mu, inv, c1, c2, zp, scp, shp, w, mup, invp = args
    c_out, c_in = w.shape[1], w.shape[0]
    hp = torch.relu(zp * scp + shp)
    mask = hp > 0
    zc, dy, sc, mu, inv, c1, c2, zp, hp, mup, invp = (
        _f(t, prec) for t in (zc, dy, sc, mu, inv, c1, c2, zp, hp, mup, invp))
    dz = dy * sc - c1 - ((zc - mu) * inv) * c2
    dyp = _mm(dz.reshape(-1, c_out), w.t(), prec).reshape(hp.shape) * mask
    return (dyp, _dw(dz.reshape(-1, c_out), hp.reshape(-1, c_in), prec),
            dz.double().sum((0, 1)), _sums(dyp, 1),
            _sums(dyp * ((zp - mup) * invp), 1))


def f2_emulated(args, groups, prec):
    """Trunk F2 as ``train_bwd_tc.cu`` computes it: ``(sum, sumsq, max,
    min, argmax, argmin)``; ``prec="f64"`` is the float64 control (h2 from
    fp32, the product and the sums in float64)."""
    z2, sc2, sh2, w3, b3 = args
    bsz, n, c2 = z2.shape
    c3 = w3.shape[1]
    bpg = bsz // groups

    def cloud(v):            # [C] or [G, C] statistic -> [B, 1, C]
        return v.reshape(groups, -1).repeat_interleave(bpg, 0)[:, None, :]

    h2 = _f(torch.relu(z2.float() * cloud(sc2) + cloud(sh2)), prec)
    z3 = _mm(h2.reshape(-1, c2), w3, prec).reshape(bsz, n, c3) + _f(b3, prec)
    if prec == "f64":
        s, ss = (t.reshape(groups, -1, c3).sum(1) for t in (z3, z3 * z3))
    else:   # fp32 sums of each tile of TC_TILE points, added in float64
        s, ss = (sum(t[:, p:p + TC_TILE].sum(1).double()
                     for p in range(0, n, TC_TILE)).reshape(
                         groups, bpg, c3).sum(1) for t in (z3, z3 * z3))
    mx, mn = z3.max(1).values, z3.min(1).values
    first = lambda hit: hit.int().argmax(1).int()  # noqa: E731
    return (s[0] if groups == 1 else s, ss[0] if groups == 1 else ss, mx,
            mn, first(z3 == mx[:, None]), first(z3 == mn[:, None]))


def _tile_sums(t, prec):
    """Each cloud's column sums of ``[B, N, C]``: fp32 sums of each tile
    of ``TC_TILE`` points added in float64 (float64 throughout for
    ``f64``)."""
    if prec == "f64":
        return t.double().sum(1)
    return sum(t[:, p:p + TC_TILE].sum(1).double()
               for p in range(0, t.shape[1], TC_TILE))


def pmid_emulated(args, prec):
    """Pmid as ``train_bwd_tc.cu`` computes it: ``(z, sum, sumsq)``, ``z``
    before its stash; ``prec="f64"`` is the float64 control (h from fp32,
    the product and the sums in float64)."""
    z_prev, sc, sh, w, b = args
    bsz, n, c_in = z_prev.shape
    h = _f(torch.relu(z_prev.float() * sc + sh), prec)
    z = _mm(h.reshape(-1, c_in), w, prec).reshape(bsz, n, -1) + _f(b, prec)
    return z, _tile_sums(z, prec).sum(0), _tile_sums(z * z, prec).sum(0)


def head_b1_emulated(args, prec):
    """The seg head's B1 as ``train_bwd_tc.cu`` computes it: ``(dpf, dw1a,
    db1, r)``."""
    z1, dy1, sc1, mu1, inv1, c1, c2, pf, w1a = args
    bsz, n, c_out = z1.shape
    c_in = w1a.shape[0]
    z1, dy1, sc1, mu1, inv1, c1, c2, pf = (
        _f(t, prec) for t in (z1, dy1, sc1, mu1, inv1, c1, c2, pf))
    dz = dy1 * sc1 - c1 - ((z1 - mu1) * inv1) * c2
    dpf = _mm(dz.reshape(-1, c_out), w1a.t(), prec).reshape(bsz, n, c_in)
    r = _tile_sums(dz, prec)
    return (dpf, _dw(dz.reshape(-1, c_out), pf.reshape(-1, c_in), prec),
            r.sum(0), r)


def f1_emulated(args, groups, prec):
    """Trunk F1 as ``train_bwd_tc.cu`` computes it: ``(z2, sum, sumsq)``,
    ``z2`` before its stash; the sums per group (``[C]`` for one group).
    At c_in <= 4 the kernel's product is fp32 FMAs: plain fp32 here."""
    x, w2, b2 = args
    bsz, n, c_in = x.shape
    if prec == "3xtf32" and c_in <= 4:
        z = x @ w2 + b2
    else:
        z = _mm(x.reshape(-1, c_in), w2, prec).reshape(bsz, n, -1) + _f(
            b2, prec)
    s, ss = (_tile_sums(t, prec).reshape(groups, -1, z.shape[-1]).sum(1)
             for t in (z, z * z))
    return (z, s[0] if groups == 1 else s, ss[0] if groups == 1 else ss)


def _tile_dw(h, dz, prec):
    """``h^T dz`` of ``[B, N, C]`` operands as per-tile products of
    ``TC_TILE`` points added in float64, ``[c_h, c_dz]``."""
    out = sum(_mm(h[b, p:p + TC_TILE].t(), dz[b, p:p + TC_TILE],
                  prec).double()
              for b in range(h.shape[0]) for p in range(0, h.shape[1],
                                                        TC_TILE))
    return out if prec == "f64" else out.float()


def p1_emulated(args, prec):
    """The seg head's P1 as ``train_bwd_tc.cu`` computes it: ``(z1, sum,
    sumsq)``, ``z1`` before its stash: ``(pf W1a^T + g_row[cloud]) +
    b1``."""
    pf, g_row, w1a, b1 = args
    bsz, n, c_in = pf.shape
    z = (_mm(pf.reshape(-1, c_in), w1a, prec).reshape(bsz, n, -1)
         + _f(g_row, prec)[:, None, :]) + _f(b1, prec)
    return z, _tile_sums(z, prec).sum(0), _tile_sums(z * z, prec).sum(0)


def _z4(z3, sc3, sh3, w4, b4, prec):
    """B4's and P4's shared first half (``z4_softmax``): ``(h3, its ReLU
    mask, z4 = h3 W4^T + b4)``, h3 and the mask from fp32."""
    bsz, n, c3 = z3.shape
    h3 = torch.relu(z3.float() * sc3 + sh3)
    mask = h3 > 0
    h3 = _f(h3, prec)
    z4 = _mm(h3.reshape(-1, c3), w4, prec).reshape(bsz, n, -1) + _f(b4, prec)
    return h3, mask, z4


def p4_emulated(args, prec):
    """The seg head's P4 as ``train_bwd_tc.cu`` computes it: ``(logp,
    z4)``, logp = z4 - (log(sum exp(z4 - m)) + m) and the logits it came
    from (``prec="f64"``: the float64 control)."""
    z4 = _z4(*args, prec)[2]
    m = z4.max(-1, keepdim=True).values
    lse = torch.log(torch.exp(z4 - m).sum(-1, keepdim=True)) + m
    return z4 - lse, z4


def b4_emulated(args, prec):
    """The seg head's B4 as ``train_bwd_tc.cu`` computes it: ``(dy3, dw4,
    db4, t1, t2)``, ``dy3`` before its stash; ``prec="f64"`` is the float64
    control (h3 and its mask from fp32, everything after in float64)."""
    z3, sc3, sh3, w4, b4, mu3, inv3, dlp = args
    bsz, n, c3 = z3.shape
    h3, mask, z4 = _z4(z3, sc3, sh3, w4, b4, prec)
    e = torch.exp(z4 - z4.max(-1, keepdim=True).values)
    dl = _f(dlp, prec)
    dz = dl - (e / e.sum(-1, keepdim=True)) * dl.sum(-1, keepdim=True)
    dy3 = _mm(dz.reshape(-1, dz.shape[-1]), w4.t(), prec).reshape(
        bsz, n, c3) * mask
    zhat = (_f(z3, prec) - _f(mu3, prec)) * _f(inv3, prec)
    return (dy3, _tile_dw(h3, dz, prec), _tile_sums(dz, prec).sum(0),
            _tile_sums(dy3, prec).sum(0), _tile_sums(dy3 * zhat, prec).sum(0))


def _rel(a, b) -> float:
    a = np.asarray(a.detach().double() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach().double() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _stash(a: np.ndarray) -> np.ndarray:
    """Values a bf16 stash holds (the same on both sides)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _b1_args(groups, bf16=False):
    c2, c3 = B1_WIDTHS
    bsz = 2 * groups
    rng = np.random.default_rng(10 * groups + bf16)
    f = np.float32
    stat = (c2,) if groups == 1 else (groups, c2)
    stat3 = (c3,) if groups == 1 else (groups, c3)
    z2 = rng.standard_normal((bsz, N, c2)).astype(f)
    return ((_stash(z2) if bf16 else z2),
            rng.uniform(0.5, 1.5, stat).astype(f),
            (rng.standard_normal(stat) * 0.1).astype(f),
            (rng.uniform(-1, 1, (c2, c3)) / np.sqrt(c2)).astype(f),
            (rng.standard_normal(c3) * 0.1).astype(f),
            (rng.standard_normal(stat3) * 0.1).astype(f),
            rng.uniform(0.5, 1.5, stat3).astype(f),
            (rng.standard_normal((bsz, c3)) * 1e-3).astype(f),
            (rng.standard_normal((bsz, c3)) * 1e-3).astype(f),
            rng.standard_normal((bsz, c3)).astype(f),
            rng.integers(0, N, (bsz, c3)).astype(np.int32),
            (rng.standard_normal(stat) * 0.1).astype(f),
            rng.uniform(0.5, 1.5, stat).astype(f))


@functools.lru_cache(maxsize=None)
def _bmid_args(c_out, c_in, bf16=False):
    rng = np.random.default_rng(c_out * 1000 + c_in + bf16)
    f = np.float32

    def stash(*shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(f)
        return _stash(a) if bf16 else a

    return (stash(2, N, c_out), stash(2, N, c_out, scale=0.2),
            rng.uniform(0.5, 1.5, c_out).astype(f),
            (rng.standard_normal(c_out) * 0.1).astype(f),
            rng.uniform(0.5, 1.5, c_out).astype(f),
            (rng.standard_normal(c_out) * 1e-2).astype(f),
            (rng.standard_normal(c_out) * 1e-2).astype(f),
            stash(2, N, c_in),
            rng.uniform(0.5, 1.5, c_in).astype(f),
            (rng.standard_normal(c_in) * 0.1).astype(f),
            (rng.uniform(-1, 1, (c_in, c_out)) / np.sqrt(c_in)).astype(f),
            (rng.standard_normal(c_in) * 0.1).astype(f),
            rng.uniform(0.5, 1.5, c_in).astype(f))


@functools.lru_cache(maxsize=None)
def _f2_args(groups, bf16=False):
    """F2's inputs; cloud 0 repeats its first 150 points in its last 150,
    so each of its extrema is attained twice."""
    c2, c3 = F2_WIDTHS
    bsz = 2 * groups
    rng = np.random.default_rng(20 * groups + bf16)
    f = np.float32
    stat = (c2,) if groups == 1 else (groups, c2)
    z2 = rng.standard_normal((bsz, N, c2)).astype(f)
    z2[0, N // 2:] = z2[0, :N // 2]
    return ((_stash(z2) if bf16 else z2),
            rng.uniform(0.5, 1.5, stat).astype(f),
            (rng.standard_normal(stat) * 0.1).astype(f),
            (rng.uniform(-1, 1, (c2, c3)) / np.sqrt(c2)).astype(f),
            (rng.standard_normal(c3) * 0.1).astype(f))


@functools.lru_cache(maxsize=None)
def _pmid_args(c_in, c_out, bf16=False):
    rng = np.random.default_rng(c_in * 1000 + c_out + 30 + bf16)
    f = np.float32
    z = rng.standard_normal((2, N, c_in)).astype(f)
    return ((_stash(z) if bf16 else z),
            rng.uniform(0.5, 1.5, c_in).astype(f),
            (rng.standard_normal(c_in) * 0.1).astype(f),
            (rng.uniform(-1, 1, (c_in, c_out)) / np.sqrt(c_in)).astype(f),
            (rng.standard_normal(c_out) * 0.1).astype(f))


@functools.lru_cache(maxsize=None)
def _head_b1_args(c_out, c_in, bf16=False):
    rng = np.random.default_rng(c_out * 1000 + c_in + 40 + bf16)
    f = np.float32

    def stash(*shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(f)
        return _stash(a) if bf16 else a

    return (stash(2, N, c_out), stash(2, N, c_out, scale=0.2),
            rng.uniform(0.5, 1.5, c_out).astype(f),
            (rng.standard_normal(c_out) * 0.1).astype(f),
            rng.uniform(0.5, 1.5, c_out).astype(f),
            (rng.standard_normal(c_out) * 1e-2).astype(f),
            (rng.standard_normal(c_out) * 1e-2).astype(f),
            np.maximum(rng.standard_normal((2, N, c_in)), 0).astype(f),
            (rng.uniform(-1, 1, (c_in, c_out)) / np.sqrt(c_out)).astype(f))


@functools.lru_cache(maxsize=None)
def _f1_args(c_in, c2, groups):
    rng = np.random.default_rng(c_in * 1000 + c2 + 50 + groups)
    f = np.float32
    return (np.maximum(rng.standard_normal((2 * groups, N, c_in)), 0).astype(f),
            (rng.uniform(-1, 1, (c_in, c2)) / np.sqrt(c_in)).astype(f),
            (rng.standard_normal(c2) * 0.1).astype(f))


@functools.lru_cache(maxsize=None)
def _b4_args(k, bf16=False):
    rng = np.random.default_rng(k * 1000 + 60 + bf16)
    f = np.float32
    z3 = rng.standard_normal((2, N, B4_C3)).astype(f)
    return ((_stash(z3) if bf16 else z3),
            rng.uniform(0.5, 1.5, B4_C3).astype(f),
            (rng.standard_normal(B4_C3) * 0.1).astype(f),
            (rng.uniform(-1, 1, (B4_C3, k)) / np.sqrt(B4_C3)).astype(f),
            (rng.standard_normal(k) * 0.1).astype(f),
            (rng.standard_normal(B4_C3) * 0.1).astype(f),
            rng.uniform(0.5, 1.5, B4_C3).astype(f),
            rng.standard_normal((2, N, k)).astype(f))


@functools.lru_cache(maxsize=None)
def _p1_args(c_in, c1):
    rng = np.random.default_rng(c_in * 1000 + c1 + 70)
    f = np.float32
    return (np.maximum(rng.standard_normal((2, N, c_in)), 0).astype(f),
            (rng.standard_normal((2, c1)) * 0.5).astype(f),
            (rng.uniform(-1, 1, (c_in, c1)) / np.sqrt(c_in)).astype(f),
            (rng.standard_normal(c1) * 0.1).astype(f))


def _torch(args):
    return tuple(torch.from_numpy(a) for a in args)


@functools.lru_cache(maxsize=None)
def _jax_b1(groups, bf16=False):
    args = [jnp.asarray(a) for a in _b1_args(groups, bf16)]
    if bf16:
        args[0] = args[0].astype(jnp.bfloat16)
        with jax_core.mixed_precision():
            return jax_trunk._b1_call(*args, groups=groups)
    return jax_trunk._b1_call(*args, groups=groups)


@functools.lru_cache(maxsize=None)
def _jax_bmid(c_out, c_in, bf16=False):
    args = [jnp.asarray(a) for a in _bmid_args(c_out, c_in, bf16)]
    if bf16:
        for i in (0, 1, 7):
            args[i] = args[i].astype(jnp.bfloat16)
        with jax_core.mixed_precision():
            return jax_head._bmid_call(*args)
    return jax_head._bmid_call(*args)


@functools.lru_cache(maxsize=None)
def _jax_f2(groups, bf16=False):
    args = [jnp.asarray(a) for a in _f2_args(groups, bf16)]
    if bf16:
        args[0] = args[0].astype(jnp.bfloat16)
        with jax_core.mixed_precision():
            return jax_trunk._f2_call(*args, groups=groups)
    return jax_trunk._f2_call(*args, groups=groups)


@functools.lru_cache(maxsize=None)
def _jax_pmid(c_in, c_out, bf16=False):
    args = [jnp.asarray(a) for a in _pmid_args(c_in, c_out, bf16)]
    if bf16:
        args[0] = args[0].astype(jnp.bfloat16)
        with jax_core.mixed_precision():
            return jax_head._pmid_call(*args)
    return jax_head._pmid_call(*args)


@functools.lru_cache(maxsize=None)
def _jax_head_b1(c_out, c_in, bf16=False):
    args = [jnp.asarray(a) for a in _head_b1_args(c_out, c_in, bf16)]
    if bf16:
        for i in (0, 1):
            args[i] = args[i].astype(jnp.bfloat16)
        with jax_core.mixed_precision():
            return jax_head._b1_call(*args)
    return jax_head._b1_call(*args)


@functools.lru_cache(maxsize=None)
def _jax_f1(c_in, c2, groups, bf16=False):
    args = [jnp.asarray(a) for a in _f1_args(c_in, c2, groups)]
    if bf16:
        with jax_core.mixed_precision():
            return jax_trunk._f1_call(*args, groups=groups)
    return jax_trunk._f1_call(*args, groups=groups)


@functools.lru_cache(maxsize=None)
def _jax_b4(k, bf16=False):
    args = [jnp.asarray(a) for a in _b4_args(k, bf16)]
    if bf16:
        args[0] = args[0].astype(jnp.bfloat16)
        with jax_core.mixed_precision():
            return jax_head._b4_call(*args)
    return jax_head._b4_call(*args)


@functools.lru_cache(maxsize=None)
def _jax_p1(c_in, c1, bf16=False):
    args = [jnp.asarray(a) for a in _p1_args(c_in, c1)]
    if bf16:
        with jax_core.mixed_precision():
            return jax_head._p1_call(*args)
    return jax_head._p1_call(*args)


@functools.lru_cache(maxsize=None)
def _jax_p4(k, bf16=False):
    args = [jnp.asarray(a) for a in _b4_args(k, bf16)[:5]]
    if bf16:
        args[0] = args[0].astype(jnp.bfloat16)
        with jax_core.mixed_precision():
            return jax_head._p4_call(*args)
    return jax_head._p4_call(*args)


NAMES = ("dy_prev", "dw", "db", "t1", "t2")
PMID_NAMES = ("z", "sum", "sumsq")
HEAD_B1_NAMES = ("dpf", "dw1a", "db1", "r")
F2_NAMES = ("sum", "sumsq", "max", "min")
F1_NAMES = ("z2", "sum", "sumsq")
B4_NAMES = ("dy3", "dw4", "db4", "t1", "t2")
P1_NAMES = ("z1", "sum", "sumsq")


def _winners_agree(emu, other, z3, what):
    """Winner indices equal, or (rounding making two distinct points tie)
    pointing at values within ``BOUND`` of each other."""
    got, ref = emu.long(), torch.as_tensor(np.array(other)).long()
    vg = torch.gather(z3, 1, got[:, None, :])[:, 0]
    vr = torch.gather(z3, 1, ref[:, None, :])[:, 0]
    gap = ((vg - vr).abs() * (got != ref)).max().item()
    assert gap <= BOUND * max(1.0, z3.abs().max().item()), (what, gap)


@pytest.mark.parametrize("groups", [1, 2])
def test_f2_3xtf32_matches_float64_plain_and_jax(groups):
    """fp32: the sums within ``BOUND`` of float64, all four values of the
    plain twin and the JAX kernel, the winners theirs (or ties)."""
    args = _torch(_f2_args(groups))
    emu = f2_emulated(args, groups, "3xtf32")
    ref = f2_emulated(args, groups, "f64")
    plain = trunk_train.f2_plain(*args, groups=groups)
    jax_out = _jax_f2(groups)
    for i, nm in enumerate(F2_NAMES):
        e = emu[i]
        if i < 2:
            assert _rel(e, ref[i]) <= BOUND, (nm, _rel(e, ref[i]))
        assert _rel(e, plain[i]) <= BOUND, (nm, _rel(e, plain[i]))
        assert _rel(e, np.asarray(jax_out[i]).reshape(e.shape)) <= BOUND, nm
    z2, sc2, sh2, w3, b3 = args
    bpg = z2.shape[0] // groups
    h2 = torch.relu(z2 * sc2.reshape(groups, -1).repeat_interleave(
        bpg, 0)[:, None] + sh2.reshape(groups, -1).repeat_interleave(
            bpg, 0)[:, None])
    z3 = (h2.double() @ w3.double() + b3.double())
    for i, (want, sign) in enumerate(((4, 1), (5, -1))):
        for other in (plain[want], jax_out[want]):
            _winners_agree(emu[want], other, sign * z3, F2_NAMES[2 + i])


@pytest.mark.parametrize("groups", [1, 2])
def test_f2_winners_are_the_first_of_duplicated_points(groups):
    """Cloud 0's points 150.. repeat its points ..150, so every extremum
    is attained twice; the winner is the first (the JAX kernel's and
    torch's convention), and the second half never wins."""
    args = _torch(_f2_args(groups))
    for prec in ("3xtf32", "bf16"):
        emu = f2_emulated(args, groups, prec)
        for idx in emu[4:]:
            assert (idx[0] < N // 2).all(), prec
    plain = trunk_train.f2_plain(*args, groups=groups)
    for idx in plain[4:]:
        assert (idx[0] < N // 2).all()


@pytest.mark.parametrize("groups", [1, 2])
def test_f2_bf16_matches_jax_mixed_precision(groups):
    """bf16 h2 and W3 as the JAX kernel's ``_mxu_dot`` casts them, fp32
    sums: within ``BF16_BOUND`` of it and of the port's bf16 plain twin;
    and the rounding did happen (fp32 lands elsewhere)."""
    args = _torch(_f2_args(groups, bf16=True))
    emu = f2_emulated(args, groups, "bf16")
    plain = trunk_train.f2_plain(*args, groups=groups, bf16=True)
    fp32 = f2_emulated(args, groups, "3xtf32")
    jax_out = _jax_f2(groups, True)
    for i, nm in enumerate(F2_NAMES):
        e = emu[i]
        j = np.asarray(jax_out[i], np.float32).reshape(e.shape)
        assert _rel(e, j) <= BF16_BOUND, (nm, _rel(e, j))
        assert _rel(e, plain[i]) <= BF16_BOUND, (nm, _rel(e, plain[i]))
    assert _rel(emu[1], fp32[1]) > 10 * BOUND


@pytest.mark.parametrize("groups", [1, 2])
def test_b1_3xtf32_matches_float64_plain_and_jax(groups):
    args = _torch(_b1_args(groups))
    emu = b1_emulated(args, groups, "3xtf32")
    ref = b1_emulated(args, groups, "f64")
    plain = trunk_train.b1_plain(*args, groups=groups)
    jax_out = _jax_b1(groups)
    for nm, e, r, p, j in zip(NAMES, emu, ref, plain, jax_out):
        assert _rel(e, r) <= BOUND, (nm, _rel(e, r))
        assert _rel(e, p) <= BOUND, (nm, _rel(e, p))
        assert _rel(e, np.asarray(j).reshape(e.shape)) <= BOUND, nm


@pytest.mark.parametrize("c_out,c_in", BMID_WIDTHS)
def test_bmid_3xtf32_matches_float64_plain_and_jax(c_out, c_in):
    args = _torch(_bmid_args(c_out, c_in))
    emu = bmid_emulated(args, "3xtf32")
    ref = bmid_emulated(args, "f64")
    plain = seg_head_train.bmid_plain(*args)
    jax_out = _jax_bmid(c_out, c_in)
    for nm, e, r, p, j in zip(NAMES, emu, ref, plain, jax_out):
        assert _rel(e, r) <= BOUND, (nm, _rel(e, r))
        assert _rel(e, p) <= BOUND, (nm, _rel(e, p))
        assert _rel(e, np.asarray(j).reshape(e.shape)) <= BOUND, nm


@pytest.mark.parametrize("groups", [1, 2])
def test_b1_bf16_matches_jax_mixed_precision(groups):
    """bf16 operands at the places the JAX kernel's ``_mxu_dot`` casts,
    fp32 sums: within ``BF16_BOUND`` of it (a dz3 that rounds to its other
    bf16 neighbour moves a sum by one bf16 step of one term) and also of
    the port's bf16 plain twin; and the rounding did happen (fp32 lands
    elsewhere)."""
    args = _torch(_b1_args(groups, bf16=True))
    emu = b1_emulated(args, groups, "bf16")
    plain = trunk_train.b1_plain(*args, groups=groups, bf16=True)
    fp32 = b1_emulated(args, groups, "3xtf32")
    for nm, e, p, j in zip(NAMES, emu, plain, _jax_b1(groups, True)):
        assert _rel(e, np.asarray(j, np.float32).reshape(e.shape)) <= \
            BF16_BOUND, nm
        assert _rel(e, p) <= BF16_BOUND, nm
    assert _rel(emu[1], fp32[1]) > 10 * BOUND


@pytest.mark.parametrize("c_out,c_in", BMID_WIDTHS)
def test_bmid_bf16_matches_jax_mixed_precision(c_out, c_in):
    """As the B1 case; ``dyp`` is a bf16 stash on both sides: equal or
    one bf16 step apart, or within ``BF16_BOUND`` of its scale."""
    args = _torch(_bmid_args(c_out, c_in, bf16=True))
    emu = list(bmid_emulated(args, "bf16"))
    emu[0] = emu[0].to(torch.bfloat16)
    plain = seg_head_train.bmid_plain(*args, bf16=True)
    for i, (nm, e, p, j) in enumerate(zip(NAMES, emu, plain,
                                          _jax_bmid(c_out, c_in, True))):
        j = torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))
                             ).reshape(e.shape)
        if i == 0:
            e, p = e.float(), p.float()
            step = (j.abs() * 2.0 ** -7).clamp_min(
                BF16_BOUND * max(1.0, j.abs().max().item()))
            assert ((e - j).abs() <= step).all(), nm
            assert ((e - p).abs() <= step).all(), nm
        else:
            assert _rel(e, j) <= BF16_BOUND, nm
            assert _rel(e, p) <= BF16_BOUND, nm


@pytest.mark.parametrize("c_in,c_out", PMID_WIDTHS)
def test_pmid_3xtf32_matches_float64_plain_and_jax(c_in, c_out):
    args = _torch(_pmid_args(c_in, c_out))
    emu = pmid_emulated(args, "3xtf32")
    ref = pmid_emulated(args, "f64")
    plain = seg_head_train.pmid_plain(*args)
    for nm, e, r, p, j in zip(PMID_NAMES, emu, ref, plain,
                              _jax_pmid(c_in, c_out)):
        assert _rel(e, r) <= BOUND, (nm, _rel(e, r))
        assert _rel(e, p) <= BOUND, (nm, _rel(e, p))
        assert _rel(e, np.asarray(j).reshape(e.shape)) <= BOUND, nm


@pytest.mark.parametrize("c_in,c_out", PMID_WIDTHS)
def test_pmid_bf16_matches_jax_mixed_precision(c_in, c_out):
    """bf16 h and W as the JAX kernel's ``_mxu_dot`` casts them, fp32
    sums; ``z`` a bf16 stash on both sides: equal or one bf16 step apart,
    or within ``BF16_BOUND`` of its scale; the sums within ``BF16_BOUND``;
    and the rounding did happen (fp32 lands elsewhere)."""
    args = _torch(_pmid_args(c_in, c_out, bf16=True))
    emu = list(pmid_emulated(args, "bf16"))
    assert _rel(emu[0], pmid_emulated(args, "3xtf32")[0]) > 10 * BOUND
    emu[0] = emu[0].to(torch.bfloat16)
    plain = seg_head_train.pmid_plain(*args, bf16=True)
    for i, (nm, e, p, j) in enumerate(zip(PMID_NAMES, emu, plain,
                                          _jax_pmid(c_in, c_out, True))):
        j = torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))
                             ).reshape(e.shape)
        if i == 0:
            e, p = e.float(), p.float()
            step = (j.abs() * 2.0 ** -7).clamp_min(
                BF16_BOUND * max(1.0, j.abs().max().item()))
            assert ((e - j).abs() <= step).all(), nm
            assert ((e - p).abs() <= step).all(), nm
        else:
            assert _rel(e, j) <= BF16_BOUND, nm
            assert _rel(e, p) <= BF16_BOUND, nm


@pytest.mark.parametrize("c_out,c_in", HEAD_B1_WIDTHS)
def test_head_b1_3xtf32_matches_float64_plain_and_jax(c_out, c_in):
    args = _torch(_head_b1_args(c_out, c_in))
    emu = head_b1_emulated(args, "3xtf32")
    ref = head_b1_emulated(args, "f64")
    plain = seg_head_train.b1_plain(*args)
    for nm, e, r, p, j in zip(HEAD_B1_NAMES, emu, ref, plain,
                              _jax_head_b1(c_out, c_in)):
        assert _rel(e, r) <= BOUND, (nm, _rel(e, r))
        assert _rel(e, p) <= BOUND, (nm, _rel(e, p))
        assert _rel(e, np.asarray(j).reshape(e.shape)) <= BOUND, nm


@pytest.mark.parametrize("c_out,c_in", HEAD_B1_WIDTHS)
def test_head_b1_bf16_matches_jax_mixed_precision(c_out, c_in):
    """bf16 dz, W1a and pf as the JAX kernel's ``_mxu_dot`` /
    ``_mxu_dot_t`` cast them, fp32 sums; db and r from the unrounded dz:
    within ``BF16_BOUND`` of it and of the port's bf16 plain twin; and the
    rounding did happen (fp32 lands elsewhere)."""
    args = _torch(_head_b1_args(c_out, c_in, bf16=True))
    emu = head_b1_emulated(args, "bf16")
    plain = seg_head_train.b1_plain(*args, bf16=True)
    fp32 = head_b1_emulated(args, "3xtf32")
    for nm, e, p, j in zip(HEAD_B1_NAMES, emu, plain,
                           _jax_head_b1(c_out, c_in, True)):
        assert _rel(e, np.asarray(j, np.float32).reshape(e.shape)) <= \
            BF16_BOUND, nm
        assert _rel(e, p) <= BF16_BOUND, nm
    assert _rel(emu[1], fp32[1]) > 10 * BOUND


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("c_in,c2", F1_WIDTHS)
def test_f1_3xtf32_matches_float64_plain_and_jax(c_in, c2, groups):
    """fp32 (3xTF32; plain fp32 at depth 3): z2 and its per-group sums
    within ``BOUND`` of float64, of the plain twin and of the JAX kernel."""
    args = _torch(_f1_args(c_in, c2, groups))
    emu = f1_emulated(args, groups, "3xtf32")
    ref = f1_emulated(args, groups, "f64")
    plain = trunk_train.f1_plain(*args, groups=groups)
    for nm, e, r, p, j in zip(F1_NAMES, emu, ref, plain,
                              _jax_f1(c_in, c2, groups)):
        assert _rel(e, r) <= BOUND, (nm, _rel(e, r))
        assert _rel(e, p) <= BOUND, (nm, _rel(e, p))
        assert _rel(e, np.asarray(j).reshape(e.shape)) <= BOUND, nm


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("c_in,c2", F1_WIDTHS)
def test_f1_bf16_matches_jax_mixed_precision(c_in, c2, groups):
    """bf16 x and W2 as the JAX kernel's ``_mxu_dot`` casts them, fp32
    sums of the unrounded z2; z2 a bf16 stash on both sides: equal or one
    bf16 step apart, or within ``BF16_BOUND`` of its scale; the sums within
    ``BF16_BOUND``; and the rounding did happen (fp32 lands elsewhere)."""
    args = _torch(_f1_args(c_in, c2, groups))
    emu = list(f1_emulated(args, groups, "bf16"))
    assert _rel(emu[0], f1_emulated(args, groups, "3xtf32")[0]) > 10 * BOUND
    emu[0] = emu[0].to(torch.bfloat16)
    plain = trunk_train.f1_plain(*args, groups=groups, bf16=True)
    for i, (nm, e, p, j) in enumerate(zip(F1_NAMES, emu, plain,
                                          _jax_f1(c_in, c2, groups, True))):
        j = torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))
                             ).reshape(e.shape)
        if i == 0:
            e, p = e.float(), p.float()
            step = (j.abs() * 2.0 ** -7).clamp_min(
                BF16_BOUND * max(1.0, j.abs().max().item()))
            assert ((e - j).abs() <= step).all(), nm
            assert ((e - p).abs() <= step).all(), nm
        else:
            assert _rel(e, j) <= BF16_BOUND, nm
            assert _rel(e, p) <= BF16_BOUND, nm


@pytest.mark.parametrize("k", B4_PARTS)
def test_b4_3xtf32_matches_float64_plain_and_jax(k):
    """fp32: dy3, dW4, db4, t1, t2 within ``BOUND`` of float64, of the
    plain twin and of the JAX kernel, k = 50 and an odd k = 13 (padded
    logits: -inf in the softmax, zero in dz)."""
    args = _torch(_b4_args(k))
    emu = b4_emulated(args, "3xtf32")
    ref = b4_emulated(args, "f64")
    plain = seg_head_train.b4_plain(*args)
    for nm, e, r, p, j in zip(B4_NAMES, emu, ref, plain, _jax_b4(k)):
        assert _rel(e, r) <= BOUND, (nm, _rel(e, r))
        assert _rel(e, p) <= BOUND, (nm, _rel(e, p))
        assert _rel(e, np.asarray(j).reshape(e.shape)) <= BOUND, nm


@pytest.mark.parametrize("k", B4_PARTS)
def test_b4_bf16_matches_jax_mixed_precision(k):
    """bf16 h3, W4 and dz as the JAX kernel's ``_mxu_dot`` /
    ``_mxu_dot_t`` cast them, fp32 sums; db from the unrounded dz, t1 / t2
    from the unrounded dy3; dy3 a bf16 stash on both sides: equal or one
    bf16 step apart, or within ``BF16_BOUND`` of its scale; and the
    rounding did happen (fp32 lands elsewhere)."""
    args = _torch(_b4_args(k, bf16=True))
    emu = list(b4_emulated(args, "bf16"))
    assert _rel(emu[1], b4_emulated(args, "3xtf32")[1]) > 10 * BOUND
    emu[0] = emu[0].to(torch.bfloat16)
    plain = seg_head_train.b4_plain(*args, bf16=True)
    for i, (nm, e, p, j) in enumerate(zip(B4_NAMES, emu, plain,
                                          _jax_b4(k, True))):
        j = torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))
                             ).reshape(e.shape)
        if i == 0:
            e, p = e.float(), p.float()
            step = (j.abs() * 2.0 ** -7).clamp_min(
                BF16_BOUND * max(1.0, j.abs().max().item()))
            assert ((e - j).abs() <= step).all(), nm
            assert ((e - p).abs() <= step).all(), nm
        else:
            assert _rel(e, j) <= BF16_BOUND, nm
            assert _rel(e, p) <= BF16_BOUND, nm


@pytest.mark.parametrize("c_in,c1", P1_WIDTHS)
def test_p1_3xtf32_matches_float64_plain_and_jax(c_in, c1):
    """fp32 (3xTF32): z1 and its sums within ``BOUND`` of float64, of the
    plain twin and of the JAX kernel; c1 256 spans two of the kernel's
    column slices."""
    args = _torch(_p1_args(c_in, c1))
    emu = p1_emulated(args, "3xtf32")
    ref = p1_emulated(args, "f64")
    plain = seg_head_train.p1_plain(*args)
    for nm, e, r, p, j in zip(P1_NAMES, emu, ref, plain, _jax_p1(c_in, c1)):
        assert _rel(e, r) <= BOUND, (nm, _rel(e, r))
        assert _rel(e, p) <= BOUND, (nm, _rel(e, p))
        assert _rel(e, np.asarray(j).reshape(e.shape)) <= BOUND, nm


@pytest.mark.parametrize("c_in,c1", P1_WIDTHS)
def test_p1_bf16_matches_jax_mixed_precision(c_in, c1):
    """bf16 pf and W1a as the JAX kernel's ``_mxu_dot`` casts them, fp32
    sums of the unrounded z1; z1 a bf16 stash on both sides: equal or one
    bf16 step apart; the sums within ``BF16_BOUND``; and the rounding did
    happen (fp32 lands elsewhere)."""
    args = _torch(_p1_args(c_in, c1))
    emu = list(p1_emulated(args, "bf16"))
    assert _rel(emu[0], p1_emulated(args, "3xtf32")[0]) > 10 * BOUND
    emu[0] = emu[0].to(torch.bfloat16)
    plain = seg_head_train.p1_plain(*args, bf16=True)
    for i, (nm, e, p, j) in enumerate(zip(P1_NAMES, emu, plain,
                                          _jax_p1(c_in, c1, True))):
        j = torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))
                             ).reshape(e.shape)
        if i == 0:
            e, p = e.float(), p.float()
            step = j.abs() * 2.0 ** -7
            assert ((e - j).abs() <= step).all(), nm
            assert ((e - p).abs() <= step).all(), nm
        else:
            assert _rel(e, j) <= BF16_BOUND, nm
            assert _rel(e, p) <= BF16_BOUND, nm


@pytest.mark.parametrize("k", B4_PARTS)
def test_p4_3xtf32_matches_float64_plain_and_jax(k):
    """fp32: logp within ``BOUND`` of float64, of the plain twin and of
    the JAX kernel, k = 50 and an odd k = 13 (padded logits -inf), and
    its logits z4 within ``BOUND`` of float64."""
    args = _torch(_b4_args(k)[:5])
    emu = p4_emulated(args, "3xtf32")
    ref = p4_emulated(args, "f64")
    plain = seg_head_train.p4_plain(*args)
    assert _rel(emu[0], ref[0]) <= BOUND, _rel(emu[0], ref[0])
    assert _rel(emu[1], ref[1]) <= BOUND, _rel(emu[1], ref[1])
    assert _rel(emu[0], plain) <= BOUND, _rel(emu[0], plain)
    assert _rel(emu[0], np.asarray(_jax_p4(k))) <= BOUND


@pytest.mark.parametrize("k", B4_PARTS)
def test_p4_bf16_matches_jax_mixed_precision(k):
    """bf16 h3 and W4 as the JAX kernel's ``_mxu_dot`` casts them (z3 a
    bf16 stash), fp32 sums and softmax: logp within ``BF16_BOUND`` of it
    and of the port's bf16 plain twin; and the rounding did happen (fp32
    lands elsewhere)."""
    args = _torch(_b4_args(k, bf16=True)[:5])
    emu = p4_emulated(args, "bf16")[0]
    assert _rel(emu, p4_emulated(args, "3xtf32")[0]) > 10 * BOUND
    j = np.asarray(_jax_p4(k, True), np.float32)
    assert _rel(emu, j) <= BF16_BOUND, _rel(emu, j)
    plain = seg_head_train.p4_plain(*args, bf16=True)
    assert _rel(emu, plain) <= BF16_BOUND, _rel(emu, plain)


@pytest.mark.parametrize("pas", ["B1", "Bmid", "F2", "Pmid", "head B1", "F1",
                                 "B4", "P1", "P4"])
def test_one_tf32_product_misses_the_bound(pas):
    """Control: with one TF32 product (no ``lo``) in place of three the
    emulation misses ``BOUND`` of float64 on the products' outputs, which
    3xTF32 meets (the tests above)."""
    if pas == "F2":
        args = _torch(_f2_args(1))
        one, ref = (f2_emulated(args, 1, p) for p in ("tf32", "f64"))
    elif pas == "B1":
        args = _torch(_b1_args(1))
        one, ref = (b1_emulated(args, 1, p) for p in ("tf32", "f64"))
    elif pas == "Bmid":
        args = _torch(_bmid_args(*BMID_WIDTHS[0]))
        one, ref = (bmid_emulated(args, p) for p in ("tf32", "f64"))
    elif pas == "Pmid":
        args = _torch(_pmid_args(*PMID_WIDTHS[0]))
        one, ref = (pmid_emulated(args, p) for p in ("tf32", "f64"))
    elif pas == "head B1":
        args = _torch(_head_b1_args(*HEAD_B1_WIDTHS[0]))
        one, ref = (head_b1_emulated(args, p) for p in ("tf32", "f64"))
    elif pas == "F1":
        args = _torch(_f1_args(*F1_WIDTHS[0], 1))
        one, ref = (f1_emulated(args, 1, p) for p in ("tf32", "f64"))
    elif pas == "B4":
        args = _torch(_b4_args(B4_PARTS[0]))
        one, ref = (b4_emulated(args, p) for p in ("tf32", "f64"))
    elif pas == "P1":
        args = _torch(_p1_args(*P1_WIDTHS[0]))
        one, ref = (p1_emulated(args, p) for p in ("tf32", "f64"))
    else:   # logp, and its logits z4
        args = _torch(_b4_args(B4_PARTS[0])[:5])
        one, ref = (p4_emulated(args, p) for p in ("tf32", "f64"))
    assert max(_rel(one[i], ref[i]) for i in (0, 1)) > BOUND
