"""The numerics of the T-Net fc layers' split-K tensor-core product
(``csrc/small_fc.cuh``, under ``pool_fc_epilogue`` and ``fc_head_train``),
emulated in plain PyTorch on the CPU.

The card's kernels cannot run here; their arithmetic can. A layer's
product ``X W^T`` splits k into the cluster's slices (``launch.fc_split``:
8 CTAs, or fewer where the layer has 128 column groups or more), each
slice one product from zero: in fp32 3xTF32 (``mm_3xtf32`` of
``tests/test_torch_gemm_numerics.py``: per 8-deep k step ``a_lo b_hi +
a_hi b_lo + a_hi b_hi`` added to an fp32 accumulator), in bf16 with bf16
operands and fp32 sums; the slices' partials are added in fp32 in rank
order, then the bias. The BN epilogue follows in fp32 as the kernel
takes it: moments per group of rows centred on the running mean, summed
as ``bn_fwd_column``'s warp sums them (lane by lane, then its shuffle
tree; ``bn_moments``): one pass, unless ``m2`` reaches
``ONE_PASS_LIMIT`` times the second pass's variance about the mean,
then that variance; the normalize as ``((z - mu) * inv) * g + be``
(pool-fc) or ``(z - mu) * (inv * g) + be`` (the fc head), the ReLU. The
head's backward: dz2 by BN2's backward in fp32, ``dW2 = dz2^T h1`` one
product over the rows (the kernel's 64 x 64 output tiles take the whole
depth), ``dh1 = dz2 W2`` and ``dh = dz1 W1`` split-K in 3xTF32 in both
precisions (the JAX kernel's ``_mxu_dot_nt`` runs at HIGHEST), ``dW1 =
dz1^T h``; under bf16 only the three forward products and dW1/dW2 round
their operands.

Held at narrow widths (pool-fc 256 -> 64; the head 256 -> 64 -> 32 -> k^2
at k = 3 and 4), B = 2, 32 and 64 (groups 2): fp32 within ``BOUND``
(1e-4 scale-relative) of float64, of the port's plain twins and of the
JAX package's ``pool_fc_epilogue._fwd_call`` / ``fc_head_train._fwd_call``
/ ``_bwd_call`` (Pallas in interpret mode, as its own tests run it); bf16
within ``BF16_BOUND`` of the JAX kernels under their mixed-precision
scope. At B = 2 the moments are centred on the batch means (running
means track them): about a far centre two rows' one-pass variance (the
JAX kernels') cancels to a few bits in any order of sums. The control:
one TF32 product instead of three misses ``BOUND``. These tests document the
contract the kernels are built to and run no kernel; ``chip_smoke.py``
holds the kernels to their plain twins and to float64 on the card.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import core as jax_core
from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    fc_head_train as jax_fc,
    pool_fc_epilogue as jax_pool,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import build, launch
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    fc_head_train, pool_fc_epilogue,
)
from tests.test_torch_gemm_numerics import mm_3xtf32

BOUND = 1e-4
BF16_BOUND = 1e-3      # chip_smoke.py's bound for a bf16 pass's fp32 outputs
POOL_WIDTHS = (256, 64)            # (c3, c1)
HEAD_WIDTHS = (256, 64, 32)        # (c0, c1, c2); fc3 to k^2
POOL_CASES = ((2, 1), (32, 1), (64, 2))   # (batch, groups)
POOL_NAMES = ("h1", "h", "z1", "mu", "var", "inv")
FWD_NAMES = ("out", "z1", "z2", "mu1", "var1", "inv1", "mu2", "var2",
             "inv2")
BWD_NAMES = ("dh", "dw1", "db1", "dg1", "dbe1", "dw2", "db2", "dg2", "dbe2")
ONE_PASS_LIMIT = 4096.0   # small_fc.cuh's kFcOnePassLimit


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _mm(a, b, prec):
    """``a @ b`` as a CTA computes its slice: ``3xtf32``, ``tf32`` (one
    product, the control), ``bf16`` (bf16 operands, fp32 sums) or
    ``f64``."""
    if prec == "f64":
        return a.double() @ b.double()
    if prec == "bf16":
        return _bf(a) @ _bf(b)
    return mm_3xtf32(a, b, terms=3 if prec == "3xtf32" else 1)


def split_mm(x, w, prec):
    """``x [rows, k] @ w [k, cols]`` as ``fc_cluster``: k in the
    cluster's slices, each slice's product from zero, the partials added
    in fp32 in rank order."""
    if prec == "f64":
        return x.double() @ w.double()
    k, cols = w.shape
    cs, kc = launch.fc_split(k, cols)
    acc = None
    for q in range(cs):
        if q * kc >= k:
            part = torch.zeros(x.shape[0], cols)
        else:
            part = _mm(x[:, q * kc:(q + 1) * kc], w[q * kc:(q + 1) * kc],
                       prec)
        acc = part if acc is None else acc + part
    return acc


def _f(t, prec):
    return t.double() if prec == "f64" else t


def warp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x [G, b, C]`` summed over its rows as a warp of
    ``bn_fwd_column`` sums them: row r into lane r % 32 in row order,
    then the lanes by ``warp_sum``'s xor shuffle tree (16, 8, 4, 2, 1)."""
    g, b, c = x.shape
    v = torch.zeros(g, 32, c, dtype=x.dtype)
    for r0 in range(0, b, 32):
        blk = x[:, r0:r0 + 32]
        v[:, :blk.shape[1]] = v[:, :blk.shape[1]] + blk
    for s in (16, 8, 4, 2, 1):
        v = v + v[:, torch.arange(32) ^ s]
    return v[:, 0]


def bn_moments(z, rm, groups):
    """``(mu, var, inv)`` per group, ``[groups, cols]``, as
    ``bn_fwd_column`` takes them: ``d = z - rm``; ``mu_c``, ``m2`` and
    the second pass's ``var2 = mean((d - mu_c)^2)`` by ``warp_sum``; the
    one-pass ``max(m2 - mu_c^2, 0)`` unless ``m2`` reaches
    ``ONE_PASS_LIMIT`` times ``var2``, then ``var2``."""
    b = z.shape[0] // groups
    d = (z - rm).reshape(groups, b, -1)
    mu_c = warp_sum(d) / b
    m2 = warp_sum(d * d) / b
    e = d - mu_c[:, None]
    var2 = warp_sum(e * e) / b
    var = torch.where(var2 * ONE_PASS_LIMIT > m2,
                      torch.clamp(m2 - mu_c * mu_c, min=0.0), var2)
    return mu_c + rm, var, torch.rsqrt(var + core.BN_EPS)


def bn_fwd(z, rm, g, be, groups, fold):
    """The BN epilogue: ``(h, mu, var, inv)``, statistics ``[groups,
    cols]``."""
    b = z.shape[0] // groups
    mu, var, inv = bn_moments(z, rm, groups)
    zg = z.reshape(groups, b, -1) - mu[:, None]
    h = (zg * (inv * g)[:, None] if fold else (zg * inv[:, None]) * g) + be
    return torch.relu(h).reshape(z.shape), mu, var, inv


def pool_emulated(args, groups, prec):
    """Pool-fc as ``pool_fc_epilogue.cu`` computes it: ``(h1, h, z1, mu,
    var, inv)``; ``s3c`` None is the identity fold."""
    mx, mn, s3c, t3, w1, b1, g1, be1, rm1 = (
        _f(a, prec) if a is not None else None for a in args)
    if s3c is None:
        h = torch.relu(mx)
    else:
        h = torch.relu(torch.where(s3c >= 0, mx, mn) * s3c + t3)
    z1 = split_mm(h, w1, prec) + b1
    h1, mu, var, inv = bn_fwd(z1, rm1, g1, be1, groups, fold=False)
    return h1, h, z1, mu, var, inv


def head_fwd_emulated(args, prec):
    """The fc head's forward as ``fc_head_train.cu`` computes it."""
    h, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, rm1, rm2 = (
        _f(a, prec) for a in args)
    z1 = split_mm(h, w1, prec) + b1
    h1, mu1, var1, inv1 = bn_fwd(z1, rm1, g1, be1, 1, fold=True)
    z2 = split_mm(h1, w2, prec) + b2
    h2, mu2, var2, inv2 = bn_fwd(z2, rm2, g2, be2, 1, fold=True)
    out = split_mm(h2, w3, prec) + b3
    return (out, z1, z2, mu1[0], var1[0], inv1[0], mu2[0], var2[0],
            inv2[0])


def _bn_bwd(dh, z, mu, inv, g, be):
    b = z.shape[0]
    zhat = (z - mu) * inv
    dy = dh * (torch.relu(zhat * g + be) > 0)
    t1, t2 = dy.sum(0), (dy * zhat).sum(0)
    dz = (g * inv) * ((dy - t1 / b) - zhat * (t2 / b))
    return dz, dz.sum(0), t2, t1


def head_bwd_emulated(args, prec):
    """The fc head's backward: ``dW2`` and ``dW1`` in ``prec``, the
    cotangents ``dh1`` and ``dh`` split-K in 3xTF32 (or ``prec`` for the
    float64 and TF32 controls)."""
    dh2, h, z1, z2, w1, w2, g1, be1, g2, be2, mu1, inv1, mu2, inv2 = (
        _f(a, prec) for a in args)
    cot = prec if prec in ("f64", "tf32") else "3xtf32"
    h1 = torch.relu(((z1 - mu1) * inv1) * g1 + be1)
    dz2, db2, dg2, dbe2 = _bn_bwd(dh2, z2, mu2, inv2, g2, be2)
    dw2 = _mm(dz2.t(), h1, prec).t()
    dz1, db1, dg1, dbe1 = _bn_bwd(split_mm(dz2, w2.t(), cot), z1, mu1, inv1,
                                  g1, be1)
    dw1 = _mm(dz1.t(), h, prec).t()
    return (split_mm(dz1, w1.t(), cot), dw1, db1, dg1, dbe1, dw2, db2, dg2,
            dbe2)


def _rel(a, b) -> float:
    a = np.asarray(a.detach().double() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach().double() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _centre(z, groups):
    """Each group's batch mean of ``z`` (fp32), the moments' centre at
    B = 2."""
    return z.double().reshape(groups, z.shape[0] // groups, -1).mean(
        1).float()


def _pool_args(bsz, groups, identity=False):
    rng = np.random.default_rng(100 * bsz + groups + 7 * identity)
    f = np.float32
    c3, c1 = POOL_WIDTHS
    mx = rng.standard_normal((bsz, c3)).astype(f)
    if identity:
        mn = s3c = t3 = None
    else:
        mn = mx - np.abs(rng.standard_normal(mx.shape)).astype(f)
        s3c = (rng.uniform(0.5, 1.5, c3)
               * np.where(rng.random(c3) < 0.3, -1, 1)).astype(f)
        t3 = (rng.standard_normal(c3) * 0.1).astype(f)
    args = [torch.from_numpy(a) if a is not None else None for a in (
        mx, mn, s3c, t3, (rng.standard_normal((c3, c1)) * 0.2).astype(f),
        (rng.standard_normal(c1) * 0.1).astype(f),
        rng.uniform(0.5, 1.5, c1).astype(f),
        (rng.standard_normal(c1) * 0.1).astype(f),
        (rng.standard_normal(c1) * 0.3).astype(f))]
    if bsz == 2:
        args[8] = _centre(pool_emulated(args, groups, "f64")[2].float(),
                          groups)[0]
    return args


def _head_args(bsz, k):
    rng = np.random.default_rng(10 * bsz + k)
    f = np.float32
    c0, c1, c2 = HEAD_WIDTHS
    args = [np.maximum(rng.standard_normal((bsz, c0)), 0).astype(f)]
    for c_in, c_out, bn in ((c0, c1, True), (c1, c2, True),
                            (c2, k * k, False)):
        args += [(rng.uniform(-1, 1, (c_in, c_out)) / np.sqrt(c_in)
                  ).astype(f), (rng.standard_normal(c_out) * 0.1).astype(f)]
        if bn:
            args += [rng.uniform(0.5, 1.5, c_out).astype(f),
                     (rng.standard_normal(c_out) * 0.1).astype(f)]
    args = [torch.from_numpy(a) for a in args] + [
        torch.from_numpy((rng.standard_normal(c) * 0.3).astype(f))
        for c in (c1, c2)]
    if bsz == 2:
        ref = head_fwd_emulated(args, "f64")
        args[11] = _centre(ref[1].float(), 1)[0]
        args[12] = _centre(ref[2].float(), 1)[0]
    return args


def _bwd_args(bsz, bf16=False):
    """Backward inputs from the plain forward's stashes at k = 3."""
    args = _head_args(bsz, 3)
    _, z1, z2, mu1, _, inv1, mu2, _, inv2 = \
        fc_head_train.fc_head_fwd_plain(*args, bf16)
    rng = np.random.default_rng(bsz + 1)
    dh2 = torch.from_numpy(rng.standard_normal(
        (bsz, HEAD_WIDTHS[2])).astype(np.float32))
    return (dh2, args[0], z1, z2, args[1], args[5], args[3], args[4],
            args[7], args[8], mu1, inv1, mu2, inv2)


def _jax(fn, args, bf16, **kw):
    a = [jnp.asarray(t.numpy()) for t in args]
    if bf16:
        with jax_core.mixed_precision():
            return fn(*a, **kw)
    return fn(*a, **kw)


def _jax_pool(args, groups, bf16=False):
    if args[2] is None:   # the JAX package's identity fold
        c3 = args[0].shape[1]
        args = [args[0], args[0], torch.ones(c3), torch.zeros(c3),
                *args[4:]]
    return _jax(jax_pool._fwd_call, args, bf16, groups=groups)


def _jax_bwd(args, bf16=False):
    a = list(args)
    for i in (10, 11, 12, 13):     # the statistics as the kernel's [1, C]
        a[i] = a[i][None]
    return _jax(jax_fc._bwd_call, a, bf16)


def _hold(emu, refs, names, bound):
    for other, what in refs:
        for nm, e, o in zip(names, emu, other):
            o = np.asarray(o, np.float64).reshape(tuple(e.shape))
            assert _rel(e, o) <= bound, (what, nm, _rel(e, o))


@pytest.mark.parametrize("bsz,groups", POOL_CASES)
def test_pool_fc_3xtf32_matches_float64_plain_and_jax(bsz, groups):
    args = _pool_args(bsz, groups)
    emu = pool_emulated(args, groups, "3xtf32")
    plain = pool_fc_epilogue.pool_fc_fwd_plain(*args, groups)
    _hold(emu, ((pool_emulated(args, groups, "f64"), "float64"),
                (plain, "plain"), (_jax_pool(args, groups), "jax")),
          POOL_NAMES, BOUND)


def test_pool_fc_identity_fold_matches_the_jax_fold():
    """``relu_fc_bn_relu``'s identity fold (``h = relu(g)``, nothing but
    ``g`` read) against the JAX package's ``g`` as both extrema with
    ``s3c = 1``, ``t3 = 0``."""
    args = _pool_args(64, 2, identity=True)
    emu = pool_emulated(args, 2, "3xtf32")
    plain = pool_fc_epilogue.pool_fc_fwd_plain(*args, 2)
    _hold(emu, ((pool_emulated(args, 2, "f64"), "float64"),
                (plain, "plain"), (_jax_pool(args, 2), "jax")),
          POOL_NAMES, BOUND)


@pytest.mark.parametrize("bsz,groups", POOL_CASES[1:])
def test_pool_fc_bf16_matches_jax_mixed_precision(bsz, groups):
    """bf16 h and W1 as the JAX kernel's ``_mxu_dot`` casts them, fp32
    sums: within ``BF16_BOUND`` of it and of the port's bf16 plain twin;
    and the rounding did happen (fp32 lands elsewhere)."""
    args = _pool_args(bsz, groups)
    emu = pool_emulated(args, groups, "bf16")
    plain = pool_fc_epilogue.pool_fc_fwd_plain(*args, groups, True)
    _hold(emu, ((plain, "plain"), (_jax_pool(args, groups, True), "jax")),
          POOL_NAMES, BF16_BOUND)
    assert _rel(emu[2], pool_emulated(args, groups, "3xtf32")[2]) > \
        10 * BOUND


@pytest.mark.parametrize("bsz", [2, 32])
@pytest.mark.parametrize("k", [3, 4])
def test_fc_head_fwd_3xtf32_matches_float64_plain_and_jax(bsz, k):
    args = _head_args(bsz, k)
    emu = head_fwd_emulated(args, "3xtf32")
    plain = fc_head_train.fc_head_fwd_plain(*args)
    _hold(emu, ((head_fwd_emulated(args, "f64"), "float64"),
                (plain, "plain"), (_jax(jax_fc._fwd_call, args, False),
                                   "jax")), FWD_NAMES, BOUND)


@pytest.mark.parametrize("k", [3, 4])
def test_fc_head_fwd_bf16_matches_jax_mixed_precision(k):
    args = _head_args(32, k)
    emu = head_fwd_emulated(args, "bf16")
    plain = fc_head_train.fc_head_fwd_plain(*args, True)
    _hold(emu, ((plain, "plain"), (_jax(jax_fc._fwd_call, args, True),
                                   "jax")), FWD_NAMES, BF16_BOUND)
    assert _rel(emu[1], head_fwd_emulated(args, "3xtf32")[1]) > 10 * BOUND


@pytest.mark.parametrize("bsz", [2, 32])
def test_fc_head_bwd_3xtf32_matches_float64_plain_and_jax(bsz):
    args = _bwd_args(bsz)
    emu = head_bwd_emulated(args, "3xtf32")
    plain = fc_head_train.fc_head_bwd_plain(*args)
    _hold(emu, ((head_bwd_emulated(args, "f64"), "float64"),
                (plain, "plain"), (_jax_bwd(args), "jax")), BWD_NAMES,
          BOUND)


def test_fc_head_bwd_bf16_matches_jax_mixed_precision():
    """bf16 operands for dW1 and dW2 alone: the cotangents and sums
    (fp32 in both) within ``BOUND`` of the JAX kernel under mixed
    precision and of the bf16 twin; dW1 and dW2 within ``BF16_BOUND`` of
    the twin, and of the JAX kernel by ``chip_smoke.check_rounded``: its
    fp32 dz, summed in another order, straddles a bf16 rounding boundary
    now and then, and at 32 rows one term moves a sum by a large part."""
    from chip_smoke import check_rounded

    args = _bwd_args(32, bf16=True)
    emu = head_bwd_emulated(args, "bf16")
    plain = fc_head_train.fc_head_bwd_plain(*args, True)
    jx = _jax_bwd(args, True)
    fp32 = [i for i, nm in enumerate(BWD_NAMES) if nm not in ("dw1", "dw2")]
    for other in (plain, jx):
        _hold([emu[i] for i in fp32], ((
            [other[i] for i in fp32], "plain or jax"),),
            [BWD_NAMES[i] for i in fp32], BOUND)
    for i in (1, 5):
        assert _rel(emu[i], plain[i]) <= BF16_BOUND, BWD_NAMES[i]
        check_rounded(BWD_NAMES[i], emu[i], torch.from_numpy(np.array(
            jx[i], np.float32)), "fc-numerics")
    assert _rel(emu[1], head_bwd_emulated(args, "3xtf32")[1]) > 10 * BOUND


@pytest.mark.parametrize("what", ["pool", "fwd", "bwd"])
def test_one_tf32_product_misses_the_bound(what):
    """Control: with one TF32 product (no ``lo``) in place of three the
    emulation misses ``BOUND`` of float64 on the products' outputs, which
    3xTF32 meets (the tests above)."""
    if what == "pool":
        args, i = _pool_args(32, 1), 2                 # z1
        one, ref = (pool_emulated(args, 1, p) for p in ("tf32", "f64"))
    elif what == "fwd":
        args, i = _head_args(32, 4), 1                 # z1
        one, ref = (head_fwd_emulated(args, p) for p in ("tf32", "f64"))
    else:
        args, i = _bwd_args(32), 0                     # dh
        one, ref = (head_bwd_emulated(args, p) for p in ("tf32", "f64"))
    assert _rel(one[i], ref[i]) > BOUND


def test_fc_split_mirrors_small_fc():
    """``launch.fc_split`` and its constants are ``csrc/small_fc.cuh``'s
    (the emulation above splits k as the kernel does), so is the BN's
    ``ONE_PASS_LIMIT`` (the twins' too), and at the port's
    widths: fc1 8 slices of 128, fc2 of 64, fc3 at k = 3 of 32 and at k =
    64 (256 column groups) 2 of 128; the backward's dz2 W2 8 of 32 and
    dz1 W1 8 of 64."""
    header = (pathlib.Path(build.CSRC) / "small_fc.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (kFc\w+) = (\d+);", header))
    limit = re.search(r"constexpr float kFcOnePassLimit = ([\d.]+)f;", header)
    assert float(limit.group(1)) == ONE_PASS_LIMIT == core.ONE_PASS_LIMIT
    assert (launch.FC_COLS, launch.FC_CLUSTER, launch.FC_SLICE,
            launch.FC_WIDE) == tuple(int(consts[n]) for n in (
                "kFcCols", "kFcCluster", "kFcSlice", "kFcWide"))
    assert [launch.fc_split(k, c) for k, c in (
        (1024, 512), (512, 256), (256, 9), (256, 4096), (256, 512),
        (512, 1024))] == [(8, 128), (8, 64), (8, 32), (2, 128), (8, 32),
                          (8, 64)]
