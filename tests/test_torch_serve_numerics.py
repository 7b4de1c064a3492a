"""The numerics of the serving kernels on the tensor cores
(``csrc/encoder_fused.cu``: ``stack_tc_kernel`` behind
``fused_stack_maxpool`` and ``head_tc_kernel`` behind ``seg_head_fused``),
emulated in plain PyTorch on the CPU.

The card's kernels cannot run here; their arithmetic can. The stack runs
each layer as ``act((h W^T) * scale + shift)``, every product 3xTF32
(``mm_3xtf32`` of ``tests/test_torch_gemm_numerics.py``: per 8-deep k step
``a_lo b_hi + a_hi b_lo + a_hi b_hi`` added to an fp32 accumulator) but a
first layer of depth <= 4, which is fp32 FMAs in order of k; the scale
and shift are applied with one rounding each, then the activation, and
only then the max: per 128-point tile of one cloud over its valid rows,
then over the cloud's tiles. The seg head takes ``g_row = g W1b`` in
fp32 (the prologue kernel), ``h1 = relu((pf W1a + g_row) * s1 + t1)`` by
64-channel chunks (elementwise per column: the chunks change nothing),
layer 2's accumulator running on across the chunks (one 3xTF32 product
over the whole depth, in order), layers 3 and 4 in 3xTF32, ``+ b4``, and
per row ``(z - max) - log(sum(exp(z - max)))``.

Held at narrow widths (stacks 3 -> 16 -> 32 -> 64, all ReLU, and 16 -> 32
-> 64 with no activation last and negative folded scales; a head with
c_pf 16, c_g 32 and 64 -> 32 -> 16 -> 13 parts, an odd part count that
the kernel pads to a whole n8 tile) on 2 clouds of a ragged N = 300:
within ``BOUND`` (1e-4 scale-relative) of float64, of the port's plain
twins and of the JAX package's ``fused_stack_maxpool`` /
``seg_head_fused`` (HIGHEST precision, Pallas in interpret mode as
``tests/test_torch_kernels.py`` runs them), and by ``chip_smoke.py``'s
float64 control (the max error against float64 at most ``F64_FACTOR``
times the plain fp32 pass's). Controls: one TF32 product instead of
three fails that control (and the stack's ``BOUND``), and with negative
scales the max taken before the affine (``max(z) * scale + shift``)
misses the plain twin by far. These
tests run no kernel; ``chip_smoke.py`` (phases 3 and 24) holds the
kernels to their plain twins and to float64 on the card.

Their bf16 mode (``core.mixed_precision``, the JAX package's ``_mxu_dot``
in its bf16 scope) is emulated too (``prec="bf16"``): every product's
operands rounded to bf16 (nearest even), each 16-deep k step's products
summed (exactly: bf16 products are exact in fp32) and added to an fp32
accumulator, as one m16n8k16 ``mma.sync`` a step; the stack's FMA layer
and the head's global row on the rounded operands, their fp32 FMAs kept.
It must meet the bf16 plain twins and the JAX kernels in interpret mode
under ``mixed_precision`` by ``chip_smoke.check_bf16``'s rule (at most
``STASH_SHARE`` of the outputs beyond ``BOUND`` of the scale, every one
within ``BF16_BOUND``: a bf16 hidden activation may round one step apart
where two fp32 sums of another order straddle a midpoint), and fp32
operands (the control) must miss it. Whole forwards in bf16: the port's
segmenter and classifier under ``core.mixed_precision`` against the JAX
package's under its own, on its Pallas path (interpret mode): within
``YARD_FACTOR`` times what bf16 moves the JAX package's fp32 forward, and
beyond ``BOUND`` of the port's fp32 forward (they are bf16).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import (
    apply_classifier, apply_segmenter, core as jax_core,
)
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    encoder_fused as jax_encoder_fused,
)
from adversarial_learning_on_pointclouds_tpu.utils import torch_import
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetCls, PointNetDenseCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    encoder_fused,
)
from chip_smoke import BF16_BOUND, F64_FACTOR, STASH_SHARE, YARD_FACTOR
from tests.test_torch_gemm_numerics import mm_3xtf32

BOUND = 1e-4
B, N = 2, 300          # ragged: no tile of 128 divides N
TILE = 128             # points a tile (kTile in csrc/encoder_fused.cu)
STACKS = {             # widths, activations, last scales negative
    "3-16-32-64": ((3, 16, 32, 64), ("relu", "relu", "relu"), False),
    "16-32-64": ((16, 32, 64), ("relu", None), True),
}
HEAD = (16, 32, (64, 32, 16), 13)   # c_pf, c_g, (c1, c2, c3), parts


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _f64_ratio(got, plain, ref) -> float:
    """``chip_smoke.py``'s float64 control: ``got``'s max error against the
    float64 pass ``ref`` over the plain fp32 pass's."""
    err = [float(np.abs(np.asarray(t, np.float64) - np.asarray(ref)).max())
           for t in (got, plain)]
    return err[0] / err[1]


def _fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as fp32 FMAs in order of k: each step's product and sum
    rounded once to fp32 (float64 holds the product exactly)."""
    v = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    for k in range(a.shape[1]):
        v = (a[:, k:k + 1].double() * b[k:k + 1].double() + v).float().double()
    return v.float()


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as one m16n8k16 bf16 ``mma.sync`` a 16-deep k step: the
    rounded operands' products summed per step (exact in float64) and
    added to an fp32 accumulator."""
    a, b = _bf(a), _bf(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 16):
        k = slice(k0, k0 + 16)
        acc = acc + (a[:, k].double() @ b[k].double()).float()
    return acc


def _mm(a, b, prec):
    """``a @ b`` as the kernels compute it: ``3xtf32``, ``tf32`` (one
    product, the control), ``bf16`` or ``f64``; depth <= 4 as fp32 FMAs
    (on bf16-rounded operands in ``bf16``)."""
    if prec == "f64":
        return a.double() @ b.double()
    if a.shape[1] <= 4:
        return _fma(_bf(a), _bf(b)) if prec == "bf16" else _fma(a, b)
    if prec == "bf16":
        return mm_bf16(a, b)
    return mm_3xtf32(a, b, terms=3 if prec == "3xtf32" else 1)


def _f(t, prec):
    return t.double() if prec == "f64" else t


def _tile_max(h: torch.Tensor, n: int) -> torch.Tensor:
    """``[B, N, C]`` -> ``[B, C]``: each 128-point tile's column max over
    its rows (the tail tile's valid rows only: nothing is padded), then the
    max over the tiles."""
    return torch.stack([h[:, p0:min(n, p0 + TILE)].amax(1)
                        for p0 in range(0, n, TILE)]).amax(0)


def stack_emulated(x, ws, shifts, scales, acts, prec, max_first=False):
    """``fused_stack_maxpool`` as ``stack_tc_kernel`` computes it;
    ``prec="f64"`` is the float64 control (every operation, the ReLU
    branches too, in float64). ``max_first``: the planted fault of taking
    the last layer's max before its affine."""
    bsz, n, c0 = x.shape
    h = _f(x.reshape(-1, c0), prec)
    for i, (w, sh, sc, act) in enumerate(zip(ws, shifts, scales, acts)):
        z = _mm(h, w, prec)
        if max_first and i == len(ws) - 1:
            zmax = _tile_max(z.reshape(bsz, n, -1), n)
            return core.activation(zmax * sc + sh, act)
        h = core.activation(z * _f(sc, prec) + _f(sh, prec), act)
    return _tile_max(h.reshape(bsz, n, -1), n)


def head_emulated(pf, g, w1, sh1, sc1, w2, sh2, sc2, w3, sh3, sc3, w4, b4,
                  prec):
    """``seg_head_fused`` as ``global_row_kernel`` + ``head_tc_kernel``
    compute it (``prec="f64"``: the float64 control)."""
    bsz, n, c_pf = pf.shape
    g, w1b = (_bf(g), _bf(w1[c_pf:])) if prec == "bf16" else (g, w1[c_pf:])
    g_row = _f(g, prec) @ _f(w1b, prec)                # the prologue, fp32
    z1 = _mm(_f(pf.reshape(-1, c_pf), prec), w1[:c_pf], prec)
    h = torch.relu((z1.reshape(bsz, n, -1) + g_row[:, None]) * _f(sc1, prec)
                   + _f(sh1, prec)).reshape(bsz * n, -1)
    h = torch.relu(_mm(h, w2, prec) * _f(sc2, prec) + _f(sh2, prec))
    h = torch.relu(_mm(h, w3, prec) * _f(sc3, prec) + _f(sh3, prec))
    z = _mm(h, w4, prec) + _f(b4, prec)
    m = z.amax(-1, keepdim=True)
    out = (z - m) - torch.log(torch.exp(z - m).sum(-1, keepdim=True))
    return out.reshape(bsz, n, -1)


def _layer(rng, c_in, c_out, negative=False):
    """numpy ``([out, in] weight, shift, scale)`` with a folded-BN affine;
    ``negative``: every other scale negated."""
    bound = c_in ** -0.5
    w = rng.uniform(-bound, bound, (c_out, c_in)).astype(np.float32)
    shift = rng.normal(0, 0.1, c_out).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    if negative:
        scale[1::2] *= -1
    return w, shift, scale


@functools.lru_cache(maxsize=None)
def _stack_args(key):
    widths, acts, negative = STACKS[key]
    rng = np.random.default_rng(13)
    x = rng.normal(size=(B, N, widths[0])).astype(np.float32)
    layers = [_layer(rng, a, b, negative and i == len(widths) - 2)
              for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))]
    return x, layers, acts


def _torch_stack(key):
    x, layers, acts = _stack_args(key)
    ws, shs, scs = zip(*layers)
    # [in, out] views of [out, in] storage: what the models pass.
    return (torch.from_numpy(x), [torch.from_numpy(w).t() for w in ws],
            [torch.from_numpy(s) for s in shs],
            [torch.from_numpy(s) for s in scs], acts)


@functools.lru_cache(maxsize=None)
def _jax_stack(key):
    x, layers, acts = _stack_args(key)
    ws, shs, scs = zip(*layers)
    return np.array(jax_encoder_fused.fused_stack_maxpool(
        jnp.asarray(x), [jnp.asarray(w.T) for w in ws],
        [jnp.asarray(s) for s in shs], [jnp.asarray(s) for s in scs], acts))


@functools.lru_cache(maxsize=None)
def _head_args():
    c_pf, c_g, (c1, c2, c3), k = HEAD
    rng = np.random.default_rng(14)
    pf = np.maximum(rng.normal(size=(B, N, c_pf)), 0).astype(np.float32)
    g = np.maximum(rng.normal(size=(B, c_g)), 0).astype(np.float32)
    layers = [_layer(rng, a, b)
              for a, b in ((c_pf + c_g, c1), (c1, c2), (c2, c3))]
    w4, b4, _ = _layer(rng, c3, k)
    return pf, g, layers, w4, b4


def _torch_head():
    pf, g, layers, w4, b4 = _head_args()
    flat = [t for w, sh, sc in layers
            for t in (torch.from_numpy(w).t(), torch.from_numpy(sh),
                      torch.from_numpy(sc))]
    return (torch.from_numpy(pf), torch.from_numpy(g), *flat,
            torch.from_numpy(w4).t(), torch.from_numpy(b4))


@functools.lru_cache(maxsize=None)
def _jax_head():
    pf, g, layers, w4, b4 = _head_args()
    flat = [jnp.asarray(t) for w, sh, sc in layers for t in (w.T, sh, sc)]
    return np.array(jax_encoder_fused.seg_head_fused(
        jnp.asarray(pf), jnp.asarray(g), *flat, jnp.asarray(w4.T),
        jnp.asarray(b4)))


@pytest.mark.parametrize("key", sorted(STACKS))
def test_stack_3xtf32_matches_float64_plain_and_jax(key):
    """The pooled stack within ``BOUND`` of float64, of the plain twin and
    of the JAX kernel: 3 -> 16 -> 32 -> 64 (the first layer at depth 3 as
    fp32 FMAs) and 16 -> 32 -> 64 with no activation last and negative
    folded scales (the max of the affine, not the affine of the max)."""
    args = _torch_stack(key)
    emu, ref = (stack_emulated(*args, p) for p in ("3xtf32", "f64"))
    plain = encoder_fused.fused_stack_maxpool_plain(*args)
    assert emu.shape == (B, STACKS[key][0][-1])
    assert _rel(emu, ref) <= BOUND
    assert _f64_ratio(emu, plain, ref) <= F64_FACTOR
    assert _rel(emu, plain) <= BOUND
    assert _rel(emu, _jax_stack(key)) <= BOUND


def test_head_3xtf32_matches_float64_plain_and_jax():
    """The head's log-probs within ``BOUND`` of float64, of the plain twin
    and of the JAX kernel, at an odd part count (13: the kernel's padded
    logits are -inf in the max and out of the sum)."""
    args = _torch_head()
    emu, ref = (head_emulated(*args, p) for p in ("3xtf32", "f64"))
    plain = encoder_fused.seg_head_fused_plain(*args)
    assert emu.shape == (B, N, HEAD[3])
    assert _rel(emu, ref) <= BOUND
    assert _f64_ratio(emu, plain, ref) <= F64_FACTOR
    assert _rel(emu, plain) <= BOUND
    assert _rel(emu, _jax_head()) <= BOUND
    assert np.abs(np.exp(emu.double().numpy()).sum(-1) - 1).max() <= BOUND


@pytest.mark.parametrize("what", ["stack", "head"])
def test_one_tf32_product_misses_the_bound(what):
    """Control: with one TF32 product (no ``lo``) in place of three the
    emulation misses the float64 control that 3xTF32 meets (above): its
    error against float64 is far above ``F64_FACTOR`` times the plain fp32
    pass's. The stack also misses ``BOUND``; the head's log-probs do not
    (about 2.5e-5 scale-relative, at these widths and at the serving
    ones), which is why the card holds the head by the float64 control."""
    if what == "stack":
        args = _torch_stack("16-32-64")
        one, ref = (stack_emulated(*args, p) for p in ("tf32", "f64"))
        plain = encoder_fused.fused_stack_maxpool_plain(*args)
        assert _rel(one, ref) > BOUND
    else:
        args = _torch_head()
        one, ref = (head_emulated(*args, p) for p in ("tf32", "f64"))
        plain = encoder_fused.seg_head_fused_plain(*args)
    assert _f64_ratio(one, plain, ref) > 10 * F64_FACTOR


def test_max_before_the_affine_misses_the_bound():
    """Control: with negative folded scales, taking the last layer's max
    before ``* scale + shift`` (which is exact only for positive scales)
    misses the plain twin by far: the kernel takes the max last."""
    args = _torch_stack("16-32-64")
    wrong = stack_emulated(*args, "3xtf32", max_first=True)
    assert _rel(wrong, encoder_fused.fused_stack_maxpool_plain(*args)) > 0.1


def check_bf16(got, ref):
    """``chip_smoke.check_bf16``'s rule: at most ``STASH_SHARE`` of the
    outputs beyond ``BOUND`` of the scale, every one within
    ``BF16_BOUND``."""
    got, ref = (np.asarray(t, np.float64) for t in (got, ref))
    scale = max(float(np.abs(ref).max()), 1.0)
    err = np.abs(got - ref)
    return (err > BOUND * scale).mean() <= STASH_SHARE and \
        err.max() <= BF16_BOUND * scale


@functools.lru_cache(maxsize=None)
def _jax_stack_bf16(key):
    x, layers, acts = _stack_args(key)
    ws, shs, scs = zip(*layers)
    with jax_core.mixed_precision():
        return np.array(jax_encoder_fused.fused_stack_maxpool(
            jnp.asarray(x), [jnp.asarray(w.T) for w in ws],
            [jnp.asarray(s) for s in shs], [jnp.asarray(s) for s in scs],
            acts))


@functools.lru_cache(maxsize=None)
def _jax_head_bf16():
    pf, g, layers, w4, b4 = _head_args()
    flat = [jnp.asarray(t) for w, sh, sc in layers for t in (w.T, sh, sc)]
    with jax_core.mixed_precision():
        return np.array(jax_encoder_fused.seg_head_fused(
            jnp.asarray(pf), jnp.asarray(g), *flat, jnp.asarray(w4.T),
            jnp.asarray(b4)))


@pytest.mark.parametrize("key", sorted(STACKS))
def test_stack_bf16_matches_its_twin_and_jax(key):
    """``stack_tc_kernel``'s bf16 arithmetic against the bf16 plain twin
    and the JAX kernel under ``mixed_precision``; fp32 operands miss; the
    wrapper's plain route under the scope is the bf16 twin."""
    args = _torch_stack(key)
    emu = stack_emulated(*args, "bf16")
    twin = encoder_fused.fused_stack_maxpool_plain(*args, bf16=True)
    assert check_bf16(emu, twin)
    assert check_bf16(emu, _jax_stack_bf16(key))
    assert not check_bf16(stack_emulated(*args, "3xtf32"), twin)
    with core.mixed_precision():
        np.testing.assert_array_equal(
            encoder_fused.fused_stack_maxpool(*args), twin)


def test_head_bf16_matches_its_twin_and_jax():
    """``head_tc_kernel``'s (and its global-row prologue's) bf16
    arithmetic against the bf16 plain twin and the JAX kernel under
    ``mixed_precision``; fp32 operands miss."""
    args = _torch_head()
    emu = head_emulated(*args, "bf16")
    twin = encoder_fused.seg_head_fused_plain(*args, bf16=True)
    assert check_bf16(emu, twin)
    assert check_bf16(emu, _jax_head_bf16())
    assert not check_bf16(head_emulated(*args, "3xtf32"), twin)
    with core.mixed_precision():
        np.testing.assert_array_equal(encoder_fused.seg_head_fused(*args),
                                      twin)


def _bn_spread(model, gen):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model


@pytest.mark.parametrize("kind", ["seg", "cls"])
def test_bf16_eval_forward_matches_jax(kind):
    """The whole eval forward of the segmenter (feature transform, 5
    parts) and the classifier (10 classes) in bf16, B=4 N=64, against the
    JAX package's Pallas path (interpret mode) under its
    ``mixed_precision`` (measured 1.6e-4 and 2.1e-4 of the scale, where
    bf16 moves JAX's fp32 forward by 3.5e-4 and 3.2e-4)."""
    gen = torch.Generator().manual_seed(2)
    model = _bn_spread(PointNetDenseCls(5, True, generator=gen)
                       if kind == "seg" else
                       PointNetCls(10, False, generator=gen), gen)
    importer = (torch_import.segmenter_from_state_dict if kind == "seg"
                else torch_import.classifier_from_state_dict)
    apply = apply_segmenter if kind == "seg" else apply_classifier
    params, state = importer(model.state_dict())
    x = np.random.default_rng(3).normal(size=(4, 64, 3)).astype(np.float32)
    ref, port = {}, {}
    for bf16 in (False, True):
        with use_pallas(True), jax_core.mixed_precision(enabled=bf16):
            ref[bf16] = np.asarray(apply(params, state, jnp.asarray(x),
                                         train=False)[0])
        with torch.no_grad(), core.mixed_precision(enabled=bf16):
            port[bf16] = model(torch.from_numpy(x))[0].numpy()
    moved = _rel(ref[True], ref[False])   # 3.5e-4 and 3.2e-4
    assert _rel(port[False], ref[False]) <= BOUND
    assert _rel(port[True], ref[True]) <= YARD_FACTOR * moved
    assert _rel(port[True], port[False]) > BOUND
