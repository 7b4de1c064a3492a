"""The numerics of ``fused_mlp_stack``'s tensor-core kernel
(``csrc/mlp_stack.cu``: ``chain_tc_kernel``), emulated in plain PyTorch on
the CPU.

The card's kernel cannot run here; its arithmetic can. Each layer but a
narrow last one is a product on the tensor cores: in fp32 3xTF32
(``mm_3xtf32`` of ``tests/test_torch_gemm_numerics.py``: per 8-deep k
step ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` added to an fp32 accumulator),
under mixed precision bf16 operands with fp32 sums, the activations kept
between layers as bf16 (exact: the next product rounds them anyway). The
epilogue rounds ``z * scale`` and ``+ shift`` apart, then the activation.
A last layer narrower than 8 columns (the discriminator's 512 -> 1) folds
into the layer before in the kernel's order: per 128-column chunk, per
column warp (32 columns) and lane group t, an fp32 FMA chain over the
columns 8 j + 2 t + e (j 0..3, e 0..1; bf16 operands under mixed
precision); the group's four partials as (p0 + p1) + (p2 + p3); a warp's
partials over the chunks in order, then the warps in order; then the
last layer's affine and activation.

Held on 2 clouds of a ragged N = 300 (no tile of 128 or 64 rows divides
600 rows) at the discriminator's chain with k = 50 and k = 53 and at the
3 -> 64 -> 128 -> 1024 ReLU chain (and a 45 -> 72 -> 200 -> 136 -> 5
chain with negative scales, whose 5-wide last layer folds from partial
chunks, and 64 -> 384 -> 64, which takes 64-row tiles in fp32): fp32
within ``BOUND`` (1e-4 scale-relative) of float64, of the
port's ``fused_mlp_stack_plain`` and, on the first three, of the JAX
package's ``fused_mlp_stack`` (HIGHEST precision, Pallas in interpret
mode as its own tests run it); bf16 within ``BF16_BOUND``, the bound of
``tests/test_torch_mlp_stack.py``, of the plain twin and of the JAX
kernel under their mixed-precision scopes. The control: one TF32 product
instead of three misses ``BOUND`` (at the output's own scale: the
discriminator's logits are about 0.01, so a bound floored at 1 would not
tell the two apart there). The kernel's shared-memory plan
(``make_plan``, on the source's constants) is mirrored too: every chain
the tests and ``chip_smoke.py`` use fits a block, at 128 rows where the
kernel takes 128, and a chain that no block holds is refused. These tests document the contract the kernel is built
to and run no kernel; ``chip_smoke.py`` phase 18 holds the kernel on the
card to its plain twin.
"""

import functools
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import core as jax_core
from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    shared_mlp as jax_shared_mlp,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import build
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    shared_mlp,
)
from tests.test_torch_gemm_numerics import mm_3xtf32

BOUND = 1e-4
BF16_BOUND = 1e-3      # tests/test_torch_mlp_stack.py's BF16_RTOL
BSZ, N = 2, 300        # 600 rows: ragged for tiles of 128 and of 64
# The kernel's constants, as csrc/mlp_stack.cu defines them.
K = {k: int(v) for k, v in re.findall(
    r"constexpr int (k\w+) = (\d+);",
    (pathlib.Path(build.CSRC) / "mlp_stack.cu").read_text())}
WARPS_N = K["kWarpsN"]           # column warps
CHUNK = 32 * WARPS_N             # output columns a chunk, a slot's
FOLD_MAX = K["kFoldMax"]         # a last layer this narrow folds
SMEM_OPTIN = 232448    # bytes a block may take on the H100
SLOPE = 0.2
D_ACTS = ("leaky_relu",) * 4 + (None,)
# name: (widths, acts, input, scales: "unit" | "positive" | "signed")
CHAINS = {
    "disc-k50": ((50, 64, 128, 256, 512, 1), D_ACTS, "probs", "unit"),
    "disc-k53": ((53, 64, 128, 256, 512, 1), D_ACTS, "geo", "unit"),
    "relu-1024": ((3, 64, 128, 1024), ("relu",) * 3, "normal", "positive"),
    "odd-fold5": ((45, 72, 200, 136, 5), ("leaky_relu", "relu", None, "relu"),
                  "normal", "signed"),
    "rows64": ((64, 384, 64), ("relu", None), "normal", "positive"),
}
# The chain that takes 64-row tiles in fp32: three slots of 128 rows do
# not fit beside the ring.
ROWS64 = {"rows64"}
# The chains also held to the JAX kernel (Pallas in interpret mode, about
# a second a chain): the discriminator's and the 1024-wide one.
JAX_CHAINS = {"disc-k50", "disc-k53", "relu-1024"}


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


def _act(z, act):
    if act is None:
        return z
    if act == "relu":
        return torch.relu(z)
    return torch.where(z >= 0, z, SLOPE * z)


def _mm(h, w, prec):
    """``h @ w`` as the kernel's tensor-core layers compute it:
    ``3xtf32``, ``tf32`` (one product, the control), ``bf16`` (bf16
    operands, fp32 sums) or ``f64``."""
    if prec == "f64":
        return h.double() @ w.double()
    if prec == "bf16":
        return _bf(h) @ _bf(w)
    return mm_3xtf32(h.contiguous(), w.contiguous(),
                     terms=3 if prec == "3xtf32" else 1)


def _fma(a, b, c):
    """fp32 ``a * b + c`` rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def fold(h, w, prec):
    """``h [M, K] @ w [K, C]``, C < 8, as the kernel folds the narrow last
    layer (the module docstring's order); float64 with ``prec="f64"``.
    Every lane's chain runs at once: column 128 c + 32 wn + 8 j + 2 t + e
    is entry (c, wn, j, t, e) of the padded columns, and the zero columns
    past K (and a warp's chunks past its width) add exact zeros."""
    if prec == "f64":
        return h.double() @ w.double()
    if prec == "bf16":
        h, w = _bf(h), _bf(w)
    m, k = h.shape
    chunks = math.ceil(k / CHUNK)
    pad = chunks * CHUNK - k
    hc = torch.nn.functional.pad(h, (0, pad)).view(m, chunks, WARPS_N, 4, 4,
                                                  2)
    wc = torch.nn.functional.pad(w, (0, 0, 0, pad)).view(
        chunks, WARPS_N, 4, 4, 2, -1)
    p = torch.zeros(m, chunks, WARPS_N, 4, w.shape[1])   # per lane (c, wn, t)
    for j in range(4):
        for e in range(2):
            p = _fma(hc[:, :, :, j, :, e, None], wc[:, :, j, :, e], p)
    v = (p[:, :, :, 0] + p[:, :, :, 1]) + (p[:, :, :, 2] + p[:, :, :, 3])
    red = v[:, 0]
    for c in range(1, chunks):
        red = red + v[:, c]
    s = red[:, 0]
    for wn in range(1, WARPS_N):
        s = s + red[:, wn]
    return s


def chain_emulated(x, ws, shifts, scales, acts, prec):
    """The chain as ``chain_tc_kernel`` computes it, ``[B, N, C_L]``;
    float64 throughout with ``prec="f64"``."""
    f = torch.float64 if prec == "f64" else torch.float32
    h = x.reshape(-1, x.shape[-1]).to(f)
    folds = len(ws) >= 2 and ws[-1].shape[1] < FOLD_MAX
    mma = len(ws) - folds
    for li in range(len(ws)):
        z = (_mm(h, ws[li], prec) if li < mma else fold(h, ws[li], prec))
        h = _act(z.to(f) * scales[li].to(f) + shifts[li].to(f), acts[li])
        if prec == "bf16" and li + 1 < mma:
            h = _bf(h)              # a slot holds the activation as bf16
    return h.reshape(*x.shape[:2], -1)


@functools.lru_cache(maxsize=None)
def _args(name):
    """Numpy-seeded inputs of a chain: the D's probability maps (every
    fifth row one-hot; ``geo`` with unit-sphere coordinates appended) or
    normal inputs; weights ``[in, out]`` at PyTorch's default bounds; unit,
    positive or mixed-sign scales."""
    widths, acts, kind, scaled = CHAINS[name]
    rng = np.random.default_rng(sum(widths))
    if kind == "normal":
        x = rng.normal(size=(BSZ, N, widths[0]))
    else:
        z = rng.normal(0, 3, (BSZ, N, 50))
        x = np.exp(z - z.max(-1, keepdims=True))
        x /= x.sum(-1, keepdims=True)
        x[:, ::5] = np.eye(50)[rng.integers(0, 50, (BSZ, len(range(0, N,
                                                                  5))))]
        if kind == "geo":
            xyz = rng.normal(size=(BSZ, N, 3))
            xyz -= xyz.mean(1, keepdims=True)
            xyz /= np.linalg.norm(xyz, axis=-1).max(1)[:, None, None]
            x = np.concatenate([x, xyz], -1)
    ws, shifts, scales = [], [], []
    for c_in, c_out in zip(widths, widths[1:]):
        ws.append(rng.uniform(-1, 1, (c_in, c_out)) / np.sqrt(c_in))
        shifts.append(rng.uniform(-1, 1, c_out) / np.sqrt(c_in))
        sc = np.ones(c_out) if scaled == "unit" else rng.uniform(0.5, 1.5,
                                                                 c_out)
        if scaled == "signed":
            sc = np.where(rng.uniform(size=c_out) < 0.3, -sc, sc)
        scales.append(sc)
    f = np.float32
    return (x.astype(f), tuple(w.astype(f) for w in ws),
            tuple(s.astype(f) for s in shifts),
            tuple(s.astype(f) for s in scales), acts)


def _torch_args(name):
    x, ws, shifts, scales, acts = _args(name)
    t = lambda arrays: [torch.from_numpy(a) for a in arrays]  # noqa: E731
    return torch.from_numpy(x), t(ws), t(shifts), t(scales), list(acts)


@functools.lru_cache(maxsize=None)
def _emulated(name, prec):
    """``chain_emulated`` of a chain's inputs, once per precision."""
    return chain_emulated(*_torch_args(name), prec)


@functools.lru_cache(maxsize=None)
def _jax(name, bf16=False):
    """The JAX package's ``fused_mlp_stack`` on the chain, as numpy."""
    x, ws, shifts, scales, acts = _args(name)
    with jax_core.mixed_precision(enabled=bf16):
        out = jax_shared_mlp.fused_mlp_stack(
            jnp.asarray(x), [jnp.asarray(w) for w in ws],
            [jnp.asarray(s) for s in shifts],
            [jnp.asarray(s) for s in scales], list(acts))
    return np.asarray(out, np.float32)


def _rel(a, b, floor=1.0) -> float:
    """``max|a - b|`` over ``max(floor, max|b|)``: scale-relative as
    ``chip_smoke.py`` holds the kernel, or with ``floor=0`` at the
    output's own scale (the discriminator's logits are about 0.01)."""
    a = np.asarray(a.double() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.double() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), floor)


@pytest.mark.parametrize("name", list(CHAINS))
def test_3xtf32_matches_float64_plain_and_jax(name):
    """fp32: the emulated kernel within ``BOUND`` of float64 (also at the
    output's own scale), of the plain twin and (``JAX_CHAINS``) of the JAX
    kernel."""
    args = _torch_args(name)
    got = _emulated(name, "3xtf32")
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    f64 = _emulated(name, "f64")
    assert _rel(got, f64) <= BOUND
    assert _rel(got, f64, floor=0.0) <= BOUND
    assert _rel(got, shared_mlp.fused_mlp_stack_plain(*args)) <= BOUND
    if name in JAX_CHAINS:
        assert _rel(got, _jax(name)) <= BOUND


@pytest.mark.parametrize("name", list(CHAINS))
def test_bf16_matches_plain_and_jax_mixed_precision(name):
    """bf16 operands and activations, fp32 sums: within ``BF16_BOUND`` of
    the plain twin's and (``JAX_CHAINS``) of the JAX kernel's mixed
    precision; and the rounding did happen (the fp32 emulation lands
    elsewhere)."""
    got = _emulated(name, "bf16")
    plain = shared_mlp.fused_mlp_stack_plain(*_torch_args(name), bf16=True)
    assert _rel(got, plain) <= BF16_BOUND
    if name in JAX_CHAINS:
        assert _rel(got, _jax(name, bf16=True)) <= BF16_BOUND
    assert _rel(got, _emulated(name, "3xtf32"), floor=0.0) > 10 * BOUND


@pytest.mark.parametrize("name", list(CHAINS))
def test_one_tf32_product_misses_the_bound(name):
    """Control: one TF32 product (no ``lo`` terms) in place of three
    misses ``BOUND`` of float64 at the output's own scale, which 3xTF32
    meets (above); at the wider chains' scale, floored at 1, too."""
    tf32, f64 = _emulated(name, "tf32"), _emulated(name, "f64")
    assert _rel(tf32, f64, floor=0.0) > BOUND
    if not name.startswith("disc"):
        assert _rel(tf32, f64) > BOUND


@pytest.mark.parametrize("prec", ["3xtf32", "bf16"])
def test_fold_is_the_narrow_product(prec):
    """The fold's order of sums is one order of the same product: within
    fp32 rounding of float64 on the operands as the kernel rounds them."""
    args = _torch_args("odd-fold5")
    h = torch.from_numpy(np.random.default_rng(3).normal(
        size=(BSZ * N, 136)).astype(np.float32))
    w = args[1][-1]
    ref = (_bf(h).double() @ _bf(w).double() if prec == "bf16"
           else h.double() @ w.double())
    assert _rel(fold(h, w, prec), ref) <= 1e-6


def make_plan(widths, bf16, tm):
    """``csrc/mlp_stack.cu``'s ``make_plan``: ``(bytes, slots, reuse
    bits)``, bytes ``None`` past ``kMaxSlots``."""
    layers = len(widths) - 1
    folds = widths[-1] if layers >= 2 and widths[-1] < FOLD_MAX else 0
    mma = layers - (1 if folds else 0)
    n_in = -(-widths[0] // CHUNK)
    in_slots, slots, reuse = list(range(n_in)), n_in, 0
    for li in range(mma - 1):
        n_out = -(-widths[li + 1] // CHUNK)
        busy, out = set(in_slots), []
        for c in range(n_out):
            s = next((s for s in range(slots) if s not in busy), slots)
            if s == slots and c + 1 == n_out:
                s, reuse = in_slots[0], reuse | 1 << li
            elif s == slots:
                slots += 1
            busy.add(s)
            out.append(s)
        in_slots = out
    if slots > K["kMaxSlots"]:
        return None, slots, reuse
    # rows padded by 16 bytes; the ring; the fold's partials
    acts = (slots * tm * (CHUNK + 8) * 2 if bf16 else
            slots * tm * (CHUNK + 4) * 4)
    ring = K["kRing"] * CHUNK * (K["kSliceK"] + 4) * 4
    return acts + ring + WARPS_N * folds * tm * 4, slots, reuse


def tile_rows(widths, bf16):
    """The rows a tile the launcher picks (128 where they fit, else 64),
    with the bytes, or ``(None, None)`` where it refuses the chain."""
    for tm in (128, 64):
        nbytes = make_plan(widths, bf16, tm)[0]
        if nbytes is not None and nbytes <= SMEM_OPTIN:
            return tm, nbytes
    return None, None


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(CHAINS))
def test_every_chain_fits_a_block(name, bf16):
    """Every chain the tests and ``chip_smoke.py`` run fits one block of
    the H100, at 128 rows but ``ROWS64`` in fp32; the discriminator in two
    slots, its x, h1 and h2 in turn in one, h3 across both (layers 0, 1
    and 2 each end by overwriting their input's first slot)."""
    widths = CHAINS[name][0]
    tm, nbytes = tile_rows(widths, bf16)
    assert tm == (64 if name in ROWS64 and not bf16 else 128), (tm, nbytes)
    if name.startswith("disc"):
        assert make_plan(widths, bf16, 128)[1:] == (2, 0b111)
        assert nbytes == (126976 if bf16 else 192512)


def test_a_chain_no_block_holds_is_refused():
    """1024 -> 1024 -> 1024: eight slots of input and seven new ones for
    the output pass ``kMaxSlots`` at any tile height (kErrSmem on the
    card, chip_smoke.py phase 18)."""
    for bf16 in (False, True):
        assert tile_rows((1024, 1024, 1024), bf16) == (None, None)
