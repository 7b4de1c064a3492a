"""The fp32 numerics of the port's GEMM core (``csrc/strided_gemm.cu``),
emulated in plain PyTorch on the CPU.

The card's kernel cannot run here; its arithmetic can. ``tf32_rna``
rounds fp32 to TF32 (10 mantissa bits, to nearest with ties away from
zero, as ``cvt.rna.tf32.f32``) by integer arithmetic on the bits;
``mm_3xtf32`` splits each operand into ``hi = tf32(v)`` and ``lo =
tf32(v - hi)`` and, per 8-deep k step, sums ``a_lo b_hi + a_hi b_lo +
a_hi b_hi`` from zero (exactly here: the tensor core's own rounding
inside a step is not modelled, the card's float64 control in
``chip_smoke.py`` holds that) and adds the step to an fp32 accumulator
with round-to-nearest, as the kernel does. The emulation is held at the
widths of the generator's and the discriminator's paths within
``BOUND = 1e-4`` scale-relative of float64, of the JAX package's
``pointwise_matmul`` forward, dx and dW (HIGHEST precision, its Pallas
kernels in interpret mode as its own tests run them) and of its
``tnet_apply`` at k = 3 and 64. Two controls: one TF32 product (no
``lo``) at depth 1024 misses the bound, and the split's error at depth 1
is more than twice fp32's, which is why the kernel streams products of
depth <= 4 in fp32 FMA instead. The package's ``*_plain`` functions stay
plain fp32 products; the emulation lives here only.

These tests document the numerics contract the kernel is built to; they
do not run the kernel, and no change to ``strided_gemm.cu`` can make them
fail. The kernel itself is held to the contract on the card by
``chip_smoke.py`` (phase 15: every pass within ``BOUND`` of its plain
pass, its float64 control within ``F64_FACTOR`` of cuBLAS fp32's error).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    shared_mlp as jax_shared_mlp,
    tnet_apply as jax_tnet,
)
from chip_smoke import F64_FACTOR

BOUND = 1e-4
BSZ, N = 2, 256
PARTS = 50
# The widths the emulation is held at: (c_in, c_out) of layers of the
# generator's path and the discriminator's.
WIDTHS = ((3, 64), (64, 128), (128, 1024), (512, 256), (128, PARTS),
          (512, 1))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 of fp32's 23 mantissa bits, rounding
    the 13 dropped ones to nearest, ties away from zero (adding half of
    the kept bit to the magnitude carries into the exponent as it must)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, terms: int = 3
              ) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` as the GEMM core computes an fp32 product:
    per 8-deep k step ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` (``terms=1``:
    ``a_hi b_hi`` alone, one TF32 product), rounded to fp32 and added to
    an fp32 accumulator."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        step = ah[:, k].double() @ bh[k].double()
        if terms == 3:
            step = (al[:, k].double() @ bh[k].double()
                    + ah[:, k].double() @ bl[k].double() + step)
        acc = acc + step.float()
    return acc


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _inputs(c_in, c_out, seed, bsz=BSZ, n=N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, n, c_in)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(c_in, c_out)) / np.sqrt(c_in)
         ).astype(np.float32)
    b = (rng.normal(size=c_out) * 0.1).astype(np.float32)
    g = rng.normal(size=(bsz, n, c_out)).astype(np.float32)
    return x, w, b, g


def _emulated(pas, x, w, b, g):
    """The pass through ``mm_3xtf32`` and its float64 product."""
    c_in, c_out = w.shape
    xr, gr = (torch.from_numpy(t.reshape(-1, t.shape[-1])) for t in (x, g))
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    if pas == "fwd":
        a, m = xr, wt
        emu = mm_3xtf32(a, m) + bt
        ref = a.double() @ m.double() + bt.double()
    elif pas == "dx":
        a, m = gr, wt.t().contiguous()
        emu, ref = mm_3xtf32(a, m), a.double() @ m.double()
    else:
        a, m = xr.t().contiguous(), gr
        emu, ref = mm_3xtf32(a, m), a.double() @ m.double()
    return emu.numpy(), ref.numpy()


@functools.lru_cache(maxsize=None)
def _case(c_in, c_out):
    """The inputs at a width and the JAX package's forward, dx and dW on
    them (one VJP for the three passes)."""
    x, w, b, g = _inputs(c_in, c_out, seed=c_in * 1000 + c_out)
    y, vjp = jax.vjp(jax_shared_mlp.pointwise_matmul, jnp.asarray(x),
                     jnp.asarray(w), jnp.asarray(b))
    dx, dw, _ = vjp(jnp.asarray(g))
    outs = {"fwd": y, "dx": dx, "dW": dw}
    return (x, w, b, g), {k: np.asarray(v).reshape(-1, v.shape[-1])
                          for k, v in outs.items()}


@pytest.mark.parametrize("pas", ["fwd", "dx", "dW"])
@pytest.mark.parametrize("c_in,c_out", WIDTHS)
def test_3xtf32_matches_float64_and_jax(c_in, c_out, pas):
    args, jax_out = _case(c_in, c_out)
    emu, ref = _emulated(pas, *args)
    assert _rel(emu, ref) <= BOUND, _rel(emu, ref)
    assert _rel(emu, jax_out[pas]) <= BOUND, _rel(emu, jax_out[pas])


@pytest.mark.parametrize("pas", ["fwd", "dx", "dT"])
@pytest.mark.parametrize("k", [3, 64])
def test_3xtf32_tnet_apply_matches_float64_and_jax(k, pas):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(BSZ, N, k)).astype(np.float32)
    t = (np.eye(k) + rng.normal(size=(BSZ, k, k)) * 0.2).astype(np.float32)
    g = rng.normal(size=(BSZ, N, k)).astype(np.float32)
    y, vjp = jax.vjp(jax_tnet.tnet_apply, jnp.asarray(x), jnp.asarray(t))
    jdx, jdt = vjp(jnp.asarray(g))
    jax_out = {"fwd": y, "dx": jdx, "dT": jdt}[pas]
    for i in range(BSZ):
        xt, tt, gt = (torch.from_numpy(v[i]) for v in (x, t, g))
        a, m = {"fwd": (xt, tt), "dx": (gt, tt.t().contiguous()),
                "dT": (xt.t().contiguous(), gt)}[pas]
        emu = mm_3xtf32(a, m).numpy()
        assert _rel(emu, (a.double() @ m.double()).numpy()) <= BOUND
        assert _rel(emu, np.asarray(jax_out[i])) <= BOUND


def _depth_errors(k, terms, rows=4096, n=128, seed=7):
    """Max errors against float64 of the emulation and of the plain fp32
    product at depth ``k``, and the float64 product's scale."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(rows, k)).astype(np.float32))
    m = torch.from_numpy((rng.uniform(-1, 1, size=(k, n)) / np.sqrt(k))
                         .astype(np.float32))
    ref = a.double() @ m.double()
    emu = (mm_3xtf32(a, m, terms).double() - ref).abs().max().item()
    plain = ((a @ m).double() - ref).abs().max().item()
    return emu, plain, max(1.0, ref.abs().max().item())


def test_one_tf32_product_fails_the_checks():
    """Control: without ``lo`` (one TF32 product, about 2^-11 of each
    term) at depth 1024 the emulation misses ``BOUND`` of float64 and is
    far past the float64 control's factor, which 3xTF32 meets."""
    one, plain, scale = _depth_errors(1024, terms=1)
    three, _, _ = _depth_errors(1024, terms=3)
    assert one / scale > BOUND, one / scale
    assert one > 50 * F64_FACTOR * plain, (one, plain)
    assert three <= F64_FACTOR * plain, (three, plain)


def test_3xtf32_at_depth_one_is_why_thin_products_stream():
    """At depth 1 the split's lost bits (about 2^-22 of a product) are
    more than twice the error of fp32's one rounding, so the kernel
    computes products of depth <= 4 in fp32 FMA; at the depths
    the tensor cores take (50 and up) 3xTF32 is within the factor."""
    emu, plain, _ = _depth_errors(1, terms=3)
    assert emu > F64_FACTOR * plain, (emu, plain)
    for k in (50, 64, 512):
        emu, plain, _ = _depth_errors(k, terms=3)
        assert emu <= F64_FACTOR * plain, (k, emu, plain)
