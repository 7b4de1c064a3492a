"""``trunk3_train``, the whole T-Net conv stack (conv1 + BN1 + ReLU ->
conv2 + BN2 + ReLU -> conv3 + BN3 -> max over points), port against the
JAX package.

At B=2, N=64 and the T-Nets' widths (c_in 3 for STN3d, 64 for STNkd, then
64 -> 128 -> 1024), numpy-seeded, with negative BN3 gammas (the pool
takes the channel min there):

* the port's ``trunk3_train`` (its passes' plain twins on the CPU:
  trunk F1, the seg head's Pmid, trunk F2; trunk B1, the seg head's Bmid
  and B1) against the JAX package's ``trunk3_train`` (its Pallas kernels
  in interpret mode): the pooled output and the six statistics within
  1e-4 of their scale and all 13 gradients of ``sum(sin(pooled))``
  within ``1e-4 * (1 + max|g|)``, as ``tests/test_kernels.py``'s
  ``test_trunk3_kernel_parity`` bounds JAX's own;
* the same function composed two other ways, each within the same
  bounds: conv1 + BN1 + ReLU in plain PyTorch in front of
  ``trunk2_train``, and ``trunk3_train_reference`` (the whole stack under
  torch autograd);
* a planted fault, the BN2 statistic terms (``coef1``/``coef2``) dropped
  from the Bmid pass, moves the input gradient and the weight gradients
  in front of BN2 far beyond ``chip_smoke.py``'s whole-function bound;
* under each package's mixed-precision scope (bf16 operands and
  stashes) the port against JAX's and against conv1 + ``trunk2_train``:
  bf16 stashes a step apart move the statistics and the pool's winners,
  which a batch of 2 carries through every gradient, so each quantity is
  held to the larger of 1e-3 and twice what bf16 moves the other side's
  own function, as ``tests/test_torch_bench_step.py`` holds the bf16
  objectives; and farther than that from the port's fp32 function, so
  the scope rounded. The two passes that see the 3-wide input (trunk F1,
  the seg head's B1) are held tight under the scope on the same inputs
  as JAX's: bf16 stashes equal or one bf16 step apart, fp32 outputs
  within 1e-3 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import core as jax_core
from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    seg_head_train as jax_head, trunk_train as jax_trunk,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.models.core import BN_EPS
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    seg_head_train, trunk_train,
)

B, N = 2, 64
C1, C2, C3 = 64, 128, 1024
RTOL = 1e-4
BF16_RTOL = 1e-3
YARD = 2.0
BIAS_BEFORE_BN = (2, 6, 10)     # db1, db2, db3 among the 13 gradients


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(c_in, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32

    def a(*s):
        return (rng.standard_normal(s) * 0.2).astype(f)

    def gam(c, negative=0.0):
        return (rng.uniform(0.5, 1.5, c)
                * np.where(rng.random(c) < negative, -1, 1)).astype(f)

    return (rng.standard_normal((B, N, c_in)).astype(f), a(c_in, C1), a(C1),
            gam(C1), a(C1), a(C1, C2), a(C2), gam(C2), a(C2), a(C2, C3),
            a(C3), gam(C3, 0.3), a(C3))


def _port(fn, args, bf16=False):
    """Outputs and the 13 gradients of ``sum(sin(out[0]))``."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    with core.mixed_precision(enabled=bf16):
        out = fn(*leaves)
        torch.sin(out[0]).sum().backward()
    return ([o.detach().numpy() for o in out],
            [t.grad.numpy() for t in leaves])


def _jax(args, bf16=False):
    j_args = [jnp.asarray(a) for a in args]
    with jax_core.mixed_precision(enabled=bf16):
        out = jax_trunk.trunk3_train(*j_args)
        grads = jax.grad(lambda *a: jnp.sum(jnp.sin(
            jax_trunk.trunk3_train(*a)[0])), argnums=tuple(range(13)))(
                *j_args)
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


def _conv1_then_trunk2(x, w1, b1, g1, be1, *rest):
    """conv1 + BN1 + ReLU in plain PyTorch (two-pass moments; bf16
    operands under the scope) in front of ``trunk2_train``."""
    z1 = core.matmul(x, w1) + b1
    mu1, var1 = z1.mean((0, 1)), z1.var((0, 1), unbiased=False)
    h1 = torch.relu((z1 - mu1) * torch.rsqrt(var1 + BN_EPS) * g1 + be1)
    g, mu2, var2, mu3, var3 = trunk_train.trunk2_train(h1, *rest)
    return g, mu1.detach(), var1.detach(), mu2, var2, mu3, var3


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _assert_close(got, want, rtol):
    """Outputs within ``rtol`` of their scale; gradients within ``rtol *
    (1 + max|g|)`` of each one's own largest element."""
    (out, grads), (out_ref, grads_ref) = got, want
    assert len(out) == len(out_ref) == 7
    for i, (a, b) in enumerate(zip(out, out_ref)):
        assert a.shape == b.shape and _rel(a, b) <= rtol, (i, _rel(a, b))
    for i, (a, b) in enumerate(zip(grads, grads_ref)):
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert a.shape == b.shape and err <= rtol * (1 + scale), (i, err)


@pytest.fixture(scope="module", params=[3, 64], ids=["stn3d", "stnkd"])
def case(request):
    args = _args(request.param, seed=request.param)
    return args, _port(trunk_train.trunk3_train, args)


def test_trunk3_matches_jax(case):
    args, got = case
    _assert_close(got, _jax(args), RTOL)


@pytest.mark.parametrize("other", ["conv1+trunk2", "reference"])
def test_trunk3_matches_other_compositions(case, other):
    args, got = case
    fn = (_conv1_then_trunk2 if other == "conv1+trunk2"
          else trunk_train.trunk3_train_reference)
    _assert_close(got, _port(fn, args), RTOL)


def _zeroed(fn, positions):
    def wrapped(*args):
        args = list(args)
        for i in positions:
            args[i] = torch.zeros_like(args[i])
        return fn(*args)
    return wrapped


def test_whole_function_check_catches_missing_statistic_terms(case,
                                                              monkeypatch):
    """Bmid without BN2's statistic terms (``coef1``, ``coef2``): the
    input gradient and the weight gradients in front of BN2 (dw1, dw2)
    move by more than ``chip_smoke.py``'s whole-function bound, which the
    intact function meets by far (the tests above)."""
    from chip_smoke import WHOLE_BOUND

    args, _ = case
    monkeypatch.setattr(seg_head_train, "bmid",
                        _zeroed(seg_head_train.bmid, (5, 6)))
    _, grads = _port(trunk_train.trunk3_train, args)
    _, ref = _port(trunk_train.trunk3_train_reference, args)
    rel = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
           for a, b in zip(grads, ref)]
    assert min(rel[i] for i in (0, 1, 5)) > WHOLE_BOUND, rel


@pytest.mark.parametrize("other", ["jax", "conv1+trunk2"])
@pytest.mark.parametrize("c_in", [3, 64])
def test_trunk3_bf16_matches(c_in, other):
    """Under the scope: JAX's ``trunk3_train``, or conv1 + BN1 + ReLU in
    front of the port's ``trunk2_train``, each under its package's scope.
    bf16 stashes that round one step apart on the two sides move the BN
    statistics and the pool's winners, which at B=2 carry that rounding
    through every gradient, so each quantity is held to the larger of
    ``BF16_RTOL`` and twice what bf16 moves the other side's own function
    (its bf16 against its fp32 result), as ``tests/test_torch_bench_step.py``
    holds the bf16 objectives; the passes' own rounding is held tight by
    the test below. The conv biases' gradients (each in front of a batch
    BN: zero in exact arithmetic) are sums of dz that cancel, from bf16
    stashes in the passes (and JAX's) but through autograd of the
    unrounded BN1 in conv1 + ``trunk2_train``: they are held to JAX's
    alone."""
    args = _args(c_in, seed=10 + c_in)
    got = _port(trunk_train.trunk3_train, args, bf16=True)
    if other == "jax":
        want, fp32 = _jax(args, bf16=True), _jax(args)
    else:
        want, fp32 = (_port(_conv1_then_trunk2, args, bf16=True),
                      _port(_conv1_then_trunk2, args))
    for a, b, y in zip(got[0], want[0], fp32[0]):
        assert _rel(a, b) <= max(BF16_RTOL, YARD * _rel(y, b))
    for i, (a, b, y) in enumerate(zip(got[1], want[1], fp32[1])):
        if other != "jax" and i in BIAS_BEFORE_BN:
            continue
        scale = 1 + float(np.abs(b).max())
        moved = float(np.abs(y - b).max())
        err = float(np.abs(a - b).max())
        assert err <= max(BF16_RTOL * scale, YARD * moved), (i, err, moved)
    # The scope rounded: the port's fp32 gradients land elsewhere.
    plain = _port(trunk_train.trunk3_train, args)
    assert max(_rel(a, b) for a, b in zip(got[1], plain[1])) > 10 * RTOL


def _stash(a):
    """bf16 values as a stash holds them, on both sides."""
    b = jnp.asarray(a, jnp.bfloat16)
    return b, torch.from_numpy(np.asarray(b.astype(jnp.float32))).to(
        torch.bfloat16)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("name", ["trunk_F1", "head_B1"])
def test_bf16_passes_at_width_3_match_jax(name):
    """The two passes that see STN3d's 3-wide input, which no other
    training path feeds them (trunk F1 on the raw points; the seg head's
    B1 with a 3-wide ``pf``: ``dx`` and ``dw1``), under each package's
    scope on the same inputs: a bf16 stash equal or one bf16 step apart,
    every fp32 output within ``BF16_RTOL`` of its scale (one operand that
    rounds to its other neighbour moves a sum by one bf16 step of one
    term)."""
    rng = np.random.default_rng(3)
    f = np.float32

    def r(*s, scale=0.2):
        return (rng.standard_normal(s) * scale).astype(f)

    def pos(c):
        return rng.uniform(0.5, 1.5, c).astype(f)

    x = r(B, N, 3, scale=1.0)
    if name == "trunk_F1":
        port_fn, jax_fn = trunk_train.f1_plain, jax_trunk._f1_call
        jax_in = port_in = [x, r(3, C1), r(C1)]
    else:
        port_fn, jax_fn = seg_head_train.b1_plain, jax_head._b1_call
        (z1j, z1t), (dyj, dyt) = (_stash(r(B, N, C1, scale=s))
                                  for s in (1.0, 0.2))
        rest = [pos(C1), r(C1), pos(C1), r(C1, scale=1e-2),
                r(C1, scale=1e-2), x, r(3, C1)]
        jax_in, port_in = [z1j, dyj, *rest], [z1t, dyt, *rest]
    with jax_core.mixed_precision():
        ref = jax_fn(*[jnp.asarray(a) for a in jax_in])
    got = port_fn(*[a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
                    for a in port_in], bf16=True)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        a, bf = _np(a).reshape(np.shape(b)), b.dtype == jnp.bfloat16
        b = _np(b)
        scale = max(float(np.abs(b).max()), 1.0)
        if bf:
            assert (np.abs(a - b) <= np.maximum(np.abs(b) * 2.0 ** -7,
                                                1e-4 * scale)).all()
        else:
            assert np.abs(a - b).max() <= BF16_RTOL * scale
