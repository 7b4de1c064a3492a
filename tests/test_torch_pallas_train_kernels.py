"""The per-layer training kernels (``use_pallas_train``), port against the
JAX package.

``pointwise_matmul``, ``tnet_apply``, ``maxpool_points`` and
``fc_head_train`` run on the CPU, where every CUDA pass takes its plain
PyTorch twin and the autograd glue is the port's own; the JAX side runs
its Pallas kernels in interpret mode (``tests/conftest.py``). Both get the
same numpy-seeded inputs and the same numpy cotangent, at odd widths (3,
9) and N = 516, which the JAX kernels cannot tile (one full-width block)
and which is ragged for the port's 64-row tiles. The forward and every
VJP output are held at ``1e-4 * max(1, |ref|)`` (fp32 programs that sum
in another order, as ``tests/test_kernels.py``), under
``core.mixed_precision`` too: there both sides round the same operands
to bf16 (the forward and ``dx`` of ``pointwise_matmul``, ``fc_head_train``'s
three forward products and ``dw1``/``dw2``) and keep the rest fp32, so
they still differ by summation order only; except that ``fc_head_train``
rounds ``dz1``/``dz2``, which it computes, as ``dw1``/``dw2``'s operands:
where the two sides' fp32 ``dz`` straddles a rounding boundary the bf16
operand differs by one bf16 step, and at 8 rows one term can carry a
whole sum, so those two are held to ``1e-4`` on all but ``1%`` of their
elements and to ``2^-7`` of their scale on every one (a missing rounding
misses ``1e-4`` on a third or more of them). Three planted faults must
fail those bounds: ``fc_head_train``'s backward without its
batch-statistic terms, its ``dw`` left in fp32 under the scope, and
``pointwise_matmul``'s ``dw`` rounded to bf16.
``chip_smoke.py`` holds the CUDA passes against the same plain twins on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import core as jax_core
from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    fc_head_train as jax_fc_head,
    maxpool_points as jax_maxpool,
    shared_mlp as jax_shared_mlp,
    tnet_apply as jax_tnet,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import build
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    fc_head_train, maxpool_points, shared_mlp, tnet_apply,
)

RTOL = 1e-4
N = 516


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0)


def _close_rounded(a, b):
    """A bf16-operand product of a computed, rounded operand (see the
    module docstring): ``(share beyond RTOL, max error)`` of the scale,
    asserted at most ``1e-2`` and ``2^-7``."""
    a, b = _np(a), _np(b)
    err = np.abs(a - b) / max(np.abs(b).max(), 1.0)
    share = float((err > RTOL).mean())
    assert share <= 1e-2 and err.max() <= 2.0 ** -7, (share, err.max())
    return share, float(err.max())


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _vjp(port_fn, jax_fn, args, cts, bf16=False, n_out=1):
    """``(port outputs, port grads, JAX outputs, JAX grads)`` of the first
    ``n_out`` outputs with cotangents ``cts`` (the rest get zero), both
    under their mixed-precision scope when ``bf16``."""
    with jax_core.mixed_precision(enabled=bf16):
        ref, vjp = jax.vjp(jax_fn, *map(jnp.asarray, args))
        ref_t = ref if isinstance(ref, tuple) else (ref,)
        full = [jnp.asarray(c) for c in cts] + [
            jnp.zeros_like(r) for r in ref_t[len(cts):]]
        g_ref = vjp(tuple(full) if isinstance(ref, tuple) else full[0])
    t_args = [torch.from_numpy(a).requires_grad_() for a in args]
    with core.mixed_precision(enabled=bf16):
        got = port_fn(*t_args)
        got_t = got if isinstance(got, tuple) else (got,)
        torch.autograd.backward(got_t[:n_out],
                                [torch.from_numpy(c) for c in cts])
    return got_t, [t.grad for t in t_args], ref_t, g_ref


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# pointwise_matmul
# ---------------------------------------------------------------------------

def _pm_inputs(c_in, c_out, seed=0, bsz=2):
    rng = np.random.default_rng(seed)
    return ([_rand(rng, bsz, N, c_in), _rand(rng, c_in, c_out, scale=0.3),
             _rand(rng, c_out, scale=0.1)], [_rand(rng, bsz, N, c_out)])


def _port_pm(x, w, b):
    # The kernels take the weight as the [in, out] view of [out, in].
    return shared_mlp.pointwise_matmul(x, w.t().contiguous().t(), b)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c_in,c_out", [(3, 9), (64, 64), (128, 50)])
def test_pointwise_matmul_matches_jax(c_in, c_out, bf16):
    args, cts = _pm_inputs(c_in, c_out)
    got, grads, ref, g_ref = _vjp(_port_pm, jax_shared_mlp.pointwise_matmul,
                                  args, cts, bf16)
    _close(got[0], ref[0])
    for g, r in zip(grads, g_ref):
        _close(g, r)


def test_pointwise_matmul_bf16_rounds_where_jax_does():
    """Under the scope the forward and dx change (bf16 operands) and dw/db
    do not (fp32), on both sides."""
    args, cts = _pm_inputs(64, 64, seed=3)
    f32 = _vjp(_port_pm, jax_shared_mlp.pointwise_matmul, args, cts, False)
    b16 = _vjp(_port_pm, jax_shared_mlp.pointwise_matmul, args, cts, True)
    assert _rel(b16[0][0], f32[0][0]) > 1e-3
    assert _rel(b16[1][0], f32[1][0]) > 1e-3
    for i in (1, 2):
        assert torch.equal(b16[1][i], f32[1][i])


def test_pointwise_matmul_bf16_dw_fails_the_check(monkeypatch):
    """Control: a dw taken from bf16-rounded operands misses the JAX
    package's fp32 dw by more than the bound."""
    plain = shared_mlp.pm_dwdb_plain

    def bf16_dw(x, g):
        _, db = plain(x, g)
        dw, _ = plain(core.operand(x, True), core.operand(g, True))
        return dw, db

    monkeypatch.setattr(shared_mlp, "pm_dwdb_plain", bf16_dw)
    args, cts = _pm_inputs(64, 64, seed=1)
    _, grads, _, g_ref = _vjp(_port_pm, jax_shared_mlp.pointwise_matmul,
                              args, cts, True)
    assert _rel(grads[1], g_ref[1]) > 10 * RTOL


def test_pointwise_matmul_skips_dx_of_a_leaf_without_grad():
    """The first layer of the input T-Net sees the points, which take no
    gradient: no dx pass runs for them."""
    args, cts = _pm_inputs(3, 9)
    x = torch.from_numpy(args[0])
    w, b = (torch.from_numpy(a).requires_grad_() for a in args[1:])
    seen = []
    orig = shared_mlp.pm_dx
    shared_mlp.pm_dx = lambda *a: seen.append(1) or orig(*a)
    try:
        shared_mlp.pointwise_matmul(x, w, b).backward(
            torch.from_numpy(cts[0]))
    finally:
        shared_mlp.pm_dx = orig
    assert not seen and w.grad is not None and b.grad is not None


# ---------------------------------------------------------------------------
# tnet_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("k", [3, 64])
def test_tnet_apply_matches_jax(k, bf16):
    """fp32 in all three products, under the mixed-precision scope too."""
    rng = np.random.default_rng(k)
    t = (np.eye(k) + rng.normal(size=(2, k, k)) * 0.2).astype(np.float32)
    args, cts = [_rand(rng, 2, N, k), t], [_rand(rng, 2, N, k)]
    got, grads, ref, g_ref = _vjp(tnet_apply.tnet_apply, jax_tnet.tnet_apply,
                                  args, cts, bf16)
    _close(got[0], ref[0])
    for g, r in zip(grads, g_ref):
        _close(g, r)
    if bf16:   # the same values as the fp32 twin: nothing rounds to bf16
        x, tt = (torch.from_numpy(a) for a in args)
        assert torch.equal(got[0].detach(), tnet_apply.tnet_fwd_plain(x, tt))


# ---------------------------------------------------------------------------
# maxpool_points
# ---------------------------------------------------------------------------

def _dup_points(seed, c=9, bsz=3):
    """Clouds whose second half repeats the first: every max is attained
    twice; one channel is all zeros (a ReLU'd T-Net channel) and one is
    tied at its max on a run of points."""
    rng = np.random.default_rng(seed)
    x = _rand(rng, bsz, N, c)
    x[:, N - N // 2:] = x[:, :N // 2]
    x[:, :, 0] = 0.0
    x[:, 100:140, 1] = 7.0
    return x


def test_maxpool_points_matches_jax_with_duplicated_maxima():
    x = _dup_points(0)
    rng = np.random.default_rng(1)
    cts = [_rand(rng, x.shape[0], x.shape[2])]
    got, grads, ref, g_ref = _vjp(maxpool_points.maxpool_points,
                                  jax_maxpool.maxpool_points, [x], cts)
    _close(got[0], ref[0])
    _close(grads[0], g_ref[0])
    # One winner per (cloud, channel): the first point attaining the max.
    dx = grads[0].numpy()
    nz = dx != 0
    assert (nz.sum(1) == (cts[0] != 0)).all()
    first = np.argmax(x == x.max(1, keepdims=True), axis=1)
    np.testing.assert_array_equal(np.argmax(nz, axis=1), first)
    assert (first[:, 0] == 0).all() and (first[:, 1] == 100).all()


def test_maxpool_points_is_not_amax():
    """amax's gradient splits a tie between the points; the kernel's goes
    to the first one alone, as the JAX kernel's (and the reference's)."""
    x = torch.from_numpy(_dup_points(2)).requires_grad_()
    maxpool_points.maxpool_points(x).sum().backward()
    ours = x.grad.clone()
    x.grad = None
    x.amax(dim=1).sum().backward()
    assert not torch.equal(ours, x.grad)
    assert float(ours.max()) == 1.0 and float(x.grad.max()) < 1.0


def test_maxpool_points_reference_agrees():
    x = torch.from_numpy(_dup_points(3)).requires_grad_()
    maxpool_points.maxpool_points(x).sum().backward()
    g = x.grad.clone()
    x.grad = None
    maxpool_points.maxpool_points_reference(x).sum().backward()
    assert torch.equal(g, x.grad)


# ---------------------------------------------------------------------------
# fc_head_train
# ---------------------------------------------------------------------------

def _fc_inputs(k, seed=0, bsz=8):
    rng = np.random.default_rng(seed)
    widths = (1024, 512, 256, k * k)
    args = [np.abs(_rand(rng, bsz, widths[0]))]      # pooled ReLU features
    for i, (c_in, c_out) in enumerate(zip(widths[:-1], widths[1:])):
        args += [_rand(rng, c_in, c_out, scale=c_in ** -0.5),
                 _rand(rng, c_out, scale=0.1)]
        if i < 2:
            args += [rng.uniform(0.5, 1.5, c_out).astype(np.float32),
                     _rand(rng, c_out, scale=0.1)]
    rms = [_rand(rng, 512, scale=0.3), _rand(rng, 256, scale=0.3)]
    return args + rms, [_rand(rng, bsz, k * k)]


def _port_fc(*a):
    a = list(a)
    for i in (1, 5, 9):                  # weights as [in, out] views
        a[i] = a[i].t().contiguous().t()
    return fc_head_train.fc_head_train(*a)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("k", [3, 64])
def test_fc_head_train_matches_jax(k, bf16):
    args, cts = _fc_inputs(k)
    got, grads, ref, g_ref = _vjp(_port_fc, jax_fc_head.fc_head_train, args,
                                  cts, bf16)
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        _close(a, b)
    for i, (g, r) in enumerate(zip(grads[:11], g_ref[:11])):
        if bf16 and i in (1, 5):      # dw1, dw2: a rounded computed dz
            _close_rounded(g, r)
        else:
            _close(g, r)
    assert all(g is None for g in grads[11:])   # running means: constants


def test_fc_head_train_fp32_dw_under_bf16_fails(monkeypatch):
    """Control: dw1/dw2 from fp32 operands under the scope (the rest as
    it was) miss the JAX package's bf16 ones on far more than 1% of the
    elements."""
    bn_bwd = fc_head_train._bn_bwd
    monkeypatch.setattr(fc_head_train, "_bn_bwd",
                        lambda *a: bn_bwd(*a[:-1], False))
    args, cts = _fc_inputs(3, seed=6)
    _, grads, _, g_ref = _vjp(_port_fc, jax_fc_head.fc_head_train, args, cts,
                              True)
    for i in (1, 5):
        with pytest.raises(AssertionError):
            _close_rounded(grads[i], g_ref[i])


def _drop_statistic_terms(dh2, h, z1, z2, w1, w2, g1, be1, g2, be2, mu1,
                          inv1, mu2, inv2, bf16=False):
    """The planted fault: both BN layers' dz without the batch-statistic
    terms (dz = g * inv * dy), everything else as the plain pass."""
    def layer(dh, z, mu, inv, g, be, prev):
        zhat = (z - mu) * inv
        dy = dh * (torch.relu(zhat * g + be) > 0)
        dz = (g * inv) * dy
        dw = torch.matmul(core.operand(prev, bf16).t(),
                          core.operand(dz, bf16))
        return dz, dw, dz.sum(0), (dy * zhat).sum(0), dy.sum(0)
    h1 = fc_head_train.recompute_h(z1, mu1, inv1, g1, be1)
    dz2, dw2, db2, dg2, dbe2 = layer(dh2, z2, mu2, inv2, g2, be2, h1)
    dz1, dw1, db1, dg1, dbe1 = layer(torch.matmul(dz2, w2.t()), z1, mu1,
                                     inv1, g1, be1, h)
    return (torch.matmul(dz1, w1.t()), dw1, db1, dg1, dbe1, dw2, db2, dg2,
            dbe2)


def test_fc_head_train_without_statistic_terms_fails(monkeypatch):
    """Control: the backward without the batch-statistic gradient terms
    misses the JAX package's gradients of h, w1 and w2 far above the
    bound."""
    monkeypatch.setattr(fc_head_train, "fc_head_bwd_plain",
                        _drop_statistic_terms)
    args, cts = _fc_inputs(3, seed=4)
    _, grads, _, g_ref = _vjp(_port_fc, jax_fc_head.fc_head_train, args, cts)
    assert min(_rel(grads[i], g_ref[i]) for i in (0, 1, 5)) > 10 * RTOL


def test_fc_head_train_reference_agrees():
    """The explicit backward against autograd through the batch
    statistics of the plain composition (relative L2, a different
    algorithm)."""
    args, cts = _fc_inputs(64, seed=5)
    outs = []
    for fn in (fc_head_train.fc_head_train,
               fc_head_train.fc_head_train_reference):
        t = [torch.from_numpy(a).requires_grad_() for a in args]
        fn(*t)[0].backward(torch.from_numpy(cts[0]))
        outs.append([x.grad for x in t[:11]])
    # b1 and b2 precede a batch-statistic BN: their gradient is zero in
    # exact arithmetic, both sides' rounding of a cancelling sum, held to
    # the norm of the same layer's weight gradient.
    for i, (a, b) in enumerate(zip(*outs)):
        denom = outs[1][{2: 1, 6: 5}.get(i, i)].norm()
        assert float((a - b).norm() / denom) < 1e-4, i


# ---------------------------------------------------------------------------
# Glue
# ---------------------------------------------------------------------------

def _unbuildable():
    raise AssertionError("a CPU tensor reached the kernel library")


def test_cpu_passes_skip_the_library(monkeypatch):
    """CPU tensors run every pass's plain twin: the library is never built
    and no launch is counted."""
    monkeypatch.setattr(build, "library", _unbuildable)
    passes = (list(shared_mlp.PM_PASSES.values())
              + list(tnet_apply.PASSES.values())
              + list(maxpool_points.PASSES.values())
              + list(fc_head_train.PASSES.values()))
    before = [p.launches for p in passes]
    args, cts = _pm_inputs(3, 9)
    _vjp(_port_pm, jax_shared_mlp.pointwise_matmul, args, cts)
    x = torch.from_numpy(_dup_points(0)).requires_grad_()
    maxpool_points.maxpool_points(x).sum().backward()
    a, c = _fc_inputs(3)
    t = [torch.from_numpy(v).requires_grad_() for v in a]
    fc_head_train.fc_head_train(*t)[0].backward(torch.from_numpy(c[0]))
    tnet_apply.tnet_apply(x[:, :, :3], torch.eye(3).expand(3, 3, 3).clone()
                          .requires_grad_()).sum().backward()
    assert [p.launches for p in passes] == before


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        maxpool_points.maxpool_fwd(torch.zeros(2, 3, 4, device="meta"))
