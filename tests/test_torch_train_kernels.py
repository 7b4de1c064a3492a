"""The port's training kernels against the JAX package's.

Each port function (``trunk2_train``, ``seg_head_train``,
``relu_fc_bn_relu`` / ``pool_fc_epilogue``) runs on the CPU, where every
CUDA pass takes its plain PyTorch twin and the autograd glue around the
passes is the port's own; the JAX side runs its Pallas kernels in
interpret mode (``tests/conftest.py``). Both get the same numpy-seeded
inputs at the narrow widths of ``tests/test_kernels.py``. Outputs,
statistics and every gradient (of ``sum(sin(out))``) are compared at
``1e-4 * max(1, |ref|)``: fp32 programs that differ by summation order.
``chip_smoke.py`` holds the CUDA passes against the same plain twins on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    pool_fc_epilogue as jax_pool_fc,
    seg_head_train as jax_seg_head,
    trunk_train as jax_trunk,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import build
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    pool_fc_epilogue, seg_head_train, trunk_train,
)

RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=RTOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0)


def _compare(port_fn, jax_fn, args, n_out, jax_kwargs=None, port_kwargs=None):
    """Outputs and the gradients of ``sum(sin(out[0]))`` with respect to
    every argument, port against JAX."""
    jax_kwargs, port_kwargs = jax_kwargs or {}, port_kwargs or {}
    j_args = [jnp.asarray(a) for a in args]
    t_args = [torch.from_numpy(a).requires_grad_() for a in args]
    ref = jax_fn(*j_args, **jax_kwargs)
    got = port_fn(*t_args, **port_kwargs)
    assert len(got) == n_out
    for a, b in zip(got, ref):
        _close(a, b)
    idxs = tuple(range(len(args)))
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_fn(*a, **jax_kwargs)[0])),
                     argnums=idxs)(*j_args)
    torch.sin(got[0]).sum().backward()
    for t, g in zip(t_args, g_ref):
        _close(t.grad, g)


def _trunk_args(n, seed=0, dup=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((2, n, 16)).astype(f)
    if dup:  # every odd point repeats the even one before it: max ties
        x[:, 1::2] = x[:, 0:n - n % 2:2]
    c2, c3 = 32, 64
    return (x, (rng.standard_normal((16, c2)) * 0.2).astype(f),
            (rng.standard_normal(c2) * 0.1).astype(f),
            rng.uniform(0.5, 1.5, c2).astype(f),
            (rng.standard_normal(c2) * 0.1).astype(f),
            (rng.standard_normal((c2, c3)) * 0.2).astype(f),
            (rng.standard_normal(c3) * 0.1).astype(f),
            # Negative gammas: the pool switches to the channel min.
            (rng.uniform(0.5, 1.5, c3)
             * np.where(rng.random(c3) < 0.3, -1, 1)).astype(f),
            (rng.standard_normal(c3) * 0.1).astype(f))


@pytest.mark.parametrize("n,dup", [(128, False), (130, False), (128, True)],
                         ids=["tileable", "untileable", "ties"])
def test_trunk2_train_matches_jax(n, dup):
    _compare(trunk_train.trunk2_train, jax_trunk.trunk2_train,
             _trunk_args(n, dup=dup), 5)


def test_trunk2_train_ties_take_the_first_point():
    """With duplicated points the pooled gradient lands on the first of
    each tied pair, as in the JAX kernel (and torch's max)."""
    args = [torch.from_numpy(a) for a in _trunk_args(128, seed=3, dup=True)]
    bsz, n = args[0].shape[:2]
    with torch.no_grad():
        z2, s2, ss2 = trunk_train.f1(*args[:3])
        mu2, var2, inv2 = core.batch_moments(s2, ss2, bsz * n)
        sc2 = args[3] * inv2
        out = trunk_train.f2(z2, sc2, args[4] - mu2 * sc2, *args[5:7])
    imax, imin = out[4], out[5]
    assert (imax % 2 == 0).all() and (imin % 2 == 0).all()


def _head_args(n, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32

    def a(*s):
        return (rng.standard_normal(s) * 0.2).astype(f)

    def gam(c):
        return rng.uniform(0.5, 1.5, c).astype(f)

    cpf, c1, c2, c3, k = 16, 64, 48, 32, 10
    return (a(2, n, cpf), a(2, 96), a(cpf + 96, c1), a(c1), gam(c1), a(c1),
            a(c1, c2), a(c2), gam(c2), a(c2), a(c2, c3), a(c3), gam(c3), a(c3),
            a(c3, k), a(k))


@pytest.mark.parametrize("n", [128, 130], ids=["tileable", "untileable"])
def test_seg_head_train_matches_jax(n):
    _compare(seg_head_train.seg_head_train, jax_seg_head.seg_head_train,
             _head_args(n), 7)


def _pool_args(seed, bsz=8, c3=64, c1=32):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((bsz, c3)).astype(f),
            (rng.standard_normal((c3, c1)) * 0.2).astype(f),
            (rng.standard_normal(c1) * 0.1).astype(f),
            rng.uniform(0.5, 1.5, c1).astype(f),
            (rng.standard_normal(c1) * 0.1).astype(f),
            (rng.standard_normal(c1) * 0.3).astype(f))


@pytest.mark.parametrize("groups", [1, 2])
def test_relu_fc_bn_relu_matches_jax(groups):
    *args, rm1 = _pool_args(groups)
    _compare(pool_fc_epilogue.relu_fc_bn_relu, jax_pool_fc.relu_fc_bn_relu,
             args, 3, jax_kwargs=dict(rm1=jnp.asarray(rm1), groups=groups),
             port_kwargs=dict(rm1=torch.from_numpy(rm1), groups=groups))


@pytest.mark.parametrize("groups", [1, 2])
def test_pool_fc_epilogue_matches_jax(groups):
    """The general entry: the max/min pair selected by the sign of BN3's
    scale (negative entries included) and the pool affine."""
    rng = np.random.default_rng(10 + groups)
    mx, w1, b1, g1, be1, rm1 = _pool_args(groups)
    mn = mx - np.abs(rng.standard_normal(mx.shape)).astype(np.float32)
    s3c = (rng.uniform(0.5, 1.5, mx.shape[1])
           * np.where(rng.random(mx.shape[1]) < 0.3, -1, 1)).astype(np.float32)
    t3 = (rng.standard_normal(mx.shape[1]) * 0.1).astype(np.float32)
    _compare(pool_fc_epilogue.pool_fc_epilogue, jax_pool_fc.pool_fc_epilogue,
             (mx, mn, s3c, t3, w1, b1, g1, be1), 4,
             jax_kwargs=dict(rm1=jnp.asarray(rm1), groups=groups),
             port_kwargs=dict(rm1=torch.from_numpy(rm1), groups=groups))


@pytest.mark.parametrize("name", ["trunk2_train", "seg_head_train",
                                  "pool_fc_epilogue"])
def test_autograd_functions_match_plain_references(name):
    """Each autograd function (the passes and their glue) against the
    whole function composed in plain PyTorch under autograd: outputs,
    statistics and all gradients."""
    if name == "trunk2_train":
        args, fn, ref = (_trunk_args(130, seed=5), trunk_train.trunk2_train,
                         trunk_train.trunk2_train_reference)
    elif name == "seg_head_train":
        args, fn, ref = (_head_args(130, seed=5),
                         seg_head_train.seg_head_train,
                         seg_head_train.seg_head_train_reference)
    else:
        mx, *rest, rm1 = _pool_args(5)
        args = (mx, mx - 1, np.linspace(-1, 1, mx.shape[1], dtype=np.float32),
                np.full(mx.shape[1], 0.1, np.float32), *rest)
        fn, ref = (pool_fc_epilogue.pool_fc_epilogue,
                   pool_fc_epilogue.pool_fc_epilogue_reference)
    grads = []
    for f in (fn, ref):
        t_args = [torch.from_numpy(a).requires_grad_() for a in args]
        out = f(*t_args)
        torch.sin(out[0]).sum().backward()
        grads.append((out, [t.grad for t in t_args]))
    (out, g), (out_ref, g_ref) = grads
    for a, b in zip(out, out_ref):
        _close(a, b)
    for a, b in zip(g, g_ref):
        _close(a, b)


def _zeroed(fn, positions):
    """``fn`` with the arguments at ``positions`` replaced by zeros."""
    def wrapped(*args):
        args = list(args)
        for i in positions:
            args[i] = torch.zeros_like(args[i])
        return fn(*args)
    return wrapped


@pytest.mark.parametrize("name", ["trunk2_train", "seg_head_train"])
def test_whole_function_check_catches_missing_statistic_terms(name,
                                                              monkeypatch):
    """A planted fault: the backward passes lose the BN statistic-gradient
    terms of ``dz`` (trunk B1's ``coef1``/``coef2``, the head's Bmid and
    B1 ``c1``/``c2``). ``chip_smoke.py``'s whole-function check (relative
    L2 error of each gradient against the plain reference, at most
    ``WHOLE_BOUND``) must then fail on the input gradient and on every
    weight gradient in front of the faulty BN, while the intact functions
    pass it by far (the test above)."""
    from chip_smoke import WHOLE_BOUND

    if name == "trunk2_train":
        monkeypatch.setattr(trunk_train, "b1",
                            _zeroed(trunk_train.b1, (7, 8)))
        args, fn, ref = (_trunk_args(130, seed=5), trunk_train.trunk2_train,
                         trunk_train.trunk2_train_reference)
        hit = (0, 1, 5)            # dx, dw2, dw3
    else:
        monkeypatch.setattr(seg_head_train, "bmid",
                            _zeroed(seg_head_train.bmid, (5, 6)))
        monkeypatch.setattr(seg_head_train, "b1",
                            _zeroed(seg_head_train.b1, (5, 6)))
        args, fn, ref = (_head_args(130, seed=5),
                         seg_head_train.seg_head_train,
                         seg_head_train.seg_head_train_reference)
        hit = (0, 1, 2, 6, 10)     # dpf, dg, dw1, dw2, dw3
    grads = []
    for f in (fn, ref):
        t_args = [torch.from_numpy(a).requires_grad_() for a in args]
        torch.sin(f(*t_args)[0]).sum().backward()
        grads.append([t.grad.double() for t in t_args])
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(*grads)]
    assert min(rel[i] for i in hit) > WHOLE_BOUND, rel


def _unbuildable():
    raise AssertionError("a CPU tensor reached the kernel library")


def test_cpu_training_passes_skip_the_library(monkeypatch):
    """CPU tensors run every training pass's plain twin: the kernel
    library is never built and no launch is counted."""
    monkeypatch.setattr(build, "library", _unbuildable)
    passes = (list(trunk_train.PASSES.values())
              + list(seg_head_train.PASSES.values())
              + [pool_fc_epilogue.pool_fc_fwd])
    counts = [p.launches for p in passes]
    _compare(trunk_train.trunk2_train, jax_trunk.trunk2_train,
             _trunk_args(64, seed=7), 5)
    t_args = [torch.from_numpy(a).requires_grad_()
              for a in _head_args(64, seed=7)]
    seg_head_train.seg_head_train(*t_args)[0].sum().backward()
    g = torch.rand(4, 16, requires_grad=True)
    pool_fc_epilogue.relu_fc_bn_relu(g, torch.rand(16, 8), torch.zeros(8),
                                     torch.ones(8), torch.zeros(8))[0].sum(
                                         ).backward()
    assert [p.launches for p in passes] == counts


def test_trunk_refuses_groups_that_do_not_split_the_batch():
    """``trunk2_train`` refuses a grouping that does not split the batch
    into equal streams (0 groups, or 3 for a batch of 8); the paired
    trunks' ``groups=2`` itself is held in
    ``tests/test_torch_paired_trunks.py``."""
    args = [torch.from_numpy(a) for a in _trunk_args(8)]
    for groups in (0, 3):
        with pytest.raises(ValueError, match="does not split"):
            trunk_train.trunk2_train(*args, groups=groups)


def test_argument_structs_mirror_the_cuda_header():
    """The ctypes structures the wrappers fill match the C structs of
    ``csrc/train_gemm.cuh``, ``csrc/pool_fc_epilogue.cu``,
    ``csrc/disc_fused.cuh`` and the per-layer training kernels' sources
    field for field (names, order, int or pointer): a mismatch would pass
    garbage to the card silently."""
    import ctypes
    import pathlib
    import re

    from adversarial_learning_on_pointclouds_tpu_torch.ops import launch

    for struct, source in ((launch.RowFwdArgs, "train_gemm.cuh"),
                           (launch.BwdArgs, "train_gemm.cuh"),
                           (launch.PoolFcArgs, "pool_fc_epilogue.cu"),
                           (launch.DiscArgs, "disc_fused.cuh"),
                           (launch.PmArgs, "pointwise_matmul.cu"),
                           (launch.TnetArgs, "tnet_apply.cu"),
                           (launch.MaxpoolArgs, "maxpool_points.cu"),
                           (launch.FcHeadArgs, "fc_head_train.cu")):
        header = (pathlib.Path(build.CSRC) / source).read_text()
        body = re.search(r"struct %s \{(.*?)\};" % struct.__name__, header,
                         re.S).group(1)
        want = []
        for decl in re.findall(r"^\s*([^/\n][^;]*);", body, re.M):
            kind = "ptr" if "*" in decl else "int"
            names = decl.split("*")[-1] if kind == "ptr" else decl[3:]
            want += [(n.strip(), kind) for n in names.split(",")]
        got = [(n, "int" if t is ctypes.c_int else "ptr")
               for n, t in struct._fields_]
        assert got == want, struct.__name__
    # The tensor-core passes' scratch (csrc/train_bwd_tc.cu): dz and h
    # for dW = dz^T h on the GEMM core.
    assert [n for n, _ in launch.BwdArgs._fields_][-2:] == ["dzs", "hs"]
    # The disc's weight-gradient pass (csrc/disc_tc.cu): a split count per
    # dW product, the row pass's partials and scratch, the products'
    # partials.
    disc = [n for n, _ in launch.DiscArgs._fields_]
    assert disc[3:7] == ["split1", "split2", "split3", "split4"]
    assert disc[-4:] == ["part", "dzs", "hs", "part_w"]


def test_row_tiles_mirror_the_cuda_sources():
    """The wrappers size the per-block partials (``part``) by the rows a
    block of the row kernels owns (the generator's passes all on the
    tensor cores, the disc's backward row pass); a tile in Python smaller
    than the C one would let the kernels write past the end of ``part``."""
    import pathlib
    import re

    from adversarial_learning_on_pointclouds_tpu_torch.ops import launch

    for tile, name, source in ((launch.TC_TILE, "kTcRows",
                                "train_bwd_tc.cu"),
                               (launch.DISC_TILE, "kDwRows", "disc_tc.cu")):
        text = (pathlib.Path(build.CSRC) / source).read_text()
        value = re.search(r"constexpr int %s = (\d+);" % name, text)
        assert value and int(value.group(1)) == tile, name


def test_weight_views():
    """Weights reach the kernels as [in, out] views of row-major [out,
    in] storage, row slices included (W1[:64] of the 1088-wide head)."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops import launch

    cpu = torch.device("cpu")
    w1 = torch.zeros(512, 1088).t()               # [1088, 512] view
    assert launch.weight_ld("w1a", w1[:64], (64, 512), cpu) == 1088
    assert launch.weight_ld("w1", w1, (1088, 512), cpu) == 1088
    with pytest.raises(ValueError, match="view of row-major"):
        launch.weight_ld("w", w1.contiguous(), (1088, 512), cpu)
    with pytest.raises(TypeError, match="int32"):
        launch.expect("idx", torch.zeros(2, 3), (2, 3), cpu,
                      dtype=torch.int32)
