"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version (the CUDA
kernels run only on the card: ``chip_smoke.py`` holds them against these
same plain versions there), and the JAX kernels run in Pallas interpret
mode (``tests/conftest.py``). Both sides get the same numpy-seeded
inputs. Bound: ``2e-5 * max(1, |ref|)``, fp32 reduction order, as in
``tests/test_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    encoder_fused as jax_encoder_fused,
    shared_mlp as jax_shared_mlp,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import build, launch
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    encoder_fused, shared_mlp,
)

B = 2
RTOL = 2e-5
N_CASES = [128, 100]  # tileable, and untileable (the TPU kernels pad it)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0)


def _layer(rng, c_in, c_out):
    """numpy ``([out, in] weight, shift, scale)``: torch's layout, with a
    non-trivial folded-BN affine."""
    bound = c_in ** -0.5
    w = rng.uniform(-bound, bound, (c_out, c_in)).astype(np.float32)
    shift = rng.normal(0, 0.1, c_out).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    return w, shift, scale


def _jax_args(layer):
    w, shift, scale = layer
    return jnp.asarray(w.T), jnp.asarray(shift), jnp.asarray(scale)


def _torch_args(layer):
    w, shift, scale = layer
    # [in, out] view of [out, in] storage: what the models pass.
    return (torch.from_numpy(w).t(), torch.from_numpy(shift),
            torch.from_numpy(scale))


@pytest.mark.parametrize("n", N_CASES)
@pytest.mark.parametrize("act", ["relu", "leaky_relu", None])
def test_fused_linear_affine_act_matches_jax(n, act):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, n, 3)).astype(np.float32)
    layer = _layer(rng, 3, 64)
    ref = jax_shared_mlp.fused_linear_affine_act(jnp.asarray(x),
                                                 *_jax_args(layer), act)
    got = shared_mlp.fused_linear_affine_act(torch.from_numpy(x),
                                             *_torch_args(layer), act)
    _close(got, ref)


STACKS = {
    # T-Net trunks (STN3d; STNkd is the same with c0 = 64).
    "tnet": ((3, 64, 128, 1024), ("relu", "relu", "relu")),
    # Encoder trunk: bn3 has no ReLU before the pool.
    "trunk": ((64, 128, 1024), ("relu", None)),
}


@pytest.mark.parametrize("n", N_CASES)
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_fused_stack_maxpool_matches_jax(n, stack):
    widths, acts = STACKS[stack]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, n, widths[0])).astype(np.float32)
    layers = [_layer(rng, a, b) for a, b in zip(widths[:-1], widths[1:])]
    jw, jsh, jsc = zip(*map(_jax_args, layers))
    tw, tsh, tsc = zip(*map(_torch_args, layers))
    ref = jax_encoder_fused.fused_stack_maxpool(jnp.asarray(x), jw, jsh, jsc,
                                                acts)
    got = encoder_fused.fused_stack_maxpool(torch.from_numpy(x), tw, tsh, tsc,
                                            acts)
    assert got.shape == (B, widths[-1])
    _close(got, ref)


@pytest.mark.parametrize("n", N_CASES)
def test_seg_head_fused_matches_jax(n):
    rng = np.random.default_rng(2)
    pf = np.maximum(rng.normal(size=(B, n, 64)), 0).astype(np.float32)
    g = rng.normal(size=(B, 1024)).astype(np.float32)
    layers = [_layer(rng, a, b)
              for a, b in ((1088, 512), (512, 256), (256, 128))]
    w4, b4, _ = _layer(rng, 128, 50)
    ref = jax_encoder_fused.seg_head_fused(
        jnp.asarray(pf), jnp.asarray(g),
        *[a for layer in layers for a in _jax_args(layer)],
        jnp.asarray(w4.T), jnp.asarray(b4))
    got = encoder_fused.seg_head_fused(
        torch.from_numpy(pf), torch.from_numpy(g),
        *[a for layer in layers for a in _torch_args(layer)],
        torch.from_numpy(w4).t(), torch.from_numpy(b4))
    assert got.shape == (B, n, 50)
    _close(got, ref)


def _unbuildable():
    raise AssertionError("a CPU tensor reached the kernel library")


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    """The device is the whole switch: CPU tensors never touch the
    kernel library or the launch counts."""
    monkeypatch.setattr(build, "library", _unbuildable)
    wrappers = (shared_mlp.fused_linear_affine_act,
                encoder_fused.fused_stack_maxpool, encoder_fused.seg_head_fused)
    counts = [w.launches for w in wrappers]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(B, 40, 64)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, 1024)).astype(np.float32))
    l64, l1088, l512, l256 = (_torch_args(_layer(rng, a, b)) for a, b in
                              ((64, 64), (1088, 512), (512, 256), (256, 128)))
    w4 = torch.from_numpy(_layer(rng, 128, 50)[0]).t()
    b4 = torch.zeros(50)

    got = shared_mlp.fused_linear_affine_act(x, *l64, "relu")
    assert torch.equal(got, shared_mlp.fused_linear_affine_act_plain(
        x, *l64, "relu"))
    stack = (x, (l64[0],), (l64[1],), (l64[2],), (None,))
    assert torch.equal(encoder_fused.fused_stack_maxpool(*stack),
                       encoder_fused.fused_stack_maxpool_plain(*stack))
    head = (x, g, *l1088, *l512, *l256, w4, b4)
    assert torch.equal(encoder_fused.seg_head_fused(*head),
                       encoder_fused.seg_head_fused_plain(*head))
    assert [w.launches for w in wrappers] == counts


def test_devices_without_a_kernel_raise():
    x = torch.empty(B, 8, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        shared_mlp.fused_linear_affine_act(x, x[0].t(), x[0, 0], x[0, 0],
                                           "relu")


def test_operand_checks():
    """What a CUDA launch checks before a pointer leaves Python."""
    cpu = torch.device("cpu")
    w = torch.zeros(64, 3)  # [out, in] storage
    launch.expect("w", w.t(), (3, 64), cpu, weight=True)
    with pytest.raises(ValueError, match="view of a row-major"):
        launch.expect("w", w.t().contiguous(), (3, 64), cpu, weight=True)
    with pytest.raises(ValueError, match="contiguous"):
        launch.expect("x", torch.zeros(4, 6)[:, ::2], (4, 3), cpu)
    with pytest.raises(TypeError, match="float32"):
        launch.expect("x", torch.zeros(4, 3, dtype=torch.float64), (4, 3),
                      cpu)
    with pytest.raises(ValueError, match="shape"):
        launch.expect("x", torch.zeros(4, 3), (4, 4), cpu)
    with pytest.raises(ValueError, match="unknown activation"):
        launch.act_code("gelu")
    with pytest.raises(RuntimeError, match="no backward"):
        launch.no_grad(torch.zeros(2, requires_grad=True))
