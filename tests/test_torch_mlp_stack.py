"""``fused_mlp_stack`` and the inference-only discriminator, port against
the JAX package.

* ``fused_mlp_stack_plain`` (what a CPU tensor runs) against the JAX
  package's ``fused_mlp_stack`` (its ``pallas_call`` in interpret mode)
  on the same numpy-seeded inputs, within 1e-5 of the output's scale:
  the JAX test's 3-layer chain, the discriminator's 5-layer chain with
  non-unit scales, a ReLU chain, and a ragged N (67, which the JAX kernel
  takes only as one full-width block); in fp32, and under each package's
  mixed-precision scope (bf16 operands, fp32 sums) within 1e-3 of the
  scale, as the bf16 passes of ``tests/test_torch_bench_step.py``: one
  operand that rounds to its other bf16 neighbour on one side moves a sum
  by one bf16 step of one term.
* ``FCDiscriminator.infer`` against the JAX package's
  ``apply_discriminator_fused`` on converted weights, and against the
  port's own ``forward``.
* No autograd: ``infer``'s logits have no ``grad_fn``, and
  ``fused_mlp_stack`` raises when grad is enabled and an input or weight
  requires it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import (
    apply_discriminator_fused as jax_apply_discriminator_fused,
    core as jax_core, init_discriminator,
)
from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    shared_mlp as jax_shared_mlp,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    FCDiscriminator, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    shared_mlp,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import convert

RTOL = 1e-5
BF16_RTOL = 1e-3
B, N, PARTS = 2, 64, 50
D_WIDTHS = (PARTS, 64, 128, 256, 512, 1)
D_ACTS = ("leaky_relu",) * 4 + (None,)
CHAINS = {
    # tests/test_kernels.py::test_fused_mlp_stack_matches_layerwise
    "jax-test": ((PARTS, 64, 128, 1), ("leaky_relu", "leaky_relu", None),
                 False, N),
    "disc-scaled": (D_WIDTHS, D_ACTS, True, N),
    "relu": ((32, 96, 64, 16), ("relu", "relu", "relu"), True, N),
    "ragged-N67": (D_WIDTHS, D_ACTS, True, 67),
}


def _chain(name, seed=0):
    widths, acts, scaled, n = CHAINS[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, n, widths[0])).astype(np.float32)
    ws, shifts, scales = [], [], []
    for c_in, c_out in zip(widths, widths[1:]):
        ws.append(rng.uniform(-1, 1, (c_in, c_out)).astype(np.float32)
                  * c_in ** -0.5)
        shifts.append(rng.normal(0, 0.1, c_out).astype(np.float32))
        scales.append(rng.uniform(0.5, 1.5, c_out).astype(np.float32)
                      if scaled else np.ones(c_out, np.float32))
    return x, ws, shifts, scales, list(acts)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(CHAINS))
def test_plain_stack_matches_jax(name, bf16):
    x, ws, shifts, scales, acts = _chain(name)
    with jax_core.mixed_precision(enabled=bf16):
        want = jax_shared_mlp.fused_mlp_stack(
            jnp.asarray(x), [jnp.asarray(w) for w in ws],
            [jnp.asarray(s) for s in shifts],
            [jnp.asarray(s) for s in scales], acts)
    with core.mixed_precision(enabled=bf16):
        got = shared_mlp.fused_mlp_stack(torch.from_numpy(x), _t(ws),
                                         _t(shifts), _t(scales), acts)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= (BF16_RTOL if bf16 else RTOL)
    if bf16:   # the scope rounded: fp32 operands land elsewhere
        fp32 = shared_mlp.fused_mlp_stack_plain(torch.from_numpy(x), _t(ws),
                                                _t(shifts), _t(scales), acts)
        assert _rel(got.numpy(), fp32.numpy()) > 10 * RTOL


@pytest.fixture(scope="module")
def discriminators():
    import jax

    params = jax.tree_util.tree_map(
        np.array, init_discriminator(jax.random.PRNGKey(1), PARTS))
    model = FCDiscriminator(PARTS)
    model.load_state_dict(convert.discriminator_state_dict(params),
                          strict=True)
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (B, 67, PARTS)).astype(np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    return params, model.train(), probs


def test_infer_matches_jax_and_forward(discriminators):
    params, model, probs = discriminators
    want = jax_apply_discriminator_fused(params, jnp.asarray(probs))
    x = torch.from_numpy(probs)
    got = model.infer(x)
    assert got.shape == (B, 67, 1)
    assert _rel(got.numpy(), want) <= RTOL
    assert _rel(got.numpy(), model(x).detach().numpy()) <= RTOL


def test_infer_and_stack_have_no_backward(discriminators):
    _, model, probs = discriminators
    x = torch.from_numpy(probs).requires_grad_()
    out = model.infer(x)
    assert out.grad_fn is None and not out.requires_grad
    assert all(p.grad is None for p in model.parameters())
    ws, bs = model._params()
    ones = [torch.ones_like(b) for b in bs]
    with pytest.raises(RuntimeError, match="no backward"):
        shared_mlp.fused_mlp_stack(x.detach(), ws, bs, ones, D_ACTS)
    with pytest.raises(RuntimeError, match="no backward"):
        shared_mlp.fused_mlp_stack(
            x, [w.detach() for w in ws], [b.detach() for b in bs], ones,
            D_ACTS)
    with torch.no_grad():
        shared_mlp.fused_mlp_stack(x, ws, bs, ones, D_ACTS)


def test_stack_refuses_mismatched_layers():
    x, ws, shifts, scales, acts = _chain("jax-test")
    with pytest.raises(ValueError, match="one shift, scale and act"):
        shared_mlp.fused_mlp_stack(torch.from_numpy(x), _t(ws),
                                   _t(shifts[:-1]), _t(scales), acts)
    with pytest.raises(ValueError, match="unknown activation"):
        shared_mlp.fused_mlp_stack(torch.from_numpy(x), _t(ws), _t(shifts),
                                   _t(scales), ["gelu"] * len(ws))
