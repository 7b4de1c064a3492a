"""The port's paired trunks (``trunk2_train(groups=2)``, ``paired_trunks``)
against the JAX package's.

* ``trunk2_train(groups=2)`` on the CPU (each pass's plain twin) against
  the JAX ``trunk2_train(groups=2)`` with its Pallas kernels in interpret
  mode: the pooled output, the ``[2, C]`` statistics and every gradient
  (of ``sum(sin(pooled))``) at ``1e-4 * max(1, |ref|)``, the bound of
  ``tests/test_torch_train_kernels.py`` (fp32 programs that differ in
  summation order).
* Its pooled values and statistics equal two groups=1 calls bit for bit,
  in fp32 and under the mixed-precision scope, as the JAX docstring
  states (``trunk_train.py:405-415``).
* The port's G+D step with ``paired_trunks`` against its paired-heads
  step (the JAX ``tests/test_round4.py::
  test_paired_trunks_step_matches_paired_heads``): the forward does not
  change, so every metric is equal; the gradients differ in summation
  order only (within ``1e-4 * (1 + max|g|)``).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    trunk_train as jax_trunk,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    trunk_train,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import adversarial

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
    np.testing.assert_allclose(a, b, atol=rtol * max(np.abs(b).max(), 1.0),
                               rtol=0)


def _args(n, seed=0, bsz=4):
    """Two streams of ``bsz // 2`` clouds at the narrow widths of the JAX
    package's own trunk test (16 -> 32 -> 64), negative BN3 gammas."""
    rng = np.random.default_rng(seed)
    f = np.float32
    c2, c3 = 32, 64
    return (rng.standard_normal((bsz, n, 16)).astype(f),
            (rng.standard_normal((16, c2)) * 0.2).astype(f),
            (rng.standard_normal(c2) * 0.1).astype(f),
            rng.uniform(0.5, 1.5, c2).astype(f),
            (rng.standard_normal(c2) * 0.1).astype(f),
            (rng.standard_normal((c2, c3)) * 0.2).astype(f),
            (rng.standard_normal(c3) * 0.1).astype(f),
            (rng.uniform(0.5, 1.5, c3)
             * np.where(rng.random(c3) < 0.3, -1, 1)).astype(f),
            (rng.standard_normal(c3) * 0.1).astype(f))


@pytest.mark.parametrize("n", [128, 130], ids=["tileable", "ragged"])
def test_trunk2_train_groups2_matches_jax(n):
    args = _args(n)
    j_args = [jnp.asarray(a) for a in args]
    t_args = [torch.from_numpy(a).requires_grad_() for a in args]
    ref = jax_trunk.trunk2_train(*j_args, groups=2)
    got = trunk_train.trunk2_train(*t_args, groups=2)
    assert got[1].shape == (2, 32) and got[3].shape == (2, 64)
    for a, b in zip(got, ref):
        _close(a, b)
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.sin(
        jax_trunk.trunk2_train(*a, groups=2)[0])),
        argnums=tuple(range(len(args))))(*j_args)
    torch.sin(got[0]).sum().backward()
    for t, g in zip(t_args, g_ref):
        _close(t.grad, g)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_groups2_equals_two_calls(bf16):
    x, *rest = (torch.from_numpy(a) for a in _args(130, seed=1))
    with torch.no_grad(), core.mixed_precision(enabled=bf16):
        whole = trunk_train.trunk2_train(x, *rest, groups=2)
        parts = [trunk_train.trunk2_train(x[s], *rest)
                 for s in (slice(0, 2), slice(2, 4))]
    assert torch.equal(whole[0], torch.cat([p[0] for p in parts]))
    for i in range(1, 5):
        assert torch.equal(whole[i], torch.stack([p[i] for p in parts]))


def _step(cfg, g, d, batch):
    state = adversarial.create_state(cfg, 10, device="cpu", g_model=g,
                                     d_model=d)
    txs = adversarial.make_txs(cfg, 10)
    metrics = adversarial.train_step(state, *batch, cfg=cfg, g_tx=txs[0],
                                     d_tx=txs[1])
    return metrics, state


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_paired_trunks_step_matches_paired_heads(bf16):
    cfg = AdversarialConfig(num_points=64, batch_size=4, bf16=bf16,
                            augment=True, pallas_augment=True)
    gen = torch.Generator().manual_seed(5)
    x_l = torch.randn(4, 64, 3, generator=gen)
    x_u = torch.randn(4, 64, 3, generator=gen)
    y_l = torch.randint(0, 50, (4, 64), generator=gen)
    probe = adversarial.create_state(cfg, 10, device="cpu")
    runs = {}
    for paired in (False, True):
        c = dataclasses.replace(cfg, paired_trunks=paired)
        runs[paired] = _step(c, copy.deepcopy(probe.g_model),
                             copy.deepcopy(probe.d_model), (x_l, y_l, x_u))
    (m_ph, s_ph), (m_pt, s_pt) = runs[False], runs[True]
    for k in m_ph:
        assert torch.equal(m_pt[k], m_ph[k]), k
    want = dict(s_ph.g_model.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in want.values())
    for k, p in s_pt.g_model.named_parameters():
        assert float((p.grad - want[k].grad).abs().max()) <= \
            1e-4 * (1 + scale), k
    sd_ph, sd_pt = s_ph.g_model.state_dict(), s_pt.g_model.state_dict()
    stats = [k for k in sd_ph if k.endswith(("running_mean", "running_var",
                                             "num_batches_tracked"))]
    assert len(stats) == 3 * 16
    for k in stats:
        assert torch.equal(sd_pt[k], sd_ph[k]), k


def test_paired_trunks_need_paired_heads():
    with pytest.raises(ValueError, match="paired-heads"):
        AdversarialConfig(paired_trunks=True, paired_heads=False)
    assert AdversarialConfig(paired_trunks=True).paired_trunks
