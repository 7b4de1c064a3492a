"""The port's segmentation training step against the JAX package's.

* Model level: the train-mode forward of a full-width ``PointNetDenseCls``
  (B=8, N=128, random BatchNorm affine and running statistics) against
  ``apply_segmenter(train=True)`` on the JAX Pallas path (interpret mode)
  and on its jnp path: log-probs, new running statistics and every
  parameter gradient of the training loss, at the bounds of
  ``tests/test_kernels.py``'s model-level check (5e-3 scale-relative;
  gradients 2e-2 * (1 + max|g|)): the batch-axis BNs of the T-Net heads
  amplify summation-order differences at small batch.
* ``loss_fn`` / ``train_step`` against ``segment.loss_fn``.
* The optimizer and its schedule against optax, fed identical gradients.
* Augmentation: exact for normalize, by invariants for the random parts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.configs import (
    SegmentConfig as JaxSegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu.data import augment as jax_augment
from adversarial_learning_on_pointclouds_tpu.models import (
    apply_segmenter, init_segmenter,
)
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.train import (
    segment as jax_segment, state as jax_state,
)
from adversarial_learning_on_pointclouds_tpu_torch import losses
from adversarial_learning_on_pointclouds_tpu_torch.configs import SegmentConfig
from adversarial_learning_on_pointclouds_tpu_torch.data import augment
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetDenseCls,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    segment, state as state_lib,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import convert

B, N, PARTS = 8, 128, 50
RTOL = 5e-3
GRAD_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize_bn(tree_p, tree_s, rng):
    for key, sub in tree_p.items():
        if key.startswith("bn"):
            c = sub["scale"].shape[0]
            sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sub["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            tree_s[key] = {
                "mean": rng.normal(0, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        elif isinstance(sub, dict) and key in tree_s:
            _randomize_bn(sub, tree_s[key], rng)


@pytest.fixture(scope="module")
def jax_model():
    params, state = init_segmenter(jax.random.PRNGKey(0), PARTS,
                                   feature_transform=True)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    _randomize_bn(params, state, np.random.default_rng(0))
    return params, state


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    y = rng.integers(0, PARTS, size=(B, N)).astype(np.int32)
    return x, y


def _port_model(jax_model):
    model = PointNetDenseCls(PARTS, feature_transform=True)
    model.load_state_dict(convert.segmenter_state_dict(*jax_model),
                          strict=True)
    return model.train()


def _scaled_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0)


@pytest.fixture(scope="module", params=[True, False], ids=["pallas", "jnp"])
def jax_step(request, jax_model, batch):
    """JAX's train forward, new BN state, loss and parameter grads."""
    x, y = map(jnp.asarray, batch)
    params, state = jax_model
    cfg = JaxSegmentConfig(num_points=N)
    with use_pallas(request.param):
        logp, _, _, _ = apply_segmenter(params, state, x, train=True)
        (loss, (new_bn, acc)), grads = jax.value_and_grad(
            jax_segment.loss_fn, has_aux=True)(params, state, x, y, cfg)
    return logp, new_bn, loss, acc, grads


def test_train_forward_and_grads_match_jax(jax_model, batch, jax_step):
    ref_logp, ref_bn, ref_loss, _, ref_grads = jax_step
    x, y = map(torch.from_numpy, batch)
    model = _port_model(jax_model)
    logp, _, trans_feat = model(x)
    _scaled_close(logp.detach(), ref_logp, RTOL)
    loss = (losses.nll_loss(logp, y)
            + losses.FT_REG_WEIGHT * losses.orthogonality_reg(trans_feat))
    _scaled_close(loss.detach(), ref_loss, RTOL)
    loss.backward()

    want = convert.segmenter_state_dict(jax_model[0], ref_bn)
    got = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 16
    for k in stats:
        _scaled_close(got[k], want[k], RTOL)
    assert all(int(v) == 1 for k, v in got.items()
               if k.endswith("num_batches_tracked"))

    want_g = convert.segmenter_state_dict(ref_grads, jax_model[1])
    params = dict(model.named_parameters())
    assert set(params) <= set(want_g)
    scale = max(float(want_g[k].abs().max()) for k in params)
    for k, p in params.items():
        diff = float((p.grad - want_g[k]).abs().max())
        assert diff <= GRAD_TOL * (1 + scale), (k, diff)


def test_loss_fn_and_train_step_match_jax(jax_model, batch, jax_step):
    """``loss_fn`` gives JAX's loss and accuracy; ``train_step`` (whose
    default chain only normalizes a batch already at ``num_points``)
    gives JAX's loss on the normalized batch and leaves its gradients in
    ``.grad``."""
    _, _, ref_loss, ref_acc, _ = jax_step
    x, y = map(torch.from_numpy, batch)
    cfg = SegmentConfig(num_points=N, normalize=False)
    loss, acc = segment.loss_fn(_port_model(jax_model), x, y, cfg)
    _scaled_close(loss.detach(), ref_loss, RTOL)
    assert abs(float(acc) - float(ref_acc)) <= 2.0 / (B * N)

    cfg = SegmentConfig(num_points=N)
    xn = jax_augment.normalize_unit_sphere(jnp.asarray(batch[0]))
    with use_pallas():
        (ref_loss, _), ref_grads = jax.value_and_grad(
            jax_segment.loss_fn, has_aux=True)(
                *jax_model, xn, jnp.asarray(batch[1]),
                JaxSegmentConfig(num_points=N))
    tx = segment.make_tx(cfg, steps_per_epoch=10)
    state = segment.create_state(cfg, 10, device="cpu",
                                 model=_port_model(jax_model))
    metrics = segment.train_step(state, x, y, cfg=cfg, tx=tx)
    _scaled_close(metrics["loss"], ref_loss, RTOL)
    assert state.step == 1
    want_g = convert.segmenter_state_dict(ref_grads, jax_model[1])
    params = dict(state.model.named_parameters())
    scale = max(float(want_g[k].abs().max()) for k in params)
    for k, p in params.items():
        assert float((p.grad - want_g[k]).abs().max()) <= \
            GRAD_TOL * (1 + scale), k


def _optax_and_port(kind, schedule):
    steps_per_epoch, epochs = 3, 4
    kw = dict(optimizer=kind, lr_schedule=schedule,
              total_steps=epochs * steps_per_epoch, poly_power=0.9)
    tx = jax_state.make_optimizer(0.01, 0.9, 0.999, 1, 0.5, steps_per_epoch,
                                  **kw)
    port = state_lib.make_optimizer(0.01, 0.9, 0.999, 1, 0.5,
                                    steps_per_epoch, **kw)
    return tx, port, epochs * steps_per_epoch


@pytest.mark.parametrize("kind,schedule", [("adam", "step"), ("adam", "poly"),
                                           ("sgd", "step"), ("sgd", "poly")])
def test_optimizer_matches_optax_on_identical_grads(kind, schedule):
    """The same gradient sequence through optax and through the port's
    optimizer: the learning rate of every step and the parameters after
    it agree."""
    tx, port, steps = _optax_and_port(kind, schedule)
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=3).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(steps)]
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt, sched = port.init(list(tp.values()))
    for t, g in enumerate(grads):
        lr = opt.param_groups[0]["lr"]
        want_lr = 0.01 * (0.5 ** (t // 3) if schedule == "step"
                          else (1 - t / steps) ** 0.9)
        assert abs(lr - want_lr) <= 1e-9, (t, lr, want_lr)
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), jp[k], atol=1e-6,
                                       rtol=1e-5)


def test_normalize_matches_jax():
    x = np.random.default_rng(2).normal(2.0, 3.0, (4, 50, 3)).astype(
        np.float32)
    got = augment.normalize_unit_sphere(torch.from_numpy(x))
    want = jax_augment.normalize_unit_sphere(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(augment.normalize_unit_sphere_np(x), want,
                               atol=1e-6)


def test_augment_invariants():
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 300, 3)).astype(np.float32))
    # Labels ride the resample gather: label = the point's row index.
    labels = torch.arange(300).expand(4, -1).contiguous()
    pts, lab = augment.resample_fixed_n(gen, x, 128, labels)
    assert pts.shape == (4, 128, 3) and lab.shape == (4, 128)
    assert torch.equal(pts, torch.gather(x, 1, lab[..., None].expand(
        -1, -1, 3)))
    rot = augment.random_rotate(gen, x)
    torch.testing.assert_close(rot.norm(dim=-1), x.norm(dim=-1))
    torch.testing.assert_close(rot[..., 1], x[..., 1])
    jit = augment.jitter(gen, x)
    assert (jit - x).abs().max() <= 0.05 + 1e-6
    assert 0.005 < float((jit - x).std()) < 0.015
    drop = augment.point_dropout(gen, x)
    same = (drop == x).all(-1) | (drop == x[:, :1]).all(-1)
    assert bool(same.all())


@pytest.mark.parametrize("flags", [
    dict(), dict(augment=True), dict(point_dropout=True),
    dict(normalize=False, resample=False)])
def test_chain_from_cfg_shapes_and_labels(flags):
    cfg = SegmentConfig(num_points=64, **flags)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 100, 3) * 5 + 1
    y = torch.arange(100).expand(2, -1).contiguous()
    pts, lab = augment.chain_from_cfg(gen, cfg, x, y)
    n = 64 if cfg.resample else 100
    assert pts.shape == (2, n, 3) and lab.shape == (2, n)
    if cfg.normalize and not cfg.augment and not cfg.point_dropout:
        assert float(pts.norm(dim=-1).max()) <= 1 + 1e-5
    if not cfg.augment and not cfg.point_dropout:
        base = augment.normalize_unit_sphere(x) if cfg.normalize else x
        torch.testing.assert_close(
            pts, torch.gather(base, 1, lab[..., None].expand(-1, -1, 3)))


def test_config_defaults_match_jax():
    port = dataclasses.asdict(SegmentConfig())
    ref = dataclasses.asdict(JaxSegmentConfig())
    assert {k: ref[k] for k in port} == port


def test_train_step_refuses_another_tx():
    """The state's optimizer takes the step, so a ``tx`` other than the
    one the state was built with raises instead of being ignored."""
    cfg = SegmentConfig(num_points=64)
    state = segment.create_state(cfg, 10, device="cpu")
    assert segment.make_tx(cfg, 10) == state.tx
    x = torch.randn(2, 64, 3)
    y = torch.zeros(2, 64, dtype=torch.long)
    other = segment.make_tx(dataclasses.replace(cfg, lr=0.1), 10)
    with pytest.raises(ValueError, match="built with"):
        segment.train_step(state, x, y, cfg=cfg, tx=other)
    assert state.step == 0


def test_ten_steps_lower_the_loss_on_a_fixed_batch():
    """The whole step on the CPU: Adam on one fixed batch lowers the loss
    and keeps it finite."""
    cfg = SegmentConfig(num_points=64, lr=3e-3)
    state = segment.create_state(cfg, 10, device="cpu")
    tx = segment.make_tx(cfg, 10)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(4, 64, 3, generator=gen)
    y = (x[..., 0] > 0).long() + 2 * (x[..., 1] > 0).long()
    seen = [float(segment.train_step(state, x, y, cfg=cfg, tx=tx)["loss"])
            for _ in range(10)]
    assert np.isfinite(seen).all() and seen[-1] < seen[0]
