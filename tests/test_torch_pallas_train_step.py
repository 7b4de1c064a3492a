"""The training steps under ``use_pallas_train``, port against the JAX
package's ``use_pallas(training=True)`` (``bench.py --pallas_train``).

* Model level: the config-3 train-mode forward of a full-width
  ``PointNetDenseCls`` (B=8, random BatchNorm affine and running
  statistics), its loss and every parameter gradient, against
  ``apply_segmenter`` / ``segment.loss_fn`` under ``use_pallas(training=
  True)`` with the Pallas kernels in interpret mode, at N=128 (the fused
  trunk and seg head, with ``pointwise_matmul`` on the conv1 layers,
  ``tnet_apply`` and ``fc_head_train``) and at N=516, which the JAX
  package's fused training kernels cannot tile (the whole trunk and seg
  head layer by layer, ``maxpool_points`` on all three trunks). Bounds as
  the default path's model-level check: 5e-3 scale-relative, gradients
  2e-2 * (1 + max|g|).
* Which kernels each branch reaches, counted per pass on the CPU (the
  counts ``chip_smoke.py`` checks on the card at B=32).
* The bf16 bench objectives (paired heads) under the switch against the
  JAX package's under ``use_pallas(training=True)``, bounded as
  ``tests/test_torch_bench_step.py`` bounds them (the larger of the fp32
  bounds and twice what bf16 moves the JAX package's own objectives).
* ``train_tiling_ok`` equals the JAX package's for N in 1..3000; the
  switch is off by default, and off it the dispatch reaches none of the
  four kernels and the same fused passes as before.
* The config-4 G+D step at N=516 under the switch (the discriminator
  layer by layer, one stacked D pass, no known logits) against the JAX
  package's ``_train_step_impl`` under ``use_pallas(training=True)`` at
  the model-level bounds: every metric, running statistic and G and D
  gradient; its launches per step on and off the switch; the frozen
  discriminator's ``.grad`` stays ``None`` with no dW pass; the bf16
  bench objectives at N=516, bounded as at N=128.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu import losses as jax_losses
from adversarial_learning_on_pointclouds_tpu.configs import (
    AdversarialConfig as JaxAdversarialConfig,
)
from adversarial_learning_on_pointclouds_tpu.data import augment as jax_augment
from adversarial_learning_on_pointclouds_tpu.models import (
    apply_segmenter, core as jax_core, init_discriminator, init_segmenter,
)
from adversarial_learning_on_pointclouds_tpu.ops import dispatch as jax_ops
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.train import (
    adversarial as jax_adv,
)
from adversarial_learning_on_pointclouds_tpu.train.classify import (
    FT_REG_WEIGHT,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig, SegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    FCDiscriminator, PointNetDenseCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    disc_fused, fc_head_train, maxpool_points, pool_fc_epilogue,
    seg_head_train, shared_mlp, tnet_apply, trunk_train,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    adversarial, segment,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import convert

B, PARTS = 8, 50
RTOL = 5e-3
GRAD_TOL = 2e-2
YARD = 2.0


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
    params = jax.tree_util.tree_map(np.array, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    _randomize_bn(params, state, np.random.default_rng(0))
    return params, state


def _batch(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(B, n, 3)).astype(np.float32)
    y = rng.integers(0, PARTS, size=(B, n)).astype(np.int32)
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


@pytest.fixture(scope="module", params=[128, 516],
                ids=["fused-N128", "layerwise-N516"])
def jax_step(request, jax_model):
    """JAX's train forward, loss, new BN state and parameter gradients
    under ``use_pallas(training=True)``, once per N."""
    n = request.param
    x, y = map(jnp.asarray, _batch(n))
    params, state = jax_model

    def loss_fn(p):   # segment.loss_fn, with the log-probs kept
        logp, _, trans_feat, new_bn = apply_segmenter(p, state, x,
                                                      train=True)
        loss = (jax_losses.nll_loss(logp, y) + FT_REG_WEIGHT
                * jax_losses.orthogonality_reg(trans_feat))
        return loss, (logp, new_bn)

    with use_pallas(True, training=True):
        assert jax_ops.train_tiling_ok(n) == (n == 128)
        (loss, (logp, new_bn)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
    return n, logp, new_bn, loss, grads


def test_step_under_the_switch_matches_jax(jax_model, jax_step):
    n, ref_logp, ref_bn, ref_loss, ref_grads = jax_step
    x, y = (torch.from_numpy(a) for a in _batch(n))
    model = _port_model(jax_model)
    seen = []
    model.register_forward_hook(lambda m, i, out: seen.append(out[0]))
    with dispatch.use_pallas_train():
        loss, _ = segment.loss_fn(model, x, y.long(),
                                  SegmentConfig(num_points=n))
        loss.backward()
    _scaled_close(seen[0].detach(), ref_logp, RTOL)
    _scaled_close(loss.detach(), ref_loss, RTOL)

    want = convert.segmenter_state_dict(jax_model[0], ref_bn)
    got = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 16
    for k in stats:
        _scaled_close(got[k], want[k], RTOL)

    want_g = convert.segmenter_state_dict(ref_grads, jax_model[1])
    params = dict(model.named_parameters())
    assert set(params) <= set(want_g)
    scale = max(float(want_g[k].abs().max()) for k in params)
    for k, p in params.items():
        diff = float((p.grad - want_g[k]).abs().max())
        assert diff <= GRAD_TOL * (1 + scale), (k, diff)


# ---------------------------------------------------------------------------
# Which passes each branch reaches
# ---------------------------------------------------------------------------

_NEW = {"pointwise_matmul": (shared_mlp, shared_mlp.PM_PASSES),
        "tnet_apply": (tnet_apply, tnet_apply.PASSES),
        "maxpool_points": (maxpool_points, maxpool_points.PASSES),
        "fc_head_train": (fc_head_train, fc_head_train.PASSES)}
_OLD = {"trunk2_train": (trunk_train, trunk_train.PASSES),
        "seg_head_train": (seg_head_train, seg_head_train.PASSES),
        "pool_fc_epilogue": (pool_fc_epilogue,
                             {"fwd": pool_fc_epilogue.pool_fc_fwd})}


@contextlib.contextmanager
def _count_passes(monkeypatch, kernels=None):
    """Counts every pass call (CPU tensors run the plain twins, so the
    wrappers' own launch counts stay at 0)."""
    counts = {}
    for kernel, (module, passes) in (kernels or {**_NEW, **_OLD}).items():
        for pas, fn in passes.items():
            def counted(*a, _fn=fn, _key=(kernel, pas), **k):
                counts[_key] = counts.get(_key, 0) + 1
                return _fn(*a, **k)
            monkeypatch.setattr(module, fn.__name__, counted)
    yield counts


def _step_counts(jax_model, n, monkeypatch, switch):
    x, y = (torch.from_numpy(a) for a in _batch(n))
    model = _port_model(jax_model)
    with _count_passes(monkeypatch) as counts, \
            dispatch.use_pallas_train(switch):
        loss, _ = segment.loss_fn(model, x, y.long(),
                                  SegmentConfig(num_points=n))
        loss.backward()
    return {k: {p: counts.get((k, p), 0) for p in passes}
            for k, (_, passes) in {**_NEW, **_OLD}.items()}


_DEFAULT = {"trunk2_train": {"F1": 3, "F2": 3, "B1": 3},
            "seg_head_train": {"P1": 1, "Pmid": 2, "P4": 1, "B4": 1,
                               "Bmid": 2, "B1": 1},
            "pool_fc_epilogue": {"fwd": 2}}
_NONE = {"pointwise_matmul": {"fwd": 0, "dx": 0, "dW": 0},
         "tnet_apply": {"fwd": 0, "dx": 0, "dT": 0},
         "maxpool_points": {"fwd": 0, "bwd": 0},
         "fc_head_train": {"fwd": 0, "bwd": 0}}
_SWITCH = {"tnet_apply": {"fwd": 2, "dx": 1, "dT": 2},
           "fc_head_train": {"fwd": 2, "bwd": 2},
           "pool_fc_epilogue": {"fwd": 0}}
EXPECTED = {
    # N=128: conv1 of STN3d, the encoder and STNkd (STN3d's sees the
    # points: no dx); the fused trunks and seg head as by default.
    128: {**_DEFAULT, **_NONE, **_SWITCH,
          "pointwise_matmul": {"fwd": 3, "dx": 2, "dW": 3}},
    # N=516: every conv of the three trunks and seg head conv2-4 (conv1
    # is plain in the JAX package too), the max-pools; no fused pass.
    516: {**_NONE, **_SWITCH,
          "pointwise_matmul": {"fwd": 12, "dx": 11, "dW": 12},
          "maxpool_points": {"fwd": 3, "bwd": 3},
          "trunk2_train": {"F1": 0, "F2": 0, "B1": 0},
          "seg_head_train": {p: 0 for p in _DEFAULT["seg_head_train"]}},
}


@pytest.mark.parametrize("n", [128, 516])
def test_passes_per_step_under_the_switch(jax_model, n, monkeypatch):
    assert _step_counts(jax_model, n, monkeypatch, True) == EXPECTED[n]


@pytest.mark.parametrize("n", [128, 516])
def test_off_the_switch_nothing_changes(jax_model, n, monkeypatch):
    """Off by default; off the switch none of the four kernels is reached
    and the fused passes run at every N, as before."""
    assert not dispatch.pallas_train_enabled()
    assert _step_counts(jax_model, n, monkeypatch, False) == {
        **_DEFAULT, **_NONE}


def test_bench_step_passes_under_the_switch(monkeypatch):
    """``bench.py --pallas_train`` at a tileable N (paired heads): the
    conv1 layers and the transforms of both streams through the new
    kernels, the fc heads' fc1 + BN in plain PyTorch (no pool-fc pass, no
    fc_head_train), the fused trunks and seg heads as by default."""
    cfg = AdversarialConfig(batch_size=4, num_points=128, epochs=1,
                            augment=True, bf16=True, pallas_augment=True)
    state = adversarial.create_state(cfg, 10, device="cpu")
    txs = adversarial.make_txs(cfg, 10)
    x = torch.from_numpy(_batch(128)[0][:4])
    y = torch.zeros(4, 128, dtype=torch.long)
    with _count_passes(monkeypatch) as counts, \
            dispatch.use_pallas_train():
        adversarial.train_step(state, x, y, x, cfg=cfg, g_tx=txs[0],
                               d_tx=txs[1])
    doubled = {k: {p: 2 * c for p, c in v.items()}
               for k, v in _DEFAULT.items()}
    want = {**_NONE, **doubled, "pool_fc_epilogue": {"fwd": 0},
            "trunk2_train": {"F1": 6, "F2": 6, "B1": 6},
            "pointwise_matmul": {"fwd": 6, "dx": 4, "dW": 6},
            "tnet_apply": {"fwd": 4, "dx": 2, "dT": 4}}
    got = {k: {p: counts.get((k, p), 0) for p in passes}
           for k, (_, passes) in {**_NEW, **_OLD}.items()}
    assert got == want


def test_switch_is_scoped_and_per_thread():
    import threading

    seen = []
    with dispatch.use_pallas_train():
        assert dispatch.pallas_train_enabled()
        t = threading.Thread(target=lambda: seen.append(
            dispatch.pallas_train_enabled()))
        t.start()
        t.join(timeout=30)
        with dispatch.use_pallas_train(False):
            assert not dispatch.pallas_train_enabled()
        assert dispatch.pallas_train_enabled()
    assert not t.is_alive() and seen == [False]
    assert not dispatch.pallas_train_enabled()


def test_train_tiling_ok_matches_jax():
    for n in range(1, 3001):
        assert dispatch.train_tiling_ok(n) == jax_ops.train_tiling_ok(n), n
    assert dispatch.layer_by_layer(2500) is False
    with dispatch.use_pallas_train():
        assert dispatch.layer_by_layer(2500)
        assert not dispatch.layer_by_layer(2048)


# ---------------------------------------------------------------------------
# The config-4 G+D step at an untileable N under the switch
# ---------------------------------------------------------------------------

_DISC = {"disc_fused": (disc_fused, disc_fused.PASSES)}
_ALL = {**_NEW, **_OLD, **_DISC}
_NO_DISC = {"disc_fused": {p: 0 for p in disc_fused.PASSES}}
# Per config-4 step (paired heads, fp32): the generator's passes for two
# streams; the discriminator's, fused (off the switch) or layer by layer.
EXPECTED_ADV = {
    # The G as config 3 at N=516, twice (the paired heads' fc1 + BN run
    # plain: no fc_head_train); the D layer by layer: two frozen passes
    # in the G step (forward and dx, no dW), one stacked pass at 3B in
    # the D step (no dx into its detached input).
    "switch": {**_NONE, **_NO_DISC,
               "pointwise_matmul": {"fwd": 24 + 15, "dx": 22 + 14,
                                    "dW": 24 + 5},
               "maxpool_points": {"fwd": 6, "bwd": 6},
               "tnet_apply": {"fwd": 4, "dx": 2, "dT": 4},
               "trunk2_train": {"F1": 0, "F2": 0, "B1": 0},
               "seg_head_train": {p: 0 for p in _DEFAULT["seg_head_train"]},
               "pool_fc_epilogue": {"fwd": 0}},
    # Off the switch, as before: the fused passes at every N, the D's
    # two frozen forwards and the D step's known-logits passes.
    "off": {**_NONE,
            "trunk2_train": {"F1": 6, "F2": 6, "B1": 6},
            "seg_head_train": {p: 2 * c for p, c in
                               _DEFAULT["seg_head_train"].items()},
            "pool_fc_epilogue": {"fwd": 2},
            "disc_fused": {"fwd": 3, "bwd_dx": 2, "bwd_dw": 2, "bwd": 0}},
}
AN, AB = 516, 8


def _adv_count(monkeypatch, switch, fn):
    with _count_passes(monkeypatch, _ALL) as counts, \
            dispatch.use_pallas_train(switch):
        fn()
    return {k: {p: counts.get((k, p), 0) for p in passes}
            for k, (_, passes) in _ALL.items()}


@pytest.mark.parametrize("switch", [True, False], ids=["switch", "off"])
def test_adversarial_step_passes_at_untileable_n(monkeypatch, switch):
    """The launches of one G+D step at N=516 (untileable for the JAX
    package's fused kernels), under the switch and off it."""
    cfg = AdversarialConfig(batch_size=2, num_points=AN, epochs=1)
    state = adversarial.create_state(cfg, 10, device="cpu")
    txs = adversarial.make_txs(cfg, 10)
    x = torch.from_numpy(_batch(AN)[0][:2])
    y = torch.zeros(2, AN, dtype=torch.long)
    got = _adv_count(monkeypatch, switch, lambda: adversarial.train_step(
        state, x, y, x, cfg=cfg, g_tx=txs[0], d_tx=txs[1]))
    assert got == EXPECTED_ADV["switch" if switch else "off"]


def test_frozen_layerwise_discriminator_gets_no_gradient(monkeypatch):
    """The G step under the switch at N=516: D's layers run frozen, with
    forward and dx passes only (no dW pass), and D's ``.grad`` stays
    ``None``; G's gradients are all there."""
    cfg = AdversarialConfig(batch_size=2, num_points=AN)
    g = PointNetDenseCls(PARTS, feature_transform=True,
                         generator=torch.Generator().manual_seed(0)).train()
    d = FCDiscriminator(PARTS, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(_batch(AN)[0][:2])
    y = torch.zeros(2, AN, dtype=torch.long)

    def g_step():
        total, _ = adversarial.g_loss_fn(g, d, x, y, x, cfg, 1.0)
        total.backward()

    got = _adv_count(monkeypatch, True, g_step)
    assert got["pointwise_matmul"] == {"fwd": 24 + 10, "dx": 22 + 10,
                                       "dW": 24}
    assert all(p.grad is None for p in d.parameters())
    assert all(p.grad is not None for p in g.parameters())


@pytest.fixture(scope="module")
def adv_models():
    g_params, g_state = init_segmenter(jax.random.PRNGKey(0), PARTS,
                                       feature_transform=True)
    g_params = jax.tree_util.tree_map(np.array, g_params)
    g_state = jax.tree_util.tree_map(np.asarray, g_state)
    _randomize_bn(g_params, g_state, np.random.default_rng(0))
    d_params = jax.tree_util.tree_map(
        np.array, init_discriminator(jax.random.PRNGKey(1), PARTS))
    rng = np.random.default_rng(5)
    x_l, x_u = (rng.normal(size=(AB, AN, 3)).astype(np.float32)
                for _ in range(2))
    y_l = rng.integers(0, PARTS, size=(AB, AN)).astype(np.int32)
    return g_params, g_state, d_params, (x_l, y_l, x_u)


def test_adversarial_step_at_untileable_n_matches_jax(adv_models):
    """One config-4 G+D step at N=516 under the switch against the JAX
    package's ``_train_step_impl`` under ``use_pallas(training=True)``
    (its Pallas kernels in interpret mode; the generator and the
    discriminator layer by layer, no known logits, one D pass over
    ``[fake_l; fake_u; real]``): every metric, every new running statistic
    and every G and D gradient the step takes. JAX's step runs with
    ``optax.identity()`` for both nets, so each new parameter is the old
    one plus its gradient (the sum's rounding is 1e-7 of the parameter,
    far below the bound). The points go in as they are (``normalize``
    off on both sides): on points normalized to the unit sphere this
    fixture's input T-Net gradients are ill-conditioned in fp32, the
    port's and JAX's alike (3e-2 of (1 + max|g|) from float64 on the
    CPU)."""
    import optax

    from adversarial_learning_on_pointclouds_tpu.train import (
        state as jax_state,
    )

    g_params, g_state, d_params, batch = adv_models
    jcfg = JaxAdversarialConfig(num_points=AN, batch_size=AB,
                                feature_transform=True, normalize=False)
    tx = optax.identity()
    jstate = jax_state.GANTrainState(
        g_params=g_params, g_bn_state=g_state, g_opt_state=tx.init(g_params),
        d_params=d_params, d_opt_state=tx.init(d_params),
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    with use_pallas(True, training=True):
        assert not jax_ops.train_tiling_ok(AN)
        new_state, ref = jax.jit(lambda st, *b: jax_adv._train_step_impl(
            st, *b, jcfg, tx, tx))(jstate, *map(jnp.asarray, batch))
    g_grads, d_grads = (jax.tree_util.tree_map(
        lambda new, old: np.asarray(new) - old, new, old)
        for new, old in ((new_state.g_params, g_params),
                         (new_state.d_params, d_params)))

    g = PointNetDenseCls(PARTS, feature_transform=True)
    g.load_state_dict(convert.segmenter_state_dict(g_params, g_state),
                      strict=True)
    d = FCDiscriminator(PARTS)
    d.load_state_dict(convert.discriminator_state_dict(d_params), strict=True)
    cfg = AdversarialConfig(num_points=AN, batch_size=AB, normalize=False)
    state = adversarial.create_state(cfg, 10, device="cpu", g_model=g,
                                     d_model=d)
    txs = adversarial.make_txs(cfg, 10)
    x_l, y_l, x_u = (torch.from_numpy(np.array(a)) for a in batch)
    with dispatch.use_pallas_train():
        metrics = adversarial.train_step(state, x_l, y_l.long(), x_u,
                                         cfg=cfg, g_tx=txs[0], d_tx=txs[1])
    assert set(metrics) == set(ref)
    for k in ("loss_g", "loss_ce", "loss_adv", "loss_semi", "loss_d"):
        _scaled_close(metrics[k], ref[k], RTOL)
    assert abs(float(metrics["acc"]) - float(ref["acc"])) <= 2.0 / (AB * AN)

    want = convert.segmenter_state_dict(g_params, new_state.g_bn_state)
    got = g.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 16
    for k in stats:
        _scaled_close(got[k], want[k], RTOL)

    for model, want_g in (
            (g, convert.segmenter_state_dict(g_grads, g_state)),
            (d, convert.discriminator_state_dict(d_grads))):
        params = dict(model.named_parameters())
        scale = max(float(want_g[k].abs().max()) for k in params)
        for k, p in params.items():
            diff = float((p.grad - want_g[k]).abs().max())
            assert diff <= GRAD_TOL * (1 + scale), (k, diff)


# ---------------------------------------------------------------------------
# The bench objectives under the switch (bf16, paired heads)
# ---------------------------------------------------------------------------

BN = 128


def _models(n, normalize=True):
    g_params, g_state = init_segmenter(jax.random.PRNGKey(0), PARTS,
                                       feature_transform=True)
    g_params = jax.tree_util.tree_map(np.array, g_params)
    g_state = jax.tree_util.tree_map(np.asarray, g_state)
    _randomize_bn(g_params, g_state, np.random.default_rng(0))
    d_params = jax.tree_util.tree_map(
        np.array, init_discriminator(jax.random.PRNGKey(1), PARTS))
    rng = np.random.default_rng(1)
    x_l, x_u = (rng.normal(size=(B, n, 3)).astype(np.float32)
                for _ in range(2))
    if normalize:
        x_l, x_u = (np.asarray(jax_augment.normalize_unit_sphere(
            jnp.asarray(x))) for x in (x_l, x_u))
    y_l = rng.integers(0, PARTS, size=(B, n)).astype(np.int32)
    return g_params, g_state, d_params, (x_l, y_l, x_u)


@pytest.fixture(scope="module")
def models():
    return _models(BN)


def _jax_objectives(models, bf16):
    g_params, g_state, d_params, batch = models
    x_l, y_l, x_u = map(jnp.asarray, batch)
    jcfg = JaxAdversarialConfig(num_points=x_l.shape[1], batch_size=B,
                                feature_transform=True, bf16=bf16)
    with use_pallas(True, training=True), \
            jax_core.mixed_precision(enabled=bf16):
        (g_loss, aux), g_grads = jax.jit(
            jax.value_and_grad(jax_adv._g_loss_fn, has_aux=True),
            static_argnums=(6,))(g_params, d_params, g_state, x_l, y_l, x_u,
                                 jcfg, jnp.float32(1.0))
    return g_loss, aux, g_grads


@pytest.fixture(scope="module")
def jax_objectives(models):
    return {bf16: _jax_objectives(models, bf16) for bf16 in (False, True)}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _bf16_objectives_match(models, jax_objectives):
    """The port's bf16 objectives under the switch against JAX's, each held
    to the larger of the fp32 bound and twice what bf16 moves JAX's own."""
    g_params, g_state, d_params, batch = models
    g = PointNetDenseCls(PARTS, feature_transform=True)
    g.load_state_dict(convert.segmenter_state_dict(g_params, g_state),
                      strict=True)
    g.train()
    d = FCDiscriminator(PARTS)
    d.load_state_dict(convert.discriminator_state_dict(d_params), strict=True)
    x_l, y_l, x_u = (torch.from_numpy(np.array(a)) for a in batch)
    cfg = AdversarialConfig(num_points=x_l.shape[1], batch_size=B, bf16=True)
    assert cfg.paired_heads
    with dispatch.use_pallas_train(), core.mixed_precision():
        total, aux = adversarial.g_loss_fn(g, d, x_l, y_l.long(), x_u, cfg,
                                           1.0)
        total.backward()
    ref, yard = jax_objectives[True], jax_objectives[False]
    pairs = [(total, ref[0], yard[0])]
    pairs += [(aux[k], ref[1][k], yard[1][k])
              for k in ("l_ce", "l_adv", "l_semi", "d_l", "d_u", "logp_l")]
    for got, want, fp32 in pairs:
        assert _rel(got, want) <= max(RTOL, YARD * _rel(fp32, want))
    want = convert.segmenter_state_dict(ref[2], g_state)
    fp32 = convert.segmenter_state_dict(yard[2], g_state)
    names = [k for k, _ in g.named_parameters()]
    scale = max(float(np.abs(np.asarray(want[k])).max()) for k in names)
    err = max(_rel(p.grad, want[k]) * max(float(want[k].abs().max()), 1.0)
              for k, p in g.named_parameters()) / (1 + scale)
    moved = max(float((fp32[k] - want[k]).abs().max())
                for k in names) / (1 + scale)
    assert err <= max(GRAD_TOL, YARD * moved), (err, moved)


def test_bf16_objectives_under_the_switch_match_jax(models, jax_objectives):
    _bf16_objectives_match(models, jax_objectives)


def test_bf16_objectives_at_untileable_n_match_jax():
    """The bench objectives at N=516 under the switch: the generator's
    trunks and seg head and both frozen discriminator passes layer by
    layer, as the JAX package runs them there; bounded as at N=128."""
    models_516 = _models(AN)
    _bf16_objectives_match(models_516, {
        bf16: _jax_objectives(models_516, bf16) for bf16 in (False, True)})
