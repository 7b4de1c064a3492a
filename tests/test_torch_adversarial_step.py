"""The port's config-4 adversarial G+D step against the JAX package's.

A full-width generator (B=8, N=128, 50 parts, feature transform, random
BatchNorm affine and running statistics, as in
``tests/test_torch_train_step.py``) and discriminator, carried across
with ``convert.segmenter_state_dict`` / ``discriminator_state_dict``,
against the JAX package on the same numpy-seeded batch:

* ``forward_pair`` against ``apply_segmenter_pair``: both streams'
  log-probs and every new running statistic (grouped-BN chain included);
* ``g_loss_fn`` / ``d_loss_fn`` against ``_g_loss_fn`` / ``_d_loss_fn``
  (the known-logits path): every loss term, every G and D gradient;
* one ``train_step`` against JAX's ``train_step`` (normalize the only
  augmentation): every metric and every gradient.

The JAX generator runs its jnp path (``use_pallas(False)``; the Pallas
path of the same functions is held against it by the JAX package's own
tests), its known-logits and detached discriminator passes the Pallas
kernels in interpret mode. Bounds are ``tests/test_torch_train_step.py``'s:
5e-3 scale-relative, gradients within 2e-2 * (1 + max|g|). The semi
mask is a threshold, so it is held to JAX's everywhere except at points
within rounding of the threshold or of a tie for the argmax.
"""

import copy
import dataclasses

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
    apply_discriminator, core as jax_core, init_discriminator, init_segmenter,
)
from adversarial_learning_on_pointclouds_tpu.models.segmenter import (
    apply_segmenter_pair,
)
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.train import (
    adversarial as jax_adv, state as jax_state,
)
from adversarial_learning_on_pointclouds_tpu_torch import losses
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig, parse_adversarial_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    FCDiscriminator, PointNetDenseCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import adversarial
from adversarial_learning_on_pointclouds_tpu_torch.utils import convert

B, N, PARTS = 8, 128, 50
RTOL = 5e-3
GRAD_TOL = 2e-2
# A threshold near the middle of sigmoid(D) on this fixture, so the semi
# mask keeps some points and drops others.
THRESHOLD = 0.5
# The combinations the JAX package refuses (its flag check, and
# create_state's for the two controls), and the options still to port.
REFUSED = {
    "supervised_only+self_training": (
        ValueError, "mutually exclusive",
        dict(supervised_only=True, self_training=True)),
    "paired_trunks-paired_heads": (
        ValueError, "paired-heads",
        dict(paired_trunks=True, paired_heads=False)),
    "paired_trunks+fused_forward": (
        ValueError, "paired-heads",
        dict(paired_trunks=True, fused_forward=True)),
    "paired_conv1-paired_heads": (
        ValueError, "paired-heads",
        dict(paired_conv1=True, paired_heads=False)),
    "paired_conv1+fused_forward": (
        ValueError, "paired-heads",
        dict(paired_conv1=True, fused_forward=True)),
    "fused_epoch": (NotImplementedError, "item 5", dict(fused_epoch=True)),
    "num_devices": (NotImplementedError, "item 15", dict(num_devices=2)),
}


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


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _scaled_close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0)


def _grads_close(got: dict, want: dict):
    """Every gradient within ``GRAD_TOL * (1 + max|g|)`` over the net."""
    assert set(got) == set(want)
    scale = max(float(want[k].abs().max()) for k in want)
    for k, g in got.items():
        assert g is not None, k
        diff = float((g - want[k]).abs().max())
        assert diff <= GRAD_TOL * (1 + scale), (k, diff)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    x_l = rng.normal(size=(B, N, 3)).astype(np.float32)
    x_u = rng.normal(size=(B, N, 3)).astype(np.float32)
    y_l = rng.integers(0, PARTS, size=(B, N)).astype(np.int32)
    return x_l, y_l, x_u


@pytest.fixture(scope="module")
def jax_models(batch):
    """G and D params (numpy) and JAX's pair forward of the normalized
    batch. G's last layer is scaled up, so that its probability maps are
    far from uniform (and its argmax far from ties); D's last layer too,
    with its bias set to the median of its logits on the unlabeled
    stream, so that sigmoid(D) straddles THRESHOLD: the semi mask keeps
    half the points, few of them near it."""
    g_params, g_state = init_segmenter(jax.random.PRNGKey(0), PARTS,
                                       feature_transform=True)
    g_params = jax.tree_util.tree_map(np.array, g_params)
    g_state = jax.tree_util.tree_map(np.asarray, g_state)
    _randomize_bn(g_params, g_state, np.random.default_rng(0))
    g_params["conv4"]["w"] *= 10
    x_l, _, x_u = map(jnp.asarray, _normalized(batch))
    with use_pallas(False):
        pair = jax.jit(apply_segmenter_pair)(g_params, g_state, x_l, x_u)
        d_params = jax.tree_util.tree_map(
            np.array, init_discriminator(jax.random.PRNGKey(1), PARTS))
        d_params["conv5"]["w"] *= 300
        d_u = apply_discriminator(d_params, jnp.exp(pair[1]))
    d_params["conv5"]["b"] -= np.median(np.asarray(d_u))
    return g_params, g_state, d_params, pair


def _normalized(batch):
    x_l, y_l, x_u = batch
    return (np.asarray(jax_augment.normalize_unit_sphere(jnp.asarray(x_l))),
            y_l,
            np.asarray(jax_augment.normalize_unit_sphere(jnp.asarray(x_u))))


def _cfgs(**kw):
    return (AdversarialConfig(num_points=N, batch_size=B,
                              semi_threshold=THRESHOLD, **kw),
            JaxAdversarialConfig(num_points=N, batch_size=B,
                                 semi_threshold=THRESHOLD, **kw))


@pytest.fixture(scope="module")
def jax_ref(jax_models, batch):
    """JAX's pair forward, G loss and gradients (jnp path) and D loss and
    gradients (known-logits path) on the normalized batch."""
    g_params, g_state, d_params, pair = jax_models
    x_l, y_l, x_u = map(jnp.asarray, _normalized(batch))
    jcfg = _cfgs()[1]
    with use_pallas(False):
        (g_loss, aux), g_grads = jax.jit(
            jax.value_and_grad(jax_adv._g_loss_fn, has_aux=True),
            static_argnums=(6,))(g_params, d_params, g_state, x_l, y_l, x_u,
                                 jcfg, jnp.float32(1.0))
    fake_logits = jnp.concatenate([aux["d_l"], aux["d_u"]])
    (d_loss, (d_real, d_fake)), d_grads = jax.value_and_grad(
        jax_adv._d_loss_fn, has_aux=True)(
            d_params, aux["probs_l"], aux["probs_u"], y_l, PARTS, fake_logits)
    return dict(pair=pair, g_loss=g_loss, aux=aux, g_grads=g_grads,
                d_loss=d_loss, d_real=d_real, d_fake=d_fake, d_grads=d_grads,
                fake_logits=fake_logits)


def _port_models(jax_models):
    g_params, g_state, d_params, _ = jax_models
    g = PointNetDenseCls(PARTS, feature_transform=True)
    g.load_state_dict(convert.segmenter_state_dict(g_params, g_state),
                      strict=True)
    d = FCDiscriminator(PARTS)
    d.load_state_dict(convert.discriminator_state_dict(d_params), strict=True)
    return g.train(), d


def _t(a):
    return torch.from_numpy(np.array(a))


def test_forward_pair_matches_jax(jax_models, batch, jax_ref):
    logp_a, logp_b, tf_a, tf_b, new_state = jax_ref["pair"]
    x_l, _, x_u = map(_t, _normalized(batch))
    g, _ = _port_models(jax_models)
    got = g.forward_pair(x_l, x_u)
    for a, b in zip(got, (logp_a, logp_b, tf_a, tf_b)):
        _scaled_close(a, b)
    want = convert.segmenter_state_dict(jax_models[0], new_state)
    sd = g.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 16
    for k in stats:
        _scaled_close(sd[k], want[k])
    assert all(int(v) == 2 for k, v in sd.items()
               if k.endswith("num_batches_tracked"))


def _semi_mask_agrees(port_d_u, port_logp_u, ref_d_u, ref_logp_u):
    """The port's semi mask and pseudo-labels equal JAX's except where
    JAX's sigmoid(d_u) is within 1e-4 of the threshold or its top two
    log-probs are within 1e-5 of each other."""
    ref_sig = np.asarray(jax.nn.sigmoid(ref_d_u[..., 0]))
    ref_mask = ref_sig > THRESHOLD
    mask = (torch.sigmoid(port_d_u[..., 0]) > THRESHOLD).numpy()
    ref_logp = np.asarray(ref_logp_u)
    top2 = np.sort(ref_logp, -1)[..., -2:]
    tie = top2[..., 1] - top2[..., 0] <= 1e-5
    near = np.abs(ref_sig - THRESHOLD) <= 1e-4
    pseudo = port_logp_u.detach().argmax(-1).numpy()
    assert 0.05 < ref_mask.mean() < 0.95, ref_mask.mean()
    assert near.mean() < 0.01 and tie.mean() < 0.01
    assert ((mask == ref_mask) | near).all()
    assert ((pseudo == ref_logp.argmax(-1)) | tie).all()


def test_g_loss_fn_matches_jax(jax_models, batch, jax_ref):
    """Every loss term and every generator gradient; D, frozen in the G
    step, gets no gradient."""
    x_l, y_l, x_u = map(_t, _normalized(batch))
    g, d = _port_models(jax_models)
    cfg = _cfgs()[0]
    total, aux = adversarial.g_loss_fn(g, d, x_l, y_l.long(), x_u, cfg, 1.0)
    ref = jax_ref["aux"]
    _scaled_close(total, jax_ref["g_loss"])
    for key in ("l_ce", "l_adv", "l_semi", "d_l", "d_u", "probs_l",
                "probs_u", "logp_l"):
        _scaled_close(aux[key], ref[key])
    _semi_mask_agrees(aux["d_u"].detach(), aux["probs_u"].detach().log(),
                      ref["d_u"], jax_ref["pair"][1])
    total.backward()
    assert all(p.grad is None for p in d.parameters())
    want = convert.segmenter_state_dict(jax_ref["g_grads"], jax_models[1])
    _grads_close({k: p.grad for k, p in g.named_parameters()},
                 {k: want[k] for k, _ in g.named_parameters()})


def _d_grads(d, jax_grads):
    want = convert.discriminator_state_dict(jax_grads)
    return ({k: p.grad for k, p in d.named_parameters()}, want)


def test_d_loss_fn_matches_jax(jax_models, batch, jax_ref):
    """The D objective on JAX's detached predictions, its logits and every
    D gradient, with the fakes' logits given (no fake forward)."""
    _, d = _port_models(jax_models)
    aux = jax_ref["aux"]
    loss, (d_real, d_fake) = adversarial.d_loss_fn(
        d, _t(aux["probs_l"]), _t(aux["probs_u"]), _t(batch[1]), PARTS,
        _t(jax_ref["fake_logits"]))
    _scaled_close(loss, jax_ref["d_loss"])
    _scaled_close(d_real, jax_ref["d_real"])
    _scaled_close(d_fake, jax_ref["d_fake"])
    loss.backward()
    _grads_close(*_d_grads(d, jax_ref["d_grads"]))


def test_train_step_matches_jax(jax_models, batch, jax_ref):
    """One step of each package from the same weights on the same raw
    batch (normalize is the chain's only step at N = num_points): every
    metric, and every G and D gradient the step leaves behind."""
    cfg, jcfg = _cfgs()
    g_params, g_state, d_params, _ = jax_models
    g_tx, d_tx = jax_adv.make_txs(jcfg, 10)
    jstate = jax_state.GANTrainState(
        g_params=g_params, g_bn_state=g_state,
        g_opt_state=g_tx.init(g_params), d_params=d_params,
        d_opt_state=d_tx.init(d_params), step=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(0))
    with use_pallas(False):
        _, ref = jax_adv.train_step(jstate, *map(jnp.asarray, batch),
                                    cfg=jcfg, g_tx=g_tx, d_tx=d_tx)
    g, d = _port_models(jax_models)
    state = adversarial.create_state(cfg, 10, device="cpu", g_model=g,
                                     d_model=d)
    txs = adversarial.make_txs(cfg, 10)
    x_l, y_l, x_u = map(_t, batch)
    metrics = adversarial.train_step(state, x_l, y_l.long(), x_u, cfg=cfg,
                                     g_tx=txs[0], d_tx=txs[1])
    assert state.step == 1
    assert set(metrics) == set(ref)
    for k in ("loss_g", "loss_ce", "loss_adv", "loss_semi", "loss_d"):
        _scaled_close(metrics[k], ref[k])
    assert abs(float(metrics["acc"]) - float(ref["acc"])) <= 2.0 / (B * N)
    want = convert.segmenter_state_dict(jax_ref["g_grads"], g_state)
    _grads_close({k: p.grad for k, p in g.named_parameters()},
                 {k: want[k] for k, _ in g.named_parameters()})
    _grads_close(*_d_grads(d, jax_ref["d_grads"]))


@pytest.mark.parametrize("shape", [(2 * B, 32), (2 * B, 16, 32)],
                         ids=["rows", "points"])
def test_grouped_bn_matches_sequential_calls(shape):
    """Two row blocks through ``batch_norm_train_grouped``: each block
    normalized with its own moments, the running statistics chained
    block 0 -> 1; as two ``batch_norm_train`` calls up to the centring
    constant, and as the JAX package's ``batch_norm_grouped``."""
    rng = np.random.default_rng(2)
    x = (rng.normal(0.3, 1.5, shape)).astype(np.float32)
    c = shape[-1]
    bn = torch.nn.BatchNorm1d(c)
    with torch.no_grad():
        bn.weight.copy_(_t(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(_t(rng.normal(0, 0.1, c).astype(np.float32)))
        bn.running_mean.copy_(_t(rng.normal(0, 0.1, c).astype(np.float32)))
        bn.running_var.copy_(_t(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    seq = copy.deepcopy(bn)
    p = {"scale": bn.weight.detach().numpy().copy(),
         "bias": bn.bias.detach().numpy().copy()}
    s = {"mean": bn.running_mean.numpy().copy(),
         "var": bn.running_var.numpy().copy()}
    y = core.batch_norm_train_grouped(bn, _t(x), 2)
    y_seq = torch.cat([core.batch_norm_train(seq, _t(x[:B])),
                       core.batch_norm_train(seq, _t(x[B:]))])
    y_jax, s_jax = jax_core.batch_norm_grouped(p, s, jnp.asarray(x), True, 2)
    for a, b in ((y, y_seq), (y, y_jax)):
        _scaled_close(a, b, 1e-5)
    for a, b in ((bn.running_mean, seq.running_mean),
                 (bn.running_mean, s_jax["mean"]),
                 (bn.running_var, seq.running_var),
                 (bn.running_var, s_jax["var"])):
        _scaled_close(a, b, 1e-6)
    assert int(bn.num_batches_tracked) == int(seq.num_batches_tracked) == 2


def test_paired_heads_match_sequential_forwards(jax_models, batch):
    """The paired forward (T-Net fc heads batched across the streams) and
    two sequential forwards are the same function: in float64 on the CPU
    they agree to 1e-9 in the losses, D's logits, every gradient and
    every running statistic. (In fp32 the batch-8 BatchNorms of the
    T-Net heads amplify the two orders of summation far above
    rounding.)"""
    x_l, y_l, x_u = (_t(a) for a in _normalized(batch))
    outs = []
    for paired in (True, False):
        g, d = (m.double() for m in _port_models(jax_models))
        cfg = _cfgs(paired_heads=paired)[0]
        total, aux = adversarial.g_loss_fn(g, d, x_l.double(), y_l.long(),
                                           x_u.double(), cfg, 1.0)
        total.backward()
        outs.append((total, aux, g))
    (t_p, a_p, g_p), (t_s, a_s, g_s) = outs
    _scaled_close(t_p, t_s, 1e-9)
    for key in ("l_ce", "l_adv", "l_semi", "d_l", "d_u", "logp_l"):
        _scaled_close(a_p[key], a_s[key], 1e-9)
    want = dict(g_s.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in want.values())
    for k, p in g_p.named_parameters():
        assert float((p.grad - want[k].grad).abs().max()) <= \
            1e-9 * (1 + scale), k
    sd_p, sd_s = g_p.state_dict(), g_s.state_dict()
    for k in sd_s:
        if k.endswith(("running_mean", "running_var")):
            _scaled_close(sd_p[k], sd_s[k], 1e-9)


@pytest.mark.parametrize("name", ["bce", "adv_g", "d", "semi", "self_train"])
def test_losses_match_jax(name):
    """Each objective and its gradient on random inputs."""
    rng = np.random.default_rng(3)
    z = rng.normal(0, 3, (2, 40, 1)).astype(np.float32)
    z2 = rng.normal(0, 3, (2, 40, 1)).astype(np.float32)
    logits = rng.normal(0, 2, (2, 40, 6)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    fns = {
        "bce": (lambda a, b: losses.bce_with_logits(a, 0.3),
                lambda a, b: jax_losses.bce_with_logits(a, 0.3), z, z2),
        "adv_g": (lambda a, b: losses.adv_g_loss(a),
                  lambda a, b: jax_losses.adv_g_loss(a), z, z2),
        "d": (losses.d_loss, jax_losses.d_loss, z, z2),
        "semi": (lambda a, b: losses.semi_loss(a, b, 0.5),
                 lambda a, b: jax_losses.semi_loss(a, b, 0.5), lp, z),
        "self_train": (lambda a, b: losses.self_train_loss(a, 0.3),
                       lambda a, b: jax_losses.self_train_loss(a, 0.3), lp,
                       z),
    }
    port_fn, jax_fn, a, b = fns[name]
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    out = port_fn(ta, tb)
    out.backward()
    ref, (ga, gb) = jax.value_and_grad(jax_fn, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    _scaled_close(out, ref, 1e-6)
    _scaled_close(ta.grad, ga, 1e-6)
    _scaled_close(tb.grad if tb.grad is not None else torch.zeros_like(tb),
                  gb, 1e-6)


def test_create_state_runs_on_the_cpu_only_when_asked(monkeypatch):
    cfg = AdversarialConfig(num_points=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        adversarial.create_state(cfg, 10)
    state = adversarial.create_state(cfg, 10, device="cpu")
    assert state.g_model.training and state.step == 0
    for p in (*state.g_model.parameters(), *state.d_model.parameters()):
        assert p.device.type == "cpu"
    assert (state.g_tx, state.d_tx) == adversarial.make_txs(cfg, 10)
    group = state.d_optimizer.param_groups[0]
    assert isinstance(state.d_optimizer, torch.optim.Adam)
    assert (group["lr"], group["betas"]) == (1e-4, (0.9, 0.99))


def test_config_defaults_match_jax():
    port = dataclasses.asdict(AdversarialConfig())
    ref = dataclasses.asdict(JaxAdversarialConfig())
    assert {k: ref[k] for k in port} == port


@pytest.mark.parametrize("combination", REFUSED)
def test_ablation_controls_raise(combination):
    """Each ablation knob alone is accepted; the combinations the JAX
    package refuses raise, in the config and through the flag parser."""
    error, match, kw = REFUSED[combination]
    for flag in set(kw) & {"supervised_only", "self_training", "d_geometry",
                           "paired_trunks", "paired_conv1", "fused_forward"}:
        AdversarialConfig(**{flag: True})
    with pytest.raises(error, match=match):
        AdversarialConfig(**kw)
    argv = [f"--{k}" if v is True else "--no_paired_heads" if v is False
            else f"--{k}={v}" for k, v in kw.items()]
    with pytest.raises((error, SystemExit)):
        parse_adversarial_args(argv)


def test_train_step_refuses_other_txs():
    cfg = AdversarialConfig(num_points=64)
    state = adversarial.create_state(cfg, 10, device="cpu")
    g_tx, d_tx = adversarial.make_txs(cfg, 10)
    other = adversarial.make_txs(dataclasses.replace(cfg, lr_d=0.1), 10)[1]
    x = torch.randn(2, 64, 3)
    y = torch.zeros(2, 64, dtype=torch.long)
    with pytest.raises(ValueError, match="built with"):
        adversarial.train_step(state, x, y, x, cfg=cfg, g_tx=g_tx, d_tx=other)
    assert state.step == 0


def test_ten_steps_lower_the_loss_on_a_fixed_batch():
    """The whole G+D step on the CPU: ten steps on one fixed batch lower
    the supervised loss and keep every metric finite."""
    cfg = AdversarialConfig(num_points=64, lr=3e-3)
    state = adversarial.create_state(cfg, 10, device="cpu")
    g_tx, d_tx = adversarial.make_txs(cfg, 10)
    gen = torch.Generator().manual_seed(4)
    x_l = torch.randn(4, 64, 3, generator=gen)
    x_u = torch.randn(4, 64, 3, generator=gen)
    y = (x_l[..., 0] > 0).long() + 2 * (x_l[..., 1] > 0).long()
    seen = [adversarial.train_step(state, x_l, y, x_u, cfg=cfg, g_tx=g_tx,
                                   d_tx=d_tx) for _ in range(10)]
    assert all(np.isfinite(float(v)) for m in seen for v in m.values())
    assert float(seen[-1]["loss_ce"]) < float(seen[0]["loss_ce"])
