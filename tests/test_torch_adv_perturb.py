"""The port's FGSM perturbation training (config 5) against the JAX
package's.

* FGSM and PGD (1 and 3 steps) against the JAX package's ``attacks.py``
  on the same eval-mode loss (B=8, N=512, random BatchNorm statistics,
  the JAX side jitted on its jnp path, the path its attack forces): the
  input gradient within 1e-4 of its largest element; the perturbed
  clouds equal, but where the JAX gradient is below 1e-6 of its largest
  element (their share bounded, 1%), where ``sign`` may flip by
  rounding; the points that win no channel of any max-pool get exactly
  zero gradient on both sides.
* The attack runs the eval-mode blocks' plain versions
  (``differentiable_eval``): the eval kernels' wrappers are never called
  inside it, nor the per-layer training kernels under
  ``use_pallas_train``, while an eval forward outside calls them; the
  BatchNorm running statistics and the parameters' ``.grad`` are left
  untouched and the model's train mode restored.
* The config-5 step (FGSM and PGD-3; dropout 0, no augmentation) against
  the JAX package's ``adv_perturb._train_step_impl`` under
  ``optax.identity()`` (so new - old parameters are its gradients): the
  loss at 5e-3, every gradient at 2e-2 * (1 + max|g|), the new running
  statistics at 5e-3; PGD at one step takes FGSM's path.
* ``run_adv_perturb`` for one tiny epoch through the CLI, and
  ``eval_robustness`` at eps 0 equal to the plain eval accuracy with a
  ragged last batch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu import attacks as jax_attacks
from adversarial_learning_on_pointclouds_tpu import losses as jax_losses
from adversarial_learning_on_pointclouds_tpu.configs import (
    AdvPerturbConfig as JaxAdvPerturbConfig,
)
from adversarial_learning_on_pointclouds_tpu.models import apply_classifier
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.train import (
    adv_perturb as jax_adv_perturb, state as jax_state,
)
from adversarial_learning_on_pointclouds_tpu.utils import torch_import
from adversarial_learning_on_pointclouds_tpu_torch import (
    attacks, eval as eval_lib, eval_robustness, losses, train_adv_perturb,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdvPerturbConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    encoder_fused, shared_mlp, tnet_apply,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    adv_perturb, runner,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import convert
from tests.test_torch_classify import randomize_bn

B, K, EPS = 8, 40, 0.05
N_ATTACK, N_STEP = 512, 64
GRAD_REL = 1e-4     # input gradients, of their largest element
NEAR_ZERO = 1e-6    # below this share of max|g| a sign may flip
NEAR_SHARE = 1e-2   # at most this share of the elements so exempted
RTOL, GRAD_TOL = 5e-3, 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """A seeded config-5 classifier (no feature transform) with random
    BatchNorm statistics, dropout 0."""
    m = PointNetCls(K, dropout=0.0,
                    generator=torch.Generator().manual_seed(0))
    randomize_bn(m, torch.Generator().manual_seed(1))
    return m


def _batch(n, seed=2):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, n, 3)) * rng.uniform(0.5, 2.0, (B, 1, 3))
         ).astype(np.float32)
    return x, rng.integers(0, K, B).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("steps",))
def _jax_attack(params, state, x, y, steps):
    """The JAX attack's output, and its gradient at each of its iterates
    (PGD's loop restated, its output tied to the attack's)."""
    def loss(x):
        return jax_losses.nll_loss(
            apply_classifier(params, state, x, train=False)[0], y)

    with use_pallas(False):
        adv = (jax_attacks.iterated_fgsm_points(loss, x, EPS, steps)
               if steps else jax_attacks.fgsm_points(loss, x, EPS))
        grads, xi = [], x
        for _ in range(max(steps, 1)):
            grads.append(jax.grad(loss)(xi))
            xi = x + jnp.clip(xi + EPS / max(steps, 1) * jnp.sign(grads[-1])
                              - x, -EPS, EPS)
        return jnp.stack(grads), adv, xi


def _port_loss(m, y):
    m.eval()

    def loss(x):
        return losses.nll_loss(m(x)[0], y)
    return loss


@pytest.fixture(scope="module")
def attack_batch():
    return _batch(N_ATTACK)


def _pool_winners(monkeypatch):
    """Record, per max-pool of the plain eval path, each channel's
    winning point."""
    winners = []
    plain = encoder_fused.fused_stack_maxpool_plain

    def rec(x, ws, shifts, scales, acts, bf16=False):
        h = x
        for w, sh, sc, act in zip(ws, shifts, scales, acts):
            h = core.activation(torch.matmul(h, w) * sc + sh, act)
        winners.append(h.argmax(dim=1))
        return plain(x, ws, shifts, scales, acts, bf16)

    monkeypatch.setattr(encoder_fused, "fused_stack_maxpool_plain", rec)
    return winners


@pytest.mark.parametrize("steps", [0, 1, 3], ids=["fgsm", "pgd1", "pgd3"])
def test_attacks_match_jax(model, attack_batch, steps, monkeypatch):
    x, y = attack_batch
    params, state = torch_import.classifier_from_state_dict(
        model.state_dict())
    g_steps, adv_ref, restated = map(np.asarray, _jax_attack(
        params, state, jnp.asarray(x), jnp.asarray(y), steps))
    if steps:
        assert np.array_equal(restated, adv_ref)
    g_ref = g_steps[0]
    m = PointNetCls(K)
    m.load_state_dict(model.state_dict())
    loss = _port_loss(m, torch.from_numpy(y))
    winners = _pool_winners(monkeypatch)
    g = attacks.input_grad(loss, torch.from_numpy(x)).numpy()
    scale = np.abs(g_ref).max()
    assert np.abs(g - g_ref).max() <= GRAD_REL * scale
    won = np.zeros((B, N_ATTACK), bool)
    for w in winners:
        for b in range(B):
            won[b, w[b].numpy()] = True
    assert len(winners) == 2 and won.any() and not won.all()
    assert (g[~won] == 0).all() and (g_ref[~won] == 0).all()
    adv = (attacks.iterated_fgsm_points(loss, torch.from_numpy(x), EPS, steps)
           if steps else attacks.fgsm_points(loss, torch.from_numpy(x), EPS))
    assert not adv.requires_grad
    adv = adv.numpy()
    # The sign-flip rule, at every iterate's JAX gradient.
    near = np.zeros_like(adv, bool)
    for gs in g_steps:
        near |= (np.abs(gs) < NEAR_ZERO * np.abs(gs).max()) & (gs != 0)
    assert near.mean() <= NEAR_SHARE
    assert np.array_equal(adv[~near], adv_ref[~near])
    # Inside the L-inf ball, to the rounding of x's scale.
    assert np.abs(adv - x).max() <= EPS + 1e-6 * np.abs(x).max()


def test_attack_runs_plain_versions_and_touches_nothing(model,
                                                       monkeypatch):
    """Inside the attack no eval kernel wrapper nor per-layer training
    kernel is called (under ``use_pallas_train`` too); an eval forward
    outside calls them. The running statistics, ``num_batches_tracked``
    and the parameters' ``.grad`` stay as they were; train mode is
    restored."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"{name} called")
        return fn

    for mod, name in ((shared_mlp, "fused_linear_affine_act"),
                      (encoder_fused, "fused_stack_maxpool"),
                      (tnet_apply, "tnet_apply")):
        monkeypatch.setattr(mod, name, refuse(name))
    x, y = map(torch.from_numpy, _batch(N_STEP))
    cfg = AdvPerturbConfig(num_points=N_STEP, feature_transform=True)
    m = PointNetCls(K, True, generator=torch.Generator().manual_seed(3))
    m.train()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    with dispatch.use_pallas_train():
        for c in (cfg, AdvPerturbConfig(attack="pgd", attack_steps=2)):
            adv = attacks.attack(m, x, y, c.epsilon,
                                 adv_perturb.attack_steps(c))
            assert adv.shape == x.shape and m.training
    after = m.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert all(p.grad is None for p in m.parameters())
    m.eval()
    with torch.no_grad(), pytest.raises(AssertionError, match="called"):
        m(x)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_step(state, x, y, cfg):
    return jax_adv_perturb._train_step_impl(state, x, y, cfg,
                                            optax.identity())


@pytest.mark.parametrize("attack,steps", [("fgsm", 1), ("pgd", 3)])
def test_train_step_matches_jax(model, attack, steps):
    x, y = _batch(N_STEP, seed=4)
    params, bn = torch_import.classifier_from_state_dict(model.state_dict())
    jcfg = JaxAdvPerturbConfig(num_points=N_STEP, dropout=0.0, attack=attack,
                               attack_steps=steps)
    new, ref = _jax_step(
        jax_state.TrainState(params, bn, optax.identity().init(params),
                             jnp.zeros((), jnp.int32),
                             jax.random.PRNGKey(0)),
        jnp.asarray(x), jnp.asarray(y), jcfg)
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   new.params, params)
    cfg = AdvPerturbConfig(num_points=N_STEP, dropout=0.0, attack=attack,
                           attack_steps=steps)
    m = PointNetCls(K)
    m.load_state_dict(model.state_dict())
    tx = adv_perturb.make_tx(cfg, 10)
    st = adv_perturb.create_state(cfg, 10, device="cpu", model=m)
    got = adv_perturb.train_step(st, *map(torch.from_numpy, (x, y)), cfg=cfg,
                                 tx=tx)
    scale = max(1.0, abs(float(ref["loss"])))
    assert abs(float(got["loss"]) - float(ref["loss"])) <= RTOL * scale
    want = convert.classifier_state_dict(grads, new.bn_state)
    named = dict(st.model.named_parameters())
    gscale = max(float(want[k].abs().max()) for k in named)
    for k, p in named.items():
        assert float((p.grad - want[k]).abs().max()) <= \
            GRAD_TOL * (1 + gscale), k
    sd = st.model.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            s = max(1.0, float(v.abs().max()))
            assert float((sd[k] - v).abs().max()) <= RTOL * s, k
    assert st.step == 1


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_attack_runs_in_the_configs_precision(model, monkeypatch, bf16):
    """Under ``--bf16`` the attack runs inside ``core.mixed_precision``,
    as the JAX package's attack runs in its runner's bf16 scope; in fp32
    outside any scope."""
    seen = []
    attack = attacks.attack

    def spy(*args, **kwargs):
        seen.append(core.compute_dtype())
        return attack(*args, **kwargs)

    monkeypatch.setattr(attacks, "attack", spy)
    x, y = map(torch.from_numpy, _batch(N_STEP, seed=6))
    cfg = AdvPerturbConfig(num_points=N_STEP, dropout=0.0, bf16=bf16)
    m = PointNetCls(K)
    m.load_state_dict(model.state_dict())
    st = adv_perturb.create_state(cfg, 10, device="cpu", model=m)
    adv_perturb.train_step(st, x, y, cfg=cfg, tx=adv_perturb.make_tx(cfg, 10))
    assert seen == [torch.bfloat16 if bf16 else None]


def test_pgd_one_step_takes_fgsm_path(model):
    x, y = map(torch.from_numpy, _batch(N_STEP, seed=5))
    m = PointNetCls(K)
    m.load_state_dict(model.state_dict())
    pgd1 = AdvPerturbConfig(attack="pgd", attack_steps=1)
    assert adv_perturb.attack_steps(pgd1) == 0
    assert adv_perturb.attack_steps(AdvPerturbConfig()) == 0
    assert adv_perturb.attack_steps(AdvPerturbConfig(
        attack="pgd", attack_steps=3)) == 3
    a = attacks.attack(m, x, y, EPS, adv_perturb.attack_steps(pgd1))
    assert torch.equal(a, attacks.fgsm_points(_port_loss(m, y), x, EPS))


def test_run_adv_perturb_and_eval_robustness(tmp_path, capsys):
    out = str(tmp_path / "advp")
    result = train_adv_perturb.main([
        "--cpu", "--nepoch", "1", "--batchSize", "8", "--num_points", "32",
        "--outf", out, "--quiet"])
    assert result["state"].step == 8
    assert sorted(p for p in __import__("os").listdir(out)) == [
        "0", "advp_epochs.csv", "advp_metrics.csv"]
    capsys.readouterr()
    accs = eval_robustness.main(["--model", out, "--cpu", "--num_points",
                                 "32", "--batchSize", "5", "--epsilons", "0",
                                 "0.05"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[-2:] == [f"eps={e:<6g} FGSM accuracy: {accs[e]:.4f}"
                            for e in (0.0, 0.05)]
    cfg = AdvPerturbConfig(batch_size=5, num_points=32)
    _, _, x_te, y_te = runner._modelnet_arrays(cfg)
    assert len(x_te) % 5
    plain = eval_lib.evaluate_classifier(result["state"].model, x_te, y_te, 5)
    assert accs[0.0] == plain["accuracy"]
