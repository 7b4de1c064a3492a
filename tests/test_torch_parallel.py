"""The port's data parallelism (``parallel/dist.py``) against one device
and against the JAX package's DP mesh.

The ranks are gloo processes on the CPU, spawned once per world size for
the whole module (``parallel.steps.run_many``); every test asserts on
the saved results. Each rank takes its rows of a global numpy batch that
every rank is given whole.

* **W = 2 and 4 against W = 1**, configs 1, 3, 4 and 5, with rotate,
  jitter, point dropout and a resample from 40 to 32 points on, through
  the generator's chain and through ``augment_fused``'s plain twin with
  ``cloud0``; ``--fused_epoch`` (config 4 at W = 2 and 4, config 1 at 2:
  the steps and the eval scan); config 3 under ``use_pallas_train`` (the
  per-layer kernels' plain versions, the single-stream T-Net heads
  through ``fc_head_train`` on the gathered global batch). Every loss
  within rel 1e-5, ``acc`` within two flipped points, every gradient
  within 1e-4 x (1 + the largest |g| of its net), every running
  statistic, every parameter and buffer bit-equal across the ranks. These run in float64: in fp32 this model's gradients
  move by up to 1e-2 of their scale when one device merely sums the
  batch in another order (the reversed batch at W = 1 moves
  ``feat.stn.conv1.weight`` by 7.7e-3 of 1 + its scale), which no
  data-parallel bound can beat; in float64 that noise is below 1e-13.
  In fp32 the dry run (W = 2), the multihost check and the JAX
  comparisons (W = 4) hold the losses and the ranks' bit-equality.
* **The bounds catch the fault they guard**: per-rank BN statistics
  planted at W = 2 (``steps.with_fault("local_bn")``) miss them by O(1).
* **Against the JAX package** on conftest's 8-device CPU mesh, fp32,
  augmentation off (the two packages' generators differ), the same
  weights through ``utils/convert.py``: config 4 at W = 4 against
  ``adversarial._train_step_impl`` on ``make_mesh(4)`` and config 1 at
  W = 2 against ``classify._train_step_impl`` on ``make_mesh(2)``, each
  with ``optax.identity()`` so that new - old parameters are the
  gradients: losses rel 1e-5, gradients by ``tests/test_sharding.py``'s
  ``_grad_close`` rule (2e-2 of 1 + the largest |g|).
* ``dryrun_multichip`` at W = 2 and ``multihost_check`` (2 hosts x 2
  ranks) pass their own checks on the CPU (``--device cpu``; both take the
  card by default and raise without one); the runner at ``--num_devices 2`` (configs
  3 and 4, one epoch on the synthetic fixture) takes W = 1's first step
  and writes from rank 0 alone; the refusals (B % W, ``--num_devices``
  above the cards on CUDA).
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.configs import (
    AdversarialConfig as JaxAdversarialConfig,
    ClassifyConfig as JaxClassifyConfig,
)
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.parallel import (
    make_mesh, shard_batch,
)
from adversarial_learning_on_pointclouds_tpu.parallel.mesh import (
    replicate_tree,
)
from adversarial_learning_on_pointclouds_tpu.train import (
    adversarial as jax_adv, classify as jax_cls, state as jax_state,
)
from adversarial_learning_on_pointclouds_tpu_torch import (
    dryrun_multichip, multihost_check,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist, steps
from adversarial_learning_on_pointclouds_tpu_torch.utils import convert

B, N, N_SRC = 8, 32, 40
PARTS, CLASSES = 6, 4
WORLDS = (2, 4)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
JAX_GRAD_RTOL = 2e-2
AUG = dict(augment=True, point_dropout=True)
CONFIGS = {
    "cls": ("classify", dict(num_classes=CLASSES)),
    "advp": ("adv_perturb", dict(num_classes=CLASSES)),
    "seg": ("segment", dict(num_parts=PARTS)),
    "adv": ("adversarial", dict(num_parts=PARTS)),
}
AUGS = ("gen", "fused")
POOL, TEST, SPE = 16, 8, 2


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, N_SRC, 3)).astype(np.float32)
    xu = rng.standard_normal((B, N_SRC, 3)).astype(np.float32)
    y = rng.integers(0, PARTS, (B, N_SRC)).astype(np.int32)
    lab = (np.arange(B) % CLASSES).astype(np.int32)
    return {"cls": (x, lab), "advp": (x, lab), "seg": (x, y),
            "adv": (x, y, xu)}


def _cfg(name, aug):
    kind, kw = CONFIGS[name]
    return kind, dict(batch_size=B, num_points=N, pallas_augment=aug == "fused",
                      **AUG, **kw)


def _epoch_data():
    rng = np.random.default_rng(2)
    px = rng.standard_normal((POOL, N, 3)).astype(np.float32)
    py = rng.integers(0, PARTS, (POOL, N)).astype(np.int32)
    pu = rng.standard_normal((POOL, N, 3)).astype(np.float32)
    tx = rng.standard_normal((TEST, N, 3)).astype(np.float32)
    ts = rng.integers(0, PARTS, (TEST, N)).astype(np.int32)
    tc = np.zeros((TEST,), np.int64)
    idx_l = rng.permutation(POOL)[:SPE * B].reshape(SPE, B).astype(np.int64)
    idx_u = rng.permutation(POOL)[:SPE * B].reshape(SPE, B).astype(np.int64)
    te_idx = np.arange(TEST, dtype=np.int64).reshape(1, TEST)
    lab = (np.arange(POOL) % CLASSES).astype(np.int64)
    return {
        "epoch-adv": dict(kind="adversarial", cfg_kw=dict(
            num_parts=PARTS, batch_size=B, num_points=N, **AUG),
            pools=(px, py, pu), idx=(idx_l, idx_u), test=(tx, ts, tc),
            te_idx=te_idx),
        "epoch-cls": dict(kind="classify", cfg_kw=dict(
            num_classes=CLASSES, batch_size=B, num_points=N, **AUG),
            pools=(px, lab), idx=(idx_l,), test=(tx,), te_idx=te_idx),
    }


def _jax_models():
    """JAX weights (numpy) for the cross-package checks, and the port's
    state dicts of them (``utils/convert.py``)."""
    from adversarial_learning_on_pointclouds_tpu.models import (
        init_classifier, init_discriminator, init_segmenter,
    )
    gp, gs = init_segmenter(jax.random.PRNGKey(0), PARTS,
                            feature_transform=True)
    dp = init_discriminator(jax.random.PRNGKey(1), PARTS)
    cp, cs = init_classifier(jax.random.PRNGKey(2), CLASSES,
                             feature_transform=False)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    gp, gs, dp, cp, cs = map(to_np, (gp, gs, dp, cp, cs))
    sd = lambda d: {k: v.numpy() for k, v in d.items()}  # noqa: E731
    return dict(
        jax=dict(g=(gp, gs), d=dp, cls=(cp, cs)),
        adv={"g": sd(convert.segmenter_state_dict(gp, gs)),
             "d": sd(convert.discriminator_state_dict(dp))},
        cls={"model": sd(convert.classifier_state_dict(cp, cs))})


def _jax_batch():
    rng = np.random.default_rng(4)
    return (rng.standard_normal((B, N, 3)).astype(np.float32),
            rng.integers(0, PARTS, (B, N)).astype(np.int32),
            rng.standard_normal((B, N, 3)).astype(np.float32),
            (np.arange(B) % CLASSES).astype(np.int32))


def _calls(w, models, tmp):
    """The rank functions a world size runs (``w`` 1: the reference)."""
    data = _data()
    calls = []
    for name in CONFIGS:
        for aug in AUGS:
            kind, cfg = _cfg(name, aug)
            kw = dict(kind=kind, cfg_kw=cfg, batches=[data[name]])
            calls.append((f"{name}-{aug}", steps.run_steps, kw, "float64"))
    kind, cfg = _cfg("seg", "gen")
    calls.append(("seg-switch", steps.run_steps, dict(
        kind=kind, cfg_kw=cfg, batches=[data["seg"]], switch=True),
        "float64"))
    for name, kw in _epoch_data().items():
        if name == "epoch-adv" or w < 4:
            calls.append((name, steps.run_fused_epoch, kw, "float64"))
    if w == 2:
        kind, cfg = _cfg("adv", "gen")
        calls.append(("fault-local_bn", steps.with_fault, dict(
            fault="local_bn", fn=steps.run_steps, kwargs=dict(
                kind=kind, cfg_kw=cfg, batches=[data["adv"]])), "float64"))
    x, y, xu, lab = _jax_batch()
    if w in (1, 4):
        calls.append(("jax-adv", steps.run_steps, dict(
            kind="adversarial", cfg_kw=dict(num_parts=PARTS, batch_size=B,
                                            num_points=N),
            batches=[(x, y, xu)], weights=models["adv"]), "float32"))
        cfg_kw, batch = multihost_check.scenario()
        calls.append(("multihost", multihost_check.host_rank if w == 4
                      else steps.run_steps,
                      dict(cfg_kw=cfg_kw, batch=batch, device="cpu")
                      if w == 4 else
                      dict(kind="adversarial", cfg_kw=cfg_kw,
                           batches=[batch], device="cpu"), "float32"))
    if w in (1, 2):
        calls.append(("jax-cls", steps.run_steps, dict(
            kind="classify", cfg_kw=dict(num_classes=CLASSES, batch_size=B,
                                         num_points=N, dropout=0.0),
            batches=[(x, lab)], weights=models["cls"]), "float32"))
        drc = (dryrun_multichip.reference_calls(2, "cpu") if w == 1
               else dryrun_multichip.calls(2, "cpu"))
        calls += [(f"dryrun/{n}", fn, kw, dt) for n, fn, kw, dt in drc]
        for mod, kind in (("train_segmentation", "seg"),
                          ("train_adversarial", "adv")):
            out = os.path.join(tmp, f"{kind}{w}")
            calls.append((f"runner-{kind}", steps.run_cli, dict(
                module=f"adversarial_learning_on_pointclouds_tpu_torch.{mod}",
                argv=["--cpu", "--num_devices", str(w), "--nepoch", "1",
                      "--batchSize", str(B), "--num_points", str(N),
                      "--ckpt_policy", "every", "--quiet", "--outf", out],
                out_dir=out), "float32"))
    return calls


@pytest.fixture(scope="module")
def models():
    return _jax_models()


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    """``{w: [rank results]}``, and ``"jax"``: the JAX package's mesh
    steps. Each world size's ranks are one spawn, run in the background
    while this process runs W = 1 and the JAX steps."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        spawned = {w: pool.submit(dist.spawn, steps.run_many, w,
                                  args=(_calls(w, models, tmp),))
                   for w in WORLDS}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)     # as each rank runs
        try:
            out = {1: [steps.run_many(_calls(1, models, tmp))]}
        finally:
            torch.set_num_threads(threads)
        out["jax"] = {"adv": _jax_adv_step(models), "cls": _jax_cls_step(models)}
        out.update({w: f.result() for w, f in spawned.items()})
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-8)


def _losses_close(got, ref, npts, rtol=LOSS_RTOL):
    for k in ref:
        if k == "acc":
            assert abs(got[k] - ref[k]) <= 2.0 / npts + 1e-12, (k, got[k],
                                                               ref[k])
        else:
            assert _rel(got[k], ref[k]) < rtol, (k, got[k], ref[k],
                                                 _rel(got[k], ref[k]))


def _grad_err(got, ref):
    """The worst leaf's ``max |g - g_ref|`` over 1 + the net's largest
    ``|g_ref|``, over the nets."""
    worst = 0.0
    for net in ref:
        assert set(got[net]) == set(ref[net]), net
        scale = max(float(np.abs(g).max()) for g in ref[net].values())
        for k, g in ref[net].items():
            worst = max(worst, float(np.abs(got[net][k] - g).max())
                        / (1.0 + scale))
    return worst


def _npts(name):
    return B * (N if name in ("seg", "adv") else 1)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("aug", AUGS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_losses_match_one_device(runs, name, aug, w):
    key = f"{name}-{aug}"
    _losses_close(runs[w][0][key]["metrics"][0],
                  runs[1][0][key]["metrics"][0], _npts(name))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("aug", AUGS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_gradients_match_one_device(runs, name, aug, w):
    key = f"{name}-{aug}"
    assert _grad_err(runs[w][0][key]["grads"],
                     runs[1][0][key]["grads"]) <= GRAD_RTOL


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("aug", AUGS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_running_statistics_match_one_device(runs, name, aug, w):
    """Every BatchNorm buffer after the step is the global batch's."""
    key = f"{name}-{aug}"
    for net, bufs in runs[1][0][key]["buffers"].items():
        for k, ref in bufs.items():
            np.testing.assert_allclose(runs[w][0][key]["buffers"][net][k],
                                       ref, rtol=1e-9, atol=1e-12,
                                       err_msg=f"{net}.{k}")


@pytest.mark.parametrize("w", WORLDS)
def test_per_layer_kernels_switch_matches_one_device(runs, w):
    """Config 3 under ``use_pallas_train``: ``pointwise_matmul`` for conv1,
    the single-stream T-Net heads through ``fc_head_train`` on the
    gathered global batch."""
    got, ref = runs[w][0]["seg-switch"], runs[1][0]["seg-switch"]
    _losses_close(got["metrics"][0], ref["metrics"][0], _npts("seg"))
    assert _grad_err(got["grads"], ref["grads"]) <= GRAD_RTOL


@pytest.mark.parametrize("w", WORLDS)
def test_every_rank_holds_the_same_state(runs, w):
    for r, res in enumerate(runs[w]):
        for name, out in res.items():
            if isinstance(out, dict) and "same" in out \
                    and not name.startswith("fault-"):
                assert out["same"], (r, name)
                assert out["world"] == w and out["rank"] == r


@pytest.mark.parametrize("name,w", [("epoch-adv", 2), ("epoch-adv", 4),
                                    ("epoch-cls", 2)])
def test_fused_epoch_matches_one_device(runs, name, w):
    got, ref = runs[w][0][name], runs[1][0][name]
    assert len(got["metrics"]) == SPE
    for g, r in zip(got["metrics"], ref["metrics"]):
        _losses_close(g, r, B * (N if name == "epoch-adv" else 1))
    assert _grad_err(got["grads"], ref["grads"]) <= GRAD_RTOL
    if isinstance(ref["eval"], dict):
        for k, v in ref["eval"].items():
            assert got["eval"][k].shape == v.shape == (1, TEST)
            np.testing.assert_allclose(got["eval"][k], v, atol=1e-9)
    else:
        np.testing.assert_array_equal(got["eval"], ref["eval"])


@pytest.mark.parametrize("w", WORLDS)
def test_collectives_of_a_step(runs, w):
    """A config-4 step issues its statistic all-reduces, one gather a T-Net
    head (forward and backward) and one gradient bucket a network; world
    size 1 issues none."""
    assert runs[1][0]["adv-gen"]["collectives"] == {}
    c = runs[w][0]["adv-gen"]["collectives"]
    assert c["grads"][0] == 2
    assert c["gather"][0] == 2 * 2     # 2 T-Nets' paired heads, fwd + bwd
    assert c["stats"][0] > 10


def test_planted_local_batch_norm_fails_the_check(runs):
    """Per-rank BN statistics (``with_fault("local_bn")``) at W = 2 miss
    W = 1 by O(1): the gradient bound is missed by more than a thousand
    times, and the losses by far more than their bound."""
    got = runs[2][0]["fault-local_bn"]
    ref = runs[1][0]["adv-gen"]
    assert _grad_err(got["grads"], ref["grads"]) > 1e3 * GRAD_RTOL
    with pytest.raises(AssertionError):
        _losses_close(got["metrics"][0], ref["metrics"][0], B * N)
    assert _grad_err(runs[2][0]["adv-gen"]["grads"],
                     ref["grads"]) <= GRAD_RTOL


def _grad_close(got, want, rtol=JAX_GRAD_RTOL):
    """``tests/test_sharding.py``'s rule: every leaf within ``rtol * (1 +
    the largest |g| of the tree)``."""
    scale = max(float(np.abs(g).max()) for g in want.values())
    for k, g in want.items():
        d = float(np.abs(got[k] - g).max())
        assert d <= rtol * (1.0 + scale), (k, d, scale)


def _jax_grads(new, old):
    return jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b, new, old)


def _jax_adv_step(models):
    """Config 4 on ``make_mesh(4)``: ``(metrics, {net: gradients})``."""
    (gp, gs), dp = models["jax"]["g"], models["jax"]["d"]
    x, y, xu, _ = _jax_batch()
    jcfg = JaxAdversarialConfig(num_parts=PARTS, batch_size=B, num_points=N)
    tx = optax.identity()
    st = jax_state.GANTrainState(
        g_params=gp, g_bn_state=gs, g_opt_state=tx.init(gp), d_params=dp,
        d_opt_state=tx.init(dp), step=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(0))
    mesh = make_mesh(4)
    with use_pallas(False):
        new, m = jax.jit(lambda s, *b: jax_adv._train_step_impl(
            s, *b, jcfg, tx, tx))(replicate_tree(mesh, st),
                                  *shard_batch(mesh, (x, y, xu)))
    return ({k: float(v) for k, v in m.items()},
            {"g": {k: v.numpy() for k, v in convert.segmenter_state_dict(
                _jax_grads(new.g_params, gp), gs).items()},
             "d": {k: v.numpy() for k, v in convert.discriminator_state_dict(
                 _jax_grads(new.d_params, dp)).items()}})


def test_config4_at_four_ranks_matches_jax_mesh(runs):
    metrics, grads = runs["jax"]["adv"]
    got = runs[4][0]["jax-adv"]
    _losses_close(got["metrics"][0], metrics, B * N)
    for net in ("g", "d"):
        _grad_close(got["grads"][net],
                    {k: grads[net][k] for k in got["grads"][net]})


def _jax_cls_step(models):
    """Config 1 on ``make_mesh(2)``: ``(metrics, gradients)``."""
    cp, cs = models["jax"]["cls"]
    x, _, _, lab = _jax_batch()
    jcfg = JaxClassifyConfig(num_classes=CLASSES, batch_size=B, num_points=N,
                             dropout=0.0)
    tx = optax.identity()
    st = jax_state.TrainState(params=cp, bn_state=cs, opt_state=tx.init(cp),
                              step=jnp.zeros((), jnp.int32),
                              rng=jax.random.PRNGKey(0))
    mesh = make_mesh(2)
    with use_pallas(False):
        new, m = jax.jit(lambda s, *b: jax_cls._train_step_impl(
            s, *b, jcfg, tx))(replicate_tree(mesh, st),
                              *shard_batch(mesh, (x, lab)))
    return ({k: float(v) for k, v in m.items()},
            {k: v.numpy() for k, v in convert.classifier_state_dict(
                _jax_grads(new.params, cp), cs).items()})


def test_config1_at_two_ranks_matches_jax_mesh(runs):
    metrics, want = runs["jax"]["cls"]
    got = runs[2][0]["jax-cls"]
    _losses_close(got["metrics"][0], metrics, B)
    _grad_close(got["grads"]["model"],
                {k: want[k] for k in got["grads"]["model"]})


def test_dryrun_multichip_at_two_ranks(runs):
    ref = {k[len("dryrun/"):]: v for k, v in runs[1][0].items()
           if k.startswith("dryrun/")}
    got = {k[len("dryrun/"):]: v for k, v in runs[2][0].items()
           if k.startswith("dryrun/")}
    lines = dryrun_multichip.check(got, ref, 2)
    assert len(lines) == 6 and all(" OK" in ln for ln in lines)


def test_multihost_two_hosts_of_two_ranks(runs):
    outs = [res["multihost"] for res in runs[4]]
    assert [(o["host"], o["local"]) for o in outs] == [(0, 0), (0, 1),
                                                      (1, 0), (1, 1)]
    lines = multihost_check.check(outs, runs[1][0]["multihost"]["metrics"][0])
    assert lines[-1] == "MULTIHOST OK"


@pytest.mark.parametrize("kind", ["seg", "adv"])
def test_runner_at_two_ranks(runs, kind):
    """``--num_devices 2`` through the CLI's runner for one epoch: the first
    step's metrics as W=1's, one CSV row a step and one an epoch (rank 0
    alone writes), the eval's mIoU finite."""
    ref = runs[1][0][f"runner-{kind}"]["csv"]
    got = runs[2][0][f"runner-{kind}"]
    assert runs[2][1][f"runner-{kind}"]["csv"] is None
    name = "seg" if kind == "seg" else "adv"
    rows, ref_rows = got["csv"][f"{name}_metrics.csv"], \
        ref[f"{name}_metrics.csv"]
    assert len(rows) == len(ref_rows) > 1
    assert [r["step"] for r in rows] == [r["step"] for r in ref_rows]
    keys = [k for k in ref_rows[0] if k.startswith("loss") or k == "acc"]
    _losses_close({k: float(rows[0][k]) for k in keys},
                  {k: float(ref_rows[0][k]) for k in keys}, B * N)
    epochs = got["csv"][f"{name}_epochs.csv"]
    assert len(epochs) == 1 and np.isfinite(float(epochs[0]["instance_miou"]))


def test_batch_that_the_ranks_do_not_divide_raises(monkeypatch):
    """B % W: a rank of a group of 3 cannot take its rows of 8."""
    monkeypatch.setattr(dist, "world_size", lambda: 3)
    monkeypatch.setattr(dist, "rank", lambda: 1)
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        dist.shard_rows(np.zeros((B, 3)))
    assert dist.shard_rows(torch.arange(9)).tolist() == [3, 4, 5]


def test_num_devices_above_the_cards_raises():
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match="CUDA device"):
        dist.resolve_world(visible + 1, "cuda")
    assert dist.resolve_world(0, "cpu") == 1
    assert dist.resolve_world(4, "cpu") == 4


def test_dry_runs_default_to_the_card(monkeypatch):
    """``dryrun_multichip`` and ``multihost_check`` take the first card
    unless ``--device cpu`` asks for the CPU; without a card both raise
    before any rank starts."""
    assert dryrun_multichip.parse_args([]).device == "cuda"
    assert dryrun_multichip.parse_args(["2", "--device", "cpu"]).device \
        == "cpu"
    assert dryrun_multichip.rank_devices(2, "cuda") == ["cuda:0"] * 2
    assert dryrun_multichip.rank_devices(4, "cpu") == ["cpu"] * 4
    assert {kw["device"] for _, _, kw, _ in dryrun_multichip.calls(2)} \
        == {"cuda"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_spawn(*a, **k):
        raise AssertionError("a rank started without a card")

    monkeypatch.setattr(dist, "spawn", no_spawn)
    for main in (lambda: dryrun_multichip.main(["2"]),
                 lambda: multihost_check.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main()
