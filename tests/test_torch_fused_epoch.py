"""``--fused_epoch``: a whole epoch, its steps and the test pass's eval
scan, as one call of the trainer's ``epoch_program``.

Against the JAX package (its generator on the jnp path, its
discriminator's known-logits and detached passes in interpret mode):
``adversarial.epoch_program`` and ``segment.epoch_program`` from the same
weights (carried across with ``utils/convert.py``) on the same numpy
pools and index plans (the synthetic ShapeNet-part fixture). Three steps
at B=16 (ROADMAP's "Small batch" trap: runs drift from the first Adam
step, so across packages B=16 and three steps, or lr=0): every ``[spe]``
loss within 5e-3 scale-relative, the accuracy at the first step
(``_metrics_close`` says why not later). At lr=0 (the parameters stay,
the BatchNorm running statistics move in both) the eval outputs: each
shape's IoU within 1e-5 and its correct-point count equal, except on
shapes where the two packages' argmax differ at a point; such flips are
counted, bounded, and each must lie at a top-2 margin within rounding.

Inside the port, on the CPU: a ``--fused_epoch`` run equals the per-step
run with ``--scan 2`` bit for bit (every logged metric, every eval
summary, the best metric, the final weights) for configs 1-5 over two
epochs, and a fused ``--resume_full`` repeats epoch 1; the three
refusals raise with the JAX package's words; a numpy eval plan raises;
the e2e record twins run at a tiny size and print the JAX scripts' JSON
keys.
"""

import ast
import csv
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.configs import (
    AdversarialConfig as JaxAdversarialConfig,
    SegmentConfig as JaxSegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu.models import (
    apply_segmenter, init_discriminator, init_segmenter,
)
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.train import (
    adversarial as jax_adv, segment as jax_seg, state as jax_state,
)
from adversarial_learning_on_pointclouds_tpu_torch import (
    e2e_adversarial_record, e2e_record,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig, AdvPerturbConfig, ClassifyConfig, SegmentConfig,
    parse_adversarial_args, parse_classify_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.modelnet40 import (
    synthetic_modelnet,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.shapenet_part import (
    make_synthetic_shapenet,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    FCDiscriminator, PointNetDenseCls,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    adversarial, classify, runner, segment,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import convert

B, N, PARTS, STEPS = 16, 32, 50, 3
N_TEST = 20             # two eval batches, the second ragged
RTOL = 5e-3             # the JAX package's model-level step bound
IOU_TOL = 1e-5
# At most this share of the eval points may take another argmax in the
# two packages at lr=0, each at a top-2 margin within MARGIN.
FLIP_SHARE = 1e-3
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Pools, plans and weights from numpy seeds: the synthetic
    ShapeNet-part fixture's 120 train clouds as the labeled and (in
    another order) the unlabeled pool, its N_TEST test clouds unit-sphere
    normalized with their part labels and categories, the ``[STEPS, B]``
    plans of both streams and the ``[2, B]`` eval plan; G and D from the
    JAX package's initializers (one compiled call each)."""
    root = make_synthetic_shapenet(str(tmp_path_factory.mktemp("sn")), 160,
                                   N, seed=22)
    (x, y, _), (te_x, te_s, te_c) = runner._shapenet_arrays(
        SegmentConfig(dataset=root, num_points=N, resample=False))
    rng = np.random.default_rng(22)
    u = x[rng.permutation(len(x))]
    idx_l = np.stack([rng.permutation(len(x))[:B] for _ in range(STEPS)])
    idx_u = np.stack([rng.permutation(len(x))[:B] for _ in range(STEPS)])
    assert len(te_x) == N_TEST
    te = (te_x, te_s, te_c)
    te_idx = runner.eval_lib._eval_indices(N_TEST, B)[0]
    g = jax.jit(functools.partial(init_segmenter, num_parts=PARTS,
                                  feature_transform=True))(
        jax.random.PRNGKey(0))
    d = jax.jit(functools.partial(init_discriminator, num_parts=PARTS))(
        jax.random.PRNGKey(1))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(x=x, y=y, u=u, te=te, idx_l=idx_l, idx_u=idx_u,
                te_idx=te_idx, g=to_np(g), d=to_np(d))


def _t(a):
    return torch.from_numpy(np.array(a))


def _g_model(data):
    g = PointNetDenseCls(PARTS, feature_transform=True)
    g.load_state_dict(convert.segmenter_state_dict(*data["g"]), strict=True)
    return g


def _scaled_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def _metrics_close(ms, ref):
    """Every loss at every step within RTOL; the accuracy, a share of
    argmax hits, at the first step (both packages' weights still equal)
    within two points' flips. From the second step on the weights differ
    by the drift of the first Adam step, and an untrained G's argmax over
    50 near-equal log-probabilities follows it: config 3's third step
    measured 13 of 1024 points apart (1.3e-2), so the later accuracies
    are held through the losses."""
    assert set(ms) == set(ref)
    for k in ms:
        if k == "acc":
            assert abs(float(ms[k][0]) - float(ref[k][0])) <= 2.0 / (B * N)
        else:
            _scaled_close(ms[k].numpy(), ref[k])


def _eval_close(ev, ref, g_model, jax_params, jax_bn, te):
    """Each shape's IoU within IOU_TOL and its correct count equal, but
    where the two packages' argmax differ at a point: such flips are
    counted and bounded, each at a top-2 margin within MARGIN."""
    te_x, _, _ = te
    with segment.eval_mode(g_model):
        logp = g_model(_t(te_x))[0].numpy()
    with use_pallas(False):
        ref_logp = np.asarray(jax.jit(apply_segmenter, static_argnames=(
            "train",))(jax_params, jax_bn, jnp.asarray(te_x),
                       train=False)[0])
    arg, ref_arg = logp.argmax(-1), ref_logp.argmax(-1)
    flips = arg != ref_arg
    assert flips.sum() <= FLIP_SHARE * flips.size, int(flips.sum())
    if flips.any():
        top = np.take_along_axis(ref_logp, ref_arg[..., None], -1)[..., 0]
        other = np.take_along_axis(ref_logp, arg[..., None], -1)[..., 0]
        assert (top - other)[flips].max() <= MARGIN
    mask = runner.eval_lib._eval_indices(N_TEST, B)[1]
    ious = ev["ious"].numpy().reshape(-1)[mask]
    correct = ev["correct"].numpy().reshape(-1)[mask]
    ref_ious = np.asarray(ref["ious"]).reshape(-1)[mask]
    ref_correct = np.asarray(ref["correct"]).reshape(-1)[mask]
    clean = ~flips.any(-1)
    np.testing.assert_allclose(ious[clean], ref_ious[clean], atol=IOU_TOL,
                               rtol=0)
    np.testing.assert_array_equal(correct[clean], ref_correct[clean])
    assert (np.abs(correct - ref_correct) <= flips.sum(-1)).all()


def _adam(lr, b1, b2):
    """The JAX package's Adam with its learning rate held in the optimizer
    state (``optax.inject_hyperparams``), so that one compiled epoch
    program serves both learning rates. Over three steps it is the
    package's ``make_optimizer``: its staircase decay first moves after
    ``lr_step`` epochs."""
    return optax.inject_hyperparams(optax.adam)(learning_rate=lr, b1=b1,
                                                b2=b2, eps=1e-8)


def _opt_state(tx, params, lr):
    state = tx.init(params)
    state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
    return state


KW = dict(num_points=N, batch_size=B, normalize=False)


@pytest.fixture(scope="module")
def jax_adv_setup():
    """JAX's config 4 and its G and D optimizers, one of each for both
    learning rates (a fixture, so the compiled program is reused)."""
    jcfg = JaxAdversarialConfig(**KW)
    return (jcfg, _adam(jcfg.lr, jcfg.beta1, jcfg.beta2),
            _adam(jcfg.lr_d, jcfg.beta1_d, jcfg.beta2_d))


@pytest.mark.parametrize("lr", [1e-3, 0.0])
def test_adversarial_epoch_program_matches_jax(data, jax_adv_setup, lr):
    """Config 4's whole epoch: three G+D steps, then G's eval scan; at
    lr=1e-3 G and D learn (D at its default 1e-4), at 0 neither."""
    jcfg, g_tx, d_tx = jax_adv_setup
    cfg = AdversarialConfig(lr=lr, lr_d=jcfg.lr_d if lr else 0.0, **KW)
    g_params, g_state = data["g"]
    jstate = jax_state.GANTrainState(
        g_params=g_params, g_bn_state=g_state,
        g_opt_state=_opt_state(g_tx, g_params, cfg.lr),
        d_params=data["d"],
        d_opt_state=_opt_state(d_tx, data["d"], cfg.lr_d),
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    with use_pallas(False):
        jstate, ref_ms, ref_ev = jax_adv.epoch_program(
            jstate, *map(jnp.asarray, (data["x"], data["y"], data["u"],
                                       data["idx_l"], data["idx_u"])),
            *map(jnp.asarray, data["te"]), data["te_idx"], cfg=jcfg,
            g_tx=g_tx, d_tx=d_tx)
    d = FCDiscriminator(PARTS)
    d.load_state_dict(convert.discriminator_state_dict(data["d"]),
                      strict=True)
    state = adversarial.create_state(cfg, STEPS, device="cpu",
                                     g_model=_g_model(data), d_model=d)
    txs = adversarial.make_txs(cfg, STEPS)
    ms, ev = adversarial.epoch_program(
        state, *map(_t, (data["x"], data["y"], data["u"])),
        *(_t(a).long() for a in (data["idx_l"], data["idx_u"])),
        *map(_t, data["te"]), _t(data["te_idx"]).long(), cfg=cfg,
        g_tx=txs[0], d_tx=txs[1])
    assert state.step == STEPS and {v.shape for v in ms.values()} == {
        (STEPS,)}
    _metrics_close(ms, ref_ms)
    if lr == 0.0:
        _eval_close(ev, ref_ev, state.g_model, jstate.g_params,
                    jstate.g_bn_state, data["te"])


@pytest.fixture(scope="module")
def jax_seg_setup():
    jcfg = JaxSegmentConfig(**KW)
    return jcfg, _adam(jcfg.lr, jcfg.beta1, jcfg.beta2)


@pytest.mark.parametrize("lr", [1e-3, 0.0])
def test_segment_epoch_program_matches_jax(data, jax_seg_setup, lr):
    """Config 3's whole epoch (the single-network form,
    ``state.epoch_program_fns``): three steps, then the eval scan."""
    jcfg, tx = jax_seg_setup
    cfg = SegmentConfig(lr=lr, **KW)
    g_params, g_state = data["g"]
    jstate = jax_state.TrainState(
        params=g_params, bn_state=g_state,
        opt_state=_opt_state(tx, g_params, lr),
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    with use_pallas(False):
        jstate, ref_ms, ref_ev = jax_seg.epoch_program(
            jstate, jnp.asarray(data["x"]), jnp.asarray(data["y"]),
            jnp.asarray(data["idx_l"]), tuple(map(jnp.asarray, data["te"])),
            data["te_idx"], cfg=jcfg, tx=tx)
    state = segment.create_state(cfg, STEPS, device="cpu",
                                 model=_g_model(data))
    ms, ev = segment.epoch_program(
        state, _t(data["x"]), _t(data["y"]), _t(data["idx_l"]).long(),
        tuple(map(_t, data["te"])), _t(data["te_idx"]).long(), cfg=cfg,
        tx=segment.make_tx(cfg, STEPS))
    assert state.step == STEPS
    _metrics_close(ms, ref_ms)
    if lr == 0.0:
        _eval_close(ev, ref_ev, state.model, jstate.params,
                    jstate.bn_state, data["te"])


# ---------------------------------------------------------------------------
# Inside the port: fused against per-step runs, refusals, the e2e twins
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """40 shapes of 32 points: 30 train (7 batches of 4), 5 test."""
    return make_synthetic_shapenet(str(tmp_path_factory.mktemp("small")),
                                   40, 32, seed=4)


def _csv(out_dir, name, kind):
    with open(os.path.join(out_dir, f"{name}_{kind}.csv")) as f:
        return list(csv.DictReader(f))


# Each config's runner, config class, run name and best metric; configs 1
# and 2 differ by the feature transform.
RUNS = {
    "1": (runner.run_classification, ClassifyConfig, "cls",
          "best_accuracy", dict(feature_transform=False)),
    "2": (runner.run_classification, ClassifyConfig, "cls",
          "best_accuracy", dict(feature_transform=True)),
    "3": (runner.run_segmentation, SegmentConfig, "seg", "best_miou", {}),
    "4": (runner.run_adversarial, AdversarialConfig, "adv", "best_miou",
          dict(labeled_ratio=0.5)),
    "5": (runner.run_adv_perturb, AdvPerturbConfig, "advp",
          "best_accuracy", {}),
}


@pytest.mark.parametrize("config", sorted(RUNS))
def test_fused_epoch_run_equals_per_step_run(root, tmp_path, monkeypatch,
                                             config):
    """Two epochs with augmentation (the generator's draws in the same
    order) of ``--fused_epoch`` against ``--scan 2`` (config 4's 3 steps
    an epoch end on a single step): every logged metric, every eval row
    and table, the best metric and the final weights bit for bit. The
    classifiers read a ModelNet40 fixture of 28 train and 10 test clouds
    (7 steps an epoch, a ragged eval batch)."""
    monkeypatch.setattr(runner, "synthetic_modelnet", functools.partial(
        synthetic_modelnet, 28, 10, 32))
    run, cls, name, key, extra = RUNS[config]
    kw = dict(batch_size=4, num_points=32, epochs=2, quiet=True,
              ckpt_policy="none", augment=True, scan=2, **extra)
    if name in ("seg", "adv"):
        kw["dataset"] = root
    results, rows = {}, {}
    for fused in (False, True):
        cfg = cls(out_dir=str(tmp_path / str(fused)), fused_epoch=fused,
                  **kw)
        results[fused] = run(cfg, device="cpu")
        timing = ("step_time_s", "points_per_sec_per_chip", "train_s",
                  "eval_s", "ckpt_s")
        rows[fused] = [[{k: v for k, v in r.items() if k not in timing}
                        for r in _csv(cfg.out_dir, name, kind)]
                       for kind in ("metrics", "epochs")]
    assert rows[True] == rows[False]
    metrics, epochs = rows[True]
    assert len(metrics) == results[True]["state"].step and len(epochs) == 2
    assert results[True][key] == results[False][key]
    assert results[True].get("category_miou") == \
        results[False].get("category_miou")
    models = [r["state"].g_model if name == "adv" else r["state"].model
              for r in (results[False], results[True])]
    for (k, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        assert torch.equal(a, b), k


def test_fused_epoch_resume_full_continues_the_run(root, tmp_path):
    """Config 4 under ``--fused_epoch``: ``--resume_full`` from the
    epoch-0 checkpoint runs epoch 1 again with the uninterrupted run's
    per-step metrics (the unlabeled stream advanced past epoch 0's
    steps), its step count continuing, and writes the same epoch row."""
    cfg = AdversarialConfig(batch_size=4, num_points=32, epochs=2,
                            dataset=root, quiet=True, augment=True,
                            fused_epoch=True, out_dir=str(tmp_path / "full"))
    full = runner.run_adversarial(cfg, device="cpu")
    first = tmp_path / "first"
    os.makedirs(first)
    os.rename(os.path.join(cfg.out_dir, "0"), first / "0")
    resumed = runner.run_adversarial(dataclasses.replace(
        cfg, out_dir=str(tmp_path / "resumed"), resume=str(first),
        resume_full=True), device="cpu")
    assert resumed["state"].step == full["state"].step == 6
    drop = ("step_time_s", "points_per_sec_per_chip", "train_s", "eval_s",
            "ckpt_s")

    def rows(d, kind):
        return [{k: v for k, v in r.items() if k not in drop}
                for r in _csv(d, "adv", kind)]

    assert rows(tmp_path / "resumed", "metrics") == \
        rows(cfg.out_dir, "metrics")[3:]
    assert rows(tmp_path / "resumed", "epochs") == \
        rows(cfg.out_dir, "epochs")[1:]


@pytest.mark.parametrize("change,match", [
    (dict(device_data=False), "needs device-resident pools"),
    (dict(eval_every=2), "--eval_every is a per-step-path knob"),
    (dict(batch_size=32), "at least one full train batch per epoch"),
])
def test_fused_epoch_refusals(root, tmp_path, change, match):
    """The JAX package's three refusals, in its words."""
    cfg = dataclasses.replace(SegmentConfig(
        batch_size=4, num_points=32, epochs=1, dataset=root, quiet=True,
        ckpt_policy="none", out_dir=str(tmp_path), fused_epoch=True),
        **change)
    with pytest.raises(ValueError, match=match):
        runner.run_segmentation(cfg, device="cpu")


def test_eval_scans_take_a_plan_on_the_pools_device():
    """The eval scans copy nothing from the host: a numpy plan raises."""
    pool = torch.zeros(4, 8, 3)
    plan = np.zeros((1, 4), np.int64)
    model = PointNetDenseCls(PARTS)
    with pytest.raises(TypeError, match="index tensor on cpu"):
        segment.eval_scan(model, pool, pool[..., 0].long(),
                          torch.zeros(4, dtype=torch.long), plan)
    with pytest.raises(TypeError, match="index tensor on cpu"):
        classify.eval_scan(model, pool, plan)
    got = segment.eval_scan(model, pool, pool[..., 0].long(),
                            torch.zeros(4, dtype=torch.long),
                            torch.from_numpy(plan))
    assert got["ious"].shape == (1, 4)


def test_fused_epoch_flag_is_parsed():
    cfg, _ = parse_adversarial_args(["--fused_epoch", "--cpu"])
    assert cfg.fused_epoch
    assert parse_classify_args(["--fused_epoch"])[0].fused_epoch
    assert not parse_classify_args([])[0].fused_epoch


def _json_keys(script):
    """The keys of the dict literal that ``scripts/<script>`` prints."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", script)
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "dumps":
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no json.dumps in {script}")


@pytest.mark.parametrize("twin,argv", [
    (e2e_record, ["--config", "cls"]),
    (e2e_record, ["--config", "seg"]),
    (e2e_record, ["--config", "advp"]),
    (e2e_adversarial_record, ["--fused_epoch", "--scan", "2"]),
], ids=["cls", "seg", "advp", "adv-fused"])
def test_e2e_twin_prints_the_jax_keys(tmp_path, monkeypatch, capsys, twin,
                                      argv):
    """A tiny CPU run of each twin: its last line is the JAX script's JSON
    line, key for key, after one line an epoch."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    record = twin.main(argv + ["--cpu", "--shapes", "48", "--points", "32",
                               "--batch", "8", "--epochs", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    script = twin.__name__.rsplit(".", 1)[1] + ".py"
    assert list(json.loads(lines[-1])) == list(record) == _json_keys(script)
    assert [ln.split(":")[0] for ln in lines if ln.startswith("[e2e]")] == \
        ["[e2e] epoch 0", "[e2e] epoch 1"]
    assert record["epochs"] == 2 and record["wall_s"] > 0
