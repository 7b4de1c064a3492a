"""The port's ablation controls and batching knobs against the JAX
package's, and the adversarial-gain sweep.

* One config-4 G+D step per knob (``supervised_only``, ``self_training``,
  ``d_geometry``, ``paired_conv1``, ``fused_forward``) against the JAX
  package's ``_train_step_impl`` (jitted, its jnp path) at B=8, N=64,
  fp32, augmentation off: the same numpy-seeded weights (carried across
  by ``convert.segmenter_state_dict`` / ``discriminator_state_dict``, D
  at width 53 under ``d_geometry``) and the same points (``normalize``
  off on both sides). JAX's step runs with
  ``optax.identity()``, so each new parameter is the old one plus its
  gradient. Compared: every loss, the labeled log-probs, every new
  running statistic, every G and D gradient, at
  ``tests/test_torch_adversarial_step.py``'s bounds; under the controls
  D stays as it was on both sides.
* Under either control D is not run and not updated, across two steps
  with ``pallas_augment`` (still one ``augment_fused_pair`` a step).
* Twins of ``tests/test_round4.py``'s ``d_geometry`` checkpoint tests (a
  generator-only restore, ``infer --model adv``) and of its sweep tests
  (resume from the ``.partial`` sidecar, ``--seed_base`` and the digest's
  ``--merge``), the sweep with ``--quick --cpu`` on a tiny fixture; the
  port's digest renders the committed JAX artifacts as the JAX package's
  does.
"""

import copy
import io
import json
import os
import tempfile
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.configs import (
    AdversarialConfig as JaxAdversarialConfig,
)
from adversarial_learning_on_pointclouds_tpu.models import (
    apply_discriminator, init_discriminator, init_segmenter,
)
from adversarial_learning_on_pointclouds_tpu.models.segmenter import (
    apply_segmenter_pair,
)
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.train import (
    adversarial as jax_adv, state as jax_state,
)
from adversarial_learning_on_pointclouds_tpu_torch import (
    ablation_adversarial_gain as abl, ablation_digest as dig, infer,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    FCDiscriminator, PointNetDenseCls,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    augment_fused,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    adversarial, runner,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import (
    checkpoint, convert,
)
from tests.test_torch_adversarial_step import (
    RTOL, _grads_close, _randomize_bn, _scaled_close,
)

B, N, PARTS = 8, 64, 50
THRESHOLD = 0.5
KNOBS = ("supervised_only", "self_training", "d_geometry", "paired_conv1",
         "fused_forward")
CONTROLS = ("supervised_only", "self_training")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small CPU steps (the suite's
    parallel workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    """The points both packages take, as they are (``normalize`` off):
    on this fixture's points normalized to the unit sphere the input
    T-Net's fp32 gradients are ill-conditioned under ``fused_forward``
    (JAX's 4.5e-2 of (1 + max|g|) from the float64 step, in which the two
    packages agree within 2e-6)."""
    rng = np.random.default_rng(1)
    x_l, x_u = (rng.normal(size=(B, N, 3)).astype(np.float32)
                for _ in range(2))
    y_l = rng.integers(0, PARTS, size=(B, N)).astype(np.int32)
    return x_l, y_l, x_u


@pytest.fixture(scope="module")
def models(batch):
    """G (random BatchNorm affine and running statistics, its last layer
    scaled up so its maps are far from uniform) and D at widths 50 and 53
    (its last layer scaled up, its bias at the median of its logits on
    the unlabeled stream, so that sigmoid(D) straddles THRESHOLD), as
    numpy trees."""
    g_params, g_state = init_segmenter(jax.random.PRNGKey(0), PARTS,
                                       feature_transform=True)
    g_params = jax.tree_util.tree_map(np.array, g_params)
    g_state = jax.tree_util.tree_map(np.asarray, g_state)
    _randomize_bn(g_params, g_state, np.random.default_rng(0))
    g_params["conv4"]["w"] *= 10
    x_l, _, x_u = map(jnp.asarray, batch)
    with use_pallas(False):
        probs_u = jnp.exp(jax.jit(apply_segmenter_pair)(
            g_params, g_state, x_l, x_u)[1])
    d_trees = {}
    for geo in (False, True):
        d = jax.tree_util.tree_map(np.array, init_discriminator(
            jax.random.PRNGKey(1), PARTS + 3 * geo))
        d["conv5"]["w"] *= 300
        with use_pallas(False):
            d_u = apply_discriminator(d, jax_adv._d_in(probs_u, x_u, geo))
        d["conv5"]["b"] -= np.median(np.asarray(d_u))
        d_trees[geo] = d
    return g_params, g_state, d_trees


def _port_models(g_params, g_state, d_params):
    g = PointNetDenseCls(PARTS, feature_transform=True)
    g.load_state_dict(convert.segmenter_state_dict(g_params, g_state),
                      strict=True)
    d = FCDiscriminator(d_params["conv1"]["w"].shape[0])
    d.load_state_dict(convert.discriminator_state_dict(d_params), strict=True)
    return g.train(), d


def _cfgs(**kw):
    kw = dict(num_points=N, batch_size=B, semi_threshold=THRESHOLD,
              normalize=False, **kw)
    return AdversarialConfig(**kw), JaxAdversarialConfig(**kw)


@pytest.mark.parametrize("knob", KNOBS)
def test_knob_step_matches_jax(models, batch, knob, monkeypatch):
    g_params, g_state, d_trees = models
    d_params = d_trees[knob == "d_geometry"]
    cfg, jcfg = _cfgs(**{knob: True})
    tx = optax.identity()
    jstate = jax_state.GANTrainState(
        g_params=g_params, g_bn_state=g_state, g_opt_state=tx.init(g_params),
        d_params=d_params, d_opt_state=tx.init(d_params),
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))

    def step(st, x_l, y_l, x_u):
        # The step, and its G objective's labeled log-probs (the chain
        # leaves these points as they are: no augmentation, N = num_points).
        new, metrics = jax_adv._train_step_impl(st, x_l, y_l, x_u, jcfg, tx,
                                                tx)
        _, aux = jax_adv._g_loss_fn(st.g_params, st.d_params, st.g_bn_state,
                                    x_l, y_l, x_u, jcfg, jnp.float32(1.0))
        return new, metrics, aux["logp_l"]

    with use_pallas(False):
        new_state, ref, ref_logp = jax.jit(step)(jstate,
                                                 *map(jnp.asarray, batch))
    g_grads, d_grads = (jax.tree_util.tree_map(
        lambda new, old: np.asarray(new) - old, new, old)
        for new, old in ((new_state.g_params, g_params),
                         (new_state.d_params, d_params)))

    g, d = _port_models(g_params, g_state, d_params)
    state = adversarial.create_state(cfg, 10, device="cpu", g_model=g,
                                     d_model=d)
    txs = adversarial.make_txs(cfg, 10)
    seen = []
    g_loss_fn = adversarial.g_loss_fn
    monkeypatch.setattr(adversarial, "g_loss_fn",
                        lambda *a: seen.append(g_loss_fn(*a)) or seen[-1])
    x_l, y_l, x_u = (torch.from_numpy(np.array(a)) for a in batch)
    metrics = adversarial.train_step(state, x_l, y_l.long(), x_u, cfg=cfg,
                                     g_tx=txs[0], d_tx=txs[1])
    assert set(metrics) == set(ref)
    for k in ("loss_g", "loss_ce", "loss_adv", "loss_semi", "loss_d"):
        _scaled_close(metrics[k], ref[k], RTOL)
    assert abs(float(metrics["acc"]) - float(ref["acc"])) <= 2.0 / (B * N)
    _scaled_close(seen[0][1]["logp_l"].detach(), ref_logp, RTOL)

    want = convert.segmenter_state_dict(g_params, new_state.g_bn_state)
    got = g.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 16
    for k in stats:
        _scaled_close(got[k], want[k], RTOL)
    g_want = convert.segmenter_state_dict(g_grads, g_state)
    _grads_close({k: p.grad for k, p in g.named_parameters()},
                 {k: g_want[k] for k, _ in g.named_parameters()})
    d_want = convert.discriminator_state_dict(d_grads)
    if knob in CONTROLS:
        assert all(float(v.abs().max()) == 0.0 for v in d_want.values())
        assert all(p.grad is None for p in d.parameters())
    else:
        _grads_close({k: p.grad for k, p in d.named_parameters()}, d_want)


@pytest.mark.parametrize("control", CONTROLS)
def test_controls_leave_d_untouched(control, monkeypatch):
    """Two steps under a control with ``pallas_augment``: D never runs
    (its methods raise), its parameters are bit-equal, it has no gradient,
    no Adam moment and an unstepped schedule, ``loss_d`` is 0; the
    unlabeled stream is still augmented, one ``augment_fused_pair`` a
    step."""
    cfg = AdversarialConfig(num_points=N, batch_size=B, augment=True,
                            pallas_augment=True, **{control: True})
    state = adversarial.create_state(cfg, 10, device="cpu")
    txs = adversarial.make_txs(cfg, 10)
    d0 = copy.deepcopy(state.d_model.state_dict())
    sched0 = copy.deepcopy(state.d_scheduler.state_dict())

    def refuse(*a, **k):
        raise AssertionError("D ran under an ablation control")

    for name in ("forward", "frozen", "detached", "with_known_logits"):
        monkeypatch.setattr(FCDiscriminator, name, refuse)
    pairs = []
    pair = augment_fused.augment_fused_pair
    monkeypatch.setattr(augment_fused, "augment_fused_pair",
                        lambda *a, **k: pairs.append(1) or pair(*a, **k))
    rng = np.random.default_rng(2)
    for _ in range(2):
        x_l, x_u = (torch.from_numpy(rng.normal(size=(B, N, 3)).astype(
            np.float32)) for _ in range(2))
        y_l = torch.from_numpy(rng.integers(0, PARTS, (B, N)))
        m = adversarial.train_step(state, x_l, y_l, x_u, cfg=cfg,
                                   g_tx=txs[0], d_tx=txs[1])
        assert float(m["loss_d"]) == 0.0 and float(m["loss_adv"]) == 0.0
        assert np.isfinite(float(m["loss_g"]))
    assert len(pairs) == 2
    for k, v in state.d_model.state_dict().items():
        assert torch.equal(v, d0[k]), k
    assert all(p.grad is None for p in state.d_model.parameters())
    assert not state.d_optimizer.state
    assert state.d_scheduler.state_dict() == sched0
    assert state.step == 2


def _geo_state(seed=0, d_geometry=True, num_parts=9):
    cfg = AdversarialConfig(num_points=N, num_parts=num_parts, batch_size=B,
                            feature_transform=True, d_geometry=d_geometry,
                            seed=seed)
    return cfg, adversarial.create_state(cfg, 1, device="cpu")


def test_restore_fields_generator_subtree_d_geometry(tmp_path):
    """A ``d_geometry`` checkpoint restores G alone into a state without
    the flag (D's width 12 against 9 does not block it); the full
    restore there fails naming ``--d_geometry``; ``--resume_full`` into a
    ``d_geometry`` state restores the widened D."""
    _, st_geo = _geo_state(seed=1)
    ckpt = str(tmp_path / "adv_geo")
    checkpoint.save(ckpt, 0, st_geo)
    assert st_geo.d_model.conv1.weight.shape[1] == 12

    _, tmpl = _geo_state(d_geometry=False)
    sub = checkpoint.restore_fields(ckpt, tmpl, ("g_model",))
    for (k, a), b in zip(sub["g_model"].state_dict().items(),
                         st_geo.g_model.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="--d_geometry"):
        checkpoint.restore(ckpt, _geo_state(d_geometry=False)[1])

    _, full = _geo_state()
    checkpoint.restore(ckpt, full)
    for (k, a), b in zip(full.d_model.state_dict().items(),
                         st_geo.d_model.state_dict().values()):
        assert torch.equal(a, b), k


def test_infer_cli_adv_d_geometry_checkpoint(tmp_path, capsys):
    """``infer --model adv`` serves the generator of a ``d_geometry`` run
    (its ``_D.pth`` companion at width 12 beside it); warm-starting a
    state without the flag from the pair fails naming ``--d_geometry``,
    one with the flag takes both."""
    _, st = _geo_state(seed=2)
    g_pth = str(tmp_path / "g.pth")
    torch.save(st.g_model.state_dict(), g_pth)
    torch.save(st.d_model.state_dict(), str(tmp_path / "g_D.pth"))
    pts = tmp_path / "cloud.pts"
    np.savetxt(pts, np.random.default_rng(5).standard_normal((80, 3)))
    infer.main(["--checkpoint", g_pth, "--model", "adv", "--input",
                str(pts), "--num_points", str(N), "--num_parts", "9",
                "--feature_transform", "--device", "cpu"])
    assert capsys.readouterr().out.count("parts {") == 1

    with pytest.raises(ValueError, match="--d_geometry"):
        checkpoint.load_pth_warm_start(g_pth,
                                       _geo_state(d_geometry=False)[1])
    _, warm = _geo_state()
    checkpoint.load_pth_warm_start(g_pth, warm)
    assert torch.equal(warm.d_model.conv1.weight, st.d_model.conv1.weight)


QUICK = ["--quick", "--cpu", "--num_points", "64", "--batchSize", "8"]


@pytest.fixture
def sweep_tmp(tmp_path, monkeypatch):
    """The sweep's fixture and run directories under ``tmp_path``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_ablation_sweep_resumes_from_partial(sweep_tmp, monkeypatch):
    """A sweep cut after its first cell resumes from the ``.partial``
    sidecar and runs only the rest; the artifact holds every cell and the
    sidecar is gone; a sidecar of another sweep configuration is not
    consumed."""
    calls = []
    run = runner.run_adversarial

    def cut(cfg, device="cuda"):
        calls.append((cfg.seed, cfg.supervised_only, cfg.d_geometry, device))
        if len(calls) == 2 and not getattr(cut, "resumed", False):
            raise KeyboardInterrupt("simulated wedge")
        return run(cfg, device=device)

    monkeypatch.setattr(runner, "run_adversarial", cut)
    out = str(sweep_tmp / "abl.json")
    argv = QUICK + ["--modes", "sup", "geo", "--json", out]
    with pytest.raises(KeyboardInterrupt):
        abl.main(argv)
    assert not os.path.exists(out)
    with open(out + ".partial") as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert len(lines) == 1 + 1 and lines[1]["mode"] == "sup"
    assert calls[0] == (0, True, False, "cpu")

    cut.resumed = True
    calls.clear()
    art = abl.main(argv)
    assert calls == [(0, False, True, "cpu")]
    assert [r["mode"] for r in art["runs"]] == ["sup", "geo"]
    assert art["runs"][0] == lines[1] and art["device"] == "cpu"
    assert not os.path.exists(out + ".partial")
    with open(out) as f:
        assert json.load(f)["runs"] == art["runs"]

    with open(out + ".partial", "w") as f:
        f.write(json.dumps({"config_fp": "other"}) + "\n")
    calls.clear()
    abl.main(argv)
    assert len(calls) == 2


def test_ablation_seed_base_extension_and_pooled_digest(sweep_tmp, capsys):
    """``--seed_base`` runs the next seeds, so a second sweep extends the
    first's N; ``ablation_digest --merge`` pools both into one table of
    seed-paired deltas. The artifact's configuration has the JAX sweep's
    keys, so the two packages' artifacts pool."""
    outs = []
    for base in (0, 1):
        out = str(sweep_tmp / f"abl_{base}.json")
        outs.append(out)
        art = abl.main(QUICK + ["--seed_base", str(base), "--modes", "sup",
                                "geo", "--json", out])
        assert sorted({r["seed"] for r in art["runs"]}) == [base]
        assert all(0.0 < r["best_miou"] <= 1.0 for r in art["runs"])
    with open(os.path.join(REPO, "ABLATION_r05_geo_sigma030.json")) as f:
        assert set(json.load(f)["config"]) == set(art["config"])
    capsys.readouterr()
    dig.main(["--merge"] + outs)
    tbl = capsys.readouterr().out
    assert "seeds [0, 1]" in tbl
    row = [ln for ln in tbl.splitlines() if ln.startswith("| 0.5 |")][0]
    assert "geo−sup: " in row and "/2+, p=" in row


@pytest.mark.parametrize("artifact", [
    ["ABLATION_r05_geo_sigma030.json"],
    ["--merge", "ABLATION_r05_geo_sigma030.json",
     "ABLATION_r05_geo_sigma030_s1019.json"]], ids=["one", "merged"])
def test_digest_renders_jax_artifacts_as_jax_does(artifact, monkeypatch):
    from scripts import ablation_digest as jax_dig

    args = [a if a.startswith("--") else os.path.join(REPO, a)
            for a in artifact]
    monkeypatch.setattr("sys.argv", ["ablation_digest.py"] + args)
    outs = []
    for main in (lambda: dig.main(args), jax_dig.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "geo−sup" in outs[0]


def test_sweep_fixture_holds_the_jax_sweeps_arrays(sweep_tmp):
    """The sweep's fixture (npz layout) gives the runner exactly the arrays
    the JAX sweep's h5 fixture gives the JAX runner: every cloud whole, in
    the pools and the eval split alike (the pts layout would resample
    each cloud with replacement)."""
    from adversarial_learning_on_pointclouds_tpu.data import (
        shapenet_part as jax_sn,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.data import (
        shapenet_part as sn,
    )

    a = abl.parse_args(["--num_shapes", "32", "--num_points", "64",
                        "--cluster_parts", "--cluster_sigma", "0.3"])
    root = abl.fixture(a)
    assert sorted(os.listdir(root)) == [f"ply_data_{s}0.npz"
                                        for s in ("test", "train", "val")]
    ref = jax_sn.make_synthetic_shapenet(
        str(sweep_tmp / "jax_h5"), num_shapes=32, num_points=64,
        cluster_parts=True, cluster_sigma=0.3)
    for split in ("train", "test"):
        got, want = sn.ShapeNetPart(root, split), jax_sn.ShapeNetPart(ref,
                                                                     split)
        for fn in ("as_arrays", "as_pool_arrays"):
            for x, y in zip(getattr(got, fn)(64, 1), getattr(want, fn)(64, 1)):
                np.testing.assert_array_equal(x, y)


def test_sweep_flags_are_the_jax_sweeps():
    """The port's sweep takes the JAX sweep's flags, and ``--cpu`` is the
    only way to the CPU."""
    a = abl.parse_args(["--quick", "--modes", "sup", "adv", "geo", "st",
                        "--st_threshold", "0.7", "--seed_base", "3",
                        "--eval_every", "5", "--cluster_parts",
                        "--cluster_sigma", "0.3"])
    assert (a.seeds, a.nepoch, a.num_shapes, a.ratios) == (1, 2, 96, [0.5])
    assert (a.st_threshold, a.seed_base, a.eval_every, a.cluster_parts,
            a.cluster_sigma) == (0.7, 3, 5, True, 0.3)
    assert abl.device_from_args(a) == "cuda"
    assert abl.device_from_args(abl.parse_args(["--cpu"])) == "cpu"
    assert set(abl.CFG_KEYS) == set(vars(abl.parse_args([]))) - {
        "dataset", "json", "quick", "cpu", "no_pallas"}
