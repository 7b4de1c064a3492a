"""The port's training runs (``train/runner.py``) and CLIs.

Port only, at B=4, N=64, two epochs on a synthetic pts fixture:
* device-resident pools train exactly as host batches do, ``--scan 2``
  exactly as single steps, for config 3 and config 4;
* ``--resume_full`` from the epoch-0 checkpoint runs epoch 1 again with
  the uninterrupted run's per-step losses, its step count continuing;
* ``--eval_every`` and ``--ckpt_policy`` decide which epochs are
  evaluated and saved;
* the CLIs ``train_segmentation``, ``train_adversarial`` and
  ``eval_segmentation`` run in-process, and the eval CLI reproduces the
  run's last eval; the flags the port cannot honour raise;
* an epoch from the CLI's flags under ``--supervised_only`` (D untouched,
  ``loss_d`` 0 every step) and ``--d_geometry`` (D at 53 channels
  trains).

Against the JAX package: both runners start from the same reference
``.pth`` (and its ``_D.pth``), with augment and resample off, the JAX
package's on its jnp path. Config 3: one epoch of 3 steps at B=16 (64
shapes: 48 train, 8 test in one ragged eval batch). Config 4: two
epochs at B=4 and lr=0, at three labeled ratios (the split as given,
the split raised to one batch, the unlabeled stream falling back to the
whole train set); under ``--d_geometry`` three epochs with G at lr=0
and D learning. At ``lr=0`` every per-step loss lies within 1e-5
(relative) and the eval summary and per-category table within 1e-6; at
the default lr the first step within 1e-5 and the later steps within
5e-3, the JAX package's model-level step bound. Why B=16: from the first
Adam step on, rounding differences grow from step to step, and at B=4
they grow too fast for any bound, the port's own as much as against the
JAX package. On a CPU, with only the thread count changed (another
summation order), the port's B=4 run of a 40-shape fixture differed from
itself by 1.0e-2 at step 4, and from the JAX package's by 5.3e-2; at
B=16 on this fixture the two packages differed by 4.1e-5 and 1.8e-3 at
steps 2 and 3.
"""

import csv
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.configs import (
    AdversarialConfig as JaxAdversarialConfig,
    SegmentConfig as JaxSegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu.train import (
    runner as jax_runner,
)
from adversarial_learning_on_pointclouds_tpu_torch import (
    eval_segmentation, train_adversarial, train_segmentation,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig, SegmentConfig, parse_adversarial_args,
    parse_segment_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.shapenet_part import (
    make_synthetic_shapenet,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    FCDiscriminator, PointNetDenseCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    adversarial, runner, segment,
)

B, N = 4, 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file's small CPU steps run: the
    suite's parallel workers would otherwise oversubscribe the cores,
    which slows such steps many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """40 shapes: 30 train (7 batches of 4, a dropped tail of 2), 5
    test (a ragged last eval batch)."""
    return make_synthetic_shapenet(str(tmp_path_factory.mktemp("sn")), 40,
                                   N, seed=4)


def _rows(out_dir, name):
    with open(os.path.join(out_dir, f"{name}_metrics.csv")) as f:
        return list(csv.DictReader(f))


def _epochs(out_dir, name):
    with open(os.path.join(out_dir, f"{name}_epochs.csv")) as f:
        return list(csv.DictReader(f))


def _losses(out_dir, name, key):
    return [(int(r["step"]), float(r[key])) for r in _rows(out_dir, name)]


def _run(cfg, tmp_path, tag, **kw):
    cfg = dataclasses.replace(cfg, out_dir=str(tmp_path / tag), **kw)
    run = (runner.run_adversarial if isinstance(cfg, AdversarialConfig)
           else runner.run_segmentation)
    return run(cfg, device="cpu"), cfg.out_dir


KINDS = {
    "seg": (SegmentConfig, "loss"),
    "adv": (AdversarialConfig, "loss_g"),
}


@pytest.mark.parametrize("kind", ["seg", "adv"])
def test_device_pools_host_data_and_scan_train_alike(root, tmp_path, kind):
    cls, key = KINDS[kind]
    cfg = cls(batch_size=B, num_points=N, epochs=2, dataset=root,
              quiet=True, augment=True, feature_transform=kind == "seg")
    r_dev, d_dev = _run(cfg, tmp_path, "dev")
    r_host, d_host = _run(cfg, tmp_path, "host", device_data=False)
    r_scan, d_scan = _run(cfg, tmp_path, "scan", scan=2)
    ref = _losses(d_dev, kind, key)
    spe = 7 if kind == "seg" else 3
    assert [s for s, _ in ref] == list(range(1, 2 * spe + 1))
    assert _losses(d_host, kind, key) == ref
    assert _losses(d_scan, kind, key) == ref
    assert r_dev["best_miou"] == r_host["best_miou"] == r_scan["best_miou"]
    # The host path's table is numpy's float64 IoUs, the device path's
    # the float32 ones of shape_ious_device.
    assert r_dev["category_miou"] == pytest.approx(r_host["category_miou"],
                                                   rel=1e-6)
    assert r_dev["category_miou"] == r_scan["category_miou"]
    header = list(_rows(d_dev, kind)[0])
    assert header[:5] == ["epoch", "batch", "step", "step_time_s",
                          "points_per_sec_per_chip"]
    assert list(_epochs(d_dev, kind)[0]) == [
        "epoch", "instance_miou", "point_accuracy", "num_shapes", "train_s",
        "eval_s", "ckpt_s"]
    assert sorted(os.listdir(d_dev)) == ["0", "1", f"{kind}_epochs.csv",
                                         f"{kind}_metrics.csv"]


@pytest.mark.parametrize("kind", ["seg", "adv"])
def test_resume_full_continues_the_run(root, tmp_path, kind):
    cls, key = KINDS[kind]
    cfg = cls(batch_size=B, num_points=N, epochs=2, dataset=root,
              quiet=True, augment=True, feature_transform=False)
    full, d_full = _run(cfg, tmp_path, "full")
    first = str(tmp_path / "first")
    shutil.copytree(os.path.join(d_full, "0"), os.path.join(first, "0"))
    resumed, d_res = _run(cfg, tmp_path, "resumed", resume=first,
                          resume_full=True)
    ref = _losses(d_full, kind, key)
    got = _losses(d_res, kind, key)
    assert got == ref[len(ref) // 2:]  # epoch 1 again, steps continuing
    assert resumed["state"].step == full["state"].step
    assert resumed["best_miou"] == float(_epochs(d_full, kind)[1][
        "instance_miou"])
    assert [int(r["epoch"]) for r in _epochs(d_res, kind)] == [1]


def test_eval_every_and_best_policy(root, tmp_path, monkeypatch):
    evals = []
    real = runner.eval_lib.evaluate_segmenter_device

    def counting(*a, **k):
        evals.append(1)
        return real(*a, **k)

    monkeypatch.setattr(runner.eval_lib, "evaluate_segmenter_device",
                        counting)
    cfg = SegmentConfig(batch_size=8, num_points=N, epochs=5, dataset=root,
                        quiet=True, feature_transform=False, eval_every=2)
    _, d = _run(cfg, tmp_path, "ee")
    assert len(evals) == 3  # epochs 1, 3 and the last, 4
    assert sorted(int(x) for x in os.listdir(d) if x.isdigit()) == \
        [0, 1, 2, 3, 4]
    evals.clear()
    _, d = _run(cfg, tmp_path, "best", ckpt_policy="best")
    saved = {int(x) for x in os.listdir(d) if x.isdigit()}
    assert len(evals) == 3 and saved and saved <= {1, 3, 4}


def test_cli_train_and_eval_in_process(root, tmp_path, capsys):
    common = ["--cpu", "--nepoch", "2", "--batchSize", str(B),
              "--num_points", str(N), "--dataset", root, "--quiet"]
    seg_dir = str(tmp_path / "s")
    result = train_segmentation.main(common + ["--outf", seg_dir])
    out = capsys.readouterr().out
    assert "final best instance mIoU" in out and "pts layout" in out
    last = float(_epochs(seg_dir, "seg")[-1]["instance_miou"])
    ply = str(tmp_path / "ply")
    ev, table = eval_segmentation.main([
        "--cpu", "--model", seg_dir, "--dataset", root, "--num_points",
        str(N), "--export_ply", ply])
    out = capsys.readouterr().out
    assert ev["instance_miou"] == pytest.approx(last, rel=1e-6)
    assert f"instance mIoU: {last:.4f}" in out
    assert table == pytest.approx(result["category_miou"], rel=1e-6)
    assert sorted(os.listdir(ply)) == [f"shape{i}.ply" for i in range(4)]

    adv_dir = str(tmp_path / "a")
    train_adversarial.main(common + ["--outf", adv_dir, "--scan", "2"])
    assert "final best instance mIoU" in capsys.readouterr().out
    last = float(_epochs(adv_dir, "adv")[-1]["instance_miou"])
    ev, _ = eval_segmentation.main([
        "--cpu", "--adversarial", "--model", adv_dir, "--dataset", root,
        "--num_points", str(N), "--batchSize", "2"])
    assert ev["instance_miou"] == pytest.approx(last, rel=1e-6)


def test_cli_default_fixture_is_pts_in_its_own_directory(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    train_segmentation.main(["--cpu", "--nepoch", "1", "--batchSize", "8",
                             "--num_points", "32", "--quiet", "--outf",
                             str(tmp_path / "out"), "--ckpt_policy", "none"])
    fixture = tmp_path / f"{runner.SYNTHETIC_DIR}_32"
    assert (fixture / "synsetoffset2category.txt").exists()
    assert not list(fixture.glob("*.h5"))
    assert "pts layout" in capsys.readouterr().out
    # Another point count gets a fixture of its own.
    assert runner.default_fixture(16) == str(tmp_path /
                                             f"{runner.SYNTHETIC_DIR}_16")
    assert runner.default_fixture(32) == str(fixture)


def test_profile_dir_writes_a_trace(root, tmp_path):
    cfg = SegmentConfig(batch_size=8, num_points=32, epochs=1, dataset=root,
                        quiet=True, feature_transform=False,
                        ckpt_policy="none",
                        profile_dir=str(tmp_path / "prof"))
    _run(cfg, tmp_path, "p")
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


@pytest.mark.parametrize("argv,error,match", [
    (["--no_pallas"], ValueError, "--cpu"),
    (["--fused_epoch"], NotImplementedError, "item 5"),
    (["--num_devices", "4"], NotImplementedError, "item 15"),
    (["--remat"], NotImplementedError, "not ported"),
])
def test_flags_the_port_cannot_honour_raise(argv, error, match):
    with pytest.raises(error, match=match):
        parse_adversarial_args(argv)
    with pytest.raises(error, match=match):
        parse_segment_args(argv)


@pytest.mark.parametrize("flag", ["--supervised_only", "--d_geometry"])
def test_runner_epoch_under_ablation_flag(root, tmp_path, flag):
    """An epoch of ``run_adversarial`` from the CLI's flags: under
    ``--supervised_only`` D is untouched and ``loss_d`` 0 at every step;
    under ``--d_geometry`` D takes 53 input channels and trains."""
    cfg, device = parse_adversarial_args([
        flag, "--cpu", "--nepoch", "1", "--batchSize", str(B),
        "--num_points", str(N), "--dataset", root, "--ckpt_policy", "none",
        "--quiet", "--outf", str(tmp_path / "adv")])
    d0 = adversarial.create_state(cfg, 1, device="cpu").d_model
    out = runner.run_adversarial(cfg, device=device)
    d_model = out["state"].d_model
    assert d_model.conv1.weight.shape[1] == (53 if cfg.d_geometry else 50)
    losses = [float(r["loss_d"]) for r in _rows(cfg.out_dir, "adv")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert 0.0 <= out["best_miou"] <= 1.0
    moved = any(not torch.equal(a, b) for a, b in zip(
        d_model.state_dict().values(), d0.state_dict().values()))
    if flag == "--supervised_only":
        assert losses == [0.0] * 3 and not moved
    else:
        assert min(losses) > 0.0 and moved


def test_flags_carry_the_jax_names_and_defaults():
    cfg, device = parse_adversarial_args([
        "--bf16", "--pallas_augment", "--paired_trunks", "--scan", "8",
        "--host_data", "--ckpt_policy", "latest", "--log_lag", "0",
        "--lr_D", "3e-4", "--threshold", "0.3", "--manualSeed", "5"])
    assert device == "cuda"
    assert (cfg.bf16, cfg.pallas_augment, cfg.paired_trunks, cfg.scan) == \
        (True, True, True, 8)
    assert (cfg.device_data, cfg.ckpt_policy, cfg.log_lag) == \
        (False, "latest", 0)
    assert (cfg.lr_d, cfg.semi_threshold, cfg.seed) == (3e-4, 0.3, 5)
    seg, device = parse_segment_args(["--cpu"])
    assert device == "cpu" and seg.num_points == 2048
    assert seg.out_dir == "seg" and not seg.feature_transform


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """A reference-format segmenter ``.pth`` with spread weights (random
    BatchNorm affine and statistics), feature transform on, and beside it
    the ``_D.pth`` discriminator that a GAN state's warm start loads."""
    gen = torch.Generator().manual_seed(11)
    model = PointNetDenseCls(50, feature_transform=True, generator=gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                c = mod.num_features
                mod.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                mod.bias.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    path = str(tmp_path_factory.mktemp("pth") / "g.pth")
    torch.save(model.state_dict(), path)
    torch.save(FCDiscriminator(50, generator=gen).state_dict(),
               path[:-len(".pth")] + "_D.pth")
    return path


def _close(got, ref, rtol):
    assert abs(got - ref) <= rtol * max(abs(ref), 1e-12), (got, ref)


@pytest.fixture(scope="module")
def root64(tmp_path_factory):
    return make_synthetic_shapenet(str(tmp_path_factory.mktemp("sn64")), 64,
                                   N, seed=4)


# Config 4's labeled split at B=4 of the 30 train shapes of ``root``:
# ratio -> steps an epoch.
ADV_SPLITS = {
    0.5: 3,  # 15 labeled, 15 unlabeled: 3 batches each
    0.1: 1,  # int(3.0) < B: the labeled split is one batch
    0.9: 6,  # 3 unlabeled shapes: the whole train set stands in
}


@pytest.mark.parametrize("kind,lr,ratio", [
    ("seg", 0.0, None), ("seg", 1e-3, None),
    ("adv", 0.0, 0.5), ("adv", 0.0, 0.1), ("adv", 0.0, 0.9),
])
def test_runner_matches_jax_from_the_same_pth(request, pth, tmp_path,
                                              kind, lr, ratio):
    """Config 3 for one epoch at B=16; config 4 for two epochs at B=4 and
    lr=0 (G and D), where the labeled split, the unlabeled stream on
    ``seed + 1`` (its position kept across epochs) and its fallback to
    the whole train set must give every step the JAX package's rows."""
    kw = dict(num_points=N, quiet=True, feature_transform=True,
              resample=False, lr=lr, resume=pth)
    if kind == "seg":
        kw.update(batch_size=16, epochs=1,
                  dataset=request.getfixturevalue("root64"))
        cfg, jax_cfg = SegmentConfig, JaxSegmentConfig
        run_jax, keys, steps = jax_runner.run_segmentation, ("loss",), 3
    else:
        kw.update(batch_size=B, epochs=2, lr_d=lr, labeled_ratio=ratio,
                  dataset=request.getfixturevalue("root"))
        cfg, jax_cfg = AdversarialConfig, JaxAdversarialConfig
        run_jax, keys = jax_runner.run_adversarial, ("loss_g", "loss_d")
        steps = 2 * ADV_SPLITS[ratio]
    port, d_port = _run(cfg(**kw), tmp_path, "port")
    d_ref = str(tmp_path / "jax")
    ref = run_jax(jax_cfg(out_dir=d_ref, use_pallas=False, num_devices=1,
                          **kw))
    for key in keys:
        got, want = _losses(d_port, kind, key), _losses(d_ref, kind, key)
        assert [s for s, _ in got] == [s for s, _ in want] == \
            list(range(1, steps + 1))
        for i, ((_, g), (_, w)) in enumerate(zip(got, want)):
            _close(g, w, 1e-5 if lr == 0.0 or i == 0 else 5e-3)
    if lr:
        return
    for ev, ev_ref in zip(_epochs(d_port, kind), _epochs(d_ref, kind),
                          strict=True):
        for k in ("instance_miou", "point_accuracy", "num_shapes"):
            assert float(ev[k]) == pytest.approx(float(ev_ref[k]),
                                                 rel=1e-6), k
    table, table_ref = port["category_miou"], ref["category_miou"]
    assert table.keys() == table_ref.keys()
    for k in table:
        assert table[k] == pytest.approx(table_ref[k], rel=1e-6), k
    np.testing.assert_allclose(port["best_miou"], ref["best_miou"],
                               rtol=1e-6)


def test_d_geometry_run_matches_jax_while_d_learns(root, tmp_path):
    """Three epochs of config 4 under ``--d_geometry`` (9 steps at B=4)
    from one ``.pth`` pair (G, and D at width 53), G frozen (lr 0) and D
    learning (lr_d 1e-4), against the JAX package's runner: every step's
    losses within 1e-5, so D's passes, its Adam and schedule, and the
    coordinates on fakes and reals hold over a run, not one step. (With
    G learning too, the runs drift from its first Adam step at this
    batch, as the module docstring says.)"""
    gen = torch.Generator().manual_seed(11)
    pth = str(tmp_path / "g.pth")
    torch.save(PointNetDenseCls(50, True, generator=gen).state_dict(), pth)
    torch.save(FCDiscriminator(53, generator=gen).state_dict(),
               str(tmp_path / "g_D.pth"))
    kw = dict(num_points=N, batch_size=B, epochs=3, lr=0.0, lr_d=1e-4,
              d_geometry=True, resume=pth, dataset=root, quiet=True,
              feature_transform=True, resample=False, ckpt_policy="none")
    _, d_port = _run(AdversarialConfig(**kw), tmp_path, "port")
    d_ref = str(tmp_path / "jax")
    jax_runner.run_adversarial(JaxAdversarialConfig(
        out_dir=d_ref, use_pallas=False, num_devices=1, **kw))
    for key in ("loss_g", "loss_ce", "loss_adv", "loss_semi", "loss_d"):
        got, want = _losses(d_port, "adv", key), _losses(d_ref, "adv", key)
        assert [s for s, _ in got] == [s for s, _ in want] == \
            list(range(1, 10))
        for (_, g), (_, w) in zip(got, want):
            _close(g, w, 1e-5)



def test_runner_bf16_eval_matches_jax(root64, pth, tmp_path, monkeypatch):
    """Under ``--bf16`` the runner's eval runs in the mixed-precision
    scope, as the JAX runner's does: config 3 for one epoch at B=16 and
    lr=0 from one ``.pth``, against the JAX runner on its Pallas path
    (its eval kernels honour the scope; interpret mode). The epoch's eval
    summary is the JAX package's (within 1e-6: both round the same
    operands, and no argmax turns on this fixture); the eval saw the bf16
    scope, and the same run in fp32 evaluates other log-probs."""
    scopes, logps = [], []
    evaluate = runner.eval_lib.evaluate_segmenter_device

    def spy(model, *args, **kwargs):
        scopes.append(core.compute_dtype())
        with torch.no_grad(), segment.eval_mode(model):
            logps.append(model(args[0][:4])[0])
        return evaluate(model, *args, **kwargs)

    monkeypatch.setattr(runner.eval_lib, "evaluate_segmenter_device", spy)
    kw = dict(num_points=N, quiet=True, feature_transform=True,
              resample=False, lr=0.0, resume=pth, batch_size=16, epochs=1,
              dataset=root64, bf16=True)
    _, d_port = _run(SegmentConfig(**kw), tmp_path, "port")
    _run(SegmentConfig(**{**kw, "bf16": False}), tmp_path, "fp32")
    assert scopes == [torch.bfloat16, None]
    assert (logps[0] - logps[1]).abs().max() > 1e-4
    d_ref = str(tmp_path / "jax")
    jax_runner.run_segmentation(JaxSegmentConfig(
        out_dir=d_ref, use_pallas=True, num_devices=1, **kw))
    for ev, ev_ref in zip(_epochs(d_port, "seg"), _epochs(d_ref, "seg"),
                          strict=True):
        for k in ("instance_miou", "point_accuracy", "num_shapes"):
            assert float(ev[k]) == pytest.approx(float(ev_ref[k]),
                                                 rel=1e-6), k
