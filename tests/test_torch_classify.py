"""The port's classifier (configs 1 and 2) against the JAX package's.

* ``PointNetCls``'s eval and train forwards against ``apply_classifier``
  (jitted) through ``convert.classifier_state_dict`` (B=8, N=64, random
  BatchNorm
  affine and running statistics, with and without the feature
  transform): log-probs within 1e-5 of their scale in fp32, the train
  forward at dropout 0 with its new running statistics; the eval forward
  on the JAX package's jnp path and its Pallas path (interpret mode).
* ``classify.loss_fn`` and its gradients against ``jax.value_and_grad``
  of the JAX ``classify.loss_fn`` at dropout 0, at the step bounds of
  ``tests/test_torch_train_step.py`` (5e-3; gradients 2e-2 * (1 +
  max|g|)); ``train_step`` leaves them in ``.grad``.
* The dropout sits between fc2 and bn2: with one injected mask the train
  forward equals ``tests/torch_ref.py``'s ``PointNetClsTorch``, and the
  mask applied after bn2 instead misses it by far; a mask drawn from a
  generator repeats with the generator's state.
* The synthetic ModelNet40 arrays equal the JAX package's h5 fixture,
  read with ``h5py`` by the port's ``ModelNet40``.
* ``evaluate_classifier`` and ``evaluate_classifier_device`` equal each
  other and the JAX package's (a ragged last batch).
* A ``PointNetCls`` ``.pth`` round trip (``load_classifier``, the JAX
  package's importer), and ``infer --model cls --device cpu`` printing
  the classes of the JAX package's forward, as ``scripts/infer.py``
  prints them.
* ``run_classification``: two tiny epochs, ``--resume_full`` from the
  epoch-0 checkpoint repeating epoch 1 bit for bit, the eval CLI
  reproducing the last eval; the flags that raise.
* ``run_classification`` (config 1) and ``run_adv_perturb`` (config 5)
  against the JAX package's runners from one ``.pth`` on one h5
  fixture, two epochs at lr=0: ``_modelnet_arrays`` exactly, every
  step's loss within 1e-5, each epoch's eval equal.
"""

import copy
import dataclasses
import functools
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adversarial_learning_on_pointclouds_tpu import eval as jax_eval
from adversarial_learning_on_pointclouds_tpu.configs import (
    AdvPerturbConfig as JaxAdvPerturbConfig,
    ClassifyConfig as JaxClassifyConfig,
)
from adversarial_learning_on_pointclouds_tpu.data.modelnet40 import (
    ModelNet40 as JaxModelNet40, make_synthetic_modelnet_h5,
)
from adversarial_learning_on_pointclouds_tpu.models import apply_classifier
from adversarial_learning_on_pointclouds_tpu.ops import dispatch, use_pallas
from adversarial_learning_on_pointclouds_tpu.train import (
    classify as jax_classify, runner as jax_runner,
)
from adversarial_learning_on_pointclouds_tpu.utils import torch_import
from adversarial_learning_on_pointclouds_tpu_torch import (
    eval as eval_lib, eval_classification, infer, train_classification,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdvPerturbConfig, ClassifyConfig, parse_adv_perturb_args,
    parse_classify_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.modelnet40 import (
    ModelNet40, synthetic_modelnet,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetCls, PointNetDenseCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    classify, runner,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import (
    checkpoint, convert,
)
from tests import torch_ref

B, N, K = 8, 64, 40
FWD_TOL = 1e-5     # fp32 forwards, scale-relative
RTOL = 5e-3        # the model-level step bounds of test_torch_train_step.py
GRAD_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file's small CPU steps run: the
    suite's parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize_bn(model, gen):
    """Random BatchNorm affine parameters and running statistics."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                assert m.weight.shape == (c,)


@pytest.fixture(scope="module", params=[False, True], ids=["cfg1", "cfg2"])
def jax_model(request):
    """``(feature_transform, params, bn_state)`` of a seeded classifier
    with random BatchNorm statistics, the JAX package's trees made by its
    ``.pth`` importer from the port's state_dict."""
    ft = request.param
    model = PointNetCls(K, ft, generator=torch.Generator().manual_seed(0))
    randomize_bn(model, torch.Generator().manual_seed(1))
    params, state = torch_import.classifier_from_state_dict(
        model.state_dict())
    return ft, params, state


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(B, N, 3)) * rng.uniform(0.5, 2.0, (B, 1, 3))
         ).astype(np.float32)
    y = rng.integers(0, K, size=B).astype(np.int32)
    return x, y


def _port(jax_model, dropout=0.0):
    ft, params, state = jax_model
    model = PointNetCls(K, ft, dropout)
    model.load_state_dict(convert.classifier_state_dict(params, state),
                          strict=True)
    return model


@functools.partial(jax.jit, static_argnames=("train", "paths"))
def _jax_forward(params, state, x, train, paths):
    with dispatch.path_context(paths):
        return apply_classifier(params, state, x, train=train,
                                rng=jax.random.PRNGKey(1), dropout_rate=0.0)


def _scaled_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0)


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
def test_eval_forward_matches_jax(jax_model, batch, pallas):
    _, params, state = jax_model
    with use_pallas(pallas):
        paths = dispatch.current_paths()
    ref = _jax_forward(params, state, jnp.asarray(batch[0]), False, paths)[0]
    with torch.no_grad():
        logp = _port(jax_model)(torch.from_numpy(batch[0]))[0]
    assert logp.shape == (B, K)
    _scaled_close(logp, ref, FWD_TOL)


def test_train_forward_matches_jax(jax_model, batch):
    """Dropout 0: log-probs and every new running statistic."""
    _, params, state = jax_model
    ref, _, _, ref_bn = _jax_forward(params, state, jnp.asarray(batch[0]),
                                     True, dispatch.current_paths())
    model = _port(jax_model).train()
    with torch.no_grad():
        logp = model(torch.from_numpy(batch[0]))[0]
    _scaled_close(logp, ref, FWD_TOL)
    want = convert.classifier_state_dict(params, ref_bn)
    got = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * (5 + 5 * (1 + jax_model[0]))
    for k in stats:
        _scaled_close(got[k], want[k], FWD_TOL)


@pytest.fixture(scope="module")
def jax_grads(jax_model, batch):
    _, params, state = jax_model
    cfg = JaxClassifyConfig(num_points=N, dropout=0.0,
                            feature_transform=jax_model[0])
    (loss, (_, acc)), grads = jax.jit(jax.value_and_grad(
        jax_classify.loss_fn, has_aux=True), static_argnums=5)(
            params, state, *map(jnp.asarray, batch), jax.random.PRNGKey(2),
            cfg)
    return loss, acc, grads


def _check_grads(model, jax_model, ref_grads):
    want = convert.classifier_state_dict(ref_grads, jax_model[2])
    params = dict(model.named_parameters())
    assert set(params) <= set(want)
    scale = max(float(want[k].abs().max()) for k in params)
    for k, p in params.items():
        diff = float((p.grad - want[k]).abs().max())
        assert diff <= GRAD_TOL * (1 + scale), (k, diff)


def test_loss_fn_and_grads_match_jax(jax_model, batch, jax_grads):
    ref_loss, ref_acc, ref_grads = jax_grads
    cfg = ClassifyConfig(num_points=N, dropout=0.0,
                         feature_transform=jax_model[0])
    model = _port(jax_model).train()
    loss, acc = classify.loss_fn(model, *map(torch.from_numpy, batch), cfg)
    _scaled_close(loss.detach(), ref_loss, RTOL)
    assert float(acc) == float(ref_acc)
    loss.backward()
    _check_grads(model, jax_model, ref_grads)


def test_train_step_leaves_jax_grads(jax_model, batch, jax_grads):
    """``train_step`` without augmentation and normalization: JAX's loss,
    its gradients in ``.grad``, one step taken."""
    ref_loss, _, ref_grads = jax_grads
    cfg = ClassifyConfig(num_points=N, dropout=0.0, normalize=False,
                         feature_transform=jax_model[0])
    tx = classify.make_tx(cfg, 10)
    state = classify.create_state(cfg, 10, device="cpu",
                                  model=_port(jax_model, dropout=0.3))
    assert state.model.dropout == 0.0
    metrics = classify.train_step(state, *map(torch.from_numpy, batch),
                                  cfg=cfg, tx=tx)
    _scaled_close(metrics["loss"], ref_loss, RTOL)
    assert state.step == 1 and int(state.device_step) == 1
    _check_grads(state.model, jax_model, ref_grads)


class _MaskDropout(torch.nn.Module):
    def __init__(self, mask, p):
        super().__init__()
        self.mask, self.p = mask, p

    def forward(self, x):
        return torch.where(self.mask, x / (1 - self.p), 0.0)


def test_dropout_sits_between_fc2_and_bn2(batch, monkeypatch):
    model = PointNetCls(K, dropout=0.3,
                        generator=torch.Generator().manual_seed(3)).train()
    ref = torch_ref.PointNetClsTorch(K)
    ref.load_state_dict(model.state_dict(), strict=True)
    ref.train()
    mask = core.dropout_mask(torch.Generator().manual_seed(4), (B, 256), 0.3,
                             "cpu")
    assert 0.5 < float(mask.float().mean()) < 0.9
    x = torch.from_numpy(batch[0])
    draw = core.dropout_mask
    monkeypatch.setattr(core, "dropout_mask", lambda *a: mask)
    with torch.no_grad():
        got = copy.deepcopy(model)(x)[0]
        ref.dropout = _MaskDropout(mask, 0.3)
        want = ref(x.transpose(1, 2))[0]
        h = F.relu(ref.bn1(ref.fc1(ref.feat(x.transpose(1, 2))[0])))
        after = F.log_softmax(ref.fc3(F.relu(ref.dropout(ref.bn2(
            ref.fc2(h))))), dim=1)
    _scaled_close(got, want, 1e-4)
    assert float((got - after).abs().max()) > 100 * 1e-4 * max(
        1.0, float(want.abs().max()))
    # The mask drawn from a generator: the same state, the same forward
    # (each from the same running statistics, which centre the moments).
    monkeypatch.setattr(core, "dropout_mask", draw)

    def fwd(gen):
        with torch.no_grad():
            return copy.deepcopy(model)(x, gen)[0]

    a = fwd(torch.Generator().manual_seed(5))
    monkeypatch.setattr(core, "dropout_mask", lambda *a: draw(
        torch.Generator().manual_seed(5), (B, 256), 0.3, "cpu"))
    assert torch.equal(a, fwd(None))
    monkeypatch.setattr(core, "dropout_mask", draw)
    assert not torch.equal(a, fwd(torch.Generator().manual_seed(6)))


def test_synthetic_arrays_equal_jax_h5_fixture(tmp_path):
    root = make_synthetic_modelnet_h5(str(tmp_path), 9, 5, 40, seed=7)
    want = []
    for split in ("train", "test"):
        ds, jds = ModelNet40(root, split), JaxModelNet40(root, split)
        assert np.array_equal(ds.points, jds.points)
        assert np.array_equal(ds.labels, jds.labels)
        assert len(ds) == len(jds)
        want += [ds.points, ds.labels]
    got = synthetic_modelnet(9, 5, 40, seed=7)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    default = synthetic_modelnet()
    assert [a.shape for a in default] == [(64, 2048, 3), (64,),
                                          (32, 2048, 3), (32,)]
    with pytest.raises(FileNotFoundError):
        ModelNet40(str(tmp_path), "val")


def test_evaluators_match_each_other_and_jax(jax_model):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(20, N, 3)).astype(np.float32)   # 3 batches of 8
    y = rng.integers(0, K, 20).astype(np.int32)
    model = _port(jax_model)
    host = eval_lib.evaluate_classifier(model, x, y, B, K)
    dev = eval_lib.evaluate_classifier_device(model, torch.from_numpy(x), y,
                                              B, K)
    _, params, state = jax_model
    ref = jax_eval.evaluate_classifier(params, state, x, y, B, K)
    assert host == dev == {k: float(v) for k, v in ref.items()}
    assert host["num_examples"] == 20.0


def test_pth_round_trip_and_infer_cls(tmp_path, capsys):
    """Config 2's classifier (random BatchNorm statistics) through a
    ``.pth``: ``load_classifier`` and the JAX package's importer and
    ``convert.classifier_state_dict`` give its tensors back bit for bit;
    ``infer --model cls`` prints the JAX forward's classes as the JAX
    script prints them (``cloud i: class c``)."""
    ft = True
    model = PointNetCls(K, ft, generator=torch.Generator().manual_seed(2))
    randomize_bn(model, torch.Generator().manual_seed(3))
    path = str(tmp_path / "cls.pth")
    torch.save(model.state_dict(), path)
    loaded = checkpoint.load_classifier(path, K, ft, device="cpu")
    back = convert.classifier_state_dict(*torch_import.classifier_from_state_dict(
        torch_import.load_pth(path)))
    for sd in (loaded.state_dict(), back):
        assert sd.keys() == model.state_dict().keys()
        assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items()
                   if not k.endswith("num_batches_tracked"))
    with pytest.raises(ValueError, match="segmenter checkpoint, not a "
                       "classifier"):
        seg = str(tmp_path / "seg.pth")
        torch.save(PointNetDenseCls(50, True).state_dict(), seg)
        checkpoint.load_classifier(seg)
    with pytest.raises(ValueError, match="--feature_transform"):
        checkpoint.load_classifier(path, K, not ft)

    rng = np.random.default_rng(4)
    inp = str(tmp_path / "in.h5")
    with h5py.File(inp, "w") as f:
        f["data"] = rng.normal(size=(B, 150, 3)).astype(np.float32)
    infer.main(["--checkpoint", path, "--model", "cls", "--input", inp,
                "--num_points", str(N), "--batch", "3", "--device", "cpu",
                "--feature_transform"])
    got = capsys.readouterr().out
    params, state = torch_import.classifier_from_state_dict(
        torch_import.load_pth(path))
    clouds = infer.prep(infer.load_clouds(inp), N)
    pred = np.argmax(np.asarray(_jax_forward(
        params, state, jnp.asarray(clouds), False,
        dispatch.current_paths())[0]), -1)
    assert got == "".join(f"cloud {i}: class {int(c)}\n"
                          for i, c in enumerate(pred))
    assert got.splitlines()[0].startswith("cloud 0: class ")
    assert len(got.splitlines()) == B


def _losses(out_dir, name="cls"):
    import csv

    with open(os.path.join(out_dir, f"{name}_metrics.csv")) as f:
        return [(int(r["step"]), float(r["loss"])) for r in csv.DictReader(f)]


def _epochs(out_dir, name="cls"):
    import csv

    with open(os.path.join(out_dir, f"{name}_epochs.csv")) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("kind", ["cls", "advp"])
def test_runner_matches_jax_from_the_same_pth(tmp_path, kind):
    """The port's runner against the JAX package's, from one reference
    ``.pth`` (random BatchNorm affine parameters, statistics from the
    train pool) on one h5 fixture of 48 train and 29 test shapes of 128
    points in 4 classes, run at N=64, B=16, two epochs of 3 steps at
    lr=0, dropout 0, augment off, no checkpoints, the JAX package's on
    its jnp path: config 1 (``run_classification``; the feature
    transform's step is held by the step tests above, and its JAX
    compile would add 4 s) and config 5 (``run_adv_perturb``, FGSM at
    epsilon 0: the attack runs, in eval mode on its plain path, and the
    update takes ``x + 0 * sign(g)``, which is ``x``).
    ``_modelnet_arrays`` gives the JAX package's arrays exactly, with and
    without ``resample`` (the train pool's seeded subsample or its source
    resolution; the test split normalized, then subsampled); the runs
    use ``resample`` off. Every step's loss within 1e-5 (relative); each
    epoch's eval (accuracy, average class accuracy, a ragged last batch
    of 13, on the running statistics the steps moved) equal.

    Not at the default lr: from the first Adam step on, the port's run
    differs from itself when only the thread count changes (config 5 on
    48 shapes of 40 classes: by 3.4e-3 at step 2 and 4.1e-2 at step 4),
    as ``tests/test_torch_runner.py`` found for config 3. Not at epsilon
    0.05: the perturbed clouds differ where ``sign`` flips at a gradient
    within rounding of 0 (of six models whose statistics were set with
    random dropout masks, two gave a step 5e-4 and 1.1e-3 apart, the
    others every step within 1e-5); the attack itself is held by
    ``tests/test_torch_adv_perturb.py`` with the sign-flip rule."""
    k = 4
    root = make_synthetic_modelnet_h5(str(tmp_path / "mn"), 48, 29, 128,
                                      num_classes=k, seed=3)
    model = PointNetCls(k, dropout=0.0,
                        generator=torch.Generator().manual_seed(5))
    randomize_bn(model, torch.Generator().manual_seed(6))
    # Running statistics near the fixture's own (30 train forwards at
    # momentum 0.1, no dropout): with the random ones every test cloud
    # gets one class.
    x_tr = torch.from_numpy(runner._modelnet_arrays(ClassifyConfig(
        dataset=root, num_points=N, resample=False))[0])
    model.train()
    with torch.no_grad():
        for _ in range(30):
            model(x_tr)
    pth = str(tmp_path / "m.pth")
    torch.save(model.state_dict(), pth)
    kw = dict(dataset=root, num_points=N, batch_size=16, epochs=2, lr=0.0,
              dropout=0.0, resample=False, quiet=True, resume=pth,
              num_classes=k, ckpt_policy="none")
    if kind == "cls":
        cfg, jax_cfg = ClassifyConfig, JaxClassifyConfig
        run, run_jax = runner.run_classification, jax_runner.run_classification
    else:
        kw["epsilon"] = 0.0
        cfg, jax_cfg = AdvPerturbConfig, JaxAdvPerturbConfig
        run, run_jax = runner.run_adv_perturb, jax_runner.run_adv_perturb
    for resample in (False, True):
        arrays = runner._modelnet_arrays(cfg(**{**kw, "resample": resample}))
        ref = jax_runner._modelnet_arrays(jax_cfg(**{**kw,
                                                     "resample": resample}))
        assert arrays[0].shape[1] == (128 if resample else N)
        for a, b in zip(arrays, ref, strict=True):
            np.testing.assert_array_equal(a, b)
    d_port, d_ref = str(tmp_path / "port"), str(tmp_path / "jax")
    port = run(cfg(out_dir=d_port, **kw), device="cpu")
    ref = run_jax(jax_cfg(out_dir=d_ref, use_pallas=False, num_devices=1,
                          **kw))
    got, want = _losses(d_port, kind), _losses(d_ref, kind)
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, 7))
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (g, w)
    evs = _epochs(d_port, kind)
    for ev, ev_ref in zip(evs, _epochs(d_ref, kind), strict=True):
        for key in ("accuracy", "avg_class_accuracy", "num_examples"):
            assert float(ev[key]) == float(ev_ref[key]), key
    assert float(evs[0]["num_examples"]) == 29.0
    assert 0 < port["best_accuracy"] < 1
    with torch.no_grad():   # the eval is not one class for every cloud
        preds = port["state"].model.eval()(torch.from_numpy(arrays[2]))[0]
    assert len(set(preds.argmax(-1).tolist())) > 1
    assert port["best_accuracy"] == float(ref["best_accuracy"])


def test_run_classification_resumes_bit_for_bit(tmp_path, capsys):
    """Two epochs of 4 steps (B=16, N=32, the in-memory fixture, feature
    transform, augmentation and dropout on), then ``--resume_full`` from
    the epoch-0 checkpoint: epoch 1's per-step losses again, exactly; the
    eval CLI on the run's directory reproduces its last eval (two
    batches)."""
    cfg = ClassifyConfig(batch_size=16, num_points=32, epochs=2, quiet=True,
                         feature_transform=True, augment=True,
                         out_dir=str(tmp_path / "a"))
    first = runner.run_classification(cfg, device="cpu")
    assert first["state"].step == 8
    assert sorted(os.listdir(cfg.out_dir)) == ["0", "1", "cls_epochs.csv",
                                               "cls_metrics.csv"]
    losses = _losses(cfg.out_dir)
    assert [s for s, _ in losses] == list(range(1, 9))
    resumed = runner.run_classification(dataclasses.replace(
        cfg, out_dir=str(tmp_path / "b"), resume=str(tmp_path / "a"),
        resume_full=True), device="cpu")
    assert resumed["state"].step == 8
    ckpt0 = str(tmp_path / "c")
    os.makedirs(ckpt0)
    os.rename(os.path.join(cfg.out_dir, "0"), os.path.join(ckpt0, "0"))
    resumed = runner.run_classification(dataclasses.replace(
        cfg, out_dir=str(tmp_path / "d"), resume=ckpt0, resume_full=True),
        device="cpu")
    assert _losses(str(tmp_path / "d")) == losses[4:]
    assert resumed["best_accuracy"] == float(_epochs(cfg.out_dir)[1][
        "accuracy"])
    capsys.readouterr()
    ev = eval_classification.main(["--model", cfg.out_dir, "--cpu",
                                   "--num_points", "32", "--batchSize", "16"])
    last = _epochs(cfg.out_dir)[-1]
    assert ev["accuracy"] == float(last["accuracy"])
    assert ev["avg_class_accuracy"] == float(last["avg_class_accuracy"])
    assert f"accuracy: {ev['accuracy']:.4f}" in capsys.readouterr().out


@pytest.mark.parametrize("parse,flags,err,match", [
    (parse_classify_args, ["--fused_epoch"], NotImplementedError, "item 5"),
    (parse_classify_args, ["--num_devices", "2"], NotImplementedError,
     "item 15"),
    (parse_adv_perturb_args, ["--num_devices", "4"], NotImplementedError,
     "item 15"),
    (parse_adv_perturb_args, ["--no_pallas"], ValueError, "--cpu"),
])
def test_flags_that_raise(parse, flags, err, match):
    with pytest.raises(err, match=match):
        parse(flags)


def test_cli_flags_and_defaults():
    cfg, device = parse_classify_args(["--feature_transform", "--augment",
                                       "--cpu", "--nepoch", "3"])
    assert device == "cpu" and cfg.feature_transform and cfg.augment
    assert (cfg.num_points, cfg.num_classes, cfg.dropout, cfg.out_dir,
            cfg.epochs) == (1024, 40, 0.3, "cls", 3)
    cfg, device = parse_adv_perturb_args(["--attack", "pgd",
                                          "--attack_steps", "3"])
    assert device == "cuda"
    assert (cfg.attack, cfg.attack_steps, cfg.epsilon, cfg.out_dir,
            cfg.num_points) == ("pgd", 3, 0.05, "advp", 1024)
    assert train_classification.main.__module__.endswith(
        "train_classification")


def test_checkpoint_restores_classifier_state(tmp_path):
    cfg = ClassifyConfig(batch_size=4, num_points=16, augment=True)
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(4, 16, 3, generator=g), torch.randint(0, K, (4,),
                                                             generator=g)
    tx = classify.make_tx(cfg, 5)
    state = classify.create_state(cfg, 5, device="cpu")
    classify.train_step(state, x, y, cfg=cfg, tx=tx)
    checkpoint.save(str(tmp_path), 0, state)
    want = classify.train_step(state, x, y, cfg=cfg, tx=tx)["loss"]
    fresh = classify.create_state(dataclasses.replace(cfg, seed=1), 5,
                                  device="cpu")
    checkpoint.restore(str(tmp_path), fresh)
    assert fresh.step == 1
    assert torch.equal(classify.train_step(fresh, x, y, cfg=cfg,
                                           tx=tx)["loss"], want)
    only = classify.create_state(dataclasses.replace(cfg, seed=1), 5,
                                 device="cpu")
    checkpoint.restore_fields(str(tmp_path), only, ("model",))
    assert only.step == 0
    pth = str(tmp_path / "m.pth")
    torch.save(state.model.state_dict(), pth)
    warm = classify.create_state(cfg, 5, device="cpu")
    checkpoint.load_params_only(pth, warm)
    assert all(torch.equal(warm.model.state_dict()[k], v)
               for k, v in state.model.state_dict().items())
