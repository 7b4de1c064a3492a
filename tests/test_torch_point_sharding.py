"""The port's point sharding (``parallel/point.py``) against one device
and against the JAX package's ``point_sharded_eval`` /
``point_sharded_train_step``.

The ranks are gloo processes on the CPU, four of them spawned once (in
the background while this process runs one device and the JAX mesh;
W = 2 point sharding is the dry run's, ``tests/test_torch_parallel.py``);
the tests assert on the saved results. Every rank is given
the whole batch and keeps its block of the point axis.

* ``point_sharded_eval`` of the segmenter (per-point log-probs) and of the
  classifier (pooled logits), at a point count the ranks divide (128) and
  one they do not (133, padded by repeating the last point and trimmed):
  against the one-device forward and against the JAX package's on
  ``make_mesh(4)``, max |delta| 2e-4 (``__graft_entry__.py:187``).
* ``point_sharded_train_step`` (8 clouds of 128 points, 6 parts, feature
  transform): the loss within rel 1e-5 of the one-device step's and of
  the JAX package's on ``make_mesh(4)`` (``__graft_entry__.py:222``), the
  JAX gradients by ``_grad_close``'s 2e-2 global-scale rule, every rank's
  parameters bit-equal; in float64 every gradient within 1e-4 x (1 + the
  largest |g|) of one device's, and a planted fault, the replicated
  orthogonality term counted once a rank (W times in all), misses that.
* ``train_giant_cloud`` at 4 ranks trains and evaluates; a point count
  the ranks do not divide is refused by it and by the train step.
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
    SegmentConfig as JaxSegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu.models.classifier import (
    apply_classifier, init_classifier,
)
from adversarial_learning_on_pointclouds_tpu.models.segmenter import (
    apply_segmenter, init_segmenter,
)
from adversarial_learning_on_pointclouds_tpu.parallel import (
    make_mesh, point_sharded_eval, point_sharded_train_step,
)
from adversarial_learning_on_pointclouds_tpu.train import (
    state as jax_state,
)
from adversarial_learning_on_pointclouds_tpu_torch import train_giant_cloud
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist, steps
from adversarial_learning_on_pointclouds_tpu_torch.utils import convert

B_EVAL, B_TRAIN, N = 2, 8, 128
PARTS, CLASSES = 6, 5
WORLDS = (4,)
JAX_W = 4
EVAL_ATOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SEG = dict(num_parts=PARTS, feature_transform=True)
CLS = dict(num_classes=CLASSES, feature_transform=True)
TRAIN = dict(num_parts=PARTS, num_points=N, batch_size=B_TRAIN,
             feature_transform=True, augment=False)


def _models():
    sp, ss = init_segmenter(jax.random.PRNGKey(0), PARTS,
                            feature_transform=True)
    cp, cs = init_classifier(jax.random.PRNGKey(1), CLASSES,
                             feature_transform=True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    sp, ss, cp, cs = map(to_np, (sp, ss, cp, cs))
    sd = lambda d: {k: v.numpy() for k, v in d.items()}  # noqa: E731
    return dict(jax=dict(seg=(sp, ss), cls=(cp, cs)),
                seg={"model": sd(convert.segmenter_state_dict(sp, ss))},
                cls={"model": sd(convert.classifier_state_dict(cp, cs))})


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B_EVAL, N + 5, 3)).astype(np.float32)
    rng_t = np.random.default_rng(5)
    xt = rng_t.standard_normal((B_TRAIN, N, 3)).astype(np.float32)
    yt = rng_t.integers(0, PARTS, (B_TRAIN, N)).astype(np.int32)
    return {"even": x[:, :N], "odd": x}, (xt, yt)


def _calls(w, models, tmp):
    evals, (xt, yt) = _inputs()
    calls = []
    for n, x in evals.items():
        for kind, cfg, wts, per_point in (("segment", SEG, models["seg"],
                                           True),
                                          ("classify", CLS, models["cls"],
                                           False)):
            if w == 1:
                kw = dict(kind=kind, cfg_kw=cfg, x=x, weights=wts)
                calls.append((f"eval-{kind}-{n}", steps.eval_forward, kw,
                              "float32"))
            else:
                kw = dict(kind=kind, cfg_kw=cfg, x=x, weights=wts,
                          per_point=per_point)
                calls.append((f"eval-{kind}-{n}", steps.run_point_eval, kw,
                              "float32"))
    train = dict(cfg_kw=TRAIN, x=xt, y=yt, weights=models["seg"])
    calls.append(("train", steps.run_point_train, train, "float32"))
    calls.append(("train-f64", steps.run_point_train, train, "float64"))
    if w > 1:
        calls.append(("fault-replicated_w_times", steps.with_fault, dict(
            fault="replicated_w_times", fn=steps.run_point_train,
            kwargs=train), "float64"))
        calls.append(("refusal", steps.error_of, dict(
            fn=steps.run_point_train, kwargs=dict(
                cfg_kw={**TRAIN, "num_points": N + 2 * w - 1},
                x=np.zeros((B_TRAIN, N + 2 * w - 1, 3), np.float32),
                y=np.zeros((B_TRAIN, N + 2 * w - 1), np.int32))),
            "float32"))
    if w > 1:
        out = os.path.join(tmp, "giant")
        calls.append(("giant", steps.run_cli, dict(
            module="adversarial_learning_on_pointclouds_tpu_torch."
                   "train_giant_cloud",
            argv=["--cpu", "--num_devices", str(w), "--num_points", "64",
                  "--num_shapes", "8", "--batchSize", "2", "--nepoch", "1",
                  "--ckpt_policy", "none", "--outf", out],
            out_dir=out), "float32"))
    return calls


def _jax_runs(models):
    """The JAX package on ``make_mesh(4)``: the evals and the train step
    (``optax.identity()``: new - old parameters are the gradients)."""
    evals, (xt, yt) = _inputs()
    mesh = make_mesh(JAX_W)
    (sp, ss), (cp, cs) = models["jax"]["seg"], models["jax"]["cls"]
    out = {}
    for n, x in evals.items():
        out[f"eval-segment-{n}"] = np.asarray(point_sharded_eval(
            apply_segmenter, sp, ss, x, mesh, per_point=True))
        out[f"eval-classify-{n}"] = np.asarray(point_sharded_eval(
            apply_classifier, cp, cs, x, mesh, per_point=False))
    tx = optax.identity()
    cfg = JaxSegmentConfig(**TRAIN)
    st = jax_state.TrainState(params=sp, bn_state=ss, opt_state=tx.init(sp),
                              step=jnp.zeros((), jnp.int32),
                              rng=jax.random.PRNGKey(0))
    new, m = point_sharded_train_step(st, xt, yt, mesh, cfg=cfg, tx=tx)
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b,
                                   new.params, sp)
    out["train"] = (float(m["loss"]), {
        k: v.numpy() for k, v in convert.segmenter_state_dict(grads,
                                                              ss).items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    models = _models()
    tmp = str(tmp_path_factory.mktemp("points"))
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
        out["jax"] = _jax_runs(models)
        out.update({w: f.result() for w, f in spawned.items()})
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-8)


def _grad_err(got, ref):
    scale = max(float(np.abs(g).max()) for g in ref.values())
    return max(float(np.abs(got[k] - g).max()) for k, g in ref.items()) \
        / (1.0 + scale)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("n", ["even", "odd"])
@pytest.mark.parametrize("kind", ["segment", "classify"])
def test_point_sharded_eval_matches_one_device(runs, kind, n, w):
    key = f"eval-{kind}-{n}"
    got, ref = runs[w][0][key], runs[1][0][key]
    assert got.shape == ref.shape == ((B_EVAL, N + 5 * (n == "odd"), PARTS)
                                      if kind == "segment"
                                      else (B_EVAL, CLASSES))
    assert float(np.abs(got - ref).max()) < EVAL_ATOL
    for r in range(1, w):       # the whole output on every rank
        np.testing.assert_array_equal(runs[w][r][key], got)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("n", ["even", "odd"])
@pytest.mark.parametrize("kind", ["segment", "classify"])
def test_point_sharded_eval_matches_jax(runs, kind, n, w):
    key = f"eval-{kind}-{n}"
    assert float(np.abs(runs[w][0][key] - runs["jax"][key]).max()) \
        < EVAL_ATOL


@pytest.mark.parametrize("w", WORLDS)
def test_point_sharded_train_step_matches_one_device(runs, w):
    got, ref = runs[w][0]["train"], runs[1][0]["train"]
    assert _rel(got["metrics"][0]["loss"], ref["metrics"][0]["loss"]) \
        < LOSS_RTOL
    assert abs(got["metrics"][0]["acc"] - ref["metrics"][0]["acc"]) \
        <= 2.0 / (B_TRAIN * N)
    assert all(r["train"]["same"] for r in runs[w])


@pytest.mark.parametrize("w", WORLDS)
def test_point_sharded_gradients_match_one_device(runs, w):
    """float64: every gradient, and every new running statistic."""
    got, ref = runs[w][0]["train-f64"], runs[1][0]["train-f64"]
    assert _rel(got["metrics"][0]["loss"], ref["metrics"][0]["loss"]) < 1e-12
    assert _grad_err(got["grads"]["model"], ref["grads"]["model"]) \
        <= GRAD_RTOL
    for k, v in ref["buffers"]["model"].items():
        np.testing.assert_allclose(got["buffers"]["model"][k], v,
                                   rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("w", WORLDS)
def test_point_sharded_train_step_matches_jax(runs, w):
    loss, grads = runs["jax"]["train"]
    got = runs[w][0]["train"]
    assert _rel(got["metrics"][0]["loss"], loss) < LOSS_RTOL
    want = {k: grads[k] for k in got["grads"]["model"]}
    scale = max(float(np.abs(g).max()) for g in want.values())
    for k, g in want.items():
        assert float(np.abs(got["grads"]["model"][k] - g).max()) \
            <= 2e-2 * (1.0 + scale), k


@pytest.mark.parametrize("w", WORLDS)
def test_replicated_term_counted_w_times_fails_the_check(runs, w):
    """The orthogonality regularizer of the replicated transforms entered
    once a rank: the loss is off by (W - 1) x 0.001 x the regularizer,
    which the loss bound catches, and the gradient bound too."""
    got = runs[w][0]["fault-replicated_w_times"]
    ref = runs[1][0]["train-f64"]
    assert _rel(got["metrics"][0]["loss"], ref["metrics"][0]["loss"]) \
        > 100 * LOSS_RTOL
    assert _grad_err(got["grads"]["model"], ref["grads"]["model"]) \
        > 10 * GRAD_RTOL


@pytest.mark.parametrize("w", WORLDS)
def test_point_count_the_ranks_do_not_divide_is_refused(runs, w):
    err = runs[w][0]["refusal"]
    assert err is not None and err.startswith("ValueError")
    assert f"must divide the {w} ranks" in err


def test_giant_cloud_trainer_at_four_ranks(runs):
    got = runs[4][0]["giant"]
    assert np.isfinite(got["result"]["best_miou"])
    rows = got["csv"]["seg_giant_epochs.csv"]
    assert len(rows) == 1 and np.isfinite(float(rows[0]["loss"]))
    assert all(r["giant"]["csv"] is None for r in runs[4][1:])


def test_giant_cloud_trainer_refuses_an_indivisible_point_count(capsys):
    with pytest.raises(SystemExit):
        train_giant_cloud.main(["--cpu", "--num_devices", "3",
                                "--num_points", "256"])
    assert "must divide the 3 ranks" in capsys.readouterr().err
