"""The port's segmentation eval against the JAX package's.

* ``shape_ious_device`` equals the JAX function exactly on random
  predictions (inside and outside each shape's category range), and the
  numpy protocol it reduces to.
* On weights carried across by ``utils/convert.py`` (full width, 50
  parts, feature transform, random BatchNorm statistics), at B=4, N=64:
  the eval forward's log-probs lie within 1e-4 (scale-relative) of the
  JAX package's ``apply_segmenter(train=False)`` on its jnp path, and
  ``eval_step`` / ``eval_scan`` give the same predictions, correct counts
  and IoUs, except at points whose top-two log-probs lie within 1e-5
  (and the shapes holding them).
* ``evaluate_segmenter`` (host batches, ragged last batch padded and
  masked) equals ``evaluate_segmenter_device`` (device pools, one loop)
  in the port, and both equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu import eval as jax_eval
from adversarial_learning_on_pointclouds_tpu.models import (
    apply_segmenter, init_segmenter,
)
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.train import (
    segment as jax_segment,
)
from adversarial_learning_on_pointclouds_tpu.utils import (
    metrics as jax_metrics,
)
from adversarial_learning_on_pointclouds_tpu_torch import eval as eval_lib
from adversarial_learning_on_pointclouds_tpu_torch.data.shapenet_part import (
    CATEGORY_PART_RANGES,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetDenseCls,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import segment
from adversarial_learning_on_pointclouds_tpu_torch.utils import (
    convert, metrics,
)

B, N, PARTS = 4, 64, 50
RTOL = 1e-4
TIE = 1e-5


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


def _labels(rng, cats, n):
    """Part labels inside each shape's category range."""
    start = CATEGORY_PART_RANGES[cats, 0][:, None]
    count = CATEGORY_PART_RANGES[cats, 1][:, None]
    return (start + rng.integers(0, 6, (len(cats), n)) % count
            ).astype(np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_shape_ious_device_equals_jax(seed):
    rng = np.random.default_rng(seed)
    b, n = 16, int(rng.integers(5, 200))
    cats = rng.integers(0, 16, b).astype(np.int32)
    gt = _labels(rng, cats, n)
    pred = _labels(rng, cats, n)
    # Some predictions off the category's range, some shapes perfect, and
    # a part absent from both (IoU 1).
    off = rng.random((b, n)) < 0.1
    pred = np.where(off, rng.integers(0, PARTS, (b, n)), pred).astype(
        np.int32)
    pred[0] = gt[0]
    gt[1] = CATEGORY_PART_RANGES[cats[1], 0]
    got = metrics.shape_ious_device(torch.from_numpy(pred),
                                    torch.from_numpy(gt),
                                    torch.from_numpy(cats)).numpy()
    ref = np.asarray(jax_metrics.shape_ious_device(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(cats)))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, metrics.shape_ious(pred, gt, cats),
                               rtol=1e-6)
    assert got[0] == 1.0


@pytest.fixture(scope="module")
def models():
    params, state = init_segmenter(jax.random.PRNGKey(3), PARTS,
                                   feature_transform=True)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    _randomize_bn(params, state, np.random.default_rng(3))
    model = PointNetDenseCls(PARTS, feature_transform=True)
    model.load_state_dict(convert.segmenter_state_dict(params, state),
                          strict=True)
    return params, state, model


@pytest.fixture(scope="module")
def test_split():
    """11 clouds: at B=4 the last batch is ragged (3 of 4)."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(11, N, 3))
         * rng.uniform(0.5, 2.0, (11, 1, 3))).astype(np.float32)
    cats = rng.integers(0, 16, 11).astype(np.int32)
    return x, _labels(rng, cats, N), cats


def _ties(logp):
    """Points whose top-two log-probs lie within ``TIE``."""
    top2 = np.sort(np.asarray(logp), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < TIE


def test_eval_forward_and_step_match_jax(models, test_split):
    params, state, model = models
    x, y, c = (a[:B] for a in test_split)
    with use_pallas(False):
        ref_logp = np.asarray(apply_segmenter(params, state, jnp.asarray(x),
                                              train=False)[0])
        ref = jax_segment.eval_step(params, state, jnp.asarray(x),
                                    jnp.asarray(y), jnp.asarray(c))
    model.train()
    with segment.eval_mode(model):
        assert not model.training
        logp = model(torch.from_numpy(x))[0].numpy()
    assert model.training  # the mode is restored
    scale = max(1.0, np.abs(ref_logp).max())
    np.testing.assert_allclose(logp, ref_logp, atol=RTOL * scale, rtol=0)

    got = segment.eval_step(model, torch.from_numpy(x), torch.from_numpy(y),
                            torch.from_numpy(c))
    pred, ref_pred = got["pred"].numpy(), np.asarray(ref["pred"])
    ties = _ties(ref_logp)
    assert np.all((pred == ref_pred) | ties)
    clean = ~ties.any(-1)
    np.testing.assert_array_equal(got["ious"].numpy()[clean],
                                  np.asarray(ref["ious"])[clean])
    assert abs(int(got["correct"]) - int(ref["correct"])) <= ties.sum()


def test_eval_scan_matches_jax(models, test_split):
    params, state, model = models
    x, y, c = test_split
    idx, mask = eval_lib._eval_indices(len(x), B)
    jax_idx, jax_mask = jax_eval._eval_indices(len(x), B)
    np.testing.assert_array_equal(idx, jax_idx)
    np.testing.assert_array_equal(mask, jax_mask)
    with use_pallas(False):
        ref = jax_segment.eval_scan(params, state, jnp.asarray(x),
                                    jnp.asarray(y), jnp.asarray(c),
                                    jnp.asarray(idx))
        ref_logp = np.asarray(apply_segmenter(params, state, jnp.asarray(x),
                                              train=False)[0])
    got = segment.eval_scan(model, torch.from_numpy(x), torch.from_numpy(y),
                            torch.from_numpy(c), idx)
    assert set(got) == {"correct", "ious"}
    assert tuple(got["ious"].shape) == idx.shape
    shape_ties = _ties(ref_logp).any(-1)[idx]           # [S, B]
    np.testing.assert_array_equal(got["ious"].numpy()[~shape_ties],
                                  np.asarray(ref["ious"])[~shape_ties])
    np.testing.assert_array_equal(got["correct"].numpy()[~shape_ties],
                                  np.asarray(ref["correct"])[~shape_ties])


def test_host_and_device_eval_agree_and_match_jax(models, test_split):
    params, state, model = models
    x, y, c = test_split
    host = eval_lib.evaluate_segmenter(model, x, y, c, batch_size=B)
    dev = eval_lib.evaluate_segmenter_device(
        model, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(c),
        y, c, batch_size=B)
    assert host[0]["num_shapes"] == dev[0]["num_shapes"] == len(x)
    for a, b in ((host[0], dev[0]), (host[1], dev[1])):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-6, abs=1e-7), k
    with use_pallas(False):
        ref = jax_eval.evaluate_segmenter_device(
            params, state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(c),
            y, c, batch_size=B)
    for a, b in ((dev[0], ref[0]), (dev[1], ref[1])):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-6, abs=1e-7), k


def test_numpy_metrics_equal_jax():
    """The copied numpy half: accuracy, class accuracies, the per-shape
    and per-category IoUs and the confusion matrix."""
    rng = np.random.default_rng(5)
    logp = rng.normal(size=(40, 8)).astype(np.float32)
    labels = rng.integers(0, 8, 40)
    mask = rng.random(40) < 0.5
    assert metrics.accuracy(logp, labels) == jax_metrics.accuracy(logp, labels)
    assert metrics.accuracy(logp, labels, mask) == \
        jax_metrics.accuracy(logp, labels, mask)
    pred = logp.argmax(-1)
    assert metrics.class_accuracies(pred, labels, 8) == \
        jax_metrics.class_accuracies(pred, labels, 8)
    cats = rng.integers(0, 16, 12).astype(np.int32)
    gt, pp = _labels(rng, cats, 30), _labels(rng, cats, 30)
    np.testing.assert_array_equal(metrics.shape_ious(pp, gt, cats),
                                  jax_metrics.shape_ious(pp, gt, cats))
    assert metrics.instance_miou(pp, gt, cats) == \
        jax_metrics.instance_miou(pp, gt, cats)
    assert metrics.category_miou(pp, gt, cats) == \
        jax_metrics.category_miou(pp, gt, cats)
    np.testing.assert_array_equal(metrics.confusion_matrix(pp, gt),
                                  jax_metrics.confusion_matrix(pp, gt))
