"""The port's segmenter (the whole serving forward) against the JAX
package's ``apply_segmenter(train=False)``.

A JAX ``init_segmenter`` at full width (50 parts, feature transform on)
with random BatchNorm affine and running statistics, so that no fold is
the identity, is converted by the port's ``utils/convert.py`` and loaded
with ``strict=True``. Inputs are numpy-seeded. Bound: ``1e-4 * max(1,
|ref|)``, five chained layers up to 1088 wide, as in
``tests/test_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import (
    apply_segmenter, init_segmenter,
)
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.utils import torch_export
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetDenseCls,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import (
    checkpoint, convert,
)
from tests.torch_ref import PointNetDenseClsTorch

B, N, PARTS = 2, 128, 50
RTOL = 1e-4


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0)


def _randomize_bn(tree_p, tree_s, rng):
    """Random BN scale/bias and running mean/var, in place, on numpy
    copies of a JAX (params, bn_state) pair."""
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
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    _randomize_bn(params, state, np.random.default_rng(0))
    return params, state


@pytest.fixture(scope="module")
def port_model(jax_model):
    model = PointNetDenseCls(PARTS, feature_transform=True)
    model.load_state_dict(convert.segmenter_state_dict(*jax_model),
                          strict=True)
    return model


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
def test_segmenter_matches_jax(jax_model, port_model, pallas):
    x = np.random.default_rng(1).normal(size=(B, N, 3)).astype(np.float32)
    with use_pallas(pallas):
        ref_logp, ref_t, ref_tf, _ = apply_segmenter(
            *jax_model, jnp.asarray(x), train=False)
    with torch.inference_mode():
        logp, trans, trans_feat = port_model(torch.from_numpy(x))
    assert logp.shape == (B, N, PARTS)
    _close(logp, ref_logp)
    _close(trans, ref_t)
    _close(trans_feat, ref_tf)


def test_converter_matches_torch_export(jax_model):
    ours = convert.segmenter_state_dict(*jax_model)
    theirs = torch_export.segmenter_state_dict(*jax_model)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype, key
        assert torch.equal(ours[key], value), key


def test_reference_module_loads_port_state_dict(port_model):
    """The reference PyTorch PointNetDenseCls loads the port's state_dict
    strictly and computes the same log-probs (channels-first input)."""
    ref = PointNetDenseClsTorch(k=PARTS, feature_transform=True).eval()
    ref.load_state_dict(port_model.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, N, 3)).astype(np.float32))
    with torch.inference_mode():
        want = ref(x.transpose(2, 1).contiguous())[0]
        got = port_model(x)[0]
    _close(got, want)


def test_seeded_init():
    """Init draws from the given generator alone, within torch's default
    bounds; BatchNorm starts at its defaults."""
    def make(seed):
        return PointNetDenseCls(
            PARTS, generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    assert a["feat.conv3.weight"].abs().max() <= 128 ** -0.5
    assert torch.equal(a["bn1.running_var"], torch.ones(512))


def test_checkpoint_mismatch_is_readable(tmp_path, port_model):
    path = str(tmp_path / "g.pth")
    torch.save(port_model.state_dict(), path)
    loaded = checkpoint.load_segmenter(path, PARTS, feature_transform=True,
                                       device="cpu")
    assert all(torch.equal(loaded.state_dict()[k], v)
               for k, v in port_model.state_dict().items())
    with pytest.raises(ValueError, match="unexpected.*--feature_transform"):
        checkpoint.load_segmenter(path, PARTS, feature_transform=False)
    with pytest.raises(ValueError, match="shape mismatch.*--num_parts"):
        checkpoint.load_segmenter(path, 4, feature_transform=True)
    cls_path = str(tmp_path / "cls.pth")
    torch.save({"fc3.weight": torch.zeros(40, 256)}, cls_path)
    with pytest.raises(NotImplementedError, match="classifier"):
        checkpoint.load_segmenter(cls_path)
    other = str(tmp_path / "other.pth")
    torch.save({"w": torch.zeros(1)}, other)
    with pytest.raises(ValueError, match="not a recognized"):
        checkpoint.load_segmenter(other)


def test_train_mode_raises(port_model, monkeypatch):
    """Train mode is the training forward: on the CPU it runs the training
    kernels' plain passes (the kernel library is never built, no launch
    is counted) and updates the running statistics; on a device without
    kernels it raises."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops import build
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        pool_fc_epilogue, seg_head_train, trunk_train,
    )

    def unbuildable():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "library", unbuildable)
    passes = [*trunk_train.PASSES.values(), *seg_head_train.PASSES.values(),
              pool_fc_epilogue.pool_fc_fwd]
    counts = [p.launches for p in passes]
    model = PointNetDenseCls(PARTS)
    model.load_state_dict(port_model.state_dict())
    model.train()
    logp, _, _ = model(torch.randn(2, 8, 3))
    logp.sum().backward()
    assert [p.launches for p in passes] == counts
    assert int(model.bn1.num_batches_tracked) == 1
    assert not torch.equal(model.bn1.running_mean,
                           port_model.bn1.running_mean)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        model.to("meta")(torch.zeros(1, 8, 3, device="meta"))
