"""The port's host data layer against the JAX package's.

* The index and batch streams (``host_index_iterator``,
  ``host_batch_iterator``, ``cycling_host_indices``,
  ``cycling_host_batches``) and ``num_batches`` equal the JAX package's
  bit for bit over several n, B, seed, epoch and ``drop_last``: both
  runners define their epochs by them.
* ``make_synthetic_shapenet`` writes byte-identical files in both
  layouts; its default layout is pts (the JAX package's is h5).
* ``ShapeNetPart.as_arrays`` / ``as_pool_arrays`` equal the JAX
  package's on an h5 and a pts fixture, with and without
  ``class_choice``, through the native loader and through the numpy path;
  the runner's ``_shapenet_arrays`` (the normalized test split) too.
* The port imports with ``h5py`` blocked, and reads a pts fixture so.
* The device stage keeps K-stacking and the ragged tail as single steps.
"""

import filecmp
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.configs import (
    SegmentConfig as JaxSegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu.data import (
    loader as jax_loader, native_loader as jax_native,
    shapenet_part as jax_sp,
)
from adversarial_learning_on_pointclouds_tpu.train import (
    runner as jax_runner,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    SegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.data import (
    loader, native_loader, shapenet_part as sp,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM_CASES = [(n, b, seed, epoch, drop)
                for n, b in ((10, 4), (33, 8), (64, 16), (7, 8))
                for seed, epoch in ((0, 0), (3, 5))
                for drop in (True, False)]


def _equal(a, b):
    assert type(a) is type(b) or isinstance(a, tuple)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,b,seed,epoch,drop", STREAM_CASES)
def test_index_and_batch_streams_match_jax(n, b, seed, epoch, drop):
    got = list(loader.host_index_iterator(n, b, True, drop, seed, epoch))
    ref = list(jax_loader.host_index_iterator(n, b, True, drop, seed, epoch))
    assert len(got) == len(ref) == loader.num_batches(n, b, drop) \
        == jax_loader.num_batches(n, b, drop)
    for g, r in zip(got, ref):
        _equal(g, r)
    rng = np.random.default_rng(n)
    arrays = (rng.normal(size=(n, 5, 3)).astype(np.float32),
              rng.integers(0, 50, (n, 5)).astype(np.int32))
    for g, r in itertools.zip_longest(
            loader.host_batch_iterator(arrays, b, True, drop, seed, epoch),
            jax_loader.host_batch_iterator(arrays, b, True, drop, seed,
                                           epoch)):
        _equal(g, r)


@pytest.mark.parametrize("n,b,seed,start", [(10, 4, 0, 0), (33, 8, 1, 2),
                                            (16, 16, 5, 1)])
def test_cycling_streams_match_jax(n, b, seed, start):
    take = 3 * max(n // b, 1) + 2
    got = itertools.islice(loader.cycling_host_indices(n, b, seed, start),
                           take)
    ref = itertools.islice(jax_loader.cycling_host_indices(n, b, seed, start),
                           take)
    for g, r in zip(got, ref):
        _equal(g, r)
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got = itertools.islice(loader.cycling_host_batches((x,), b, seed, start),
                           take)
    ref = itertools.islice(
        jax_loader.cycling_host_batches((x,), b, seed, start), take)
    for g, r in zip(got, ref):
        _equal(g, r)


def test_device_batches_stack_k_and_run_the_tail_singly():
    n, b, k = 22, 4, 2  # 5 batches: two stacked groups and one single
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    host = list(loader.host_batch_iterator((x,), b, seed=1))
    out = list(loader.device_batches(iter(host), "cpu", k_stack=k))
    assert [s for _, s in out] == [True, True, False]
    assert [tuple(t[0].shape) for t, _ in out] == [(2, 4, 3), (2, 4, 3),
                                                   (4, 3)]
    flat = torch.cat([t[0].reshape(-1, 3) for t, _ in out]).numpy()
    np.testing.assert_array_equal(flat, np.concatenate([h[0] for h in host]))


@pytest.mark.parametrize("kw", [dict(), dict(cluster_parts=True),
                                dict(boundary_jitter=0.3)])
@pytest.mark.parametrize("layout", ["h5", "pts"])
def test_synthetic_fixture_files_are_byte_identical(tmp_path, layout, kw):
    a = sp.make_synthetic_shapenet(str(tmp_path / "port"), 24, 32, seed=3,
                                   layout=layout, **kw)
    b = jax_sp.make_synthetic_shapenet(str(tmp_path / "jax"), 24, 32,
                                       seed=3, layout=layout, **kw)
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    names_b = sorted(os.path.relpath(os.path.join(d, f), b)
                     for d, _, fs in os.walk(b) for f in fs)
    assert names == names_b and names
    if layout == "h5":
        import h5py

        for name in names:
            with h5py.File(os.path.join(a, name)) as fa, \
                    h5py.File(os.path.join(b, name)) as fb:
                assert sorted(fa) == sorted(fb)
                for key in fa:
                    _equal(np.asarray(fa[key]), np.asarray(fb[key]))
        return
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


def test_default_layout_is_pts(tmp_path):
    root = sp.make_synthetic_shapenet(str(tmp_path), 8, 16)
    assert os.path.exists(os.path.join(root, "synsetoffset2category.txt"))
    assert not [f for f in os.listdir(root) if f.endswith(".h5")]


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapenet")
    return {layout: jax_sp.make_synthetic_shapenet(
        str(root / layout), 40, 48, seed=1, layout=layout)
        for layout in ("h5", "pts")}


@pytest.mark.parametrize("layout,class_choice,numpy_path", [
    ("h5", None, False), ("h5", "Chair", False),
    ("pts", None, False), ("pts", "Chair", False),
    ("pts", None, True), ("pts", "Chair", True)])
def test_shapenet_arrays_match_jax(fixtures, layout, class_choice,
                                   numpy_path, monkeypatch):
    """The h5 layout reads without a loader choice; the pts layout
    through the native library and through the numpy path."""
    if numpy_path:
        monkeypatch.setattr(native_loader, "get_lib", lambda: None)
        monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    else:
        assert native_loader.native_available()
    root = fixtures[layout]
    for split in ("train", "test"):
        got = sp.ShapeNetPart(root, split, class_choice)
        ref = jax_sp.ShapeNetPart(root, split, class_choice)
        assert len(got) == len(ref) > 0
        for n_pts, seed in ((48, 0), (32, 3), (96, 1)):
            _equal(got.as_arrays(n_pts, seed), ref.as_arrays(n_pts, seed))
            _equal(got.as_pool_arrays(n_pts, seed),
                   ref.as_pool_arrays(n_pts, seed))
        if layout == "pts":
            assert native_loader.last_loader() == (
                "numpy" if numpy_path else "native")


@pytest.mark.parametrize("resample", [True, False])
@pytest.mark.parametrize("layout", ["h5", "pts"])
def test_runner_shapenet_arrays_match_jax(fixtures, layout, resample):
    kw = dict(dataset=fixtures[layout], num_points=32, seed=2,
              resample=resample)
    got = runner._shapenet_arrays(SegmentConfig(**kw))
    ref = jax_runner._shapenet_arrays(JaxSegmentConfig(**kw))
    for g, r in zip(got, ref):
        _equal(tuple(g), tuple(r))


def test_port_imports_and_reads_pts_without_h5py(tmp_path):
    """With ``h5py`` blocked in ``sys.modules`` the whole port imports,
    writes its default (pts) fixture and reads it."""
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "import importlib, pkgutil\n"
        "import adversarial_learning_on_pointclouds_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from adversarial_learning_on_pointclouds_tpu_torch.data import "
        "shapenet_part as sp\n"
        f"root = sp.make_synthetic_shapenet({str(tmp_path)!r}, 16, 32)\n"
        "x, s, c = sp.ShapeNetPart(root, 'train').as_arrays(32)\n"
        "assert x.shape == (12, 32, 3) and 'jax' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
