"""The port's ``precision_delta`` against ``scripts/precision_delta.py``.

* Its flags and defaults are the JAX script's (read from the parser the
  script's ``main`` builds, stopped before it parses), plus ``--cpu``;
  its default artifact is ``PRECISION_torch.json``, never the JAX one.
* Its fixture (npz layout, written once under the temporary directory)
  holds the JAX script's ``make_synthetic_shapenet`` arrays bit for bit,
  in the pools and the eval split alike.
* A whole run on the CPU at a reduced size (1 seed, 2 epochs, 48 shapes
  of 64 points, B=8): the JSON has exactly ``PRECISION_r03.json``'s keys
  at every level, the delta is the means' difference, the runner got
  each arm's ``bf16`` and the bf16 arm ran inside
  ``core.mixed_precision`` (bf16 operands seen) while the fp32 arm never
  did.
"""

import argparse
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu_torch import (
    precision_delta as pd,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.train import runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ONLY = {"cpu": False, "no_pallas": False}
SMALL = ["--cpu", "--seeds", "1", "--nepoch", "2", "--num_shapes", "48",
         "--num_points", "64", "--batchSize", "8"]


class _Parsed(Exception):
    pass


def jax_flags(main, monkeypatch) -> dict:
    """``{option string: default}`` of the parser that a JAX script's
    ``main`` builds, caught when it parses (the script runs no further)."""
    caught = {}

    def grab(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            main()
    return flags(caught["parser"])


def flags(parser: argparse.ArgumentParser) -> dict:
    return {a.option_strings[0]: a.default for a in parser._actions
            if a.option_strings and a.dest != "help"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_dirs(tmp_path, monkeypatch):
    """The fixture and the run directories under ``tmp_path``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_flags_are_the_jax_scripts(monkeypatch):
    from scripts import precision_delta as jax_pd

    want = jax_flags(jax_pd.main, monkeypatch)
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def keep(self, args=None, namespace=None):
        captured["parser"] = self
        return real(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", keep)
    pd.parse_args([])
    got = flags(captured["parser"])
    assert want.pop("--json") == "PRECISION_r03.json"
    assert got.pop("--json") == "PRECISION_torch.json"
    assert got == {**want, **{f"--{k}": v for k, v in PORT_ONLY.items()}}
    a = pd.parse_args(["--quick"])
    assert (a.seeds, a.nepoch, a.num_shapes) == (1, 2, 96)
    assert pd.device_from_args(pd.parse_args([])) == "cuda"
    assert pd.device_from_args(pd.parse_args(["--cpu"])) == "cpu"
    assert set(pd.CFG_KEYS) == {k[2:] for k in want} - {"quick"}


def test_fixture_holds_the_jax_scripts_arrays(tmp_dirs):
    from adversarial_learning_on_pointclouds_tpu.data import (
        shapenet_part as jax_sn,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.data import (
        shapenet_part as sn,
    )

    a = pd.parse_args(["--num_shapes", "32", "--num_points", "64"])
    root = pd.fixture(a)
    assert sorted(os.listdir(root)) == [f"ply_data_{s}0.npz"
                                        for s in ("test", "train", "val")]
    assert pd.fixture(a) == root  # written once
    ref = jax_sn.make_synthetic_shapenet(str(tmp_dirs / "jax_h5"),
                                         num_shapes=32, num_points=64)
    for split in ("train", "test"):
        got, want = sn.ShapeNetPart(root, split), jax_sn.ShapeNetPart(ref,
                                                                     split)
        for fn in ("as_arrays", "as_pool_arrays"):
            for x, y in zip(getattr(got, fn)(64, 1), getattr(want, fn)(64, 1)):
                np.testing.assert_array_equal(x, y)


def _keys(tree):
    """The dict keys at every level (lists by their first element)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree:
        return [_keys(tree[0])]
    return None


def test_run_writes_the_jax_schema_with_each_arm_in_its_precision(
        tmp_dirs, monkeypatch):
    seen = []
    run = runner.run_adversarial
    compute_dtype = core.compute_dtype

    def spy_run(cfg, device="cuda"):
        seen.append({"bf16": cfg.bf16, "device": device, "dtypes": set()})
        return run(cfg, device=device)

    def spy_dtype():
        dtype = compute_dtype()
        if seen:
            seen[-1]["dtypes"].add(dtype)
        return dtype

    monkeypatch.setattr(runner, "run_adversarial", spy_run)
    monkeypatch.setattr(core, "compute_dtype", spy_dtype)
    path = str(tmp_dirs / "PRECISION_small.json")
    out = pd.main(SMALL + ["--json", path])
    with open(path) as f:
        written = json.load(f)
    with open(os.path.join(REPO, "PRECISION_r03.json")) as f:
        jax_out = json.load(f)
    assert written == out
    assert _keys(written) == _keys(jax_out)
    assert [(r["seed"], r["mode"]) for r in written["runs"]] == [
        (0, "fp32"), (0, "bf16")]
    s = written["summary"]
    assert s["delta_bf16_minus_fp32"] == pytest.approx(
        s["bf16"]["mean"] - s["fp32"]["mean"], abs=1e-5)
    for r in written["runs"]:
        assert 0.0 <= r["best_miou"] <= 1.0 and r["wall_s"] >= 0
    assert [(c["bf16"], c["device"]) for c in seen] == [(False, "cpu"),
                                                        (True, "cpu")]
    assert seen[0]["dtypes"] == {None}
    assert torch.bfloat16 in seen[1]["dtypes"]
    a = pd.parse_args(SMALL + ["--json", path])
    for mode in pd.MODES:
        files = os.listdir(pd.run_dir(a, 0, mode))
        assert "adv_metrics.csv" in files and "adv_epochs.csv" in files
