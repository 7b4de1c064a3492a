"""The port's ``infer`` entry point against the JAX ``scripts/infer.py``,
and the port's independence from JAX.

Both CLIs run on the same reference-format ``.pth`` (a JAX
``init_segmenter`` with random BatchNorm statistics, exported) and the
same input file; they share the seeded host resample, so their printed
part predictions must agree line for line. The port runs with
``--device cpu`` (the kernels' plain versions), the JAX script with
``--no_pallas --cpu``.
"""

import importlib.util
import os
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import init_segmenter
from adversarial_learning_on_pointclouds_tpu.utils import torch_export
from adversarial_learning_on_pointclouds_tpu_torch import infer
from adversarial_learning_on_pointclouds_tpu_torch.utils.ply import (
    write_ply_with_labels,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPTS = 128


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    params, state = init_segmenter(jax.random.PRNGKey(3), 50,
                                   feature_transform=True)
    rng = np.random.default_rng(3)
    # Running mean 0 -> N(0, 0.05), var 1 -> U(0.35, 1.65).
    state = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * rng.uniform(0.5, 1.5, a.shape)
                   + rng.normal(0, 0.05, a.shape)).astype(np.float32), state)
    # At init the global feature decides every point's part; weighting the
    # head's per-point rows up makes the predicted parts vary by point.
    params = jax.tree_util.tree_map(np.asarray, params)
    params["conv1"]["w"] = params["conv1"]["w"] * np.where(
        np.arange(1088) < 64, 20.0, 1.0).astype(np.float32)[:, None]
    path = str(tmp_path_factory.mktemp("ckpt") / "g.pth")
    torch_export.save_pth(path, torch_export.segmenter_state_dict(params,
                                                                  state))
    return path


def _write_input(tmp_path, kind):
    rng = np.random.default_rng(4)
    clouds = [rng.normal(size=(int(rng.integers(150, 300)), 3)) *
              rng.uniform(0.5, 2.0, 3) for _ in range(3)]
    path = str(tmp_path / f"in.{kind}")
    if kind == "pts":
        np.savetxt(path, clouds[0], fmt="%.6f")
    elif kind == "ply":
        write_ply_with_labels(path, clouds[0], np.zeros(len(clouds[0])))
    else:
        with h5py.File(path, "w") as f:
            f["data"] = np.stack([c[:150] for c in clouds]).astype(np.float32)
    return path


def _jax_infer(argv, monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_infer_script", os.path.join(REPO, "scripts", "infer.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["infer.py", *argv, "--no_pallas",
                                      "--cpu"])
    script.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("kind,model,batch", [("pts", "seg", 32),
                                              ("h5", "adv", 2),
                                              ("ply", "seg", 32)])
def test_main_matches_jax_infer(tmp_path, pth, monkeypatch, capsys, kind,
                                model, batch):
    inp = _write_input(tmp_path, kind)
    argv = ["--checkpoint", pth, "--model", model, "--feature_transform",
            "--input", inp, "--num_points", str(NPTS), "--batch", str(batch)]
    want = _jax_infer(argv, monkeypatch, capsys)
    ply = str(tmp_path / "out.ply")
    infer.main([*argv, "--device", "cpu", "--ply", ply])
    got = capsys.readouterr().out
    assert got.splitlines()[:-1] == want.splitlines()
    assert got.splitlines()[-1] == f"wrote {ply}"
    assert len(want.splitlines()) == (3 if kind == "h5" else 1)
    assert "," in want  # more than one part predicted
    assert os.path.getsize(ply) > 0


def test_prep_matches_jax_script():
    from adversarial_learning_on_pointclouds_tpu.data.augment import (
        normalize_unit_sphere_np,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.data import augment

    pts = np.random.default_rng(5).normal(size=(7, 200, 3)) * 3 + 1
    np.testing.assert_array_equal(augment.normalize_unit_sphere_np(pts),
                                  normalize_unit_sphere_np(pts))
    a, b = infer.prep(pts, 64, seed=1), infer.prep(pts, 64, seed=1)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (7, 64, 3)


def test_device_cuda_without_cuda_raises(tmp_path, pth, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(["--checkpoint", pth, "--model", "seg",
                    "--feature_transform", "--input",
                    _write_input(tmp_path, "pts")])


@pytest.mark.parametrize("extra", [["--model", "cls", "--artifact", "c.shlo"],
                                   ["--model", "seg", "--artifact", "g.shlo"]])
def test_unported_routes_raise(tmp_path, pth, extra):
    """The JAX package's StableHLO artifacts (``.shlo``) are not the
    port's: ``--artifact`` serves a ``.pt2`` of ``export_serving`` and
    refuses anything else before it reads the input (and takes precedence
    over ``--checkpoint``, as in the JAX script)."""
    extra = [str(tmp_path / e) if e.endswith(".shlo") else e for e in extra]
    with open(extra[-1], "wb") as f:
        f.write(b"ML\xefR\x00 a StableHLO bytecode module, not a .pt2")
    with pytest.raises(ValueError, match="not a serving artifact"):
        infer.main(["--checkpoint", pth, "--input",
                    _write_input(tmp_path, "pts"), "--device", "cpu", *extra])


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import adversarial_learning_on_pointclouds_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'adversarial_learning_on_pointclouds_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) >= 15  # every submodule was imported


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No card: chip_smoke.py exits non-zero and prints no result, in the
    repo and alone in a directory."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
