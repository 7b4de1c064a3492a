"""The port's serving artifacts (``utils/serving.py``, ``torch.export``)
and serving tools, on the CPU at small sizes (N=64, 5 parts, 10
classes; seeded weights with random BatchNorm statistics).

* The portable artifact, saved and loaded, against the JAX package's
  artifact (``serving.export_*`` with ``platforms=("cpu",)``) and its
  live eval on the jnp path (``use_pallas(False)``), from the same
  weights (``utils/convert.py`` / the JAX package's ``.pth`` importer),
  for the segmenter and the classifier: fp32 within ``FWD_TOL`` of the
  scale; bf16 within ``YARD_FACTOR`` times what bf16 moves the JAX
  package's fp32 forward (the JAX XLA path rounds the folded weight w *
  scale to bf16, the port's kernels and twins round w: measured 7.3e-4
  and 4.1e-4 against 6.1e-4 and 3.9e-4 that bf16 moves JAX's fp32
  forward), and beyond ``FWD_TOL`` of the fp32 forward (it is bf16).
* A symbolic batch serves b = 1, 3 and 8; a pinned batch refuses b = 2.
* A portable export made inside a forced-kernels route and an ambient
  mixed-precision scope holds no registered op and stays fp32.
* The kernels artifact's graph holds the three registered ops, per
  forward conv1 1, stacks 3, head 1 (the classifier 1, 2, 0); loading it
  on the CPU raises, and so does an op on a CPU tensor; ``kernels=True``
  without ``devices=("cuda",)`` is refused.
* A fresh process that imports only ``torch`` serves a portable
  artifact; it cannot load a kernels artifact until it imports the op
  registrations (``ops/serving_ops.py``), and then can.
* ``export_serving --verify``, ``infer --artifact`` (``.pts`` input,
  ``--ply``, the kind from the artifact, a pinned batch padding the
  ragged tail, the ``--num_points`` mismatch) and ``infer --checkpoint``
  from a checkpoint directory the port's trainers write; ``serve_bench
  --device cpu``; ``render_cloud`` on a ``.ply`` and a ``.pts`` file;
  ``utils.profiling.debug_nans``.
"""

import json
import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import (
    apply_classifier, apply_segmenter, core as jax_core,
)
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.utils import (
    serving as jax_serving, torch_import,
)
from adversarial_learning_on_pointclouds_tpu_torch import (
    export_serving, infer, render_cloud, serve_bench,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    SegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetCls, PointNetDenseCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import (
    launch, serving_ops,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import segment
from adversarial_learning_on_pointclouds_tpu_torch.utils import (
    checkpoint, profiling, serving,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils.ply import read_ply
from chip_smoke import YARD_FACTOR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, PARTS, CLASSES = 64, 5, 10
FWD_TOL = 1e-5         # fp32 forwards, scale-relative
OPS_PER_FORWARD = {"seg": {"linear_affine_act": 1, "stack_maxpool": 3,
                           "seg_head": 1},
                   "cls": {"linear_affine_act": 1, "stack_maxpool": 2,
                           "seg_head": 0}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _model(kind):
    """A seeded model with random BatchNorm affine and statistics: the
    segmenter with the feature transform, the classifier without."""
    gen = torch.Generator().manual_seed(0)
    model = (PointNetDenseCls(PARTS, True, generator=gen) if kind == "seg"
             else PointNetCls(CLASSES, False, generator=gen))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model


@pytest.fixture(scope="module")
def models():
    return {k: _model(k) for k in ("seg", "cls")}


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(8, N, 3)) * rng.uniform(0.5, 2.0, (8, 1, 3))
            ).astype(np.float32)


def _export(model, kind, **kw):
    fn = serving.export_segmenter if kind == "seg" \
        else serving.export_classifier
    return fn(model, N, **kw)


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """``{(kind, bf16, kernels): path}``: each model's portable artifacts
    in fp32 and bf16 and its fp32 kernels artifact."""
    tmp = tmp_path_factory.mktemp("artifacts")
    out = {}
    for kind, model in models.items():
        for bf16, kernels in ((False, False), (True, False), (False, True)):
            path = str(tmp / f"{kind}_{int(bf16)}_{int(kernels)}.pt2")
            serving.save_exported(_export(
                model, kind, bf16=bf16, kernels=kernels,
                devices=("cuda",) if kernels else serving.DEFAULT_DEVICES),
                path)
            out[(kind, bf16, kernels)] = path
    return out


def _live(model, x, bf16=False):
    with torch.no_grad(), core.mixed_precision(enabled=bf16):
        return model(torch.from_numpy(x))[0].numpy()


@pytest.mark.parametrize("kind", ["seg", "cls"])
def test_portable_artifact_matches_jax_artifact_and_live_eval(
        models, clouds, artifacts, kind):
    model = models[kind]
    importer = (torch_import.segmenter_from_state_dict if kind == "seg"
                else torch_import.classifier_from_state_dict)
    params, state = importer(model.state_dict())
    jax_export = (jax_serving.export_segmenter if kind == "seg"
                  else jax_serving.export_classifier)
    apply = apply_segmenter if kind == "seg" else apply_classifier
    jax_art, jax_live, port = {}, {}, {}
    for bf16 in (False, True):
        jax_art[bf16] = np.asarray(jax_export(
            params, state, N, None, ("cpu",), bf16=bf16).call(clouds))
        with use_pallas(False), jax_core.mixed_precision(enabled=bf16):
            jax_live[bf16] = np.asarray(jax.jit(
                lambda x: apply(params, state, x, train=False)[0])(
                    jnp.asarray(clouds)))
        port[bf16] = serving.load_exported(
            artifacts[(kind, bf16, False)], "cpu")(clouds).numpy()
    assert port[False].shape == ((8, N, PARTS) if kind == "seg"
                                 else (8, CLASSES))
    assert _rel(port[False], jax_art[False]) <= FWD_TOL
    assert _rel(port[False], jax_live[False]) <= FWD_TOL
    bf16_bound = YARD_FACTOR * _rel(jax_art[True], jax_art[False])
    assert _rel(port[True], jax_art[True]) <= bf16_bound
    assert _rel(port[True], jax_live[True]) <= bf16_bound
    assert _rel(port[True], port[False]) > FWD_TOL
    np.testing.assert_array_equal(port[True], _live(model, clouds, True))


@pytest.mark.parametrize("b", [1, 3, 8])
def test_symbolic_batch_serves_every_size(models, clouds, artifacts, b):
    served = serving.load_exported(artifacts[("seg", False, False)], "cpu")
    assert served.batch is None and served.num_points == N
    assert served.kind == "seg"
    got = served(torch.from_numpy(clouds[:b]))
    assert got.shape == (b, N, PARTS)
    assert _rel(got, _live(models["seg"], clouds[:b])) <= FWD_TOL


def test_pinned_batch_refuses_other_sizes(models, clouds, tmp_path):
    path = str(tmp_path / "pinned.pt2")
    serving.save_exported(_export(models["cls"], "cls", batch=3), path)
    served = serving.load_exported(path, "cpu")
    assert served.batch == 3 and served.kind == "cls"
    assert _rel(served(clouds[:3]), _live(models["cls"], clouds[:3])) \
        <= FWD_TOL
    with pytest.raises(ValueError, match="pinned to 3"):
        served(clouds[:2])


def _registered_ops(program):
    counts = {op: 0 for op in serving_ops.OPS}
    for node in program.graph.nodes:
        name = str(node.target)
        for op in serving_ops.OPS:
            if name.startswith(f"pointtpu.{op}."):
                counts[op] += 1
    return counts


def test_portable_export_inside_forced_kernels_holds_no_op(models, clouds):
    """The export chooses its route and precision: an ambient forced-ops
    route and mixed-precision scope change nothing."""
    with launch.eval_route("ops"), core.mixed_precision():
        exp = _export(models["seg"], "seg")
    assert sum(_registered_ops(exp.program).values()) == 0
    assert not exp.meta["bf16"] and not exp.meta["kernels"]
    got = serving.serve(exp, "cpu")(clouds)
    assert _rel(got, _live(models["seg"], clouds)) <= FWD_TOL


@pytest.mark.parametrize("kind", ["seg", "cls"])
def test_kernels_artifact_holds_the_registered_ops(models, artifacts, kind):
    path = artifacts[(kind, False, True)]
    program = torch.export.load(path)
    assert _registered_ops(program) == OPS_PER_FORWARD[kind]
    meta = serving.read_meta(path)
    assert meta["kernels"] and meta["devices"] == ["cuda"]
    with pytest.raises(ValueError, match="kernels artifact"):
        serving.load_exported(path, "cpu")
    with pytest.raises(ValueError, match="devices=\\('cuda',\\)"):
        _export(models[kind], kind, kernels=True)


def test_registered_ops_take_cuda_tensors_only():
    """No plain path inside an op: a CPU tensor raises, through the op and
    through a wrapper routed to the ops; the wrappers' device rule runs
    the plain version."""
    x = torch.randn(2, 8, 3)
    w, shift, scale = torch.randn(4, 3), torch.zeros(4), torch.ones(4)
    with pytest.raises(NotImplementedError, match="CPU"):
        serving_ops.linear_affine_act(x, w, shift, scale, 1, False)
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        shared_mlp,
    )
    with launch.eval_route("ops"), pytest.raises(NotImplementedError):
        shared_mlp.fused_linear_affine_act(x, w.t(), shift, scale, "relu")
    with launch.eval_route("plain"):
        assert torch.equal(
            shared_mlp.fused_linear_affine_act(x, w.t(), shift, scale,
                                               "relu"),
            shared_mlp.fused_linear_affine_act_plain(x, w.t(), shift, scale,
                                                     "relu"))
    with pytest.raises(ValueError, match="unknown eval route"):
        with launch.eval_route("kernels"):
            pass


FRESH = """
import json, sys, torch
port = "adversarial_learning_on_pointclouds_tpu_torch"
portable, kernels, x = sys.argv[1:4]
with torch.inference_mode():
    out = torch.export.load(portable).module()(torch.load(x))
imported = sorted(m for m in sys.modules if m.startswith(port))
try:
    torch.export.load(kernels)
    refused = False
except Exception:
    refused = True
import adversarial_learning_on_pointclouds_tpu_torch.ops.serving_ops
torch.export.load(kernels)
torch.save(out, x + ".out")
print(json.dumps({"imported": imported, "refused": refused}))
"""


def test_fresh_process_serves_portable_with_torch_alone(models, clouds,
                                                        artifacts, tmp_path):
    x = str(tmp_path / "x.pt")
    torch.save(torch.from_numpy(clouds), x)
    proc = subprocess.run(
        [sys.executable, "-c", FRESH, artifacts[("seg", False, False)],
         artifacts[("seg", False, True)], x], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen == {"imported": [], "refused": True}
    assert _rel(torch.load(x + ".out"), _live(models["seg"], clouds)) \
        <= FWD_TOL


@pytest.fixture(scope="module")
def pth(models, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pth")
    out = {}
    for kind, model in models.items():
        out[kind] = str(tmp / f"{kind}.pth")
        torch.save(model.state_dict(), out[kind])
    return out


@pytest.mark.parametrize("kind,flags", [
    ("seg", ["--feature_transform", "--num_parts", str(PARTS)]),
    ("cls", ["--num_classes", str(CLASSES), "--bf16", "--batch", "4"]),
])
def test_export_serving_verify(pth, tmp_path, capsys, kind, flags):
    out = str(tmp_path / f"{kind}.pt2")
    export_serving.main(["--model", kind, "--checkpoint", pth[kind],
                         "--out", out, "--num_points", str(N), "--device",
                         "cpu", "--verify", *flags])
    text = capsys.readouterr().out
    assert "verify: max |artifact - live|" in text
    meta = serving.read_meta(out)
    assert meta["kind"] == kind and meta["bf16"] == ("--bf16" in flags)
    assert meta["batch"] == (4 if "--batch" in flags else None)
    with pytest.raises(SystemExit):
        export_serving.main(["--model", kind, "--checkpoint", pth[kind],
                             "--out", out, "--kernels"])


def _pts(tmp_path, n=300):
    path = str(tmp_path / "shape.pts")
    np.savetxt(path, np.random.default_rng(4).normal(size=(n, 3)),
               fmt="%.6f")
    return path


def test_infer_artifact_writes_ply_and_matches_the_checkpoint(
        pth, artifacts, tmp_path, capsys):
    """``.pts`` input, the kind taken from the artifact's output rank, the
    part labels of the live ``.pth`` route."""
    pts, ply = _pts(tmp_path), str(tmp_path / "out.ply")
    infer.main(["--artifact", artifacts[("seg", False, False)], "--input",
                pts, "--ply", ply, "--device", "cpu"])
    got = capsys.readouterr().out
    infer.main(["--checkpoint", pth["seg"], "--model", "seg",
                "--feature_transform", "--num_parts", str(PARTS),
                "--num_points", str(N), "--input", pts, "--device", "cpu"])
    want = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]
    assert got.splitlines()[0].startswith("cloud 0: parts")
    assert read_ply(ply).shape == (N, 3)
    infer.main(["--artifact", artifacts[("cls", False, False)], "--input",
                pts, "--device", "cpu"])
    assert capsys.readouterr().out.startswith("cloud 0: class")


def test_infer_pinned_batch_pads_the_ragged_tail(models, tmp_path, capsys):
    """Six clouds through an artifact pinned to batch 4: the second batch
    is padded, and every class is the symbolic artifact's."""
    rng = np.random.default_rng(6)
    h5 = str(tmp_path / "clouds.h5")
    with h5py.File(h5, "w") as f:
        f["data"] = rng.normal(size=(6, 200, 3)).astype(np.float32)
    printed = []
    for batch in (4, None):
        path = str(tmp_path / f"cls_{batch}.pt2")
        serving.save_exported(_export(models["cls"], "cls", batch=batch),
                              path)
        infer.main(["--artifact", path, "--input", h5, "--device", "cpu"])
        printed.append(capsys.readouterr().out.splitlines())
    assert len(printed[0]) == 6 and printed[0] == printed[1]


def test_infer_num_points_mismatch_raises(artifacts, tmp_path):
    with pytest.raises(SystemExit, match="exported point count 64"):
        infer.main(["--artifact", artifacts[("seg", False, False)],
                    "--input", _pts(tmp_path), "--num_points", "128",
                    "--device", "cpu"])


def test_infer_checkpoint_directory(models, pth, tmp_path, capsys):
    """A checkpoint directory the port's trainers write serves as the
    reference ``.pth`` of the same weights does."""
    cfg = SegmentConfig(num_points=N, num_parts=PARTS,
                        feature_transform=True)
    state = segment.create_state(cfg, 1, device="cpu")
    state.model.load_state_dict(models["seg"].state_dict())
    ckpt = str(tmp_path / "seg")
    checkpoint.save(ckpt, 0, state)
    pts = _pts(tmp_path)
    printed = []
    for path in (ckpt, pth["seg"]):
        infer.main(["--checkpoint", path, "--model", "seg",
                    "--feature_transform", "--num_parts", str(PARTS),
                    "--num_points", str(N), "--input", pts, "--device",
                    "cpu"])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]


def test_serve_bench_on_the_cpu(capsys):
    rows = serve_bench.main(["--device", "cpu", "--batch", "2",
                             "--num_points", "32", "--iters", "1"])
    assert [r for r, _ in rows] == ["artifact fp32", "artifact bf16",
                                    "live plain fp32"]
    assert all(dt > 0 for _, dt in rows)
    out = capsys.readouterr().out
    assert "needs a CUDA device: not run" in out and "Mpts/s" in out


@pytest.mark.parametrize("kind", ["ply", "pts"])
def test_render_cloud(tmp_path, kind):
    pytest.importorskip("matplotlib")
    pts = np.random.default_rng(7).normal(size=(100, 3)).astype(np.float32)
    png = str(tmp_path / "out.png")
    if kind == "ply":
        from adversarial_learning_on_pointclouds_tpu_torch.utils.ply import (
            write_ply_with_labels,
        )
        src = str(tmp_path / "c.ply")
        write_ply_with_labels(src, pts, np.arange(100) % 4)
        render_cloud.main(["--ply", src, "--out", png])
    else:
        src, seg = str(tmp_path / "c.pts"), str(tmp_path / "c.seg")
        np.savetxt(src, pts, fmt="%.6f")
        np.savetxt(seg, np.arange(100) % 4, fmt="%d")
        render_cloud.main(["--pts", src, "--seg", seg, "--out", png])
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_debug_nans():
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    before = (torch.is_anomaly_enabled(),
              torch.is_anomaly_check_nan_enabled())
    with profiling.debug_nans():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"), \
                pytest.warns(UserWarning):
            (torch.sqrt(x) * 0.0).sum().backward()
    assert (torch.is_anomaly_enabled(),
            torch.is_anomaly_check_nan_enabled()) == before
    (torch.sqrt(x) * 0.0).sum().backward()   # no check outside: no raise
    assert torch.isnan(x.grad).any()
