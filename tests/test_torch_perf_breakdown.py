"""The port's ``perf_breakdown`` against ``scripts/perf_breakdown.py``.

* Its flags and defaults are the JAX script's, plus ``--steps`` (the
  script's ``timeit`` default, 30) and ``--cpu``.
* Each of its four components (``STN3d``, ``STNkd(64)``, the encoder in
  its parts mode, the whole segmenter G; forward + backward in training
  mode, fp32) against the JAX script's lambda at B=8, N=64: the JAX
  script's inputs, weights of its inits' shapes drawn with numpy (random
  BatchNorm affine and statistics) and carried across by
  ``utils/convert.py``, the JAX side on its plain path
  (``use_pallas(False)``: the reference its Pallas kernels are held to by
  the JAX package's own tests; in interpret mode the four gradients took
  25 s of this file's budget here). The scalar within
  5e-3 of max(1, |value|) and every parameter's gradient within 2e-2 x
  (1 + the component's largest |g|): ``tests/test_torch_train_step.py``'s
  bounds, where the batch-axis BNs of the T-Net heads amplify
  summation-order differences at small batch. The points are the
  script's standard normals, not normalized (normalized points make the
  input T-Net's fp32 gradients ill-conditioned at small batch in both
  packages).
* A smoke run on the CPU prints the four lines and the JAX script's
  share line, each share positive and the ratio of the printed times.
  A wall share is the host's and is not bounded by 1 (under the suite's
  parallel workers the encoder's call once took 121% of G's; on the card
  too); ``chip_smoke.py`` holds the device shares in (0, 1].
"""

import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import (
    apply_segmenter, init_segmenter, tnet,
)
from adversarial_learning_on_pointclouds_tpu.models.encoder import (
    apply_encoder_parts, init_encoder,
)
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu_torch import perf_breakdown as pb
from adversarial_learning_on_pointclouds_tpu_torch.utils import convert
from tests.test_torch_precision_delta import flags, jax_flags
from tests.test_torch_train_step import GRAD_TOL, RTOL

B, N = 8, 64
CONVERT = {"stn3": convert.tnet_state_dict, "stn64": convert.tnet_state_dict,
           "encoder": convert.encoder_state_dict,
           "segmenter": convert.segmenter_state_dict}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_init(init, rng):
    """``(params, bn_state)`` of the shapes ``init`` gives (traced only,
    ``jax.eval_shape``), drawn with numpy: dense weights uniform within
    1/sqrt(fan in), biases small, random BatchNorm affine and running
    statistics (no fold is the identity)."""
    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "w":
            v = rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
        elif name in ("b", "bias", "mean"):
            v = rng.normal(0, 0.1, shape)
        else:  # BN scale, running var
            v = rng.uniform(0.5, 1.5, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


@pytest.fixture(scope="module")
def jax_side():
    """``{component: (params, bn_state, value, grads)}`` of the JAX
    script's four lambdas (``scripts/perf_breakdown.py:64-77``) in fp32
    on the JAX package's plain path, as numpy, on numpy-drawn weights of
    its inits' shapes (the JAX initializers run eagerly here took about
    8 s)."""
    xs = {k: jnp.asarray(v.numpy()) for k, v in pb.inputs(B, N,
                                                          "cpu").items()}
    rng = np.random.default_rng(0)
    tp3, ts3 = _numpy_init(lambda: tnet.init_tnet(
        jax.random.PRNGKey(0), k=3), rng)
    tp64, ts64 = _numpy_init(lambda: tnet.init_tnet(
        jax.random.PRNGKey(1), k=64), rng)
    ep, es = _numpy_init(lambda: init_encoder(
        jax.random.PRNGKey(2), feature_transform=True), rng)
    sp, ss = _numpy_init(lambda: init_segmenter(
        jax.random.PRNGKey(3), 50, feature_transform=True), rng)
    lambdas = {
        "stn3": (tp3, ts3, lambda p: jnp.sum(
            tnet.apply_tnet(p, ts3, xs["x"], train=True)[0] ** 2)),
        "stn64": (tp64, ts64, lambda p: jnp.sum(
            tnet.apply_tnet(p, ts64, xs["x64"], train=True)[0] ** 2)),
        "encoder": (ep, es, lambda p: jnp.sum(
            apply_encoder_parts(p, es, xs["x"], train=True)[1] ** 2)),
        "segmenter": (sp, ss, lambda p: jnp.sum(
            apply_segmenter(p, ss, xs["x"], train=True)[0] ** 2)),
    }
    out = {}
    with use_pallas(False):
        for key, (p, s, fn) in lambdas.items():
            value, grads = jax.jit(jax.value_and_grad(fn))(p)
            out[key] = (p, s, np.asarray(value),
                        jax.tree_util.tree_map(np.asarray, grads))
    return out


def test_flags_are_the_jax_scripts(monkeypatch):
    import argparse

    from scripts import perf_breakdown as jax_pb

    want = jax_flags(jax_pb.main, monkeypatch)
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def keep(self, args=None, namespace=None):
        captured["parser"] = self
        return real(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", keep)
    pb.parse_args([])
    assert flags(captured["parser"]) == {
        **want, "--steps": 30, "--cpu": False, "--no_pallas": False}
    assert want == {"--batch": 32, "--points": 2048, "--fp32": False}
    assert pb.device_from_args(pb.parse_args([])) == "cuda"


@pytest.mark.parametrize("label,key,loss_fn,x_key", pb.COMPONENTS,
                         ids=[c[1] for c in pb.COMPONENTS])
def test_component_matches_the_jax_scripts_lambda(jax_side, label, key,
                                                  loss_fn, x_key):
    params, state, value, grads = jax_side[key]
    seed, make = pb.MODELS[key]
    model = make(torch.Generator().manual_seed(seed))
    model.load_state_dict(CONVERT[key](params, state), strict=True)
    model.train()
    loss = pb.fwd_bwd(model, loss_fn, pb.inputs(B, N, "cpu")[x_key],
                      bf16=False)
    assert abs(float(loss) - float(value)) <= RTOL * max(abs(float(value)),
                                                         1.0), label
    want = CONVERT[key](grads, state)
    got = dict(model.named_parameters())
    assert set(got) == {k for k in want if k.endswith(("weight", "bias"))}
    scale = max(float(want[k].abs().max()) for k in got)
    for k, p in got.items():
        diff = float((p.grad - want[k]).abs().max())
        assert diff <= GRAD_TOL * (1 + scale), (label, k, diff, scale)


def test_cpu_smoke_prints_four_lines_and_the_shares():
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = pb.main(["--cpu", "--batch", "4", "--points", "64",
                       "--steps", "3"])
    text = buf.getvalue()
    for label, *_ in pb.COMPONENTS:
        assert re.search(rf"^{re.escape(label)} +\d+\.\d{{3}} ms$", text,
                         re.M), text
    assert re.search(r"^T-net share of encoder: [\d.]+%; encoder share of "
                     r"G: [\d.]+%; T-net share of G: [\d.]+%$", text,
                     re.M), text
    assert [r["name"] for r in out["components"]] == [
        c[0] for c in pb.COMPONENTS]
    assert "device_shares" not in out
    t3, t64, te, ts = (r["wall_ms"] for r in out["components"])
    sh = out["shares"]
    assert sh == pytest.approx({"tnet_of_encoder": (t3 + t64) / te,
                                "encoder_of_g": te / ts,
                                "tnet_of_g": (t3 + t64) / ts})
    assert sh["tnet_of_g"] == pytest.approx(sh["tnet_of_encoder"]
                                            * sh["encoder_of_g"])
    assert all(0.0 < v < float("inf") for v in sh.values()), text


def test_port_kernels_are_csrcs_global_functions():
    names = pb.port_kernels()
    assert {"f1_tc_kernel", "f2_tc_kernel", "b1_tc_kernel", "fc_tc_kernel",
            "head_p1_tc_kernel", "pmid_tc_kernel", "b4_tc_kernel",
            "bmid_tc_kernel", "head_b1_tc_kernel"} <= names
    assert pb.is_port_kernel("void f1_tc_kernel<false, 64>(F1Args)")
    assert pb.is_port_kernel("b1_tc_kernel(BwdArgs)")
    for other in ("void at::native::elementwise_kernel<128, 4>(int)",
                  "Memcpy HtoD (Pageable -> Device)",
                  "ampere_sgemm_128x64_nn"):
        assert not pb.is_port_kernel(other)


class _Event:
    def __init__(self, name, start):
        from torch.autograd import DeviceType

        self._name, self._start, self._type = name, start, DeviceType.CUDA

    def name(self):
        return self._name

    def device_type(self):
        return self._type

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return 1000


def _fake_profiler(monkeypatch, windows):
    """torch.profiler windows that hold ``windows``' records in turn (each
    a list of names, one record every 2 us from 0; a record of 1 us)."""
    import types

    import torch.profiler

    left = list(windows)

    class Profile:
        def __init__(self, activities):
            names = left.pop(0)
            events = [_Event(n, 2000 * i) for i, n in enumerate(names)]
            self.profiler = types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(events=lambda: events))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return left


def test_a_short_profiler_window_is_taken_again_then_raises(monkeypatch):
    """``device_window`` keeps no window with fewer records of the port's
    kernels than its wrappers launched, or a port kernel counted a number
    of times the calls do not divide (PyTorch's records so counted are
    named, not refused); after ``PROFILE_TRIES`` short windows it
    raises."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        trunk_train,
    )

    def fn():  # one counted launch a call
        trunk_train.f1.launches += 1

    f1, other = "f1_tc_kernel(F1Args)", "void at::native::k<1>(int)"
    left = _fake_profiler(monkeypatch, [
        [f1] + [other] * 2,       # a port record lost: 1 against 2
        [f1] * 3 + [other],       # 3 port records: the calls lost one
        [f1] * 2 + [other] * 3])  # complete; PyTorch's 3 named uneven
    out = pb.device_window(fn, calls=2)
    assert not left and out["windows"] == 3
    assert out["port_records"] == 1 and out["records"] == 2.5
    assert out["uneven"] == {other[:40]: 3}
    assert out["launches"]["trunk2_train"] == {"F1": 1, "F2": 0, "B1": 0}
    assert out["device_ms"] == pytest.approx(5 * 1e-3 / 2)  # 5 x 1 us
    _fake_profiler(monkeypatch, [[other] * 2] * pb.PROFILE_TRIES)
    with pytest.raises(RuntimeError, match="lost records"):
        pb.device_window(fn, calls=2)
