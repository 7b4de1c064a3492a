#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's serving path (``adversarial_learning_on_pointclouds_tpu_
torch``: part-segmentation inference at full width, 50 parts, feature
transform on, N = 2500, batch 32) and checks each hand-written kernel
against its plain PyTorch version. Phases, one or more lines each:

1. device: CUDA must be available; the card's name and power limit;
2. build: the kernels compile from ``csrc/`` (nvcc, sm_90a);
3. kernels: each kernel against its plain version at the main path's
   shapes, at a ragged point count and at batch 1;
4. slice: a seeded full-width segmenter with random BatchNorm statistics
   is saved as a ``.pth``, served through ``infer.main`` once and through
   ``Predictor.predict`` over 4 batches of 32 clouds, compared with the
   same ``Predictor`` on the CPU, and the kernels' launch counts are
   checked (3 / 1 / 1 per forward);
5. timing: CUDA events, median of 20 runs after warm-up, kernel against
   plain version and the whole slice per batch of 32; then the device
   time alone of each (torch.profiler: the sum of the GPU kernels a call
   runs, which leaves out the host's launch work) and the forward's
   kernels by device time.

The line before the last is a JSON object of the kernels' numbers, the
last ``{"ok": true, "device": {...}}``. Any failure raises: the exit code
is non-zero and no result is printed.

    python3 chip_smoke.py
"""

import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout

import numpy as np
import torch

SEED = 0
B, N, PARTS = 32, 2500, 50
RAGGED_N = 2047
BOUND = 1e-4          # scale-relative: max|a - b| / max(1, max|b|)
REPS = 20
KERNELS_ROOT = "adversarial_learning_on_pointclouds_tpu_torch"
TPU_KERNELS = "adversarial_learning_on_pointclouds_tpu/ops/kernels"


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor):
    diff = (a.double() - b.double()).abs().max().item()
    return diff / max(1.0, b.abs().max().item()), diff


def check(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    rel, diff = rel_err(got, ref)
    phase("kernels", f"{name}: max scale-relative error {rel:.3e} "
          f"(max abs {diff:.3e}, bound {BOUND:g})")
    if rel > BOUND:
        raise AssertionError(f"{name}: error {rel:.3e} above {BOUND:g}")
    return diff


def event_ms(fn, reps: int):
    """CUDA-event times in ms of ``reps`` calls of ``fn``, one by one."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def time_pair(kernel_fn, plain_fn):
    """Median ms of each function over REPS runs, in the order plain,
    kernel, kernel, plain, after a warm-up."""
    for fn in (kernel_fn, plain_fn, kernel_fn, plain_fn):
        fn()
    plain = event_ms(plain_fn, REPS // 2)
    kernel = event_ms(kernel_fn, REPS)
    plain += event_ms(plain_fn, REPS // 2)
    return statistics.median(kernel), statistics.median(plain)


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def device_profile(fn, reps: int = 10):
    """``{kernel name: device ms per call}`` of ``fn``'s GPU work, from
    torch.profiler (device activity only)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: _device_us(e) / reps / 1e3 for e in prof.key_averages()
            if _device_us(e) > 0}


def layer_params(gen, c_in, c_out, dev):
    """A random [in, out] weight view (over row-major [out, in] storage)
    with a non-trivial folded-BN shift and scale."""
    bound = c_in ** -0.5
    w = (torch.rand(c_out, c_in, generator=gen) * 2 - 1) * bound
    shift = torch.randn(c_out, generator=gen) * 0.1
    scale = 0.5 + torch.rand(c_out, generator=gen)
    return w.to(dev).t(), shift.to(dev), scale.to(dev)


def randomize_bn(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Random BatchNorm affine and running statistics, so that no fold is
    the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    card = card.splitlines()[0]
    phase("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from adversarial_learning_on_pointclouds_tpu_torch import infer
    from adversarial_learning_on_pointclouds_tpu_torch.models import (
        PointNetDenseCls, core,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.ops import build
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        encoder_fused, shared_mlp,
    )
    core.exact_fp32()

    # 2. build
    t0 = time.perf_counter()
    built = not build.library_path().exists()
    build.library()
    phase("build", f"{'compiled' if built else 'loaded'} "
          f"{build.library_path().name} in {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions
    gen = torch.Generator().manual_seed(SEED)
    err = {"fused_linear_affine_act": 0.0, "fused_stack_maxpool": 0.0,
           "seg_head_fused": 0.0}
    stacks = {"stn3d": ((3, 64, 128, 1024), ("relu",) * 3),
              "stnkd": ((64, 64, 128, 1024), ("relu",) * 3),
              "trunk": ((64, 128, 1024), ("relu", None))}
    head_widths = ((1088, 512), (512, 256), (256, 128))
    main_args = {}
    with torch.inference_mode():
        conv1 = layer_params(gen, 3, 64, dev)
        stack_params = {k: [layer_params(gen, a, b, dev)
                            for a, b in zip(w[:-1], w[1:])]
                        for k, (w, _) in stacks.items()}
        head = [layer_params(gen, a, b, dev) for a, b in head_widths]
        w4, _, _ = layer_params(gen, 128, PARTS, dev)
        b4 = (torch.randn(PARTS, generator=gen) * 0.1).to(dev)
        for bsz, n in ((B, N), (B, RAGGED_N), (1, N)):
            tag = f"B={bsz} N={n}"
            x3 = torch.randn(bsz, n, 3, generator=gen).to(dev)
            x64 = torch.relu(torch.randn(bsz, n, 64, generator=gen)).to(dev)
            g = torch.relu(torch.randn(bsz, 1024, generator=gen)).to(dev)
            main = (bsz, n) == (B, N)

            args = (x3, *conv1, "relu")
            d = check(f"fused_linear_affine_act conv1 3->64 {tag}",
                      shared_mlp.fused_linear_affine_act(*args),
                      shared_mlp.fused_linear_affine_act_plain(*args))
            err["fused_linear_affine_act"] = max(
                err["fused_linear_affine_act"], d)
            if main:
                main_args["fused_linear_affine_act"] = [args]

            for key, (widths, acts) in stacks.items():
                ws, shs, scs = zip(*stack_params[key])
                args = (x3 if widths[0] == 3 else x64, ws, shs, scs, acts)
                d = check(f"fused_stack_maxpool {key} "
                          f"{'->'.join(map(str, widths))} {tag}",
                          encoder_fused.fused_stack_maxpool(*args),
                          encoder_fused.fused_stack_maxpool_plain(*args))
                err["fused_stack_maxpool"] = max(err["fused_stack_maxpool"], d)
                if main:
                    main_args.setdefault("fused_stack_maxpool", []).append(args)

            args = (x64, g, *head[0], *head[1], *head[2], w4, b4)
            d = check(f"seg_head_fused 1088->512->256->128->{PARTS} {tag}",
                      encoder_fused.seg_head_fused(*args),
                      encoder_fused.seg_head_fused_plain(*args))
            err["seg_head_fused"] = max(err["seg_head_fused"], d)
            if main:
                main_args["seg_head_fused"] = [args]
        torch.cuda.synchronize()

    # 4. the slice: serve a seeded full-width segmenter
    wrappers = {"fused_stack_maxpool": encoder_fused.fused_stack_maxpool,
                "fused_linear_affine_act": shared_mlp.fused_linear_affine_act,
                "seg_head_fused": encoder_fused.seg_head_fused}
    per_forward = {"fused_stack_maxpool": 3, "fused_linear_affine_act": 1,
                   "seg_head_fused": 1}
    rng = np.random.default_rng(SEED)
    model = PointNetDenseCls(PARTS, feature_transform=True, generator=gen)
    randomize_bn(model, gen)
    with torch.no_grad():  # per-point features decide more of the parts
        model.conv1.weight[:, :64] *= 20
    raw = [rng.normal(size=(int(rng.integers(2000, 3000)), 3)) *
           rng.uniform(0.5, 2.0, size=3) for _ in range(4 * B)]
    clouds = infer.prep(raw, N)
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "g.pth")
        torch.save(model.state_dict(), pth)
        pts = os.path.join(tmp, "shape.pts")
        np.savetxt(pts, raw[0], fmt="%.6f")
        predictor = infer.Predictor(pth, "adv", N, "cuda",
                                    feature_transform=True)

        for w in wrappers.values():
            w.launches = 0
        out = io.StringIO()
        with redirect_stdout(out):
            infer.main(["--checkpoint", pth, "--model", "adv",
                        "--feature_transform", "--input", pts,
                        "--device", "cuda"])
        t0 = time.perf_counter()
        logp = predictor.predict(clouds)
        serve_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}

        phase("slice", f"infer.main: {out.getvalue().strip()}")
        forwards = 1 + len(clouds) // B
        for k, count in launches.items():
            if count != per_forward[k] * forwards:
                raise AssertionError(
                    f"{k} launched {count} times in {forwards} forwards, "
                    f"expected {per_forward[k]} per forward")
        phase("slice", f"launches over {forwards} forwards: {launches}")
        phase("slice", f"Predictor.predict {len(clouds)} clouds x {N} "
              f"points, batch {B}: {serve_s:.3f} s (first use)")

        ref = infer.Predictor(pth, "adv", N, "cpu",
                              feature_transform=True).predict(clouds)
    if logp.shape != (4 * B, N, PARTS) or not np.isfinite(logp).all():
        raise AssertionError(f"log-probs {logp.shape} not finite "
                             f"[{4 * B}, {N}, {PARTS}]")
    mass = np.abs(np.exp(logp.astype(np.float64)).sum(-1) - 1).max()
    if mass > 1e-4:
        raise AssertionError(f"probabilities sum to 1 +- {mass:.2e}")
    rel, diff = rel_err(torch.from_numpy(logp), torch.from_numpy(ref))
    scale = max(1.0, float(np.abs(ref).max()))
    arg_gpu, arg_cpu = logp.argmax(-1), ref.argmax(-1)
    flips = np.nonzero(arg_gpu != arg_cpu)
    margin = (np.take_along_axis(ref, arg_cpu[..., None], -1)
              - np.take_along_axis(ref, arg_gpu[..., None], -1))[flips]
    phase("slice", f"GPU vs CPU log-probs: max scale-relative error "
          f"{rel:.3e} (max abs {diff:.3e}, bound {BOUND:g}); "
          f"{len(flips[0])} of {arg_cpu.size} argmax differ")
    if rel > BOUND:
        raise AssertionError(f"slice error {rel:.3e} above {BOUND:g}")
    if len(flips[0]) and margin.max() >= BOUND * scale:
        raise AssertionError(f"argmax differs at a top-2 margin of "
                             f"{margin.max():.3e}")

    # 5. timing
    results = []
    with torch.inference_mode():
        for name, src, line in (
                ("fused_linear_affine_act", "shared_mlp.cu", "shared_mlp.py:227"),
                ("fused_stack_maxpool", "encoder_fused.cu", "encoder_fused.py:109"),
                ("seg_head_fused", "encoder_fused.cu", "encoder_fused.py:182")):
            kernel, plain = wrappers[name], getattr(
                shared_mlp if name == "fused_linear_affine_act"
                else encoder_fused, f"{name}_plain")
            calls = main_args[name]
            ms, plain_ms = time_pair(lambda: [kernel(*a) for a in calls],
                                     lambda: [plain(*a) for a in calls])
            dev_ms = sum(device_profile(
                lambda: [kernel(*a) for a in calls]).values())
            plain_dev_ms = sum(device_profile(
                lambda: [plain(*a) for a in calls]).values())
            phase("timing", f"{card}: {name} x{len(calls)} per forward at "
                  f"B={B} N={N}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms;"
                  f" device time alone: kernel {dev_ms:.4f} ms, plain "
                  f"{plain_dev_ms:.4f} ms")
            results.append({"name": name, "route": "cuda",
                            "source": f"{KERNELS_ROOT}/csrc/{src}",
                            "replaces": f"{TPU_KERNELS}/{line}",
                            "launches": launches[name],
                            "max_abs_err": err[name], "ms": ms,
                            "plain_ms": plain_ms, "device_ms": dev_ms,
                            "plain_device_ms": plain_dev_ms})

        x = torch.from_numpy(clouds[:B]).to(dev)
        model_gpu = predictor.model
        model_gpu(x)
        fwd_ms = statistics.median(event_ms(lambda: model_gpu(x), REPS))
        kernels = device_profile(lambda: model_gpu(x))
    phase("timing", f"{card}: segmenter forward B={B} N={N} on the device: "
          f"{fwd_ms:.3f} ms, {B / fwd_ms * 1e3:.1f} clouds/s")
    busy = sum(kernels.values())
    phase("profile", f"{card}: forward B={B} N={N}: GPU kernels busy "
          f"{busy:.3f} ms of {fwd_ms:.3f} ms ({100 * (1 - busy / fwd_ms):.1f}%"
          f" idle), {len(kernels)} kernel names")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        phase("profile", f"  {ms:.4f} ms  {key[:90]}")
    serve = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        predictor.predict(clouds[:B])
        serve.append(time.perf_counter() - t0)
    serve_ms = statistics.median(serve) * 1e3
    phase("timing", f"{card}: Predictor.predict B={B} N={N} host to host: "
          f"{serve_ms:.3f} ms, {B / serve_ms * 1e3:.1f} clouds/s")

    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
