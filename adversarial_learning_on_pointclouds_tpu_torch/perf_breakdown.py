"""Component-level timing breakdown of the generator's training step.

The port's twin of ``scripts/perf_breakdown.py``: the forward + backward
of each model component in training mode, at the bench's shapes (batch
32, 2048 points, bf16 mixed precision unless ``--fp32``, the kernels on),
each as a loss-like scalar -> gradient, as its role in the real step:

* ``STN3d`` on ``x [B, N, 3]``, the gradient of ``sum(T ** 2)``;
* ``STNkd(64)`` on ``x64 [B, N, 64]``, the same;
* ``PointNetfeat`` (both T-Nets) in its parts mode, ``sum(global ** 2)``;
* ``PointNetDenseCls``, the whole G, ``sum(log_probs ** 2)``.

Each is timed as the JAX script's ``timeit`` times it: one warm call, a
synchronization, ``--steps`` calls, a synchronization, divided by the
steps. On the card the host sets that wall time, so each line also gives
the component's device time (the union of its kernels' and copies'
intervals a call) and its launches, from one torch.profiler window; the
three shares follow on both. A window that lost records (fewer records
of the port's own kernels, the ``__global__`` functions of ``csrc/``,
than the wrappers counted launches, each of which launches at least one;
or one of those kernels seen a number of times that is not a multiple
of the calls) is taken again, up to ``PROFILE_TRIES`` windows, and then
this raises: no share comes from a short window. PyTorch's own records
whose count the calls do not divide are named on the line.
``--cpu`` runs the kernels' plain versions on the CPU, wall time only.

    python -m adversarial_learning_on_pointclouds_tpu_torch.perf_breakdown
    python -m adversarial_learning_on_pointclouds_tpu_torch.perf_breakdown --fp32
"""

from __future__ import annotations

import argparse
import collections
import functools
import re
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    add_cpu_flag, device_from_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetDenseCls, PointNetfeat, STN3d, STNkd, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import steps
from adversarial_learning_on_pointclouds_tpu_torch.train.state import (
    train_device,
)

NUM_PARTS = 50
PROFILE_TRIES = 8
WINDOW_CALLS = 5     # calls in a profiler window
CSRC = Path(__file__).resolve().parent / "csrc"
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def stn_loss(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    return (model(x) ** 2).sum()


def encoder_loss(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    return (model(x)[1] ** 2).sum()


def segmenter_loss(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    return (model(x)[0] ** 2).sum()


# (line label, model key, loss, input key), in the JAX script's order.
COMPONENTS = (
    ("STN3d fwd+bwd", "stn3", stn_loss, "x"),
    ("STNkd(64) fwd+bwd", "stn64", stn_loss, "x64"),
    ("encoder (incl. both T-nets) fwd+bwd", "encoder", encoder_loss, "x"),
    ("full segmenter G fwd+bwd", "segmenter", segmenter_loss, "x"),
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--steps", type=int, default=30,
                   help="timed calls a component (the JAX script's timeit "
                        "default)")
    add_cpu_flag(p)
    return p.parse_args(argv)


def inputs(batch: int, points: int, device) -> Dict[str, torch.Tensor]:
    """The JAX script's inputs: standard normals from ``default_rng(0)``
    ``[B, N, 3]`` and ``default_rng(1)`` ``[B, N, 64]``."""
    x = np.random.default_rng(0).standard_normal(
        (batch, points, 3)).astype(np.float32)
    x64 = np.random.default_rng(1).standard_normal(
        (batch, points, 64)).astype(np.float32)
    return {"x": torch.from_numpy(x).to(device),
            "x64": torch.from_numpy(x64).to(device)}


# model key -> constructor from a generator, seeded as the JAX script
# keys the component (PRNGKey 0-3).
MODELS = {
    "stn3": (0, lambda gen: STN3d(generator=gen)),
    "stn64": (1, lambda gen: STNkd(64, generator=gen)),
    "encoder": (2, lambda gen: PointNetfeat(True, generator=gen)),
    "segmenter": (3, lambda gen: PointNetDenseCls(NUM_PARTS, True,
                                                  generator=gen)),
}


def make_models(device) -> Dict[str, torch.nn.Module]:
    """The four components, seeded, in training mode on ``device``."""
    return {k: make(torch.Generator().manual_seed(seed)).to(device).train()
            for k, (seed, make) in MODELS.items()}


def fwd_bwd(model: torch.nn.Module, loss_fn: Callable, x: torch.Tensor,
            bf16: bool) -> torch.Tensor:
    """One forward + backward: the loss, the gradients left in the
    parameters' ``.grad`` (set anew, not accumulated)."""
    model.zero_grad(set_to_none=True)
    with core.mixed_precision(enabled=bf16):
        loss = loss_fn(model, x)
        loss.backward()
    return loss.detach()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn: Callable, n: int, device: torch.device) -> float:
    """The JAX script's ``timeit``: seconds a call over ``n`` calls after
    one warm call."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / n


def _busy_ns(spans: List[tuple]) -> int:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@functools.lru_cache(maxsize=None)
def port_kernels() -> frozenset:
    """The names of the port's CUDA kernels: ``csrc/``'s ``__global__``
    functions."""
    return frozenset(name for f in CSRC.iterdir() if f.suffix in (".cu",
                                                                ".cuh")
                     for name in _GLOBAL.findall(f.read_text()))


def is_port_kernel(record: str) -> bool:
    """Whether a profiler record's name (``void f1_tc_kernel<false, 64>(
    F1Args)``) is one of ``port_kernels``."""
    m = re.search(r"(\w+)\s*[<(]", record)
    return bool(m) and m.group(1) in port_kernels()


def device_window(fn: Callable, calls: int = WINDOW_CALLS) -> dict:
    """One torch.profiler window of ``calls`` calls of ``fn`` on the card:
    ``device_ms`` (busy, a call), ``records`` and ``port_records``
    (device records a call, all and the port's kernels'), ``kernels``
    (``{name: records a call}``), ``launches`` (the wrappers' counted
    launches a call, ``{kernel: {pass: n}}``), ``uneven`` (``{name:
    records in the window}`` of PyTorch's records whose count the calls
    do not divide) and ``windows`` (taken). A window is short when it
    holds fewer records of the port's kernels than the wrappers launched,
    or one of the port's kernels counted a number of times that the calls
    do not divide (every call launches the same kernels); it is taken
    again, up to ``PROFILE_TRIES`` windows, then this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(PROFILE_TRIES):
        steps.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = steps.launches()
        n_launched = sum(sum(p.values()) for p in launched.values())
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        names = collections.Counter(e.name() for e in events)
        port = {k: c for k, c in names.items() if is_port_kernel(k)}
        ours = sum(port.values())
        odd = {k[:40]: c for k, c in port.items() if c % calls}
        seen.append((ours, n_launched, odd))
        if ours < n_launched or odd:
            continue
        spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in events]
        return {"device_ms": _busy_ns(spans) / calls / 1e6,
                "records": len(events) / calls,
                "port_records": ours // calls,
                "kernels": {k: c / calls for k, c in names.items()},
                "launches": {k: {p: n // calls for p, n in v.items()}
                             for k, v in launched.items()},
                "uneven": {k[:40]: c for k, c in names.items()
                           if c % calls and k not in port},
                "windows": len(seen)}
    raise RuntimeError(
        f"torch.profiler lost records in {PROFILE_TRIES} windows of "
        f"{calls} calls (the port's kernels' records, counted launches, "
        f"port kernels the calls do not divide: {seen}): device time not "
        "measured")


def shares(t3: float, t64: float, te: float, ts: float) -> dict:
    """The three shares of the components' times, in the JAX script's
    order."""
    return {"tnet_of_encoder": (t3 + t64) / te, "encoder_of_g": te / ts,
            "tnet_of_g": (t3 + t64) / ts}


def share_line(sh: dict) -> str:
    """The JAX script's share line."""
    return (f"T-net share of encoder: {sh['tnet_of_encoder']:.1%}; "
            f"encoder share of G: {sh['encoder_of_g']:.1%}; "
            f"T-net share of G: {sh['tnet_of_g']:.1%}")


def _launch_text(launches: Dict[str, Dict[str, int]]) -> str:
    return ", ".join(
        f"{k} " + " ".join(f"{p} {n}" for p, n in v.items() if n)
        for k, v in launches.items() if any(v.values())) or "none"


def main(argv: Optional[Sequence[str]] = None) -> dict:
    a = parse_args(argv)
    device = train_device(device_from_args(a))
    if device.type == "cuda":
        core.exact_fp32()
    bf16 = not a.fp32
    xs = inputs(a.batch, a.points, device)
    models = make_models(device)
    on = (torch.cuda.get_device_name(device) if device.type == "cuda"
          else "cpu")
    print(f"B={a.batch} N={a.points} {'bf16' if bf16 else 'fp32'} on {on}, "
          f"{a.steps} steps", flush=True)
    rows = []
    for name, key, loss_fn, x_key in COMPONENTS:
        def fn(model=models[key], loss_fn=loss_fn, x=xs[x_key]):
            return fwd_bwd(model, loss_fn, x, bf16)

        row = {"name": name, "wall_ms": timeit(fn, a.steps, device) * 1e3}
        line = f"{name:<42s} {row['wall_ms']:8.3f} ms"
        if device.type == "cuda":
            row.update(device_window(fn))
            line += (f"  device {row['device_ms']:8.3f} ms, "
                     f"{row['records']:g} device records a call, "
                     f"{row['port_records']} of the port's kernels "
                     f"(profiler window {row['windows']}); launches "
                     f"{_launch_text(row['launches'])}")
            if row["uneven"]:
                line += ("; records the calls do not divide: "
                         f"{row['uneven']}")
        rows.append(row)
        print(line, flush=True)
    out = {"batch": a.batch, "points": a.points, "bf16": bf16,
           "steps": a.steps, "components": rows,
           "shares": shares(*(r["wall_ms"] for r in rows))}
    print(f"\n{share_line(out['shares'])}")
    if device.type == "cuda":
        out["device_shares"] = shares(*(r["device_ms"] for r in rows))
        print(f"on device time: {share_line(out['device_shares'])}")
    return out


if __name__ == "__main__":
    main()
