"""Serving-path throughput: exported artifacts against the live model.

The port of ``scripts/serve_bench.py``: eval-mode forward time at
serving shapes of a seeded model (feature transform on, the default
widths), for

- the portable artifact (``utils/serving.py``: the eval kernels' plain
  versions) in fp32 and bf16;
- the kernels artifact (the eval kernels' registered ops) in fp32 and
  bf16, on a CUDA device only;
- the live model on its plain versions (``launch.eval_route("plain")``)
  and on its kernels (the device rule), fp32.

Each artifact is timed as exported, in memory (the JAX script times its
``Exported`` so too), on the device ``utils.serving.serve`` puts it. A
row's time is the mean over ``--iters`` forwards between two
synchronizes (the card's queue drained before and after), on the host's
clock. Prints one line a row: ms/batch, clouds/s and Mpts/s. Same flags
as the JAX script, with ``--device`` (default ``cuda``) added; on the
CPU the rows that need the card are left out and say so.

    python -m adversarial_learning_on_pointclouds_tpu_torch.serve_bench \\
        --model seg --batch 32 --num_points 2500
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetCls, PointNetDenseCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import launch
from adversarial_learning_on_pointclouds_tpu_torch.utils import serving

ROWS = ("artifact fp32", "artifact bf16", "kernels artifact fp32",
        "kernels artifact bf16", "live plain fp32", "live kernels fp32")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, x: torch.Tensor, iters: int, device: torch.device) -> float:
    """Seconds a forward: ``fn(x)`` twice to warm up, then ``iters``
    forwards between two synchronizes."""
    with torch.inference_mode():
        fn(x)
        fn(x)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        _sync(device)
    return (time.perf_counter() - t0) / iters


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("cls", "seg"), default="seg")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda or cpu (no kernels rows on the CPU)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None
         ) -> List[Tuple[str, float]]:
    """Prints the rows; returns ``[(row, seconds a forward)]``."""
    a = parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {a.device}: CUDA is not available "
                           "(pass --device cpu)")
    core.exact_fp32()
    gen = torch.Generator().manual_seed(0)
    if a.model == "cls":
        model = PointNetCls(40, feature_transform=True, generator=gen)
        export = serving.export_classifier
    else:
        model = PointNetDenseCls(50, feature_transform=True, generator=gen)
        export = serving.export_segmenter
    model = model.to(device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (a.batch, a.num_points, 3)).astype(np.float32)).to(device)
    cuda = device.type == "cuda"
    rows = []
    for name in ROWS[:4]:
        kernels = name.startswith("kernels")
        if kernels and not cuda:
            print(f"{name:<22s} needs a CUDA device: not run")
            continue
        exp = export(model, a.num_points, a.batch,
                     ("cuda",) if kernels else serving.DEFAULT_DEVICES,
                     bf16=name.endswith("bf16"), kernels=kernels)
        served = serving.serve(exp, device)
        rows.append((name, _time(served.module, x, a.iters, device)))

    def live_plain(xx):
        with launch.eval_route("plain"):
            return model(xx)[0]

    rows.append(("live plain fp32", _time(live_plain, x, a.iters, device)))
    if cuda:
        rows.append(("live kernels fp32",
                     _time(lambda xx: model(xx)[0], x, a.iters, device)))
    else:
        print(f"{'live kernels fp32':<22s} needs a CUDA device: not run")
    for name, dt in rows:
        cps = a.batch / dt
        print(f"{name:<22s} {dt * 1e3:8.3f} ms/batch  {cps:10.1f} clouds/s"
              f"  {cps * a.num_points / 1e6:8.2f} Mpts/s")
    return rows


if __name__ == "__main__":
    main()
