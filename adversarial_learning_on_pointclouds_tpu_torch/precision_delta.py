"""bf16-vs-fp32 accuracy delta on the flagship config, through the port's
runner.

The port's twin of ``scripts/precision_delta.py``: the same flags, the
same loop and the same JSON schema (``PRECISION_r03.json``'s). Config 4
(adv + semi) at ``--ratio`` runs for each seed twice through
``train/runner.py::run_adversarial``, in fp32 and then in bf16 mixed
precision (``core.mixed_precision``: bf16 matmul operands and stashes,
fp32 sums, BN and reductions), on the learnable synthetic ShapeNet-part
fixture (per-category blob constellations, the same protocol as the
adversarial-gain sweep). Each run reports its best-epoch instance mIoU
on the held-out split; the summary gives each mode's mean and std and
the delta of the means.

The fixture holds the JAX script's arrays (``make_synthetic_shapenet`` at
its defaults) in the npz layout, written once under the temporary
directory and shared with the port's sweep
(``ablation_adversarial_gain.synthetic_root``). Each run's logs go to
``run_dir(a, seed, mode)`` (named for ``--json``, so that two runs side
by side keep theirs apart), emptied first. The runs take the card unless
``--cpu`` asks for the CPU (the kernels' plain versions); without a card
it raises before it writes anything.

    python -m adversarial_learning_on_pointclouds_tpu_torch.precision_delta \\
        --seeds 3 --nepoch 100
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from adversarial_learning_on_pointclouds_tpu_torch.ablation_adversarial_gain import (
    device_name, synthetic_root,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig, add_cpu_flag, device_from_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import runner
from adversarial_learning_on_pointclouds_tpu_torch.train.state import (
    train_device,
)

MODES = ("fp32", "bf16")
# The run configuration's keys, as the JAX script records them.
CFG_KEYS = ("seeds", "ratio", "nepoch", "batchSize", "num_points",
            "num_shapes")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--ratio", type=float, default=0.5)
    p.add_argument("--nepoch", type=int, default=100)
    p.add_argument("--batchSize", type=int, default=16)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--num_shapes", type=int, default=512)
    p.add_argument("--json", type=str, default="PRECISION_torch.json")
    p.add_argument("--quick", action="store_true",
                   help="tiny smoke setting (CI): 1 seed, 2 epochs, "
                        "96 shapes")
    add_cpu_flag(p)
    a = p.parse_args(argv)
    if a.quick:
        a.seeds, a.nepoch, a.num_shapes = 1, 2, 96
    return a


def fixture(a: argparse.Namespace) -> str:
    """The data root: the JAX script's fixture at ``--num_shapes`` and
    ``--num_points``, in the npz layout."""
    return synthetic_root(a.num_shapes, a.num_points)


def run_dir(a: argparse.Namespace, seed: int, mode: str) -> str:
    """A run's output directory (its metric CSVs)."""
    stem = os.path.splitext(os.path.basename(a.json))[0]
    return os.path.join(tempfile.gettempdir(), f"prec_{stem}_{seed}_{mode}")


def summarize(runs: list) -> dict:
    """Per mode the mean, std and runs of ``best_miou``; the delta of the
    means, bf16 less fp32."""
    summary = {}
    for mode in MODES:
        vals = [r["best_miou"] for r in runs if r["mode"] == mode]
        summary[mode] = {"mean": round(float(np.mean(vals)), 5),
                         "std": round(float(np.std(vals)), 5),
                         "runs": vals}
    summary["delta_bf16_minus_fp32"] = round(
        summary["bf16"]["mean"] - summary["fp32"]["mean"], 5)
    return summary


def main(argv: Optional[Sequence[str]] = None) -> dict:
    a = parse_args(argv)
    device = device_from_args(a)
    train_device(device)  # no card: raise before the fixture is written
    root = fixture(a)
    runs = []
    for seed in range(a.seeds):
        for mode in MODES:
            out_dir = run_dir(a, seed, mode)
            shutil.rmtree(out_dir, ignore_errors=True)
            cfg = AdversarialConfig(
                dataset=root, labeled_ratio=a.ratio, seed=seed,
                batch_size=a.batchSize, num_points=a.num_points,
                epochs=a.nepoch, bf16=(mode == "bf16"),
                ckpt_policy="none", quiet=True, out_dir=out_dir)
            t0 = time.perf_counter()
            res = runner.run_adversarial(cfg, device=device)
            dt = time.perf_counter() - t0
            row = {"seed": seed, "mode": mode,
                   "best_miou": round(float(res["best_miou"]), 5),
                   "wall_s": round(dt, 1)}
            runs.append(row)
            print(f"[precision] {row}", flush=True)

    summary = summarize(runs)
    out = {"config": {k: getattr(a, k) for k in CFG_KEYS},
           "runs": runs, "summary": summary}
    with open(a.json, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {a.json} ({device_name(device)})")
    print("\n| precision | best mIoU (mean ± std) |")
    print("|---|---|")
    for mode in MODES:
        s = summary[mode]
        print(f"| {mode} | {s['mean']:.4f} ± {s['std']:.4f} |")
    print(f"delta (bf16 - fp32): {summary['delta_bf16_minus_fp32']:+.4f}")
    return out


if __name__ == "__main__":
    main()
