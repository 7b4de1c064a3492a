"""End-to-end throughput records of the single-network configs: 1-2
(classification), 3 (segmentation) and 5 (FGSM perturbation training).

Counterpart of ``scripts/e2e_record.py``, with its flags and defaults
and ``--cpu``: the whole runner (index streams, the device gather and
augmentation chain, ``--scan K`` calls, the eval every epoch, the
checkpoints) on a large synthetic fixture, in bf16 with the feature
transform, timed on the host's clock from the run's start to its end.
It prints the JAX script's JSON line, with the same keys, as its last
line; before it, one line an epoch with the logger's ``train_s``,
``eval_s`` and ``ckpt_s`` and the host's share of the epoch (below).

ShapeNet-part (``--config seg``) is written once in the pts layout under
the temporary directory; ModelNet40 (``cls``, ``advp``) is
``data/modelnet40.synthetic_modelnet`` at ``--shapes`` train and
``--shapes // 4`` test clouds, in memory.

The host's share of an epoch is ``1 - device span / wall``: the wall is
``train_s + eval_s + ckpt_s``, the device span the time between two CUDA
events, one recorded before the epoch's first launch and one after its
eval's last. The span holds the device's idle gaps between launches, so
the share is a lower bound of the time the device waits on the host.

    python -m adversarial_learning_on_pointclouds_tpu_torch.e2e_record \\
        --config seg            # on the card; --cpu for the plain versions
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import functools
import json
import os
import tempfile
import time
from typing import List

import torch

from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdvPerturbConfig, ClassifyConfig, SegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.modelnet40 import (
    synthetic_modelnet,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.shapenet_part import (
    make_synthetic_shapenet,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import runner

# The runner's functions that launch an epoch's training (and, fused, its
# eval), and those that launch a per-step epoch's eval.
EPOCH_FNS = ("_single_net_epoch", "_fused_single_epoch", "_adv_epoch",
             "_fused_adv_epoch")
EVAL_FNS = ("_evaluate", "_evaluate_classifier")


class EpochClock:
    """Inside the block, a CUDA event is recorded before each of the
    runner's epoch calls and after it, and again after the epoch's eval
    (``EPOCH_FNS``, ``EVAL_FNS``): ``spans()`` gives each epoch's device
    span in seconds. On the CPU nothing is recorded."""

    def __init__(self, device):
        self.on = torch.device(device).type == "cuda"
        self.events: List[list] = []
        self._stack = contextlib.ExitStack()

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _wrap(self, name, train):
        fn = getattr(runner, name)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            if train:
                start = self._event()
            out = fn(*args, **kwargs)
            if train:
                self.events.append([start, self._event()])
            elif self.events:
                self.events[-1][1] = self._event()
            return out

        self._stack.callback(setattr, runner, name, fn)
        setattr(runner, name, timed)

    def __enter__(self):
        if self.on:
            for name in EPOCH_FNS + EVAL_FNS:
                self._wrap(name, name in EPOCH_FNS)
        return self

    def __exit__(self, *exc):
        self._stack.close()

    def spans(self) -> List[float]:
        if not self.on:
            return []
        torch.cuda.synchronize()
        return [s.elapsed_time(e) / 1e3 for s, e in self.events]


def epoch_lines(out_dir: str, name: str, epochs: int, spans) -> List[str]:
    """One line for each of the run's ``epochs`` epochs, the last rows of
    the logger's ``{name}_epochs.csv`` (it appends to a file an earlier
    run left), with the device spans (``EpochClock``), for the lines
    before the JSON."""
    with open(os.path.join(out_dir, f"{name}_epochs.csv")) as f:
        rows = list(csv.DictReader(f))[-epochs:]
    lines = []
    for i, r in enumerate(rows):
        t = {k: float(r[k]) for k in ("train_s", "eval_s", "ckpt_s")}
        wall = sum(t.values())
        line = (f"[e2e] epoch {r['epoch']}: train_s {t['train_s']:.4f}, "
                f"eval_s {t['eval_s']:.4f}, ckpt_s {t['ckpt_s']:.4f}")
        if i < len(spans):
            line += (f"; device span {spans[i]:.4f} s, host share "
                     f"{1 - spans[i] / wall:.1%}")
        else:
            line += "; device span not measured (no card)"
        lines.append(line)
    return lines


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", choices=("cls", "seg", "advp"),
                   default="cls")
    p.add_argument("--shapes", type=int, default=2048)
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--scan", type=int, default=8)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--outf", type=str, default="")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU: the kernels' plain PyTorch "
                        "versions (default: the card, the kernels)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    tmp = tempfile.gettempdir()
    out = args.outf or os.path.join(tmp, f"pointtpu_torch_e2e_{args.config}")
    kw = dict(num_points=args.points, batch_size=args.batch,
              epochs=args.epochs, feature_transform=True,
              augment=args.augment, bf16=True, scan=args.scan,
              out_dir=out, quiet=True)
    fixture = contextlib.ExitStack()
    if args.config == "seg":
        root = os.path.join(
            tmp, f"pointtpu_torch_e2e_sn_{args.shapes}x{args.points}")
        if not (os.path.isdir(root) and os.listdir(root)):
            make_synthetic_shapenet(root, num_shapes=args.shapes,
                                    num_points=args.points)
        cfg = SegmentConfig(dataset=root, **kw)
        run, key = runner.run_segmentation, "best_miou"
    else:
        fixture.callback(setattr, runner, "synthetic_modelnet",
                         runner.synthetic_modelnet)
        runner.synthetic_modelnet = functools.partial(
            synthetic_modelnet, args.shapes, args.shapes // 4, args.points)
        if args.config == "advp":
            cfg = AdvPerturbConfig(epsilon=0.05, **kw)
            run, key = runner.run_adv_perturb, "best_accuracy"
        else:
            cfg = ClassifyConfig(**kw)
            run, key = runner.run_classification, "best_accuracy"

    with fixture, EpochClock(device) as clock:
        t0 = time.perf_counter()
        result = run(cfg, device=device)
        wall = time.perf_counter() - t0
    for line in epoch_lines(out, args.config, args.epochs, clock.spans()):
        print(line)
    pts = args.batch * args.points * result["state"].step
    n_chips = 1  # the runners use one device, a card or the CPU
    record = {
        "metric": f"{args.config}_e2e_epoch_throughput",
        "shapes": args.shapes, "points": args.points, "batch": args.batch,
        "epochs": args.epochs, "scan": args.scan,
        "wall_s": round(wall, 1),
        "epochs_per_sec": round(args.epochs / wall, 4),
        "points_per_sec_per_chip_incl_host": round(
            pts / wall / n_chips, 1),
        "best": round(float(result[key]), 4),
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
