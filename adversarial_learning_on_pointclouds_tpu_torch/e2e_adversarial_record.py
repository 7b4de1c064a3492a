"""End-to-end throughput record of config 4: the adversarial runner
(index streams, the augmentation chain, G+D steps, the eval and a
checkpoint every epoch) on a large synthetic ShapeNet-part fixture.

Counterpart of ``scripts/e2e_adversarial_record.py``, with its flags and
defaults and ``--cpu``: labeled ratio 0.5, bf16, the feature transform,
``--scan K`` steps a call, or ``--fused_epoch`` (each epoch's steps and
eval in one call). Timed on the host's clock from the run's start to its
end, so epochs/s and points/s include the host's input pipeline, unlike
a step's device throughput. It prints the JAX script's JSON line, with
the same keys, as its last line; before it, one line an epoch with
``train_s``, ``eval_s``, ``ckpt_s`` and the host's share of the epoch
(``e2e_record``'s docstring says how that is measured). The fixture is
written once in the pts layout under the temporary directory.

    python -m adversarial_learning_on_pointclouds_tpu_torch.\\
e2e_adversarial_record --scan 8 --fused_epoch   # --cpu: plain versions
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.shapenet_part import (
    make_synthetic_shapenet,
)
from adversarial_learning_on_pointclouds_tpu_torch.e2e_record import (
    EpochClock, epoch_lines,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import runner


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", type=int, default=2048)
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--scan", type=int, default=0)
    p.add_argument("--fused_epoch", action="store_true",
                   help="one call per epoch (the train steps + the eval "
                        "scan) and one readback group after it")
    p.add_argument("--ckpt_policy", type=str, default="every",
                   choices=("every", "latest", "none"))
    p.add_argument("--augment", action="store_true",
                   help="rotate/jitter on (the synthetic fixture's labels "
                        "are axis-aligned, so rotation hurts its "
                        "learnability: off by default for the record)")
    p.add_argument("--outf", type=str, default="")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU: the kernels' plain PyTorch "
                        "versions (default: the card, the kernels)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    tmp = tempfile.gettempdir()
    root = os.path.join(tmp,
                        f"pointtpu_torch_e2e_sn_{args.shapes}x{args.points}")
    if not (os.path.isdir(root) and os.listdir(root)):
        make_synthetic_shapenet(root, num_shapes=args.shapes,
                                num_points=args.points)
    out = args.outf or os.path.join(tmp, "pointtpu_torch_e2e_adv")
    cfg = AdversarialConfig(
        dataset=root, num_points=args.points, batch_size=args.batch,
        epochs=args.epochs, labeled_ratio=0.5, feature_transform=True,
        augment=args.augment, bf16=True, scan=args.scan, out_dir=out,
        fused_epoch=args.fused_epoch, ckpt_policy=args.ckpt_policy,
        quiet=True)

    with EpochClock(device) as clock:
        t0 = time.perf_counter()
        result = runner.run_adversarial(cfg, device=device)
        wall = time.perf_counter() - t0
    for line in epoch_lines(out, "adv", args.epochs, clock.spans()):
        print(line)
    pts = 2 * args.batch * args.points * result["state"].step
    n_chips = 1  # the runner uses one device, a card or the CPU
    record = {
        "metric": "adversarial_e2e_epoch_throughput",
        "shapes": args.shapes, "points": args.points, "batch": args.batch,
        "epochs": args.epochs, "scan": args.scan,
        "fused_epoch": args.fused_epoch,
        "wall_s": round(wall, 1),
        "epochs_per_sec": round(args.epochs / wall, 4),
        "points_per_sec_per_chip_incl_host": round(pts / wall / n_chips, 1),
        "best_miou": round(float(result["best_miou"]), 4),
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
