"""Evaluate a part segmenter on ShapeNet-part, on the GPU.

The port of ``scripts/eval_segmentation.py``: loads a checkpoint (a
directory written by the port's trainers, or a reference-format ``.pth``
state_dict), reports instance mIoU, point accuracy and the per-category
table, and can export colored ``.ply`` point clouds of the first shapes'
predictions (``utils/ply.py``). ``--adversarial`` reads a config-4
checkpoint's generator only. Same flags as the JAX script; the card runs
the serving kernels, ``--cpu`` their plain PyTorch versions. The
model's part count and whether it has the feature transform are read
from the checkpoint (the JAX script builds it with one). The test split is prepared as the trainers
prepare it, so at a run's ``--num_points`` (default 2048) this
reproduces the run's last eval.

    python -m adversarial_learning_on_pointclouds_tpu_torch.eval_segmentation \\
        --model seg --num_points 2048
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from adversarial_learning_on_pointclouds_tpu_torch import eval as eval_lib
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    SegmentConfig, add_cpu_flag, device_from_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    runner, segment,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import checkpoint
from adversarial_learning_on_pointclouds_tpu_torch.utils.ply import (
    write_ply_with_labels,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", type=str, required=True,
                   help="checkpoint dir (as written by training) or a "
                        "reference-format .pth state_dict")
    p.add_argument("--dataset", type=str, default="")
    p.add_argument("--split", type=str, default="test",
                   choices=("test", "val", "train"),
                   help="which split to evaluate (the split's files must "
                        "exist in the dataset layout)")
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--class_choice", type=str, default=None)
    p.add_argument("--export_ply", type=str, default=None,
                   help="write the first batch's predictions here as .ply")
    p.add_argument("--adversarial", action="store_true",
                   help="checkpoint is a GAN state (config 4)")
    add_cpu_flag(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    a = parse_args(argv)
    device = device_from_args(a)
    # The segmenter only (for --adversarial the generator's field): eval
    # needs no optimizer and nothing of the discriminator.
    model = checkpoint.load_saved_segmenter(
        a.model, "g_model" if a.adversarial else "model", device)
    cfg = SegmentConfig(batch_size=a.batchSize, num_points=a.num_points,
                        dataset=a.dataset, class_choice=a.class_choice)

    _, (x_te, s_te, c_te) = runner._shapenet_arrays(cfg, eval_split=a.split)
    ev, table = eval_lib.evaluate_segmenter(model, x_te, s_te, c_te,
                                            cfg.batch_size)
    print(f"instance mIoU: {ev['instance_miou']:.4f}")
    print(f"point accuracy: {ev['point_accuracy']:.4f}")
    for cat, miou in sorted(table.items()):
        print(f"  {cat:12s} {miou:.4f}")

    if a.export_ply:
        import torch

        x = torch.from_numpy(x_te[:4]).to(device)
        out = segment.eval_step(model, x, torch.from_numpy(s_te[:4]).to(device),
                                torch.from_numpy(c_te[:4]).to(device))
        pred = out["pred"].cpu().numpy()
        os.makedirs(a.export_ply, exist_ok=True)
        for i in range(pred.shape[0]):
            path = os.path.join(a.export_ply, f"shape{i}.ply")
            write_ply_with_labels(path, x_te[i], pred[i])
            print(f"wrote {path}")
    return ev, table


if __name__ == "__main__":
    main()
