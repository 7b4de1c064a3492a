"""Giant-cloud segmentation: the point axis sharded over the ranks.

The port of ``scripts/train_giant_cloud.py``: config-3 segmentation at
point counts where one device's memory or latency budget runs out, each
cloud's points split across W ranks (``parallel/point.py``:
``point_sharded_train_step``, ``point_sharded_eval``). Every layer is per
point except the BN statistics, the max-pools and the loss mean, which
reduce over every rank's points; parameters, optimizer state and
gradients stay the same on every rank. It runs the plain path
(``ops.dispatch.use_kernels(False)``), as the JAX package forces its XLA
path there.

The train step refuses a ``--num_points`` that the ranks do not divide
(padding would bias the BN statistics; resample to a multiple instead;
the eval pads and trims exactly). Without ``--dataset`` it trains on a
synthetic fixture at ``--num_points``. ``--num_devices W`` spawns W ranks
(0: every visible card; with ``--cpu``, one rank, or W gloo ranks).
Only rank 0 logs and checkpoints.

    python -m adversarial_learning_on_pointclouds_tpu_torch.train_giant_cloud \\
        --cpu --num_devices 2 --num_points 4096 --num_shapes 16 \\
        --batchSize 2 --nepoch 2
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    SegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.loader import (
    host_batch_iterator, num_batches,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.shapenet_part import (
    make_synthetic_shapenet,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import (
    dist, point,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    runner, segment,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import checkpoint
from adversarial_learning_on_pointclouds_tpu_torch.utils.logging import (
    MetricLogger,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils.metrics import (
    shape_ious_device,
)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="point-sharded giant-cloud segmentation")
    p.add_argument("--dataset", type=str, default="",
                   help="ShapeNet-part root ('' = synthetic fixture at "
                        "--num_points resolution)")
    p.add_argument("--num_points", type=int, default=16384)
    p.add_argument("--num_shapes", type=int, default=32,
                   help="synthetic fixture size")
    p.add_argument("--batchSize", type=int, default=4)
    p.add_argument("--nepoch", type=int, default=10)
    p.add_argument("--num_devices", type=int, default=0,
                   help="ranks the points split over (0 = every visible "
                        "card; one rank with --cpu)")
    p.add_argument("--feature_transform", action="store_true")
    p.add_argument("--outf", type=str, default="seg_giant")
    p.add_argument("--ckpt_policy", type=str, default="every",
                   choices=["every", "latest", "best", "none"],
                   help="per-epoch checkpointing: every epoch, skip to the "
                        "latest, the best eval epoch only, or none")
    p.add_argument("--eval_every", type=int, default=1,
                   help="run the (point-sharded) eval pass every K-th "
                        "epoch and always the last one")
    p.add_argument("--class_choice", type=str, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (gloo ranks; default: the cards)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The CLI: ``{"best_miou": ...}`` (rank 0's, where it spawned
    ranks)."""
    p = parser()
    a = p.parse_args(argv)
    device = "cpu" if a.cpu else "cuda"
    world = (dist.world_size() if dist.world_size() > 1
             else dist.resolve_world(a.num_devices, device))
    if a.num_points % world:
        p.error(f"--num_points {a.num_points} must divide the {world} "
                "ranks (BN statistics must not see pad points; resample "
                "to a multiple)")
    ranks = dist.cli_ranks(__spec__.name if __spec__ else __name__, argv,
                           a.num_devices, device)
    if ranks is not None:
        return ranks[0]
    return {"best_miou": train(a, device)}


def train(a: argparse.Namespace, device) -> float:
    """The run of ``a`` in this process (one rank of the group, or the
    only process); returns the best instance mIoU."""
    world = dist.world_size()
    cfg = SegmentConfig(
        dataset=(a.dataset or os.path.join(
            tempfile.gettempdir(),
            f"pointtpu_torch_giant_{a.num_shapes}x{a.num_points}")),
        num_points=a.num_points, batch_size=a.batchSize, epochs=a.nepoch,
        feature_transform=a.feature_transform, class_choice=a.class_choice,
        out_dir=a.outf, device_data=False, scan=0, resample=False,
        num_devices=a.num_devices)
    if not a.dataset and dist.rank() == 0 and not (
            os.path.isdir(cfg.dataset) and os.listdir(cfg.dataset)):
        make_synthetic_shapenet(cfg.dataset, num_shapes=a.num_shapes,
                                num_points=a.num_points, cluster_parts=True)
    dist.barrier()    # the fixture is on disk before any rank reads it
    (x_tr, s_tr, _c_tr), (x_te, s_te, c_te) = runner._shapenet_arrays(cfg)
    dev = runner._setup(cfg, device)
    spe = num_batches(len(x_tr), cfg.batch_size)
    if a.nepoch < 1 or spe < 1:
        raise SystemExit(f"nothing to train: {a.nepoch} epochs x {spe} "
                         f"steps/epoch (train set {len(x_tr)} shapes < "
                         f"--batchSize {a.batchSize}?)")
    tx = segment.make_tx(cfg, spe)
    state = segment.create_state(cfg, spe, device=dev)
    logger = MetricLogger(cfg.out_dir, "seg_giant", quiet=cfg.quiet,
                          enabled=dist.rank() == 0)
    if dist.rank() == 0:
        print(f"[giant] ranks={world} N={a.num_points} "
              f"({a.num_points // world}/rank) batch={a.batchSize} "
              f"train={len(x_tr)} test={len(x_te)}", flush=True)

    best = 0.0
    m = {}
    saver = checkpoint.AsyncSaver(a.ckpt_policy if dist.rank() == 0
                                  else "none")
    for epoch in range(a.nepoch):
        t0 = time.perf_counter()
        for xb, yb in host_batch_iterator((x_tr, s_tr), cfg.batch_size,
                                          shuffle=True, seed=cfg.seed,
                                          epoch=epoch, drop_last=True):
            m = point.point_sharded_train_step(
                state, torch.from_numpy(xb).to(dev),
                torch.from_numpy(yb).long().to(dev), cfg=cfg, tx=tx)
        train_s = time.perf_counter() - t0

        if not ((epoch + 1) % max(a.eval_every, 1) == 0
                or epoch == a.nepoch - 1):
            if a.ckpt_policy != "best":
                saver.save(cfg.out_dir, epoch, state)
            continue

        # Eval: the point-sharded forward; the batch axis is whole on
        # every rank, so the ragged last batch needs no padding.
        ious, accs = [], []
        for i in range(0, len(x_te), cfg.batch_size):
            xb = torch.from_numpy(x_te[i:i + cfg.batch_size]).to(dev)
            yb = torch.from_numpy(s_te[i:i + cfg.batch_size]).long().to(dev)
            cb = torch.from_numpy(c_te[i:i + cfg.batch_size]).long().to(dev)
            pred = point.point_sharded_eval(state.model, xb,
                                            per_point=True).argmax(-1)
            ious.append(shape_ious_device(pred, yb, cb).cpu().numpy())
            accs.append((pred == yb).float().mean(1).cpu().numpy())
        miou = float(np.concatenate(ious).mean())
        best = max(best, miou)
        logger.log_epoch(
            epoch, instance_miou=miou,
            point_accuracy=float(np.concatenate(accs).mean()),
            loss=float(m["loss"]), train_s=round(train_s, 3),
            eval_s=round(time.perf_counter() - t0 - train_s, 3))
        saver.save(cfg.out_dir, epoch, state, metric=miou)
    saver.close()   # drains: the last epoch is on disk before returning
    logger.close()
    if dist.rank() == 0:
        print(f"[giant] best instance mIoU {best:.4f}")
    return best


if __name__ == "__main__":
    main()
