"""Point sharding: one cloud's points split across the ranks.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/parallel/
mesh.py``'s ``point_sharded_eval`` and ``point_sharded_train_step``:
single-cloud scaling for point counts beyond one device's memory or
latency budget. Every layer is per point except the symmetric
max-pools, the BN batch statistics and the loss mean; under
``dist.point_sharding`` the first reduce over every rank's points
(``dist.all_reduce_max_points``), the others all-reduce their sums and
count the global points (``models/core.py``, ``losses.py``), while the
``[B, C]`` rows after the pools (the T-Net fc heads, the global feature)
are computed replicated on every rank. Both forms run the plain path
(``ops.dispatch.use_kernels(False)``), as the JAX package forces its XLA
path there: no kernel reduces over another rank's points.

Each rank is given the whole batch ``x [B, N, 3]`` (the same on every
rank) and takes its block of the point axis (``dist.shard_rows``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist
from adversarial_learning_on_pointclouds_tpu_torch.train import segment


def point_sharded_eval(model: torch.nn.Module, x: torch.Tensor,
                       per_point: Optional[bool] = None) -> torch.Tensor:
    """The eval forward of ``model`` (the classifier or the segmenter;
    its first output) on ``x [B, N, 3]`` with the point axis sharded
    across the ranks, the whole output on every rank.

    A point count that the world size does not divide is padded by
    repeating each cloud's last point, which is exact for this
    architecture (every layer is per point, and a max over points does not
    change when a point it already holds is repeated); per-point outputs
    are trimmed back to ``N``. ``per_point`` says whether the output keeps
    the point axis at position 1 (the segmenter's ``[B, N, k]``) or pools
    it away (the classifier's ``[B, k]``); None infers it from the shape,
    as the JAX package's does."""
    n = x.shape[1]
    pad = (-n) % dist.world_size()
    if pad:
        x = torch.cat([x, x[:, -1:].expand(-1, pad, -1)], dim=1)
    xs = dist.shard_rows(x, dim=1)
    with dispatch.use_kernels(False), dist.point_sharding(), \
            segment.eval_mode(model):
        out = model(xs)[0]
        if per_point is None:
            per_point = out.dim() >= 2 and out.shape[1] == xs.shape[1]
        if per_point:
            out = dist.gather_axis(out, dim=1)[:, :n]
    return out


def point_sharded_train_step(state, x: torch.Tensor, y: torch.Tensor, *,
                             cfg, tx) -> Dict[str, torch.Tensor]:
    """One segmentation training step (``segment.train_step``: in place,
    the global metrics returned) on ``x [B, N, 3]`` and per-point labels
    ``y [B, N]`` with the point axis sharded across the ranks: the BN
    statistics, the max-pools and the loss mean are the whole cloud's,
    and the gradients are summed over the ranks. ``N`` must divide the
    world size: a repeated pad point is invisible to a max-pool but would
    bias the BN statistics and the per-point loss, so it raises (resample
    to a multiple instead), as the JAX package's does."""
    n, w = x.shape[1], dist.world_size()
    if n % w:
        raise ValueError(
            f"point_sharded_train_step: N={n} must divide the {w} ranks "
            "(padding would bias BN statistics and the per-point loss; "
            "resample to a multiple instead)")
    with dispatch.use_kernels(False), dist.point_sharding():
        return segment.train_step(state, dist.shard_rows(x, dim=1),
                                  dist.shard_rows(y, dim=1), cfg=cfg, tx=tx)
