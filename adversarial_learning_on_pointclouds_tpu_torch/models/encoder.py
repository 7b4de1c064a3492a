"""PointNet encoder trunk (``PointNetfeat`` in the reference), eval.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/models/
encoder.py::apply_encoder_parts`` with ``train=False`` under
``use_pallas``. On ``x [B, N, 3]``:

1. STN3d predicts ``T [B, 3, 3]``; ``x <- x @ T``.
2. conv1 3->64 + BN + ReLU (``fused_linear_affine_act``).
3. With ``feature_transform``, STNkd predicts ``T64``; ``x <- x @ T64``.
   This is the per-point feature ``[B, N, 64]``.
4. conv2 64->128 (BN, ReLU) -> conv3 128->1024 (BN, **no ReLU**, the
   reference's quirk) -> max over points, as one ``fused_stack_maxpool``:
   the 1024-d global feature ``[B, 1024]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.models.tnet import (
    STN3d, STNkd,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch as ops
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    encoder_fused,
)


class PointNetfeat(nn.Module):
    def __init__(self, feature_transform: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_transform = feature_transform
        self.stn = STN3d()
        self.conv1 = nn.Conv1d(3, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)
        if feature_transform:
            self.fstn = STNkd(64)
        core.finish_init(self, device, generator)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
        """``x [B, N, 3]`` -> ``(point_feat [B, N, 64], global [B, 1024],
        trans [B, 3, 3], trans_feat [B, 64, 64] or None)``."""
        core.require_eval(self)
        trans = self.stn(x)
        x = ops.batched_transform(x, trans)
        x = ops.linear_bn_act(self.conv1, self.bn1, x, "relu")
        trans_feat = None
        if self.feature_transform:
            trans_feat = self.fstn(x)
            x = ops.batched_transform(x, trans_feat)
        w2, s2, c2 = ops.folded_affine(self.conv2, self.bn2)
        w3, s3, c3 = ops.folded_affine(self.conv3, self.bn3)
        g = encoder_fused.fused_stack_maxpool(x, (w2, w3), (s2, s3), (c2, c3),
                                              ("relu", None))
        return x, g, trans, trans_feat
