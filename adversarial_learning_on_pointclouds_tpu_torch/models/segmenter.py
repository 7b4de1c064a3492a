"""PointNet part segmenter (``PointNetDenseCls``), the adversarial
trainer's generator, eval forward.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/models/
segmenter.py::apply_segmenter`` with ``train=False`` under
``use_pallas``: the encoder's per-point and global features go straight
into ``seg_head_fused`` (1088->512->256->128->k with folded BN, then a
per-point ``log_softmax``), so the ``[B, N, 1088]`` concat never exists.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.models.encoder import (
    PointNetfeat,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch as ops
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    encoder_fused,
)


class PointNetDenseCls(nn.Module):
    def __init__(self, k: int = 50, feature_transform: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        self.feat = PointNetfeat(feature_transform)
        self.conv1 = nn.Conv1d(1088, 512, 1)
        self.conv2 = nn.Conv1d(512, 256, 1)
        self.conv3 = nn.Conv1d(256, 128, 1)
        self.conv4 = nn.Conv1d(128, k, 1)
        self.bn1 = nn.BatchNorm1d(512)
        self.bn2 = nn.BatchNorm1d(256)
        self.bn3 = nn.BatchNorm1d(128)
        core.finish_init(self, device, generator)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``x [B, N, 3]`` -> ``(log_probs [B, N, k], trans, trans_feat)``."""
        core.require_eval(self)
        pf, g, trans, trans_feat = self.feat(x)
        folded = [ops.folded_affine(getattr(self, f"conv{i}"),
                                    getattr(self, f"bn{i}")) for i in (1, 2, 3)]
        logp = encoder_fused.seg_head_fused(
            pf, g, *folded[0], *folded[1], *folded[2],
            core.weight_in_out(self.conv4), self.conv4.bias)
        return logp, trans, trans_feat
