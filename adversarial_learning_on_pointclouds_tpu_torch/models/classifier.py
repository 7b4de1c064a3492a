"""PointNet classifier (``PointNetCls``), configs 1, 2 and 5.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/models/
classifier.py::apply_classifier``: the encoder's 1024-d global feature
(``PointNetfeat``), fc1 1024->512 + BN + ReLU, fc2 512->256 with dropout
*between* the linear and its BN (the reference's ordering,
``relu(bn2(dropout(fc2(x))))``), fc3 256->k and ``log_softmax``.
Parameter names are the reference's (the dropout has none), so a
reference ``PointNetCls`` state_dict loads with ``strict=True``.

fc1 + bn1 runs ``ops.linear_bn_act`` on ``[B, 1024]`` rows, plain
``torch.matmul`` in both modes, as the JAX package leaves it to XLA. On a
card the eval forward launches the encoder's eval kernels (conv1's
``fused_linear_affine_act``, the T-Nets' and the trunk's
``fused_stack_maxpool``); the train forward (``.train()``) its training
kernels (``trunk2_train`` per trunk, ``relu_fc_bn_relu`` per T-Net
head), with batch statistics and the running statistics updated in
place.
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


class PointNetCls(nn.Module):
    def __init__(self, k: int = 40, feature_transform: bool = False,
                 dropout: float = 0.3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        self.dropout = dropout
        self.feat = PointNetfeat(feature_transform)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k)
        self.bn1 = nn.BatchNorm1d(512)
        self.bn2 = nn.BatchNorm1d(256)
        core.finish_init(self, device, generator)

    def forward(self, x: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``x [B, N, 3]`` -> ``(log_probs [B, k], trans, trans_feat)``; in
        train mode the dropout mask is drawn from ``dropout_gen``."""
        _, h, trans, trans_feat = self.feat(x)
        h = ops.linear_bn_act(self.fc1, self.bn1, h, "relu")
        if self.training:
            h = core.dropout(core.dense(self.fc2, h), self.dropout,
                             dropout_gen)
            h = torch.relu(core.batch_norm_train(self.bn2, h))
        else:
            h = ops.linear_bn_act(self.fc2, self.bn2, h, "relu")
        return (torch.log_softmax(core.dense(self.fc3, h), dim=-1), trans,
                trans_feat)
