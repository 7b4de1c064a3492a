"""PointNet encoder trunk (``PointNetfeat`` in the reference).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/models/
encoder.py::apply_encoder_parts`` under ``use_pallas``. On ``x [B, N,
3]``:

1. STN3d predicts ``T [B, 3, 3]``; ``x <- x @ T``.
2. conv1 3->64 + BN + ReLU (``fused_linear_affine_act``).
3. With ``feature_transform``, STNkd predicts ``T64``; ``x <- x @ T64``.
   This is the per-point feature ``[B, N, 64]``.
4. conv2 64->128 (BN, ReLU) -> conv3 128->1024 (BN, **no ReLU**, the
   reference's quirk) -> max over points: the 1024-d global feature
   ``[B, 1024]``.

In eval mode step 2 is ``fused_linear_affine_act`` and step 4 one
``fused_stack_maxpool``, with folded BNs (their plain versions under
``ops.use_kernels(False)``, the attacks' context). In train mode (``.train()``)
the BNs use batch statistics and update their running statistics in
place: step 2 is plain PyTorch, step 4 ``trunk2_train``. Under
``ops.use_pallas_train`` step 2 runs ``pointwise_matmul`` and the
transforms ``tnet_apply``; at a point count ``ops.layer_by_layer`` names,
step 4 is conv2 + BN + ReLU and conv3 + BN (no activation) through
``pointwise_matmul``, then ``maxpool_points``, as the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.models.tnet import (
    STN3d, STNkd, train_trunk,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch as ops


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
        trans = self.stn(x)
        x = ops.batched_transform(x, trans)
        x = ops.linear_bn_act(self.conv1, self.bn1, x, "relu")
        trans_feat = None
        if self.feature_transform:
            trans_feat = self.fstn(x)
            x = ops.batched_transform(x, trans_feat)
        if self.training:
            return x, self._train_trunk(x), trans, trans_feat
        g = ops.stack_maxpool(x, (ops.folded_affine(self.conv2, self.bn2),
                                  ops.folded_affine(self.conv3, self.bn3)),
                              ("relu", None))
        return x, g, trans, trans_feat

    def forward_pair(self, x_a: torch.Tensor, x_b: torch.Tensor,
                     paired_trunks: bool = False, paired_conv1: bool = False):
        """Train mode, two streams -> ``(pf_a, g_a, pf_b, g_b, trans_feat_a,
        trans_feat_b)``, as the JAX package's ``apply_encoder_parts_pair``:
        the T-Nets through ``forward_pair``; conv1 and the trunk per
        stream, a then b, so every running statistic is chained a -> b;
        with ``paired_trunks`` the trunks (the T-Nets' too) run as one
        ``trunk2_train(groups=2)`` on the stacked streams, with the same
        statistics; with ``paired_conv1`` conv1 + BN1 of both streams run
        as one ``linear_bn_act_pair`` (per-stream statistics), here and in
        the T-Nets where their grouped trunk does not run."""
        t_a, t_b = self.stn.forward_pair(x_a, x_b, paired_trunks,
                                         paired_conv1)
        x_a = ops.batched_transform(x_a, t_a)
        x_b = ops.batched_transform(x_b, t_b)
        if paired_conv1:
            x_a, x_b = ops.linear_bn_act_pair(self.conv1, self.bn1, x_a, x_b,
                                              "relu")
        else:
            x_a = ops.linear_bn_act(self.conv1, self.bn1, x_a, "relu")
            x_b = ops.linear_bn_act(self.conv1, self.bn1, x_b, "relu")
        tf_a = tf_b = None
        if self.feature_transform:
            tf_a, tf_b = self.fstn.forward_pair(x_a, x_b, paired_trunks,
                                                paired_conv1)
            x_a = ops.batched_transform(x_a, tf_a)
            x_b = ops.batched_transform(x_b, tf_b)
        if paired_trunks and not ops.layer_by_layer(x_a.shape[1]):
            g = train_trunk(self, x_a, x_b)
            b = x_a.shape[0]
            return x_a, g[:b], x_b, g[b:], tf_a, tf_b
        g_a = self._train_trunk(x_a)
        g_b = self._train_trunk(x_b)
        return x_a, g_a, x_b, g_b, tf_a, tf_b

    def _train_trunk(self, x: torch.Tensor) -> torch.Tensor:
        """conv2 -> conv3 -> max over points of one stream in train mode."""
        if ops.layer_by_layer(x.shape[1]):
            h = ops.linear_bn_act(self.conv2, self.bn2, x, "relu")
            return ops.max_points(ops.linear_bn_act(self.conv3, self.bn3, h,
                                                    None))
        return train_trunk(self, x)
