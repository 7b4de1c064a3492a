"""PointNet part segmenter (``PointNetDenseCls``), the adversarial
trainer's generator.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/models/
segmenter.py::apply_segmenter`` under ``use_pallas``: the encoder's
per-point and global features go straight into the head (1088->512->256
->128->k, BN + ReLU each, then a per-point ``log_softmax``), so the ``[B,
N, 1088]`` concat never exists. Eval runs ``seg_head_fused`` with folded
BNs (its plain version on the plain path, ``ops.plain``); train (``.train()``) runs ``seg_head_train`` with batch statistics
and updates the running statistics in place; under
``ops.use_pallas_train``, at a point count ``ops.layer_by_layer`` names,
the head runs layer by layer as the JAX package's does there (conv1 split
into its point and global halves in plain PyTorch, conv2-conv4 through
``pointwise_matmul``, then ``log_softmax``). ``forward_pair`` is the
adversarial trainer's two-stream training forward.
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
    seg_head_train,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist


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
        pf, g, trans, trans_feat = self.feat(x)
        if self.training:
            return self._train_head(pf, g), trans, trans_feat
        folded = [ops.folded_affine(getattr(self, f"conv{i}"),
                                    getattr(self, f"bn{i}")) for i in (1, 2, 3)]
        logp = ops.seg_head(pf, g, *folded[0], *folded[1], *folded[2],
                            core.weight_in_out(self.conv4), self.conv4.bias)
        return logp, trans, trans_feat

    def forward_pair(self, x_a: torch.Tensor, x_b: torch.Tensor,
                     paired_trunks: bool = False, paired_conv1: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The train-mode forward of two streams ``[B, N, 3]`` -> ``(logp_a,
        logp_b, trans_feat_a, trans_feat_b)``, as the JAX package's
        ``apply_segmenter_pair`` (the adversarial trainer's default,
        ``paired_heads``): the encoder through ``PointNetfeat.forward_pair``
        (``paired_trunks``: its trunks batched across the streams;
        ``paired_conv1``: its conv1 layers), then the seg head per stream,
        a then b."""
        if not self.training:
            raise ValueError("forward_pair is the two-stream training "
                             "forward: put the model in .train() first")
        pf_a, g_a, pf_b, g_b, tf_a, tf_b = self.feat.forward_pair(
            x_a, x_b, paired_trunks, paired_conv1)
        logp_a = self._train_head(pf_a, g_a)
        return logp_a, self._train_head(pf_b, g_b), tf_a, tf_b

    def _train_head(self, pf: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if ops.layer_by_layer(pf.shape[1]):
            c = pf.shape[-1]
            w1 = core.weight_in_out(self.conv1)
            z = (core.matmul(pf, w1[:c]) + core.matmul(g, w1[c:])[:, None]
                 + self.conv1.bias)
            h = torch.relu(core.batch_norm_train(self.bn1, z))
            h = ops.linear_bn_act(self.conv2, self.bn2, h, "relu")
            h = ops.linear_bn_act(self.conv3, self.bn3, h, "relu")
            return torch.log_softmax(ops.linear_act(self.conv4, h), dim=-1)
        params = []
        for i in (1, 2, 3):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            params += [core.weight_in_out(conv), conv.bias, bn.weight, bn.bias]
        logp, *stats = seg_head_train.seg_head_train(
            pf, g, *params, core.weight_in_out(self.conv4), self.conv4.bias)
        m = dist.count(pf.shape[0] * pf.shape[1], True)
        for i, (mu, var) in enumerate(zip(stats[::2], stats[1::2]), start=1):
            core.update_running(getattr(self, f"bn{i}"), mu, var, m)
        return logp
