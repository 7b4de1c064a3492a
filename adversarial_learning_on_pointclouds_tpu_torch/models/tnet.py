"""T-Net spatial/feature transformers (STN3d / STNkd), eval forward.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/models/tnet.py``
(``apply_tnet`` with ``train=False`` under ``use_pallas``): the conv
trunk k->64->128->1024 (folded BN, ReLU each) and the max over points run
as one ``fused_stack_maxpool``; the fc head 1024->512->256->k*k on the
pooled ``[B, 1024]`` rows is plain ``torch.matmul``; the flattened
identity is added last. Parameter names are the reference's
(``bn4``/``bn5`` are the fc BNs).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch as ops
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    encoder_fused,
)


class STNkd(nn.Module):
    """``x [B, N, k]`` -> transform ``[B, k, k]``."""

    def __init__(self, k: int = 64, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        self.conv1 = nn.Conv1d(k, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k * k)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)
        self.bn4 = nn.BatchNorm1d(512)
        self.bn5 = nn.BatchNorm1d(256)
        core.finish_init(self, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        core.require_eval(self)
        ws, shifts, scales = zip(*(
            ops.folded_affine(getattr(self, f"conv{i}"), getattr(self, f"bn{i}"))
            for i in (1, 2, 3)))
        h = encoder_fused.fused_stack_maxpool(x, ws, shifts, scales,
                                              ("relu", "relu", "relu"))
        h = ops.linear_bn_act(self.fc1, self.bn4, h, "relu")
        h = ops.linear_bn_act(self.fc2, self.bn5, h, "relu")
        out = core.dense(self.fc3, h)
        iden = torch.eye(self.k, dtype=out.dtype, device=out.device)
        return (out + iden.reshape(-1)).reshape(-1, self.k, self.k)


class STN3d(STNkd):
    """The input transform: ``STNkd`` with ``k = 3``."""

    def __init__(self, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(3, device, generator)
