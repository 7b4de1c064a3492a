"""T-Net spatial/feature transformers (STN3d / STNkd).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/models/tnet.py``
(``apply_tnet`` under ``use_pallas``). The conv trunk k->64->128->1024
(BN + ReLU each) ends in a max over points; the fc head 1024->512->256->
k*k runs on the pooled ``[B, 1024]`` rows; the flattened identity is
added last. Parameter names are the reference's (``bn4``/``bn5`` are the
fc BNs).

* Eval: the whole trunk and its max are one ``fused_stack_maxpool`` with
  folded BNs (``ops.stack_maxpool``: its plain version under
  ``ops.differentiable_eval``); the fc head is plain ``torch.matmul``.
* Train (``.train()``): conv1 is plain PyTorch with a batch-statistic BN;
  conv2 + conv3 + max run as ``trunk2_train`` with the post-pool ReLU
  applied to the pooled vector (``max(relu(y)) == relu(max(y))``); fc1 +
  BN + both ReLUs run as ``relu_fc_bn_relu`` (moments centred on the
  running mean); fc2 + BN is plain, then fc3. Running statistics update in
  place, as torch's BatchNorm does. ``forward_pair`` (train mode, two
  streams) runs the trunks per stream, or both in one
  ``trunk2_train(groups=2)`` with ``paired_trunks``, and the fc head once
  for both.
* Train under ``ops.use_pallas_train`` (the JAX package's
  ``use_pallas(training=True)``): conv1 runs ``pointwise_matmul``; at a
  point count the JAX package's fused kernels cannot tile
  (``ops.layer_by_layer``) the whole trunk runs layer by layer and ends in
  ``maxpool_points``; the single-stream fc head is one
  ``fc_head_train``, and ``forward_pair``'s paired head takes fc1 + BN in
  plain PyTorch (``batch_norm_train_grouped``), as the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch as ops
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    fc_head_train, pool_fc_epilogue, trunk_train,
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
        if self.training:
            out = self._train_head(self._train_trunk(x))
        else:
            h = ops.stack_maxpool(x, [
                ops.folded_affine(getattr(self, f"conv{i}"),
                                  getattr(self, f"bn{i}"))
                for i in (1, 2, 3)], ("relu", "relu", "relu"))
            h = ops.linear_bn_act(self.fc1, self.bn4, h, "relu")
            h = ops.linear_bn_act(self.fc2, self.bn5, h, "relu")
            out = core.dense(self.fc3, h)
        iden = torch.eye(self.k, dtype=out.dtype, device=out.device)
        return (out + iden.reshape(-1)).reshape(-1, self.k, self.k)

    def forward_pair(self, x_a: torch.Tensor, x_b: torch.Tensor,
                     paired_trunks: bool = False, paired_conv1: bool = False):
        """Train mode, two streams of the same shape -> ``(T_a, T_b)``, as
        the JAX package's ``apply_tnet_pair``: the conv trunks run per
        stream (running statistics chained a -> b), or with
        ``paired_trunks`` conv1 per stream and conv2 + conv3 + max as one
        ``trunk2_train(groups=2)`` on the stacked batch (its
        ``_pooled_trunk_grouped``: per-stream statistics, the EMA chained
        a -> b); the fc head runs once on the stacked ``[2B, 1024]`` pool
        with per-stream batch statistics (fc1 + BN through
        ``relu_fc_bn_relu(groups=2)``, fc2 + BN through
        ``batch_norm_train_grouped``), the exact statistics of two
        sequential heads. Under ``ops.use_pallas_train`` the fc1 + BN of the
        head is plain PyTorch (``batch_norm_train_grouped``), and at a point
        count ``ops.layer_by_layer`` names the trunks run per stream, layer
        by layer, with ``paired_trunks`` too, as the JAX package's.
        ``paired_conv1``, where the grouped trunk does not run, takes conv1
        + BN1 of both streams as one ``linear_bn_act_pair`` (per-stream
        statistics) and the rest of each trunk per stream (``_pooled``),
        as the JAX package's ``_pooled_trunk_pair_conv1``."""
        b = x_a.shape[0]
        if paired_trunks and not ops.layer_by_layer(x_a.shape[1]):
            h1_a = ops.linear_bn_act(self.conv1, self.bn1, x_a, "relu")
            h1_b = ops.linear_bn_act(self.conv1, self.bn1, x_b, "relu")
            h = torch.relu(train_trunk(self, h1_a, h1_b))
        elif paired_conv1:
            h1_a, h1_b = ops.linear_bn_act_pair(self.conv1, self.bn1, x_a,
                                                x_b, "relu")
            h_a = self._pooled(h1_a)
            h = torch.cat([h_a, self._pooled(h1_b)])
        else:
            h_a = self._train_trunk(x_a)
            h = torch.cat([h_a, self._train_trunk(x_b)])
        if ops.pallas_train_enabled():
            h1 = torch.relu(core.batch_norm_train_grouped(
                self.bn4, core.dense(self.fc1, h), 2))
        else:
            h1, mu1, var1 = pool_fc_epilogue.relu_fc_bn_relu(
                h, core.weight_in_out(self.fc1), self.fc1.bias,
                self.bn4.weight, self.bn4.bias, self.bn4.running_mean,
                groups=2)
            for i in range(2):
                core.update_running(self.bn4, mu1[i], var1[i], b)
        h2 = torch.relu(core.batch_norm_train_grouped(
            self.bn5, core.dense(self.fc2, h1), 2))
        out = core.dense(self.fc3, h2)
        iden = torch.eye(self.k, dtype=out.dtype, device=out.device)
        t = (out + iden.reshape(-1)).reshape(-1, self.k, self.k)
        return t[:b], t[b:]

    def _train_trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The pooled ``[B, 1024]`` (after the ReLU) of one stream."""
        return self._pooled(ops.linear_bn_act(self.conv1, self.bn1, x, "relu"))

    def _pooled(self, h1: torch.Tensor) -> torch.Tensor:
        """conv2 -> conv3 -> max over points of conv1's output ``h1``:
        ``trunk2_train``, or layer by layer where ``ops.layer_by_layer``
        says so."""
        if ops.layer_by_layer(h1.shape[1]):
            h = h1
            for i in (2, 3):
                h = ops.linear_bn_act(getattr(self, f"conv{i}"),
                                      getattr(self, f"bn{i}"), h, "relu")
            return ops.max_points(h)
        return torch.relu(train_trunk(self, h1))

    def _train_head(self, h: torch.Tensor) -> torch.Tensor:
        """fc1 -> fc3 of one stream in train mode (before the identity)."""
        m = h.shape[0]
        if ops.pallas_train_enabled():
            out, mu1, var1, mu2, var2 = fc_head_train.fc_head_train(
                h, core.weight_in_out(self.fc1), self.fc1.bias,
                self.bn4.weight, self.bn4.bias, core.weight_in_out(self.fc2),
                self.fc2.bias, self.bn5.weight, self.bn5.bias,
                core.weight_in_out(self.fc3), self.fc3.bias,
                self.bn4.running_mean, self.bn5.running_mean)
            core.update_running(self.bn4, mu1, var1, m)
            core.update_running(self.bn5, mu2, var2, m)
            return out
        h1, mu1, var1 = pool_fc_epilogue.relu_fc_bn_relu(
            h, core.weight_in_out(self.fc1), self.fc1.bias, self.bn4.weight,
            self.bn4.bias, self.bn4.running_mean)
        core.update_running(self.bn4, mu1, var1, m)
        return core.dense(self.fc3,
                          ops.linear_bn_act(self.fc2, self.bn5, h1, "relu"))


def train_trunk(module: nn.Module, *xs: torch.Tensor) -> torch.Tensor:
    """``module``'s conv2 + bn2 + ReLU -> conv3 + bn3 -> max over points in
    train mode, through ``trunk2_train``, of one stream, or of several
    same-shape streams stacked into one call (the paired trunks:
    ``groups`` = their number), whose stacked pooled ``[sum B, c3]`` holds
    each stream's values bit for bit as its own call; bn2/bn3's running
    statistics take each stream's batch statistics (``B * N`` values),
    chained in stream order."""
    groups = len(xs)
    g, mu2, var2, mu3, var3 = trunk_train.trunk2_train(
        xs[0] if groups == 1 else torch.cat(xs),
        core.weight_in_out(module.conv2), module.conv2.bias,
        module.bn2.weight, module.bn2.bias, core.weight_in_out(module.conv3),
        module.conv3.bias, module.bn3.weight, module.bn3.bias, groups=groups)
    m = xs[0].shape[0] * xs[0].shape[1]
    for bn, mu, var in ((module.bn2, mu2, var2), (module.bn3, mu3, var3)):
        for i in range(groups):
            core.update_running(bn, mu.reshape(groups, -1)[i],
                                var.reshape(groups, -1)[i], m)
    return g


class STN3d(STNkd):
    """The input transform: ``STNkd`` with ``k = 3``."""

    def __init__(self, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(3, device, generator)
