"""Config-3 trainer: ShapeNet-part segmentation, the training step.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/train/
segment.py`` (``create_state``, ``make_tx``, ``loss_fn``,
``train_step``): per-point NLL on the part classes plus the weighted
orthogonality regularizer of the feature transform, Adam with a StepLR
schedule per step. The model runs in train mode, so on a CUDA device its
forward and backward go through the training kernels (``trunk2_train``,
``relu_fc_bn_relu``, ``seg_head_train``) and on the CPU through their
plain versions. Under ``ops.dispatch.use_pallas_train()`` the step runs
the per-layer training kernels instead, as the JAX package's
``use_pallas(training=True)`` (``ops/dispatch.py`` says which where).

    cfg = SegmentConfig(); tx = make_tx(cfg, steps_per_epoch)
    state = create_state(cfg, steps_per_epoch, device="cuda")
    metrics = train_step(state, points, part_labels, cfg=cfg, tx=tx)

The gather forms (``train_step_gather``, ``train_steps_scan_gather``)
take the batches' rows from device-resident pools by index, and
``train_steps_scan`` takes K stacked host batches (``--scan K``), each a
loop of ``train_step`` (``state.gather_step_fns``). The eval forms
(``eval_step``, ``eval_scan``) run the model's eval forward, on a card
the three serving kernels (conv1, the three stacks, the seg head), with
the per-shape category-restricted IoU computed on the device.
``epoch_program`` runs a whole epoch, its steps and the eval scan, in
one call (``--fused_epoch``, ``state.epoch_program_fns``).

Under data parallelism (``parallel/dist.py``) ``train_step`` takes the
rank's rows of the global batch and returns the global metrics, its
gradients summed over the ranks before the optimizer step (as
``train/classify.py``); the eval forms take the global batch or plan
and return every rank's outputs.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from adversarial_learning_on_pointclouds_tpu_torch import losses
from adversarial_learning_on_pointclouds_tpu_torch.configs import SegmentConfig
from adversarial_learning_on_pointclouds_tpu_torch.data import augment
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetDenseCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    state as state_lib,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import metrics


def make_tx(cfg: SegmentConfig, steps_per_epoch: int) -> state_lib.Optimizer:
    return state_lib.make_optimizer(
        cfg.lr, cfg.beta1, cfg.beta2, cfg.lr_step, cfg.lr_gamma,
        steps_per_epoch, optimizer=cfg.optimizer,
        lr_schedule=cfg.lr_schedule,
        total_steps=cfg.epochs * steps_per_epoch,
        poly_power=cfg.poly_power)


def create_state(cfg: SegmentConfig, steps_per_epoch: int, device="cuda",
                 model: Optional[PointNetDenseCls] = None
                 ) -> state_lib.TrainState:
    """A train-mode segmenter seeded from ``cfg.seed`` (or ``model``), on
    ``device`` (the card unless the caller asks for the CPU), its
    optimizer and an augmentation generator on the device seeded from
    ``cfg.seed``."""
    device = state_lib.train_device(device)
    if model is None:
        model = PointNetDenseCls(
            cfg.num_parts, cfg.feature_transform, device=device,
            generator=torch.Generator().manual_seed(cfg.seed))
    else:
        model.to(device)
    model.train()
    dev = next(model.parameters()).device
    tx = make_tx(cfg, steps_per_epoch)
    optimizer, scheduler = tx.init(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    state_lib.replicate(model)
    return state_lib.TrainState(
        model, tx, optimizer, scheduler, gen,
        device_step=torch.zeros((), dtype=torch.int64, device=dev))


def loss_fn(model: PointNetDenseCls, points: torch.Tensor,
            part_labels: torch.Tensor, cfg: SegmentConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, acc)`` of the train-mode forward; the BatchNorm running
    statistics update in place."""
    logp, _, trans_feat = model(points)
    loss = losses.nll_loss(logp, part_labels)
    if cfg.feature_transform:
        loss = loss + losses.FT_REG_WEIGHT * losses.orthogonality_reg(
            trans_feat)
    acc = dist.mean_share((logp.argmax(-1) == part_labels).float())
    return loss, acc


def train_step(state: state_lib.TrainState, points: torch.Tensor,
               part_labels: torch.Tensor, *, cfg: SegmentConfig,
               tx: state_lib.Optimizer) -> Dict[str, torch.Tensor]:
    """One update on ``points [B, N', 3]`` and ``part_labels [B, N']`` on
    the model's device: the augmentation chain (labels ride the
    resample), the loss and its gradients, one optimizer step and one
    schedule step, under ``cfg.bf16``'s mixed-precision scope. Returns
    ``{"loss", "acc"}`` as device scalars; the gradients stay in
    ``.grad`` until the next step. ``tx`` is the ``make_tx`` the state
    was built with; the state's optimizer takes the step, so any other
    ``tx`` raises."""
    if tx != state.tx:
        raise ValueError(f"train_step got {tx}, but the state was built "
                         f"with {state.tx}")
    points, part_labels = augment.chain_from_cfg(
        state.generator, cfg, points, part_labels, state.device_step)
    with core.mixed_precision(enabled=cfg.bf16):
        state.optimizer.zero_grad(set_to_none=True)
        loss, acc = loss_fn(state.model, points, part_labels, cfg)
        loss.backward()
    metrics = dist.all_reduce_grads(state.model.parameters(),
                                    {"loss": loss.detach(), "acc": acc})
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    state.device_step += 1
    return metrics


# Device-resident-pool and K-step forms (see state_lib.gather_step_fns).
train_step_gather, train_steps_scan_gather, train_steps_scan = \
    state_lib.gather_step_fns(train_step)


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """``model`` in eval mode under ``torch.inference_mode`` for the block,
    its train/eval mode restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield model
    finally:
        model.train(was_training)


def eval_step(model: PointNetDenseCls, points: torch.Tensor,
              part_labels: torch.Tensor, categories: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Eval forward + on-device per-shape IoU (category-restricted) of one
    batch on the model's device: ``pred [B, N]``, ``ious [B]`` and
    ``correct`` (the batch's correctly labeled points). Under data
    parallelism each rank runs its rows and returns the whole batch's."""
    points, part_labels, categories = (
        dist.shard_rows(t) for t in (points, part_labels, categories))
    with eval_mode(model):
        pred = model(points)[0].argmax(-1)
        ious = metrics.shape_ious_device(pred, part_labels, categories)
        correct = (pred == part_labels).sum()
        return {"pred": dist.gather_axis(pred),
                "ious": dist.gather_axis(ious),
                "correct": dist.all_reduce_(correct, "sum", "eval")}


def check_plan(idx, pool_x: torch.Tensor) -> None:
    """An eval plan must be an index tensor on the pools' device: the
    eval scans copy nothing from the host."""
    if not isinstance(idx, torch.Tensor) or idx.device != pool_x.device:
        raise TypeError(f"the eval plan must be an index tensor on "
                        f"{pool_x.device} (data.loader.to_device), got "
                        f"{type(idx).__name__}"
                        + (f" on {idx.device}"
                           if isinstance(idx, torch.Tensor) else ""))


def eval_scan(model: PointNetDenseCls, pool_x: torch.Tensor,
              pool_y: torch.Tensor, pool_c: torch.Tensor, idx: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """The whole test pass over the ``idx [S, B]`` rows (an index tensor
    on the pools' device) of device-resident pools, in eval mode (the JAX
    package's one-launch test pass, here a loop of eval forwards): per
    batch the rows are gathered on the device, the eval forward runs and
    the per-shape correct-point counts and IoUs stay on the device.
    Returns ``{"correct": [S, B], "ious": [S, B]}``, for one readback per
    pass; every metric of the protocol (instance mIoU, point accuracy,
    the per-category table) derives from them. Nothing is copied from or
    read back to the host. Under data parallelism each rank runs its
    columns of the plan and returns every rank's outputs."""
    check_plan(idx, pool_x)
    correct, ious = [], []
    with eval_mode(model):
        for ib in dist.shard_rows(idx, dim=1):
            x = pool_x.index_select(0, ib)
            y = pool_y.index_select(0, ib)
            c = pool_c.index_select(0, ib)
            pred = model(x)[0].argmax(-1)
            correct.append((pred == y).sum(-1))
            ious.append(metrics.shape_ious_device(pred, y, c))
        return {"correct": dist.gather_axis(torch.stack(correct), dim=1),
                "ious": dist.gather_axis(torch.stack(ious), dim=1)}


# The whole epoch in one call (--fused_epoch; state_lib.epoch_program_fns).
epoch_program = state_lib.epoch_program_fns(train_step, eval_scan)
