"""Configs 1-2 trainer: ModelNet40 classification, the training step.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/train/
classify.py`` (``create_state``, ``make_tx``, ``loss_fn``,
``train_step``, ``eval_step``, ``eval_scan``): NLL plus, under
``feature_transform``, 0.001 times the orthogonality regularizer of the
feature transform, Adam with a StepLR schedule per step. The model runs
in train mode, so on a CUDA device its forward and backward go through
the training kernels (``trunk2_train`` per trunk, ``relu_fc_bn_relu``
per T-Net head) and on the CPU through their plain versions.

    cfg = ClassifyConfig(); tx = make_tx(cfg, steps_per_epoch)
    state = create_state(cfg, steps_per_epoch, device="cuda")
    metrics = train_step(state, points, labels, cfg=cfg, tx=tx)

The dropout between fc2 and bn2 draws its mask from the state's
generator, after the augmentation chain, so a run restored from a full
checkpoint repeats the original bit for bit. The gather forms
(``train_step_gather``, ``train_steps_scan_gather``) take the batches'
rows from device-resident pools by index, and ``train_steps_scan``
takes K stacked host batches (``--scan K``), each a loop of
``train_step`` (``state.gather_step_fns``). The eval forms
(``eval_step``, ``eval_scan``) run the model's eval forward, on a card
the encoder's serving kernels. ``epoch_program`` runs a whole epoch,
its steps and the eval scan, in one call (``--fused_epoch``,
``state.epoch_program_fns``).

Under data parallelism (``parallel/dist.py``) ``train_step`` takes the
rank's rows of the global batch: the loss and ``acc`` are the rank's
shares of the global ones, the gradients and the metrics are summed over
the ranks in one bucket before the optimizer step, so every rank takes
the same update and returns the global metrics. The eval forms take the
global batch or plan, run the rank's rows and return every rank's
outputs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from adversarial_learning_on_pointclouds_tpu_torch import losses
from adversarial_learning_on_pointclouds_tpu_torch.configs import ClassifyConfig
from adversarial_learning_on_pointclouds_tpu_torch.data import augment
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    state as state_lib,
)
from adversarial_learning_on_pointclouds_tpu_torch.train.segment import (
    check_plan, eval_mode,
)


def make_tx(cfg: ClassifyConfig, steps_per_epoch: int) -> state_lib.Optimizer:
    return state_lib.make_optimizer(
        cfg.lr, cfg.beta1, cfg.beta2, cfg.lr_step, cfg.lr_gamma,
        steps_per_epoch, optimizer=cfg.optimizer,
        lr_schedule=cfg.lr_schedule,
        total_steps=cfg.epochs * steps_per_epoch,
        poly_power=cfg.poly_power)


def create_state(cfg: ClassifyConfig, steps_per_epoch: int, device="cuda",
                 model: Optional[PointNetCls] = None
                 ) -> state_lib.TrainState:
    """A train-mode classifier seeded from ``cfg.seed`` (or ``model``, its
    dropout rate set to ``cfg.dropout``), on ``device`` (the card unless
    the caller asks for the CPU), its optimizer and a generator on the
    device seeded from ``cfg.seed`` for the augmentation and the
    dropout."""
    device = state_lib.train_device(device)
    if model is None:
        model = PointNetCls(
            cfg.num_classes, cfg.feature_transform, cfg.dropout,
            device=device, generator=torch.Generator().manual_seed(cfg.seed))
    else:
        model.dropout = cfg.dropout
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


def loss_fn(model: PointNetCls, points: torch.Tensor, labels: torch.Tensor,
            cfg: ClassifyConfig,
            dropout_gen: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, acc)`` of the train-mode forward (the dropout mask drawn
    from ``dropout_gen``); the BatchNorm running statistics update in
    place."""
    logp, _, trans_feat = model(points, dropout_gen)
    loss = losses.nll_loss(logp, labels)
    if cfg.feature_transform:
        loss = loss + losses.FT_REG_WEIGHT * losses.orthogonality_reg(
            trans_feat)
    acc = dist.mean_share((logp.argmax(-1) == labels).float())
    return loss, acc


def update(state: state_lib.TrainState, points: torch.Tensor,
           labels: torch.Tensor, cfg: ClassifyConfig
           ) -> Dict[str, torch.Tensor]:
    """The supervised update on prepared ``points``: the loss and its
    gradients under ``cfg.bf16``'s mixed-precision scope, one optimizer
    step and one schedule step, the step counts advanced; at world size
    above 1 the gradients and metrics summed over the ranks first
    (``dist.all_reduce_grads``). Shared with the perturbation trainer
    (``train/adv_perturb.py``)."""
    with core.mixed_precision(enabled=cfg.bf16):
        state.optimizer.zero_grad(set_to_none=True)
        loss, acc = loss_fn(state.model, points, labels, cfg,
                            state.generator)
        loss.backward()
    metrics = dist.all_reduce_grads(state.model.parameters(),
                                    {"loss": loss.detach(), "acc": acc})
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    state.device_step += 1
    return metrics


def check_tx(state: state_lib.TrainState, tx: state_lib.Optimizer) -> None:
    """The state's optimizer takes the step, so a ``tx`` other than the
    one the state was built with raises."""
    if tx != state.tx:
        raise ValueError(f"train_step got {tx}, but the state was built "
                         f"with {state.tx}")


def train_step(state: state_lib.TrainState, points: torch.Tensor,
               labels: torch.Tensor, *, cfg: ClassifyConfig,
               tx: state_lib.Optimizer) -> Dict[str, torch.Tensor]:
    """One update on ``points [B, N', 3]`` and ``labels [B]`` on the
    model's device: the augmentation chain (resampled to
    ``cfg.num_points`` on the device), then ``update``. Returns ``{"loss",
    "acc"}`` as device scalars; the gradients stay in ``.grad`` until the
    next step."""
    check_tx(state, tx)
    points = augment.chain_from_cfg(state.generator, cfg, points,
                                    step=state.device_step)
    return update(state, points, labels, cfg)


# Device-resident-pool and K-step forms (see state_lib.gather_step_fns).
train_step_gather, train_steps_scan_gather, train_steps_scan = \
    state_lib.gather_step_fns(train_step)


def eval_step(model: PointNetCls, points: torch.Tensor, labels: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Eval-mode forward (BN running statistics, no dropout) of one batch
    on the model's device: ``log_probs [B, k]``, ``pred [B]`` and
    ``correct`` (the batch's correctly classified clouds). Under data
    parallelism each rank runs its rows and returns the whole batch's."""
    with eval_mode(model):
        logp = model(dist.shard_rows(points))[0]
        pred = logp.argmax(-1)
        correct = (pred == dist.shard_rows(labels)).sum()
        return {"log_probs": dist.gather_axis(logp),
                "pred": dist.gather_axis(pred),
                "correct": dist.all_reduce_(correct, "sum", "eval")}


def eval_scan(model: PointNetCls, pool_x: torch.Tensor, idx: torch.Tensor
              ) -> torch.Tensor:
    """The whole test pass over the ``idx [S, B]`` rows (an index tensor
    on the pool's device) of a device-resident pool, in eval mode (the
    JAX package's one-launch scan, here a loop of eval forwards): the
    predicted class ids ``[S, B]``, on the device, for one readback per
    pass. Nothing is copied from or read back to the host. Under data
    parallelism each rank runs its columns of the plan and returns every
    rank's predictions."""
    check_plan(idx, pool_x)
    with eval_mode(model):
        preds = torch.stack([model(pool_x.index_select(0, ib))[0].argmax(-1)
                             for ib in dist.shard_rows(idx, dim=1)])
        return dist.gather_axis(preds, dim=1)


# The whole epoch in one call (--fused_epoch; state_lib.epoch_program_fns).
epoch_program = state_lib.epoch_program_fns(train_step, eval_scan)
