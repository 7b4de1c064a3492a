"""Train states and optimizer construction.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/train/
state.py`` (``TrainState``, ``GANTrainState``, ``make_optimizer`` and the gather
step forms of ``gather_step_fns``). The
optimizer is ``torch.optim.Adam`` (eps 1e-8) or SGD with momentum 0.9;
the learning-rate schedule is applied per optimizer step,
as the JAX package's optax schedules are: a staircase decay by
``lr_gamma`` every ``lr_step * steps_per_epoch`` steps (StepLR per epoch,
for whole epochs), or the poly decay ``lr * (1 - step / total) **
power``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """What ``make_optimizer`` returns: ``init(params)`` builds the torch
    optimizer and its per-step schedule (the role of optax's
    ``tx.init``). Two are equal when they build the same optimizer."""

    name: str
    lr: float
    beta1: float
    beta2: float
    momentum: float
    lr_schedule: str
    lr_step_epochs: int
    lr_gamma: float
    steps_per_epoch: int
    total_steps: int
    poly_power: float

    def factor(self, t: int) -> float:
        """The schedule as a factor of the base lr at optimizer step ``t``
        (0 for the first update)."""
        if self.lr_schedule == "poly" and self.total_steps > 0:
            done = min(t, self.total_steps) / self.total_steps
            return (1.0 - done) ** self.poly_power
        if (self.lr_schedule == "step" and self.lr_step_epochs > 0
                and self.steps_per_epoch > 0):
            return self.lr_gamma ** (t // (self.lr_step_epochs
                                           * self.steps_per_epoch))
        return 1.0

    def init(self, params: Iterable[torch.nn.Parameter]):
        if self.name == "sgd":
            opt = torch.optim.SGD(params, lr=self.lr, momentum=self.momentum)
        else:
            opt = torch.optim.Adam(params, lr=self.lr,
                                   betas=(self.beta1, self.beta2), eps=1e-8)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, self.factor)


def make_optimizer(lr: float, beta1: float, beta2: float,
                   lr_step_epochs: int, lr_gamma: float,
                   steps_per_epoch: int, *, optimizer: str = "adam",
                   lr_schedule: str = "step", total_steps: int = 0,
                   poly_power: float = 0.9, momentum: float = 0.9
                   ) -> Optimizer:
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return Optimizer(optimizer, lr, beta1, beta2, momentum, lr_schedule,
                     lr_step_epochs, lr_gamma, steps_per_epoch, total_steps,
                     poly_power)


@dataclasses.dataclass
class TrainState:
    """Single-network train state: the model (parameters and BatchNorm
    running statistics), the ``Optimizer`` it was built with, the torch
    optimizer and schedule that built, the augmentation's generator and
    the step count, on the host (``step``) and on the model's device
    (``device_step``, int64, what the step's device work reads).
    ``train_step`` updates it in place."""

    model: torch.nn.Module
    tx: Optimizer
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator
    step: int = 0
    device_step: Optional[torch.Tensor] = None


@dataclasses.dataclass
class GANTrainState:
    """Generator + discriminator train state (config 4): both models, the
    ``Optimizer`` each was built with, the torch optimizers and schedules
    those built, the augmentation's generator and the step count, on the
    host (``step``) and on the models' device (``device_step``, int64:
    the semi-supervised switch and the augmentation seeds read it there).
    ``adversarial.train_step`` updates it in place."""

    g_model: torch.nn.Module
    d_model: torch.nn.Module
    g_tx: Optimizer
    d_tx: Optimizer
    g_optimizer: torch.optim.Optimizer
    g_scheduler: torch.optim.lr_scheduler.LRScheduler
    d_optimizer: torch.optim.Optimizer
    d_scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator
    step: int = 0
    device_step: Optional[torch.Tensor] = None


def train_device(device) -> torch.device:
    """The device a train state is built on; a CUDA device raises when
    there is no card, rather than leaving the step on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: CUDA is not available (pass "
                           "device='cpu' to run the plain versions)")
    return device


def stack_metrics(seen: List[Dict[str, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
    """K steps' metric dicts -> each metric stacked over K (the shape a
    ``lax.scan`` of the JAX package's step returns)."""
    return {key: torch.stack([m[key] for m in seen]) for key in seen[0]}


def gather_step_fns(train_step: Callable):
    """``(train_step_gather, train_steps_scan_gather, train_steps_scan)``
    for a single-network trainer from its ``train_step(state, points,
    labels, *, cfg, tx)``, which updates the state in place and returns
    its metrics.

    The gather forms read device-resident data pools: the host sends
    only ``[B]`` (or ``[K, B]``) int32 index vectors and the rows are
    selected on the device with ``index_select`` (the reference
    Dataset's ``__getitem__``). ``train_steps_scan`` is the host-data
    K-step form on ``[K, B, ...]`` batches. Each K-step form is a loop of
    ``train_step`` calls, its metrics stacked over K; all forms give the
    step the same rows, so the same numbers."""

    def train_step_gather(state, pool_x, pool_y, idx, *, cfg, tx):
        return train_step(state, pool_x.index_select(0, idx),
                          pool_y.index_select(0, idx), cfg=cfg, tx=tx)

    def train_steps_scan_gather(state, pool_x, pool_y, idx, *, cfg, tx):
        return stack_metrics([
            train_step_gather(state, pool_x, pool_y, i, cfg=cfg, tx=tx)
            for i in idx])

    def train_steps_scan(state, xs, ys, *, cfg, tx):
        return stack_metrics([train_step(state, x, y, cfg=cfg, tx=tx)
                              for x, y in zip(xs, ys)])

    return train_step_gather, train_steps_scan_gather, train_steps_scan
