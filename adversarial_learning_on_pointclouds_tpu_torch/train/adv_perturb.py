"""Config 5: FGSM adversarial-perturbation training, the training step.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/train/
adv_perturb.py``: per batch, the augmentation chain, then an FGSM (or,
with ``cfg.attack == "pgd"`` and ``cfg.attack_steps > 1``, PGD) attack
on the input coordinates, then the classifier's supervised update
(``classify.update``, ``classify.loss_fn``) on the perturbed clouds: two
forwards and two backwards, like the reference.

The attack (``attacks.attack``) runs the model in eval mode, as the
reference's ``model.eval()`` during attack generation: the BatchNorm
running statistics are read, not updated, and the model's train mode is
restored after. It runs under ``ops.dispatch.use_kernels(False)``, so
no eval kernel launches in it, and in ``cfg.bf16``'s mixed-precision
scope, as the JAX package's attack (bf16 matmul operands under
``--bf16``). The update then launches the
classifier's training kernels as ``classify.train_step`` does.
``epoch_program`` runs a whole epoch, its steps and the classifier's eval
scan, in one call (``--fused_epoch``). Under data parallelism each rank
attacks its own rows (the attack is per cloud and calls no collective)
and the update sums the ranks' gradients (``classify.update``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from adversarial_learning_on_pointclouds_tpu_torch import attacks
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdvPerturbConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.data import augment
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    classify, state as state_lib,
)


def create_state(cfg: AdvPerturbConfig, steps_per_epoch: int, device="cuda",
                 model: Optional[PointNetCls] = None
                 ) -> state_lib.TrainState:
    return classify.create_state(cfg, steps_per_epoch, device, model)


def make_tx(cfg: AdvPerturbConfig, steps_per_epoch: int
            ) -> state_lib.Optimizer:
    return classify.make_tx(cfg, steps_per_epoch)


def attack_steps(cfg: AdvPerturbConfig) -> int:
    """``attacks.attack``'s ``steps`` for ``cfg``: PGD's iterations, or 0
    (FGSM). PGD at one step is FGSM (alpha = eps, the projection a
    no-op), so it takes FGSM's single-gradient path, as the JAX
    package's does."""
    return cfg.attack_steps if cfg.attack == "pgd" and \
        cfg.attack_steps > 1 else 0


def train_step(state: state_lib.TrainState, points: torch.Tensor,
               labels: torch.Tensor, *, cfg: AdvPerturbConfig,
               tx: state_lib.Optimizer) -> Dict[str, torch.Tensor]:
    """Augmentation chain -> attack -> supervised update on the perturbed
    batch, in place; returns ``{"loss", "acc"}`` as device scalars."""
    classify.check_tx(state, tx)
    points = augment.chain_from_cfg(state.generator, cfg, points,
                                    step=state.device_step)
    with core.mixed_precision(enabled=cfg.bf16):
        x_adv = attacks.attack(state.model, points, labels, cfg.epsilon,
                               attack_steps(cfg))
    return classify.update(state, x_adv, labels, cfg)


# Device-resident-pool and K-step forms (see state_lib.gather_step_fns).
train_step_gather, train_steps_scan_gather, train_steps_scan = \
    state_lib.gather_step_fns(train_step)

# The whole epoch in one call (--fused_epoch; state_lib.epoch_program_fns),
# evaluated by the classifier's eval scan.
epoch_program = state_lib.epoch_program_fns(train_step, classify.eval_scan)
