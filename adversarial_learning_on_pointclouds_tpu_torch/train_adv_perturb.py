"""Train the classifier with FGSM perturbations (config 5), on the GPU.

The port of ``scripts/train_adv_perturb.py``: the classifier trainer's
flags plus ``--epsilon``, ``--attack {fgsm,pgd}`` and
``--attack_steps``, run by ``train/runner.py::run_adv_perturb`` on the
card, or with ``--cpu`` on the CPU (the kernels' plain PyTorch
versions). Each step attacks the batch in eval mode, then updates on the
perturbed clouds. ``--num_devices W`` spawns W data-parallel ranks,
each attacking its own rows.

    python -m adversarial_learning_on_pointclouds_tpu_torch.train_adv_perturb \\
        --nepoch 2 --epsilon 0.05 --outf advp
"""

from __future__ import annotations

from typing import Optional, Sequence

from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    parse_adv_perturb_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist
from adversarial_learning_on_pointclouds_tpu_torch.train import runner


def main(argv: Optional[Sequence[str]] = None) -> dict:
    cfg, device = parse_adv_perturb_args(argv)
    ranks = dist.cli_ranks(__spec__.name if __spec__ else __name__,
                           argv, cfg.num_devices, device)
    if ranks is not None:
        return ranks[0]
    result = runner.run_adv_perturb(cfg, device=device)
    if dist.rank() == 0:
        print(f"final best accuracy: {result['best_accuracy']:.4f}")
    return result


if __name__ == "__main__":
    main()
