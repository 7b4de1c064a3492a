"""Adversarial semi-supervised segmentation (config 4), on the GPU.

The port of ``scripts/train_adversarial.py``: semi-supervised
segmentation with one G and one D update per step (``--lambda_adv
--lambda_semi --threshold --labeled_ratio --lr_D``, and the bench flags
``--bf16 --pallas_augment --paired_trunks --scan K``), run by
``train/runner.py::run_adversarial`` on the card, or with ``--cpu`` on
the CPU (the kernels' plain PyTorch versions).

    python -m adversarial_learning_on_pointclouds_tpu_torch.train_adversarial \\
        --nepoch 2 --bf16 --pallas_augment --paired_trunks --scan 8
"""

from __future__ import annotations

from typing import Optional, Sequence

from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    parse_adversarial_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist
from adversarial_learning_on_pointclouds_tpu_torch.train import runner


def main(argv: Optional[Sequence[str]] = None) -> dict:
    cfg, device = parse_adversarial_args(argv)
    ranks = dist.cli_ranks(__spec__.name if __spec__ else __name__,
                           argv, cfg.num_devices, device)
    if ranks is not None:
        return ranks[0]
    result = runner.run_adversarial(cfg, device=device)
    if dist.rank() == 0:
        print(f"final best instance mIoU: {result['best_miou']:.4f}")
    return result


if __name__ == "__main__":
    main()
