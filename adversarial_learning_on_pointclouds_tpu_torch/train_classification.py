"""Train the PointNet classifier (configs 1 and 2) on ModelNet40, on the
GPU.

The port of ``scripts/train_classification.py``: the same flags (the
reference's ``train_classification.py`` names: ``--batchSize``,
``--num_points``, ``--nepoch``, ``--outf``, ``--model``, ``--dataset``,
``--feature_transform``, ...), run by ``train/runner.py::
run_classification`` on the card, or with ``--cpu`` on the CPU (the
kernels' plain PyTorch versions). Without ``--dataset`` it trains on the
synthetic fixture, made in memory. Config 2 is ``--feature_transform
--augment``.

    python -m adversarial_learning_on_pointclouds_tpu_torch.train_classification \\
        --nepoch 2 --batchSize 32 --outf cls
"""

from __future__ import annotations

from typing import Optional, Sequence

from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    parse_classify_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import runner


def main(argv: Optional[Sequence[str]] = None) -> dict:
    cfg, device = parse_classify_args(argv)
    result = runner.run_classification(cfg, device=device)
    print(f"final best accuracy: {result['best_accuracy']:.4f}")
    return result


if __name__ == "__main__":
    main()
