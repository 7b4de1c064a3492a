"""Train the part segmenter (config 3) on ShapeNet-part, on the GPU.

The port of ``scripts/train_segmentation.py``: the same flags (the
reference's ``train_segmentation.py`` names: ``--batchSize``,
``--nepoch``, ``--outf``, ``--model``, ``--dataset``, ...), run by
``train/runner.py::run_segmentation`` on the card, or with ``--cpu`` on
the CPU (the kernels' plain PyTorch versions). Without ``--dataset`` it
trains on a synthetic pts-layout fixture.

    python -m adversarial_learning_on_pointclouds_tpu_torch.train_segmentation \\
        --nepoch 2 --batchSize 32 --outf seg
"""

from __future__ import annotations

from typing import Optional, Sequence

from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    parse_segment_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist
from adversarial_learning_on_pointclouds_tpu_torch.train import runner


def main(argv: Optional[Sequence[str]] = None) -> dict:
    cfg, device = parse_segment_args(argv)
    ranks = dist.cli_ranks(__spec__.name if __spec__ else __name__,
                           argv, cfg.num_devices, device)
    if ranks is not None:
        return ranks[0]
    result = runner.run_segmentation(cfg, device=device)
    if dist.rank() == 0:
        print(f"final best instance mIoU: {result['best_miou']:.4f}")
        for cat, miou in sorted(result["category_miou"].items()):
            print(f"  {cat:12s} {miou:.4f}")
    return result


if __name__ == "__main__":
    main()
