"""Evaluate a classifier on ModelNet40, on the GPU.

The port of ``scripts/eval_classification.py``: loads a checkpoint (a
directory written by the port's classification or perturbation trainer,
or a reference-format ``PointNetCls`` ``.pth``) and reports overall and
average per-class accuracy. The card runs the serving kernels, ``--cpu``
their plain PyTorch versions. The class count and whether the model has
the feature transform are read from the checkpoint (the JAX script
builds the model from ``--feature_transform``). The test split is
prepared as the trainers prepare it, so at a run's ``--num_points``
(default 1024) this reproduces the run's last eval.

    python -m adversarial_learning_on_pointclouds_tpu_torch.eval_classification \\
        --model cls
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from adversarial_learning_on_pointclouds_tpu_torch import eval as eval_lib
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    ClassifyConfig, add_cpu_flag, device_from_args,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import runner
from adversarial_learning_on_pointclouds_tpu_torch.utils import checkpoint


def add_eval_flags(p: argparse.ArgumentParser) -> None:
    """The flags the classifier's eval CLIs share (the JAX scripts')."""
    p.add_argument("--model", type=str, required=True,
                   help="checkpoint dir (as written by training) or a "
                        "reference-format .pth state_dict")
    p.add_argument("--dataset", type=str, default="")
    p.add_argument("--split", type=str, default="test",
                   choices=("test", "val", "train"),
                   help="which split to evaluate (the split's "
                        "{split}_files.txt must exist)")
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--num_points", type=int, default=1024)
    add_cpu_flag(p)


def load(a: argparse.Namespace):
    """``(model, x_te, y_te, cfg)`` of parsed eval flags: the saved
    classifier on the flags' device, the split prepared as the trainers
    prepare it."""
    model = checkpoint.load_saved_classifier(a.model,
                                             device=device_from_args(a))
    cfg = ClassifyConfig(batch_size=a.batchSize, num_points=a.num_points,
                         dataset=a.dataset, num_classes=model.k)
    _, _, x_te, y_te = runner._modelnet_arrays(cfg, eval_split=a.split)
    return model, x_te, y_te, cfg


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_eval_flags(p)
    model, x_te, y_te, cfg = load(p.parse_args(argv))
    ev = eval_lib.evaluate_classifier(model, x_te, y_te, cfg.batch_size,
                                      cfg.num_classes)
    print(f"accuracy: {ev['accuracy']:.4f}")
    print(f"avg class accuracy: {ev['avg_class_accuracy']:.4f}")
    return ev


if __name__ == "__main__":
    main()
