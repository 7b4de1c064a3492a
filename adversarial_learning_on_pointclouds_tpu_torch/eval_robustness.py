"""Robustness of a classifier under FGSM / PGD point perturbations, on
the GPU.

The port of ``scripts/eval_robustness.py``: the accuracy on the test
split under an attack at each of ``--epsilons`` (``--pgd_steps`` 0:
FGSM, else PGD with that many steps), the ragged last batch masked. The
checkpoint and the split are read as ``eval_classification`` reads them;
``eps=0`` reproduces its clean accuracy. The attack's forward runs the
plain versions (``ops.dispatch.differentiable_eval``), the clean and
attacked evals the serving kernels on the card.

    python -m adversarial_learning_on_pointclouds_tpu_torch.eval_robustness \\
        --model advp --epsilons 0 0.05 --pgd_steps 3
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from adversarial_learning_on_pointclouds_tpu_torch import eval as eval_lib
from adversarial_learning_on_pointclouds_tpu_torch.eval_classification import (
    add_eval_flags, load,
)


def main(argv: Optional[Sequence[str]] = None) -> Dict[float, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_eval_flags(p)
    p.add_argument("--epsilons", type=float, nargs="+",
                   default=[0.0, 0.01, 0.025, 0.05, 0.1])
    p.add_argument("--pgd_steps", type=int, default=0,
                   help="0 = single-step FGSM; >0 = PGD with that many steps")
    a = p.parse_args(argv)
    model, x_te, y_te, cfg = load(a)
    accs = eval_lib.evaluate_robustness(model, x_te, y_te, a.epsilons,
                                        cfg.batch_size, a.pgd_steps)
    kind = f"PGD-{a.pgd_steps}" if a.pgd_steps else "FGSM"
    for eps, acc in accs.items():
        print(f"eps={eps:<6g} {kind} accuracy: {acc:.4f}")
    return accs


if __name__ == "__main__":
    main()
