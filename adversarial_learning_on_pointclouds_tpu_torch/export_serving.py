"""Export a trained model as a self-contained serving artifact
(``torch.export``; see ``utils/serving.py``).

The port of ``scripts/export_serving.py``: the artifact embeds the
weights, needs no model code at serving time, and is served by ``infer
--artifact`` (or ``utils.serving.load_exported``). Same flags as the JAX
script, except that ``--device`` (default ``cuda``) replaces ``--cpu``,
``--kernels`` replaces ``--pallas`` (a CUDA-only artifact holding the
three eval kernels' registered ops; it needs ``--platforms cuda``), the
platforms are ``cpu`` and ``cuda``, and ``--bf16`` traces bf16 matmul
operands (the JAX package's ``bf16=True``). ``--checkpoint`` is a
reference-format ``.pth`` or a checkpoint directory the port's trainers
wrote (its latest checkpoint; ``--model adv`` exports the generator).

    python -m adversarial_learning_on_pointclouds_tpu_torch.export_serving \\
        --model adv --checkpoint adv/ --out g.pt2 --verify
    python -m adversarial_learning_on_pointclouds_tpu_torch.export_serving \\
        --model cls --checkpoint cls.pth --out cls.pt2 --platforms cuda \\
        --kernels --bf16

``--verify`` loads the written artifact on ``--device`` and compares it
with the live model on a seeded batch: the largest scale-relative
difference of the log-probs (``max|a - b| / max(1, max|b|)``) must stay
within ``VERIFY_BOUND`` (fp32) or ``VERIFY_BOUND_BF16`` (bf16).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from adversarial_learning_on_pointclouds_tpu_torch import infer
from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.utils import serving

# The live model on the card runs the eval kernels (3xTF32 products) where
# a portable artifact runs their plain versions (cuBLAS in fp32): they
# agree within chip_smoke.py's serving bound, 1e-4 of the log-probs'
# scale. In bf16 both sides round the same operands, but where two fp32
# sums straddle a bf16 midpoint a hidden activation rounds one bf16 step
# apart, and at model level that moves log-probs by up to 1e-3 of their
# scale (chip_smoke.py's BF16_BOUND). On the CPU both sides run the same
# plain versions and agree within float rounding.
VERIFY_BOUND = 1e-4
VERIFY_BOUND_BF16 = 1e-3
VERIFY_BATCH = 4


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("cls", "seg", "adv"), required=True,
                   help="cls: classifier; seg: segmenter; adv: the "
                        "adversarial checkpoint's generator (a segmenter)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint dir (as written by training), or a "
                        "reference-format .pth state_dict")
    p.add_argument("--out", type=str, required=True,
                   help="artifact path to write (.pt2)")
    p.add_argument("--num_points", type=int, default=0,
                   help="serving point count (0 = the trainer default: "
                        f"{infer.CLS_POINTS} cls, {infer.SEG_POINTS} "
                        "seg/adv)")
    p.add_argument("--num_classes", type=int, default=40)
    p.add_argument("--num_parts", type=int, default=50)
    p.add_argument("--batch", type=int, default=0,
                   help="pin the batch dim (0 = symbolic: one artifact "
                        "serves every batch size)")
    p.add_argument("--platforms", type=str, default="cpu,cuda",
                   help="comma-separated devices the artifact serves on "
                        "(cpu, cuda)")
    p.add_argument("--kernels", action="store_true",
                   help="CUDA-only artifact with the hand-written eval "
                        "kernels as registered ops; requires --platforms "
                        "cuda")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 matmul operands with fp32 sums (default "
                        "fp32)")
    p.add_argument("--feature_transform", action="store_true")
    p.add_argument("--verify", action="store_true",
                   help="load the written artifact and compare it with "
                        "the live model on a seeded batch")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda or cpu: where the model is traced and "
                        "--verify runs")
    a = p.parse_args(argv)
    a.platforms = tuple(s.strip() for s in a.platforms.split(",")
                        if s.strip())
    if a.kernels and a.platforms != ("cuda",):
        p.error("--kernels pins the artifact to the CUDA-only registered "
                "ops: pass --platforms cuda")
    return a


def verify(path: str, model: torch.nn.Module, num_points: int,
           batch: Optional[int], bf16: bool, device: torch.device) -> float:
    """The largest scale-relative difference of the artifact at ``path``
    against the live ``model`` on a seeded batch; raise above the bound."""
    served = serving.load_exported(path, device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch or VERIFY_BATCH, num_points, 3)).astype(np.float32))
    got = served(x).double()
    with torch.inference_mode(), core.mixed_precision(enabled=bf16):
        want = model(x.to(device))[0].double()
    rel = ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()
    bound = VERIFY_BOUND_BF16 if bf16 else VERIFY_BOUND
    print(f"verify: max |artifact - live| / max(1, max|live|) = {rel:.3e} "
          f"(bound {bound:g})")
    if not rel <= bound:
        raise SystemExit(f"verify FAILED: {rel:.3e} above {bound:g}")
    return rel


def main(argv: Optional[Sequence[str]] = None) -> str:
    a = parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {a.device}: CUDA is not available "
                           "(pass --device cpu)")
    core.exact_fp32()
    cls = a.model == "cls"
    npts = a.num_points or (infer.CLS_POINTS if cls else infer.SEG_POINTS)
    model = infer.load_model(a.checkpoint, a.model, device, a.num_parts,
                             a.feature_transform, a.num_classes)
    export = serving.export_classifier if cls else serving.export_segmenter
    batch = a.batch or None
    exp = export(model, npts, batch, a.platforms, bf16=a.bf16,
                 kernels=a.kernels)
    serving.save_exported(exp, a.out)
    print(f"wrote {a.out} ({os.path.getsize(a.out) / 1e6:.1f} MB, "
          f"platforms={a.platforms}, batch="
          f"{'symbolic' if batch is None else batch}, N={npts}, "
          f"{'bf16' if a.bf16 else 'fp32'}, "
          f"{'kernels' if a.kernels else 'portable'})")
    if a.verify:
        verify(a.out, model, npts, batch, a.bf16, device)
    return a.out


if __name__ == "__main__":
    main()
