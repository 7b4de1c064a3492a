"""Classification and part-segmentation inference over a point-cloud
file, on the GPU.

The port of ``scripts/infer.py``'s ``--checkpoint`` route: a
reference-format ``.pth`` predicts a class per cloud (``--model cls``, a
``PointNetCls``, 1024 points by default) or a part label per point
(``--model seg|adv``, a segmenter or an adversarial run's generator,
2500 points by default). Same flags
as the JAX script, except that ``--device`` (default ``cuda``) replaces
``--cpu`` and there is no ``--no_pallas``: a CUDA device runs the
hand-written kernels, the CPU their plain PyTorch versions.

Inputs: a ModelNet-style ``.h5`` (``data`` dataset, ``[S, N, 3]``), a
ShapeNet-style ``.pts`` (whitespace xyz rows, one shape) or an ascii
``.ply`` written by ``utils/ply.py``. Each cloud is unit-sphere
normalized and resampled to the model's point count on the host, with
the same seeded numpy draw as the JAX script.

    python -m adversarial_learning_on_pointclouds_tpu_torch.infer \\
        --checkpoint g.pth --model adv --feature_transform --input shape.pts
    python -m adversarial_learning_on_pointclouds_tpu_torch.infer \\
        --checkpoint cls.pth --model cls --input clouds.h5
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from adversarial_learning_on_pointclouds_tpu_torch.data.augment import (
    normalize_unit_sphere_np,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.utils import checkpoint
from adversarial_learning_on_pointclouds_tpu_torch.utils.ply import (
    read_ply, write_ply_with_labels,
)

SEG_POINTS = 2500  # the seg default of scripts/infer.py
CLS_POINTS = 1024  # the cls default of scripts/infer.py


def load_clouds(path: str) -> np.ndarray:
    """-> ``[S, ?, 3]`` float32 (an ``.h5`` may hold many shapes)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".h5", ".hdf5"):
        import h5py  # only .h5 input needs it

        with h5py.File(path, "r") as f:
            return np.asarray(f["data"][:], np.float32)
    if ext == ".ply":
        return read_ply(path)[None]
    return np.loadtxt(path, dtype=np.float32).reshape(1, -1, 3)


def prep(clouds: np.ndarray, num_points: int, seed: int = 0) -> np.ndarray:
    """Unit-sphere normalize and resample each cloud to ``num_points``
    (with replacement, one seeded numpy stream for all clouds)."""
    rng = np.random.default_rng(seed)
    out = np.empty((len(clouds), num_points, 3), np.float32)
    for i, pts in enumerate(clouds):
        idx = rng.choice(len(pts), num_points, replace=True)
        out[i] = normalize_unit_sphere_np(pts)[idx]
    return out


class Predictor:
    """A loaded model on one device: ``predict`` maps prepared clouds
    ``[S, N, 3]`` to log-probabilities, ``[S, k]`` per cloud of a
    classifier (``model="cls"``), ``[S, N, k]`` per point of a segmenter
    (``"seg"``, ``"adv"``), ``batch`` clouds per forward."""

    def __init__(self, checkpoint_path: str, model: str = "seg",
                 num_points: int = SEG_POINTS, device: str = "cuda",
                 num_parts: int = 50, feature_transform: bool = False,
                 batch: int = 32, num_classes: int = 40):
        if model not in ("cls", "seg", "adv"):
            raise ValueError(f"unknown model {model!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: CUDA is not available "
                               "(pass --device cpu to run the plain versions)")
        if batch < 1:
            raise ValueError(f"--batch must be positive, got {batch}")
        core.exact_fp32()
        self.num_points = num_points
        self.batch = batch
        if model == "cls":
            self.model = checkpoint.load_classifier(
                checkpoint_path, num_classes, feature_transform, self.device)
        else:
            self.model = checkpoint.load_segmenter(
                checkpoint_path, num_parts, feature_transform, self.device)

    @torch.inference_mode()
    def predict(self, clouds: np.ndarray) -> np.ndarray:
        clouds = np.ascontiguousarray(clouds, dtype=np.float32)
        if clouds.ndim != 3 or clouds.shape[1:] != (self.num_points, 3):
            raise ValueError(f"clouds must be [S, {self.num_points}, 3], "
                             f"got {clouds.shape}")
        out = []
        for s in range(0, len(clouds), self.batch):
            x = torch.from_numpy(clouds[s:s + self.batch]).to(self.device)
            out.append(self.model(x)[0].cpu().numpy())
        return np.concatenate(out, axis=0)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", type=str, required=True,
                   help=".h5 ([S,N,3] 'data'), .pts (one shape), or .ply")
    p.add_argument("--artifact", type=str, default="",
                   help="serving artifact (not ported yet)")
    p.add_argument("--kind", choices=("cls", "seg"), default="",
                   help="artifact output kind (with --artifact)")
    p.add_argument("--checkpoint", type=str, default="",
                   help="reference-format .pth state_dict")
    p.add_argument("--model", choices=("cls", "seg", "adv"), default="cls")
    p.add_argument("--num_points", type=int, default=0,
                   help=f"0 = the model's default: {CLS_POINTS} (cls), "
                        f"{SEG_POINTS} (seg, adv)")
    p.add_argument("--num_classes", type=int, default=40)
    p.add_argument("--num_parts", type=int, default=50)
    p.add_argument("--feature_transform", action="store_true")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--ply", type=str, default="",
                   help="write the FIRST cloud's part labels as a colored "
                        ".ply (seg, adv)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    a = p.parse_args(argv)
    if a.artifact:
        raise NotImplementedError(
            "--artifact: serving artifacts are still to come (ROADMAP, "
            "Queue 1, 'Serving and tooling')")
    if not a.checkpoint:
        p.error("need --checkpoint")
    if not a.checkpoint.endswith(".pth"):
        p.error("the port loads reference-format .pth checkpoints; export "
                "a JAX checkpoint with scripts/export_pth.py")
    return a


def main(argv: Optional[Sequence[str]] = None) -> None:
    a = parse_args(argv)
    npts = a.num_points or (CLS_POINTS if a.model == "cls" else SEG_POINTS)
    predictor = Predictor(a.checkpoint, a.model, npts, a.device,
                          num_parts=a.num_parts,
                          feature_transform=a.feature_transform,
                          batch=a.batch, num_classes=a.num_classes)
    clouds = prep(load_clouds(a.input), npts)
    pred = np.argmax(predictor.predict(clouds), axis=-1)
    if a.model == "cls":
        for i, c in enumerate(pred):
            print(f"cloud {i}: class {int(c)}")
        return
    for i, lab in enumerate(pred):
        uniq, cnt = np.unique(lab, return_counts=True)
        top = ", ".join(f"{int(u)}×{int(c)}" for u, c in
                        zip(uniq[np.argsort(-cnt)][:4],
                            np.sort(cnt)[::-1][:4]))
        print(f"cloud {i}: parts {{{top}}}")
    if a.ply:
        write_ply_with_labels(a.ply, clouds[0], pred[0])
        print(f"wrote {a.ply}")


if __name__ == "__main__":
    main()
