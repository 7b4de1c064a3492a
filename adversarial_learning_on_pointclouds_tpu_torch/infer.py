"""Classification and part-segmentation inference over a point-cloud
file, on the GPU.

The port of ``scripts/infer.py``. ``--checkpoint`` loads a live model: a
reference-format ``.pth`` or a checkpoint directory the port's trainers
wrote (its latest checkpoint; the generator of an adversarial run)
predicts a class per cloud (``--model cls``, a ``PointNetCls``, 1024
points by default) or a part label per point (``--model seg|adv``, a
segmenter or an adversarial run's generator, 2500 points by default).
``--artifact`` serves a serving artifact of ``export_serving``
(``utils/serving.py``) instead: its point count and batch are the
artifact's (a pinned batch pads the ragged tail), and its kind comes from
its output's rank (``[b, k]``: cls, ``[b, N, k]``: seg) unless ``--kind``
says otherwise. Same flags as the JAX script, except that ``--device``
(default ``cuda``) replaces ``--cpu`` and there is no ``--no_pallas``: a
CUDA device runs the hand-written kernels, the CPU their plain PyTorch
versions (a kernels artifact serves on CUDA alone).

Inputs: a ModelNet-style ``.h5`` (``data`` dataset, ``[S, N, 3]``), a
ShapeNet-style ``.pts`` (whitespace xyz rows, one shape) or an ascii
``.ply`` written by ``utils/ply.py``. Each cloud is unit-sphere
normalized and resampled to the model's point count on the host, with
the same seeded numpy draw as the JAX script.

    python -m adversarial_learning_on_pointclouds_tpu_torch.infer \\
        --checkpoint g.pth --model adv --feature_transform --input shape.pts
    python -m adversarial_learning_on_pointclouds_tpu_torch.infer \\
        --checkpoint cls.pth --model cls --input clouds.h5
    python -m adversarial_learning_on_pointclouds_tpu_torch.infer \\
        --artifact g.pt2 --input shape.pts --ply out.ply
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
from adversarial_learning_on_pointclouds_tpu_torch.utils import (
    checkpoint, serving,
)
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


def load_model(checkpoint_path: str, model: str, device: torch.device,
               num_parts: int = 50, feature_transform: bool = False,
               num_classes: int = 40) -> torch.nn.Module:
    """The eval model of ``checkpoint_path`` on ``device``: a reference
    ``.pth`` of the widths the flags give, or the latest checkpoint of a
    directory the port's trainers wrote (field ``g_model`` of an
    adversarial run, ``model`` of the others; the widths read from the
    saved tensors)."""
    pth = checkpoint_path.endswith(".pth")
    if model == "cls":
        if pth:
            return checkpoint.load_classifier(
                checkpoint_path, num_classes, feature_transform, device)
        return checkpoint.load_saved_classifier(checkpoint_path, "model",
                                                device)
    if pth:
        return checkpoint.load_segmenter(checkpoint_path, num_parts,
                                         feature_transform, device)
    return checkpoint.load_saved_segmenter(
        checkpoint_path, "g_model" if model == "adv" else "model", device)


def predict_batches(fwd, clouds: np.ndarray, batch: int,
                    pinned: Optional[int] = None) -> np.ndarray:
    """``fwd`` over ``clouds [S, N, 3]`` in batches of ``batch`` clouds ->
    log-probabilities on the host; with a pinned batch (``pinned``, a
    pinned-batch artifact's) the ragged tail is padded with zero clouds
    and their outputs dropped."""
    out = []
    step = pinned or batch
    for s in range(0, len(clouds), step):
        chunk = clouds[s:s + step]
        real = len(chunk)
        if pinned and real < pinned:
            chunk = np.concatenate([chunk, np.zeros(
                (pinned - real,) + chunk.shape[1:], np.float32)])
        out.append(fwd(chunk)[:real].cpu().numpy())
    return np.concatenate(out, axis=0)


class Predictor:
    """A loaded model on one device: ``predict`` maps prepared clouds
    ``[S, N, 3]`` to log-probabilities, ``[S, k]`` per cloud of a
    classifier (``model="cls"``), ``[S, N, k]`` per point of a segmenter
    (``"seg"``, ``"adv"``), ``batch`` clouds per forward.
    ``checkpoint_path`` is a reference ``.pth`` or a trainer's checkpoint
    directory (``load_model``)."""

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
        self.model = load_model(checkpoint_path, model, self.device,
                                num_parts, feature_transform, num_classes)

    @torch.inference_mode()
    def predict(self, clouds: np.ndarray) -> np.ndarray:
        clouds = np.ascontiguousarray(clouds, dtype=np.float32)
        if clouds.ndim != 3 or clouds.shape[1:] != (self.num_points, 3):
            raise ValueError(f"clouds must be [S, {self.num_points}, 3], "
                             f"got {clouds.shape}")
        return predict_batches(
            lambda c: self.model(torch.from_numpy(c).to(self.device))[0],
            clouds, self.batch)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", type=str, required=True,
                   help=".h5 ([S,N,3] 'data'), .pts (one shape), or .ply")
    p.add_argument("--artifact", type=str, default="",
                   help="serving artifact from export_serving")
    p.add_argument("--kind", choices=("cls", "seg"), default="",
                   help="artifact output kind; default: derived from the "
                        "artifact's output rank (cls: [B,k]; seg: [B,N,k])")
    p.add_argument("--checkpoint", type=str, default="",
                   help="checkpoint dir (as written by the trainers), or a "
                        "reference-format .pth state_dict (alternative to "
                        "--artifact)")
    p.add_argument("--model", choices=("cls", "seg", "adv"), default="cls")
    p.add_argument("--num_points", type=int, default=0,
                   help=f"0 = the artifact's, or the model's default: "
                        f"{CLS_POINTS} (cls), {SEG_POINTS} (seg, adv)")
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
    if not a.artifact and not a.checkpoint:
        p.error("need --artifact or --checkpoint")
    return a


def main(argv: Optional[Sequence[str]] = None) -> None:
    a = parse_args(argv)
    if a.artifact:
        served = serving.load_exported(a.artifact, a.device)
        if a.num_points and a.num_points != served.num_points:
            # The artifact's point count is static: fail before reading
            # the input, not with a shape error from inside the program.
            raise SystemExit(
                f"--num_points {a.num_points} does not match the artifact's "
                f"exported point count {served.num_points} (drop "
                "--num_points, or re-export at the desired N)")
        kind = a.kind or served.kind
        clouds = prep(load_clouds(a.input), served.num_points)
        logp = predict_batches(served, clouds, a.batch, served.batch)
    else:
        kind = "cls" if a.model == "cls" else "seg"
        npts = a.num_points or (CLS_POINTS if kind == "cls" else SEG_POINTS)
        predictor = Predictor(a.checkpoint, a.model, npts, a.device,
                              num_parts=a.num_parts,
                              feature_transform=a.feature_transform,
                              batch=a.batch, num_classes=a.num_classes)
        clouds = prep(load_clouds(a.input), npts)
        logp = predictor.predict(clouds)
    pred = np.argmax(logp, axis=-1)
    if kind == "cls":
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
