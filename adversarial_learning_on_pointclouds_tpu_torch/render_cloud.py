"""Render point clouds to PNG (headless matplotlib).

The port of ``scripts/render_cloud.py``: scatter-render a ``.ply``
written by ``utils/ply.py`` (``infer --ply``), a raw ``.pts`` file
(colored by part label with ``--seg``), or a shape of a ShapeNet-part
root (``--dataset``, ``--index``; colored by its part labels). Same flags
as the JAX script, except that ``--device`` replaces ``--cpu``; rendering
runs on the host and touches no device, so it only names one. matplotlib
is imported when a cloud is rendered, not with this module.

    python -m adversarial_learning_on_pointclouds_tpu_torch.render_cloud \\
        --ply out.ply --out out.png
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from adversarial_learning_on_pointclouds_tpu_torch.utils import ply


def render(points: np.ndarray, labels: Optional[np.ndarray], out: str,
           elev: float = 20.0, azim: float = -60.0) -> None:
    """``points [P, 3]`` as a 3-D scatter (``labels [P]``: one color a
    part) into the PNG ``out``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6), dpi=120)
    ax = fig.add_subplot(projection="3d")
    kw = {} if labels is None else {"c": labels, "cmap": "tab20"}
    ax.scatter(points[:, 0], points[:, 2], points[:, 1], s=2, **kw)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    ax.set_box_aspect((1, 1, 1))
    fig.tight_layout(pad=0)
    fig.savefig(out)
    plt.close(fig)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ply", type=str, help=".ply file (utils/ply.py)")
    src.add_argument("--pts", type=str, help="raw .pts file (x y z rows)")
    src.add_argument("--dataset", type=str,
                     help="ShapeNet-part root; renders --index")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--seg", type=str, default="",
                   help=".seg labels for --pts coloring")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--elev", type=float, default=20.0)
    p.add_argument("--azim", type=float, default=-60.0)
    p.add_argument("--device", type=str, default="cpu",
                   help="the JAX script's --cpu: rendering uses no device")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    a = parse_args(argv)
    labels = None
    if a.ply:
        points = ply.read_ply(a.ply)  # xyz; label colors baked in the file
    elif a.pts:
        points = np.loadtxt(a.pts, dtype=np.float32).reshape(-1, 3)
        if a.seg:
            labels = np.loadtxt(a.seg, dtype=np.int32)
    else:
        from adversarial_learning_on_pointclouds_tpu_torch.data.shapenet_part \
            import ShapeNetPart

        points, labels, _ = ShapeNetPart(a.dataset, "train")[a.index]
    render(np.asarray(points), labels, a.out, a.elev, a.azim)
    print(f"wrote {a.out} ({len(points)} points)")


if __name__ == "__main__":
    main()
