"""Minimal ASCII ``.ply`` I/O: label-colored point clouds.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/utils/ply.py``
(numpy only). Colors cycle a 16-entry palette by part label.
"""

from __future__ import annotations

import numpy as np

_PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
], dtype=np.uint8)


def write_ply_with_labels(path: str, points: np.ndarray,
                          labels: np.ndarray) -> None:
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    labels = np.asarray(labels, dtype=np.int64).reshape(-1)
    colors = _PALETTE[labels % len(_PALETTE)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{c[0]} {c[1]} {c[2]}\n")


def read_ply(path: str) -> np.ndarray:
    """Read an ascii ply written by this module (xyz only)."""
    with open(path) as f:
        line = f.readline()
        n = 0
        while line and not line.startswith("end_header"):
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            line = f.readline()
        data = np.loadtxt(f, max_rows=n, ndmin=2)
    return data[:, :3].astype(np.float32)
