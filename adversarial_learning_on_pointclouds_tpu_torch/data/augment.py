"""Host-side point-cloud preparation.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/data/augment.py``;
so far only the numpy unit-sphere normalize that inference uses.
"""

from __future__ import annotations

import numpy as np


def normalize_unit_sphere_np(points: np.ndarray) -> np.ndarray:
    """Center each cloud and scale it into the unit sphere (numpy, for
    deterministic eval-set preparation)."""
    points = np.asarray(points, np.float32)
    centered = points - points.mean(axis=-2, keepdims=True)
    scale = np.max(np.linalg.norm(centered, axis=-1, keepdims=True),
                   axis=-2, keepdims=True)
    return centered / np.maximum(scale, 1e-12)
