"""Configuration read by the serving path.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/configs.py``;
only the ``SegmentConfig`` fields that inference reads are ported so far.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SegmentConfig:
    """Config 3: ShapeNet-part segmentation (also the adversarial G)."""

    num_points: int = 2048
    num_parts: int = 50
    feature_transform: bool = True
