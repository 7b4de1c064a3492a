"""Configuration of the segmentation step and of serving.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/configs.py``:
the ``SegmentConfig`` fields that the train step and inference read, with
the JAX package's names and defaults.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SegmentConfig:
    """Config 3: ShapeNet-part segmentation (also the adversarial G)."""

    batch_size: int = 32          # --batchSize
    num_points: int = 2048        # --num_points
    epochs: int = 250             # --nepoch
    seed: int = 0                 # --manualSeed
    lr: float = 1e-3              # Adam lr
    beta1: float = 0.9
    beta2: float = 0.999
    lr_step: int = 20             # StepLR step_size, in epochs
    lr_gamma: float = 0.5         # StepLR gamma
    optimizer: str = "adam"       # {adam, sgd}: sgd has momentum 0.9
    lr_schedule: str = "step"     # {step, poly}
    poly_power: float = 0.9
    feature_transform: bool = True
    augment: bool = False         # on-device rotate + jitter
    normalize: bool = True        # unit-sphere normalize per cloud
    resample: bool = True         # fixed-N subsample when clouds are larger
    point_dropout: bool = False
    num_parts: int = 50
