"""Configuration of the training steps and of serving.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/configs.py``:
the ``SegmentConfig`` and ``AdversarialConfig`` fields that the train
steps and inference read, with the JAX package's names and defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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
    scan: int = 0                 # --scan K: K steps per call; when set,
                                  #   adversarial.train_steps_scan takes
                                  #   exactly K batches
    pallas_augment: bool = False  # rotate/jitter/dropout as one
                                  #   augment_fused pass on a Philox seed
    bf16: bool = False            # mixed precision: bf16 matmul operands,
                                  #   fp32 sums (core.mixed_precision)
    num_parts: int = 50


# The JAX package's ablation controls and cross-stream batching knobs, with
# their defaults: the port runs the defaults only.
_NOT_PORTED = {"supervised_only": False, "self_training": False,
               "d_geometry": False, "paired_conv1": False,
               "fused_forward": False}


@dataclasses.dataclass(frozen=True)
class AdversarialConfig(SegmentConfig):
    """Config 4: adversarial semi-supervised segmentation (Hung et al.,
    arXiv:1802.07934), the fields the G+D train step reads. Setting an
    ablation control (``supervised_only``, ``self_training``,
    ``d_geometry``) or a batching knob (``paired_conv1``,
    ``fused_forward``) off its default raises: they are still to port
    (ROADMAP, Queue 1, item 14). ``paired_trunks`` (the trunks batched
    across the two streams, ``trunk2_train(groups=2)``) needs
    ``paired_heads``, as in the JAX package's flag check."""

    lambda_adv: float = 0.01      # --lambda_adv
    lambda_adv_unl: Optional[float] = None  # unlabeled stream's own weight
    lambda_semi: float = 0.1      # --lambda_semi
    semi_threshold: float = 0.2   # --threshold (T_semi)
    lr_d: float = 1e-4            # discriminator Adam lr
    beta1_d: float = 0.9
    beta2_d: float = 0.99
    semi_start: int = 0           # --semi_start: first step with L_semi
    paired_heads: bool = True     # T-Net fc heads batched across streams
                                  #   (paired_trunks: the conv trunks too)
    supervised_only: bool = False
    self_training: bool = False
    d_geometry: bool = False
    paired_trunks: bool = False
    paired_conv1: bool = False
    fused_forward: bool = False

    def __post_init__(self):
        for name, default in _NOT_PORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"AdversarialConfig({name}={getattr(self, name)!r}) is "
                    "not ported yet (ROADMAP, Queue 1, item 14: ablation "
                    "controls)")
        if self.paired_trunks and not self.paired_heads:
            raise ValueError("paired_trunks requires the paired-heads path "
                             "(paired_heads=True)")
