"""The models, eval and train, with the reference's parameter names."""

from adversarial_learning_on_pointclouds_tpu_torch.models.discriminator import (
    FCDiscriminator,
)
from adversarial_learning_on_pointclouds_tpu_torch.models.encoder import (
    PointNetfeat,
)
from adversarial_learning_on_pointclouds_tpu_torch.models.segmenter import (
    PointNetDenseCls,
)
from adversarial_learning_on_pointclouds_tpu_torch.models.tnet import (
    STN3d, STNkd,
)

__all__ = ["FCDiscriminator", "PointNetDenseCls", "PointNetfeat", "STN3d",
           "STNkd"]
