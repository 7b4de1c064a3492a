"""Load reference-format ``.pth`` checkpoints into the port's models.

Counterpart of the ``.pth`` half of
``adversarial_learning_on_pointclouds_tpu/utils/checkpoint.py``
(``load_pth_warm_start`` / ``load_pth_generator``). A reference run saves
``model.state_dict()`` with ``torch.save``; the architecture is told by
the top-level keys: ``conv4`` for the segmenter (T-Net layers live under
``feat.*``, so the top level is unambiguous), ``fc3`` for the
classifier. An adversarial run's generator is a segmenter ``.pth``.
"""

from __future__ import annotations

from typing import Dict

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetDenseCls,
)


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state_dict, on the CPU, loaded without unpickling code."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _check_keys(path: str, sd: dict, like: dict) -> None:
    """Raise a readable error when ``sd`` does not fit the model built
    from the flags (wrong ``--num_parts`` / ``--feature_transform``)."""
    missing = sorted(set(like) - set(sd))
    extra = sorted(set(sd) - set(like))
    wrong = [f"{k}: {tuple(sd[k].shape)} != {tuple(like[k].shape)}"
             for k in sorted(set(sd) & set(like))
             if tuple(sd[k].shape) != tuple(like[k].shape)]
    if missing or extra or wrong:
        raise ValueError(
            f"{path!r} does not match the segmenter built from the flags"
            + (f"; missing {missing[:4]}" if missing else "")
            + (f"; unexpected {extra[:4]}" if extra else "")
            + (f"; shape mismatch {wrong[:4]}" if wrong else "")
            + " - check --feature_transform / --num_parts against how the "
              ".pth was trained.")


def load_segmenter(path: str, num_parts: int = 50,
                   feature_transform: bool = True,
                   device=None) -> PointNetDenseCls:
    """Reference ``PointNetDenseCls`` ``.pth`` -> eval ``PointNetDenseCls``
    on ``device``, loaded with ``strict=True``."""
    sd = load_pth(path)
    if "conv4.weight" not in sd:
        if "fc3.weight" in sd:
            raise NotImplementedError(
                f"{path!r} is a classifier (PointNetCls) checkpoint; the "
                "port's classifier is still to come (ROADMAP, Queue 1, "
                "'Classification')")
        raise ValueError(f"{path!r}: not a recognized reference state_dict "
                         "(no top-level conv4/fc3: expected PointNetCls or "
                         "PointNetDenseCls keys)")
    model = PointNetDenseCls(num_parts, feature_transform)
    _check_keys(path, sd, model.state_dict())
    model.load_state_dict(sd, strict=True)
    if device is not None:
        model.to(device)
    return model
