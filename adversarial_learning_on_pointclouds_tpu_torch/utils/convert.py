"""JAX-package weights -> the port's state_dict.

The JAX package keeps a model as ``(params, bn_state)`` nested dicts of
arrays with dense weights ``[in, out]``; the port keeps the reference's
PyTorch modules. This converts the former (as numpy arrays, so no JAX is
needed here) into a ``state_dict`` that the port's ``PointNetCls``,
``PointNetDenseCls`` and ``FCDiscriminator`` and the reference's all
load with ``strict=True``. Its keys and values are those of the JAX
package's ``utils/torch_export.classifier_state_dict``,
``segmenter_state_dict`` and ``discriminator_state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd: Dict[str, torch.Tensor], name: str, p: dict,
           conv: bool) -> None:
    w = np.asarray(p["w"], np.float32).T  # [in, out] -> [out, in]
    sd[f"{name}.weight"] = _tensor(w[..., None] if conv else w)
    sd[f"{name}.bias"] = _tensor(p["b"])


def _bn(sd: Dict[str, torch.Tensor], name: str, p: dict, s: dict) -> None:
    sd[f"{name}.weight"] = _tensor(p["scale"])
    sd[f"{name}.bias"] = _tensor(p["bias"])
    sd[f"{name}.running_mean"] = _tensor(s["mean"])
    sd[f"{name}.running_var"] = _tensor(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _tnet(sd, prefix: str, params: dict, state: dict) -> None:
    for i in (1, 2, 3):
        _dense(sd, f"{prefix}.conv{i}", params[f"conv{i}"], conv=True)
        _bn(sd, f"{prefix}.bn{i}", params[f"bn{i}"], state[f"bn{i}"])
    # The reference names the fc-head BNs bn4/bn5.
    for i, bn_name in ((1, "bn4"), (2, "bn5")):
        _dense(sd, f"{prefix}.fc{i}", params[f"fc{i}"], conv=False)
        _bn(sd, f"{prefix}.{bn_name}", params[f"bn_fc{i}"], state[f"bn_fc{i}"])
    _dense(sd, f"{prefix}.fc3", params["fc3"], conv=False)


def _encoder(sd, params: dict, state: dict) -> None:
    feat, feat_s = params["feat"], state["feat"]
    _tnet(sd, "feat.stn", feat["stn"], feat_s["stn"])
    for i in (1, 2, 3):
        _dense(sd, f"feat.conv{i}", feat[f"conv{i}"], conv=True)
        _bn(sd, f"feat.bn{i}", feat[f"bn{i}"], feat_s[f"bn{i}"])
    if "fstn" in feat:
        _tnet(sd, "feat.fstn", feat["fstn"], feat_s["fstn"])


def classifier_state_dict(params: Dict[str, Any],
                          bn_state: Dict[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """JAX classifier ``(params, bn_state)`` -> ``PointNetCls``
    state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, params, bn_state)
    for i in (1, 2, 3):
        _dense(sd, f"fc{i}", params[f"fc{i}"], conv=False)
    for i in (1, 2):
        _bn(sd, f"bn{i}", params[f"bn{i}"], bn_state[f"bn{i}"])
    return sd


def segmenter_state_dict(params: Dict[str, Any],
                         bn_state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX segmenter ``(params, bn_state)`` -> ``PointNetDenseCls``
    state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, params, bn_state)
    for i in (1, 2, 3):
        _dense(sd, f"conv{i}", params[f"conv{i}"], conv=True)
        _bn(sd, f"bn{i}", params[f"bn{i}"], bn_state[f"bn{i}"])
    _dense(sd, "conv4", params["conv4"], conv=True)
    return sd


def discriminator_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX discriminator params -> ``FCDiscriminator`` state_dict (``conv5``
    is the reference's ``classifier``)."""
    sd: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3, 4):
        _dense(sd, f"conv{i}", params[f"conv{i}"], conv=True)
    _dense(sd, "classifier", params["conv5"], conv=True)
    return sd
