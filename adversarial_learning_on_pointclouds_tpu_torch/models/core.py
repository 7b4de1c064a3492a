"""Layer primitives with the JAX package's eval semantics.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/models/core.py``.
The port keeps parameters in ``nn.Conv1d`` / ``nn.Linear`` /
``nn.BatchNorm1d`` containers under the reference names, so reference
``.pth`` state_dicts load with ``strict=True``; the forwards compute in
the JAX package's channel-last layout (``[B, N, C]``, weights used as
``[in, out]`` views).

* BatchNorm is eval-only here: running statistics, ``eps = 1e-5``.
* Init is torch's default for ``Conv1d``/``Linear`` (weight and bias
  ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``), which is what the JAX
  package's ``torch_linear_init`` reproduces; ``init_`` redraws it from
  an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

BN_EPS = 1e-5


def exact_fp32() -> None:
    """Keep fp32 matmuls and convolutions in full fp32 on the card.

    cuDNN runs fp32 convolutions in TF32 by default, which keeps about
    three decimal digits; the port serves in fp32, like the JAX
    package's HIGHEST-precision path, so both switches are pinned off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu":
        return torch.relu(x)
    if act == "leaky_relu":
        return torch.where(x >= 0, x, 0.2 * x)
    raise ValueError(f"unknown activation {act!r}")


def weight_in_out(layer: nn.Module) -> torch.Tensor:
    """``[in, out]`` view of a ``Conv1d(k=1)`` / ``Linear`` weight (no
    copy: its strides are ``(1, in)``, the row-major ``[out, in]``
    storage the kernels read)."""
    return layer.weight.flatten(1).t()


def dense(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` over the trailing channel axis."""
    return torch.matmul(x, weight_in_out(layer)) + layer.bias


def bn_affine(bn: nn.BatchNorm1d):
    """Eval BatchNorm as a per-channel ``(scale, shift)``."""
    scale = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    return scale, bn.bias - bn.running_mean * scale


def init_(module: nn.Module, generator: torch.Generator) -> None:
    """Redraw every ``Conv1d``/``Linear`` from ``generator`` with torch's
    default bounds and reset every BatchNorm to its defaults."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()


def finish_init(module: nn.Module, device, generator) -> None:
    """Shared tail of every model constructor: optional seeded init (on
    the CPU, where ``generator`` lives), eval mode, then the device."""
    if generator is not None:
        init_(module, generator)
    module.eval()
    if device is not None:
        module.to(device)


def require_eval(module: nn.Module) -> None:
    if module.training:
        raise RuntimeError(
            f"{type(module).__name__}: the port has only the eval forward "
            "(running BatchNorm statistics); call .eval(). Training is "
            "still to come (ROADMAP, Queue 1, slice 2).")
