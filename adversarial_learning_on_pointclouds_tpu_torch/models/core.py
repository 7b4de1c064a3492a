"""Layer primitives with the JAX package's semantics.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/models/core.py``.
The port keeps parameters in ``nn.Conv1d`` / ``nn.Linear`` /
``nn.BatchNorm1d`` containers under the reference names, so reference
``.pth`` state_dicts load with ``strict=True``; the forwards compute in
the JAX package's channel-last layout (``[B, N, C]``, weights used as
``[in, out]`` views).

* BatchNorm: eval folds the running statistics; train
  (``batch_norm_train``, and ``batch_norm_train_grouped`` per row block)
  normalizes with the batch moments and updates the running statistics
  in place (``eps = 1e-5``, momentum 0.1).
* Dropout (``dropout``) is inverted, its mask drawn from an explicit
  generator.
* Data parallelism (``parallel/dist.py``): at world size W > 1 every
  batch statistic is the global batch's. ``batch_norm_train`` and
  ``batch_norm_train_grouped`` all-reduce their centred sums before the
  moments (the centre, the running mean, is the same on every rank) and
  count the global values; ``batch_moments`` and ``update_running`` take
  the global sums and count from their callers; ``dropout_mask`` draws
  the global batch's mask and keeps the rank's rows. At W = 1 nothing
  here calls a collective and every line runs as on one device.
* Init is torch's default for ``Conv1d``/``Linear`` (weight and bias
  ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``), which is what the JAX
  package's ``torch_linear_init`` reproduces; ``init_`` redraws it from
  an explicit ``torch.Generator``.
* Mixed precision: ``mixed_precision()`` is the scope under which every
  matmul of the training path takes bf16 operands with an fp32 sum and
  result (``matmul`` for the plain ops, the kernels' ``bf16`` switch for
  the passes); parameters, BatchNorm, statistics, losses and Adam stay
  fp32.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

import torch
from torch import nn

from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

_mp_state = threading.local()


def compute_dtype() -> Optional[torch.dtype]:
    """Matmul operand dtype under the mixed-precision scope (None: fp32)."""
    return getattr(_mp_state, "dtype", None)


class mixed_precision:
    """Scope: bf16 matmul operands with fp32 accumulation, as the JAX
    package's ``core.mixed_precision``. Read when a forward runs; the
    autograd functions keep what their forward saw for the backward."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 enabled: bool = True):
        self._dtype = dtype if enabled else None

    def __enter__(self):
        self._prev = compute_dtype()
        _mp_state.dtype = self._dtype
        return self

    def __exit__(self, *exc):
        _mp_state.dtype = self._prev
        return False


def operand(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``t`` as a matmul operand: rounded to bf16 (nearest even) and held
    in fp32 under ``bf16``, else ``t`` itself."""
    return t.to(torch.bfloat16).float() if bf16 else t


def stash(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A pre-BN activation or cotangent kept between passes: bf16 under
    ``bf16``, else fp32."""
    return t.to(torch.bfloat16) if bf16 else t


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for the model layer; under the scope, the fp32 product
    of the bf16-rounded operands. That is exact in every product and sums
    in fp32 with an fp32 result, as JAX's ``preferred_element_type=
    float32`` does (a bf16 ``torch.matmul`` would round its result to
    bf16). Under autograd the gradients reaching ``a`` and ``b`` are
    rounded to bf16 at the cast, as JAX's transpose of the cast is."""
    cd = compute_dtype()
    if cd is not None and a.dtype == torch.float32:
        return torch.matmul(a.to(cd).float(), b.to(cd).float())
    return torch.matmul(a, b)


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


def dropout_mask(generator: Optional[torch.Generator], shape, p: float,
                 device) -> torch.Tensor:
    """The keep mask of inverted dropout at rate ``p``: each element kept
    where a uniform draw from ``generator`` (on ``device``) lies below
    ``1 - p``. Under data parallelism the draw is the global batch's and
    the rank keeps its rows (``dist.draw_shape``)."""
    u = torch.rand(dist.draw_shape(shape), generator=generator,
                   device=device)
    return dist.own_draw(u) < 1.0 - p


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout, torch semantics (the kept elements scaled by ``1
    / (1 - p)``), as the JAX package's ``core.dropout``, its mask drawn by
    ``dropout_mask``; ``p <= 0`` is the identity."""
    if p <= 0.0:
        return x
    mask = dropout_mask(generator, x.shape, p, x.device)
    return torch.where(mask, x / (1.0 - p), 0.0)


def weight_in_out(layer: nn.Module) -> torch.Tensor:
    """``[in, out]`` view of a ``Conv1d(k=1)`` / ``Linear`` weight (no
    copy: its strides are ``(1, in)``, the row-major ``[out, in]``
    storage the kernels read)."""
    return layer.weight.flatten(1).t()


def dense(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` over the trailing channel axis (``matmul``: bf16
    operands under the mixed-precision scope)."""
    return matmul(x, weight_in_out(layer)) + layer.bias


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
    the CPU, where ``generator`` lives), eval mode (``.train()`` selects
    the training forward), then the device."""
    if generator is not None:
        init_(module, generator)
    module.eval()
    if device is not None:
        module.to(device)


def _centred_moments(xc: torch.Tensor, axes, m: int, per_point: bool):
    """``(E[xc], E[xc^2], global m)`` over ``axes`` (kept), the sums
    all-reduced where the reduction crosses the ranks
    (``dist.reduce_sum``; differentiable)."""
    sums = dist.reduce_sum(torch.stack([xc.sum(dim=axes, keepdim=True),
                                        xc.square().sum(dim=axes,
                                                        keepdim=True)]),
                           per_point)
    m = dist.count(m, per_point)
    return sums[0] / m, sums[1] / m, m


def batch_norm_train(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm over every axis but the last (channels), as
    the JAX package's ``core.batch_norm(train=True)``.

    One-pass moments centred on the running mean (``var = E[(x-c)^2] -
    E[x-c]^2`` with ``c`` the running mean, which keeps the form exact
    when ``|mean| >> std``); the biased variance normalizes, and the
    running statistics take the EMA of the mean and the unbiased variance
    (``update_running``). Gradients flow through the batch moments. At
    world size above 1 the moments are the global batch's (``[B, N, C]``
    per-point input: always; ``[B, C]`` rows: under data parallelism)."""
    axes = tuple(range(x.dim() - 1))
    c = bn.running_mean.detach().clone()
    xc = x - c
    per_point = x.dim() >= 3
    m = x.numel() // x.shape[-1]
    if dist.spans(per_point):
        mean_c, m2, m = _centred_moments(xc, axes, m, per_point)
        mean_c, m2 = mean_c.reshape(-1), m2.reshape(-1)
    else:
        mean_c = xc.mean(dim=axes)
        m2 = xc.square().mean(dim=axes)
    var = torch.clamp(m2 - mean_c.square(), min=0.0)
    mean = mean_c + c
    update_running(bn, mean, var, m)
    inv = torch.rsqrt(var + BN_EPS)
    return (x - mean) * (inv * bn.weight) + bn.bias


def batch_norm_train_grouped(bn: nn.BatchNorm1d, x: torch.Tensor,
                             groups: int) -> torch.Tensor:
    """Train-mode BatchNorm of ``groups`` contiguous row blocks of ``x
    [G * B, ..., C]``, each normalized with its own batch moments, as the
    JAX package's ``core.batch_norm_grouped``.

    Every block is centred on the *incoming* running mean; the running
    statistics then take the blocks' EMA chained block 0 -> G - 1, the
    statistics of ``groups`` sequential ``batch_norm_train`` calls (whose
    later blocks would centre on the updated mean: a rounding-level
    difference). ``groups == 1`` is ``batch_norm_train``. At world size
    above 1 each block's moments are its global batch's."""
    if groups == 1:
        return batch_norm_train(bn, x)
    gb, c = x.shape[0], x.shape[-1]
    if gb % groups:
        raise ValueError(f"batch {gb} does not split into {groups} groups")
    cc = bn.running_mean.detach().clone()
    xc = (x - cc).reshape((groups, gb // groups) + tuple(x.shape[1:]))
    axes = tuple(range(1, xc.dim() - 1))
    per_point = x.dim() >= 3
    m = xc[0].numel() // c
    if dist.spans(per_point):
        mean_c, m2, m = _centred_moments(xc, axes, m, per_point)
    else:
        mean_c = xc.mean(dim=axes, keepdim=True)
        m2 = xc.square().mean(dim=axes, keepdim=True)
    var = torch.clamp(m2 - mean_c.square(), min=0.0)
    inv = torch.rsqrt(var + BN_EPS)
    y = ((xc - mean_c) * (inv * bn.weight) + bn.bias).reshape(x.shape)
    mean = (mean_c + cc).reshape(groups, c)
    var = var.reshape(groups, c)
    for i in range(groups):
        update_running(bn, mean[i], var[i], m)
    return y


def batch_moments(s: torch.Tensor, ss: torch.Tensor, m: int):
    """``(mean, biased var, 1/sqrt(var + eps))`` from a kernel's column
    sum and sum of squares over ``m`` values (the raw one-pass form of the
    JAX training kernels). At world size above 1 the caller passes the
    global batch's sums and count."""
    mu = s / m
    var = torch.clamp(ss / m - mu * mu, min=0.0)
    return mu, var, torch.rsqrt(var + BN_EPS)


# A one-pass variance m2 - mu_c^2 keeps log2(m2 / var) fewer bits than
# fp32's 24. From this multiple on the T-Net fc heads' BN takes its
# variance from a second pass (``rows_moments``). The limit is where the
# port's JAX-parity runs over several Adam steps allow it: below it the
# heads keep the JAX kernels' one-pass rounding, which those runs pin. A
# second pass in every column moved two of them past their 5e-3
# (``test_runner_matches_jax_from_the_same_pth`` 5.09e-3,
# ``test_adversarial_epoch_program_matches_jax`` 5.2e-3) and a limit of
# 1024 a third (``test_train_steps_scan_matches_jax`` 5.03e-3); at 4096
# the scan run reads 4.43e-3 (4.44e-3 with one pass everywhere). Any
# column past it keeps fewer than half of fp32's bits in one pass.
ONE_PASS_LIMIT = 4096.0


def rows_moments(z: torch.Tensor, c: torch.Tensor, groups: int = 1):
    """``(mean, biased var, 1/sqrt(var + eps))`` per group of ``z [G b,
    C]``'s rows, each ``[G, C]``: the mean about ``c``, ``mu = c + mean(z
    - c)``; the variance in one pass about ``c``, ``max(m2 - mu_c^2, 0)``
    (the JAX kernels' form), unless ``m2`` reaches ``ONE_PASS_LIMIT``
    times the second pass's variance about the mean, ``mean((z - c -
    mu_c)^2)``: then that one. At a few rows a column's variance can sit
    near eps with ``|mu_c|`` hundreds of times its spread, where one pass
    keeps about two digits. The branch is taken on the second pass's
    variance, which any order of sums gives to a few ulps, so the kernel
    and this twin take the same one (on the one-pass variance, which
    moves by ``m2 / var`` ulps, they would part at the limit). The plain
    twin of ``csrc/small_fc.cuh``'s BN epilogue (pool-fc, the fc
    head)."""
    zc = (z - c).reshape(groups, -1, z.shape[-1])
    b = zc.shape[1]
    mu_c = zc.sum(1) / b
    m2 = (zc * zc).sum(1) / b
    d = zc - mu_c[:, None]
    var2 = (d * d).sum(1) / b
    var = torch.where(var2 * ONE_PASS_LIMIT > m2,
                      torch.clamp(m2 - mu_c * mu_c, min=0.0), var2)
    return mu_c + c, var, torch.rsqrt(var + BN_EPS)


def update_running(bn: nn.BatchNorm1d, mean: torch.Tensor,
                   var_biased: torch.Tensor, m: int) -> None:
    """torch-style running-statistic update from batch statistics, in
    place: ``(1 - momentum) * old + momentum * batch`` on the mean and
    on the unbiased variance (``m`` values behind each moment: ``B * N``
    for a per-point BN, ``B`` for an fc BN: the global batch's under data
    parallelism), and one more ``num_batches_tracked``. Counterpart of the
    JAX package's ``encoder._ema_stats``; the batch statistics carry no
    gradient."""
    with torch.no_grad():
        unbiased = var_biased.detach() * (m / max(m - 1, 1))
        bn.running_mean.copy_((1.0 - BN_MOMENTUM) * bn.running_mean
                              + BN_MOMENTUM * mean.detach())
        bn.running_var.copy_((1.0 - BN_MOMENTUM) * bn.running_var
                             + BN_MOMENTUM * unbiased)
        bn.num_batches_tracked += 1
