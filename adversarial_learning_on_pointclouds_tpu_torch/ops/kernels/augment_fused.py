"""On-device augmentation in one pass: rotate, jitter and dropout.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/ops/kernels/
augment_fused.py::augment_fused`` (``--pallas_augment``). Per cloud ``[N,
3]``:

* one angle ``U * 2 pi``: a rotation about Y in the row convention
  ``[c x0 - s x2, x1, s x0 + c x2]``;
* per coordinate a Box-Muller normal (``u1`` clamped at 1e-7) times
  ``sigma``, clipped to ``+-clip``;
* a ratio ``U * max_ratio``; every point with ``u <= ratio`` becomes the
  (rotated, jittered) first point, so all-zero bits drop every point.

Uniforms come from 32 random bits by the mantissa trick ``((bits >> 9) |
0x3F800000) - 1`` on unsigned bits. The TPU kernel draws its bits from
the TPU's on-core generator; here they are Philox4x32-10 (Salmon et al.,
SC'11, the Random123 generator), keyed by an int32 seed ``(key, 0)``,
with counter ``(point, cloud, draw, 0)``, ``cloud`` the global cloud
index ``cloud0 + b`` of the batch's row ``b`` (``cloud0`` is 0 on one
device; under data parallelism a rank passes its first row's index in
the global batch, so that each rank draws what one device draws for its
clouds):

* draw 0 of point ``p``: the three ``u1`` of its jitter and its dropout
  ``u``;
* draw 1 of point ``p``: the three ``u2`` of its jitter;
* draw 2 of point 0: the cloud's angle and its dropout ratio.

The key is ``step_seed(seed, step, stream)``: the same generator at
counter ``(step, stream, 0, 0)`` keyed by the config seed, where ``step``
is the int64 device step count. The kernel reads ``step`` from device
memory and derives the key itself, so a train step neither syncs nor
launches anything else for its seeds, and nothing is frozen into a later
graph capture.

``philox4x32`` is the same generator in plain PyTorch (uint32 arithmetic
held in int64), so the kernel (``csrc/augment_fused.cu``) and its plain
twin ``augment_fused_plain`` draw the same bits on the card, and on the
CPU the twin draws them too: the CPU and the card augment alike.
``augment_fused_plain`` also takes the bits themselves (``bits``), which
is how a test feeds it the all-zero bits of the JAX package's interpret
mode.

``augment_fused_pair`` augments two streams (a step's labeled batch as
stream 0 and its unlabeled batch as stream 1) in one launch of the same
kernel, each stream's output bit for bit what ``augment_fused`` gives it;
its plain twin is the two single-stream plain passes. ``augment_fused.launches`` counts the
kernel's launches from either entry.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from adversarial_learning_on_pointclouds_tpu_torch.ops import launch

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
TWO_PI = 6.283185307179586
ROTATE, JITTER, DROPOUT = 1, 2, 4        # the kernel's flags
Bits = Tuple[torch.Tensor, torch.Tensor]


def _mulhilo(m: int, b: torch.Tensor):
    """``(hi, lo)`` 32-bit words of ``m * b``, ``b`` uint32 in int64: the
    product is split in 16-bit halves so that no partial sum overflows."""
    p_lo = m * (b & 0xFFFF)
    p_hi = m * (b >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on counter words ``c0..c3`` and key words ``k0, k1``
    (int64 tensors or ints holding uint32 values, broadcast together):
    the four output words, as int64 tensors."""
    c0, c1, c2, c3, k0, k1 = (torch.as_tensor(v, dtype=torch.int64)
                              for v in (c0, c1, c2, c3, k0, k1))
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits (uint32 in int64) -> fp32 uniform in [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _normal(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    u1 = torch.clamp(uniform(b1), min=1e-7)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * uniform(b2))


def augment_bits(seed: torch.Tensor, bsz: int, n: int,
                 cloud0: int = 0) -> Bits:
    """The bits the kernel draws: ``(cloud [B, 2], point [B, N, 8])``
    (uint32 in int64; per cloud the angle and the ratio, per point draws
    0 and 1) of the clouds ``cloud0 .. cloud0 + B - 1``, on the seed's
    device."""
    key = seed.reshape(()).to(torch.int64) & MASK32
    dev = seed.device
    b = torch.arange(cloud0, cloud0 + bsz, device=dev,
                     dtype=torch.int64) & MASK32
    p = torch.arange(n, device=dev, dtype=torch.int64)
    cloud = philox4x32(0, b, 2, 0, key, 0)[:2]
    draws = [philox4x32(p[None, :], b[:, None], d, 0, key, 0)
             for d in (0, 1)]
    return (torch.stack(cloud, -1),
            torch.stack([w for d in draws for w in d], -1))


def step_seed(seed: int, step: torch.Tensor, stream: int = 0
              ) -> torch.Tensor:
    """The int32 key (in [0, 2^31)) of ``stream``'s augmentation at the
    int64 step count ``step``, ``[1]`` on its device: the first word of
    Philox at counter ``(step, stream, 0, 0)`` with key ``(seed, 0)``, as
    the kernel derives it."""
    word = philox4x32(step.reshape(1).to(torch.int64) & MASK32,
                      stream & MASK32, 0, 0, seed & MASK32, 0)[0]
    return (word & 0x7FFFFFFF).to(torch.int32)


def augment_fused_plain(step: torch.Tensor, points: torch.Tensor,
                        seed: int, stream: int = 0, rotate: bool = True,
                        jitter: bool = True, dropout: bool = False,
                        sigma: float = 0.01, clip: float = 0.05,
                        max_dropout_ratio: float = 0.875,
                        bits: Optional[Bits] = None,
                        cloud0: int = 0) -> torch.Tensor:
    """The kernel's pass in plain PyTorch, on ``bits`` when given (as
    ``augment_bits`` lays them out), else on the bits Philox draws from
    ``step_seed(seed, step, stream)`` for the clouds from ``cloud0``."""
    bsz, n, _ = points.shape
    cloud, point = bits if bits is not None else augment_bits(
        step_seed(seed, step, stream), bsz, n, cloud0)
    pts = points
    if rotate:
        angle = uniform(cloud[:, 0]) * TWO_PI
        c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
        x0, x1, x2 = pts.unbind(-1)
        pts = torch.stack([c * x0 - s * x2, x1, s * x0 + c * x2], -1)
    if jitter:
        noise = sigma * _normal(point[..., 0:3], point[..., 4:7])
        pts = pts + torch.clamp(noise, -clip, clip)
    if dropout:
        ratio = uniform(cloud[:, 1]) * max_dropout_ratio
        drop = uniform(point[..., 3]) <= ratio[:, None]
        pts = torch.where(drop[..., None], pts[:, :1], pts)
    return pts


def _flags(rotate: bool, jitter: bool, dropout: bool) -> int:
    return ((ROTATE if rotate else 0) | (JITTER if jitter else 0)
            | (DROPOUT if dropout else 0))


def _check(name: str, points: torch.Tensor, step: torch.Tensor,
           dev: torch.device, cloud0: int = 0) -> Tuple[int, int]:
    """``(batch, n)`` of ``points [B, N, 3]`` (fp32, contiguous, on
    ``dev``) after the checks the kernel needs, ``step`` and ``cloud0``
    with them."""
    bsz, n, _ = points.shape
    if not 0 <= cloud0 <= MASK32:
        raise ValueError(f"cloud0 {cloud0} outside the 32-bit counter word")
    launch.expect(name, points, (bsz, n, 3), dev)
    launch.expect("step", step, step.shape, dev, dtype=torch.int64)
    if step.numel() != 1:
        raise ValueError(f"step has {step.numel()} elements, expected 1")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} above the kernel's 65535")
    return bsz, n


def augment_fused(step: torch.Tensor, points: torch.Tensor, seed: int,
                  stream: int = 0, rotate: bool = True, jitter: bool = True,
                  dropout: bool = False, sigma: float = 0.01,
                  clip: float = 0.05, max_dropout_ratio: float = 0.875,
                  cloud0: int = 0) -> torch.Tensor:
    """One pass over ``points [B, N, 3]`` (fp32) of ``stream`` at the
    int64 step count ``step`` (a one-element tensor on the points'
    device, read there by the kernel), keyed by ``step_seed(seed, step,
    stream)``; its rows are the global clouds ``cloud0 ..``. The kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    if launch.on_cpu(points):
        return augment_fused_plain(step, points, seed, stream, rotate,
                                   jitter, dropout, sigma, clip,
                                   max_dropout_ratio, cloud0=cloud0)
    dev = points.device
    bsz, n = _check("points", points, step, dev, cloud0)
    out = torch.empty_like(points)
    launch.call("pt_augment_fused", dev, launch.ptr(points), launch.ptr(out),
                launch.ptr(step), seed & MASK32, stream & MASK32, cloud0,
                bsz, n, _flags(rotate, jitter, dropout), sigma, clip,
                max_dropout_ratio)
    augment_fused.launches += 1
    return out


augment_fused.launches = 0


def augment_fused_pair_plain(step: torch.Tensor, points_a: torch.Tensor,
                             points_b: torch.Tensor, seed: int,
                             rotate: bool = True, jitter: bool = True,
                             dropout: bool = False, sigma: float = 0.01,
                             clip: float = 0.05,
                             max_dropout_ratio: float = 0.875,
                             cloud0: Tuple[int, int] = (0, 0)
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair's pass in plain PyTorch: the two single-stream plain
    passes, streams 0 and 1."""
    return tuple(augment_fused_plain(step, pts, seed, stream, rotate, jitter,
                                     dropout, sigma, clip, max_dropout_ratio,
                                     cloud0=c0)
                 for stream, (pts, c0) in enumerate(zip((points_a, points_b),
                                                        cloud0)))


def augment_fused_pair(step: torch.Tensor, points_a: torch.Tensor,
                       points_b: torch.Tensor, seed: int,
                       rotate: bool = True, jitter: bool = True,
                       dropout: bool = False, sigma: float = 0.01,
                       clip: float = 0.05, max_dropout_ratio: float = 0.875,
                       cloud0: Tuple[int, int] = (0, 0)
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(augment_fused(step, points_a, seed, 0, ..., cloud0[0]),
    augment_fused(step, points_b, seed, 1, ..., cloud0[1]))`` in one
    launch: ``points_a [B_a, N_a, 3]`` and ``points_b [B_b, N_b, 3]``
    (fp32, one device; the shapes may differ). The kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if launch.on_cpu(points_a) != launch.on_cpu(points_b):
        raise ValueError(f"points_a is on {points_a.device}, points_b on "
                         f"{points_b.device}")
    if launch.on_cpu(points_a):
        return augment_fused_pair_plain(step, points_a, points_b, seed,
                                        rotate, jitter, dropout, sigma, clip,
                                        max_dropout_ratio, cloud0)
    dev = points_a.device
    bsz_a, n_a = _check("points_a", points_a, step, dev, cloud0[0])
    bsz_b, n_b = _check("points_b", points_b, step, dev, cloud0[1])
    out_a, out_b = torch.empty_like(points_a), torch.empty_like(points_b)
    launch.call("pt_augment_fused_pair", dev, launch.ptr(points_a),
                launch.ptr(points_b), launch.ptr(out_a), launch.ptr(out_b),
                launch.ptr(step), seed & MASK32, cloud0[0], cloud0[1], bsz_a,
                n_a, bsz_b, n_b, _flags(rotate, jitter, dropout), sigma, clip,
                max_dropout_ratio)
    augment_fused.launches += 1
    return out_a, out_b
