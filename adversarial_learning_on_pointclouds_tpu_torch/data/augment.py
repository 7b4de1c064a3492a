"""Point-cloud preparation and augmentation, on the device.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/data/
augment.py``. Batched over ``[B, N, 3]``; randomness comes from an
explicit ``torch.Generator`` on the points' device (its numbers are not
JAX's: tests hold these functions to their invariants, and the step
tests feed both packages the same augmented batch). The chain order is
the JAX package's: normalize -> resample -> rotate -> jitter -> dropout;
under ``cfg.pallas_augment`` the last three are one ``augment_fused``
pass keyed by Philox of the device step count instead of the generator,
and ``chain_pair_from_cfg`` makes that one launch for both streams of a
step.

At world size above 1 (``parallel/dist.py``) every rank draws what one
device draws for the global batch and keeps its part, so the ranks
together augment as one device does and every rank's generator advances
alike: the draws take ``dist.draw_shape`` and ``dist.own_draw``, its rows
under data parallelism, its points under point sharding; ``augment_fused``
takes the rank's first global cloud index (``cloud0``). Under point
sharding a cloud's centroid and scale are every rank's, a dropped point
takes the cloud's first point from rank 0, and a resample (which would
draw from every rank's points) and ``augment_fused`` raise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    augment_fused,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist


def normalize_unit_sphere_np(points: np.ndarray) -> np.ndarray:
    """Center each cloud and scale it into the unit sphere (numpy, for
    deterministic eval-set preparation)."""
    points = np.asarray(points, np.float32)
    centered = points - points.mean(axis=-2, keepdims=True)
    scale = np.max(np.linalg.norm(centered, axis=-1, keepdims=True),
                   axis=-2, keepdims=True)
    return centered / np.maximum(scale, 1e-12)


def normalize_unit_sphere(points: torch.Tensor) -> torch.Tensor:
    """Center each cloud at its centroid and divide by its largest point
    norm (both over every rank's points under point sharding)."""
    if dist.points_sharded():
        total = dist.all_reduce_(points.sum(dim=-2, keepdim=True), "sum",
                                 "stats")
        centered = points - total / dist.global_points(points.shape[-2])
        scale = dist.all_reduce_max(torch.linalg.norm(
            centered, dim=-1, keepdim=True).amax(dim=-2, keepdim=True))
        return centered / torch.clamp(scale, min=1e-12)
    centered = points - points.mean(dim=-2, keepdim=True)
    scale = torch.linalg.norm(centered, dim=-1, keepdim=True).amax(
        dim=-2, keepdim=True)
    return centered / torch.clamp(scale, min=1e-12)


def resample_fixed_n(gen: torch.Generator, points: torch.Tensor,
                     num_points: int, labels: torch.Tensor | None = None):
    """``num_points`` indices per cloud, drawn with replacement; per-point
    ``labels`` ride the same gather."""
    if dist.points_sharded():
        raise ValueError("a resample draws from every rank's points: it "
                         "cannot run under point sharding (give clouds of "
                         "num_points points, or resample=False)")
    b, n = points.shape[0], points.shape[1]
    idx = dist.own_draw(torch.randint(0, n, dist.draw_shape((b, num_points)),
                                      generator=gen, device=points.device))
    gathered = torch.gather(points, 1, idx[..., None].expand(-1, -1, 3))
    if labels is None:
        return gathered
    return gathered, torch.gather(labels, 1, idx)


def random_rotate(gen: torch.Generator, points: torch.Tensor) -> torch.Tensor:
    """A uniform rotation about the up (Y) axis, one angle per cloud:
    ``[[c, 0, s], [0, 1, 0], [-s, 0, c]]`` applied as ``points @ R``."""
    b = points.shape[0]
    angle = dist.own_draw(torch.rand(
        dist.draw_shape((b,)), generator=gen, device=points.device,
        dtype=points.dtype)) * (2.0 * math.pi)
    c, s = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, zeros, s], -1),
                       torch.stack([zeros, ones, zeros], -1),
                       torch.stack([-s, zeros, c], -1)], -2)
    return torch.bmm(points, rot)


def jitter(gen: torch.Generator, points: torch.Tensor, sigma: float = 0.01,
           clip: float = 0.05) -> torch.Tensor:
    """Gaussian per-point noise of std ``sigma``, clipped to ``+-clip``."""
    noise = sigma * dist.own_draw(torch.randn(
        dist.draw_shape(points.shape, per_point=True), generator=gen,
        device=points.device, dtype=points.dtype), per_point=True)
    return points + torch.clamp(noise, -clip, clip)


def point_dropout(gen: torch.Generator, points: torch.Tensor,
                  max_dropout_ratio: float = 0.875) -> torch.Tensor:
    """Per cloud a ratio ``r ~ U(0, max)``; each point is dropped with
    probability ``r`` and replaced by the cloud's first point (rank 0's,
    broadcast, under point sharding)."""
    b, n, _ = points.shape
    ratio = dist.own_draw(torch.rand(
        dist.draw_shape((b, 1)), generator=gen, device=points.device,
        dtype=points.dtype)) * max_dropout_ratio
    u = dist.own_draw(torch.rand(
        dist.draw_shape((b, n), per_point=True), generator=gen,
        device=points.device, dtype=points.dtype), per_point=True)
    drop = (u <= ratio)[..., None]
    first = points[:, :1, :]
    if dist.points_sharded():
        first = dist.broadcast_(first.contiguous(), 0, "broadcast")
    return torch.where(drop, first, points)


def augment_batch(gen: torch.Generator, points: torch.Tensor,
                  labels: torch.Tensor | None = None, *,
                  num_points: int | None = None, normalize: bool = False,
                  resample: bool = False, rotate: bool = True,
                  do_jitter: bool = True, dropout: bool = False):
    """normalize -> resample -> rotate -> jitter -> dropout, each behind
    its flag. Returns ``points`` or ``(points, labels)``."""
    if normalize:
        points = normalize_unit_sphere(points)
    if resample and num_points is not None:
        if labels is None:
            points = resample_fixed_n(gen, points, num_points)
        else:
            points, labels = resample_fixed_n(gen, points, num_points, labels)
    if rotate:
        points = random_rotate(gen, points)
    if do_jitter:
        points = jitter(gen, points)
    if dropout:
        points = point_dropout(gen, points)
    return points if labels is None else (points, labels)


def _fused_path(cfg) -> bool:
    return cfg.pallas_augment and (cfg.augment or cfg.point_dropout)


def _cloud0(points: torch.Tensor) -> int:
    """The rank's first global cloud index of its rows of ``points``, as
    ``augment_fused`` counts clouds (0 at world size 1); under point
    sharding the fused pass (whose bits are per point index) raises."""
    if dist.points_sharded():
        raise ValueError("augment_fused draws by point index: it does not "
                         "run under point sharding (drop pallas_augment)")
    return dist.rank() * points.shape[0]


def _prepare(gen: torch.Generator, cfg, points: torch.Tensor,
             labels: torch.Tensor | None):
    """Normalize and resample as the fused path's chain does them, the
    rest left to ``augment_fused``: ``(points, labels)``."""
    resample = (cfg.resample
                and dist.global_points(points.shape[1]) != cfg.num_points)
    out = augment_batch(gen, points, labels, num_points=cfg.num_points,
                        normalize=cfg.normalize, resample=resample,
                        rotate=False, do_jitter=False)
    return out if labels is not None else (out, None)


def chain_from_cfg(gen: torch.Generator, cfg, points: torch.Tensor,
                   labels: torch.Tensor | None = None,
                   step: torch.Tensor | None = None, stream: int = 0):
    """The chain every train step applies, gated by ``cfg.normalize``,
    ``cfg.resample`` (only when the clouds do not already have
    ``cfg.num_points``), ``cfg.augment`` (rotate and jitter) and
    ``cfg.point_dropout``.

    ``cfg.pallas_augment`` (with ``augment`` or ``point_dropout`` on)
    runs rotate, jitter and dropout as one ``augment_fused`` pass of
    ``stream`` at the int64 device step count ``step``, keyed by
    ``cfg.seed``, as the JAX package's branch does; normalize and
    resample stay plain."""
    if _fused_path(cfg):
        if step is None:
            raise ValueError("cfg.pallas_augment needs the device step")
        points, labels = _prepare(gen, cfg, points, labels)
        points = augment_fused.augment_fused(
            step, points.contiguous(), cfg.seed, stream, rotate=cfg.augment,
            jitter=cfg.augment, dropout=cfg.point_dropout,
            cloud0=_cloud0(points))
        return points if labels is None else (points, labels)
    resample = (cfg.resample
                and dist.global_points(points.shape[1]) != cfg.num_points)
    return augment_batch(
        gen, points, labels, num_points=cfg.num_points,
        normalize=cfg.normalize, resample=resample,
        rotate=cfg.augment, do_jitter=cfg.augment,
        dropout=cfg.point_dropout)


def chain_pair_from_cfg(gen: torch.Generator, cfg, a, b,
                        step: torch.Tensor | None = None):
    """``chain_from_cfg`` of a step's two streams, ``a`` (stream 0) and
    ``b`` (stream 1), each ``(points, labels or None)``: each stream's
    result as ``chain_from_cfg(gen, cfg, *a, step, 0)`` and then ``(...,
    *b, step, 1)`` return it. On the fused path (``cfg.pallas_augment``)
    normalize and resample run for ``a``, then ``b``, drawing from ``gen``
    in that order, and both streams' rotate, jitter and dropout are one
    ``augment_fused_pair`` launch, each stream bit for bit what its own
    ``augment_fused`` pass gives."""
    if not _fused_path(cfg):
        return tuple(chain_from_cfg(gen, cfg, *pl, step, s)
                     for s, pl in enumerate((a, b)))
    if step is None:
        raise ValueError("cfg.pallas_augment needs the device step")
    (pa, la), (pb, lb) = (_prepare(gen, cfg, *pl) for pl in (a, b))
    pa, pb = augment_fused.augment_fused_pair(
        step, pa.contiguous(), pb.contiguous(), cfg.seed, rotate=cfg.augment,
        jitter=cfg.augment, dropout=cfg.point_dropout,
        cloud0=(_cloud0(pa), _cloud0(pb)))
    return tuple(p if lab is None else (p, lab)
                 for p, lab in ((pa, la), (pb, lb)))
