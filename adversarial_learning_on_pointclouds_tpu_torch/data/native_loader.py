"""Python surface of the native .pts/.seg loader with its numpy path.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/data/
native_loader.py``. ``load_pts_shapes`` parses + fixed-N-resamples a list
of ShapeNet per-shape files into rectangular arrays, with the C++ thread
pool when the shared library builds (``native/build.py``) and with numpy
otherwise. Output semantics match the reference's ``np.loadtxt`` +
``np.random.choice`` pipeline (resample with replacement; labels shifted
by the category's global part-id offset); the two paths draw from
different streams, each the same as the JAX package's path of that name.
``last_loader()`` names the path the latest call took.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from adversarial_learning_on_pointclouds_tpu_torch.native.build import get_lib

_last = [""]


def native_available() -> bool:
    return get_lib() is not None


def last_loader() -> str:
    """``"native"`` or ``"numpy"``: which path the latest
    ``load_pts_shapes`` call took ("" before the first)."""
    return _last[0]


def load_pts_shapes(pts_paths: Sequence[str],
                    seg_paths: Optional[Sequence[str]],
                    part_offsets: Optional[Sequence[int]],
                    num_points: int, seed: int = 0,
                    n_threads: int = 0,
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns ``(points [S, N, 3] f32, labels [S, N] i32 or None)``."""
    n = len(pts_paths)
    lib = get_lib()
    if lib is not None:
        _last[0] = "native"
        out_pts = np.empty((n, num_points, 3), np.float32)
        out_seg = (np.empty((n, num_points), np.int32)
                   if seg_paths is not None else None)
        c_pts = (ctypes.c_char_p * n)(*[p.encode() for p in pts_paths])
        c_seg = ((ctypes.c_char_p * n)(*[p.encode() for p in seg_paths])
                 if seg_paths is not None else None)
        c_off = ((ctypes.c_int * n)(*(part_offsets or [0] * n))
                 if seg_paths is not None else None)
        rc = lib.load_shapes(
            c_pts, c_seg, c_off, n, num_points, seed,
            out_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
            if out_seg is not None else None,
            n_threads)
        if rc == 0:
            return out_pts, out_seg
        raise IOError(
            f"native loader failed on shape index {rc - 1}: "
            f"{pts_paths[rc - 1]!r}")
    return numpy_load(pts_paths, seg_paths, part_offsets, num_points, seed)


def numpy_load(pts_paths, seg_paths, part_offsets, num_points, seed):
    """The numpy path (``np.loadtxt`` + one seeded ``rng.choice`` stream),
    taken when the native library cannot be built."""
    _last[0] = "numpy"
    n = len(pts_paths)
    out_pts = np.empty((n, num_points, 3), np.float32)
    out_seg = np.empty((n, num_points), np.int32) if seg_paths else None
    rng = np.random.default_rng(seed)
    for i in range(n):
        pts = np.loadtxt(pts_paths[i], dtype=np.float32).reshape(-1, 3)
        idx = rng.choice(len(pts), num_points, replace=True)
        out_pts[i] = pts[idx]
        if seg_paths:
            seg = np.loadtxt(seg_paths[i], dtype=np.int32).reshape(-1)
            off = part_offsets[i] if part_offsets else 0
            out_seg[i] = seg[idx] + off
    return out_pts, out_seg
