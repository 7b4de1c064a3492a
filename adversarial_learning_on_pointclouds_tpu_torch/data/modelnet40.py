"""ModelNet40 (classification): the h5 reader and the synthetic fixture.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/data/
modelnet40.py``. The schema is the reference loader's: shard files
``ply_data_{train,test}*.h5`` with ``data [S, 2048, 3] float32`` and
``label [S, 1] uint8``, listed in ``{split}_files.txt``. ``ModelNet40``
concatenates the shards in host memory; ``h5py`` is imported inside the
reader only, since the card's machine has none.

No dataset ships with the repository. ``synthetic_modelnet`` returns,
in memory, the very arrays the JAX package's ``make_synthetic_modelnet_
h5`` writes (the same ``default_rng(seed)`` draws in the same order, two
shards a split): class-conditioned gaussian blobs with a class-dependent
anisotropic scaling, unit-sphere normalized, so a classifier can fit
them. The runners use it when ``cfg.dataset`` is empty.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

NUM_CLASSES = 40


class ModelNet40:
    """Host-side reader: ``points [S, N0, 3]`` float32, ``labels [S]``
    int32."""

    def __init__(self, root: str, split: str = "train"):
        import h5py  # only the h5 shards need it

        list_file = os.path.join(root, f"{split}_files.txt")
        if os.path.exists(list_file):
            with open(list_file) as f:
                shards = [ln.strip() for ln in f if ln.strip()]
            # The reference lists paths relative to the data root's parent.
            shards = [s if os.path.isabs(s) else
                      os.path.join(root, os.path.basename(s)) for s in shards]
        else:
            shards = sorted(
                os.path.join(root, fn) for fn in os.listdir(root)
                if fn.endswith(".h5") and split in fn)
        if not shards:
            raise FileNotFoundError(
                f"no ModelNet40 {split} shards under {root!r}")
        datas, labels = [], []
        for path in shards:
            with h5py.File(path, "r") as f:
                datas.append(np.asarray(f["data"], dtype=np.float32))
                labels.append(np.asarray(f["label"],
                                         dtype=np.int64).reshape(-1))
        self.points = np.concatenate(datas, axis=0)
        self.labels = np.concatenate(labels, axis=0).astype(np.int32)

    def __len__(self) -> int:
        return self.points.shape[0]


def synthetic_modelnet(num_train: int = 64, num_test: int = 32,
                       num_points: int = 2048,
                       num_classes: int = NUM_CLASSES, seed: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """``(x_train, y_train, x_test, y_test)`` as ``ModelNet40`` reads them
    from the shards of ``make_synthetic_modelnet_h5(root, num_train,
    num_test, num_points, num_classes, seed)``: points ``[S, num_points,
    3]`` float32, labels ``[S]`` int32."""
    rng = np.random.default_rng(seed)

    def split(count: int, shards: int = 2):
        per = -(-count // shards)
        xs, ys = [], []
        for si in range(shards):
            n = min(per, count - si * per)
            if n <= 0:
                break
            labels = rng.integers(0, num_classes, size=(n, 1),
                                  dtype=np.uint8)
            pts = rng.standard_normal((n, num_points, 3)).astype(np.float32)
            scale = 0.5 + 1.5 * (labels.astype(np.float32) / num_classes)
            pts[..., 0] *= scale
            pts[..., 1] *= 2.0 - scale
            norm = np.max(np.linalg.norm(pts, axis=-1, keepdims=True),
                          axis=1, keepdims=True)
            xs.append(pts / np.maximum(norm, 1e-12))
            ys.append(labels.reshape(-1).astype(np.int32))
        return np.concatenate(xs), np.concatenate(ys)

    x_tr, y_tr = split(num_train)
    x_te, y_te = split(num_test)
    return x_tr, y_tr, x_te, y_te
