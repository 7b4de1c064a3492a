"""ShapeNet-part dataset (per-point part segmentation).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/data/
shapenet_part.py``, a copy: the same category table, the same readers of
the per-shape ``.pts``/``.seg`` layout (JSON split files) and of the HDF5
packaging (keys ``data`` [S,N,3], ``label`` [S,1] category id, ``pid``
[S,N] part id), and the same synthetic fixtures, written byte for byte as
the JAX package writes them. The category -> part-id-range table
(``SEG_CLASSES``) is load-bearing for the instance-mIoU protocol
(SURVEY.md §7 hard part #6).

Three differences, all because the card's machine has no ``h5py``:
``h5py`` is imported only inside the h5 branches (the pts layout and the
package itself need only numpy); ``make_synthetic_shapenet`` writes
the **pts layout by default** (the JAX package's default is h5), so the
runner's default fixture is a pts fixture, in a directory of its own
(``train/runner.py``), not the JAX package's h5 one; and an **npz
layout** holds the h5 packaging's arrays in numpy's format
(``ply_data_<split>0.npz``, the same keys), read as the h5 layout is:
rectangular clouds taken whole, where the pts layout resamples every
cloud with replacement (``as_arrays``). The adversarial-gain sweep writes
its fixture in it, the protocol of the JAX package's sweep on its h5
fixture.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from adversarial_learning_on_pointclouds_tpu_torch.data import native_loader

NUM_PARTS = 50
NUM_CATEGORIES = 16

# Canonical category -> part class ids (the standard ShapeNet-part split
# used by the PointNet lineage's seg_classes dict).
SEG_CLASSES: Dict[str, List[int]] = {
    "Airplane": [0, 1, 2, 3],
    "Bag": [4, 5],
    "Cap": [6, 7],
    "Car": [8, 9, 10, 11],
    "Chair": [12, 13, 14, 15],
    "Earphone": [16, 17, 18],
    "Guitar": [19, 20, 21],
    "Knife": [22, 23],
    "Lamp": [24, 25, 26, 27],
    "Laptop": [28, 29],
    "Motorbike": [30, 31, 32, 33, 34, 35],
    "Mug": [36, 37],
    "Pistol": [38, 39, 40],
    "Rocket": [41, 42, 43],
    "Skateboard": [44, 45, 46],
    "Table": [47, 48, 49],
}
CATEGORY_NAMES: List[str] = list(SEG_CLASSES.keys())

# Dense [16, 2] (start, count) table for on-device category-masked ops.
CATEGORY_PART_RANGES = np.array(
    [[parts[0], len(parts)] for parts in SEG_CLASSES.values()],
    dtype=np.int32)


class _LazyPts:
    """List-like lazy view over per-shape .pts files (``__getitem__`` API
    compat with the eager h5 path)."""

    def __init__(self, paths):
        self._paths = paths

    def __len__(self):
        return len(self._paths)

    def __getitem__(self, i):
        return np.loadtxt(self._paths[i], dtype=np.float32).reshape(-1, 3)


class _LazySeg:
    """Lazy per-shape .seg labels, mapped to global part ids."""

    def __init__(self, paths, categories):
        self._paths = paths
        self._categories = categories

    def __len__(self):
        return len(self._paths)

    def __getitem__(self, i):
        seg = np.loadtxt(self._paths[i], dtype=np.int32).reshape(-1)
        return CATEGORY_PART_RANGES[self._categories[i], 0] + seg - 1


def _open_shard(path: str):
    """An h5 shard (``h5py``) or its npz twin: a mapping of the arrays, and
    a context manager that closes the file."""
    if path.endswith(".npz"):
        return np.load(path)
    import h5py  # the h5 layout only

    return h5py.File(path, "r")


class ShapeNetPart:
    """Host-side reader.

    Attributes: ``points`` [S, N, 3] float32 (pts layout: list of ragged
    arrays), ``part_labels`` [S, N] int32, ``category`` [S] int32.
    """

    def __init__(self, root: str, split: str = "train",
                 class_choice: Optional[str] = None):
        shards = sorted(
            os.path.join(root, fn) for fn in os.listdir(root)
            if fn.endswith((".h5", ".npz")) and split in fn)
        if shards:
            datas, pids, cats = [], [], []
            for path in shards:
                with _open_shard(path) as f:
                    datas.append(np.asarray(f["data"], dtype=np.float32))
                    pids.append(np.asarray(f["pid"], dtype=np.int32))
                    cats.append(np.asarray(f["label"],
                                           dtype=np.int32).reshape(-1))
            self.points = np.concatenate(datas, 0)
            self.part_labels = np.concatenate(pids, 0)
            self.category = np.concatenate(cats, 0)
            self._ragged = False
        else:
            self._load_pts_layout(root, split)
        if class_choice is not None:
            cat_id = CATEGORY_NAMES.index(class_choice)
            keep = self.category == cat_id
            self.category = self.category[keep]
            if self._ragged:
                self._pts_paths = [p for p, k in zip(self._pts_paths, keep)
                                   if k]
                self._seg_paths = [p for p, k in zip(self._seg_paths, keep)
                                   if k]
                self.points = _LazyPts(self._pts_paths)
                self.part_labels = _LazySeg(self._seg_paths, self.category)
            else:
                self.points = self.points[keep]
                self.part_labels = self.part_labels[keep]

    def _load_pts_layout(self, root: str, split: str) -> None:
        """Per-shape ``<synset>/points/*.pts`` + ``points_label/*.seg`` with
        ``train_test_split/shuffled_{split}_file_list.json`` (reference
        layout)."""
        split_file = os.path.join(
            root, "train_test_split", f"shuffled_{split}_file_list.json")
        cat_file = os.path.join(root, "synsetoffset2category.txt")
        synset_to_cat: Dict[str, int] = {}
        if os.path.exists(cat_file):
            with open(cat_file) as f:
                for line in f:
                    name, synset = line.split()
                    synset_to_cat[synset] = CATEGORY_NAMES.index(name)
        if not os.path.exists(split_file):
            raise FileNotFoundError(
                f"no ShapeNet-part h5 shards or pts layout under {root!r}")
        with open(split_file) as f:
            entries = json.load(f)
        pts_paths, seg_paths, cats = [], [], []
        for entry in entries:
            # entry like "shape_data/<synset>/<token>"
            _, synset, token = entry.split("/")
            pts_paths.append(
                os.path.join(root, synset, "points", token + ".pts"))
            seg_paths.append(
                os.path.join(root, synset, "points_label", token + ".seg"))
            cats.append(synset_to_cat.get(synset, 0))
        # Parsing + resampling is deferred to as_arrays(), where the
        # native C++ thread-pool loader does it in one pass
        # (data/native_loader.py); __getitem__ stays lazy per-shape.
        self._pts_paths = pts_paths
        self._seg_paths = seg_paths
        self.points = _LazyPts(pts_paths)
        self.part_labels = _LazySeg(seg_paths, cats)
        self.category = np.asarray(cats, dtype=np.int32)
        self._ragged = True

    def __len__(self) -> int:
        return len(self.category)

    def __getitem__(self, i: int):
        return self.points[i], self.part_labels[i], self.category[i]

    def as_arrays(self, num_points: int, seed: int = 0,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rectangularize to fixed N (host-side resample-with-replacement,
        matching the reference's ``np.random.choice`` in ``__getitem__``).

        The pts-file layout goes through the native C++ thread-pool loader
        (``data/native_loader.py``) — parse + resample in one pass."""
        if self._ragged:
            # .seg labels are 1-based within the category; global id =
            # category start + seg - 1.
            offsets = [int(CATEGORY_PART_RANGES[c, 0]) - 1
                       for c in self.category]
            pts, seg = native_loader.load_pts_shapes(
                self._pts_paths, self._seg_paths, offsets, num_points, seed)
            return pts, seg, self.category
        if self.points.shape[1] == num_points:
            return self.points, self.part_labels, self.category
        rng = np.random.default_rng(seed)
        if self.points.shape[1] < num_points:
            # Upsample-with-replacement to the requested size (pool mode
            # can ask for more points than the source holds). Per-shape
            # index draws, like the downsample loop below and the
            # reference's per-__getitem__ np.random.choice — one shared
            # draw would stamp the identical duplication pattern on every
            # shape in the dataset.
            src = self.points.shape[1]
            idx = rng.choice(src, (len(self), num_points), replace=True)
            rows = np.arange(len(self))[:, None]
            return (self.points[rows, idx], self.part_labels[rows, idx],
                    self.category)
        pts = np.empty((len(self), num_points, 3), np.float32)
        seg = np.empty((len(self), num_points), np.int32)
        for i in range(len(self)):
            p = self.points[i]
            idx = rng.choice(len(p), num_points, replace=True)
            pts[i] = p[idx]
            seg[i] = self.part_labels[i][idx]
        return pts, seg, self.category

    def as_pool_arrays(self, num_points: int, seed: int = 0,
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rectangular point POOL for the on-device per-batch fixed-N
        resample (the reference's fresh ``np.random.choice`` every
        ``__getitem__``; SURVEY.md §2.1 "Fixed-N resample").

        h5 layout: the full source-resolution arrays, untouched — the
        on-device resampler then draws from the complete point set, exactly
        like the reference. Ragged pts layout: rectangularized once to
        ``2 * num_points`` (a one-time host draw; the per-batch device draw
        then resamples fresh from that pool every epoch)."""
        if not self._ragged:
            return self.points, self.part_labels, self.category
        return self.as_arrays(2 * num_points, seed)


def make_synthetic_shapenet(root: str, num_shapes: int = 64,
                            num_points: int = 2048, seed: int = 0,
                            layout: str = "pts",
                            boundary_jitter: float = 0.0,
                            cluster_parts: bool = False,
                            center_jitter: float = 0.25,
                            cluster_sigma: float = 0.18) -> str:
    """Synthetic ShapeNet-part fixtures (pts layout by default; the JAX
    package's default is h5).

    GENERALIZABLE by construction, not just overfittable: every category
    has a fixed constellation of Gaussian blobs (category-seeded anchor
    centers), and each shape samples its points around those anchors —
    so the category (which selects the part-label range AND the labeling
    axis) is recoverable from the geometry by a global-feature encoder
    on UNSEEN shapes. Part labels stay spatially coherent (quantized
    position along a category-dependent axis). Before round 3 the clouds
    were i.i.d. Gaussians: the category was unknowable from points, so
    segmenters could only memorize the train shapes (92% train acc,
    ~2% test mIoU measured) — useless for any train-vs-eval comparison,
    e.g. the adversarial-gain ablation.

    ``cluster_parts=True`` switches the LABELING to the
    cluster-assumption regime of the semi-supervised literature: each
    shape draws one Gaussian blob per part (category anchor +
    ``center_jitter`` per-shape offset) and the part label IS blob
    membership. Part boundaries then lie in density valleys and the
    position->part map varies per shape (only resolvable from the
    shape's own cluster structure), so unlabeled clouds genuinely carry
    the structure the semi/adversarial losses are meant to exploit —
    unlike the default axis-quantized labels, which cut straight through
    the blobs, or ``boundary_jitter``, which adds noise no method can
    recover (the offset is independent of the geometry).
    ``boundary_jitter`` applies only to the axis-quantized mode.
    """
    assert not (cluster_parts and boundary_jitter > 0.0), (
        "boundary_jitter applies to axis-quantized labels only")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, NUM_CATEGORIES, size=num_shapes).astype(np.int32)
    if cluster_parts:
        kmax = int(CATEGORY_PART_RANGES[:, 1].max())
        panchor_rng = np.random.default_rng(54321)
        panchors = panchor_rng.uniform(
            -1.0, 1.0, (NUM_CATEGORIES, kmax, 3)).astype(np.float32)
        pts = np.empty((num_shapes, num_points, 3), np.float32)
        pids = np.empty((num_shapes, num_points), np.int32)
        for i, cat in enumerate(cats):
            start, count = CATEGORY_PART_RANGES[cat]
            centers = (panchors[cat, :count] + center_jitter
                       * rng.standard_normal((count, 3)).astype(np.float32))
            blob_i = rng.integers(0, count, num_points)
            # Default σ=0.18 vs ~1.1 typical inter-anchor distance: blobs
            # stay identifiable from density while overlapping enough
            # that a position-only rule misassigns boundary points.
            # ``cluster_sigma`` raises/lowers the overlap — the
            # boundary-ambiguity knob for the adversarial-gain fixture
            # ladder (round-5 rung: more ambiguity = more room for a
            # label-map prior to beat plain CE).
            pts[i] = centers[blob_i] + cluster_sigma * rng.standard_normal(
                (num_points, 3)).astype(np.float32)
            pids[i] = start + blob_i
        norm = np.max(np.linalg.norm(pts, axis=-1, keepdims=True), 1,
                      keepdims=True)
        pts /= np.maximum(norm, 1e-12)
        return _write_shapenet_fixture(root, layout, pts, cats, pids,
                                       num_shapes)
    # Per-category blob constellation: K anchors drawn once from a
    # category-seeded stream (shapes of one category share them).
    n_blobs = 4
    anchor_rng = np.random.default_rng(12345)
    anchors = anchor_rng.uniform(-1.0, 1.0,
                                 (NUM_CATEGORIES, n_blobs, 3)).astype(
                                     np.float32)
    blob = rng.integers(0, n_blobs, size=(num_shapes, num_points))
    noise = 0.25 * rng.standard_normal(
        (num_shapes, num_points, 3)).astype(np.float32)
    pts = anchors[cats[:, None], blob] + noise
    norm = np.max(np.linalg.norm(pts, axis=-1, keepdims=True), 1, keepdims=True)
    pts /= np.maximum(norm, 1e-12)
    pids = np.empty((num_shapes, num_points), np.int32)
    offs = (rng.uniform(-0.5, 0.5, num_shapes).astype(np.float32)
            * boundary_jitter if boundary_jitter > 0.0
            else np.zeros(num_shapes, np.float32))
    for i, cat in enumerate(cats):
        start, count = CATEGORY_PART_RANGES[cat]
        axis = int(cat) % 3
        u = (pts[i, :, axis] + 1.0) / 2.0 + offs[i] / count
        q = np.clip((u * count).astype(np.int32), 0, count - 1)
        pids[i] = start + q
    return _write_shapenet_fixture(root, layout, pts, cats, pids,
                                   num_shapes)


def _write_shapenet_fixture(root, layout, pts, cats, pids,
                            num_shapes) -> str:
    """Write a generated fixture in the h5, npz or pts on-disk layout
    (shared by the axis-quantized and cluster-parts modes)."""
    splits = (("train", slice(0, int(0.75 * num_shapes))),
              ("val", slice(int(0.75 * num_shapes), int(0.875 * num_shapes))),
              ("test", slice(int(0.875 * num_shapes), num_shapes)))
    if layout == "npz":
        for split, sl in splits:
            np.savez(os.path.join(root, f"ply_data_{split}0.npz"),
                     data=pts[sl], label=cats[sl].reshape(-1, 1),
                     pid=pids[sl])
        return root
    if layout == "h5":
        import h5py  # the h5 layout only

        for split, sl in splits:
            with h5py.File(os.path.join(root, f"ply_data_{split}0.h5"),
                           "w") as f:
                f.create_dataset("data", data=pts[sl])
                f.create_dataset("label", data=cats[sl].reshape(-1, 1))
                f.create_dataset("pid", data=pids[sl])
        return root
    # pts layout: per-shape text files + JSON split lists + synset map.
    synsets = [f"{10000000 + i:08d}" for i in range(NUM_CATEGORIES)]
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        for name, synset in zip(CATEGORY_NAMES, synsets):
            f.write(f"{name}\t{synset}\n")
    os.makedirs(os.path.join(root, "train_test_split"), exist_ok=True)
    for split, sl in splits:
        entries = []
        for i in range(sl.start if sl.start else 0, sl.stop):
            synset = synsets[cats[i]]
            token = f"shape{i:04d}"
            pdir = os.path.join(root, synset, "points")
            ldir = os.path.join(root, synset, "points_label")
            os.makedirs(pdir, exist_ok=True)
            os.makedirs(ldir, exist_ok=True)
            np.savetxt(os.path.join(pdir, token + ".pts"), pts[i],
                       fmt="%.6f")
            # .seg files are 1-based within the category.
            local = pids[i] - CATEGORY_PART_RANGES[cats[i], 0] + 1
            np.savetxt(os.path.join(ldir, token + ".seg"), local, fmt="%d")
            entries.append(f"shape_data/{synset}/{token}")
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(entries, f)
    return root
