"""Full training runs of the five configs — the engine behind the CLIs
``train_classification``, ``train_segmentation``, ``train_adversarial``,
``train_adv_perturb`` and the eval CLIs (SURVEY.md §2.6; call stack
§3.1).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/train/
runner.py``: ``run_classification`` (configs 1-2), ``run_segmentation``
(config 3), ``run_adversarial`` (config 4) and ``run_adv_perturb``
(config 5). Each loads its data (ModelNet40 or ShapeNet-part; a
synthetic fixture when ``cfg.dataset`` is empty), iterates epochs with
prefetched batches, runs
the eval every ``cfg.eval_every`` epochs, checkpoints under
``cfg.ckpt_policy`` and logs CSV/stdout metrics with the points/s meter,
on ``device`` (the card unless the caller asks for the CPU). By default
(``cfg.device_data``) the train and test pools live on the device and
the host sends index vectors; ``--host_data`` streams assembled batches.
Both read the same permutation streams (``data/loader.py``), so the same
rows reach each step. ``--scan K`` takes K steps per call on K-stacked
batches.

How the port differs from the JAX package's runner:
- the train steps update the state in place and return their metrics;
- ``--fused_epoch`` raises (ROADMAP Queue 1 item 5), and there is one
  device, so no mesh;
- the default ShapeNet-part fixture is in the pts layout, in a directory
  of its own (``data/shapenet_part.py``); the default ModelNet40 fixture
  is made in memory (``data/modelnet40.synthetic_modelnet``: the arrays
  the JAX package's h5 fixture holds), with no file;
- a ``--resume_full`` run continues at the checkpoint's next epoch (the
  step count over the steps per epoch), with the unlabeled stream of
  config 4 advanced to where it stood, so it repeats the uninterrupted
  run's epochs; the JAX package's restarts its epoch count at 0;
- an epoch's ``train_s`` ends when the card has finished the epoch's
  launches (the JAX package's ends when the host has queued them, up to
  ``log_lag`` launches earlier, whose device time then falls in
  ``eval_s``).
"""

from __future__ import annotations

import itertools
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from adversarial_learning_on_pointclouds_tpu_torch import eval as eval_lib
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig, AdvPerturbConfig, ClassifyConfig, SegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.data import (
    augment as aug_lib, loader, native_loader,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.loader import (
    num_batches,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.modelnet40 import (
    ModelNet40, synthetic_modelnet,
)
from adversarial_learning_on_pointclouds_tpu_torch.data.shapenet_part import (
    ShapeNetPart, make_synthetic_shapenet,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    adv_perturb, adversarial, classify, segment, state as state_lib,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import checkpoint
from adversarial_learning_on_pointclouds_tpu_torch.utils.logging import (
    MetricLogger,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils.profiling import (
    maybe_trace,
)

SYNTHETIC_DIR = "pointtpu_torch_shapenet_pts"


def default_fixture(num_points: int) -> str:
    """The synthetic ShapeNet-part fixture of a run without ``--dataset``:
    96 shapes of ``num_points`` points in the pts layout, in a directory
    of the temporary directory named for the point count, written once
    per point count (into a fresh directory renamed into place, so
    concurrent runs never read a partial fixture)."""
    name = f"{SYNTHETIC_DIR}_{num_points}"
    root = os.path.join(tempfile.gettempdir(), name)
    if os.path.isdir(root) and os.listdir(root):
        return root
    tmp = tempfile.mkdtemp(prefix=name + ".", dir=os.path.dirname(root))
    make_synthetic_shapenet(tmp, num_shapes=96, num_points=num_points)
    try:
        os.rename(tmp, root)
    except OSError:  # another run put its fixture in place first
        shutil.rmtree(tmp, ignore_errors=True)
    return root


def _subsample(points: np.ndarray, num_points: int, seed: int) -> np.ndarray:
    """One seeded host subsample of every cloud to ``num_points`` (the
    same point indices for all; with replacement when the clouds are
    smaller)."""
    if points.shape[1] == num_points:
        return points
    rng = np.random.default_rng(seed)
    idx = rng.choice(points.shape[1], num_points,
                     replace=points.shape[1] < num_points)
    return points[:, idx]


def _modelnet_arrays(cfg, eval_split: str = "test"):
    """``(x_tr, y_tr, x_te, y_te)``: the train pool at the source
    resolution when ``cfg.resample`` (the step draws a fixed-N subsample
    per batch on the device, the reference's per-``__getitem__`` draw),
    else one seeded host subsample; the eval split (``test``, or the eval
    CLIs' ``--split``) normalized over all its points, then one seeded
    subsample. Without ``cfg.dataset`` the synthetic fixture, in memory.
    Says on stdout which served the data."""
    if cfg.dataset:
        train = ModelNet40(cfg.dataset, "train")
        test = ModelNet40(cfg.dataset, eval_split)
        x_tr, y_tr, x_te, y_te = (train.points, train.labels, test.points,
                                  test.labels)
        src = f"{cfg.dataset} (h5)"
    else:
        x_tr, y_tr, x_te, y_te = synthetic_modelnet()
        splits = {"train": (x_tr, y_tr), "test": (x_te, y_te)}
        if eval_split not in splits:
            raise FileNotFoundError(f"the synthetic ModelNet40 fixture has "
                                    f"no {eval_split} split")
        x_te, y_te = splits[eval_split]
        src = "the synthetic fixture (in memory)"
    if not cfg.resample:
        x_tr = _subsample(x_tr, cfg.num_points, cfg.seed)
    if cfg.normalize:
        x_te = aug_lib.normalize_unit_sphere_np(x_te)
    x_te = _subsample(x_te, cfg.num_points, cfg.seed + 1)
    print(f"[data] ModelNet40 {src}: {len(x_tr)} train, {len(x_te)} "
          f"{eval_split} shapes of {x_tr.shape[1]} points", flush=True)
    return x_tr, y_tr, x_te, y_te


def _shapenet_arrays(cfg, eval_split: str = "test"):
    """``((x_tr, s_tr, c_tr), (x_te, s_te, c_te))``: the train pool (at
    least the source resolution when ``cfg.resample``, the step draws a
    fixed-N subsample per batch on the device; else one seeded host
    subsample) and the eval split prepared on the host (one seeded
    subsample, then unit-sphere normalized). Says on stdout which layout
    and loader served the data."""
    root = cfg.dataset or default_fixture(cfg.num_points)
    train = ShapeNetPart(root, "train", class_choice=cfg.class_choice)
    try:
        test = ShapeNetPart(root, eval_split, class_choice=cfg.class_choice)
    except (FileNotFoundError, OSError):
        if eval_split != "test":
            raise  # an explicitly requested --split must exist
        test = train
    if cfg.resample:
        tr = train.as_pool_arrays(cfg.num_points, seed=cfg.seed)
    else:
        tr = train.as_arrays(cfg.num_points, seed=cfg.seed)
    x_te, s_te, c_te = test.as_arrays(cfg.num_points, seed=cfg.seed + 1)
    if cfg.normalize:
        x_te = aug_lib.normalize_unit_sphere_np(x_te)
    how = (f"pts layout, {native_loader.last_loader()} loader"
           if train._ragged else "h5 or npz layout")
    print(f"[data] ShapeNet-part {root}: {len(tr[0])} train, {len(x_te)} "
          f"{eval_split} shapes ({how})", flush=True)
    return tr, (x_te, s_te, c_te)


def _setup(device) -> torch.device:
    """The run's device (a card raises when there is none), with fp32
    matmuls kept exact."""
    device = state_lib.train_device(device)
    core.exact_fp32()
    return device


def _epoch_end(device) -> float:
    """The host clock once the device has finished the epoch's launches,
    so that ``train_s`` covers the epoch's device work and not only its
    enqueueing."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _prefetch_depth(cfg) -> int:
    """``--workers N`` -> host prefetch depth (N batches staged ahead of
    consumption; the reference's ``num_workers`` analogue). 0 keeps the
    default double-buffering of 2."""
    return cfg.workers if cfg.workers > 0 else 2


def _resume(cfg, state, spe: int) -> int:
    """Apply ``--model`` to ``state`` in place; returns the first epoch to
    run: the checkpoint's next one under ``--resume_full``, else 0."""
    if not cfg.resume:
        return 0
    if cfg.resume_full:
        checkpoint.restore(cfg.resume, state)
        return state.step // max(spe, 1)
    checkpoint.load_params_only(cfg.resume, state)
    return 0


def _single_net_epoch(cfg, mod, state, tx, epoch, device, logger, spe,
                      pts_per_step, step_h, pools=None,
                      arrays=None) -> int:
    """One training epoch of a single-network trainer (configs 1, 2, 3,
    5).

    Default (``cfg.device_data``): the train pools live on the device
    (``pools = (pool_x, pool_y, n)``), the host streams ``[B]`` int32
    index vectors and ``mod.train_step_gather`` selects the rows there;
    with ``--scan K`` the stacked ``[K, B]`` index groups go to
    ``mod.train_steps_scan_gather``. ``--host_data`` streams assembled
    batches from ``arrays`` instead (stacked groups go to
    ``mod.train_steps_scan``). Both consume the same permutation stream.

    ``step_h`` is the host-side step counter (initial step + batches
    consumed), so logging needs no device readback. Returns the new
    ``step_h``; the state is updated in place."""
    if cfg.device_data:
        pool_x, pool_y, n = pools
        src = ((i,) for i in loader.host_index_iterator(
            n, cfg.batch_size, seed=cfg.seed, epoch=epoch))
    else:
        src = loader.host_batch_iterator(arrays, cfg.batch_size,
                                         seed=cfg.seed, epoch=epoch)
    bi = 0
    for batch, stacked in loader.device_batches(
            src, device, k_stack=cfg.scan, prefetch=_prefetch_depth(cfg)):
        if stacked:
            if cfg.device_data:
                ms = mod.train_steps_scan_gather(
                    state, pool_x, pool_y, batch[0], cfg=cfg, tx=tx)
            else:
                ms = mod.train_steps_scan(state, *batch, cfg=cfg, tx=tx)
            k = batch[0].shape[0]
            step_h += k
            logger.log_scan_steps(epoch, bi, spe, step_h, ms, k,
                                  pts_per_step)
            bi += k
            continue
        if cfg.device_data:
            m = mod.train_step_gather(state, pool_x, pool_y, batch[0],
                                      cfg=cfg, tx=tx)
        else:
            m = mod.train_step(state, *batch, cfg=cfg, tx=tx)
        step_h += 1
        logger.log_step(epoch, bi, spe, step_h, m, pts_per_step)
        bi += 1
    return step_h


def _eval_epoch(cfg, epoch: int, epochs: int) -> bool:
    """``--eval_every K``: evaluate (and emit the epoch row / feed the
    checkpoint-selection metric) on every K-th epoch and ALWAYS on the
    final one. K=1 is the reference's eval-every-epoch. Non-eval epochs
    skip the epoch row entirely (the epoch CSV schema is fixed by its
    first row) and skip the save only under the ``best`` policy (which
    cannot rank an epoch it never measured)."""
    k = max(cfg.eval_every, 1)
    return (epoch + 1) % k == 0 or epoch == epochs - 1


def _skip_eval_epoch(cfg, saver, epoch, state):
    """Bookkeeping for a skipped-eval epoch (see ``_eval_epoch``)."""
    if cfg.ckpt_policy != "best":
        saver.save(cfg.out_dir, epoch, state)


def _evaluate(cfg, model, pools_te, x_te, s_te, c_te):
    """The segmenter's eval, in ``cfg.bf16``'s mixed-precision scope (the
    JAX package's runner evaluates inside it too)."""
    with core.mixed_precision(enabled=cfg.bf16):
        if cfg.device_data:
            return eval_lib.evaluate_segmenter_device(
                model, *pools_te, s_te, c_te, cfg.batch_size)
        return eval_lib.evaluate_segmenter(model, x_te, s_te, c_te,
                                           cfg.batch_size)


def _evaluate_classifier(cfg, model, pool_te, x_te, y_te):
    """The classifier's accuracy eval, in ``cfg.bf16``'s scope."""
    with core.mixed_precision(enabled=cfg.bf16):
        if cfg.device_data:
            return eval_lib.evaluate_classifier_device(
                model, pool_te, y_te, cfg.batch_size, cfg.num_classes)
        return eval_lib.evaluate_classifier(
            model, x_te, y_te, cfg.batch_size, cfg.num_classes)


def _run_classifier(cfg, mod, name: str, epochs: Optional[int],
                    device) -> dict:
    """The classifier's run of ``mod`` (``classify`` or ``adv_perturb``):
    its steps on ModelNet40, the accuracy eval, checkpoints and logs."""
    epochs = epochs if epochs is not None else cfg.epochs
    x_tr, y_tr, x_te, y_te = _modelnet_arrays(cfg)
    device = _setup(device)
    spe = num_batches(len(x_tr), cfg.batch_size)
    tx = mod.make_tx(cfg, spe)
    state = mod.create_state(cfg, spe, device=device)
    start = _resume(cfg, state, spe)
    logger = MetricLogger(cfg.out_dir, name, quiet=cfg.quiet, lag=cfg.log_lag)
    pts_per_step = cfg.batch_size * cfg.num_points
    best = 0.0
    pools = pool_te = None
    if cfg.device_data:
        (pool_te,) = loader.to_device((x_te,), device)
        pools = (*loader.to_device((x_tr, y_tr), device), len(y_tr))
    with maybe_trace(cfg.profile_dir), \
            checkpoint.AsyncSaver(cfg.ckpt_policy) as saver:
        step_h = state.step
        for epoch in range(start, epochs):
            t0 = time.perf_counter()
            step_h = _single_net_epoch(
                cfg, mod, state, tx, epoch, device, logger, spe,
                pts_per_step, step_h, pools=pools, arrays=(x_tr, y_tr))
            t1 = _epoch_end(device)
            if not _eval_epoch(cfg, epoch, epochs):
                _skip_eval_epoch(cfg, saver, epoch, state)
                continue
            ev = _evaluate_classifier(cfg, state.model, pool_te, x_te, y_te)
            best = max(best, ev["accuracy"])
            t2 = time.perf_counter()
            saver.save(cfg.out_dir, epoch, state, metric=ev["accuracy"])
            logger.log_epoch(epoch, **ev, train_s=t1 - t0, eval_s=t2 - t1,
                             ckpt_s=time.perf_counter() - t2)
    logger.close()
    return {"best_accuracy": best, "state": state}


def run_classification(cfg: ClassifyConfig, epochs: Optional[int] = None,
                       device="cuda") -> dict:
    """Configs 1-2: mirrors ``upstream:train_classification.py``."""
    return _run_classifier(cfg, classify, "cls", epochs, device)


def run_adv_perturb(cfg: AdvPerturbConfig, epochs: Optional[int] = None,
                    device="cuda") -> dict:
    """Config 5: FGSM (or PGD) perturbation training on one device."""
    return _run_classifier(cfg, adv_perturb, "advp", epochs, device)


def run_segmentation(cfg: SegmentConfig, epochs: Optional[int] = None,
                     device="cuda") -> dict:
    """Config 3: mirrors ``upstream:train_segmentation.py``."""
    epochs = epochs if epochs is not None else cfg.epochs
    (x_tr, s_tr, c_tr), (x_te, s_te, c_te) = _shapenet_arrays(cfg)
    device = _setup(device)
    spe = num_batches(len(x_tr), cfg.batch_size)
    tx = segment.make_tx(cfg, spe)
    state = segment.create_state(cfg, spe, device=device)
    start = _resume(cfg, state, spe)
    logger = MetricLogger(cfg.out_dir, "seg", quiet=cfg.quiet, lag=cfg.log_lag)
    pts_per_step = cfg.batch_size * cfg.num_points
    best = 0.0
    table: dict = {}
    pools = pools_te = None
    if cfg.device_data:
        pools_te = loader.to_device((x_te, s_te, c_te), device)
        pools = (*loader.to_device((x_tr, s_tr), device), len(s_tr))
    with maybe_trace(cfg.profile_dir), \
            checkpoint.AsyncSaver(cfg.ckpt_policy) as saver:
        step_h = state.step
        for epoch in range(start, epochs):
            t0 = time.perf_counter()
            step_h = _single_net_epoch(
                cfg, segment, state, tx, epoch, device, logger, spe,
                pts_per_step, step_h, pools=pools,
                arrays=(x_tr, s_tr))
            t1 = _epoch_end(device)
            if not _eval_epoch(cfg, epoch, epochs):
                _skip_eval_epoch(cfg, saver, epoch, state)
                continue
            ev, table = _evaluate(cfg, state.model, pools_te, x_te, s_te,
                                  c_te)
            best = max(best, ev["instance_miou"])
            t2 = time.perf_counter()
            saver.save(cfg.out_dir, epoch, state,
                       metric=ev["instance_miou"])
            logger.log_epoch(epoch, **ev, train_s=t1 - t0, eval_s=t2 - t1,
                             ckpt_s=time.perf_counter() - t2)
    logger.close()
    return {"best_miou": best, "state": state, "category_miou": table}


def run_adversarial(cfg: AdversarialConfig, epochs: Optional[int] = None,
                    device="cuda") -> dict:
    """Config 4: mirrors ``upstream:train_adversarial*.py`` — labeled/
    unlabeled split by ``labeled_ratio``, one G update and one D update
    per step, semi-supervised masked loss.

    Stream semantics follow the reference: one pass over the LABELED split
    defines an epoch; the unlabeled stream shuffles and cycles
    independently, its position persisting across epochs (the reference's
    iterator-reset-on-StopIteration pattern). With ``cfg.scan = K > 1``,
    K steps run per call on K-batch stacked transfers."""
    epochs = epochs if epochs is not None else cfg.epochs
    (x_tr, s_tr, c_tr), (x_te, s_te, c_te) = _shapenet_arrays(cfg)
    n_lab = max(int(len(x_tr) * cfg.labeled_ratio), cfg.batch_size)
    device = _setup(device)
    spe = max(num_batches(n_lab, cfg.batch_size), 1)
    g_tx, d_tx = adversarial.make_txs(cfg, spe)
    state = adversarial.create_state(cfg, spe, device=device)
    start = _resume(cfg, state, spe)
    logger = MetricLogger(cfg.out_dir, "adv", quiet=cfg.quiet, lag=cfg.log_lag)
    pts_per_step = 2 * cfg.batch_size * cfg.num_points
    best = 0.0
    x_unl = x_tr[n_lab:]
    if len(x_unl) < cfg.batch_size:
        print(f"[runner] WARNING: labeled_ratio={cfg.labeled_ratio} leaves "
              f"{len(x_unl)} unlabeled shapes (<1 batch); cycling the full "
              "train set (labeled included) as the unlabeled stream",
              file=sys.stderr)
        x_unl = x_tr
    # Infinite unlabeled stream, created ONCE (its position persists
    # across epochs, like the reference's cycled iterator); a full resume
    # advances it past the steps already taken.
    pools_te = None
    if cfg.device_data:
        pool_x, pool_y, pool_u = loader.to_device(
            (x_tr[:n_lab], s_tr[:n_lab], x_unl), device)
        pools_te = loader.to_device((x_te, s_te, c_te), device)
        unl_stream = loader.cycling_host_indices(
            len(x_unl), cfg.batch_size, seed=cfg.seed + 1)
    else:
        unl_stream = loader.cycling_host_batches((x_unl,), cfg.batch_size,
                                                 seed=cfg.seed + 1)
    next(itertools.islice(unl_stream, state.step, state.step), None)
    table: dict = {}
    txs = dict(cfg=cfg, g_tx=g_tx, d_tx=d_tx)
    with maybe_trace(cfg.profile_dir), \
            checkpoint.AsyncSaver(cfg.ckpt_policy) as saver:
        step_h = state.step
        for epoch in range(start, epochs):
            t0 = time.perf_counter()
            if cfg.device_data:
                lab_idx = loader.host_index_iterator(
                    n_lab, cfg.batch_size, seed=cfg.seed, epoch=epoch)
                paired = zip(lab_idx, unl_stream)
            else:
                lab_host = loader.host_batch_iterator(
                    (x_tr[:n_lab], s_tr[:n_lab]), cfg.batch_size,
                    seed=cfg.seed, epoch=epoch)
                paired = ((xl, yl, xu) for (xl, yl), (xu,)
                          in zip(lab_host, unl_stream))
            bi = 0
            for batch, stacked in loader.device_batches(
                    paired, device, k_stack=cfg.scan,
                    prefetch=_prefetch_depth(cfg)):
                if cfg.device_data:
                    step = (adversarial.train_steps_scan_gather if stacked
                            else adversarial.train_step_gather)
                    m = step(state, pool_x, pool_y, pool_u, *batch, **txs)
                else:
                    step = (adversarial.train_steps_scan if stacked
                            else adversarial.train_step)
                    m = step(state, *batch, **txs)
                if stacked:
                    k = batch[0].shape[0]
                    step_h += k
                    logger.log_scan_steps(epoch, bi, spe, step_h, m, k,
                                          pts_per_step)
                    bi += k
                else:
                    step_h += 1
                    logger.log_step(epoch, bi, spe, step_h, m,
                                    pts_per_step)
                    bi += 1
            t1 = _epoch_end(device)
            if not _eval_epoch(cfg, epoch, epochs):
                _skip_eval_epoch(cfg, saver, epoch, state)
                continue
            ev, table = _evaluate(cfg, state.g_model, pools_te, x_te, s_te,
                                  c_te)
            best = max(best, ev["instance_miou"])
            t2 = time.perf_counter()
            saver.save(cfg.out_dir, epoch, state,
                       metric=ev["instance_miou"])
            t3 = time.perf_counter()
            logger.log_epoch(epoch, **ev, train_s=t1 - t0, eval_s=t2 - t1,
                             ckpt_s=t3 - t2)
    logger.close()
    return {"best_miou": best, "state": state, "category_miou": table}
