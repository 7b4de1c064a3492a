"""Rank functions that run the trainers' steps under data parallelism and
point sharding and report what they did, for the checks that hold W ranks
against one (``dryrun_multichip.py``, ``multihost_check.py``, the tests,
``chip_smoke.py``).

Each function runs in a rank that ``dist.spawn`` started (or in a
process with no group, as world size 1), builds a train state from a
config and, where given, weights (state dicts as numpy arrays), takes
its rows (or points) of a global numpy batch that every rank is given
whole, and returns numpy results that pickle: the step's metrics, every
parameter's gradient after the step (the global one, summed over the
ranks), every BatchNorm buffer after it, whether every rank holds the
same parameters and buffers bit for bit, the kernels' launches of the
step and the collectives it issued (``dist.counts``). It imports torch,
numpy and this package only.
"""

from __future__ import annotations

import csv
import importlib
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from adversarial_learning_on_pointclouds_tpu_torch import configs
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    augment_fused, disc_fused, fc_head_train, maxpool_points,
    pool_fc_epilogue, seg_head_train, shared_mlp, tnet_apply, trunk_train,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist, point
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    adv_perturb, adversarial, classify, segment, state as state_lib,
)

# kind -> (config class, trainer module)
KINDS = {
    "classify": (configs.ClassifyConfig, classify),
    "segment": (configs.SegmentConfig, segment),
    "adversarial": (configs.AdversarialConfig, adversarial),
    "adv_perturb": (configs.AdvPerturbConfig, adv_perturb),
}


def counters() -> Dict[str, dict]:
    """``{kernel: {pass: wrapper}}`` of every training kernel whose
    wrapper counts its launches."""
    return {"trunk2_train": trunk_train.PASSES,
            "seg_head_train": seg_head_train.PASSES,
            "pool_fc_epilogue": {"fwd": pool_fc_epilogue.pool_fc_fwd},
            "disc_fused": disc_fused.PASSES,
            "augment_fused": {"fwd": augment_fused.augment_fused},
            "pointwise_matmul": shared_mlp.PM_PASSES,
            "tnet_apply": tnet_apply.PASSES,
            "maxpool_points": maxpool_points.PASSES,
            "fc_head_train": fc_head_train.PASSES}


def reset_launches() -> None:
    for passes in counters().values():
        for fn in passes.values():
            fn.launches = 0


def launches() -> Dict[str, Dict[str, int]]:
    return {k: {p: fn.launches for p, fn in passes.items()}
            for k, passes in counters().items()}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy().copy()


def models_of(state) -> Dict[str, torch.nn.Module]:
    """The state's networks by name."""
    if hasattr(state, "g_model"):
        return {"g": state.g_model, "d": state.d_model}
    return {"model": state.model}


def report(state, metrics, dev) -> dict:
    """What a rank returns after its steps: ``metrics`` (a list of dicts
    of floats, one a step), ``grads`` and ``buffers`` (``{net: {name:
    array}}``; rank 0 alone, the others hold the same or ``same`` says
    they do not), ``same`` (every parameter and buffer bit-equal on every
    rank), ``launches`` and ``collectives``."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    nets = models_of(state)
    first = dist.rank() == 0
    return {
        "metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
        "grads": {n: {k: _np(p.grad) for k, p in m.named_parameters()
                      if p.grad is not None} for n, m in nets.items()}
        if first else None,
        "buffers": {n: {k: _np(b) for k, b in m.named_buffers()}
                    for n, m in nets.items()} if first else None,
        "same": dist.same_on_every_rank(
            [t for m in nets.values()
             for t in list(m.parameters()) + list(m.buffers())]),
        "launches": launches(),
        "collectives": dist.counts(),
        "rank": dist.rank(),
        "world": dist.world_size(),
    }


def make_state(kind: str, cfg_kw: dict, device, weights=None,
               steps_per_epoch: int = 10):
    """``(cfg, module, state)`` of config ``kind`` from ``cfg_kw``, on this
    rank's device; ``weights`` (``{net: state_dict of arrays}``) replace
    the seeded ones."""
    cfg_cls, mod = KINDS[kind]
    cfg = cfg_cls(**cfg_kw)
    dev = dist.rank_device(device)
    state = mod.create_state(cfg, steps_per_epoch, device=dev)
    if weights:
        for name, net in models_of(state).items():
            net.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v
                                 in weights[name].items()}, strict=True)
        state_lib.replicate(*models_of(state).values())
    return cfg, mod, state


def _txs(kind, mod, cfg, spe):
    if kind == "adversarial":
        g_tx, d_tx = mod.make_txs(cfg, spe)
        return dict(g_tx=g_tx, d_tx=d_tx)
    return dict(tx=mod.make_tx(cfg, spe))


def _tensor(a: np.ndarray, dev) -> torch.Tensor:
    """``a`` on ``dev``, a floating array in the default dtype."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.to(torch.get_default_dtype())
    return t.to(dev)


def _local(a: np.ndarray, dev, labels: bool = False) -> torch.Tensor:
    t = _tensor(dist.shard_rows(a), dev)
    return t.long() if labels else t


def run_steps(kind: str, cfg_kw: dict, batches: Sequence[tuple],
              device="cpu", weights=None, switch: bool = False) -> dict:
    """One ``train_step`` of config ``kind`` per global batch of
    ``batches`` (each a tuple of numpy arrays: ``(points, labels)``, or
    ``(x_l, y_l, x_u)`` for ``adversarial``), on this rank's rows;
    ``switch``: under ``ops.dispatch.use_pallas_train``. Returns
    ``report``."""
    cfg, mod, state = make_state(kind, cfg_kw, device, weights)
    dev = dist.rank_device(device)
    txs = _txs(kind, mod, cfg, 10)
    metrics = []
    reset_launches()
    dist.reset_counts()
    with dispatch.use_pallas_train(switch):
        for batch in batches:
            if kind == "adversarial":
                x_l, y_l, x_u = batch
                metrics.append(mod.train_step(
                    state, _local(x_l, dev), _local(y_l, dev, True),
                    _local(x_u, dev), cfg=cfg, **txs))
            else:
                x, y = batch
                metrics.append(mod.train_step(
                    state, _local(x, dev), _local(y, dev, True), cfg=cfg,
                    **txs))
    return report(state, metrics, dev)


def run_scan(cfg_kw: dict, batches: Sequence[tuple], device="cpu",
             weights=None) -> dict:
    """``adversarial.train_steps_scan`` (``--scan K``) of config 4 on the K
    global batches ``batches`` (each ``(x_l, y_l, x_u)``, stacked into
    ``[K, B, ...]``), each rank its rows of every one. Returns ``report``
    with one metrics dict a step."""
    cfg, mod, state = make_state("adversarial", cfg_kw, device, weights)
    dev = dist.rank_device(device)
    x_l, y_l, x_u = (_tensor(dist.shard_rows(np.stack([b[i] for b in batches]),
                                             dim=1), dev) for i in range(3))
    reset_launches()
    dist.reset_counts()
    ms = mod.train_steps_scan(state, x_l, y_l.long(), x_u, cfg=cfg,
                              **_txs("adversarial", mod, cfg, 10))
    return report(state, [{k: v[i] for k, v in ms.items()}
                          for i in range(len(batches))], dev)


def run_fused_epoch(kind: str, cfg_kw: dict, pools: tuple, idx: tuple,
                    test: tuple, te_idx: np.ndarray, device="cpu",
                    weights=None) -> dict:
    """One ``epoch_program`` (``--fused_epoch``) of config ``kind``: the
    global index plans ``idx`` (``([spe, B],)``, or ``(idx_l, idx_u)``
    for ``adversarial``) into the train ``pools`` and the ``[S, B]`` eval
    plan ``te_idx`` into the ``test`` pools (a tuple: the eval scan's
    pool arguments), all on every rank whole.
    Returns ``report`` with ``eval``, the eval outputs (arrays)."""
    spe = len(idx[0])
    cfg, mod, state = make_state(kind, cfg_kw, device, weights, spe)
    dev = dist.rank_device(device)
    txs = _txs(kind, mod, cfg, spe)
    pools = tuple(_tensor(p, dev) for p in pools)
    test = tuple(_tensor(t, dev) for t in test)
    idx = tuple(_tensor(i, dev) for i in idx)
    te_idx = _tensor(te_idx, dev)
    reset_launches()
    dist.reset_counts()
    if kind == "adversarial":
        ms, ev = mod.epoch_program(state, *pools, *idx, *test, te_idx,
                                   cfg=cfg, **txs)
    else:
        ms, ev = mod.epoch_program(state, *pools, *idx, test, te_idx,
                                   cfg=cfg, **txs)
    out = report(state, [{k: v[i] for k, v in ms.items()}
                         for i in range(len(idx[0]))], dev)
    out["eval"] = ({k: _np(v) for k, v in ev.items()}
                   if isinstance(ev, dict) else _np(ev))
    return out


def run_point_train(cfg_kw: dict, x: np.ndarray, y: np.ndarray,
                    device="cpu", weights=None) -> dict:
    """One ``point.point_sharded_train_step`` of the segmenter (config 3,
    ``cfg_kw``) on ``x [B, N, 3]`` and ``y [B, N]``, each rank its points.
    Returns ``report``."""
    cfg, mod, state = make_state("segment", cfg_kw, device, weights)
    dev = dist.rank_device(device)
    reset_launches()
    dist.reset_counts()
    m = point.point_sharded_train_step(state, _tensor(x, dev),
                                       _tensor(y, dev).long(), cfg=cfg,
                                       tx=mod.make_tx(cfg, 10))
    return report(state, [m], dev)


def run_point_eval(kind: str, cfg_kw: dict, x: np.ndarray, device="cpu",
                   weights=None, per_point: Optional[bool] = None
                   ) -> np.ndarray:
    """``point.point_sharded_eval`` of config ``kind``'s model on ``x``
    (the whole output, on every rank)."""
    _, _, state = make_state(kind, cfg_kw, device, weights)
    net = next(iter(models_of(state).values()))
    return _np(point.point_sharded_eval(
        net, _tensor(x, dist.rank_device(device)), per_point))


def run_many(calls: Sequence[tuple]) -> dict:
    """Several of this module's rank functions in one rank (one spawn for
    many checks): ``calls`` are ``(name, function, kwargs, dtype)``;
    returns ``{name: result}``. ``dtype`` ``"float64"`` builds the models
    and batches of that call in float64 (the default dtype for its
    duration), where the rounding of sums in another order, which moves
    fp32 gradients of this model by up to 1e-2 of their scale at world
    size 1 alone, drops below 1e-13."""
    out = {}
    prev = torch.get_default_dtype()
    for name, fn, kwargs, dtype in calls:
        torch.set_default_dtype(getattr(torch, dtype))
        try:
            out[name] = fn(**kwargs)
        finally:
            torch.set_default_dtype(prev)
    return out


def eval_forward(kind: str, cfg_kw: dict, x: np.ndarray, device="cpu",
                 weights=None) -> np.ndarray:
    """The eval forward (first output) of config ``kind``'s model on the
    whole ``x`` in one process, the reference ``point_sharded_eval`` is
    held to."""
    _, _, state = make_state(kind, cfg_kw, device, weights)
    net = next(iter(models_of(state).values()))
    with segment.eval_mode(net):
        return _np(net(_tensor(x, dist.rank_device(device)))[0])


def with_fault(fault: str, fn, kwargs: dict):
    """``fn(**kwargs)`` with a fault planted for its duration, for the
    checks that must catch it:

    * ``"local_bn"``: every BatchNorm statistic is the rank's own batch's
      (no all-reduce of the sums, the local count, the T-Net heads on the
      local rows), the losses still the ranks' shares of the global ones;
    * ``"replicated_w_times"``: a term computed on replicated values (the
      orthogonality regularizer of a point-sharded step) enters the sum
      once on every rank, W times in all."""
    saved = []

    def patch(module, name, value):
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    w = dist.world_size()
    if fault == "local_bn":
        patch(dist, "mean_share", lambda t: t.sum() / (t.numel() * w))
        patch(dist, "reduce_sum", lambda x, per_point, name="stats": x)
        patch(dist, "count", lambda m, per_point: m)
        patch(dist, "gather_rows", lambda x, groups=1: x)
        patch(dist, "own_rows", lambda y, groups=1: y)
        for module in (seg_head_train, trunk_train):
            patch(module, "global_sums", lambda *sums: sums)
    elif fault == "replicated_w_times":
        share = dist.mean_share
        patch(dist, "mean_share", lambda t: t.mean() if (
            dist.points_sharded() and t.dim() < 2) else share(t))
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        return fn(**kwargs)
    finally:
        for module, name, value in reversed(saved):
            setattr(module, name, value)


def run_cli(module: str, argv: Sequence[str], out_dir: str) -> dict:
    """A trainer CLI's ``main(argv)`` (``module``) in this rank: its
    result (without the state) and, from rank 0, the rows of the CSV
    files it wrote to ``out_dir`` (``{file name: rows}``)."""
    result = importlib.import_module(module).main(list(argv))
    out = {"result": {k: v for k, v in result.items() if k != "state"},
           "rank": dist.rank(), "csv": None}
    if dist.rank() == 0:
        out["csv"] = {}
        for name in sorted(os.listdir(out_dir)):
            if name.endswith(".csv"):
                with open(os.path.join(out_dir, name), newline="") as f:
                    out["csv"][name] = list(csv.DictReader(f))
    return out


def error_of(fn, kwargs: dict) -> Optional[str]:
    """``fn(**kwargs)``'s exception as ``"Type: message"``, or None (a
    refusal checked in a rank)."""
    try:
        fn(**kwargs)
    except Exception as e:      # the refusal under test, reported back
        return f"{type(e).__name__}: {e}"
    return None
