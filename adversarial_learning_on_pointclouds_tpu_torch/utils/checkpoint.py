"""Checkpoint / resume, and reference-format ``.pth`` loading.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/utils/
checkpoint.py`` (SURVEY.md §5 "Checkpoint / resume"). The reference
``torch.save``s the model state_dict each epoch and warm-starts
params-only via ``--model path.pth`` (optimizer state is NOT saved in the
lineage). Here, as in the JAX package, the default is stronger: the
FULL train state round-trips through step-numbered directories,
``ckpt_dir/<step>/state.pt``, one ``torch.save`` file of state_dicts:
the models (parameters and BatchNorm running statistics), the torch
optimizers and their schedules, the augmentation generator's state,
``step`` and ``device_step``. ``load_params_only`` mirrors the
reference's weaker resume (models only), and a ``.pth`` path loads the
reference format, a ``PointNetCls`` or a ``PointNetDenseCls``
(``load_pth_warm_start``, ``load_classifier``, ``load_segmenter``).
``load_saved_classifier`` and ``load_saved_segmenter`` read one model,
from either format, for evaluation.

The port's train steps update parameters and Adam moments in place, so
``save`` and ``AsyncSaver.save`` copy every tensor of the state to the
host before they return; the writer thread only ever sees that copy.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import sys
import threading
from typing import Any, Dict, Optional, Sequence

import torch

from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetCls, PointNetDenseCls,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    state as state_lib,
)

STATE_FILE = "state.pt"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _host(obj):
    """``obj`` with every tensor replaced by a host copy of it (a copy
    also when the tensor already lies on the CPU)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def snapshot(state) -> Dict[str, Any]:
    """A host copy of a ``TrainState`` / ``GANTrainState``: each field's
    state_dict (models, optimizers, schedules), the generator's state and
    the step counts, under the field's name; the ``Optimizer``
    descriptions are left out (the runner rebuilds them from the
    config)."""
    snap: Dict[str, Any] = {"kind": type(state).__name__}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, state_lib.Optimizer):
            continue
        if isinstance(value, torch.Generator):
            snap[f.name] = value.get_state().clone()
        elif hasattr(value, "state_dict"):
            snap[f.name] = _host(value.state_dict())
        else:
            snap[f.name] = _host(value)
    return snap


def _write(ckpt_dir: str, step: int, snap: Dict[str, Any]) -> str:
    path = os.path.join(_abs(ckpt_dir), str(step))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(snap, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def save(ckpt_dir: str, step: int, state) -> str:
    """Save a train state under ``ckpt_dir/<step>``."""
    return _write(ckpt_dir, step, snapshot(state))


class AsyncSaver:
    """Background checkpoint writer: the ``torch.save`` of a state runs
    off the training thread, overlapping the next epoch. ``save`` first
    copies the state to the host (``snapshot``) on the calling thread, so
    the in-place steps that follow cannot tear the checkpoint.
    ``maxsize=1`` gives natural backpressure (a third save blocks until
    the first lands); ``close()`` drains the queue so the final
    checkpoint is durable before the run returns, and re-raises any
    writer-thread failure.

    ``policy`` is the whole ``--ckpt_policy`` knob in one place:

    - ``"every"`` (default, reference semantics): every epoch saved,
      ``maxsize=1`` backpressure.
    - ``"latest"`` (keep-up mode): a save that finds the queue full
      REPLACES the still-queued stale snapshot with the newer one instead
      of blocking; intermediate epochs may be skipped, the FINAL state is
      always durable.
    - ``"best"`` (model-selection mode): save only when the caller's
      ``metric`` improves on the best seen so far, so the newest
      checkpoint on disk is the best-metric epoch (what
      ``restore(step=None)`` loads). A ``save()`` without a metric is
      unconditional.
    - ``"none"`` (sweep mode): ``save()`` is a no-op."""

    def __init__(self, policy: str = "every") -> None:
        assert policy in ("every", "latest", "none", "best"), policy
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._skip = policy == "latest"
        self._off = policy == "none"
        self._best = policy == "best"
        self._best_metric: Optional[float] = None
        self._err: Optional[BaseException] = None
        # Sticky record: set the first time ANY write fails and never
        # cleared, so close() re-surfaces the failure even if a caller
        # caught the save()-time raise and carried on.
        self.had_error: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                _write(*item)
            except BaseException as e:  # re-raised on next save()/close()
                print(f"[AsyncSaver] checkpoint write for step "
                      f"{item[1]} failed: {e!r}", file=sys.stderr,
                      flush=True)
                self._err = e
                if self.had_error is None:
                    self.had_error = e
            finally:
                self._q.task_done()

    def save(self, ckpt_dir: str, step: int, state,
             metric: Optional[float] = None) -> None:
        """Snapshot ``state`` to the host and enqueue its write. ``metric``
        (higher = better) only matters under the ``best`` policy."""
        if self._off:
            return
        if self._best and metric is not None:
            if (self._best_metric is not None
                    and metric <= self._best_metric):
                return
            self._best_metric = float(metric)
        if self._err is not None:
            err, self._err = self._err, None  # raise once, not forever
            raise err
        item = (ckpt_dir, step, snapshot(state))
        if not self._skip:
            self._q.put(item)
            return
        # Keep-up mode: displace a stale queued snapshot rather than
        # block (the pop/put pair races benignly with the writer thread).
        while True:
            try:
                self._q.put_nowait(item)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self._q.task_done()
                except queue.Empty:
                    pass

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        if self.had_error is not None:
            raise RuntimeError(
                "AsyncSaver: an earlier checkpoint write failed (a saved "
                "epoch is missing on disk)") from self.had_error

    def __enter__(self) -> "AsyncSaver":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.close()
        else:  # don't mask the in-flight exception; best-effort drain
            try:
                self.close()
            except BaseException:
                pass
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = _abs(ckpt_dir)
    if not os.path.isdir(d):
        return None
    steps = [int(n) for n in os.listdir(d)
             if n.isdigit() and os.path.exists(os.path.join(d, n, STATE_FILE))]
    return max(steps) if steps else None


def _resolve_path(ckpt_dir: str, step: Optional[int]) -> str:
    """``step=None`` -> the latest checkpoint's directory."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    return os.path.join(_abs(ckpt_dir), str(step))


def _read(ckpt_dir: str, step: Optional[int]) -> Dict[str, Any]:
    path = os.path.join(_resolve_path(ckpt_dir, step), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_fields(state, snap: Dict[str, Any], fields: Sequence[str],
                 ckpt_dir: str) -> None:
    for name in fields:
        if name not in snap:
            raise KeyError(f"the checkpoint ({snap.get('kind')}) has no "
                           f"field {name!r}")
        value, saved = getattr(state, name), snap[name]
        if isinstance(value, torch.Generator):
            value.set_state(saved)
        elif isinstance(value, torch.nn.Module):
            _load_checked(ckpt_dir, value, saved, name)
        elif hasattr(value, "load_state_dict"):
            value.load_state_dict(saved)
        elif isinstance(value, torch.Tensor):
            with torch.no_grad():
                value.copy_(saved)
        else:
            setattr(state, name, saved)


def _check_kind(ckpt_dir: str, state, snap: Dict[str, Any]) -> None:
    if snap.get("kind") != type(state).__name__:
        raise ValueError(f"{ckpt_dir!r} holds a {snap.get('kind')}, not a "
                         f"{type(state).__name__}")


def restore(ckpt_dir: str, state_like, step: Optional[int] = None):
    """Load the full train state from ``ckpt_dir`` into ``state_like`` (in
    place; also returned). ``step=None`` restores the latest checkpoint."""
    if ckpt_dir.endswith(".pth"):
        raise ValueError(
            f"{ckpt_dir!r}: full-state resume cannot load a reference "
            ".pth — the format holds params/BN only (no optimizer state, "
            "step, or generator). Drop --resume_full to warm-start "
            "params-only, the reference's --model semantics.")
    snap = _read(ckpt_dir, step)
    _check_kind(ckpt_dir, state_like, snap)
    _load_fields(state_like, snap, [
        f.name for f in dataclasses.fields(state_like)
        if not isinstance(getattr(state_like, f.name), state_lib.Optimizer)],
        ckpt_dir)
    return state_like


def restore_fields(ckpt_dir: str, state_like, fields: Sequence[str],
                   step: Optional[int] = None) -> Dict[str, Any]:
    """Load only the named fields of the train state (e.g. ``("g_model",)``
    for inference from an adversarial checkpoint, which needs nothing of
    the discriminator) into ``state_like``; returns ``{field: value}``."""
    snap = _read(ckpt_dir, step)
    _load_fields(state_like, snap, fields, ckpt_dir)
    return {name: getattr(state_like, name) for name in fields}


def _model_fields(state) -> list:
    return [f.name for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.nn.Module)]


def load_params_only(ckpt_dir: str, state_like, step: Optional[int] = None):
    """Reference-compat resume: the models (parameters + BN statistics)
    from the checkpoint, the optimizers, schedules, generator and step as
    they are (the lineage's ``--model`` warm start restarts them). A
    ``*.pth`` path loads the reference format (``load_pth_warm_start``)."""
    if ckpt_dir.endswith(".pth"):
        return load_pth_warm_start(ckpt_dir, state_like)
    snap = _read(ckpt_dir, step)
    _check_kind(ckpt_dir, state_like, snap)
    _load_fields(state_like, snap, _model_fields(state_like), ckpt_dir)
    return state_like


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state_dict, on the CPU, loaded without unpickling code."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _check_keys(path: str, sd: dict, like: dict, what: str = "segmenter"
                ) -> None:
    """Raise a readable error when ``sd`` does not fit the model built
    from the flags (wrong ``--num_classes`` / ``--num_parts`` /
    ``--feature_transform`` / ``--d_geometry``)."""
    missing = sorted(set(like) - set(sd))
    extra = sorted(set(sd) - set(like))
    wrong = [f"{k}: {tuple(sd[k].shape)} != {tuple(like[k].shape)}"
             for k in sorted(set(sd) & set(like))
             if tuple(sd[k].shape) != tuple(like[k].shape)]
    if missing or extra or wrong:
        raise ValueError(
            f"{path!r} does not match the {what} built from the flags"
            + (f"; missing {missing[:4]}" if missing else "")
            + (f"; unexpected {extra[:4]}" if extra else "")
            + (f"; shape mismatch {wrong[:4]}" if wrong else "")
            + " - check --feature_transform / --num_classes / --num_parts "
              "/ --d_geometry against how the checkpoint was trained.")


# The top-level key that tells the two reference models apart.
_KIND_KEYS = {"classifier": "fc3.weight", "segmenter": "conv4.weight"}


def _reference_sd(path: str, kind: str) -> Dict[str, torch.Tensor]:
    """A reference state_dict from ``path`` that must be a ``kind``
    (``"classifier"``: ``PointNetCls``, ``"segmenter"``:
    ``PointNetDenseCls``)."""
    sd = load_pth(path)
    if _KIND_KEYS[kind] not in sd:
        other = [k for k, key in _KIND_KEYS.items() if key in sd]
        raise ValueError(
            f"{path!r} is a {other[0]} checkpoint, not a {kind}" if other
            else f"{path!r}: not a recognized reference state_dict (no "
                 "top-level conv4/fc3: expected PointNetCls or "
                 "PointNetDenseCls keys)")
    return sd


def _load_checked(path: str, model: torch.nn.Module, sd: dict,
                  what: str) -> None:
    _check_keys(path, sd, model.state_dict(), what)
    model.load_state_dict(sd, strict=True)


def load_pth_warm_start(path: str, state_like):
    """Reference ``torch.save(state_dict)`` checkpoint -> the models'
    parameters and BN statistics, exactly the reference CLI's ``--model
    model_24.pth`` semantics (optimizer, step and generator stay fresh).
    A ``GANTrainState`` takes the generator from ``path`` and, when the
    ``<path minus .pth>_D.pth`` companion sits next to it, the
    discriminator too (else D keeps its fresh init). A ``TrainState``
    of a classifier takes a ``PointNetCls`` file, of a segmenter a
    ``PointNetDenseCls`` file."""
    if isinstance(state_like, state_lib.GANTrainState):
        sd = _reference_sd(path, "segmenter")
        _load_checked(path, state_like.g_model, sd, "generator")
        d_path = path[:-len(".pth")] + "_D.pth"
        if os.path.exists(d_path):
            _load_checked(d_path, state_like.d_model, load_pth(d_path),
                          "discriminator")
        return state_like
    kind = ("classifier" if isinstance(state_like.model, PointNetCls)
            else "segmenter")
    _load_checked(path, state_like.model, _reference_sd(path, kind), kind)
    return state_like


def load_classifier(path: str, num_classes: int = 40,
                    feature_transform: bool = False,
                    device="cuda") -> PointNetCls:
    """Reference ``PointNetCls`` ``.pth`` -> eval ``PointNetCls`` on
    ``device`` (the card unless the caller asks for the CPU), loaded with
    ``strict=True``."""
    sd = _reference_sd(path, "classifier")
    model = PointNetCls(num_classes, feature_transform)
    _load_checked(path, model, sd, "classifier")
    return model.to(device)


def load_segmenter(path: str, num_parts: int = 50,
                   feature_transform: bool = True,
                   device="cuda") -> PointNetDenseCls:
    """Reference ``PointNetDenseCls`` ``.pth`` -> eval ``PointNetDenseCls``
    on ``device`` (the card unless the caller asks for the CPU), loaded
    with ``strict=True``."""
    sd = _reference_sd(path, "segmenter")
    model = PointNetDenseCls(num_parts, feature_transform)
    _load_checked(path, model, sd, "segmenter")
    return model.to(device)


def load_saved_segmenter(path: str, field: str = "model",
                         device="cuda") -> PointNetDenseCls:
    """The segmenter saved at ``path`` on ``device`` (the card unless the
    caller asks for the CPU): a reference ``.pth``, or field ``field`` of
    the latest checkpoint of a directory the trainers wrote (``"g_model"``
    for a config-4 run's generator; no other field is loaded). Its part
    count and whether it has the feature transform are read from the
    saved tensors."""
    sd = _saved_sd(path, field, "segmenter")
    model = PointNetDenseCls(
        sd["conv4.weight"].shape[0],
        any(k.startswith("feat.fstn.") for k in sd))
    _load_checked(path, model, sd, "segmenter")
    return model.to(device)


def load_saved_classifier(path: str, field: str = "model",
                          device="cuda") -> PointNetCls:
    """The classifier saved at ``path`` (a reference ``.pth`` or a
    directory a classification or perturbation run wrote; its latest
    checkpoint's ``field``) on ``device``, in eval mode; its class count
    and whether it has the feature transform are read from the saved
    tensors."""
    sd = _saved_sd(path, field, "classifier")
    model = PointNetCls(sd["fc3.weight"].shape[0],
                        any(k.startswith("feat.fstn.") for k in sd))
    _load_checked(path, model, sd, "classifier")
    return model.to(device)


def _saved_sd(path: str, field: str, kind: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".pth"):
        return _reference_sd(path, kind)
    sd = _read(path, None)[field]
    if _KIND_KEYS[kind] not in sd:
        raise ValueError(f"{path!r}: field {field!r} is not a {kind}")
    return sd
