"""Serving artifacts through ``torch.export``: the eval forward as one
serialized program with its weights embedded.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/utils/
serving.py``, which exports through ``jax.export`` to StableHLO. Here
``torch.export`` traces the eval-mode forward ``x [b, N, 3] -> log-probs``
(``[b, k]`` of a classifier, ``[b, N, k]`` of a segmenter; the
adversarial trainer's generator is a segmenter) into an
``ExportedProgram`` whose parameters, buffers and folded BatchNorms
travel with it, saved as one ``.pt2`` file. A serving process loads it
with ``load_exported`` and needs no model code, checkpoint or config.

As in the JAX package:

- The batch is symbolic by default (``Dim("b")``): one artifact serves
  every batch size. ``batch=`` pins it, and the artifact then refuses
  other sizes. The point count is static.
- The precision is explicit: fp32 by default, bf16 matmul operands with
  fp32 sums under ``bf16=True`` (traced inside ``core.mixed_precision``).
  The exporting process's own scope changes nothing.
- The default artifact is portable: it traces the eval kernels' plain
  versions, aten ops only, which run on the CPU or the card (the JAX
  package's default rides the XLA path), and it is stored on the CPU.
  ``kernels=True`` (the JAX package's ``use_pallas_kernels=True``)
  traces the three eval kernels' registered ops (``ops/serving_ops.py``),
  whose only implementation is CUDA's, and is refused unless the
  artifact's devices are ``("cuda",)``, as the JAX package refuses any
  platform list but ``("tpu",)``.

The artifact records its kind, devices, precision, point count and batch
in ``extra_files`` (``META``). ``load_exported`` imports the op
registrations first (``torch.export.load`` cannot resolve an op that is
not registered), refuses a kernels artifact on any device but CUDA,
moves the program to the serving device and pins exact fp32
(``core.exact_fp32``: an fp32 artifact must not run its matmuls in TF32).
"""

from __future__ import annotations

import json
import zipfile
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from adversarial_learning_on_pointclouds_tpu_torch.models import core
from adversarial_learning_on_pointclouds_tpu_torch.ops import (
    dispatch, launch,
)

META = "pointtpu_serving.json"
DEFAULT_DEVICES: Tuple[str, ...] = ("cpu", "cuda")
FORMAT = 1


class Exported(NamedTuple):
    """An exported eval forward and what ``save_exported`` records of it."""
    program: torch.export.ExportedProgram
    meta: dict


class _LogProbs(nn.Module):
    """The model's eval forward, its log-probabilities alone."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)[0]


def _export(model: nn.Module, kind: str, num_points: int,
            batch: Optional[int], devices: Sequence[str], bf16: bool,
            kernels: bool) -> Exported:
    devices = tuple(devices)
    if not devices or any(d not in DEFAULT_DEVICES for d in devices):
        raise ValueError(f"devices must be drawn from {DEFAULT_DEVICES}, "
                         f"got {devices!r}")
    if kernels and devices != ("cuda",):
        raise ValueError(
            "kernels=True puts the eval kernels' registered ops, which run "
            "on CUDA alone, into the artifact: export it with "
            f"devices=('cuda',), not {devices!r} (the portable default "
            "holds aten ops only)")
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be positive or None, got {batch}")
    if dispatch.differentiable_eval_enabled():
        raise RuntimeError("export outside ops.dispatch.differentiable_eval"
                           "(): within it the eval blocks skip the kernels")
    param = next(model.parameters())
    x = torch.zeros((batch or 2, num_points, 3), device=param.device)
    dims = None if batch is not None else {
        "x": {0: torch.export.Dim("b", min=1, max=65535)}}
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), core.mixed_precision(enabled=bf16), \
                launch.eval_route("ops" if kernels else "plain"):
            program = torch.export.export(_LogProbs(model), (x,),
                                          dynamic_shapes=dims)
    finally:
        model.train(was_training)
    if not kernels:
        program = move_to_device_pass(program, "cpu")
    out = _output_shape(program)
    meta = {"format": FORMAT, "kind": kind, "devices": list(devices),
            "kernels": kernels, "bf16": bf16, "num_points": num_points,
            "batch": batch, "outputs": int(out[-1]),
            "torch": torch.__version__}
    return Exported(program, meta)


def export_classifier(model: nn.Module, num_points: int = 1024,
                      batch: Optional[int] = None,
                      devices: Sequence[str] = DEFAULT_DEVICES,
                      bf16: bool = False, kernels: bool = False) -> Exported:
    """The eval-mode classifier forward ``x [b, N, 3] -> log_probs [b,
    k]`` of a ``PointNetCls``, its parameters and running statistics in
    the artifact."""
    return _export(model, "cls", num_points, batch, devices, bf16, kernels)


def export_segmenter(model: nn.Module, num_points: int = 2500,
                     batch: Optional[int] = None,
                     devices: Sequence[str] = DEFAULT_DEVICES,
                     bf16: bool = False, kernels: bool = False) -> Exported:
    """The eval-mode segmenter forward ``x [b, N, 3] -> log_probs [b, N,
    k]`` of a ``PointNetDenseCls`` (the adversarial trainer's generator
    serves through this too)."""
    return _export(model, "seg", num_points, batch, devices, bf16, kernels)


def save_exported(exp: Exported, path: str) -> None:
    """Write the artifact: the program and its weights, ``META`` beside."""
    torch.export.save(exp.program, path,
                      extra_files={META: json.dumps(exp.meta)})


def read_meta(path: str) -> dict:
    """``META`` of an artifact, read without loading its program."""
    try:
        with zipfile.ZipFile(path) as z:
            names = [n for n in z.namelist()
                     if n == f"extra/{META}" or n.endswith(f"/extra/{META}")]
            if names:
                return json.loads(z.read(names[0]).decode())
    except zipfile.BadZipFile:
        pass
    raise ValueError(f"{path}: not a serving artifact of utils/serving.py "
                     f"(a .pt2 archive with {META})")


def _output_shape(program) -> tuple:
    out = next(n for n in program.graph.nodes if n.op == "output")
    return tuple(out.args[0][0].meta["val"].shape)


def _input_shape(program) -> tuple:
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.name == name)
    return tuple(node.meta["val"].shape)


class Served:
    """A loaded artifact on one device: call it on ``[b, N, 3]`` clouds
    (a tensor, or a numpy array, moved to the device) for log-probs on
    that device. ``kind`` is ``"seg"`` where the output is ``[b, N, k]``
    and ``"cls"`` where it is ``[b, k]``; ``batch`` is the pinned batch or
    None (symbolic)."""

    def __init__(self, program, meta: dict, device: torch.device):
        self.program, self.meta, self.device = program, meta, device
        self.module = program.module()
        shape = _input_shape(program)
        self.num_points = int(shape[1])
        self.batch = shape[0] if isinstance(shape[0], int) else None
        self.kind = "seg" if len(_output_shape(program)) == 3 else "cls"

    def __call__(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if x.dim() != 3 or tuple(x.shape[1:]) != (self.num_points, 3):
            raise ValueError(f"the artifact takes [b, {self.num_points}, 3] "
                             f"clouds, got {tuple(x.shape)}")
        if self.batch is not None and x.shape[0] != self.batch:
            raise ValueError(f"the artifact's batch is pinned to "
                             f"{self.batch}, got {x.shape[0]} clouds (pad "
                             "the batch, or export with a symbolic batch)")
        with torch.inference_mode():
            return self.module(x.to(self.device))


def load_exported(path: str, device="cuda") -> Served:
    """Load an artifact onto ``device`` (no fallback: a kernels artifact
    on any device but CUDA raises, and so does a CUDA device without
    CUDA)."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops import (  # noqa: F401
        serving_ops,
    )

    meta = read_meta(path)
    _check_device(meta, torch.device(device), path)
    return serve(Exported(torch.export.load(path), meta), device)


def serve(exp: Exported, device="cuda") -> Served:
    """An exported (or loaded) program on ``device``, as ``load_exported``
    serves a file: refused where it cannot run, moved there, exact fp32
    pinned."""
    dev = torch.device(device)
    _check_device(exp.meta, dev, "the artifact")
    program = move_to_device_pass(exp.program, str(dev))
    core.exact_fp32()
    return Served(program, exp.meta, dev)


def _check_device(meta: dict, dev: torch.device, what: str) -> None:
    if meta["kernels"] and dev.type != "cuda":
        raise ValueError(
            f"{what} is a kernels artifact: its eval kernels are registered "
            "ops with a CUDA implementation only, so it serves on a CUDA "
            f"device, not {dev} (export a portable artifact for the CPU)")
    if dev.type not in meta["devices"]:
        raise ValueError(f"{what} was exported for {meta['devices']}, not "
                         f"{dev.type}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: CUDA is not available")
