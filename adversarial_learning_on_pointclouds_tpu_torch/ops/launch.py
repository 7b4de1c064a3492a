"""What every kernel wrapper shares: the device rule, operand checks and
the status-checked call into the built library (``ops/build.py``).

The device rule is the whole switch between a kernel and its plain
PyTorch version: a tensor on the CPU takes the plain version, a tensor
on a CUDA device takes the kernel, and anything the kernel does not take
raises. There is no flag and no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from adversarial_learning_on_pointclouds_tpu_torch.ops import build

ACT_CODES = {None: 0, "relu": 1, "leaky_relu": 2}


def on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


def act_code(act: Optional[str]) -> int:
    if act not in ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    return ACT_CODES[act]


def expect(name: str, t: torch.Tensor, shape: Sequence[int],
           device: torch.device, weight: bool = False) -> None:
    """Raise unless ``t`` is fp32 on ``device`` with ``shape`` and laid
    out as the kernel reads it: contiguous, or for a ``weight`` given as
    ``[in, out]``, the transposed view of a row-major ``[out, in]``
    tensor (``layer.weight.flatten(1).t()``)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if weight and not t.t().is_contiguous():
        raise ValueError(f"{name} must be the [in, out] view of a row-major "
                         "[out, in] tensor, e.g. layer.weight.flatten(1).t()")
    if not weight and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def no_grad(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the eval kernels have no backward: call them "
                           "under torch.no_grad() or torch.inference_mode()")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def weight_ptr(w: torch.Tensor) -> ctypes.c_void_p:
    """Pointer to the row-major ``[out, in]`` storage behind ``w``."""
    return ctypes.c_void_p(w.t().data_ptr())


def pointers(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def ints(vals: Sequence[int]):
    return (ctypes.c_int * len(vals))(*vals)


def call(symbol: str, device: torch.device, *args) -> None:
    """Launch ``symbol`` on ``device``'s current stream; raise if it
    reports an error (a refused launch never runs, and a later
    synchronize would not report it)."""
    lib = build.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    status = getattr(lib, symbol)(*args, device.index, stream)
    if status != 0:
        raise RuntimeError(f"{symbol} failed: "
                           f"{lib.pt_error_string(status).decode()} "
                           f"(status {status})")
