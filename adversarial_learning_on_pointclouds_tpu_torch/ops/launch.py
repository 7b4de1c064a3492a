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
           device: torch.device, weight: Optional[bool] = False,
           dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is ``dtype`` on ``device`` with ``shape`` and
    laid out as the kernel reads it: contiguous, or for a ``weight`` given
    as ``[in, out]``, the transposed view of a row-major ``[out, in]``
    tensor (``layer.weight.flatten(1).t()``); ``weight=None`` leaves the
    layout to the caller."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if weight and not t.t().is_contiguous():
        raise ValueError(f"{name} must be the [in, out] view of a row-major "
                         "[out, in] tensor, e.g. layer.weight.flatten(1).t()")
    if weight is False and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def no_grad(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the eval kernels have no backward: call them "
                           "under torch.no_grad() or torch.inference_mode(); "
                           "to train, put the model in .train(), whose "
                           "forward runs the training kernels")


def weight_ld(name: str, w: torch.Tensor, shape: Sequence[int],
              device: torch.device) -> int:
    """Check an ``[in, out]`` weight view whose ``[out, in]`` storage rows
    may be longer than ``in`` (a row slice such as ``W1[:64]`` of the
    ``[1088, 512]`` view) and return that row stride, the kernel's
    ``ldw``."""
    expect(name, w, shape, device, weight=None)
    if w.stride(0) != 1:
        raise ValueError(f"{name} must be an [in, out] view of row-major "
                         "[out, in] storage, e.g. layer.weight.flatten(1).t()")
    return w.stride(1)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def args(struct: type, **fields) -> ctypes.Structure:
    """Fill a ``ctypes.Structure`` that mirrors a C argument struct:
    tensors become their data pointers (a weight view its storage's),
    ``None`` a null pointer, ints stay ints; ``groups`` defaults to 1."""
    out = struct()
    if any(f == "groups" for f, _ in struct._fields_):
        out.groups = 1
    for name, value in fields.items():
        if isinstance(value, torch.Tensor):
            value = value.data_ptr()
        setattr(out, name, value)
    return out


def _struct(name: str, ints: Sequence[str], ptrs: Sequence[str]) -> type:
    fields = ([(f, ctypes.c_int) for f in ints]
              + [(f, ctypes.c_void_p) for f in ptrs])
    return type(name, (ctypes.Structure,), {"_fields_": fields})


# Mirrors of the argument structs in csrc/train_gemm.cuh, field for field.
RowFwdArgs = _struct(
    "RowFwdArgs", ("batch", "n", "c_in", "c_out", "ldw", "groups", "prec"),
    ("x", "sc", "sh", "w", "bias", "addend", "z", "sum", "ssq", "part",
     "keys", "mx", "mn", "imax", "imin", "logp"))
BwdArgs = _struct(
    "BwdArgs", ("mode", "batch", "n", "c_in", "c_out", "ldw", "splits",
                "groups", "prec"),
    ("zp", "scp", "shp", "mup", "invp", "w", "bias", "zc", "dy", "sc", "mu",
     "inv", "c1", "c2", "coef1", "coef2", "s3dg", "idx", "dlp", "dyp", "t1",
     "t2", "db", "r", "dw", "part", "part_w", "dzs", "hs"))
# Mirror of the argument struct in csrc/pool_fc_epilogue.cu (mn, s3c and
# t3 null: the identity fold).
PoolFcArgs = _struct(
    "PoolFcArgs", ("batch", "c3", "c1", "groups", "prec"),
    ("mx", "mn", "s3c", "t3", "w1", "b1", "g1", "be1", "rm1", "h1", "h", "z1",
     "mu", "var", "inv"))
# Mirror of the argument struct in csrc/disc_fused.cuh.
DiscArgs = _struct(
    "DiscArgs", ("m", "k", "prec", "split1", "split2", "split3", "split4"),
    ("x", "g", "w1", "w2", "w3", "w4", "w5", "b1", "b2", "b3", "b4", "b5",
     "logits", "dx", "grad", "part", "dzs", "hs", "part_w"))
# Mirrors of the argument structs of the per-layer training kernels
# (csrc/pointwise_matmul.cu, tnet_apply.cu, maxpool_points.cu,
# fc_head_train.cu).
PmArgs = _struct(
    "PmArgs", ("rows", "c_in", "c_out", "splits", "prec"),
    ("x", "w", "bias", "g", "y", "dx", "dw", "db", "part"))
TnetArgs = _struct(
    "TnetArgs", ("batch", "n", "k", "splits"),
    ("x", "t", "g", "y", "dx", "dt", "part"))
MaxpoolArgs = _struct(
    "MaxpoolArgs", ("batch", "n", "c"), ("x", "g", "win", "y", "idx", "dx"))
FcHeadArgs = _struct(
    "FcHeadArgs", ("batch", "c0", "c1", "c2", "c3", "prec"),
    ("h", "w1", "b1", "g1", "be1", "rm1", "w2", "b2", "g2", "be2", "rm2",
     "w3", "b3", "out", "z1", "z2", "mu1", "var1", "inv1", "mu2", "var2",
     "inv2", "h1", "h2", "dh2", "dh", "dw1", "db1", "dg1", "dbe1", "dw2",
     "db2", "dg2", "dbe2", "dz1", "dz2"))
# Mirror of the argument struct in csrc/mlp_stack.cu (at most MAX_STACK
# layers).
MAX_STACK = 8
StackArgs = type("StackArgs", (ctypes.Structure,), {"_fields_": [
    ("rows", ctypes.c_int), ("layers", ctypes.c_int), ("prec", ctypes.c_int),
    ("width", ctypes.c_int * (MAX_STACK + 1)),
    ("act", ctypes.c_int * MAX_STACK), ("x", ctypes.c_void_p),
    ("w", ctypes.c_void_p * MAX_STACK), ("scale", ctypes.c_void_p * MAX_STACK),
    ("shift", ctypes.c_void_p * MAX_STACK), ("out", ctypes.c_void_p)]})
DZ_BN, DZ_TRUNK, DZ_SOFTMAX = 0, 1, 2   # BwdArgs.mode
TC_TILE = 128      # rows per block (per tile) of the tensor-core trunk
                   # F1, F2 and B1 and the seg head's six passes (kTcRows
                   # in csrc/train_bwd_tc.cu)
DISC_TILE = 64     # rows per block of the disc's backward row pass
                   # (kDwRows in csrc/disc_tc.cu)
# The T-Net fc layers' split-K product (csrc/small_fc.cuh): output columns
# a cluster owns, CTAs a cluster, the deepest k slice, and the column
# groups from which a layer runs on fewer CTAs a cluster.
FC_COLS, FC_CLUSTER, FC_SLICE, FC_WIDE = 16, 8, 128, 128
# The ``prec`` bits of the argument structs (kRound... in common.cuh):
# round every matmul operand to bf16, and which tensors are bf16 stashes
# (RowFwdArgs: x, z; BwdArgs: zp, zc, dy, dyp).
ROUND = 1
BF16_BITS = {"x": 2, "zp": 2, "z": 4, "zc": 4, "dy": 8, "dyp": 16}


def prec(bf16: bool, **tensors: Optional[torch.Tensor]) -> int:
    """The ``prec`` field: ``ROUND`` under ``bf16``, and the bit of each
    named tensor that is bf16. bf16 stashes come with bf16 operands only
    (the kernels' fp32 build takes fp32 alone)."""
    bits = ROUND if bf16 else 0
    for name, t in tensors.items():
        if t is not None and t.dtype == torch.bfloat16:
            if not bf16:
                raise TypeError(f"{name} is a bf16 stash: pass bf16=True")
            bits |= BF16_BITS[name]
    return bits


def stash_dtype(bf16: bool) -> torch.dtype:
    return torch.bfloat16 if bf16 else torch.float32


def expect_stash(name: str, t: torch.Tensor, shape: Sequence[int],
                 device: torch.device) -> None:
    """``expect`` for a stash, which is fp32 or bf16."""
    expect(name, t, shape, device,
           dtype=torch.bfloat16 if t.dtype == torch.bfloat16
           else torch.float32)


def row_blocks(bsz: int, n: int, tile: int) -> int:
    """Blocks of a row kernel: one per ``tile`` points of each cloud."""
    return bsz * -(-n // tile)


def check_groups(bsz: int, groups: int) -> int:
    """Clouds per group; raise unless ``groups`` splits the batch."""
    if groups < 1 or bsz % groups:
        raise ValueError(f"batch {bsz} does not split into {groups} groups")
    return bsz // groups


def row_splits(rows: int, m: int, n: int, device: torch.device,
               batch: int = 1) -> int:
    """Row ranges of a sum over ``rows`` rows into ``batch`` outputs of
    ``m x n`` (a dW, a dT), counted in 128 x 128 tiles: enough ranges for
    two blocks per SM, each of at least 256 rows. The ranges' partial sums
    are added in fp64 in a fixed order, so the count changes no result
    beyond rounding."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = batch * -(-m // 128) * -(-n // 128)
    return max(1, min(-(-rows // 256), -(-2 * sms // tiles)))


def fc_split(k: int, cols: int) -> tuple:
    """``(cs, kc)``: the CTAs a cluster of the T-Net fc layers' split-K
    product and the depth of each CTA's slice of ``k`` (``fc_split`` in
    csrc/small_fc.cuh): ``FC_CLUSTER``, unless the layer has ``FC_WIDE``
    column groups or more; then the fewest (1, 2, 4, 8) whose slices are
    at most ``FC_SLICE`` deep. ``kc`` is a multiple of 16."""
    cs = FC_CLUSTER
    if -(-cols // FC_COLS) >= FC_WIDE:
        cs = 1
        while cs < FC_CLUSTER and -(-k // cs) > FC_SLICE:
            cs *= 2
    return cs, (-(-k // cs) + 15) // 16 * 16


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
