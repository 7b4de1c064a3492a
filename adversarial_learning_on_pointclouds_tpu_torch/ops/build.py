"""Build and load the port's CUDA kernels.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/native/build.py``.
``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``. The
library's name carries a hash of the sources and flags, so an edited
source builds anew and an unchanged one loads from
``adversarial_learning_on_pointclouds_tpu_torch/build/``. The build runs
at first use (a few seconds) and raises with nvcc's output if it fails;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PP, _IP = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
# Every pointer and the stream are c_void_p: left to ctypes' default
# they would pass as 32-bit ints and be cut.
SIGNATURES = {
    "pt_linear_affine_act": [_P] * 5 + [_LL, _I, _I, _I, _I, _P],
    "pt_stack_maxpool": [_P, _P, _PP, _PP, _PP, _IP, _IP] + [_I] * 4 + [_P],
    "pt_seg_head": [_P] * 15 + [_I] * 9 + [_P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD / f"libpointtpu_kernels_{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): the "
                       "port's kernels build from csrc/ at first use")


def build() -> Path:
    """Compile ``csrc/*.cu`` unless this exact build exists; return it."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    # Build under a temporary name and rename: a concurrent process never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), once per
    process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pt_error_string.argtypes = [ctypes.c_int]
    lib.pt_error_string.restype = ctypes.c_char_p
    return lib
