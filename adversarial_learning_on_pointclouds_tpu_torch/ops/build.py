"""Build and load the port's CUDA kernels.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/native/build.py``.
``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one
process per source, all at once, and links the objects into one shared
library with a plain C interface, loaded with ``ctypes``. The
library's name carries a hash of the sources and flags, so an edited
source builds anew and an unchanged one loads from
``adversarial_learning_on_pointclouds_tpu_torch/build/``. The build runs
at first use (a few seconds) and raises with nvcc's output if it fails;
nothing falls back. ``ptxas -v``'s report of each kernel's registers and
spills is kept (``resource_usage``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
    ctypes.c_longlong, ctypes.c_float
_PP, _IP = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
# Every pointer and the stream are c_void_p: left to ctypes' default
# they would pass as 32-bit ints and be cut.
SIGNATURES = {
    "pt_linear_affine_act": [_P] * 5 + [_LL] + [_I] * 5 + [_P],
    "pt_stack_maxpool": [_P, _P, _PP, _PP, _PP, _IP, _IP] + [_I] * 5 + [_P],
    "pt_seg_head": [_P] * 15 + [_I] * 10 + [_P],
    "pt_augment_fused": [_P] * 3 + [_U] * 2 + [_I] * 3 + [_F] * 3 + [_I, _P],
    "pt_augment_fused_pair": [_P] * 5 + [_U] + [_I] * 5 + [_F] * 3 + [_I, _P],
}
# The training passes and the per-layer kernels take one argument struct (ops/launch.py mirrors it).
for _name in ("pt_pool_fc_fwd", "pt_trunk_f1", "pt_trunk_f2", "pt_trunk_b1",
              "pt_head_p1", "pt_head_pmid", "pt_head_p4", "pt_head_b4",
              "pt_head_bmid", "pt_head_b1", "pt_disc_fwd", "pt_disc_bwd_dx",
              "pt_disc_bwd_dw", "pt_pm_fwd", "pt_pm_dx", "pt_pm_dwdb",
              "pt_tnet_fwd", "pt_tnet_dx", "pt_tnet_dt", "pt_maxpool_fwd",
              "pt_maxpool_bwd", "pt_fc_head_fwd", "pt_fc_head_bwd",
              "pt_mlp_stack"):
    SIGNATURES[_name] = [_P, _I, _P]


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


# Seconds each source took to compile in this process's last build, and
# ``{source: ptxas_usage(...)}`` of it (both empty when the library
# loaded from BUILD).
compile_seconds: dict = {}
resource_usage: dict = {}


def ptxas_usage(text: str) -> dict:
    """``{mangled kernel: (registers, spill store bytes, spill load
    bytes)}`` from ``ptxas -v``'s report on one source."""
    usage, fn, props, spills = {}, None, None, (0, 0)
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            fn, spills = m[1], (0, 0)
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m[1]
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            if props == fn:
                spills = (int(m[1]), int(m[2]))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            usage[fn] = (int(m[1]), *spills)
            fn = None
    return usage


def _run(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(cmd, proc) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{out}")
    return out


def _compile_all(cmds, names) -> None:
    """Run every nvcc at once, each waited on by its own thread (so each
    source's time is its own); raise with the first failure's output."""
    t0 = time.perf_counter()
    procs = [_run(c) for c in cmds]
    errors = {}

    def wait(i):
        try:
            resource_usage[names[i]] = ptxas_usage(_wait(cmds[i], procs[i]))
        except RuntimeError as e:
            errors[i] = e
        compile_seconds[names[i]] = time.perf_counter() - t0

    threads = [threading.Thread(target=wait, args=(i,))
               for i in range(len(cmds))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise errors[min(errors)]


def build() -> Path:
    """Compile ``csrc/*.cu`` unless this exact build exists; return it.
    Each source compiles in its own nvcc process, all started together;
    then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    # Build in a temporary directory and rename: a concurrent process
    # never loads a half-written library.
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs = [os.path.join(tmp, f.stem + ".o") for f in cu]
        cmds = [[nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(f)]
                for f, o in zip(cu, objs)]
        compile_seconds.clear()
        resource_usage.clear()
        _compile_all(cmds, [f.name for f in cu])
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _wait(cmd, _run(cmd))
        os.replace(lib, out)
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
