"""Build + load the native pts loader (lazy, cached, with fallback).

Counterpart of ``adversarial_learning_on_pointclouds_tpu/native/
build.py``. Compiles ``pts_loader.cpp`` with ``g++ -O3`` (about 1 s) the
first time it is needed, into the package's git-ignored ``build/``
directory (where ``ops/build.py`` puts the CUDA library), then loads it
with ctypes. The library's name carries a hash of the source, so an
edited source builds anew. Without a toolchain ``get_lib`` returns None
and the caller takes the numpy path: the native loader is host code that
speeds up reading, not a dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().with_name("pts_loader.cpp")
BUILD = _SRC.parents[1] / "build"
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
          "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD / f"libptsloader_{digest.hexdigest()[:12]}.so"


def _compile(lib: Path) -> bool:
    """Compile into a temporary file beside ``lib`` and rename it into
    place, so processes that build at once never load a partial file."""
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None if unavailable."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = library_path()
        if not path.exists() and not _compile(path):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _failed = True
            return None
        lib.load_shapes.restype = ctypes.c_int
        lib.load_shapes.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _lib = lib
        return _lib
