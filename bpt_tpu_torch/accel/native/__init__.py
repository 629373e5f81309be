"""ctypes loader for the native BVH builder (``bvh_builder.cpp``).

The C++ source is compiled with ``g++`` at first use into
``bpt_tpu_torch/_build/`` (not beside the source), under a name that
carries a hash of the source and the flags, so a changed source is rebuilt
and a stale library is never loaded.  ``load()`` returns None when the
compiler or the library is unavailable; the builders then use numpy
(``use_native="auto"``) or raise (``"require"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().with_name("bvh_builder.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
# No -march=native: the library is keyed by source and flags, not by machine,
# so it must run on any x86-64 host that finds it in _build/.
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> Path:
    """Where the compiled library lives: ``_build/libbvh_builder-<hash>.so``."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbvh_builder-{digest}.so"


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True, capture_output=True)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file


def load() -> Optional[ctypes.CDLL]:
    """The shared library, compiling it if needed; None if unavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            argtypes = [
                ctypes.POINTER(ctypes.c_float),  # aabb_min
                ctypes.POINTER(ctypes.c_float),  # aabb_max
                ctypes.c_int64,  # n_tris
                ctypes.POINTER(ctypes.c_int32),  # node_tri
                ctypes.POINTER(ctypes.c_int32),  # node_right
                ctypes.POINTER(ctypes.c_float),  # node_min
                ctypes.POINTER(ctypes.c_float),  # node_max
                ctypes.POINTER(ctypes.c_int32),  # max_depth out
            ]
            for fn in (lib.bvh_build, lib.bvh_build_sah):
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _failed = True
        return _lib
