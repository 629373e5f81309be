"""Build the CUDA sources in ``bpt_tpu_torch/csrc`` with nvcc and load them.

Each kernel file exports a plain C interface and is compiled by hand into a
shared library (no PyTorch headers, so a build takes seconds), placed in
``bpt_tpu_torch/_build/`` under a name that carries a hash of the source,
of every ``csrc/`` header it includes and of the flags, and loaded with
``ctypes``.  nvcc's report (``-Xptxas -v``: registers, spills) is kept
beside the library as ``<library>.log``.  The kernels are
``megakernel`` (the fused radiance pass), ``staged`` (its staged phase
kernel; both include ``csrc/path.cuh``) and ``closest_hit`` (the
wavefront's closest-hit query).  Nothing is built or loaded until a
wrapper first launches on a CUDA tensor; that first load builds every
kernel of ``csrc/`` at once, one nvcc process each.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

#: sm_90a (Hopper with its architecture-specific features), no fast math.
#: No FMA contraction either: with it the Cornell kernel misses the
#: first-hit-normal tolerance against its plain version (see the note in
#: csrc/megakernel.cu); without it the two are bit-equal.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_loaded: dict = {}
_built: dict = {}  # kernel name -> its library, once the first load has built them


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return found


def sources(name: str, csrc: Path = CSRC) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` file it includes with quotes,
    directly or through another header, in a fixed order."""
    seen: dict[Path, None] = {}
    todo = [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen[path] = None
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return list(seen)


def source_digest(name: str, csrc: Path = CSRC, flags=NVCC_FLAGS) -> str:
    """The build's cache key: a hash of the kernel source, the headers it
    includes (names and bytes) and the flags."""
    h = hashlib.sha256()
    for path in sources(name, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_digest(name)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src.name}:\n{proc.stdout}\n{proc.stderr}")
    Path(f"{out}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def kernels(csrc: Path = CSRC) -> list[str]:
    """The kernels of ``csrc``: one per ``.cu`` file."""
    return sorted(path.stem for path in csrc.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``; cached per process.  The first load builds
    (where needed) every kernel of ``csrc/``, one nvcc process each, all
    started together: a build is one compiler process, and a run of the
    port launches every kernel."""
    if not _built:
        from concurrent.futures import ThreadPoolExecutor

        names = kernels()
        with ThreadPoolExecutor(max_workers=len(names)) as pool:
            _built.update(zip(names, pool.map(build, names)))
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(_built[name]))
    return _loaded[name]
