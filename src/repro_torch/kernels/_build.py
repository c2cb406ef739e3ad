"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point, compiled
for Hopper (``sm_90a``) into ``_build/lib<name>-<digest>.so`` inside the
package; the digest covers the sources and the flags, so an edited source
is rebuilt and a stale library is never loaded.  Libraries are built only
from the sources in this checkout.  :func:`build` compiles every missing
library at once, one ``nvcc`` process per source.

Never add ``--use_fast_math``: the kernels divide exactly where the JAX
package divides (see ``csrc/fused_measures.cuh``).  ``--fmad=false`` keeps
``a*b+c`` rounded twice, as on the host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")

#: kernel name → the sources its library is built from (the .cu first)
SOURCES: Dict[str, tuple] = {
    "topk": ("topk.cu", "bitonic.cuh"),
    "fused_measures": ("fused_measures.cu", "fused_measures.cuh"),
    "embedding_bag": ("embedding_bag.cu", "embedding_bag_bwd.cuh"),
}

#: nvcc's output (``-Xptxas=-v``: registers, shared memory, spills) per
#: kernel built in this process
build_log: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        digest.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per source, all started together.  Returns name → path."""
    names = list(SOURCES if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n][0])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, paths[n])  # atomic: readers never see a partial
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use in this process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
