"""Build the CUDA sources in ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain ``extern "C"`` interface (seconds per
file; no PyTorch headers). All missing libraries are built at once, one
``nvcc`` process per source, started together. The output goes to
``build/repro_torch/<hash>/`` under the repository root (or
``$REPRO_TORCH_BUILD_DIR``), keyed by a hash of every file in ``csrc/`` and
of the flags, so an edited source is rebuilt and an unchanged one is not.

Every C entry point takes device pointers, sizes and a ``cudaStream_t`` and
returns ``cudaGetLastError()`` after its launch; the wrappers raise when it
is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

__all__ = ["SOURCES", "build_all", "library", "build_dir", "ptxas_report"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "acq_score": "acq_score.cu",
    "acq_score_multi": "acq_score_multi.cu",
    "matern52": "matern52.cu",
}
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", ""),
        "/usr/local/cuda",
    ):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "building the CUDA kernels needs nvcc (CUDA toolkit); none found "
            "in $CUDA_HOME, /usr/local/cuda or PATH"
        )
    return found


def build_dir() -> Path:
    """``build/repro_torch/<hash of csrc/ and flags>``."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(_CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    root = os.environ.get("REPRO_TORCH_BUILD_DIR")
    base = Path(root) if root else _CSRC.parents[3] / "build" / "repro_torch"
    return base / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said about a built library (registers, shared
    memory, spills per kernel), or "" if it was not built in this tree."""
    log = build_dir() / f"lib{name}.log"
    return log.read_text() if log.is_file() else ""


def build_all() -> List[str]:
    """Build every missing library, all ``nvcc`` runs in parallel. Returns
    the names built now (empty if all were built already)."""
    with _lock:
        out_dir = build_dir()
        todo = [n for n in SOURCES if not _lib_path(n).is_file()]
        if not todo:
            return []
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
                   str(_CSRC / SOURCES[name])]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        failures = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            (out_dir / f"lib{name}.log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"{SOURCES[name]}:\n{log}")
                continue
            os.replace(tmp, _lib_path(name))
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        return todo


_ARGTYPES = {
    "acq_score": [ctypes.c_void_p] * 10
    + [ctypes.c_double, ctypes.c_double]
    + [ctypes.c_void_p]
    + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "acq_score_multi": [ctypes.c_void_p] * 13
    + [ctypes.c_double, ctypes.c_double]
    + [ctypes.c_void_p]
    + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    "matern52_gram": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "matern52_cross": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
# Host-side helpers (no launch): name -> (argtypes, restype).
_HELPERS = {
    "acq_score_multi_smem_bytes": ([ctypes.c_int] * 7, ctypes.c_longlong),
    "acq_score_multi_smem_limit": ([ctypes.c_int], ctypes.c_longlong),
}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if missing. Raises
    when no CUDA card is visible: the kernels exist only on the card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"the CUDA kernel library {name!r} needs an NVIDIA card and none "
            "is visible; CPU tensors take the plain PyTorch version instead"
        )
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if not _lib_path(name).is_file():
        build_all()
    lib = ctypes.CDLL(str(_lib_path(name)))
    for entry, argtypes in _ARGTYPES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{entry}_{suffix}", None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    for entry, (argtypes, restype) in _HELPERS.items():
        fn = getattr(lib, entry, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = restype
    _libs[name] = lib
    return lib
