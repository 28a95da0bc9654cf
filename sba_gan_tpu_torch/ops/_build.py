"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  At first
use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the root of the checkout, named by a hash of its
source and flags, and loaded with ``ctypes``.  A library that exists is
reused, so a source change gives a new build.  :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")
SOURCES = {"word_attention": "word_attention.cu"}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return exe


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all in parallel.
    Returns ``{name: nvcc log}`` (register and shared-memory use from
    ``-Xptxas -v``; empty for a library that was already built)."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
