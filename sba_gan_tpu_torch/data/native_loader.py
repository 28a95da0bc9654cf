"""The native JPEG pipeline (``MODEL.IMAGE_LOADER: native``) through ctypes.

``native/sba_loader.cpp`` (libjpeg decode, bounding-box crop, bilinear
resize to a pre-size, crop, flip, a bilinear pyramid in [-1, 1]) is compiled
at first use with ``g++ -O3 -shared -fPIC ... -ljpeg`` into
``build/native/`` at the root of the checkout, named by a hash of the source
and the command, and loaded with ``ctypes``.  A library that exists is
reused; several processes may build at once (each writes its own file and
renames it into place).

Without ``g++`` or libjpeg (its header or its library) the build fails and
:func:`load_library` raises ``RuntimeError`` with the compiler's message
(a library that exists but cannot be loaded, for want of ``libjpeg.so``,
raises it too): there is no fallback to PIL.  ctypes releases the GIL
during the call, so reader threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "sba_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_INT_P = ctypes.POINTER(ctypes.c_int)
_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((CXX, *CXX_FLAGS, *LIBS)).encode())
    return BUILD_DIR / f"libsba_loader-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the library unless it exists; its path.  Raises
    ``RuntimeError`` with the compiler's output when it cannot be built."""
    out = library_path()
    if out.exists():
        return out
    exe = shutil.which(CXX)
    if exe is None:
        raise RuntimeError(f"native image loader: {CXX} not found (it needs {CXX} and "
                           "libjpeg)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [exe, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native image loader: {' '.join(cmd)} failed (exit "
                           f"{proc.returncode}; it needs {CXX} and libjpeg):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if need be (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:  # built elsewhere, or libjpeg gone since
                raise RuntimeError(f"native image loader: {path} cannot be loaded ({e}; "
                                   f"it needs {CXX} and libjpeg)") from e
            lib.sba_load_image.restype = ctypes.c_int
            lib.sba_load_image.argtypes = [
                ctypes.c_char_p,
                _INT_P,                      # bbox (x0, y0, w, h) or NULL
                ctypes.c_int, ctypes.c_int,  # pre_w, pre_h (0: none)
                _INT_P,                      # crop2 (x0, y0, w, h) or NULL
                ctypes.c_int,                # hflip
                _INT_P, ctypes.c_int,        # sizes, n_sizes
                ctypes.POINTER(_FLOAT_P),    # outs
            ]
            _lib = lib
        return _lib


class NativeImageLoader:
    """JPEG decode -> bbox crop -> resize -> crop -> flip -> one (S, S, 3)
    float32 image in [-1, 1] per size, all in C++.  Building it raises
    ``RuntimeError`` where the library cannot be built or loaded."""

    def __init__(self):
        self._lib = load_library()

    def load(
        self,
        path: str,
        sizes: Sequence[int],
        bbox: Optional[Sequence[int]] = None,   # (x0, y0, w, h)
        pre_size=None,                           # int (square) or (w, h)
        crop2: Optional[Sequence[int]] = None,   # (x0, y0, w, h)
        hflip: bool = False,
    ) -> List[np.ndarray]:
        n = len(sizes)
        outs = [np.empty((s, s, 3), np.float32) for s in sizes]
        out_ptrs = (_FLOAT_P * n)(*[o.ctypes.data_as(_FLOAT_P) for o in outs])
        sizes_arr = (ctypes.c_int * n)(*sizes)
        bbox_arr = (ctypes.c_int * 4)(*bbox) if bbox is not None else None
        crop_arr = (ctypes.c_int * 4)(*crop2) if crop2 is not None else None
        if pre_size is None:
            pw = ph = 0
        elif isinstance(pre_size, (tuple, list)):
            pw, ph = int(pre_size[0]), int(pre_size[1])
        else:
            pw = ph = int(pre_size)
        rc = self._lib.sba_load_image(os.fsencode(path), bbox_arr, pw, ph, crop_arr,
                                      int(hflip), sizes_arr, n, out_ptrs)
        if rc != 0:
            raise IOError(f"native decode failed ({rc}): {path}")
        return outs
