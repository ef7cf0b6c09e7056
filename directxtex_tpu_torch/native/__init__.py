"""Host code of the port, built with g++ at first use and bound by ctypes.

`dither.cpp` is the Floyd-Steinberg error diffusion of
TEX_FILTER_DITHER_DIFFUSION (StoreScanlineDither,
DirectXTexConvert.cpp:4049), the same code as the JAX package's
native/dither.cpp, kept here as the port's own copy. A serpentine scan
makes each row wait for the one before it, so the pass is a dependent
chain of H x W steps per channel and image: it runs on the host.

`g++ -O2 -shared -fPIC -ffp-contract=off` builds it into `_build/` beside
the package (as _build.py does for the CUDA kernels), the library named
by a hash of the source and the flags, so an edited source rebuilds and
an unchanged one loads the earlier build. Nothing is built at import
time. A failed build or load raises RuntimeError: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

__all__ = ["fs_dither", "library"]

NATIVE_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
SOURCE = NATIVE_DIR / "dither.cpp"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdxt_dither_{h.hexdigest()[:16]}.so"


def _build() -> pathlib.Path:
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {SOURCE.name} failed: {' '.join(cmd)}:"
                           f" {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builds all succeed
    return out


def library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _library
    with _lock:
        if _library is None:
            path = _build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading {path} failed: {e}") from e
            lib.fs_dither.restype = None
            lib.fs_dither.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            _library = lib
        return _library


def fs_dither(img: np.ndarray, scale, clampzero: bool) -> np.ndarray:
    """Floyd-Steinberg dither of one [H, W, 4] f32 image, in place: the
    quantized values renormalized. `img` must be a writable C-contiguous
    float32 array; it is returned."""
    if not (isinstance(img, np.ndarray) and img.dtype == np.float32
            and img.ndim == 3 and img.shape[2] == 4
            and img.flags.c_contiguous and img.flags.writeable):
        raise ValueError("fs_dither takes a writable C-contiguous float32 "
                         "[H, W, 4] array")
    lib = library()
    sc = np.ascontiguousarray(scale, np.float32)
    lib.fs_dither(img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                  img.shape[0], img.shape[1],
                  sc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                  1 if clampzero else 0)
    return img
