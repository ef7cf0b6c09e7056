"""Build the port's CUDA kernels at first use and load them with ctypes.

`nvcc` compiles every `csrc/*.cu` of this package, one process per source
and all at once, and links the objects into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).
The library lands in `_build/` beside this file, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one
loads the earlier build. Nothing is built or loaded at import time.

Flags: sm_90a (Hopper), IEEE division and square root (nvcc's defaults),
no fast math, and --fmad=false: a contracted a*b+c rounds once where the
plain PyTorch twin rounds twice, which would move the search's float
steps (power iteration, LS refits) and with them near-tie picks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_library: ctypes.CDLL | None = None
# what the last build reported: seconds, library path, nvcc's log
build_info: dict = {}


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    """nvcc from CUDA_HOME, the PATH, or PyTorch's CUDA_HOME guess."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernel library unless this source hash is built."""
    out = BUILD_DIR / f"libdxt_kernels_{_source_key()}.so"
    if out.exists():
        build_info.update(seconds=0.0, path=str(out), log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{_source_key()}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    compiles = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj),
               str(src)]
        compiles.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for cmd, _, proc in compiles:
        text = proc.communicate()[0]
        log.append(text)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           "-o", str(tmp), *(str(obj) for _, obj, _ in compiles)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for _, obj, _ in compiles:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builds all succeed
    build_info.update(seconds=time.perf_counter() - t0, path=str(out),
                      log="".join(log) + proc.stdout + proc.stderr)
    return out


def library(signatures: dict[str, tuple[int, int]]) -> ctypes.CDLL:
    """The loaded kernel library, built on first use. `signatures` maps
    each C entry point to (pointer arguments, int arguments); every entry
    point takes its pointers, then its ints, then the CUDA stream, and
    returns cudaGetLastError() after its launch."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, (n_ptrs, n_ints) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                               + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
            _library = lib
        return _library
