"""Host code of the port, built with g++ at first use and bound by ctypes.

Three libraries, each from the port's own copy of the JAX package's
native/ source of the same name:

- `dither.cpp`: the Floyd-Steinberg error diffusion of
  TEX_FILTER_DITHER_DIFFUSION (StoreScanlineDither,
  DirectXTexConvert.cpp:4049). A serpentine scan makes each row wait for
  the one before it, so the pass is a dependent chain of H x W steps per
  channel and image: it runs on the host.
- `rle_codec.cpp` and `piz.cpp`, one library: the byte-serial container
  codecs, TGA's RLE decode, HDR's scanline decode and RLE encode, and
  EXR PIZ's Huffman decode and encode. Each reads lengths from the stream
  it is decoding, so they run on the host too; the pixels they give go
  to the device in one copy.
- `exr_openexr.cpp`: the OpenEXR adapter the reference's EXR path is
  (Auxiliary/DirectXTexEXR.cpp), for DWAA / DWAB. It is the JAX package's
  optional dependency, kept so: built only where OpenEXR's headers are
  (`/usr/include/OpenEXR`), and `openexr_library()` is None elsewhere.

`g++ -O2 -shared -fPIC -ffp-contract=off` builds each into `_build/`
beside the package (as _build.py does for the CUDA kernels), the library
named by a hash of its sources and flags, so an edited source rebuilds and
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

__all__ = ["fs_dither", "library", "codec_library", "openexr_library",
           "tga_rle_decode", "hdr_decode_scanlines", "hdr_encode_rle_channel",
           "piz_huf_uncompress", "piz_huf_compress", "openexr_read_half",
           "openexr_write_half"]

NATIVE_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
SOURCE = NATIVE_DIR / "dither.cpp"
CODEC_SOURCES = (NATIVE_DIR / "rle_codec.cpp", NATIVE_DIR / "piz.cpp")
OPENEXR_SOURCE = NATIVE_DIR / "exr_openexr.cpp"
OPENEXR_INCLUDE = pathlib.Path("/usr/include/OpenEXR")
OPENEXR_FLAGS = ("-I/usr/include/OpenEXR", "-I/usr/include/Imath",
                 "-lOpenEXR", "-lIlmThread", "-lIex", "-lImath")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_library: ctypes.CDLL | None = None
_codec_library: ctypes.CDLL | None = None
_openexr_library: ctypes.CDLL | None = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int)


def _library_path(name: str, sources, flags) -> pathlib.Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdxt_{name}_{h.hexdigest()[:16]}.so"


def _build(name: str, sources, link=()) -> pathlib.Path:
    out = _library_path(name, sources, CXX_FLAGS + tuple(link))
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, *map(str, sources), "-o", str(tmp), *link]
    what = " + ".join(s.name for s in sources)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {what} failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {what} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builds all succeed
    return out


def _load(path: pathlib.Path, signatures: dict) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"loading {path} failed: {e}") from e
    for fn, (restype, argtypes) in signatures.items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def library() -> ctypes.CDLL:
    """The dither library, built on first use."""
    global _library
    with _lock:
        if _library is None:
            _library = _load(_build("dither", (SOURCE,)), {
                "fs_dither": (None, [_f32p, ctypes.c_int, ctypes.c_int,
                                     _f32p, ctypes.c_int])})
        return _library


def codec_library() -> ctypes.CDLL:
    """The container codecs' library (rle_codec.cpp + piz.cpp), built on
    first use."""
    global _codec_library
    with _lock:
        if _codec_library is None:
            _codec_library = _load(_build("codecs", CODEC_SOURCES), {
                "tga_rle_decode": (ctypes.c_longlong, [
                    ctypes.c_char_p, ctypes.c_longlong, _u8p,
                    ctypes.c_longlong, ctypes.c_int]),
                "hdr_decode_scanlines": (ctypes.c_int, [
                    ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, _u8p]),
                "hdr_encode_rle_channel": (ctypes.c_longlong, [
                    _u8p, ctypes.c_int, _u8p]),
                "piz_huf_uncompress": (ctypes.c_int, [
                    ctypes.c_char_p, ctypes.c_longlong, _u16p,
                    ctypes.c_longlong]),
                "piz_huf_compress": (ctypes.c_longlong, [
                    _u16p, ctypes.c_longlong, _u8p, ctypes.c_longlong])})
        return _codec_library


def openexr_library() -> ctypes.CDLL | None:
    """The OpenEXR adapter, built on first use where OpenEXR's headers
    are; None where they are not (the optional dependency of the
    reference's EXR path). Where they are, a failed build raises."""
    global _openexr_library
    if not OPENEXR_INCLUDE.is_dir():
        return None
    with _lock:
        if _openexr_library is None:
            _openexr_library = _load(
                _build("openexr", (OPENEXR_SOURCE,), OPENEXR_FLAGS), {
                    "exr_openexr_read_dims": (ctypes.c_int, [
                        ctypes.c_char_p, ctypes.c_longlong, _i32p, _i32p]),
                    "exr_openexr_read_half": (ctypes.c_int, [
                        ctypes.c_char_p, ctypes.c_longlong, _u16p]),
                    "exr_openexr_write_half": (ctypes.c_longlong, [
                        _u16p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_float, ctypes.POINTER(ctypes.c_char),
                        ctypes.c_longlong])})
        return _openexr_library


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


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
    lib.fs_dither(_ptr(img, ctypes.c_float), img.shape[0], img.shape[1],
                  _ptr(sc, ctypes.c_float), 1 if clampzero else 0)
    return img


def tga_rle_decode(data: bytes, count: int, bytes_pp: int) -> np.ndarray:
    """TGA RLE packets -> `count` pixels of `bytes_pp` bytes, flat u8."""
    data = bytes(data)
    out = np.empty(count * bytes_pp, np.uint8)
    if codec_library().tga_rle_decode(data, len(data),
                                      _ptr(out, ctypes.c_uint8), count,
                                      bytes_pp) < 0:
        raise ValueError("TGA: RLE data truncated")
    return out


def hdr_decode_scanlines(data: bytes, offset: int, width: int,
                         height: int) -> np.ndarray:
    """Radiance scanlines (both RLE styles) from `offset` -> [H, W, 4] u8
    RGBE."""
    data = bytes(data)
    out = np.empty((height, width, 4), np.uint8)
    if codec_library().hdr_decode_scanlines(
            data, len(data), offset, width, height,
            _ptr(out, ctypes.c_uint8)) != 0:
        raise ValueError("HDR: invalid or truncated scanline data")
    return out


def hdr_encode_rle_channel(ch) -> bytes:
    """New-style RLE of one channel of one scanline."""
    ch = np.ascontiguousarray(ch, np.uint8)
    out = np.empty(len(ch) * 2 + 2, np.uint8)
    n = codec_library().hdr_encode_rle_channel(
        _ptr(ch, ctypes.c_uint8), len(ch), _ptr(out, ctypes.c_uint8))
    return out[:n].tobytes()


def piz_huf_uncompress(data: bytes, n_raw: int) -> np.ndarray:
    """PIZ Huffman stream -> u16[n_raw]."""
    data = bytes(data)
    out = np.empty(n_raw, np.uint16)
    rc = codec_library().piz_huf_uncompress(data, len(data),
                                            _ptr(out, ctypes.c_uint16),
                                            n_raw)
    if rc != 0:
        raise ValueError(f"EXR: corrupt PIZ huffman stream ({rc})")
    return out


def piz_huf_compress(raw) -> bytes:
    """u16 data -> PIZ Huffman stream (hufCompress's layout)."""
    raw = np.ascontiguousarray(raw, np.uint16)
    # header + packed table + worst-case body (58-bit codes + rlc chains)
    cap = 20 + (len(raw) + 65537) * 8 + 64
    out = np.empty(cap, np.uint8)
    n = codec_library().piz_huf_compress(_ptr(raw, ctypes.c_uint16),
                                         len(raw),
                                         _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise ValueError("EXR: PIZ huffman encode overflow")
    return out[:n].tobytes()


def openexr_read_half(data: bytes) -> np.ndarray | None:
    """An EXR byte stream decoded by OpenEXR -> [H, W, 4] u16 half bits,
    or None without the adapter. A stream it cannot decode raises
    ValueError."""
    lib = openexr_library()
    if lib is None:
        return None
    data = bytes(data)
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.exr_openexr_read_dims(data, len(data), ctypes.byref(w),
                                 ctypes.byref(h)) != 0:
        raise ValueError("EXR: OpenEXR could not parse the stream")
    out = np.empty((h.value, w.value, 4), np.uint16)
    if lib.exr_openexr_read_half(data, len(data),
                                 _ptr(out, ctypes.c_uint16)) != 0:
        raise ValueError("EXR: OpenEXR decode failed")
    return out


def openexr_write_half(halves, compression: int,
                       dwa_level: float = 0.0) -> bytes | None:
    """[H, W, 4] half bits encoded by OpenEXR, or None without the
    adapter."""
    lib = openexr_library()
    if lib is None:
        return None
    halves = np.ascontiguousarray(halves, np.uint16)
    h, w = halves.shape[:2]
    cap = halves.nbytes * 2 + (1 << 16)
    out = ctypes.create_string_buffer(cap)
    n = lib.exr_openexr_write_half(_ptr(halves, ctypes.c_uint16), w, h,
                                   compression, dwa_level, out, cap)
    if n == 0:
        raise ValueError("EXR: OpenEXR encode failed")
    if n < 0:
        raise ValueError("EXR: OpenEXR encode overflow")
    return out.raw[:n]
