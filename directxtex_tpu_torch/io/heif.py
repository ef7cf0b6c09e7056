"""HEIF/HEIC/AVIF codec bridge via the system libheif, on torch tensors.

The counterpart of directxtex_tpu/io/heif.py. The reference's WIC layer
decodes HEIF through the Windows HEIF/HEVC-extension codec when installed
(WIC_CODEC_HEIF, DirectXTexWIC.cpp — the codec also fronts AVIF on
current Windows); the port binds the system libheif C ABI with ctypes (no
compile step). HEVC (heic) and AV1 (avif) compression are both supported
for read and write when the corresponding decoder / encoder plugins are
present.

libheif decodes to RGBA8 on the host; the frames go to the device in one
copy and are normalized there. A save rounds to 8 bits on the texture's
device and makes one D2H copy. `is_available()` gates the binding and
callers raise a clear unsupported-codec error when libheif is absent,
matching the reference's behavior on a Windows without the HEIF
extension.
"""

from __future__ import annotations

import ctypes as C
import os
import tempfile

import numpy as np
import torch

from .. import numerics
from ..formats.dxgi import FMT
from ..texture import TexDimension, TexMetadata, Texture
from ..utils.device import resolve
from .wic import to_rgba8

__all__ = ["is_available", "load_from_heif_memory", "load_from_heif_file",
           "save_to_heif_memory", "save_to_heif_file"]

# libheif enums (libheif/heif.h)
_COLORSPACE_RGB = 1
_CHROMA_INTERLEAVED_RGBA = 11
_CHANNEL_INTERLEAVED = 10
_COMPRESSION = {"hevc": 1, "av1": 4}

_lib = None
_tried = False


class _Err(C.Structure):
    _fields_ = [("code", C.c_int), ("subcode", C.c_int),
                ("message", C.c_char_p)]


def _bind():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = C.CDLL("libheif.so.1")
    except OSError:
        return None
    sigs = {
        "heif_context_alloc": (C.c_void_p, []),
        "heif_context_free": (None, [C.c_void_p]),
        "heif_context_read_from_memory_without_copy":
            (_Err, [C.c_void_p, C.c_char_p, C.c_size_t, C.c_void_p]),
        "heif_context_get_primary_image_handle":
            (_Err, [C.c_void_p, C.POINTER(C.c_void_p)]),
        "heif_context_get_number_of_top_level_images":
            (C.c_int, [C.c_void_p]),
        "heif_context_get_list_of_top_level_image_IDs":
            (C.c_int, [C.c_void_p, C.POINTER(C.c_uint32), C.c_int]),
        "heif_context_get_image_handle":
            (_Err, [C.c_void_p, C.c_uint32, C.POINTER(C.c_void_p)]),
        "heif_image_handle_get_width": (C.c_int, [C.c_void_p]),
        "heif_image_handle_get_height": (C.c_int, [C.c_void_p]),
        "heif_image_handle_has_alpha_channel": (C.c_int, [C.c_void_p]),
        "heif_image_handle_release": (None, [C.c_void_p]),
        "heif_decode_image":
            (_Err, [C.c_void_p, C.POINTER(C.c_void_p), C.c_int, C.c_int,
                    C.c_void_p]),
        "heif_image_get_plane_readonly":
            (C.POINTER(C.c_uint8), [C.c_void_p, C.c_int,
                                    C.POINTER(C.c_int)]),
        "heif_image_get_plane":
            (C.POINTER(C.c_uint8), [C.c_void_p, C.c_int,
                                    C.POINTER(C.c_int)]),
        "heif_image_release": (None, [C.c_void_p]),
        "heif_image_create":
            (_Err, [C.c_int, C.c_int, C.c_int, C.c_int,
                    C.POINTER(C.c_void_p)]),
        "heif_image_add_plane":
            (_Err, [C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_int]),
        "heif_context_get_encoder_for_format":
            (_Err, [C.c_void_p, C.c_int, C.POINTER(C.c_void_p)]),
        "heif_encoder_set_lossy_quality": (_Err, [C.c_void_p, C.c_int]),
        "heif_encoder_set_lossless": (_Err, [C.c_void_p, C.c_int]),
        "heif_encoder_release": (None, [C.c_void_p]),
        "heif_context_encode_image":
            (_Err, [C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,
                    C.POINTER(C.c_void_p)]),
        "heif_context_write_to_file": (_Err, [C.c_void_p, C.c_char_p]),
        "heif_have_decoder_for_format": (C.c_int, [C.c_int]),
        "heif_have_encoder_for_format": (C.c_int, [C.c_int]),
    }
    try:
        for name, (res, args) in sigs.items():
            f = getattr(lib, name)
            f.restype = res
            f.argtypes = args
    except AttributeError:
        return None
    _lib = lib
    return _lib


def is_available() -> bool:
    return _bind() is not None


def _check(err: _Err, what: str) -> None:
    if err.code != 0:
        msg = (err.message or b"").decode("utf-8", "replace")
        raise ValueError(f"HEIF: {what} failed: {msg}")


def _decode_handle(lib, handle) -> np.ndarray:
    img = C.c_void_p()
    _check(lib.heif_decode_image(handle, C.byref(img), _COLORSPACE_RGB,
                                 _CHROMA_INTERLEAVED_RGBA, None), "decode")
    try:
        w = lib.heif_image_handle_get_width(handle)
        h = lib.heif_image_handle_get_height(handle)
        stride = C.c_int()
        p = lib.heif_image_get_plane_readonly(img, _CHANNEL_INTERLEAVED,
                                              C.byref(stride))
        if not p:
            raise ValueError("HEIF: no interleaved plane")
        rows = np.ctypeslib.as_array(p, shape=(h, stride.value))
        return rows[:, :w * 4].reshape(h, w, 4).copy()
    finally:
        lib.heif_image_release(img)


def decode_frames(data: bytes, all_frames: bool = False) -> np.ndarray:
    """The primary image (or, with all_frames, every top-level image)
    decoded by libheif -> [N, H, W, 4] u8 on the host."""
    lib = _bind()
    if lib is None:
        raise ValueError("HEIF: libheif unavailable in this environment")
    data = bytes(data)
    ctx = lib.heif_context_alloc()
    try:
        _check(lib.heif_context_read_from_memory_without_copy(
            ctx, data, len(data), None), "parse")
        handles = []
        if all_frames:
            n = lib.heif_context_get_number_of_top_level_images(ctx)
            ids = (C.c_uint32 * max(n, 1))()
            lib.heif_context_get_list_of_top_level_image_IDs(ctx, ids, n)
            for i in range(n):
                hd = C.c_void_p()
                _check(lib.heif_context_get_image_handle(
                    ctx, ids[i], C.byref(hd)), "image handle")
                handles.append(hd)
        else:
            hd = C.c_void_p()
            _check(lib.heif_context_get_primary_image_handle(
                ctx, C.byref(hd)), "primary image")
            handles.append(hd)
        frames = []
        try:
            for hd in handles:
                frames.append(_decode_handle(lib, hd))
        finally:
            for hd in handles:
                lib.heif_image_handle_release(hd)
    finally:
        lib.heif_context_free(ctx)
    return np.stack(frames)


def load_from_heif_memory(data: bytes, all_frames: bool = False,
                          srgb: bool = True, device=None) -> Texture:
    """Decode the primary image (or, with all_frames, every top-level
    image as an array item) to RGBA8, on `device` (CUDA unless named)."""
    frames = torch.from_numpy(decode_frames(data, all_frames))
    arr = numerics.fdiv(frames.to(resolve(device)).to(torch.float32), 255.0)
    fmt = FMT.R8G8B8A8_UNORM_SRGB if srgb else FMT.R8G8B8A8_UNORM
    meta = TexMetadata(
        width=arr.shape[2], height=arr.shape[1], depth=1,
        array_size=arr.shape[0], mip_levels=1, format=fmt,
        dimension=TexDimension.TEXTURE2D)
    return Texture(meta, [arr])


def load_from_heif_file(path, **kwargs) -> Texture:
    with open(path, "rb") as f:
        return load_from_heif_memory(f.read(), **kwargs)


def save_to_heif_memory(tex: Texture, mip: int = 0, item: int = 0,
                        compression: str = "hevc",
                        quality: float | None = None,
                        lossless: bool = False) -> bytes:
    """Encode one subresource as HEIC (hevc) or AVIF (av1). `quality`
    in [0, 1] maps to the encoder's lossy-quality property, like the
    WIC ImageQuality bag option (DirectXTexWIC.cpp:1404)."""
    lib = _bind()
    if lib is None:
        raise ValueError("HEIF: libheif unavailable in this environment")
    comp = _COMPRESSION.get(compression)
    if comp is None:
        raise ValueError(f"HEIF: unknown compression {compression!r}")
    u8 = to_rgba8(tex.image(mip, item))
    h, w = u8.shape[:2]

    ctx = lib.heif_context_alloc()
    enc = C.c_void_p()
    him = C.c_void_p()
    try:
        _check(lib.heif_context_get_encoder_for_format(
            ctx, comp, C.byref(enc)), "encoder lookup")
        if lossless:
            _check(lib.heif_encoder_set_lossless(enc, 1), "set lossless")
        if quality is not None:
            _check(lib.heif_encoder_set_lossy_quality(
                enc, int(round(quality * 100))), "set quality")
        _check(lib.heif_image_create(
            w, h, _COLORSPACE_RGB, _CHROMA_INTERLEAVED_RGBA,
            C.byref(him)), "image create")
        _check(lib.heif_image_add_plane(
            him, _CHANNEL_INTERLEAVED, w, h, 8), "add plane")
        stride = C.c_int()
        p = lib.heif_image_get_plane(him, _CHANNEL_INTERLEAVED,
                                     C.byref(stride))
        rows = np.ctypeslib.as_array(p, shape=(h, stride.value))
        rows[:, :w * 4] = u8.reshape(h, -1)
        _check(lib.heif_context_encode_image(ctx, him, enc, None, None),
               "encode")
        # libheif's streaming writer returns a struct by value from a
        # callback (not expressible in ctypes); round-trip through a
        # temp file instead.
        fd, path = tempfile.mkstemp(suffix=".heif")
        os.close(fd)
        try:
            _check(lib.heif_context_write_to_file(ctx, path.encode()),
                   "write")
            with open(path, "rb") as f:
                return f.read()
        finally:
            os.remove(path)
    finally:
        if him:
            lib.heif_image_release(him)
        if enc:
            lib.heif_encoder_release(enc)
        lib.heif_context_free(ctx)


def save_to_heif_file(tex: Texture, path, **kwargs) -> None:
    if "compression" not in kwargs:
        ext = os.path.splitext(str(path))[1].lower()
        kwargs["compression"] = "av1" if ext == ".avif" else "hevc"
    with open(path, "wb") as f:
        f.write(save_to_heif_memory(tex, **kwargs))
