"""PNG/JPEG/BMP/TIFF/GIF codec bridge on torch tensors.

The counterpart of directxtex_tpu/io/wic.py. The reference's WIC layer
(DirectXTexWIC.cpp, Windows-only) negotiates pixel formats with the OS
imaging stack; the port bridges through Pillow, imported inside the
functions that use it. Format mapping follows WICToDXGI
(DirectXTexUtil.cpp:135): 8-bit RGB(A) -> R8G8B8A8_UNORM, 16-bit ->
R16G16B16A16_UNORM, grayscale -> R8/R16, float TIFF -> R32G32B32A32_FLOAT.

Pillow decodes on the host; the decoded samples go to the device in one
copy and are normalized there (an IEEE division, as numpy's). A save
rounds to 8 bits on the texture's device and makes one D2H copy.

Scope note: the reference enumerates whatever codecs the OS WIC runtime
ships — on Windows that adds JPEG-XR (WIC_CODEC_WMP) and, with the OS
extension installed, HEIF (whose Windows codec also fronts AVIF).
HEIF/HEIC/AVIF are supported here through the system libheif binding
(io/heif.py), mirroring that optional OS dependency. JPEG-XR has no
codec here and is out of scope: `WIC_CODEC.WMP` raises a clear error
rather than silently re-encoding.
"""

from __future__ import annotations

import enum
import io as _io

import numpy as np
import torch

from .. import numerics
from ..formats.dxgi import FMT
from ..formats.packing import _sat
from ..formats.traits import make_linear
from ..texture import Texture
from ..utils.device import resolve

__all__ = ["WIC_FLAGS", "load_from_wic_memory", "save_to_wic_memory",
           "load_from_wic_file", "save_to_wic_file", "WIC_CODEC",
           "get_metadata_queries_from_wic_memory",
           "get_metadata_queries_from_wic_file"]


class WIC_FLAGS(enum.IntFlag):
    """DirectXTex.h:305-347 (subset meaningful outside Windows)."""
    NONE = 0
    FORCE_RGB = 0x1
    NO_X2_BIAS = 0x2
    NO_16BPP = 0x4
    ALLOW_MONO = 0x8
    ALL_FRAMES = 0x10
    IGNORE_SRGB = 0x20
    FORCE_SRGB = 0x40
    FORCE_LINEAR = 0x80
    DEFAULT_SRGB = 0x100
    DITHER = 0x10000
    DITHER_DIFFUSION = 0x20000


class WIC_CODEC(enum.IntEnum):
    """DirectXTex.h WIC_CODEC enum."""
    BMP = 1
    JPEG = 2
    PNG = 3
    TIFF = 4
    GIF = 5
    WMP = 6
    ICO = 7
    HEIF = 8


_PIL_FORMAT = {
    WIC_CODEC.BMP: "BMP", WIC_CODEC.JPEG: "JPEG", WIC_CODEC.PNG: "PNG",
    WIC_CODEC.TIFF: "TIFF", WIC_CODEC.GIF: "GIF", WIC_CODEC.ICO: "ICO",
}


def _host_frame(im, flags: WIC_FLAGS):
    """One Pillow frame -> (samples [H, W, C] u8 / u16 / f32 on the host,
    their full-scale value (None for float), DXGI format)."""
    mode = im.mode
    srgb = not (flags & WIC_FLAGS.FORCE_LINEAR)
    rgba_fmt = FMT.R8G8B8A8_UNORM_SRGB if srgb else FMT.R8G8B8A8_UNORM
    if mode in ("1", "L"):
        arr, full, fmt = np.asarray(im.convert("L"), np.uint8)[..., None], \
            255.0, FMT.R8_UNORM
    elif mode == "I;16":
        arr, full, fmt = np.asarray(im, np.uint16)[..., None], 65535.0, \
            FMT.R16_UNORM
    elif mode == "F":
        arr, full, fmt = np.asarray(im, np.float32)[..., None], None, \
            FMT.R32_FLOAT
    else:               # P, RGB, RGBA, LA and the rest go through RGBA8
        arr, full, fmt = np.asarray(im.convert("RGBA"), np.uint8), 255.0, \
            rgba_fmt
    if flags & WIC_FLAGS.IGNORE_SRGB:
        fmt = make_linear(fmt)
    return np.array(arr, order="C"), full, fmt     # a writable copy


def _device_frames(samples: np.ndarray, full, fmt, device) -> Texture:
    """[N, H, W, C] host samples -> a texture of N items: one copy, then
    samples / full in f32 on the device."""
    arr = torch.from_numpy(samples).to(resolve(device))
    if arr.dtype == torch.int16:            # u16 samples travel as i16
        arr = arr.to(torch.int32) & 0xFFFF
    arr = arr.to(torch.float32)
    if full is not None:
        arr = numerics.fdiv(arr, full)
    return Texture.from_array(arr, fmt=fmt, device=device)


def _to_texture(im, flags: WIC_FLAGS, device=None) -> Texture:
    arr, full, fmt = _host_frame(im, flags)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    return _device_frames(arr[None], full, fmt, device)


def _sniff_heif(data: bytes) -> bool:
    """ISOBMFF ftyp brand check for HEIF-family containers."""
    return (len(data) >= 12 and data[4:8] == b"ftyp"
            and data[8:12] in (b"heic", b"heix", b"hevc", b"heim", b"heis",
                               b"hevm", b"hevs", b"mif1", b"msf1", b"avif",
                               b"avis"))


def load_from_wic_memory(data: bytes, flags: WIC_FLAGS = WIC_FLAGS.NONE,
                         device=None) -> Texture:
    """Decode with Pillow (HEIF-family containers Pillow cannot open go to
    io/heif.py), on `device` (CUDA unless named)."""
    from PIL import Image, UnidentifiedImageError
    data = bytes(data)
    flags = WIC_FLAGS(flags)
    if _sniff_heif(data[:12]):
        try:
            Image.open(_io.BytesIO(data)).close()
        except UnidentifiedImageError:
            from . import heif
            return heif.load_from_heif_memory(
                data, all_frames=bool(flags & WIC_FLAGS.ALL_FRAMES),
                srgb=not (flags & WIC_FLAGS.FORCE_LINEAR), device=device)
    with Image.open(_io.BytesIO(data)) as im:
        if (flags & WIC_FLAGS.ALL_FRAMES) and getattr(im, "n_frames", 1) > 1:
            frames = []
            for i in range(im.n_frames):
                im.seek(i)
                frames.append(_host_frame(im.copy(), flags))
            arr, full, fmt = frames[0]
            samples = np.stack([f[0] for f in frames])
            if samples.dtype == np.uint16:
                samples = samples.view(np.int16)
            return _device_frames(samples, full, fmt, device)
        return _to_texture(im.copy(), flags, device)


def get_metadata_queries_from_wic_memory(data: bytes) -> dict:
    """Metadata-query analog of the reference's getMQR hook
    (GetMetadataFromWICMemoryEx's IWICMetadataQueryReader callback,
    DirectXTexWIC.cpp:1213-1575): returns the container's queryable
    metadata as a flat dict — codec name, size, mode, EXIF tags (by
    decoded tag name), ICC-profile presence, and any codec-specific
    info keys Pillow surfaces (dpi, gamma, chromaticity, ...).

    JXR has no codec in this environment and is reported via ValueError,
    matching an unsupported-container WIC failure. HEIC containers that
    Pillow cannot identify fall back to basic libheif-derived fields."""
    from PIL import Image, UnidentifiedImageError
    out: dict = {}
    if _sniff_heif(bytes(data[:12])):
        try:
            Image.open(_io.BytesIO(data)).close()
        except UnidentifiedImageError:
            from . import heif
            frames = heif.decode_frames(data, all_frames=True)
            return {"codec": "heif", "width": frames.shape[2],
                    "height": frames.shape[1], "mode": "RGBA",
                    "n_frames": frames.shape[0], "has_icc_profile": False}
    with Image.open(_io.BytesIO(data)) as im:
        out["codec"] = (im.format or "").lower()
        out["width"], out["height"] = im.size
        out["mode"] = im.mode
        out["n_frames"] = getattr(im, "n_frames", 1)
        for k, v in im.info.items():
            if k in ("exif", "icc_profile"):
                continue
            if isinstance(v, (int, float, str, tuple)):
                out[k] = v
        out["has_icc_profile"] = "icc_profile" in im.info
        exif = im.getexif()
        if exif:
            from PIL import ExifTags
            out["exif"] = {
                ExifTags.TAGS.get(tag, str(tag)): val
                for tag, val in exif.items()
                if isinstance(val, (int, float, str, tuple))}
    return out


def get_metadata_queries_from_wic_file(path) -> dict:
    with open(path, "rb") as f:
        return get_metadata_queries_from_wic_memory(f.read())


def to_rgba8(img: torch.Tensor) -> np.ndarray:
    """[..., 4] f32 -> u8 on the host: round(x * 255) clipped to 0..255 on
    the tensor's device (NaN -> 0), then one D2H copy."""
    u8 = _sat(torch.round(img * 255.0).clamp(0, 255), 0, 255)
    return u8.to(torch.uint8).cpu().numpy()


def _to_pil(tex: Texture, codec: WIC_CODEC, mip: int, item: int):
    from PIL import Image
    u8 = to_rgba8(tex.image(mip, item))
    if codec == WIC_CODEC.JPEG:
        return Image.fromarray(u8[..., :3], "RGB")
    return Image.fromarray(u8, "RGBA")


def save_to_wic_memory(tex: Texture, codec: WIC_CODEC,
                       flags: WIC_FLAGS = WIC_FLAGS.NONE,
                       mip: int = 0, item: int = 0,
                       quality: float | None = None, **save_kwargs) -> bytes:
    """Encode one subresource (or, with WIC_FLAGS.ALL_FRAMES on a GIF/TIFF
    target, every array item as a frame). `quality` in [0, 1] maps to the
    codec's quality property (IPropertyBag2 "ImageQuality",
    DirectXTexWIC.cpp:1404)."""
    if codec == WIC_CODEC.HEIF:
        from . import heif
        return heif.save_to_heif_memory(tex, mip=mip, item=item,
                                        quality=quality, **save_kwargs)
    if quality is not None:
        if codec == WIC_CODEC.JPEG:
            save_kwargs.setdefault("quality", int(round(quality * 100)))
        elif codec == WIC_CODEC.PNG:
            # PNG is lossless; quality steers effort/size tradeoff
            save_kwargs.setdefault("compress_level",
                                   int(round((1.0 - quality) * 9)))
    pil = _to_pil(tex, codec, mip, item)
    buf = _io.BytesIO()
    if (flags & WIC_FLAGS.ALL_FRAMES) and tex.metadata.array_size > 1 \
            and codec in (WIC_CODEC.GIF, WIC_CODEC.TIFF):
        rest = [_to_pil(tex, codec, mip, i)
                for i in range(1, tex.metadata.array_size)]
        pil.save(buf, format=_PIL_FORMAT[codec], save_all=True,
                 append_images=rest, **save_kwargs)
    else:
        pil.save(buf, format=_PIL_FORMAT[codec], **save_kwargs)
    return buf.getvalue()


_EXT_CODEC = {
    ".bmp": WIC_CODEC.BMP, ".jpg": WIC_CODEC.JPEG, ".jpeg": WIC_CODEC.JPEG,
    ".png": WIC_CODEC.PNG, ".tif": WIC_CODEC.TIFF, ".tiff": WIC_CODEC.TIFF,
    ".gif": WIC_CODEC.GIF, ".ico": WIC_CODEC.ICO,
    ".heic": WIC_CODEC.HEIF, ".heif": WIC_CODEC.HEIF,
    ".avif": WIC_CODEC.HEIF,
}


def load_from_wic_file(path, flags: WIC_FLAGS = WIC_FLAGS.NONE,
                       device=None) -> Texture:
    with open(path, "rb") as f:
        return load_from_wic_memory(f.read(), flags, device)


def save_to_wic_file(tex: Texture, path,
                     flags: WIC_FLAGS = WIC_FLAGS.NONE, **kw) -> None:
    import os
    ext = os.path.splitext(str(path))[1].lower()
    codec = _EXT_CODEC.get(ext)
    if codec is None:
        raise ValueError(f"unknown image extension {ext!r}")
    if codec == WIC_CODEC.HEIF:
        kw.setdefault("compression", "av1" if ext == ".avif" else "hevc")
    with open(path, "wb") as f:
        f.write(save_to_wic_memory(tex, codec, flags, **kw))
