"""TGA (Truevision) container codec on torch tensors.

The counterpart of directxtex_tpu/io/tga.py (DirectXTexTGA.cpp): 8/16/24/
32-bpp truecolor, grayscale and palettized images, RLE decompression,
right-to-left / top-to-bottom origin handling, the TGA 2.0 footer (alpha
mode + gamma metadata), the all-zero-alpha -> opaque heuristic, and an
uncompressed TGA 2.0 writer (the reference writer is always uncompressed,
DirectXTexTGA.cpp:18-20).

A load runs in three stages: `_host_parse` reads the header and footer
and decodes the RLE packets on the host (the port's native rle_codec.cpp;
`_decode_rle_py` is its numpy twin, for tests), the pixel bytes go to the
device in one copy, and `_device_decode` orients, swizzles and unpacks
them there (formats.packing) and applies the zero-alpha rule without a
host sync. A save packs on the texture's device and makes one D2H copy.
"""

from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np
import torch

from .. import native
from ..formats.dxgi import FMT, DXGIFormat
from ..formats.packing import pack, pack_image, unpack
from ..formats.traits import is_srgb, make_srgb
from ..texture import TexAlphaMode, TexDimension, TexMetadata, Texture
from ..utils.device import resolve

__all__ = [
    "TGA_FLAGS", "get_metadata_from_tga_memory", "load_from_tga_memory",
    "save_to_tga_memory", "load_from_tga_file", "save_to_tga_file",
]


class TGA_FLAGS(enum.IntFlag):
    """DirectXTex.h:282-303."""
    NONE = 0
    BGR = 0x1
    ALLOW_ALL_ZERO_ALPHA = 0x2
    IGNORE_SRGB = 0x10
    FORCE_SRGB = 0x20
    FORCE_LINEAR = 0x40
    DEFAULT_SRGB = 0x80


_FOOTER_SIG = b"TRUEVISION-XFILE.\x00"
_HEADER = struct.Struct("<BBBHHBHHHHBB")  # 18 bytes

# image types
_TGA_NO_IMAGE = 0
_TGA_COLORMAPPED = 1
_TGA_TRUECOLOR = 2
_TGA_BLACK_AND_WHITE = 3
_TGA_RLE = 8


@dataclasses.dataclass
class _TGAInfo:
    width: int
    height: int
    bpp: int
    image_type: int
    rle: bool
    right_to_left: bool
    top_down: bool
    id_length: int
    cm_first: int
    cm_length: int
    cm_size: int
    format: DXGIFormat
    alpha_bits: int


def _parse_header(data: bytes, flags: TGA_FLAGS) -> _TGAInfo:
    if len(data) < _HEADER.size:
        raise ValueError("TGA: file too small for header")
    (id_len, cm_type, img_type, cm_first, cm_len, cm_size,
     _xorg, _yorg, w, h, bpp, desc) = _HEADER.unpack_from(data, 0)

    base_type = img_type & ~_TGA_RLE
    rle = bool(img_type & _TGA_RLE)

    if base_type == _TGA_COLORMAPPED:
        if cm_type != 1 or cm_size not in (24, 32) or bpp != 8:
            raise ValueError("TGA: unsupported colormap layout")
        fmt = (FMT.B8G8R8A8_UNORM if flags & TGA_FLAGS.BGR
               else FMT.R8G8B8A8_UNORM) if cm_size == 32 else (
            FMT.B8G8R8X8_UNORM if flags & TGA_FLAGS.BGR else FMT.R8G8B8A8_UNORM)
    elif base_type == _TGA_TRUECOLOR:
        if cm_type != 0:
            raise ValueError("TGA: truecolor image with colormap")
        if bpp == 16:
            fmt = FMT.B5G5R5A1_UNORM
        elif bpp == 24:
            fmt = FMT.B8G8R8X8_UNORM if flags & TGA_FLAGS.BGR else FMT.R8G8B8A8_UNORM
        elif bpp == 32:
            fmt = FMT.B8G8R8A8_UNORM if flags & TGA_FLAGS.BGR else FMT.R8G8B8A8_UNORM
        else:
            raise ValueError(f"TGA: unsupported truecolor depth {bpp}")
    elif base_type == _TGA_BLACK_AND_WHITE:
        if bpp != 8:
            raise ValueError(f"TGA: unsupported grayscale depth {bpp}")
        fmt = FMT.R8_UNORM
    elif base_type == _TGA_NO_IMAGE:
        raise ValueError("TGA: file contains no image data")
    else:
        raise ValueError(f"TGA: unknown image type {img_type}")

    if w == 0 or h == 0:
        raise ValueError("TGA: zero-sized image")

    return _TGAInfo(
        width=w, height=h, bpp=bpp, image_type=base_type, rle=rle,
        right_to_left=bool(desc & 0x10), top_down=bool(desc & 0x20),
        id_length=id_len, cm_first=cm_first, cm_length=cm_len,
        cm_size=cm_size if base_type == _TGA_COLORMAPPED else 0,
        format=fmt, alpha_bits=desc & 0xF,
    )


def _parse_footer(data: bytes):
    """Returns (alpha_mode, is_srgb or None) from the TGA 2.0 extension area
    (DirectXTexTGA.cpp footer handling)."""
    alpha_mode = TexAlphaMode.UNKNOWN
    srgb = None
    if len(data) >= 26 and data[-18:] == _FOOTER_SIG:
        ext_off, _dev_off = struct.unpack_from("<II", data, len(data) - 26)
        if ext_off and ext_off + 495 <= len(data):
            ext = data[ext_off:ext_off + 495]
            size = struct.unpack_from("<H", ext, 0)[0]
            if size >= 495:
                gamma_num, gamma_den = struct.unpack_from("<HH", ext, 478)
                attrs = ext[494]
                if attrs in (0, 1):
                    alpha_mode = TexAlphaMode.OPAQUE
                elif attrs == 3:
                    alpha_mode = TexAlphaMode.STRAIGHT
                elif attrs == 4:
                    alpha_mode = TexAlphaMode.PREMULTIPLIED
                if gamma_den != 0:
                    g = gamma_num / gamma_den
                    srgb = abs(g - 2.2) < 0.05
    return alpha_mode, srgb


def _apply_srgb_meta(data: bytes, fmt: DXGIFormat,
                     flags: TGA_FLAGS) -> DXGIFormat:
    if flags & TGA_FLAGS.IGNORE_SRGB:
        return fmt
    _, srgb = _parse_footer(data)
    if srgb is None and (flags & TGA_FLAGS.DEFAULT_SRGB):
        srgb = True
    if srgb:
        return make_srgb(fmt)
    return fmt


def get_metadata_from_tga_memory(data: bytes,
                                 flags: TGA_FLAGS = TGA_FLAGS.NONE) -> TexMetadata:
    """GetMetadataFromTGAMemory (DirectXTexTGA.cpp:1888)."""
    data = bytes(data)
    info = _parse_header(data, TGA_FLAGS(flags))
    fmt = _apply_srgb_meta(data, info.format, TGA_FLAGS(flags))
    alpha_mode, _ = _parse_footer(data)
    return TexMetadata(width=info.width, height=info.height,
                       format=fmt, misc_flags2=int(alpha_mode),
                       dimension=TexDimension.TEXTURE2D)


def _decode_rle_py(data: np.ndarray, bytes_pp: int, count: int) -> np.ndarray:
    """Numpy twin of the native TGA RLE decode (`count` pixels of
    `bytes_pp` bytes): the JAX package's Python decoder, for tests."""
    out = np.empty(count * bytes_pp, np.uint8)
    si = 0
    di = 0
    n = len(data)
    while di < count * bytes_pp:
        if si >= n:
            raise ValueError("TGA: RLE data truncated")
        # int() avoids numpy uint8 wraparound in the size arithmetic below
        hdr = int(data[si])
        si += 1
        run = (hdr & 0x7F) + 1
        if hdr & 0x80:  # run-length packet
            if si + bytes_pp > n:
                raise ValueError("TGA: RLE run truncated")
            px = data[si:si + bytes_pp]
            si += bytes_pp
            end = min(di + run * bytes_pp, count * bytes_pp)
            out[di:end] = np.tile(px, run)[: end - di]
            di = end
        else:  # raw packet
            nbytes = run * bytes_pp
            if si + nbytes > n:
                raise ValueError("TGA: RLE raw packet truncated")
            end = min(di + nbytes, count * bytes_pp)
            out[di:end] = data[si:si + (end - di)]
            si += nbytes
            di = end
    return out


def _swap_rb(px: torch.Tensor) -> torch.Tensor:
    """[..., 4] RGBA <-> BGRA (a flip and a cat: an index list would be
    copied to the device, a host sync)."""
    return torch.cat([px[..., :3].flip(-1), px[..., 3:]], -1)


@dataclasses.dataclass
class _Plan:
    """What the device stage needs: the header, the flags, the palette's
    byte count at the head of the payload, and the texture's metadata."""
    info: _TGAInfo
    flags: TGA_FLAGS
    palette_bytes: int
    metadata: TexMetadata


def _host_parse(data: bytes, flags: TGA_FLAGS = TGA_FLAGS.NONE):
    """Header, footer, palette and RLE on the host -> (payload, plan): the
    payload is one u8 array, the palette as RGBA8 rows (colormapped files)
    followed by the pixel bytes in file order."""
    data = bytes(data)
    flags = TGA_FLAGS(flags)
    info = _parse_header(data, flags)
    offset = _HEADER.size + info.id_length

    parts = []
    cm_bytes = 0
    if info.image_type == _TGA_COLORMAPPED:
        entry_bytes = info.cm_size // 8
        cm_bytes = info.cm_length * entry_bytes
        raw_pal = np.frombuffer(data, np.uint8, cm_bytes, offset).reshape(
            info.cm_length, entry_bytes)
        # palette entries are BGR(A) on disk
        palette = np.zeros((info.cm_first + info.cm_length, 4), np.uint8)
        palette[:, 3] = 255
        palette[info.cm_first:, 0] = raw_pal[:, 2]
        palette[info.cm_first:, 1] = raw_pal[:, 1]
        palette[info.cm_first:, 2] = raw_pal[:, 0]
        if entry_bytes == 4:
            palette[info.cm_first:, 3] = raw_pal[:, 3]
        parts.append(palette.reshape(-1))
    offset += cm_bytes

    npix = info.width * info.height
    bytes_pp = info.bpp // 8
    if info.rle:
        parts.append(native.tga_rle_decode(data[offset:], npix, bytes_pp))
    else:
        need = npix * bytes_pp
        if len(data) - offset < need:
            raise ValueError("TGA: pixel data truncated")
        parts.append(np.frombuffer(data, np.uint8, need, offset))
    payload = np.concatenate(parts)

    alpha_mode, _ = _parse_footer(data)
    meta = TexMetadata(width=info.width, height=info.height,
                       format=_apply_srgb_meta(data, info.format, flags),
                       misc_flags2=int(alpha_mode),
                       dimension=TexDimension.TEXTURE2D)
    palette_bytes = parts[0].size if len(parts) == 2 else 0
    return payload, _Plan(info, flags, palette_bytes, meta)


def _device_decode(payload: torch.Tensor, plan: _Plan) -> Texture:
    """Orient, swizzle and unpack the pixel bytes on their device; the
    all-zero-alpha rule as a device select."""
    info, flags = plan.info, plan.flags
    h, w = info.height, info.width
    npix = h * w
    px = payload[plan.palette_bytes:].reshape(h, w, info.bpp // 8)
    # origin handling: default is bottom-left
    if not info.top_down:
        px = px.flip(0)
    if info.right_to_left:
        px = px.flip(1)

    if info.image_type == _TGA_COLORMAPPED:
        palette = payload[:plan.palette_bytes].reshape(-1, 4)
        rgba8 = palette[px[..., 0].to(torch.int64)]
        if flags & TGA_FLAGS.BGR:
            fmt_wire, wire = FMT.B8G8R8A8_UNORM, _swap_rb(rgba8)
        else:
            fmt_wire, wire = FMT.R8G8B8A8_UNORM, rgba8
    elif info.bpp == 24:
        # expand 24bpp BGR -> 32bpp; disk order is B,G,R
        expanded = torch.cat([px, torch.full_like(px[..., :1], 255)], -1)
        if info.format == FMT.R8G8B8A8_UNORM:
            fmt_wire, wire = FMT.R8G8B8A8_UNORM, _swap_rb(expanded)
        else:
            fmt_wire, wire = FMT.B8G8R8X8_UNORM, expanded
    elif info.bpp == 32 and info.format == FMT.R8G8B8A8_UNORM:
        fmt_wire, wire = FMT.R8G8B8A8_UNORM, _swap_rb(px)
    else:  # 32bpp BGRA, 8bpp gray or 16bpp 5551 pass straight to the codec
        fmt_wire, wire = info.format, px
    arr = unpack(fmt_wire, wire.reshape(-1), npix).reshape(h, w, 4)

    has_alpha_bits = info.bpp in (16, 32) or (
        info.image_type == _TGA_COLORMAPPED and info.cm_size == 32)
    if has_alpha_bits and not (flags & TGA_FLAGS.ALLOW_ALL_ZERO_ALPHA):
        # all-zero-alpha -> opaque heuristic (DirectXTexTGA.cpp
        # SetAlphaChannelToOpaque), decided on the device
        a = arr[..., 3]
        a = torch.where((a == 0.0).all(), torch.ones_like(a), a)
        arr = torch.cat([arr[..., :3], a[..., None]], -1)
    return Texture(plan.metadata, [arr[None]])


def load_from_tga_memory(data: bytes, flags: TGA_FLAGS = TGA_FLAGS.NONE,
                         device=None) -> Texture:
    """LoadFromTGAMemory (DirectXTexTGA.cpp:2008), on `device` (CUDA
    unless named)."""
    payload, plan = _host_parse(data, flags)
    return _device_decode(torch.from_numpy(payload).to(resolve(device)),
                          plan)


_SUPPORTED_SAVE = {
    FMT.R8G8B8A8_UNORM: 32, FMT.R8G8B8A8_UNORM_SRGB: 32,
    FMT.B8G8R8A8_UNORM: 32, FMT.B8G8R8A8_UNORM_SRGB: 32,
    FMT.B8G8R8X8_UNORM: 24, FMT.B8G8R8X8_UNORM_SRGB: 24,
    FMT.B5G5R5A1_UNORM: 16, FMT.R8_UNORM: 8, FMT.A8_UNORM: 8,
}


def save_to_tga_memory(tex: Texture, flags: TGA_FLAGS = TGA_FLAGS.NONE,
                       mip: int = 0, item: int = 0) -> bytes:
    """SaveToTGAMemory (DirectXTexTGA.cpp:2249): uncompressed TGA 2.0. The
    pixels pack on the texture's device and come to the host in one
    copy."""
    flags = TGA_FLAGS(flags)
    fmt = tex.metadata.format
    if fmt not in _SUPPORTED_SAVE:
        raise ValueError(f"TGA save: unsupported format {fmt!r}")
    bpp = _SUPPORTED_SAVE[fmt]
    img = tex.image(mip, item)
    h, w = img.shape[:2]

    if bpp == 8:
        chan = 3 if fmt == FMT.A8_UNORM else 0
        wire = pack(FMT.R8_UNORM, img[..., chan].reshape(-1, 1).expand(-1, 4))
        img_type, desc = _TGA_BLACK_AND_WHITE, 0
    elif bpp == 16:
        wire = pack_image(FMT.B5G5R5A1_UNORM, img)
        img_type, desc = _TGA_TRUECOLOR, 1  # 1 alpha bit
    else:
        rgba = pack_image(FMT.R8G8B8A8_UNORM, img).reshape(h, w, 4)
        if bpp == 24:
            wire, desc = rgba[..., :3].flip(-1), 0  # disk is BGR
        else:
            wire, desc = _swap_rb(rgba), 8  # BGRA, 8 alpha bits
        img_type = _TGA_TRUECOLOR

    header = _HEADER.pack(0, 0, img_type, 0, 0, 0, 0, 0, w, h, bpp, desc | 0x20)
    body = wire.contiguous().cpu().numpy().tobytes()  # top-down (bit 5 set)

    # TGA 2.0 extension area + footer
    ext = bytearray(495)
    struct.pack_into("<H", ext, 0, 495)
    srgb_out = is_srgb(fmt) or bool(flags & TGA_FLAGS.FORCE_SRGB)
    if flags & TGA_FLAGS.FORCE_LINEAR:
        srgb_out = False
    struct.pack_into("<HH", ext, 478, 22 if srgb_out else 10, 10)
    alpha_mode = tex.metadata.alpha_mode()
    if bpp in (16, 32):
        attrs = 4 if alpha_mode == TexAlphaMode.PREMULTIPLIED else 3
    else:
        attrs = 0
    ext[494] = attrs
    ext_offset = len(header) + len(body)
    footer = struct.pack("<II", ext_offset, 0) + _FOOTER_SIG

    return header + body + bytes(ext) + footer


def load_from_tga_file(path, flags: TGA_FLAGS = TGA_FLAGS.NONE,
                       device=None) -> Texture:
    with open(path, "rb") as f:
        return load_from_tga_memory(f.read(), flags, device)


def save_to_tga_file(tex: Texture, path,
                     flags: TGA_FLAGS = TGA_FLAGS.NONE) -> None:
    with open(path, "wb") as f:
        f.write(save_to_tga_memory(tex, flags))
