"""DDS container codec, the port's counterpart of directxtex_tpu/io/dds.py.

Mirrors DirectXTexDDS.cpp + DDS.h: magic/header validation, the DX10
extension header, the 72-entry legacy D3D9 pixel-format map
(DirectXTexDDS.cpp:61-182), mask-based format matching (:184-318),
DDS_FLAGS behavior switches, legacy pixel fix-ups
(LegacyExpandScanline/LegacyConvertScanline :1100-1515, vectorized with
numpy), and the DX9-compatible header writer (EncodeDDSHeader :711). The
header code and the legacy steps are the JAX package's host code, kept
here as the port's own copy.

Uncompressed images unpack on the device to f32 RGBA `Texture`s; BC
formats load as `CompressedTexture` u8 block bytes on the device (decode
via ops.compress.decompress).
"""

from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np

import torch

from ..formats.dxgi import FMT, DXGIFormat
from ..formats import traits
from ..formats.packing import (is_packable, pack, planar_to_single, unpack,
                               unpack_planar_image)
from ..formats.traits import CP_FLAGS, compute_pitch, make_srgb
from ..texture import (
    CompressedTexture, TexAlphaMode, TexDimension, TexMetadata, TexMiscFlag,
    Texture,
)
from ..utils.device import resolve
from ..utils.errors import TexArithmeticOverflowError

__all__ = [
    "DDS_FLAGS", "DDSMetaData",
    "get_metadata_from_dds_memory", "load_from_dds_memory",
    "save_to_dds_memory", "load_from_dds_file", "save_to_dds_file",
    "encode_dds_header",
]


class DDS_FLAGS(enum.IntFlag):
    """DirectXTex.h:232-280."""
    NONE = 0
    LEGACY_DWORD = 0x1
    NO_LEGACY_EXPANSION = 0x2
    NO_R10B10G10A2_FIXUP = 0x4
    FORCE_RGB = 0x8
    NO_16BPP = 0x10
    EXPAND_LUMINANCE = 0x20
    BAD_DXTN_TAILS = 0x40
    PERMISSIVE = 0x80
    IGNORE_MIPS = 0x100
    FORCE_DX10_EXT = 0x10000
    FORCE_DX10_EXT_MISC2 = 0x20000
    FORCE_DX9_LEGACY = 0x40000
    FORCE_DXT5_RXGB = 0x80000
    FORCE_24BPP_RGB = 0x100000
    ALLOW_LARGE_FILES = 0x1000000


_MAGIC = 0x20534444  # "DDS "
_HEADER_SIZE = 124
_PF_SIZE = 32
_MIN_HEADER = 4 + _HEADER_SIZE
_DX10_HEADER = _MIN_HEADER + 20

# DDS_PIXELFORMAT flags (DDS.h:42-53)
_PF_FOURCC = 0x4
_PF_RGB = 0x40
_PF_RGBA = 0x41
_PF_LUMINANCE = 0x20000
_PF_LUMINANCEA = 0x20001
_PF_ALPHAPIXELS = 0x1
_PF_ALPHA = 0x2
_PF_PAL8 = 0x20
_PF_PAL8A = 0x21
_PF_BUMPLUMINANCE = 0x40000
_PF_BUMPDUDV = 0x80000
_PF_BUMPDUDVA = 0x80001

# header flags (DDS.h:203-230)
_HF_TEXTURE = 0x00001007
_HF_MIPMAP = 0x00020000
_HF_VOLUME = 0x00800000
_HF_PITCH = 0x00000008
_HF_LINEARSIZE = 0x00080000
_HF_HEIGHT = 0x2
_CAPS_TEXTURE = 0x00001000
_CAPS_MIPMAP = 0x00400008
_CAPS_CUBEMAP = 0x00000008
_CAPS2_CUBEMAP = 0x200
_CAPS2_ALLFACES = 0xFE00
_CAPS2_VOLUME = 0x00200000

_DX10_MISC_CUBE = 0x4


def _fourcc(s: str) -> int:
    b = s.encode("latin1")
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


# conversion flags (DirectXTexDDS.cpp:28-51)
class _CF(enum.IntFlag):
    NONE = 0
    EXPAND = 0x1
    NOALPHA = 0x2
    SWIZZLE = 0x4
    PAL8 = 0x8
    F888 = 0x10
    F565 = 0x20
    F5551 = 0x40
    F4444 = 0x80
    F44 = 0x100
    F332 = 0x200
    F8332 = 0x400
    A8P8 = 0x800
    DX10 = 0x10000
    PMALPHA = 0x20000
    L8 = 0x40000
    L16 = 0x80000
    A8L8 = 0x100000
    L6V5U5 = 0x200000
    L8U8V8 = 0x400000
    WUV10 = 0x800000


@dataclasses.dataclass(frozen=True)
class _PF:
    flags: int
    fourcc: int = 0
    bits: int = 0
    rmask: int = 0
    gmask: int = 0
    bmask: int = 0
    amask: int = 0


# named pixel formats (DDS.h:71-200)
PF_DXT1 = _PF(_PF_FOURCC, _fourcc("DXT1"))
PF_DXT2 = _PF(_PF_FOURCC, _fourcc("DXT2"))
PF_DXT3 = _PF(_PF_FOURCC, _fourcc("DXT3"))
PF_DXT4 = _PF(_PF_FOURCC, _fourcc("DXT4"))
PF_DXT5 = _PF(_PF_FOURCC, _fourcc("DXT5"))
PF_BC4U = _PF(_PF_FOURCC, _fourcc("BC4U"))
PF_BC4S = _PF(_PF_FOURCC, _fourcc("BC4S"))
PF_BC5U = _PF(_PF_FOURCC, _fourcc("BC5U"))
PF_BC5S = _PF(_PF_FOURCC, _fourcc("BC5S"))
PF_RGBG = _PF(_PF_FOURCC, _fourcc("RGBG"))
PF_GRGB = _PF(_PF_FOURCC, _fourcc("GRGB"))
PF_YUY2 = _PF(_PF_FOURCC, _fourcc("YUY2"))
PF_UYVY = _PF(_PF_FOURCC, _fourcc("UYVY"))
PF_A8R8G8B8 = _PF(_PF_RGBA, 0, 32, 0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)
PF_X8R8G8B8 = _PF(_PF_RGB, 0, 32, 0x00FF0000, 0x0000FF00, 0x000000FF, 0)
PF_A8B8G8R8 = _PF(_PF_RGBA, 0, 32, 0x000000FF, 0x0000FF00, 0x00FF0000, 0xFF000000)
PF_X8B8G8R8 = _PF(_PF_RGB, 0, 32, 0x000000FF, 0x0000FF00, 0x00FF0000, 0)
PF_G16R16 = _PF(_PF_RGB, 0, 32, 0x0000FFFF, 0xFFFF0000, 0, 0)
PF_R5G6B5 = _PF(_PF_RGB, 0, 16, 0xF800, 0x07E0, 0x001F, 0)
PF_A1R5G5B5 = _PF(_PF_RGBA, 0, 16, 0x7C00, 0x03E0, 0x001F, 0x8000)
PF_X1R5G5B5 = _PF(_PF_RGB, 0, 16, 0x7C00, 0x03E0, 0x001F, 0)
PF_A4R4G4B4 = _PF(_PF_RGBA, 0, 16, 0x0F00, 0x00F0, 0x000F, 0xF000)
PF_X4R4G4B4 = _PF(_PF_RGB, 0, 16, 0x0F00, 0x00F0, 0x000F, 0)
PF_R8G8B8 = _PF(_PF_RGB, 0, 24, 0xFF0000, 0x00FF00, 0x0000FF, 0)
PF_A8R3G3B2 = _PF(_PF_RGBA, 0, 16, 0x00E0, 0x001C, 0x0003, 0xFF00)
PF_R3G3B2 = _PF(_PF_RGB, 0, 8, 0xE0, 0x1C, 0x03, 0)
PF_A4L4 = _PF(_PF_LUMINANCEA, 0, 8, 0x0F, 0, 0, 0xF0)
PF_L8 = _PF(_PF_LUMINANCE, 0, 8, 0xFF, 0, 0, 0)
PF_L16 = _PF(_PF_LUMINANCE, 0, 16, 0xFFFF, 0, 0, 0)
PF_A8L8 = _PF(_PF_LUMINANCEA, 0, 16, 0x00FF, 0, 0, 0xFF00)
PF_A8L8_ALT = _PF(_PF_LUMINANCEA, 0, 8, 0x00FF, 0, 0, 0xFF00)
PF_L8_NVTT1 = _PF(_PF_RGB, 0, 8, 0xFF, 0, 0, 0)
PF_L16_NVTT1 = _PF(_PF_RGB, 0, 16, 0xFFFF, 0, 0, 0)
PF_A8L8_NVTT1 = _PF(_PF_RGBA, 0, 16, 0x00FF, 0, 0, 0xFF00)
PF_A8 = _PF(_PF_ALPHA, 0, 8, 0, 0, 0, 0xFF)
PF_V8U8 = _PF(_PF_BUMPDUDV, 0, 16, 0x00FF, 0xFF00, 0, 0)
PF_Q8W8V8U8 = _PF(_PF_BUMPDUDV, 0, 32, 0x000000FF, 0x0000FF00, 0x00FF0000, 0xFF000000)
PF_V16U16 = _PF(_PF_BUMPDUDV, 0, 32, 0x0000FFFF, 0xFFFF0000, 0, 0)
PF_A2R10G10B10 = _PF(_PF_RGBA, 0, 32, 0x000003FF, 0x000FFC00, 0x3FF00000, 0xC0000000)
PF_A2B10G10R10 = _PF(_PF_RGBA, 0, 32, 0x3FF00000, 0x000FFC00, 0x000003FF, 0xC0000000)
PF_A2W10V10U10 = _PF(_PF_BUMPDUDVA, 0, 32, 0x3FF00000, 0x000FFC00, 0x000003FF, 0xC0000000)
PF_L6V5U5 = _PF(_PF_BUMPLUMINANCE, 0, 16, 0x001F, 0x03E0, 0xFC00, 0)
PF_X8L8V8U8 = _PF(_PF_BUMPLUMINANCE, 0, 32, 0x000000FF, 0x0000FF00, 0x00FF0000, 0)
PF_DX10 = _PF(_PF_FOURCC, _fourcc("DX10"))
PF_PAL8 = _PF(_PF_PAL8, 0, 8, 0, 0, 0, 0)
PF_PAL8A = _PF(_PF_PAL8A, 0, 16, 0, 0, 0, 0xFF00)
PF_R32F_RGB = _PF(_PF_RGB, 0, 32, 0xFFFFFFFF, 0, 0, 0)


def _fcc_pf(code) -> _PF:
    return _PF(_PF_FOURCC, _fourcc(code) if isinstance(code, str) else code)


# g_LegacyDDSMap (DirectXTexDDS.cpp:61-182)
_LEGACY_MAP: list[tuple[DXGIFormat, _CF, _PF]] = [
    (FMT.BC1_UNORM, _CF.NONE, PF_DXT1),
    (FMT.BC2_UNORM, _CF.NONE, PF_DXT3),
    (FMT.BC3_UNORM, _CF.NONE, PF_DXT5),
    (FMT.BC2_UNORM, _CF.PMALPHA, PF_DXT2),
    (FMT.BC3_UNORM, _CF.PMALPHA, PF_DXT4),
    # swizzled DXT5 variants returned as-is as BC3
    (FMT.BC3_UNORM, _CF.NONE, _fcc_pf("A2D5")),
    (FMT.BC3_UNORM, _CF.NONE, _fcc_pf("xGBR")),
    (FMT.BC3_UNORM, _CF.NONE, _fcc_pf("RxBG")),
    (FMT.BC3_UNORM, _CF.NONE, _fcc_pf("RBxG")),
    (FMT.BC3_UNORM, _CF.NONE, _fcc_pf("xRBG")),
    (FMT.BC3_UNORM, _CF.NONE, _fcc_pf("RGxB")),
    (FMT.BC3_UNORM, _CF.NONE, _fcc_pf("xGxR")),
    (FMT.BC3_UNORM, _CF.NONE, _fcc_pf("GXRB")),
    (FMT.BC3_UNORM, _CF.NONE, _fcc_pf("GRXB")),
    (FMT.BC3_UNORM, _CF.NONE, _fcc_pf("RXGB")),
    (FMT.BC3_UNORM, _CF.NONE, _fcc_pf("BRGX")),
    (FMT.BC4_UNORM, _CF.NONE, PF_BC4U),
    (FMT.BC4_SNORM, _CF.NONE, PF_BC4S),
    (FMT.BC5_UNORM, _CF.NONE, PF_BC5U),
    (FMT.BC5_SNORM, _CF.NONE, PF_BC5S),
    (FMT.BC4_UNORM, _CF.NONE, _fcc_pf("ATI1")),
    (FMT.BC5_UNORM, _CF.NONE, _fcc_pf("ATI2")),
    (FMT.BC5_UNORM, _CF.NONE, _fcc_pf("A2XY")),
    (FMT.BC6H_UF16, _CF.NONE, _fcc_pf("BC6H")),
    (FMT.BC7_UNORM, _CF.NONE, _fcc_pf("BC7L")),
    (FMT.BC7_UNORM, _CF.NONE, _fcc_pf("BC7\x00")),
    (FMT.R8G8_B8G8_UNORM, _CF.NONE, PF_RGBG),
    (FMT.G8R8_G8B8_UNORM, _CF.NONE, PF_GRGB),
    (FMT.B8G8R8A8_UNORM, _CF.NONE, PF_A8R8G8B8),
    (FMT.B8G8R8X8_UNORM, _CF.NONE, PF_X8R8G8B8),
    (FMT.R8G8B8A8_UNORM, _CF.NONE, PF_A8B8G8R8),
    (FMT.R8G8B8A8_UNORM, _CF.NOALPHA, PF_X8B8G8R8),
    (FMT.R16G16_UNORM, _CF.NONE, PF_G16R16),
    (FMT.R10G10B10A2_UNORM, _CF.SWIZZLE, PF_A2R10G10B10),
    (FMT.R10G10B10A2_UNORM, _CF.NONE, PF_A2B10G10R10),
    (FMT.R8G8B8A8_UNORM, _CF.EXPAND | _CF.NOALPHA | _CF.F888, PF_R8G8B8),
    (FMT.B5G6R5_UNORM, _CF.F565, PF_R5G6B5),
    (FMT.B5G5R5A1_UNORM, _CF.F5551, PF_A1R5G5B5),
    (FMT.B5G5R5A1_UNORM, _CF.F5551 | _CF.NOALPHA, PF_X1R5G5B5),
    (FMT.R8G8B8A8_UNORM, _CF.EXPAND | _CF.F8332, PF_A8R3G3B2),
    (FMT.B5G6R5_UNORM, _CF.EXPAND | _CF.F332, PF_R3G3B2),
    (FMT.R8_UNORM, _CF.NONE, PF_L8),
    (FMT.R16_UNORM, _CF.NONE, PF_L16),
    (FMT.R8G8_UNORM, _CF.NONE, PF_A8L8),
    (FMT.R8G8_UNORM, _CF.NONE, PF_A8L8_ALT),
    (FMT.R8_UNORM, _CF.NONE, PF_L8_NVTT1),
    (FMT.R16_UNORM, _CF.NONE, PF_L16_NVTT1),
    (FMT.R8G8_UNORM, _CF.NONE, PF_A8L8_NVTT1),
    (FMT.A8_UNORM, _CF.NONE, PF_A8),
    (FMT.R16G16B16A16_UNORM, _CF.NONE, _fcc_pf(36)),
    (FMT.R16G16B16A16_SNORM, _CF.NONE, _fcc_pf(110)),
    (FMT.R16_FLOAT, _CF.NONE, _fcc_pf(111)),
    (FMT.R16G16_FLOAT, _CF.NONE, _fcc_pf(112)),
    (FMT.R16G16B16A16_FLOAT, _CF.NONE, _fcc_pf(113)),
    (FMT.R32_FLOAT, _CF.NONE, _fcc_pf(114)),
    (FMT.R32G32_FLOAT, _CF.NONE, _fcc_pf(115)),
    (FMT.R32G32B32A32_FLOAT, _CF.NONE, _fcc_pf(116)),
    (FMT.R32_FLOAT, _CF.NONE, PF_R32F_RGB),
    (FMT.R8G8B8A8_UNORM, _CF.EXPAND | _CF.PAL8 | _CF.A8P8, PF_PAL8A),
    (FMT.R8G8B8A8_UNORM, _CF.EXPAND | _CF.PAL8, PF_PAL8),
    (FMT.B4G4R4A4_UNORM, _CF.F4444, PF_A4R4G4B4),
    (FMT.B4G4R4A4_UNORM, _CF.NOALPHA | _CF.F4444, PF_X4R4G4B4),
    (FMT.B4G4R4A4_UNORM, _CF.EXPAND | _CF.F44, PF_A4L4),
    (FMT.YUY2, _CF.NONE, PF_YUY2),
    (FMT.YUY2, _CF.SWIZZLE, PF_UYVY),
    (FMT.R8G8_SNORM, _CF.NONE, PF_V8U8),
    (FMT.R8G8B8A8_SNORM, _CF.NONE, PF_Q8W8V8U8),
    (FMT.R16G16_SNORM, _CF.NONE, PF_V16U16),
    (FMT.R8G8B8A8_UNORM, _CF.L6V5U5 | _CF.EXPAND, PF_L6V5U5),
    (FMT.R8G8B8A8_UNORM, _CF.L8U8V8, PF_X8L8V8U8),
    (FMT.R10G10B10A2_UNORM, _CF.WUV10, PF_A2W10V10U10),
]


@dataclasses.dataclass(frozen=True)
class DDSMetaData:
    """Raw DDS_PIXELFORMAT data (DirectXTex.h:218-230)."""
    size: int
    flags: int
    fourcc: int
    rgb_bit_count: int
    r_bit_mask: int
    g_bit_mask: int
    b_bit_mask: int
    a_bit_mask: int


def _match_legacy(pf: DDSMetaData, nvtt: bool,
                  flags: DDS_FLAGS) -> tuple[DXGIFormat, _CF]:
    """GetDXGIFormat (DirectXTexDDS.cpp:184)."""
    pf_flags = pf.flags
    if nvtt:
        pf_flags &= ~0xC0000000  # DDPF_SRGB | DDPF_NORMAL

    entry = None
    if pf.size == 0 and pf.flags == 0 and pf.fourcc != 0:
        # mostly-zero DDPF variant
        for fmt, cf, e in _LEGACY_MAP:
            if (e.flags & _PF_FOURCC) and e.fourcc == pf.fourcc:
                entry = (fmt, cf)
                break
    else:
        for fmt, cf, e in _LEGACY_MAP:
            if (pf_flags & _PF_FOURCC) and (e.flags & _PF_FOURCC):
                if pf.fourcc == e.fourcc:
                    entry = (fmt, cf)
                    break
            elif pf_flags == e.flags and pf.rgb_bit_count == e.bits:
                if e.flags & _PF_PAL8:
                    entry = (fmt, cf)
                    break
                if e.flags & _PF_ALPHA:
                    if pf.a_bit_mask == e.amask:
                        entry = (fmt, cf)
                        break
                elif e.flags & _PF_LUMINANCE:
                    if e.flags & _PF_ALPHAPIXELS:
                        if pf.r_bit_mask == e.rmask and pf.a_bit_mask == e.amask:
                            entry = (fmt, cf)
                            break
                    elif pf.r_bit_mask == e.rmask:
                        entry = (fmt, cf)
                        break
                elif e.flags & _PF_BUMPDUDV:
                    if e.flags & _PF_ALPHAPIXELS:
                        if pf.r_bit_mask == e.rmask and pf.a_bit_mask == e.amask:
                            flags &= ~DDS_FLAGS.NO_R10B10G10A2_FIXUP
                            entry = (fmt, cf)
                            break
                    elif pf.r_bit_mask == e.rmask:
                        entry = (fmt, cf)
                        break
                elif e.flags & _PF_ALPHAPIXELS:
                    if (pf.r_bit_mask == e.rmask and pf.g_bit_mask == e.gmask
                            and pf.b_bit_mask == e.bmask
                            and pf.a_bit_mask == e.amask):
                        entry = (fmt, cf)
                        break
                elif (pf.r_bit_mask == e.rmask and pf.g_bit_mask == e.gmask
                      and pf.b_bit_mask == e.bmask):
                    entry = (fmt, cf)
                    break

    if entry is None:
        return FMT.UNKNOWN, _CF.NONE

    fmt, cflags = entry
    if (cflags & _CF.EXPAND) and (flags & DDS_FLAGS.NO_LEGACY_EXPANSION):
        return FMT.UNKNOWN, _CF.NONE
    if fmt == FMT.R10G10B10A2_UNORM and (flags & DDS_FLAGS.NO_R10B10G10A2_FIXUP):
        cflags ^= _CF.SWIZZLE
    return fmt, cflags


@dataclasses.dataclass
class _Decoded:
    metadata: TexMetadata
    conv_flags: _CF
    data_offset: int
    dd_pixel_format: DDSMetaData


def _decode_header(data: bytes, flags: DDS_FLAGS) -> _Decoded:
    """DecodeDDSHeader (DirectXTexDDS.cpp:319)."""
    if len(data) < _MIN_HEADER:
        raise ValueError("DDS: file too small")
    if struct.unpack_from("<I", data, 0)[0] != _MAGIC:
        raise ValueError("DDS: bad magic")

    (hsize, hflags, height, width, _pitch, depth, mips) = struct.unpack_from(
        "<7I", data, 4)
    reserved1 = struct.unpack_from("<11I", data, 4 + 28)
    pf = DDSMetaData(*struct.unpack_from("<8I", data, 4 + 72))
    caps, caps2, _caps3, _caps4, _res2 = struct.unpack_from("<5I", data, 4 + 104)

    if flags & DDS_FLAGS.PERMISSIVE:
        if hsize not in (24, _HEADER_SIZE):
            raise ValueError(f"DDS: unsupported header size {hsize}")
        if pf.size not in (0, 24, _PF_SIZE):
            raise ValueError(f"DDS: unsupported pixel format size {pf.size}")
    else:
        if hsize != _HEADER_SIZE:
            raise ValueError(f"DDS: unsupported header size {hsize}")
        if pf.size != _PF_SIZE:
            raise ValueError(f"DDS: unsupported pixel format size {pf.size}")

    mip_levels = max(1, mips)
    conv = _CF.NONE
    misc_flags = 0
    misc_flags2 = 0
    offset = _MIN_HEADER

    if (pf.flags & _PF_FOURCC) and pf.fourcc == _fourcc("DX10"):
        if len(data) < _DX10_HEADER:
            raise ValueError("DDS: truncated DX10 header")
        dxgi, res_dim, misc, array_size, misc_flags2 = struct.unpack_from(
            "<5I", data, _MIN_HEADER)
        conv |= _CF.DX10
        offset = _DX10_HEADER
        array_size = max(1, array_size)
        try:
            fmt = DXGIFormat(dxgi)
        except ValueError:
            raise ValueError(f"DDS: unknown DXGI format {dxgi}") from None
        if not traits.is_valid(fmt) or traits.is_palettized(fmt):
            raise ValueError(f"DDS: unsupported format {fmt!r}")
        misc_flags = misc & ~_DX10_MISC_CUBE
        if res_dim == 2:  # TEXTURE1D
            if (hflags & _HF_HEIGHT) and height != 1:
                raise ValueError("DDS: 1D texture with height != 1")
            meta = TexMetadata(width=width, height=1, depth=1,
                               array_size=array_size, mip_levels=mip_levels,
                               misc_flags=misc_flags, misc_flags2=misc_flags2,
                               format=fmt, dimension=TexDimension.TEXTURE1D)
        elif res_dim == 3 or (res_dim == 0 and (flags & DDS_FLAGS.PERMISSIVE)):
            if misc & _DX10_MISC_CUBE:
                misc_flags |= int(TexMiscFlag.TEXTURECUBE)
                array_size *= 6
            meta = TexMetadata(width=width, height=height, depth=1,
                               array_size=array_size, mip_levels=mip_levels,
                               misc_flags=misc_flags, misc_flags2=misc_flags2,
                               format=fmt, dimension=TexDimension.TEXTURE2D)
        elif res_dim == 4:  # TEXTURE3D
            if not (hflags & _HF_VOLUME):
                raise ValueError("DDS: 3D texture missing volume flag")
            if array_size > 1:
                raise ValueError("DDS: volume arrays not supported")
            meta = TexMetadata(width=width, height=height, depth=depth,
                               array_size=1, mip_levels=mip_levels,
                               misc_flags=misc_flags, misc_flags2=misc_flags2,
                               format=fmt, dimension=TexDimension.TEXTURE3D)
        else:
            raise ValueError(f"DDS: invalid resource dimension {res_dim}")
    else:
        nvtt = reserved1[9] == _fourcc("NVTT")
        if hflags & _HF_VOLUME:
            meta_dim = TexDimension.TEXTURE3D
            array_size = 1
        else:
            if caps2 & _CAPS2_CUBEMAP:
                if (caps2 & _CAPS2_ALLFACES) != _CAPS2_ALLFACES:
                    raise ValueError("DDS: partial cubemaps not supported")
                array_size = 6
                misc_flags |= int(TexMiscFlag.TEXTURECUBE)
            else:
                array_size = 1
            meta_dim = TexDimension.TEXTURE2D
            depth = 1

        fmt, conv2 = _match_legacy(pf, nvtt, flags)
        conv |= conv2
        if fmt == FMT.UNKNOWN:
            raise ValueError("DDS: unrecognized legacy pixel format")
        if nvtt and (pf.flags & 0x40000000):
            fmt = make_srgb(fmt)

        if flags & DDS_FLAGS.PERMISSIVE:
            if meta_dim == TexDimension.TEXTURE3D:
                maxm = traits.calculate_mip_levels_3d(width, height, depth)
            else:
                maxm = traits.calculate_mip_levels(width, height)
            mip_levels = min(mip_levels, maxm)

        # EXPAND_LUMINANCE (DecodeDDSHeader :547)
        if flags & DDS_FLAGS.EXPAND_LUMINANCE:
            if fmt == FMT.R8_UNORM:
                fmt = FMT.R8G8B8A8_UNORM
                conv |= _CF.L8 | _CF.EXPAND
            elif fmt == FMT.R8G8_UNORM:
                fmt = FMT.R8G8B8A8_UNORM
                conv |= _CF.A8L8 | _CF.EXPAND
            elif fmt == FMT.R16_UNORM:
                fmt = FMT.R16G16B16A16_UNORM
                conv |= _CF.L16 | _CF.EXPAND

        meta = TexMetadata(width=width, height=height, depth=depth,
                           array_size=array_size, mip_levels=mip_levels,
                           misc_flags=misc_flags, misc_flags2=0,
                           format=fmt, dimension=meta_dim)

    # FORCE_RGB (DecodeDDSHeader :571)
    if flags & DDS_FLAGS.FORCE_RGB:
        remap = {
            FMT.B8G8R8A8_UNORM: (FMT.R8G8B8A8_UNORM, _CF.SWIZZLE),
            FMT.B8G8R8X8_UNORM: (FMT.R8G8B8A8_UNORM, _CF.SWIZZLE | _CF.NOALPHA),
            FMT.B8G8R8A8_TYPELESS: (FMT.R8G8B8A8_TYPELESS, _CF.SWIZZLE),
            FMT.B8G8R8A8_UNORM_SRGB: (FMT.R8G8B8A8_UNORM_SRGB, _CF.SWIZZLE),
            FMT.B8G8R8X8_TYPELESS: (FMT.R8G8B8A8_TYPELESS, _CF.SWIZZLE | _CF.NOALPHA),
            FMT.B8G8R8X8_UNORM_SRGB: (FMT.R8G8B8A8_UNORM_SRGB, _CF.SWIZZLE | _CF.NOALPHA),
        }
        if meta.format in remap:
            fmt, extra = remap[meta.format]
            meta = meta.with_format(fmt)
            conv |= extra

    # NO_16BPP (DecodeDDSHeader :612)
    if flags & DDS_FLAGS.NO_16BPP:
        if meta.format in (FMT.B5G6R5_UNORM, FMT.B5G5R5A1_UNORM,
                           FMT.B4G4R4A4_UNORM, FMT.A4B4G4R4_UNORM):
            if meta.format == FMT.B5G6R5_UNORM:
                conv |= _CF.NOALPHA
            if meta.format == FMT.A4B4G4R4_UNORM:
                conv |= _CF.F4444
            meta = meta.with_format(FMT.R8G8B8A8_UNORM)
            conv |= _CF.EXPAND

    # implicit alpha mode
    if conv & _CF.NOALPHA:
        meta = meta.with_alpha_mode(TexAlphaMode.OPAQUE)
    elif conv & _CF.PMALPHA:
        meta = meta.with_alpha_mode(TexAlphaMode.PREMULTIPLIED)

    if flags & DDS_FLAGS.IGNORE_MIPS:
        meta = dataclasses.replace(meta, mip_levels=1)

    return _Decoded(meta, conv, offset, pf)


def get_metadata_from_dds_memory(data: bytes,
                                 flags: DDS_FLAGS = DDS_FLAGS.NONE
                                 ) -> TexMetadata:
    return _decode_header(bytes(data), DDS_FLAGS(flags)).metadata


# ---------------------------------------------------------------------------
# legacy pixel fix-ups, vectorized (LegacyExpandScanline :1100)
# ---------------------------------------------------------------------------

def _expand_legacy(raw: np.ndarray, conv: _CF, target: DXGIFormat,
                   pal8: np.ndarray | None, set_alpha: bool) -> np.ndarray:
    """Expand one subresource's legacy bytes to the target wire format."""
    if conv & _CF.F888:
        t = raw.reshape(-1, 3).astype(np.uint32)
        out = (t[:, 2] | (t[:, 1] << 8) | (t[:, 0] << 16) | 0xFF000000)
        return out.astype("<u4").view(np.uint8)
    if conv & _CF.F8332:
        t = raw.view("<u2").astype(np.uint32)
        t1 = (t & 0xE0) | ((t & 0xE0) >> 3) | ((t & 0xC0) >> 6)
        t2 = ((t & 0x1C) << 11) | ((t & 0x1C) << 8) | ((t & 0x18) << 5)
        t3 = ((t & 0x03) << 22) | ((t & 0x03) << 20) | ((t & 0x03) << 18) | ((t & 0x03) << 16)
        ta = np.uint32(0xFF000000) if set_alpha else ((t & 0xFF00) << 16)
        return (t1 | t2 | t3 | ta).astype("<u4").view(np.uint8)
    if conv & _CF.F332:
        t = raw.astype(np.uint32)
        if target == FMT.R8G8B8A8_UNORM:
            t1 = (t & 0xE0) | ((t & 0xE0) >> 3) | ((t & 0xC0) >> 6)
            t2 = ((t & 0x1C) << 11) | ((t & 0x1C) << 8) | ((t & 0x18) << 5)
            t3 = ((t & 0x03) << 22) | ((t & 0x03) << 20) | ((t & 0x03) << 18) | ((t & 0x03) << 16)
            return (t1 | t2 | t3 | 0xFF000000).astype("<u4").view(np.uint8)
        # -> B5G6R5
        t1 = ((t & 0xE0) << 8) | ((t & 0xC0) << 5)
        t2 = ((t & 0x1C) << 6) | ((t & 0x1C) << 3)
        t3 = ((t & 0x03) << 3) | ((t & 0x03) << 1) | ((t & 0x02) >> 1)
        return (t1 | t2 | t3).astype("<u2").view(np.uint8)
    if conv & _CF.A8P8:
        t = raw.view("<u2").astype(np.uint32)
        if pal8 is None:
            raise ValueError("DDS: A8P8 file missing palette")
        t1 = pal8[t & 0xFF] & 0x00FFFFFF
        ta = np.uint32(0xFF000000) if set_alpha else ((t & 0xFF00) << 16)
        return (t1 | ta).astype("<u4").view(np.uint8)
    if conv & _CF.PAL8:
        if pal8 is None:
            raise ValueError("DDS: P8 file missing palette")
        return pal8[raw].astype("<u4").view(np.uint8)
    if conv & _CF.F44:
        t = raw.astype(np.uint32)
        if target == FMT.R8G8B8A8_UNORM:
            t1 = ((t & 0x0F) << 4) | (t & 0x0F)
            ta = np.uint32(0xFF000000) if set_alpha else (((t & 0xF0) << 24) | ((t & 0xF0) << 20))
            return (t1 | (t1 << 8) | (t1 << 16) | ta).astype("<u4").view(np.uint8)
        # -> B4G4R4A4
        t1 = t & 0x0F
        ta = np.uint32(0xF000) if set_alpha else ((t & 0xF0) << 8)
        return (t1 | (t1 << 4) | (t1 << 8) | ta).astype("<u2").view(np.uint8)
    if conv & _CF.F4444:
        # B4G4R4A4 (or 11on12 A4B4G4R4) -> R8G8B8A8
        t = raw.view("<u2").astype(np.uint32)
        t1 = ((t & 0x0F00) >> 4) | ((t & 0x0F00) >> 8)
        t2 = ((t & 0x00F0) << 8) | ((t & 0x00F0) << 4)
        t3 = ((t & 0x000F) << 20) | ((t & 0x000F) << 16)
        ta = np.uint32(0xFF000000) if set_alpha else (((t & 0xF000) << 16) | ((t & 0xF000) << 12))
        return (t1 | t2 | t3 | ta).astype("<u4").view(np.uint8)
    if conv & _CF.F565:
        t = raw.view("<u2").astype(np.uint32)
        r = (t >> 11) & 0x1F
        g = (t >> 5) & 0x3F
        b = t & 0x1F
        r8 = (r << 3) | (r >> 2)
        g8 = (g << 2) | (g >> 4)
        b8 = (b << 3) | (b >> 2)
        return (r8 | (g8 << 8) | (b8 << 16) | 0xFF000000).astype("<u4").view(np.uint8)
    if conv & _CF.F5551:
        t = raw.view("<u2").astype(np.uint32)
        r = (t >> 10) & 0x1F
        g = (t >> 5) & 0x1F
        b = t & 0x1F
        a = (t >> 15) & 0x1
        r8 = (r << 3) | (r >> 2)
        g8 = (g << 3) | (g >> 2)
        b8 = (b << 3) | (b >> 2)
        a8 = np.where(set_alpha | (a != 0), np.uint32(0xFF), np.uint32(0))
        return (r8 | (g8 << 8) | (b8 << 16) | (a8 << 24)).astype("<u4").view(np.uint8)
    if conv & _CF.L8:
        t = raw.astype(np.uint32)
        return (t | (t << 8) | (t << 16) | 0xFF000000).astype("<u4").view(np.uint8)
    if conv & _CF.L16:
        t = raw.view("<u2").astype(np.uint64)
        out = t | (t << 16) | (t << 32) | np.uint64(0xFFFF000000000000)
        return out.astype("<u8").view(np.uint8)
    if conv & _CF.A8L8:
        t = raw.view("<u2").astype(np.uint32)
        t1 = t & 0xFF
        ta = np.uint32(0xFF000000) if set_alpha else ((t & 0xFF00) << 16)
        return (t1 | (t1 << 8) | (t1 << 16) | ta).astype("<u4").view(np.uint8)
    if conv & _CF.L6V5U5:
        t = raw.view("<u2").astype(np.int32)
        t1 = ((t & 0xFC00) >> 8) | ((t & 0xC000) >> 14)
        m = 1 << 4
        v = ((((t >> 5) & 0x1F) ^ m) - m) + 16
        u = (((t & 0x1F) ^ m) - m) + 16
        t2 = ((u << 3) | (u >> 2)).astype(np.uint32)
        t3 = ((v << 3) | (v >> 2)).astype(np.uint32)
        return (t1.astype(np.uint32) | (t2 << 8) | (t3 << 16) | 0xFF000000).astype("<u4").view(np.uint8)
    raise ValueError(f"DDS: unsupported legacy expansion {conv!r}")


def _convert_legacy_inplace(raw: np.ndarray, conv: _CF,
                            set_alpha: bool) -> np.ndarray:
    """LegacyConvertScanline for same-size conversions (:1437)."""
    if conv & _CF.L8U8V8:
        t = raw.view("<u4").astype(np.uint32)
        t1 = (t >> 16) & 0xFF
        m = 1 << 7
        v = (((t >> 8) & 0xFF).astype(np.int32) ^ m) - m + 128
        u = ((t & 0xFF).astype(np.int32) ^ m) - m + 128
        out = t1 | (u.astype(np.uint32) << 8) | (v.astype(np.uint32) << 16) | 0xFF000000
        return out.astype("<u4").view(np.uint8)
    if conv & _CF.WUV10:
        t = raw.view("<u4").astype(np.uint32)
        m = 1 << 9
        w = (((t >> 20) & 0x3FF).astype(np.int32) ^ m) - m + 512
        v = (((t >> 10) & 0x3FF).astype(np.int32) ^ m) - m + 512
        u = ((t & 0x3FF).astype(np.int32) ^ m) - m + 512
        ta = np.uint32(0xC0000000) if set_alpha else (t & 0xC0000000)
        out = u.astype(np.uint32) | (v.astype(np.uint32) << 10) | \
            (w.astype(np.uint32) << 20) | ta
        return out.astype("<u4").view(np.uint8)
    return raw


def _apply_swizzle(raw: np.ndarray, fmt: DXGIFormat) -> np.ndarray:
    """SwizzleScanline equivalents (DirectXTexConvert.cpp:440)."""
    if fmt in (FMT.R10G10B10A2_UNORM, FMT.R10G10B10A2_UINT,
               FMT.R10G10B10A2_TYPELESS, FMT.R10G10B10_XR_BIAS_A2_UNORM):
        t = raw.view("<u4").astype(np.uint32)
        out = (t & 0xC00FFC00) | ((t & 0x3FF) << 20) | ((t >> 20) & 0x3FF)
        return out.astype("<u4").view(np.uint8)
    if fmt in (FMT.R8G8B8A8_UNORM, FMT.R8G8B8A8_UNORM_SRGB,
               FMT.R8G8B8A8_TYPELESS, FMT.B8G8R8A8_UNORM,
               FMT.B8G8R8X8_UNORM, FMT.B8G8R8A8_UNORM_SRGB,
               FMT.B8G8R8X8_UNORM_SRGB, FMT.B8G8R8A8_TYPELESS,
               FMT.B8G8R8X8_TYPELESS):
        q = raw.reshape(-1, 4)
        return np.ascontiguousarray(q[:, [2, 1, 0, 3]]).reshape(-1)
    if fmt == FMT.YUY2:
        q = raw.reshape(-1, 4)
        return np.ascontiguousarray(q[:, [1, 0, 3, 2]]).reshape(-1)
    return raw


def load_from_dds_memory(data: bytes, flags: DDS_FLAGS = DDS_FLAGS.NONE,
                         device=None):
    """LoadFromDDSMemory (DirectXTexDDS.cpp:2008). Returns a Texture for
    uncompressed formats, a CompressedTexture (u8 block bytes) for BC
    formats, on `device` (CUDA unless named). The header and the legacy
    expand / convert / swizzle steps run on the host (numpy); the payload
    then goes to the device in one copy and unpacks there."""
    data = bytes(data)
    flags = DDS_FLAGS(flags)
    dev = resolve(device)
    dec = _decode_header(data, flags)
    meta = dec.metadata
    conv = dec.conv_flags
    offset = dec.data_offset

    # 4GB guard (CP_FLAGS_LIMIT_4GB semantics, DirectXTex.h:136): payloads
    # past 4GiB need an explicit opt-in (DDS_FLAGS_ALLOW_LARGE_FILES :278)
    if len(data) - offset > (1 << 32) and not (
            flags & DDS_FLAGS.ALLOW_LARGE_FILES):
        raise TexArithmeticOverflowError(
            "DDS payload exceeds 4GB; pass DDS_FLAGS.ALLOW_LARGE_FILES")

    pal8 = None
    if conv & _CF.PAL8:
        pal8 = np.frombuffer(data, "<u4", 256, offset).copy()
        offset += 256 * 4

    pitch_flags = CP_FLAGS.NONE
    if flags & DDS_FLAGS.LEGACY_DWORD:
        pitch_flags |= CP_FLAGS.LEGACY_DWORD
    if flags & DDS_FLAGS.BAD_DXTN_TAILS and traits.is_compressed(meta.format):
        pitch_flags |= CP_FLAGS.BAD_DXTN_TAILS
    # wire size differs from final format size for expansions
    if conv & _CF.EXPAND:
        if conv & _CF.F888:
            pitch_flags |= CP_FLAGS.BPP24
        elif conv & (_CF.F565 | _CF.F5551 | _CF.F4444 | _CF.F8332 | _CF.A8P8
                     | _CF.L16 | _CF.A8L8 | _CF.L6V5U5):
            pitch_flags |= CP_FLAGS.BPP16
        elif conv & (_CF.F44 | _CF.F332 | _CF.PAL8 | _CF.L8):
            pitch_flags |= CP_FLAGS.BPP8

    src = np.frombuffer(data, np.uint8)
    is_bc = traits.is_compressed(meta.format)
    is_3d = meta.dimension == TexDimension.TEXTURE3D

    # collect raw wire bytes per (item, mip)
    per_level: list[list[np.ndarray]] = [[] for _ in range(meta.mip_levels)]
    pos = offset
    n_items = 1 if is_3d else meta.array_size
    for _item in range(n_items):
        for mip in range(meta.mip_levels):
            w, h, d = meta.mip_dims(mip)
            _rp, sp = compute_pitch(meta.format, w, h, pitch_flags)
            nslices = d if is_3d else 1
            nbytes = sp * nslices
            if pos + nbytes > len(src):
                raise ValueError("DDS: pixel data truncated")
            per_level[mip].append(src[pos:pos + nbytes])
            pos += nbytes

    set_alpha = bool(conv & _CF.NOALPHA)

    def upload(level_parts: list) -> list:
        """Every level's byte strings to the device in one copy; each
        level's strings back as device slices, in order."""
        flat = [p for parts in level_parts for p in parts]
        allb = torch.from_numpy(np.concatenate(flat)).to(dev)
        out, off = [], 0
        for parts in level_parts:
            out.append([])
            for q in parts:
                out[-1].append(allb[off:off + len(q)])
                off += len(q)
        return out

    if is_bc:
        # [items or depth slices, bytes a slice]: the layout compress()
        # produces
        levels = []
        for mip, parts in enumerate(upload(per_level)):
            _w, _h, d = meta.mip_dims(mip)
            rows = d if is_3d else len(parts)
            levels.append(torch.cat(parts).reshape(rows, -1))
        return CompressedTexture(meta, levels)

    if traits.is_planar(meta.format):
        # Planar video formats depack on load (the reference requires an
        # explicit ConvertToSinglePlane before any op; the loader folds
        # that in and relabels with the packed single-plane equivalent,
        # DirectXTexConvert.cpp:4916).
        single = planar_to_single(meta.format)
        if single == FMT.UNKNOWN:
            raise ValueError(f"DDS: unsupported planar format {meta.format!r}")
        levels = []
        for mip, parts in enumerate(upload(per_level)):
            w, h, _d = meta.mip_dims(mip)
            levels.append(torch.stack([
                unpack_planar_image(meta.format, raw, w, h)
                for raw in parts]))
        return Texture(meta.with_format(single), levels)

    # the legacy steps on the host, then one copy, then unpack per plane
    planes = []
    for mip in range(meta.mip_levels):
        _w, _h, d = meta.mip_dims(mip)
        planes.append([])
        for raw in per_level[mip]:
            if conv & _CF.EXPAND:
                raw = _expand_legacy(raw, conv, meta.format, pal8, set_alpha)
            raw = _convert_legacy_inplace(raw, conv, set_alpha)
            if conv & _CF.SWIZZLE:
                raw = _apply_swizzle(raw, meta.format)
            planes[-1].extend(np.split(raw, d) if is_3d else [raw])
    levels = []
    for mip, parts in enumerate(upload(planes)):
        w, h, _d = meta.mip_dims(mip)
        lvl = torch.stack([unpack(meta.format, raw, w * h).reshape(h, w, 4)
                           for raw in parts])
        if set_alpha and not (conv & _CF.EXPAND):
            lvl = torch.cat([lvl[..., :3], torch.ones_like(lvl[..., 3:])],
                            dim=-1)
        levels.append(lvl)

    return Texture(meta, levels)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_LEGACY_WRITE: dict[DXGIFormat, _PF] = {
    FMT.R8G8B8A8_UNORM: PF_A8B8G8R8,
    FMT.R16G16_UNORM: PF_G16R16,
    FMT.R8G8_UNORM: PF_A8L8,
    FMT.R16_UNORM: PF_L16,
    FMT.R8_UNORM: PF_L8,
    FMT.A8_UNORM: PF_A8,
    FMT.R8G8_B8G8_UNORM: PF_RGBG,
    FMT.G8R8_G8B8_UNORM: PF_GRGB,
    FMT.BC1_UNORM: PF_DXT1,
    FMT.BC4_SNORM: PF_BC4S,
    FMT.BC5_SNORM: PF_BC5S,
    FMT.B5G6R5_UNORM: PF_R5G6B5,
    FMT.B5G5R5A1_UNORM: PF_A1R5G5B5,
    FMT.R8G8_SNORM: PF_V8U8,
    FMT.R8G8B8A8_SNORM: PF_Q8W8V8U8,
    FMT.R16G16_SNORM: PF_V16U16,
    FMT.B8G8R8A8_UNORM: PF_A8R8G8B8,
    FMT.B4G4R4A4_UNORM: PF_A4R4G4B4,
    FMT.YUY2: PF_YUY2,
    FMT.R32G32B32A32_FLOAT: _fcc_pf(116),
    FMT.R16G16B16A16_FLOAT: _fcc_pf(113),
    FMT.R16G16B16A16_UNORM: _fcc_pf(36),
    FMT.R16G16B16A16_SNORM: _fcc_pf(110),
    FMT.R32G32_FLOAT: _fcc_pf(115),
    FMT.R16G16_FLOAT: _fcc_pf(112),
    FMT.R32_FLOAT: _fcc_pf(114),
    FMT.R16_FLOAT: _fcc_pf(111),
    FMT.BC4_UNORM: PF_BC4U,
    FMT.BC5_UNORM: PF_BC5U,
}

_DX9_ONLY_WRITE: dict[DXGIFormat, _PF] = {
    FMT.R10G10B10A2_UNORM: PF_A2B10G10R10,
    FMT.R8G8B8A8_UNORM_SRGB: PF_A8B8G8R8,
    FMT.BC1_UNORM_SRGB: PF_DXT1,
    FMT.B8G8R8A8_UNORM_SRGB: PF_A8R8G8B8,
    FMT.B8G8R8X8_UNORM_SRGB: PF_X8R8G8B8,
}


def encode_dds_header(meta: TexMetadata,
                      flags: DDS_FLAGS = DDS_FLAGS.NONE) -> bytes:
    """EncodeDDSHeader (DirectXTexDDS.cpp:711)."""
    flags = DDS_FLAGS(flags)
    if not traits.is_valid(meta.format):
        raise ValueError("DDS: invalid format")
    if traits.is_palettized(meta.format):
        raise ValueError("DDS: palettized formats not supported for write")

    if meta.array_size > 1:
        if (meta.array_size != 6 or meta.dimension != TexDimension.TEXTURE2D
                or not meta.is_cubemap()):
            if flags & DDS_FLAGS.FORCE_DX9_LEGACY:
                raise ValueError("DDS: arrays require the DX10 extension")
            flags |= DDS_FLAGS.FORCE_DX10_EXT
    if flags & DDS_FLAGS.FORCE_DX10_EXT_MISC2:
        flags |= DDS_FLAGS.FORCE_DX10_EXT

    pitch_flags = CP_FLAGS.NONE
    ddpf: _PF | None = None
    if not (flags & DDS_FLAGS.FORCE_DX10_EXT):
        fmt = meta.format
        if fmt == FMT.BC2_UNORM:
            ddpf = PF_DXT2 if meta.is_pm_alpha() else PF_DXT3
        elif fmt == FMT.BC3_UNORM:
            ddpf = PF_DXT4 if meta.is_pm_alpha() else PF_DXT5
            if flags & DDS_FLAGS.FORCE_DXT5_RXGB:
                ddpf = _fcc_pf("RXGB")
        elif fmt == FMT.B8G8R8X8_UNORM:
            if flags & DDS_FLAGS.FORCE_24BPP_RGB:
                ddpf = PF_R8G8B8
                pitch_flags |= CP_FLAGS.BPP24
            else:
                ddpf = PF_X8R8G8B8
        elif fmt in _LEGACY_WRITE:
            ddpf = _LEGACY_WRITE[fmt]
        elif (flags & DDS_FLAGS.FORCE_DX9_LEGACY):
            if fmt == FMT.BC2_UNORM_SRGB:
                ddpf = PF_DXT2 if meta.is_pm_alpha() else PF_DXT3
            elif fmt == FMT.BC3_UNORM_SRGB:
                ddpf = PF_DXT4 if meta.is_pm_alpha() else PF_DXT5
            elif fmt in _DX9_ONLY_WRITE:
                ddpf = _DX9_ONLY_WRITE[fmt]
        if (flags & DDS_FLAGS.FORCE_DX9_LEGACY) and ddpf is not None:
            if fmt == FMT.BC4_UNORM:
                ddpf = _fcc_pf("ATI1")
            elif fmt == FMT.BC5_UNORM:
                ddpf = _fcc_pf("ATI2")

    use_dx10 = ddpf is None
    if use_dx10 and (flags & DDS_FLAGS.FORCE_DX9_LEGACY):
        raise ValueError(f"DDS: cannot express {meta.format!r} in a DX9 header")

    hflags = _HF_TEXTURE
    caps = _CAPS_TEXTURE
    caps2 = 0
    mips = meta.mip_levels
    if mips > 0:
        hflags |= _HF_MIPMAP
        if mips > 1:
            caps |= _CAPS_MIPMAP

    depth = 1
    if meta.dimension == TexDimension.TEXTURE1D:
        width, height = meta.width, 1
    elif meta.dimension == TexDimension.TEXTURE2D:
        width, height = meta.width, meta.height
        if meta.is_cubemap():
            caps |= _CAPS_CUBEMAP
            caps2 |= _CAPS2_ALLFACES
    else:
        width, height, depth = meta.width, meta.height, meta.depth
        hflags |= _HF_VOLUME
        caps2 |= _CAPS2_VOLUME

    rp, sp = compute_pitch(meta.format, meta.width, meta.height, pitch_flags)
    if traits.is_compressed(meta.format):
        hflags |= _HF_LINEARSIZE
        pitch_or_linear = sp
    else:
        hflags |= _HF_PITCH
        pitch_or_linear = rp

    pf = ddpf if ddpf is not None else PF_DX10
    header = struct.pack(
        "<I 7I 11I 8I 5I",
        _MAGIC, _HEADER_SIZE, hflags, height, width, pitch_or_linear, depth,
        mips, *([0] * 11),
        _PF_SIZE, pf.flags, pf.fourcc, pf.bits, pf.rmask, pf.gmask, pf.bmask,
        pf.amask,
        caps, caps2, 0, 0, 0,
    )
    if use_dx10:
        arr = meta.array_size
        misc = meta.misc_flags & ~int(TexMiscFlag.TEXTURECUBE)
        if meta.is_cubemap():
            misc |= _DX10_MISC_CUBE
            arr //= 6
        misc2 = meta.misc_flags2 if (flags & DDS_FLAGS.FORCE_DX10_EXT_MISC2) else 0
        header += struct.pack("<5I", int(meta.format), int(meta.dimension),
                              misc, arr, misc2)
    return header


def save_to_dds_memory(tex, flags: DDS_FLAGS = DDS_FLAGS.NONE) -> bytes:
    """SaveToDDSMemory (DirectXTexDDS.cpp:2403). Every subresource packs on
    the texture's device, in the file's order; the payload then moves to
    the host once and is copied there once, into the returned bytes."""
    flags = DDS_FLAGS(flags)
    meta = tex.metadata
    header = encode_dds_header(meta, flags)
    is_3d = meta.dimension == TexDimension.TEXTURE3D
    n_items = 1 if is_3d else meta.array_size

    def subresources(lvl):
        # a volume's level is every depth slice, slice-major
        return range(lvl.shape[0]) if is_3d else (item,)

    parts = []
    if isinstance(tex, CompressedTexture):
        for item in range(n_items):
            for mip in range(tex.mip_levels):
                lvl = tex.levels[mip]
                parts.extend(lvl[z].reshape(-1) for z in subresources(lvl))
    else:
        if not is_packable(meta.format):
            raise ValueError(f"DDS: cannot store format {meta.format!r}")
        for item in range(n_items):
            for mip in range(tex.mip_levels):
                lvl = tex.levels[mip]
                parts.extend(pack(meta.format, lvl[z].reshape(-1, 4))
                             for z in subresources(lvl))
    if not parts:
        return header
    # one host copy: the payload's buffer joins the header into the bytes
    return b"".join((header, torch.cat(parts).cpu().numpy()))


def load_from_dds_file(path, flags: DDS_FLAGS = DDS_FLAGS.NONE, device=None):
    with open(path, "rb") as f:
        return load_from_dds_memory(f.read(), flags, device)


def save_to_dds_file(tex, path, flags: DDS_FLAGS = DDS_FLAGS.NONE) -> None:
    with open(path, "wb") as f:
        f.write(save_to_dds_memory(tex, flags))
