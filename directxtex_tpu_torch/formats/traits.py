"""DXGI format traits: predicates, size math, and format-family conversions.

A verbatim copy of directxtex_tpu/formats/traits.py (it imports no jax;
tests/test_torch_formats.py pins it equal).

Semantics mirror the reference's giant per-format switches in
DirectXTex/DirectXTexUtil.cpp (BitsPerPixel :594, BitsPerColor :755,
BytesPerBlock :921, ComputePitch :961, ComputeScanlines :1188,
MakeSRGB/MakeLinear/MakeTypeless* :1411-1660) and the inline predicates in
DirectXTex/DirectXTex.inl + DirectXTexUtil.cpp:340-580 — but organized as
declarative Python sets/dicts: one auditable source of truth instead of
679 case labels.
"""

from __future__ import annotations

import enum

from .dxgi import FMT, DXGIFormat

__all__ = [
    "CP_FLAGS",
    "is_valid", "is_compressed", "is_packed", "is_video", "is_planar",
    "is_palettized", "is_depth_stencil", "is_srgb", "is_bgr", "is_typeless",
    "has_alpha",
    "bits_per_pixel", "bits_per_color", "bytes_per_block",
    "compute_pitch", "compute_scanlines",
    "calculate_mip_levels", "calculate_mip_levels_3d",
    "make_srgb", "make_linear", "make_typeless",
    "make_typeless_unorm", "make_typeless_float",
]


class CP_FLAGS(enum.IntFlag):
    """ComputePitch options (DirectXTex.h:118-138)."""
    NONE = 0x0
    LEGACY_DWORD = 0x1
    PARAGRAPH = 0x2
    YMM = 0x4
    ZMM = 0x8
    PAGE4K = 0x200
    BAD_DXTN_TAILS = 0x1000
    BPP24 = 0x10000
    BPP16 = 0x20000
    BPP8 = 0x40000
    LIMIT_4GB = 0x10000000


# ---------------------------------------------------------------------------
# Predicate sets (DirectXTex.inl:56-128, DirectXTexUtil.cpp:340-580)
# ---------------------------------------------------------------------------

_COMPRESSED = frozenset({
    FMT.BC1_TYPELESS, FMT.BC1_UNORM, FMT.BC1_UNORM_SRGB,
    FMT.BC2_TYPELESS, FMT.BC2_UNORM, FMT.BC2_UNORM_SRGB,
    FMT.BC3_TYPELESS, FMT.BC3_UNORM, FMT.BC3_UNORM_SRGB,
    FMT.BC4_TYPELESS, FMT.BC4_UNORM, FMT.BC4_SNORM,
    FMT.BC5_TYPELESS, FMT.BC5_UNORM, FMT.BC5_SNORM,
    FMT.BC6H_TYPELESS, FMT.BC6H_UF16, FMT.BC6H_SF16,
    FMT.BC7_TYPELESS, FMT.BC7_UNORM, FMT.BC7_UNORM_SRGB,
})

_PACKED = frozenset({
    FMT.R8G8_B8G8_UNORM, FMT.G8R8_G8B8_UNORM,
    FMT.YUY2, FMT.Y210, FMT.Y216,
})

_VIDEO = frozenset({
    FMT.AYUV, FMT.Y410, FMT.Y416, FMT.NV12, FMT.P010, FMT.P016,
    FMT.YUY2, FMT.Y210, FMT.Y216, FMT.NV11, FMT.OPAQUE_420,
    FMT.AI44, FMT.IA44, FMT.P8, FMT.A8P8,
    FMT.P208, FMT.V208, FMT.V408,
})

_PLANAR = frozenset({
    FMT.NV12, FMT.P010, FMT.P016, FMT.OPAQUE_420, FMT.NV11,
    FMT.P208, FMT.V208, FMT.V408,
    FMT.XBOX_D16_UNORM_S8_UINT, FMT.XBOX_R16_UNORM_X8_TYPELESS,
    FMT.XBOX_X16_TYPELESS_G8_UINT,
})

# Direct3D 12 additionally treats depth+stencil pairs as planar
# (DirectXTexUtil.cpp:396-416, isd3d12 parameter).
_PLANAR_D3D12_EXTRA = frozenset({
    FMT.R32G8X24_TYPELESS, FMT.D32_FLOAT_S8X24_UINT,
    FMT.R32_FLOAT_X8X24_TYPELESS, FMT.X32_TYPELESS_G8X24_UINT,
    FMT.R24G8_TYPELESS, FMT.D24_UNORM_S8_UINT,
    FMT.R24_UNORM_X8_TYPELESS, FMT.X24_TYPELESS_G8_UINT,
})

_PALETTIZED = frozenset({FMT.AI44, FMT.IA44, FMT.P8, FMT.A8P8})

_DEPTH_STENCIL = frozenset({
    FMT.R32G8X24_TYPELESS, FMT.D32_FLOAT_S8X24_UINT,
    FMT.R32_FLOAT_X8X24_TYPELESS, FMT.X32_TYPELESS_G8X24_UINT,
    FMT.D32_FLOAT, FMT.R24G8_TYPELESS, FMT.D24_UNORM_S8_UINT,
    FMT.R24_UNORM_X8_TYPELESS, FMT.X24_TYPELESS_G8_UINT,
    FMT.D16_UNORM, FMT.XBOX_D16_UNORM_S8_UINT,
    FMT.XBOX_R16_UNORM_X8_TYPELESS, FMT.XBOX_X16_TYPELESS_G8_UINT,
})

_SRGB = frozenset({
    FMT.R8G8B8A8_UNORM_SRGB, FMT.BC1_UNORM_SRGB, FMT.BC2_UNORM_SRGB,
    FMT.BC3_UNORM_SRGB, FMT.B8G8R8A8_UNORM_SRGB, FMT.B8G8R8X8_UNORM_SRGB,
    FMT.BC7_UNORM_SRGB,
})

_BGR = frozenset({
    FMT.B5G6R5_UNORM, FMT.B5G5R5A1_UNORM, FMT.B8G8R8A8_UNORM,
    FMT.B8G8R8X8_UNORM, FMT.B8G8R8A8_TYPELESS, FMT.B8G8R8A8_UNORM_SRGB,
    FMT.B8G8R8X8_TYPELESS, FMT.B8G8R8X8_UNORM_SRGB, FMT.B4G4R4A4_UNORM,
    FMT.A4B4G4R4_UNORM,
})

_FULL_TYPELESS = frozenset({
    FMT.R32G32B32A32_TYPELESS, FMT.R32G32B32_TYPELESS,
    FMT.R16G16B16A16_TYPELESS, FMT.R32G32_TYPELESS, FMT.R32G8X24_TYPELESS,
    FMT.R10G10B10A2_TYPELESS, FMT.R8G8B8A8_TYPELESS, FMT.R16G16_TYPELESS,
    FMT.R32_TYPELESS, FMT.R24G8_TYPELESS, FMT.R8G8_TYPELESS,
    FMT.R16_TYPELESS, FMT.R8_TYPELESS, FMT.BC1_TYPELESS, FMT.BC2_TYPELESS,
    FMT.BC3_TYPELESS, FMT.BC4_TYPELESS, FMT.BC5_TYPELESS,
    FMT.B8G8R8A8_TYPELESS, FMT.B8G8R8X8_TYPELESS, FMT.BC6H_TYPELESS,
    FMT.BC7_TYPELESS,
})

_PARTIAL_TYPELESS = frozenset({
    FMT.R32_FLOAT_X8X24_TYPELESS, FMT.X32_TYPELESS_G8X24_UINT,
    FMT.R24_UNORM_X8_TYPELESS, FMT.X24_TYPELESS_G8_UINT,
    FMT.XBOX_R16_UNORM_X8_TYPELESS, FMT.XBOX_X16_TYPELESS_G8_UINT,
})

_HAS_ALPHA = frozenset({
    FMT.R32G32B32A32_TYPELESS, FMT.R32G32B32A32_FLOAT,
    FMT.R32G32B32A32_UINT, FMT.R32G32B32A32_SINT,
    FMT.R16G16B16A16_TYPELESS, FMT.R16G16B16A16_FLOAT,
    FMT.R16G16B16A16_UNORM, FMT.R16G16B16A16_UINT,
    FMT.R16G16B16A16_SNORM, FMT.R16G16B16A16_SINT,
    FMT.R10G10B10A2_TYPELESS, FMT.R10G10B10A2_UNORM, FMT.R10G10B10A2_UINT,
    FMT.R8G8B8A8_TYPELESS, FMT.R8G8B8A8_UNORM, FMT.R8G8B8A8_UNORM_SRGB,
    FMT.R8G8B8A8_UINT, FMT.R8G8B8A8_SNORM, FMT.R8G8B8A8_SINT,
    FMT.A8_UNORM,
    FMT.BC1_TYPELESS, FMT.BC1_UNORM, FMT.BC1_UNORM_SRGB,
    FMT.BC2_TYPELESS, FMT.BC2_UNORM, FMT.BC2_UNORM_SRGB,
    FMT.BC3_TYPELESS, FMT.BC3_UNORM, FMT.BC3_UNORM_SRGB,
    FMT.B5G5R5A1_UNORM, FMT.B8G8R8A8_UNORM,
    FMT.R10G10B10_XR_BIAS_A2_UNORM, FMT.B8G8R8A8_TYPELESS,
    FMT.B8G8R8A8_UNORM_SRGB,
    FMT.BC7_TYPELESS, FMT.BC7_UNORM, FMT.BC7_UNORM_SRGB,
    FMT.AYUV, FMT.Y410, FMT.Y416, FMT.AI44, FMT.IA44, FMT.A8P8,
    FMT.B4G4R4A4_UNORM,
    FMT.XBOX_R10G10B10_7E3_A2_FLOAT, FMT.XBOX_R10G10B10_6E4_A2_FLOAT,
    FMT.XBOX_R10G10B10_SNORM_A2_UNORM, FMT.A4B4G4R4_UNORM,
})


def is_valid(fmt: int) -> bool:
    return 1 <= int(fmt) <= 191


def is_compressed(fmt: DXGIFormat) -> bool:
    return fmt in _COMPRESSED


def is_packed(fmt: DXGIFormat) -> bool:
    return fmt in _PACKED


def is_video(fmt: DXGIFormat) -> bool:
    return fmt in _VIDEO


def is_planar(fmt: DXGIFormat, isd3d12: bool = False) -> bool:
    if fmt in _PLANAR:
        return True
    return isd3d12 and fmt in _PLANAR_D3D12_EXTRA


def is_palettized(fmt: DXGIFormat) -> bool:
    return fmt in _PALETTIZED


def is_depth_stencil(fmt: DXGIFormat) -> bool:
    return fmt in _DEPTH_STENCIL


def is_srgb(fmt: DXGIFormat) -> bool:
    return fmt in _SRGB


def is_bgr(fmt: DXGIFormat) -> bool:
    return fmt in _BGR


def is_typeless(fmt: DXGIFormat, partial_typeless: bool = True) -> bool:
    if fmt in _FULL_TYPELESS:
        return True
    return partial_typeless and fmt in _PARTIAL_TYPELESS


def has_alpha(fmt: DXGIFormat) -> bool:
    return fmt in _HAS_ALPHA


# ---------------------------------------------------------------------------
# Bits per pixel (DirectXTexUtil.cpp:594-755)
# ---------------------------------------------------------------------------

def _expand(bpp_groups: dict[int, tuple[DXGIFormat, ...]]) -> dict[DXGIFormat, int]:
    table: dict[DXGIFormat, int] = {}
    for bits, fmts in bpp_groups.items():
        for f in fmts:
            table[f] = bits
    return table


_BPP = _expand({
    128: (FMT.R32G32B32A32_TYPELESS, FMT.R32G32B32A32_FLOAT,
          FMT.R32G32B32A32_UINT, FMT.R32G32B32A32_SINT),
    96: (FMT.R32G32B32_TYPELESS, FMT.R32G32B32_FLOAT,
         FMT.R32G32B32_UINT, FMT.R32G32B32_SINT),
    64: (FMT.R16G16B16A16_TYPELESS, FMT.R16G16B16A16_FLOAT,
         FMT.R16G16B16A16_UNORM, FMT.R16G16B16A16_UINT,
         FMT.R16G16B16A16_SNORM, FMT.R16G16B16A16_SINT,
         FMT.R32G32_TYPELESS, FMT.R32G32_FLOAT, FMT.R32G32_UINT,
         FMT.R32G32_SINT, FMT.R32G8X24_TYPELESS, FMT.D32_FLOAT_S8X24_UINT,
         FMT.R32_FLOAT_X8X24_TYPELESS, FMT.X32_TYPELESS_G8X24_UINT,
         FMT.Y416, FMT.Y210, FMT.Y216),
    32: (FMT.R10G10B10A2_TYPELESS, FMT.R10G10B10A2_UNORM,
         FMT.R10G10B10A2_UINT, FMT.R11G11B10_FLOAT, FMT.R8G8B8A8_TYPELESS,
         FMT.R8G8B8A8_UNORM, FMT.R8G8B8A8_UNORM_SRGB, FMT.R8G8B8A8_UINT,
         FMT.R8G8B8A8_SNORM, FMT.R8G8B8A8_SINT, FMT.R16G16_TYPELESS,
         FMT.R16G16_FLOAT, FMT.R16G16_UNORM, FMT.R16G16_UINT,
         FMT.R16G16_SNORM, FMT.R16G16_SINT, FMT.R32_TYPELESS, FMT.D32_FLOAT,
         FMT.R32_FLOAT, FMT.R32_UINT, FMT.R32_SINT, FMT.R24G8_TYPELESS,
         FMT.D24_UNORM_S8_UINT, FMT.R24_UNORM_X8_TYPELESS,
         FMT.X24_TYPELESS_G8_UINT, FMT.R9G9B9E5_SHAREDEXP,
         FMT.R8G8_B8G8_UNORM, FMT.G8R8_G8B8_UNORM, FMT.B8G8R8A8_UNORM,
         FMT.B8G8R8X8_UNORM, FMT.R10G10B10_XR_BIAS_A2_UNORM,
         FMT.B8G8R8A8_TYPELESS, FMT.B8G8R8A8_UNORM_SRGB,
         FMT.B8G8R8X8_TYPELESS, FMT.B8G8R8X8_UNORM_SRGB, FMT.AYUV,
         FMT.Y410, FMT.YUY2, FMT.XBOX_R10G10B10_7E3_A2_FLOAT,
         FMT.XBOX_R10G10B10_6E4_A2_FLOAT, FMT.XBOX_R10G10B10_SNORM_A2_UNORM),
    24: (FMT.P010, FMT.P016, FMT.XBOX_D16_UNORM_S8_UINT,
         FMT.XBOX_R16_UNORM_X8_TYPELESS, FMT.XBOX_X16_TYPELESS_G8_UINT,
         FMT.V408),
    16: (FMT.R8G8_TYPELESS, FMT.R8G8_UNORM, FMT.R8G8_UINT, FMT.R8G8_SNORM,
         FMT.R8G8_SINT, FMT.R16_TYPELESS, FMT.R16_FLOAT, FMT.D16_UNORM,
         FMT.R16_UNORM, FMT.R16_UINT, FMT.R16_SNORM, FMT.R16_SINT,
         FMT.B5G6R5_UNORM, FMT.B5G5R5A1_UNORM, FMT.A8P8,
         FMT.B4G4R4A4_UNORM, FMT.P208, FMT.V208, FMT.A4B4G4R4_UNORM),
    12: (FMT.NV12, FMT.OPAQUE_420, FMT.NV11),
    8: (FMT.R8_TYPELESS, FMT.R8_UNORM, FMT.R8_UINT, FMT.R8_SNORM,
        FMT.R8_SINT, FMT.A8_UNORM, FMT.BC2_TYPELESS, FMT.BC2_UNORM,
        FMT.BC2_UNORM_SRGB, FMT.BC3_TYPELESS, FMT.BC3_UNORM,
        FMT.BC3_UNORM_SRGB, FMT.BC5_TYPELESS, FMT.BC5_UNORM, FMT.BC5_SNORM,
        FMT.BC6H_TYPELESS, FMT.BC6H_UF16, FMT.BC6H_SF16, FMT.BC7_TYPELESS,
        FMT.BC7_UNORM, FMT.BC7_UNORM_SRGB, FMT.AI44, FMT.IA44, FMT.P8,
        FMT.XBOX_R4G4_UNORM),
    1: (FMT.R1_UNORM,),
    4: (FMT.BC1_TYPELESS, FMT.BC1_UNORM, FMT.BC1_UNORM_SRGB,
        FMT.BC4_TYPELESS, FMT.BC4_UNORM, FMT.BC4_SNORM),
})


def bits_per_pixel(fmt: DXGIFormat) -> int:
    """Bits-per-pixel for a format, or 0 (DirectXTexUtil.cpp:594)."""
    return _BPP.get(fmt, 0)


# ---------------------------------------------------------------------------
# Bits per color channel (DirectXTexUtil.cpp:755-920)
# ---------------------------------------------------------------------------

_BPC = _expand({
    32: (FMT.R32G32B32A32_TYPELESS, FMT.R32G32B32A32_FLOAT,
         FMT.R32G32B32A32_UINT, FMT.R32G32B32A32_SINT,
         FMT.R32G32B32_TYPELESS, FMT.R32G32B32_FLOAT, FMT.R32G32B32_UINT,
         FMT.R32G32B32_SINT, FMT.R32G32_TYPELESS, FMT.R32G32_FLOAT,
         FMT.R32G32_UINT, FMT.R32G32_SINT, FMT.R32G8X24_TYPELESS,
         FMT.D32_FLOAT_S8X24_UINT, FMT.R32_FLOAT_X8X24_TYPELESS,
         FMT.X32_TYPELESS_G8X24_UINT, FMT.R32_TYPELESS, FMT.D32_FLOAT,
         FMT.R32_FLOAT, FMT.R32_UINT, FMT.R32_SINT),
    24: (FMT.R24G8_TYPELESS, FMT.D24_UNORM_S8_UINT,
         FMT.R24_UNORM_X8_TYPELESS, FMT.X24_TYPELESS_G8_UINT),
    16: (FMT.R16G16B16A16_TYPELESS, FMT.R16G16B16A16_FLOAT,
         FMT.R16G16B16A16_UNORM, FMT.R16G16B16A16_UINT,
         FMT.R16G16B16A16_SNORM, FMT.R16G16B16A16_SINT, FMT.R16G16_TYPELESS,
         FMT.R16G16_FLOAT, FMT.R16G16_UNORM, FMT.R16G16_UINT,
         FMT.R16G16_SNORM, FMT.R16G16_SINT, FMT.R16_TYPELESS, FMT.R16_FLOAT,
         FMT.D16_UNORM, FMT.R16_UNORM, FMT.R16_UINT, FMT.R16_SNORM,
         FMT.R16_SINT, FMT.BC6H_TYPELESS, FMT.BC6H_UF16, FMT.BC6H_SF16,
         FMT.Y416, FMT.P016, FMT.Y216, FMT.XBOX_D16_UNORM_S8_UINT,
         FMT.XBOX_R16_UNORM_X8_TYPELESS, FMT.XBOX_X16_TYPELESS_G8_UINT),
    14: (FMT.R9G9B9E5_SHAREDEXP,),
    11: (FMT.R11G11B10_FLOAT,),
    10: (FMT.R10G10B10A2_TYPELESS, FMT.R10G10B10A2_UNORM,
         FMT.R10G10B10A2_UINT, FMT.R10G10B10_XR_BIAS_A2_UNORM, FMT.Y410,
         FMT.P010, FMT.Y210, FMT.XBOX_R10G10B10_7E3_A2_FLOAT,
         FMT.XBOX_R10G10B10_6E4_A2_FLOAT, FMT.XBOX_R10G10B10_SNORM_A2_UNORM),
    8: (FMT.R8G8B8A8_TYPELESS, FMT.R8G8B8A8_UNORM, FMT.R8G8B8A8_UNORM_SRGB,
        FMT.R8G8B8A8_UINT, FMT.R8G8B8A8_SNORM, FMT.R8G8B8A8_SINT,
        FMT.R8G8_TYPELESS, FMT.R8G8_UNORM, FMT.R8G8_UINT, FMT.R8G8_SNORM,
        FMT.R8G8_SINT, FMT.R8_TYPELESS, FMT.R8_UNORM, FMT.R8_UINT,
        FMT.R8_SNORM, FMT.R8_SINT, FMT.A8_UNORM, FMT.R8G8_B8G8_UNORM,
        FMT.G8R8_G8B8_UNORM, FMT.BC4_TYPELESS, FMT.BC4_UNORM, FMT.BC4_SNORM,
        FMT.BC5_TYPELESS, FMT.BC5_UNORM, FMT.BC5_SNORM, FMT.B8G8R8A8_UNORM,
        FMT.B8G8R8X8_UNORM, FMT.B8G8R8A8_TYPELESS, FMT.B8G8R8A8_UNORM_SRGB,
        FMT.B8G8R8X8_TYPELESS, FMT.B8G8R8X8_UNORM_SRGB, FMT.AYUV, FMT.NV12,
        FMT.OPAQUE_420, FMT.YUY2, FMT.NV11, FMT.P208, FMT.V208, FMT.V408),
    7: (FMT.BC7_TYPELESS, FMT.BC7_UNORM, FMT.BC7_UNORM_SRGB),
    6: (FMT.BC1_TYPELESS, FMT.BC1_UNORM, FMT.BC1_UNORM_SRGB,
        FMT.BC2_TYPELESS, FMT.BC2_UNORM, FMT.BC2_UNORM_SRGB,
        FMT.BC3_TYPELESS, FMT.BC3_UNORM, FMT.BC3_UNORM_SRGB,
        FMT.B5G6R5_UNORM),
    5: (FMT.B5G5R5A1_UNORM,),
    4: (FMT.B4G4R4A4_UNORM, FMT.XBOX_R4G4_UNORM, FMT.A4B4G4R4_UNORM),
    1: (FMT.R1_UNORM,),
})


def bits_per_color(fmt: DXGIFormat) -> int:
    """Largest color-channel depth, or 0 (DirectXTexUtil.cpp:755).

    Palettized formats return 0 by design.
    """
    return _BPC.get(fmt, 0)


_BPB8 = frozenset({
    FMT.BC1_TYPELESS, FMT.BC1_UNORM, FMT.BC1_UNORM_SRGB,
    FMT.BC4_TYPELESS, FMT.BC4_UNORM, FMT.BC4_SNORM,
})


def bytes_per_block(fmt: DXGIFormat) -> int:
    """Bytes per 4x4 BC block, or 0 for non-BC (DirectXTexUtil.cpp:921)."""
    if fmt in _BPB8:
        return 8
    if fmt in _COMPRESSED:
        return 16
    return 0


# ---------------------------------------------------------------------------
# Pitch / scanline math (DirectXTexUtil.cpp:961-1250)
# ---------------------------------------------------------------------------

def compute_pitch(
    fmt: DXGIFormat,
    width: int,
    height: int,
    flags: CP_FLAGS = CP_FLAGS.NONE,
) -> tuple[int, int]:
    """Returns (row_pitch, slice_pitch) in bytes (DirectXTexUtil.cpp:961)."""
    if fmt == FMT.UNKNOWN:
        raise ValueError("cannot compute pitch for DXGI_FORMAT_UNKNOWN")

    if is_compressed(fmt):
        bpb = bytes_per_block(fmt)
        if flags & CP_FLAGS.BAD_DXTN_TAILS:
            # Some legacy tools wrote truncated tails for non-multiple-of-4
            # mip levels (DDS_FLAGS_BAD_DXTN_TAILS).
            nbw = width >> 2
            nbh = height >> 2
            pitch = max(1, nbw * bpb)
            return pitch, max(1, pitch * nbh)
        nbw = max(1, (width + 3) // 4)
        nbh = max(1, (height + 3) // 4)
        pitch = nbw * bpb
        return pitch, pitch * nbh

    if fmt in (FMT.R8G8_B8G8_UNORM, FMT.G8R8_G8B8_UNORM, FMT.YUY2):
        pitch = ((width + 1) >> 1) * 4
        return pitch, pitch * height

    if fmt in (FMT.Y210, FMT.Y216):
        pitch = ((width + 1) >> 1) * 8
        return pitch, pitch * height

    if fmt in (FMT.NV12, FMT.OPAQUE_420):
        if height % 2 != 0:
            raise ValueError(f"{fmt.name} requires height aligned to 2")
        pitch = ((width + 1) >> 1) * 2
        return pitch, pitch * (height + ((height + 1) >> 1))

    if fmt in (FMT.P010, FMT.P016, FMT.XBOX_D16_UNORM_S8_UINT,
               FMT.XBOX_R16_UNORM_X8_TYPELESS, FMT.XBOX_X16_TYPELESS_G8_UINT):
        if fmt in (FMT.P010, FMT.P016) and height % 2 != 0:
            raise ValueError(f"{fmt.name} requires height aligned to 2")
        pitch = ((width + 1) >> 1) * 4
        return pitch, pitch * (height + ((height + 1) >> 1))

    if fmt == FMT.NV11:
        pitch = ((width + 3) >> 2) * 4
        return pitch, pitch * height * 2

    if fmt == FMT.P208:
        pitch = ((width + 1) >> 1) * 2
        return pitch, pitch * height * 2

    if fmt == FMT.V208:
        if height % 2 != 0:
            raise ValueError("V208 requires height aligned to 2")
        pitch = width
        return pitch, pitch * (height + (((height + 1) >> 1) * 2))

    if fmt == FMT.V408:
        pitch = width
        return pitch, pitch * (height + ((height >> 1) * 4))

    # Uncompressed path
    if flags & CP_FLAGS.BPP24:
        bpp = 24
    elif flags & CP_FLAGS.BPP16:
        bpp = 16
    elif flags & CP_FLAGS.BPP8:
        bpp = 8
    else:
        bpp = bits_per_pixel(fmt)
    if bpp == 0:
        raise ValueError(f"no bits-per-pixel for format {fmt!r}")

    if flags & CP_FLAGS.PAGE4K:
        pitch = ((width * bpp + 32767) // 32768) * 4096
    elif flags & CP_FLAGS.ZMM:
        pitch = ((width * bpp + 511) // 512) * 64
    elif flags & CP_FLAGS.YMM:
        pitch = ((width * bpp + 255) // 256) * 32
    elif flags & CP_FLAGS.PARAGRAPH:
        pitch = ((width * bpp + 127) // 128) * 16
    elif flags & CP_FLAGS.LEGACY_DWORD:
        # Special computation for DDS files created with legacy DirectDraw
        # pitch-alignment assumptions.
        pitch = ((width * bpp + 31) // 32) * 4
    else:
        pitch = (width * bpp + 7) // 8
    return pitch, pitch * height


def compute_scanlines(fmt: DXGIFormat, height: int) -> int:
    """Number of rows of *stored* data (DirectXTexUtil.cpp:1188)."""
    if fmt == FMT.UNKNOWN:
        return 0
    if is_compressed(fmt):
        return max(1, (height + 3) // 4)
    if fmt in (FMT.NV11, FMT.P208):
        return height * 2
    if fmt == FMT.V208:
        return height + (((height + 1) >> 1) * 2)
    if fmt == FMT.V408:
        return height + ((height >> 1) * 4)
    if fmt in (FMT.NV12, FMT.P010, FMT.P016, FMT.OPAQUE_420,
               FMT.XBOX_D16_UNORM_S8_UINT, FMT.XBOX_R16_UNORM_X8_TYPELESS,
               FMT.XBOX_X16_TYPELESS_G8_UINT):
        return height + ((height + 1) >> 1)
    return height


def calculate_mip_levels(width: int, height: int, mip_levels: int = 0) -> int:
    """Full (or validated) mip count for a 2D texture (DirectXTex.h:145)."""
    if mip_levels > 1:
        max_mips = calculate_mip_levels(width, height)
        if mip_levels > max_mips:
            raise ValueError(f"requested {mip_levels} mips, max is {max_mips}")
        return mip_levels
    if mip_levels == 1:
        return 1
    count = 1
    size = max(width, height)
    while size > 1:
        size >>= 1
        count += 1
    return count


def calculate_mip_levels_3d(width: int, height: int, depth: int,
                            mip_levels: int = 0) -> int:
    """Full (or validated) mip count for a volume texture (DirectXTex.h:147)."""
    if mip_levels > 1:
        max_mips = calculate_mip_levels_3d(width, height, depth)
        if mip_levels > max_mips:
            raise ValueError(f"requested {mip_levels} mips, max is {max_mips}")
        return mip_levels
    if mip_levels == 1:
        return 1
    count = 1
    size = max(width, height, depth)
    while size > 1:
        size >>= 1
        count += 1
    return count


# ---------------------------------------------------------------------------
# Format-family conversions (DirectXTexUtil.cpp:1411-1660)
# ---------------------------------------------------------------------------

_SRGB_OF = {
    FMT.R8G8B8A8_UNORM: FMT.R8G8B8A8_UNORM_SRGB,
    FMT.BC1_UNORM: FMT.BC1_UNORM_SRGB,
    FMT.BC2_UNORM: FMT.BC2_UNORM_SRGB,
    FMT.BC3_UNORM: FMT.BC3_UNORM_SRGB,
    FMT.B8G8R8A8_UNORM: FMT.B8G8R8A8_UNORM_SRGB,
    FMT.B8G8R8X8_UNORM: FMT.B8G8R8X8_UNORM_SRGB,
    FMT.BC7_UNORM: FMT.BC7_UNORM_SRGB,
}
_LINEAR_OF = {v: k for k, v in _SRGB_OF.items()}


def make_srgb(fmt: DXGIFormat) -> DXGIFormat:
    return _SRGB_OF.get(fmt, fmt)


def make_linear(fmt: DXGIFormat) -> DXGIFormat:
    return _LINEAR_OF.get(fmt, fmt)


_TYPELESS_OF = _expand({
    FMT.R32G32B32A32_TYPELESS: (FMT.R32G32B32A32_FLOAT,
                                FMT.R32G32B32A32_UINT, FMT.R32G32B32A32_SINT),
    FMT.R32G32B32_TYPELESS: (FMT.R32G32B32_FLOAT, FMT.R32G32B32_UINT,
                             FMT.R32G32B32_SINT),
    FMT.R16G16B16A16_TYPELESS: (FMT.R16G16B16A16_FLOAT,
                                FMT.R16G16B16A16_UNORM,
                                FMT.R16G16B16A16_UINT,
                                FMT.R16G16B16A16_SNORM,
                                FMT.R16G16B16A16_SINT),
    FMT.R32G32_TYPELESS: (FMT.R32G32_FLOAT, FMT.R32G32_UINT, FMT.R32G32_SINT),
    FMT.R10G10B10A2_TYPELESS: (FMT.R10G10B10A2_UNORM, FMT.R10G10B10A2_UINT,
                               FMT.XBOX_R10G10B10_7E3_A2_FLOAT,
                               FMT.XBOX_R10G10B10_6E4_A2_FLOAT,
                               FMT.XBOX_R10G10B10_SNORM_A2_UNORM),
    FMT.R8G8B8A8_TYPELESS: (FMT.R8G8B8A8_UNORM, FMT.R8G8B8A8_UNORM_SRGB,
                            FMT.R8G8B8A8_UINT, FMT.R8G8B8A8_SNORM,
                            FMT.R8G8B8A8_SINT),
    FMT.R16G16_TYPELESS: (FMT.R16G16_FLOAT, FMT.R16G16_UNORM,
                          FMT.R16G16_UINT, FMT.R16G16_SNORM, FMT.R16G16_SINT),
    FMT.R32_TYPELESS: (FMT.D32_FLOAT, FMT.R32_FLOAT, FMT.R32_UINT,
                       FMT.R32_SINT),
    FMT.R8G8_TYPELESS: (FMT.R8G8_UNORM, FMT.R8G8_UINT, FMT.R8G8_SNORM,
                        FMT.R8G8_SINT),
    FMT.R16_TYPELESS: (FMT.R16_FLOAT, FMT.D16_UNORM, FMT.R16_UNORM,
                       FMT.R16_UINT, FMT.R16_SNORM, FMT.R16_SINT),
    FMT.R8_TYPELESS: (FMT.R8_UNORM, FMT.R8_UINT, FMT.R8_SNORM, FMT.R8_SINT,
                      FMT.XBOX_R4G4_UNORM),
    FMT.BC1_TYPELESS: (FMT.BC1_UNORM, FMT.BC1_UNORM_SRGB),
    FMT.BC2_TYPELESS: (FMT.BC2_UNORM, FMT.BC2_UNORM_SRGB),
    FMT.BC3_TYPELESS: (FMT.BC3_UNORM, FMT.BC3_UNORM_SRGB),
    FMT.BC4_TYPELESS: (FMT.BC4_UNORM, FMT.BC4_SNORM),
    FMT.BC5_TYPELESS: (FMT.BC5_UNORM, FMT.BC5_SNORM),
    FMT.B8G8R8A8_TYPELESS: (FMT.B8G8R8A8_UNORM, FMT.B8G8R8A8_UNORM_SRGB),
    FMT.B8G8R8X8_TYPELESS: (FMT.B8G8R8X8_UNORM, FMT.B8G8R8X8_UNORM_SRGB),
    FMT.BC6H_TYPELESS: (FMT.BC6H_UF16, FMT.BC6H_SF16),
    FMT.BC7_TYPELESS: (FMT.BC7_UNORM, FMT.BC7_UNORM_SRGB),
})


def make_typeless(fmt: DXGIFormat) -> DXGIFormat:
    return _TYPELESS_OF.get(fmt, fmt)


_UNORM_OF_TYPELESS = {
    FMT.R16G16B16A16_TYPELESS: FMT.R16G16B16A16_UNORM,
    FMT.R10G10B10A2_TYPELESS: FMT.R10G10B10A2_UNORM,
    FMT.R8G8B8A8_TYPELESS: FMT.R8G8B8A8_UNORM,
    FMT.R16G16_TYPELESS: FMT.R16G16_UNORM,
    FMT.R8G8_TYPELESS: FMT.R8G8_UNORM,
    FMT.R16_TYPELESS: FMT.R16_UNORM,
    FMT.R8_TYPELESS: FMT.R8_UNORM,
    FMT.BC1_TYPELESS: FMT.BC1_UNORM,
    FMT.BC2_TYPELESS: FMT.BC2_UNORM,
    FMT.BC3_TYPELESS: FMT.BC3_UNORM,
    FMT.BC4_TYPELESS: FMT.BC4_UNORM,
    FMT.BC5_TYPELESS: FMT.BC5_UNORM,
    FMT.B8G8R8A8_TYPELESS: FMT.B8G8R8A8_UNORM,
    FMT.B8G8R8X8_TYPELESS: FMT.B8G8R8X8_UNORM,
    FMT.BC7_TYPELESS: FMT.BC7_UNORM,
}


def make_typeless_unorm(fmt: DXGIFormat) -> DXGIFormat:
    return _UNORM_OF_TYPELESS.get(fmt, fmt)


_FLOAT_OF_TYPELESS = {
    FMT.R32G32B32A32_TYPELESS: FMT.R32G32B32A32_FLOAT,
    FMT.R32G32B32_TYPELESS: FMT.R32G32B32_FLOAT,
    FMT.R16G16B16A16_TYPELESS: FMT.R16G16B16A16_FLOAT,
    FMT.R32G32_TYPELESS: FMT.R32G32_FLOAT,
    FMT.R16G16_TYPELESS: FMT.R16G16_FLOAT,
    FMT.R32_TYPELESS: FMT.R32_FLOAT,
    FMT.R16_TYPELESS: FMT.R16_FLOAT,
}


def make_typeless_float(fmt: DXGIFormat) -> DXGIFormat:
    return _FLOAT_OF_TYPELESS.get(fmt, fmt)


# ---------------------------------------------------------------------------
# Tiled-resource tile shapes (DirectXTexUtil.cpp:1259, DirectXTex.h:538-578)
# ---------------------------------------------------------------------------

TILED_RESOURCE_TILE_SIZE_IN_BYTES = 65536


def compute_tile_shape(fmt: DXGIFormat, dimension: int) -> tuple[int, int, int]:
    """Standard 64KB tile shape (width, height, depth) for a format.

    dimension is a TexDimension value (2=1D, 3=2D, 4=3D). Raises ValueError
    for video/packed/1bpp/24bpp/96bpp formats, matching the reference.
    """
    if is_video(fmt) or is_packed(fmt):
        raise ValueError(f"no tile shape for video/packed format {fmt!r}")
    bpp = bits_per_pixel(fmt)
    if bpp in (0, 1, 24, 96):
        raise ValueError(f"no tile shape for {bpp}bpp format {fmt!r}")
    compressed = is_compressed(fmt)
    bpb = bytes_per_block(fmt)

    if dimension == 2:  # TEXTURE1D
        if compressed:
            raise ValueError("1D tiled resources cannot be compressed")
        return (TILED_RESOURCE_TILE_SIZE_IN_BYTES * 8 // bpp, 1, 1)

    if dimension == 3:  # TEXTURE2D
        if compressed:
            if bpb == 8:
                return (128 * 4, 64 * 4, 1)
            return (64 * 4, 64 * 4, 1)
        if bpp <= 8:
            return (256, 256, 1)
        if bpp <= 16:
            return (256, 128, 1)
        if bpp <= 32:
            return (128, 128, 1)
        if bpp <= 64:
            return (128, 64, 1)
        return (64, 64, 1)

    if dimension == 4:  # TEXTURE3D
        if compressed:
            if bpb == 8:
                return (32 * 4, 16 * 4, 16)
            return (16 * 4, 16 * 4, 16)
        if bpp <= 8:
            return (64, 32, 32)
        if bpp <= 16:
            return (32, 32, 32)
        if bpp <= 32:
            return (32, 32, 16)
        if bpp <= 64:
            return (32, 16, 16)
        return (16, 16, 16)

    raise ValueError(f"invalid dimension {dimension}")
