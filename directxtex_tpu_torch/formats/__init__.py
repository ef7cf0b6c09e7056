"""Format core: DXGI format space, traits, and packed-layout descriptors
(the port's copies of directxtex_tpu/formats; the wire-format codec is
formats.packing, on torch tensors)."""

from .dxgi import DXGIFormat, FMT, format_from_name
from .traits import (
    CP_FLAGS,
    bits_per_color,
    bits_per_pixel,
    bytes_per_block,
    calculate_mip_levels,
    calculate_mip_levels_3d,
    compute_pitch,
    compute_scanlines,
    compute_tile_shape,
    has_alpha,
    is_bgr,
    is_compressed,
    is_depth_stencil,
    is_packed,
    is_palettized,
    is_planar,
    is_srgb,
    is_typeless,
    is_valid,
    is_video,
    make_linear,
    make_srgb,
    make_typeless,
    make_typeless_float,
    make_typeless_unorm,
)

__all__ = [
    "DXGIFormat", "FMT", "format_from_name",
    "CP_FLAGS", "bits_per_color", "bits_per_pixel", "bytes_per_block",
    "calculate_mip_levels", "calculate_mip_levels_3d", "compute_pitch",
    "compute_scanlines", "compute_tile_shape", "has_alpha", "is_bgr", "is_compressed",
    "is_depth_stencil", "is_packed", "is_palettized", "is_planar", "is_srgb",
    "is_typeless", "is_valid", "is_video", "make_linear", "make_srgb",
    "make_typeless", "make_typeless_float", "make_typeless_unorm",
]
