"""Texture ops on torch tensors (the port's part of directxtex_tpu/ops):
sRGB conversion, the normal map's neighbourhood fetch, format conversion
(with the ordered dither), compress / decompress and the flag enums."""

from .colorspace import (
    apply_linear_to_srgb, apply_srgb_to_linear, linear_to_srgb, srgb_to_linear,
)
from .convert import (CONVF, convert, convert_ex, convert_to_single_plane,
                      convert_values, get_convert_flags)
from .flags import (
    CMSE_FLAGS, CNMAP_FLAGS, TEX_COMPRESS_FLAGS, TEX_FILTER_FLAGS,
    TEX_FR_FLAGS, TEX_PMALPHA_FLAGS, TEX_THRESHOLD_DEFAULT,
)
from .compress import (compress, compress_ex, compress_many,
                       decompress, default_decompress_format)

__all__ = [
    "CMSE_FLAGS", "CNMAP_FLAGS", "CONVF", "TEX_COMPRESS_FLAGS",
    "TEX_FILTER_FLAGS", "TEX_FR_FLAGS", "TEX_PMALPHA_FLAGS",
    "TEX_THRESHOLD_DEFAULT",
    "apply_linear_to_srgb", "apply_srgb_to_linear", "compress",
    "compress_ex", "compress_many", "convert", "convert_ex",
    "convert_to_single_plane", "convert_values", "decompress",
    "default_decompress_format", "get_convert_flags", "linear_to_srgb",
    "srgb_to_linear",
]
