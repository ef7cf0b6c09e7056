"""Texture ops on torch tensors (the port's part of directxtex_tpu/ops):
sRGB conversion, format conversion (with the ordered and the diffusion
dither), compress / decompress, flip / rotate, resize, mipmaps (2D, 3D,
alpha coverage), premultiplied alpha, the normal map, color rotation and
PQ, MSE / PSNR and the per-image helpers, and the flag enums. Its
`__all__` is the JAX package's."""

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
from .fliprotate import flip_rotate
from .mipmaps import (
    calculate_alpha_coverage, generate_mipmaps, generate_mipmaps_3d,
    scale_mipmaps_alpha_for_coverage,
)
from .resize import resize, resize_array
from .misc import (
    compute_mse, compute_psnr, copy_rectangle, evaluate_image, transform_image,
)
from .normalmaps import compute_normal_map
from .pmalpha import demultiply_values, premultiply_alpha, premultiply_values

__all__ = [
    "CMSE_FLAGS", "CNMAP_FLAGS", "CONVF", "TEX_COMPRESS_FLAGS",
    "TEX_FILTER_FLAGS", "TEX_FR_FLAGS", "TEX_PMALPHA_FLAGS",
    "TEX_THRESHOLD_DEFAULT",
    "apply_linear_to_srgb", "apply_srgb_to_linear",
    "calculate_alpha_coverage", "compress", "compress_ex",
    "compress_many", "compute_mse",
    "compute_normal_map", "compute_psnr", "convert", "convert_ex",
    "convert_to_single_plane", "convert_values", "copy_rectangle",
    "demultiply_values", "evaluate_image", "flip_rotate",
    "decompress", "default_decompress_format", "generate_mipmaps",
    "generate_mipmaps_3d", "get_convert_flags", "linear_to_srgb",
    "premultiply_alpha", "premultiply_values", "resize", "resize_array",
    "scale_mipmaps_alpha_for_coverage", "srgb_to_linear", "transform_image",
]
