"""Op flag enums, mirroring DirectXTex.h values exactly.

A verbatim copy of directxtex_tpu/ops/flags.py (tests/test_torch_formats.py
pins it equal).

TEX_FR_FLAGS (DirectXTex.h:723-731), TEX_FILTER_FLAGS (:741-797),
TEX_PMALPHA_FLAGS (:864-879), TEX_COMPRESS_FLAGS (:887-917),
CNMAP_FLAGS (:973-995), CMSE_FLAGS (:1022-1039).
"""

from __future__ import annotations

import enum


class TEX_FR_FLAGS(enum.IntFlag):
    ROTATE0 = 0
    ROTATE90 = 0x1
    ROTATE180 = 0x2
    ROTATE270 = 0x3
    FLIP_HORIZONTAL = 0x08
    FLIP_VERTICAL = 0x10


class TEX_FILTER_FLAGS(enum.IntFlag):
    DEFAULT = 0

    WRAP_U = 0x1
    WRAP_V = 0x2
    WRAP_W = 0x4
    WRAP = 0x7
    MIRROR_U = 0x10
    MIRROR_V = 0x20
    MIRROR_W = 0x40
    MIRROR = 0x70

    SEPARATE_ALPHA = 0x100
    FLOAT_X2BIAS = 0x200

    RGB_COPY_RED = 0x1000
    RGB_COPY_GREEN = 0x2000
    RGB_COPY_BLUE = 0x4000
    RGB_COPY_ALPHA = 0x8000

    DITHER = 0x10000
    DITHER_DIFFUSION = 0x20000

    POINT = 0x100000
    LINEAR = 0x200000
    CUBIC = 0x300000
    BOX = 0x400000
    FANT = 0x400000  # equivalent to BOX for mipmaps
    TRIANGLE = 0x500000

    SRGB_IN = 0x1000000
    SRGB_OUT = 0x2000000
    SRGB = 0x3000000

    FORCE_NON_WIC = 0x10000000
    FORCE_WIC = 0x20000000


TEX_FILTER_DITHER_MASK = 0xF0000
TEX_FILTER_MODE_MASK = 0xF00000
TEX_FILTER_SRGB_MASK = 0xF000000
TEX_THRESHOLD_DEFAULT = 0.5
TEX_ALPHA_WEIGHT_DEFAULT = 1.0


class TEX_PMALPHA_FLAGS(enum.IntFlag):
    DEFAULT = 0
    IGNORE_SRGB = 0x1
    REVERSE = 0x2
    SRGB_IN = 0x1000000
    SRGB_OUT = 0x2000000
    SRGB = 0x3000000


class TEX_COMPRESS_FLAGS(enum.IntFlag):
    DEFAULT = 0
    RGB_DITHER = 0x10000
    A_DITHER = 0x20000
    DITHER = 0x30000
    UNIFORM = 0x40000
    BC7_USE_3SUBSETS = 0x80000
    BC7_QUICK = 0x100000
    # extension: a second winner-refine perturbation pass (the analog of
    # the reference CPU codec's OptimizeEndPoints hill climb,
    # BC6HBC7.cpp:2926-3044); the default tier already runs one pass
    BC7_MAXQUALITY = 0x200000
    # extension (r5): BC6H mid quality tier — default search + one
    # remap-ladder round on the winner (between default and MAXQUALITY
    # on the quality/cost frontier; BC6HBC7.cpp:2081-2226 analog)
    BC6H_MID = 0x400000
    SRGB_IN = 0x1000000
    SRGB_OUT = 0x2000000
    SRGB = 0x3000000
    PARALLEL = 0x10000000


class CNMAP_FLAGS(enum.IntFlag):
    DEFAULT = 0
    CHANNEL_RED = 0x1
    CHANNEL_GREEN = 0x2
    CHANNEL_BLUE = 0x3
    CHANNEL_ALPHA = 0x4
    CHANNEL_LUMINANCE = 0x5
    MIRROR_U = 0x1000
    MIRROR_V = 0x2000
    MIRROR = 0x3000
    INVERT_SIGN = 0x4000
    COMPUTE_OCCLUSION = 0x8000


CNMAP_CHANNEL_MASK = 0xF


class CMSE_FLAGS(enum.IntFlag):
    DEFAULT = 0
    IMAGE1_SRGB = 0x1
    IMAGE2_SRGB = 0x2
    IGNORE_RED = 0x10
    IGNORE_GREEN = 0x20
    IGNORE_BLUE = 0x40
    IGNORE_ALPHA = 0x80
    IMAGE1_X2_BIAS = 0x100
    IMAGE2_X2_BIAS = 0x200
