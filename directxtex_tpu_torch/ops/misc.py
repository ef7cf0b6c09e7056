"""Misc image ops on torch tensors: ComputeMSE, CopyRectangle,
EvaluateImage, TransformImage (DirectXTexMisc.cpp).

The counterpart of directxtex_tpu/ops/misc.py. The images stay on their
device: compute_mse returns device scalars, evaluate_image and
transform_image hand `pixel_func` the device tensors. An image given as a
numpy array goes to `device` (CUDA unless named).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..formats.dxgi import FMT, DXGIFormat
from ..numerics import power
from ..texture import Texture
from ..utils.device import constant, resolve
from .flags import CMSE_FLAGS

__all__ = ["compute_mse", "compute_psnr", "copy_rectangle", "evaluate_image",
           "transform_image"]

# g_Gamma22: the gamma-2.2 approximation of sRGB (RGB only)
_GAMMA22 = (2.2, 2.2, 2.2, 1.0)

_SRGB_MSE_FORMATS = (
    FMT.R8G8B8A8_UNORM_SRGB, FMT.BC1_UNORM_SRGB, FMT.BC2_UNORM_SRGB,
    FMT.BC3_UNORM_SRGB, FMT.B8G8R8A8_UNORM_SRGB, FMT.BC7_UNORM_SRGB,
)


def _implied_flags(fmt: DXGIFormat, which: int, flags: CMSE_FLAGS) -> CMSE_FLAGS:
    """Flags implied by image format (DirectXTexMisc.cpp:47-92)."""
    srgb = CMSE_FLAGS.IMAGE1_SRGB if which == 1 else CMSE_FLAGS.IMAGE2_SRGB
    if fmt == FMT.B8G8R8X8_UNORM:
        flags |= CMSE_FLAGS.IGNORE_ALPHA
    elif fmt == FMT.B8G8R8X8_UNORM_SRGB:
        flags |= srgb | CMSE_FLAGS.IGNORE_ALPHA
    elif fmt in _SRGB_MSE_FORMATS:
        flags |= srgb
    return flags


def _f32(image, device) -> torch.Tensor:
    """An f32 tensor of `image`: a tensor stays on its device."""
    if torch.is_tensor(image):
        return image.to(torch.float32)
    return torch.from_numpy(np.array(image, np.float32)).to(resolve(device))


def _gamma22(v: torch.Tensor) -> torch.Tensor:
    """v ** _GAMMA22: RGB to the power 2.2, alpha as it is (x ** 1)."""
    return torch.cat([power(v[..., :3], _GAMMA22[0]), v[..., 3:]], dim=-1)


def compute_mse(image1, image2, flags: CMSE_FLAGS = CMSE_FLAGS.DEFAULT,
                fmt1: DXGIFormat | None = None,
                fmt2: DXGIFormat | None = None,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """MSE between two [..., 4] RGBA images (ComputeMSE,
    DirectXTexMisc.cpp:27-180). Returns (mse_scalar, mse_per_channel[4]);
    the scalar is the SUM of the four channel MSEs, matching the reference.
    """
    flags = CMSE_FLAGS(flags)
    if fmt1 is not None:
        flags = _implied_flags(fmt1, 1, flags)
    if fmt2 is not None:
        flags = _implied_flags(fmt2, 2, flags)

    v1 = _f32(image1, device)
    v2 = _f32(image2, v1.device)
    if v1.shape[-1] not in (3, 4) or v2.shape[-1] not in (3, 4):
        raise ValueError("compute_mse expects [..., 3] or [..., 4] images")
    if v1.shape[-1] == 3:
        v1 = torch.cat([v1, v1.new_zeros(v1.shape[:-1] + (1,))], dim=-1)
        flags |= CMSE_FLAGS.IGNORE_ALPHA
    if v2.shape[-1] == 3:
        v2 = torch.cat([v2, v2.new_zeros(v2.shape[:-1] + (1,))], dim=-1)
        flags |= CMSE_FLAGS.IGNORE_ALPHA
    if flags & CMSE_FLAGS.IMAGE1_SRGB:
        v1 = _gamma22(v1)
    if flags & CMSE_FLAGS.IMAGE1_X2_BIAS:
        v1 = v1 * 2.0 - 1.0
    if flags & CMSE_FLAGS.IMAGE2_SRGB:
        v2 = _gamma22(v2)
    if flags & CMSE_FLAGS.IMAGE2_X2_BIAS:
        v2 = v2 * 2.0 - 1.0

    d = v1 - v2
    mask = tuple(0.0 if flags & f else 1.0 for f in (
        CMSE_FLAGS.IGNORE_RED, CMSE_FLAGS.IGNORE_GREEN,
        CMSE_FLAGS.IGNORE_BLUE, CMSE_FLAGS.IGNORE_ALPHA))
    d = d * constant(("cmse_mask", mask),
                     lambda: np.array(mask, np.float32), d.device)
    npix = d.numel() // 4
    sq = (d * d).reshape(-1, 4).sum(dim=0)
    mse_v = torch.div(sq, torch.full_like(sq, float(npix)))
    return mse_v.sum(), mse_v


def compute_psnr(image1, image2, flags: CMSE_FLAGS = CMSE_FLAGS.DEFAULT,
                 device=None) -> torch.Tensor:
    """PSNR in dB over RGB channels (peak 1.0), the benchmark quality metric.

    Uses MSE averaged over the 3 color channels (texconv/texdiag convention).
    """
    _, mse_v = compute_mse(image1, image2, flags | CMSE_FLAGS.IGNORE_ALPHA,
                           device=device)
    s = mse_v.sum()
    mse = torch.div(s, torch.full_like(s, 3.0))
    m = torch.maximum(mse, torch.full_like(mse, 1e-30))
    return 10.0 * torch.log10(torch.div(torch.ones_like(m), m))


def copy_rectangle(src: torch.Tensor, src_rect: tuple[int, int, int, int],
                   dst: torch.Tensor, x_offset: int,
                   y_offset: int) -> torch.Tensor:
    """CopyRectangle (DirectXTexMisc.cpp:275): paste src[y:y+h, x:x+w] into
    dst at (x_offset, y_offset). Arrays are [H, W, 4]; returns new dst."""
    x, y, w, h = src_rect
    if x + w > src.shape[1] or y + h > src.shape[0]:
        raise ValueError("source rectangle out of bounds")
    if x_offset + w > dst.shape[1] or y_offset + h > dst.shape[0]:
        raise ValueError("destination rectangle out of bounds")
    out = dst.clone()
    out[y_offset:y_offset + h, x_offset:x_offset + w] = \
        src[y:y + h, x:x + w]
    return out


def evaluate_image(tex_or_image,
                   pixel_func: Callable[[torch.Tensor], None]) -> None:
    """EvaluateImage (DirectXTexMisc.cpp:475): call `pixel_func(pixels)` with
    each full [H, W, 4] plane (the reference iterates scanlines; on the
    device the natural unit is the whole plane)."""
    if isinstance(tex_or_image, Texture):
        for lvl in tex_or_image.levels:
            for item in range(lvl.shape[0]):
                pixel_func(lvl[item])
    else:
        pixel_func(tex_or_image)


def transform_image(tex: Texture,
                    pixel_func: Callable[[torch.Tensor], torch.Tensor]
                    ) -> Texture:
    """TransformImage (DirectXTexMisc.cpp:606): map a user function over every
    [H, W, 4] plane, producing a new texture."""
    new_levels = []
    for lvl in tex.levels:
        out = torch.stack([pixel_func(lvl[item])
                           for item in range(lvl.shape[0])])
        if out.shape != lvl.shape:
            raise ValueError("pixel_func must preserve shape")
        new_levels.append(out)
    return tex.replace_levels(new_levels)
