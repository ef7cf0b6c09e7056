"""Mipmap generation (DirectXTexMipmaps.cpp) on torch tensors.

The counterpart of directxtex_tpu/ops/mipmaps.py. The reference generates
level l+1 from level l with per-filter scanline loops (Generate2DMips*
Filter, :907-1607). Here each level is a few torch ops on the texture's
device: point = strided slice, box = 2x2 (or 1x2/2x1) mean, linear/cubic/
triangle through the resize module's weight matrices. sRGB-correct
filtering wraps the whole chain in transfer functions (Load/
StoreScanlineLinear semantics).

Alpha-coverage preservation (ScaleMipMapsAlphaForCoverage,
DirectXTexMipmaps.cpp:3483) runs the reference's bisection search on
device tensors, the whole level at once, with no read back to the host.

Where the JAX package fails, the port refuses with ValueError: the box
filter (DEFAULT / BOX) on a level with an odd side above 1, where the JAX
package's reshape raises TypeError, and POINT on such a level, where its
strided slice keeps the odd texel and the chain leaves the sizes that its
own mip count expects (a 3 x 3 level gives 2 x 2, not 1 x 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats import traits
from ..texture import TexDimension, Texture
from .colorspace import apply_linear_to_srgb, apply_srgb_to_linear
from .flags import TEX_FILTER_FLAGS as TF
from .flags import TEX_FILTER_MODE_MASK
from .resize import resize_array, weights_on

__all__ = ["generate_mipmaps", "generate_mipmaps_3d",
           "scale_mipmaps_alpha_for_coverage", "calculate_alpha_coverage"]

_COVERAGE_STEPS = 10     # EstimateAlphaScaleForCoverage's bisection steps


def _refuse_odd(sides, what: str) -> None:
    """ValueError where a side above 1 is odd (see the module docstring)."""
    odd = [s for s in sides if s > 1 and s % 2]
    if odd:
        raise ValueError(
            f"{what}: a level of size {'x'.join(map(str, sides))} has an odd "
            f"side above 1, which this filter cannot halve; the JAX package "
            f"fails here too (ROADMAP queue 3). Use LINEAR, CUBIC or "
            f"TRIANGLE, or a power-of-two size")


def _halve(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean of each pair along `dim` (even length): (a + b) / 2, as the
    JAX package's reshape-mean rounds it."""
    shape = list(x.shape)
    shape[dim:dim + 1] = [shape[dim] // 2, 2]
    pairs = x.reshape(shape)
    s = pairs.select(dim + 1, 0) + pairs.select(dim + 1, 1)
    return torch.div(s, torch.full_like(s, 2.0))


def _box_reduce_2d(img: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 4] -> [N, H/2, W/2, 4] box filter; handles H==1 or W==1."""
    _, h, w, _ = img.shape
    _refuse_odd((h, w), "box mip reduction")
    if h > 1:
        img = _halve(img, 1)
    if w > 1:
        img = _halve(img, 2)
    return img


def _point_reduce_2d(img: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 4] -> [N, H/2, W/2, 4] point sample; handles H==1/W==1."""
    _, h, w, _ = img.shape
    _refuse_odd((h, w), "point mip reduction")
    if h > 1 and w > 1:
        return img[:, ::2, ::2]
    return img[:, :, ::2] if w > 1 else img[:, ::2, :]


def _reduce_level(img: torch.Tensor, mode: int, wrap_mirror: TF
                  ) -> torch.Tensor:
    """One mip reduction step for 2D [N, H, W, 4]."""
    if mode == int(TF.POINT):
        return _point_reduce_2d(img)
    if mode in (0, int(TF.BOX), int(TF.LINEAR), int(TF.CUBIC),
                int(TF.TRIANGLE)):
        # linear/cubic/triangle for exact-1/2 downscale: the reference's
        # linear filter with a pow2 halving reduces to the same 2x2 box;
        # cubic/triangle use the resize module once sizes aren't pow2.
        n, h, w, c = img.shape
        nh, nw = max(1, h // 2), max(1, w // 2)
        if mode in (0, int(TF.BOX)) or (h // 2 * 2 == h and w // 2 * 2 == w):
            if mode in (int(TF.CUBIC), int(TF.TRIANGLE)):
                return resize_array(img, nw, nh, TF(mode) | wrap_mirror)
            return _box_reduce_2d(img)
        return resize_array(img, nw, nh, TF(mode) | wrap_mirror)
    raise ValueError(f"unknown filter mode {mode:#x}")


def generate_mipmaps(tex: Texture, filter_flags: TF = TF.DEFAULT,
                     levels: int = 0) -> Texture:
    """GenerateMipMaps (DirectXTexMipmaps.cpp:2828). levels=0 => full chain."""
    filter_flags = TF(filter_flags)
    meta = tex.metadata
    if meta.dimension == TexDimension.TEXTURE3D:
        return generate_mipmaps_3d(tex, filter_flags, levels)
    if traits.is_compressed(meta.format):
        raise ValueError("generate_mipmaps: decompress first")

    n_levels = traits.calculate_mip_levels(meta.width, meta.height, levels)
    mode = int(filter_flags) & TEX_FILTER_MODE_MASK
    wrap_mirror = filter_flags & (TF.WRAP | TF.MIRROR)

    srgb = traits.is_srgb(meta.format) or bool(filter_flags & TF.SRGB_IN)

    base = tex.levels[0]
    work = apply_srgb_to_linear(base) if srgb else base
    chain = [base]
    lin = work
    for _ in range(1, n_levels):
        lin = _reduce_level(lin, mode, wrap_mirror)
        chain.append(apply_linear_to_srgb(lin) if srgb else lin)

    new_meta = dataclasses.replace(meta, mip_levels=n_levels)
    return Texture(new_meta, chain)


def _filter_axis(lin: torch.Tensor, axis: int, mode: int, wrap: bool,
                 mirror: bool) -> torch.Tensor:
    """Halve `axis` of [D, H, W, 4] with filter_weights' matrix (a
    tensordot, as the JAX package's Generate3DMips*Filter)."""
    size = lin.shape[axis]
    W = weights_on(size, max(1, size // 2), mode, wrap, mirror, lin.device)
    return torch.movedim(torch.tensordot(
        W, torch.movedim(lin, axis, 0), dims=([1], [0])), 0, axis)


def generate_mipmaps_3d(tex: Texture, filter_flags: TF = TF.DEFAULT,
                        levels: int = 0) -> Texture:
    """GenerateMipMaps3D (DirectXTexMipmaps.cpp:3254)."""
    filter_flags = TF(filter_flags)
    meta = tex.metadata
    n_levels = traits.calculate_mip_levels_3d(meta.width, meta.height,
                                              meta.depth, levels)
    mode = int(filter_flags) & TEX_FILTER_MODE_MASK
    wrap = bool(filter_flags & TF.WRAP)
    mirror = bool(filter_flags & TF.MIRROR)

    srgb = traits.is_srgb(meta.format) or bool(filter_flags & TF.SRGB_IN)
    base = tex.levels[0]  # [D, H, W, 4]
    lin = apply_srgb_to_linear(base) if srgb else base
    chain = [base]
    for _ in range(1, n_levels):
        d, h, w, c = lin.shape
        if mode == int(TF.POINT):
            _refuse_odd((d, h, w), "3D point mip reduction")
            lin = lin[:: 2 if d > 1 else 1, :: 2 if h > 1 else 1,
                      :: 2 if w > 1 else 1]
        elif mode in (int(TF.LINEAR), int(TF.CUBIC), int(TF.TRIANGLE)):
            # Generate3DMips{Linear,Cubic,Triangle}Filter
            # (DirectXTexMipmaps.cpp:1608-2827): separable per-axis filter
            # matrices (filters.h weights)
            for axis, size in ((0, d), (1, h), (2, w)):
                if max(1, size // 2) != size:
                    lin = _filter_axis(lin, axis, mode, wrap, mirror)
        else:  # box / fant default
            _refuse_odd((d, h, w), "3D box mip reduction")
            for axis, size in ((0, d), (1, h), (2, w)):
                if size > 1:
                    lin = _halve(lin, axis)
        chain.append(apply_linear_to_srgb(lin) if srgb else lin)

    new_meta = dataclasses.replace(meta, mip_levels=n_levels)
    return Texture(new_meta, chain)


def calculate_alpha_coverage(alpha: torch.Tensor, ref: float,
                             scale: torch.Tensor | float = 1.0
                             ) -> torch.Tensor:
    """Fraction of texels whose (scaled) alpha passes the reference test
    (CalculateAlphaCoverage, DirectXTexMipmaps.cpp:215), an f32 device
    scalar: the count of passing texels times the f32 reciprocal of their
    number, as XLA computes a mean."""
    a = torch.minimum(alpha * scale, torch.ones_like(alpha))
    n = (a > ref).sum().to(torch.float32)
    return n * float(np.float32(1.0) / np.float32(alpha.numel()))


def _estimate_scale(alpha: torch.Tensor, ref: float,
                    base_cov: torch.Tensor) -> torch.Tensor:
    """EstimateAlphaScaleForCoverage (:310): bisection over [0, 4] from 1,
    each step a torch.where on device scalars (no host sync)."""
    mn = torch.zeros((), dtype=torch.float32, device=alpha.device)
    mx = torch.full_like(mn, 4.0)
    scale = torch.ones_like(mn)
    for _ in range(_COVERAGE_STEPS):
        low = calculate_alpha_coverage(alpha, ref, scale) < base_cov
        mn = torch.where(low, scale, mn)
        mx = torch.where(low, mx, scale)
        scale = (mn + mx) * 0.5
    return scale


def scale_mipmaps_alpha_for_coverage(tex: Texture,
                                     alpha_reference: float) -> Texture:
    """ScaleMipMapsAlphaForCoverage (DirectXTexMipmaps.cpp:3483).

    For each mip > 0, bisection-search an alpha scale so that level's
    coverage matches the base level's (EstimateAlphaScaleForCoverage :310),
    then scale alpha (:143).
    """
    base_cov = calculate_alpha_coverage(tex.levels[0][..., 3],
                                        alpha_reference)
    new_levels = [tex.levels[0]]
    for lvl in tex.levels[1:]:
        a = lvl[..., 3]
        scale = _estimate_scale(a, alpha_reference, base_cov)
        scaled = torch.minimum(a * scale, torch.ones_like(a))
        new_levels.append(torch.cat([lvl[..., :3], scaled[..., None]],
                                    dim=-1))
    return tex.replace_levels(new_levels)
