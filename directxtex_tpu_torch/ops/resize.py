"""Image resize (DirectXTexResize.cpp + filters.h) on torch tensors.

The counterpart of directxtex_tpu/ops/resize.py. The reference walks
destination scanlines gathering weighted source taps (point :255, box :312,
linear :375, cubic :466, triangle/Fant :627, with filters.h building
per-row tap tables). Here, as in the JAX package, the complete separable
filter is two weight matrices built on the host (`filter_weights`, numpy,
the JAX package's code verbatim) - out = W_y @ img @ W_x^T - so every
filter, the variable-footprint Fant filter included, is two plain
products over the whole image batch. Wrap/mirror boundary semantics fold
into the weight matrices (filters.h:64-207 bounduvw). A weight matrix is
copied to a device once per (in, out, mode, wrap, mirror). The products
run in f32 (no TF32: torch's defaults, which chip_smoke.py asserts).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..formats import traits
from ..texture import Texture
from ..utils.device import constant
from .colorspace import apply_linear_to_srgb, apply_srgb_to_linear
from .flags import TEX_FILTER_FLAGS as TF
from .flags import TEX_FILTER_MODE_MASK

__all__ = ["resize", "resize_array", "filter_weights"]


def _bound(idx: np.ndarray, size: int, wrap: bool, mirror: bool) -> np.ndarray:
    """Boundary handling for tap indices (filters.h bounduvw)."""
    if wrap:
        return np.mod(idx, size)
    if mirror:
        period = 2 * size
        m = np.mod(idx, period)
        return np.where(m < size, m, period - 1 - m)
    return np.clip(idx, 0, size - 1)


@functools.lru_cache(maxsize=256)
def filter_weights(in_size: int, out_size: int, mode: int,
                   wrap: bool, mirror: bool) -> np.ndarray:
    """Dense [out_size, in_size] filter matrix for one axis.

    mode is a TEX_FILTER mode value (POINT/LINEAR/CUBIC/BOX/TRIANGLE); 0
    defaults to Fant (area-weighted), matching the reference's default.
    """
    W = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size

    if mode == int(TF.POINT):
        src = np.minimum((np.arange(out_size) * scale).astype(np.int64),
                         in_size - 1)
        W[np.arange(out_size), src] = 1.0

    elif mode == int(TF.LINEAR):
        # CreateLinearFilter (filters.h:64): u = (x+0.5)*scale - 0.5
        u = (np.arange(out_size) + 0.5) * scale - 0.5
        i0 = np.floor(u).astype(np.int64)
        frac = u - i0
        for tap, w in ((i0, 1.0 - frac), (i0 + 1, frac)):
            t = _bound(tap, in_size, wrap, mirror)
            np.add.at(W, (np.arange(out_size), t), w)

    elif mode == int(TF.CUBIC):
        # CreateCubicFilter (filters.h:123) with Catmull-Rom coefficients
        u = (np.arange(out_size) + 0.5) * scale - 0.5
        i0 = np.floor(u).astype(np.int64)
        t = u - i0
        t2, t3 = t * t, t * t * t
        w0 = (-t3 + 2.0 * t2 - t) * 0.5
        w1 = (3.0 * t3 - 5.0 * t2 + 2.0) * 0.5
        w2 = (-3.0 * t3 + 4.0 * t2 + t) * 0.5
        w3 = (t3 - t2) * 0.5
        for tap, w in ((i0 - 1, w0), (i0, w1), (i0 + 1, w2), (i0 + 2, w3)):
            ti = _bound(tap, in_size, wrap, mirror)
            np.add.at(W, (np.arange(out_size), ti), w)

    elif mode == int(TF.BOX) and in_size == out_size * 2:
        # exact pow2 halving (PerformResizeUsing... box path)
        for x in range(out_size):
            W[x, 2 * x] = 0.5
            W[x, 2 * x + 1] = 0.5

    else:
        # triangle / Fant: exact area overlap (CreateTriangleFilter,
        # filters.h:214-419); also serves BOX at non-pow2 ratios and DEFAULT
        for x in range(out_size):
            lo = x * scale
            hi = (x + 1) * scale
            i0 = int(np.floor(lo))
            i1 = int(np.ceil(hi))
            for i in range(i0, i1):
                ov = min(hi, i + 1) - max(lo, i)
                if ov > 0:
                    ti = int(_bound(np.asarray(i), in_size, wrap, mirror))
                    W[x, ti] += ov / scale

    # normalize rows (guards accumulated fp error; reference normalizes
    # triangle weights the same way, filters.h:340)
    rs = W.sum(axis=1, keepdims=True)
    W = np.divide(W, rs, out=W, where=rs != 0)
    return W.astype(np.float32)


def weights_on(in_size: int, out_size: int, mode: int, wrap: bool,
               mirror: bool, device) -> torch.Tensor:
    """filter_weights(...) as an f32 tensor on `device`, copied there once
    per (in, out, mode, wrap, mirror)."""
    key = ("filter_weights", in_size, out_size, mode, wrap, mirror)
    return constant(key, lambda: filter_weights(in_size, out_size, mode,
                                                wrap, mirror), device)


def resize_array(img: torch.Tensor, width: int, height: int,
                 filter_flags: TF = TF.DEFAULT) -> torch.Tensor:
    """Resize [N, H, W, C] (or [H, W, C]) to [..., height, width, C]."""
    filter_flags = TF(filter_flags)
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
    n, h, w, c = img.shape
    mode = int(filter_flags) & TEX_FILTER_MODE_MASK
    # BOX==FANT (same flag value): at exact 2x the box matrix applies, at any
    # other ratio this falls through to the Fant area filter - matching the
    # reference, where BOX/FANT resize goes through WIC's Fant resampler at
    # arbitrary ratios (DirectXTexResize.cpp:24) and the pow2-only custom box
    # path is just its special case (:312).
    wy = weights_on(h, height, mode, bool(filter_flags & TF.WRAP_V),
                    bool(filter_flags & TF.MIRROR_V), img.device)
    wx = weights_on(w, width, mode, bool(filter_flags & TF.WRAP_U),
                    bool(filter_flags & TF.MIRROR_U), img.device)

    # two products: [n,H,W,c] -> [n,height,W,c] -> [n,height,width,c]
    tmp = torch.einsum("oh,nhwc->nowc", wy, img)
    out = torch.einsum("pw,nowc->nopc", wx, tmp)
    return out[0] if squeeze else out


def resize(tex: Texture, width: int, height: int,
           filter_flags: TF = TF.DEFAULT) -> Texture:
    """Public Resize (DirectXTexResize.cpp:854). Result has mipLevels == 1."""
    filter_flags = TF(filter_flags)
    meta = tex.metadata
    if traits.is_compressed(meta.format):
        raise ValueError("resize: decompress first")
    if width == 0 or height == 0:
        raise ValueError("resize: invalid target size")

    srgb = traits.is_srgb(meta.format) or bool(filter_flags & TF.SRGB_IN)
    base = tex.levels[0]
    work = apply_srgb_to_linear(base) if srgb else base

    if filter_flags & TF.SEPARATE_ALPHA:
        # resize color and alpha independently (ResizeSeparateColorAndAlpha,
        # DirectXTexMipmaps.cpp:408): prevents color bleed through alpha
        opaque = torch.cat([work[..., :3], torch.ones_like(work[..., 3:4])],
                           dim=-1)
        color = resize_array(opaque, width, height, filter_flags)
        alpha = resize_array(work[..., 3:4], width, height, filter_flags)
        out = torch.cat([color[..., :3], alpha], dim=-1)
    else:
        out = resize_array(work, width, height, filter_flags)
    if srgb:
        out = apply_linear_to_srgb(out)

    new_meta = dataclasses.replace(meta, width=width, height=height,
                                   mip_levels=1)
    return Texture(new_meta, [out])
