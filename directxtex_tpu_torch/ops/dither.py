"""Dithered quantization for format conversion, on torch tensors.

The counterpart of directxtex_tpu/ops/dither.py's TEX_FILTER_DITHER: the
reference's ordered 4x4 dither (g_Dither, DirectXTexConvert.cpp:3863)
around the quantization round, renormalized so that pack() afterwards
stores the values losslessly. TEX_FILTER_DITHER_DIFFUSION (Floyd-Steinberg,
the reference's StoreScanlineDither, :4049) is a serpentine scan whose
rows each wait for the one before: it runs on the host, in the port's own
copy of the JAX package's native/dither.cpp (directxtex_tpu_torch/native,
built with g++ at first use). The level goes to the host in one copy and
comes back to its device in one; `_fs_dither_py` is the same pass in
numpy, the plain twin the tests hold the library against.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..formats.dxgi import DXGIFormat, FMT
from ..numerics import clip
from ..utils.device import constant
from .flags import TEX_FILTER_FLAGS as TF

__all__ = ["dither_scales", "ordered_dither", "diffusion_dither",
           "apply_dither"]

# the reference's ordered-dither pattern (g_Dither, DirectXTexConvert.cpp:
# 3863, z=0 plane): B[y & 3][x & 3], values in (-0.5, 0.5)
_ORDERED = np.array([
    [0.468750, -0.031250, 0.343750, -0.156250],
    [-0.281250, 0.218750, -0.406250, 0.093750],
    [0.281250, -0.218750, 0.406250, -0.093750],
    [-0.468750, 0.031250, -0.343750, 0.156250],
], np.float32)

# per-channel quantization scales (g_Scale*pc tables, :3872-3881);
# (scales, clampzero). Only the formats StoreScanlineDither actually
# dithers; anything else falls through to the plain store.
_SCALES: dict[DXGIFormat, tuple[tuple, bool]] = {
    FMT.R16G16B16A16_UNORM: ((65535, 65535, 65535, 65535), True),
    FMT.R16G16B16A16_SNORM: ((32767, 32767, 32767, 32767), False),
    FMT.R10G10B10A2_UNORM: ((1023, 1023, 1023, 3), True),
    FMT.R10G10B10_XR_BIAS_A2_UNORM: ((510, 510, 510, 3), True),
    FMT.R8G8B8A8_UNORM: ((255, 255, 255, 255), True),
    FMT.R8G8B8A8_UNORM_SRGB: ((255, 255, 255, 255), True),
    FMT.B8G8R8A8_UNORM: ((255, 255, 255, 255), True),
    FMT.B8G8R8A8_UNORM_SRGB: ((255, 255, 255, 255), True),
    FMT.B8G8R8X8_UNORM: ((255, 255, 255, 255), True),
    FMT.B8G8R8X8_UNORM_SRGB: ((255, 255, 255, 255), True),
    FMT.R8G8B8A8_SNORM: ((127, 127, 127, 127), False),
    FMT.R16G16_UNORM: ((65535, 65535, 1, 1), True),
    FMT.R16G16_SNORM: ((32767, 32767, 1, 1), False),
    FMT.R8G8_UNORM: ((255, 255, 1, 1), True),
    FMT.R8G8_SNORM: ((127, 127, 1, 1), False),
    FMT.R16_UNORM: ((65535, 1, 1, 1), True),
    FMT.R16_SNORM: ((32767, 1, 1, 1), False),
    FMT.R8_UNORM: ((255, 1, 1, 1), True),
    FMT.R8_SNORM: ((127, 1, 1, 1), False),
    FMT.A8_UNORM: ((1, 1, 1, 255), True),
    FMT.B5G6R5_UNORM: ((31, 63, 31, 1), True),
    FMT.B5G5R5A1_UNORM: ((31, 31, 31, 1), True),
    FMT.B4G4R4A4_UNORM: ((15, 15, 15, 15), True),
    FMT.A4B4G4R4_UNORM: ((15, 15, 15, 15), True),
}


def dither_scales(fmt: DXGIFormat):
    """(per-channel scales [4], clampzero) or None if `fmt` is not a
    ditherable format (StoreScanlineDither's format switch)."""
    return _SCALES.get(fmt)


def ordered_dither(vals: torch.Tensor, fmt: DXGIFormat) -> torch.Tensor:
    """Ordered 4x4 dither + quantize + renormalize. vals [..., H, W, 4];
    returns the same shape on the same device."""
    entry = dither_scales(fmt)
    if entry is None:
        return vals
    scales, clampzero = entry
    dev = vals.device
    sc = constant(("dither_scales", fmt),
                  lambda: np.array(scales, np.float32), dev)
    h, w = vals.shape[-3], vals.shape[-2]
    # B[y & 3][x & 3], gathered on the device
    rows = torch.arange(h, device=dev)[:, None] & 3
    cols = torch.arange(w, device=dev)[None, :] & 3
    pat = constant("ordered_dither", lambda: _ORDERED.reshape(-1),
                   dev)[rows * 4 + cols][..., None]
    v = clip(vals, 0.0 if clampzero else -1.0, 1.0)
    t = torch.round(v * sc + pat)
    lo = torch.zeros_like(sc) if clampzero else -(sc - 1.0)
    return torch.div(clip(t, lo, sc), sc)


def _fs_dither_py(img: np.ndarray, scales: np.ndarray,
                  clampzero: bool) -> np.ndarray:
    """Floyd-Steinberg in numpy, step for step as native/dither.cpp (its
    clamps keep a zero's sign, as the C comparisons do): the plain twin of
    the host library (small images only)."""
    h, w, _ = img.shape
    out = img.astype(np.float32).copy()
    err_prev = np.zeros((w + 2, 4), np.float32)
    lo_v = np.float32(0.0 if clampzero else -1.0)
    lo_t = np.zeros(4, np.float32) if clampzero else -scales + 1.0
    for y in range(h):
        err_next = np.zeros((w + 2, 4), np.float32)
        rtl = bool(y & 1)
        verr = np.zeros(4, np.float32)
        xs = range(w - 1, -1, -1) if rtl else range(w)
        for x in xs:
            v = out[y, x] + err_prev[x + 1]
            v = np.where(v < lo_v, lo_v, np.where(v > 1.0, np.float32(1.0),
                                                  v)) + verr
            vs = v * scales
            # round-half-even, matching XMVectorRound / C nearbyintf
            target = np.round(vs.astype(np.float64)).astype(np.float32)
            e = (vs - target) / scales
            dl, dr = (x + 2, x) if rtl else (x, x + 2)
            err_next[dl] += e * (3.0 / 16.0)
            err_next[x + 1] += e * (5.0 / 16.0)
            err_next[dr] += e * (1.0 / 16.0)
            verr = e * (7.0 / 16.0)
            t = np.where(target < lo_t, lo_t, target)
            out[y, x] = np.where(t > scales, scales, t) / scales
        err_prev = err_next
    return out


def diffusion_dither(vals: torch.Tensor, fmt: DXGIFormat) -> torch.Tensor:
    """Floyd-Steinberg error-diffusion dither + quantize + renormalize.
    vals [N, H, W, 4] or [H, W, 4]: copied to the host, dithered there by
    the native library (each image on its own), copied back to vals'
    device."""
    entry = dither_scales(fmt)
    if entry is None:
        return vals
    scales, clampzero = entry
    sc = np.asarray(scales, np.float32)
    # one D2H copy into memory of our own, dithered there in place, one
    # H2D copy back
    host = torch.empty(vals.shape, dtype=torch.float32)
    host.copy_(vals.detach())
    for img in host.numpy().reshape((-1,) + tuple(vals.shape[-3:])):
        native.fs_dither(img, sc, clampzero)
    return host.to(vals.device)


def apply_dither(vals: torch.Tensor, fmt: DXGIFormat,
                 filter_flags: int) -> torch.Tensor:
    """Dispatch on TEX_FILTER_DITHER / TEX_FILTER_DITHER_DIFFUSION
    (DirectXTexConvert.cpp:4817 scanline loop)."""
    mode = int(filter_flags) & int(TF.DITHER | TF.DITHER_DIFFUSION)
    if not mode or dither_scales(fmt) is None:
        return vals
    if mode & int(TF.DITHER_DIFFUSION):
        return diffusion_dither(vals, fmt)
    return ordered_dither(vals, fmt)
