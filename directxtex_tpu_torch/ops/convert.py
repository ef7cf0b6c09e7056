"""Format conversion (the `Convert` op) on torch tensors.

The counterpart of directxtex_tpu/ops/convert.py: the reference's
ConvertScanline flag algebra (DirectXTexConvert.cpp:3080-3858) and its
86-entry g_ConvertTable (:2960, the JAX package's table verbatim) over a
whole [..., 4] plane, then a requantize through the target format's
pack / unpack (the reference's StoreScanline + LoadScanline round trip).
Each elementwise step rounds on its own, as eager jnp does; divisions by
a constant take numerics.fdiv (IEEE on the CPU and on CUDA).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..formats.dxgi import FMT, DXGIFormat
from ..formats import traits
from ..formats.packing import (is_packable, pack, planar_to_single, unpack,
                               unpack_planar_image)
from ..numerics import clip, fdiv
from ..texture import TexMetadata, Texture
from ..utils.errors import TexAbortError
from .colorspace import GRAYSCALE, apply_linear_to_srgb, apply_srgb_to_linear
from .dither import apply_dither
from .flags import TEX_FILTER_FLAGS as TF

__all__ = ["CONVF", "get_convert_flags", "convert_values", "convert",
           "convert_ex", "convert_to_single_plane"]


class CONVF(enum.IntFlag):
    """Conversion trait flags (DirectXTexP.h:355-376)."""
    FLOAT = 0x1
    UNORM = 0x2
    UINT = 0x4
    SNORM = 0x8
    SINT = 0x10
    DEPTH = 0x20
    STENCIL = 0x40
    SHAREDEXP = 0x80
    BGR = 0x100
    XR = 0x200
    PACKED = 0x400
    BC = 0x800
    YUV = 0x1000
    POS_ONLY = 0x2000
    R = 0x10000
    G = 0x20000
    B = 0x40000
    A = 0x80000
    RGB_MASK = 0x70000
    RGBA_MASK = 0xF0000


_F, _U, _UI, _S, _SI = CONVF.FLOAT, CONVF.UNORM, CONVF.UINT, CONVF.SNORM, CONVF.SINT
_R, _G, _B, _A = CONVF.R, CONVF.G, CONVF.B, CONVF.A
_RGB = _R | _G | _B
_RGBA = _RGB | _A

# g_ConvertTable (DirectXTexConvert.cpp:2960-3046): format -> CONVF flags
_CONVERT_TABLE: dict[DXGIFormat, CONVF] = {
    FMT.R32G32B32A32_FLOAT: _F | _RGBA,
    FMT.R32G32B32A32_UINT: _UI | _RGBA,
    FMT.R32G32B32A32_SINT: _SI | _RGBA,
    FMT.R32G32B32_FLOAT: _F | _RGB,
    FMT.R32G32B32_UINT: _UI | _RGB,
    FMT.R32G32B32_SINT: _SI | _RGB,
    FMT.R16G16B16A16_FLOAT: _F | _RGBA,
    FMT.R16G16B16A16_UNORM: _U | _RGBA,
    FMT.R16G16B16A16_UINT: _UI | _RGBA,
    FMT.R16G16B16A16_SNORM: _S | _RGBA,
    FMT.R16G16B16A16_SINT: _SI | _RGBA,
    FMT.R32G32_FLOAT: _F | _R | _G,
    FMT.R32G32_UINT: _UI | _R | _G,
    FMT.R32G32_SINT: _SI | _R | _G,
    FMT.D32_FLOAT_S8X24_UINT: _F | CONVF.DEPTH | CONVF.STENCIL,
    FMT.R10G10B10A2_UNORM: _U | _RGBA,
    FMT.R10G10B10A2_UINT: _UI | _RGBA,
    FMT.R11G11B10_FLOAT: _F | CONVF.POS_ONLY | _RGB,
    FMT.R8G8B8A8_UNORM: _U | _RGBA,
    FMT.R8G8B8A8_UNORM_SRGB: _U | _RGBA,
    FMT.R8G8B8A8_UINT: _UI | _RGBA,
    FMT.R8G8B8A8_SNORM: _S | _RGBA,
    FMT.R8G8B8A8_SINT: _SI | _RGBA,
    FMT.R16G16_FLOAT: _F | _R | _G,
    FMT.R16G16_UNORM: _U | _R | _G,
    FMT.R16G16_UINT: _UI | _R | _G,
    FMT.R16G16_SNORM: _S | _R | _G,
    FMT.R16G16_SINT: _SI | _R | _G,
    FMT.D32_FLOAT: _F | CONVF.DEPTH,
    FMT.R32_FLOAT: _F | _R,
    FMT.R32_UINT: _UI | _R,
    FMT.R32_SINT: _SI | _R,
    FMT.D24_UNORM_S8_UINT: _U | CONVF.DEPTH | CONVF.STENCIL,
    FMT.R8G8_UNORM: _U | _R | _G,
    FMT.R8G8_UINT: _UI | _R | _G,
    FMT.R8G8_SNORM: _S | _R | _G,
    FMT.R8G8_SINT: _SI | _R | _G,
    FMT.R16_FLOAT: _F | _R,
    FMT.D16_UNORM: _U | CONVF.DEPTH,
    FMT.R16_UNORM: _U | _R,
    FMT.R16_UINT: _UI | _R,
    FMT.R16_SNORM: _S | _R,
    FMT.R16_SINT: _SI | _R,
    FMT.R8_UNORM: _U | _R,
    FMT.R8_UINT: _UI | _R,
    FMT.R8_SNORM: _S | _R,
    FMT.R8_SINT: _SI | _R,
    FMT.A8_UNORM: _U | _A,
    FMT.R1_UNORM: _U | _R,
    FMT.R9G9B9E5_SHAREDEXP: _F | CONVF.SHAREDEXP | CONVF.POS_ONLY | _RGB,
    FMT.R8G8_B8G8_UNORM: _U | CONVF.PACKED | _RGB,
    FMT.G8R8_G8B8_UNORM: _U | CONVF.PACKED | _RGB,
    FMT.BC1_UNORM: _U | CONVF.BC | _RGBA,
    FMT.BC1_UNORM_SRGB: _U | CONVF.BC | _RGBA,
    FMT.BC2_UNORM: _U | CONVF.BC | _RGBA,
    FMT.BC2_UNORM_SRGB: _U | CONVF.BC | _RGBA,
    FMT.BC3_UNORM: _U | CONVF.BC | _RGBA,
    FMT.BC3_UNORM_SRGB: _U | CONVF.BC | _RGBA,
    FMT.BC4_UNORM: _U | CONVF.BC | _R,
    FMT.BC4_SNORM: _S | CONVF.BC | _R,
    FMT.BC5_UNORM: _U | CONVF.BC | _R | _G,
    FMT.BC5_SNORM: _S | CONVF.BC | _R | _G,
    FMT.B5G6R5_UNORM: _U | _RGB,
    FMT.B5G5R5A1_UNORM: _U | _RGBA,
    FMT.B8G8R8A8_UNORM: _U | CONVF.BGR | _RGBA,
    FMT.B8G8R8X8_UNORM: _U | CONVF.BGR | _RGB,
    FMT.R10G10B10_XR_BIAS_A2_UNORM: _U | CONVF.XR | _RGBA,
    FMT.B8G8R8A8_UNORM_SRGB: _U | CONVF.BGR | _RGBA,
    FMT.B8G8R8X8_UNORM_SRGB: _U | CONVF.BGR | _RGB,
    FMT.BC6H_UF16: _F | CONVF.BC | _RGBA,
    FMT.BC6H_SF16: _F | CONVF.BC | _RGBA,
    FMT.BC7_UNORM: _U | CONVF.BC | _RGBA,
    FMT.BC7_UNORM_SRGB: _U | CONVF.BC | _RGBA,
    FMT.AYUV: _U | CONVF.YUV | _RGBA,
    FMT.Y410: _U | CONVF.YUV | _RGBA,
    FMT.Y416: _U | CONVF.YUV | _RGBA,
    FMT.YUY2: _U | CONVF.YUV | CONVF.PACKED | _RGB,
    FMT.Y210: _U | CONVF.YUV | CONVF.PACKED | _RGB,
    FMT.Y216: _U | CONVF.YUV | CONVF.PACKED | _RGB,
    FMT.B4G4R4A4_UNORM: _U | CONVF.BGR | _RGBA,
    FMT.XBOX_R10G10B10_7E3_A2_FLOAT: _F | CONVF.POS_ONLY | _RGBA,
    FMT.XBOX_R10G10B10_6E4_A2_FLOAT: _F | CONVF.POS_ONLY | _RGBA,
    FMT.XBOX_R10G10B10_SNORM_A2_UNORM: _S | _RGBA,
    FMT.XBOX_R4G4_UNORM: _U | _R | _G,
    FMT.A4B4G4R4_UNORM: _U | CONVF.BGR | _RGBA,
}


def get_convert_flags(fmt: DXGIFormat) -> CONVF:
    """GetConvertFlags (DirectXTexConvert.cpp:3063); 0 for unknown."""
    return _CONVERT_TABLE.get(fmt, CONVF(0))


# channel helpers over [..., 4] tensors

def _splat(rgba, ch):
    return rgba[..., ch:ch + 1].expand(rgba.shape).contiguous()


def _select(base, new, mask):
    """XMVectorSelect: per-channel select; mask True picks `new`."""
    cols = [new[..., i] if mask[i] else base[..., i] for i in range(4)]
    return torch.stack(cols, dim=-1)


def _set(v, ch, x):
    """v with channel `ch` replaced by x (jnp's .at[..., ch].set)."""
    cols = [x if i == ch else v[..., i] for i in range(4)]
    return torch.stack(cols, dim=-1)


def _luma(rgba):
    return (rgba[..., 0] * GRAYSCALE[0] + rgba[..., 1] * GRAYSCALE[1]
            + rgba[..., 2] * GRAYSCALE[2])


def _grayscale3(rgba):
    return _luma(rgba)[..., None].expand(rgba.shape).contiguous()


def convert_values(rgba: torch.Tensor, in_fmt: DXGIFormat,
                   out_fmt: DXGIFormat,
                   flags: TF = TF.DEFAULT) -> torch.Tensor:
    """ConvertScanline equivalent over a whole [..., 4] f32 tensor.

    Applies sRGB in/out handling, depth/stencil channel routing, UNORM/SNORM/
    FLOAT range remaps, and R<->RGB channel fills per the reference's
    flag-difference rules (DirectXTexConvert.cpp:3080-3858).
    """
    fin = get_convert_flags(in_fmt)
    fout = get_convert_flags(out_fmt)
    if fin == 0 or fout == 0:
        raise ValueError(f"convert: unsupported formats {in_fmt!r} -> {out_fmt!r}")
    flags = TF(flags)

    # sRGB filtering mode fixups (DirectXTexConvert.cpp:3122-3167)
    if traits.is_srgb(in_fmt):
        flags |= TF.SRGB_IN
    elif in_fmt in (FMT.A8_UNORM, FMT.R10G10B10_XR_BIAS_A2_UNORM):
        flags &= ~TF.SRGB_IN
    if traits.is_srgb(out_fmt):
        flags |= TF.SRGB_OUT
    elif out_fmt in (FMT.A8_UNORM, FMT.R10G10B10_XR_BIAS_A2_UNORM):
        flags &= ~TF.SRGB_OUT
    if (flags & TF.SRGB) == TF.SRGB:
        flags &= ~TF.SRGB

    v = rgba
    if (flags & TF.SRGB_IN) and not (fin & CONVF.DEPTH) and \
            (fin & (CONVF.FLOAT | CONVF.UNORM)):
        v = apply_srgb_to_linear(v)

    diff = fin ^ fout
    if diff:
        v = _apply_diff_rules(v, fin, fout, diff, flags)

    if (flags & TF.SRGB_OUT) and not (fout & CONVF.DEPTH) and \
            (fout & (CONVF.FLOAT | CONVF.UNORM)):
        v = apply_linear_to_srgb(v)
    return v


def _apply_diff_rules(v, fin, fout, diff, flags):
    copy_mask = flags & (TF.RGB_COPY_RED | TF.RGB_COPY_GREEN |
                         TF.RGB_COPY_BLUE | TF.RGB_COPY_ALPHA)

    if diff & CONVF.DEPTH:
        if fin & CONVF.DEPTH:
            # depth -> color
            if fin & CONVF.STENCIL:
                # stencil (green, 0..255 uint) -> alpha
                s = fdiv(clip(v[..., 1], 0.0, 255.0), 255.0)
                if fout & CONVF.UNORM:
                    v = _set(v, 3, s)
                elif fout & CONVF.SNORM:
                    v = _set(v, 3, s * 2.0 - 1.0)
                else:
                    v = _set(v, 3, v[..., 1])
            # depth (red) -> RGB
            if (fout & CONVF.UNORM) and (fin & CONVF.FLOAT):
                d = clip(v[..., 0], 0.0, 1.0)
            elif fout & CONVF.SNORM:
                if fin & CONVF.UNORM:
                    d = v[..., 0] * 2.0 - 1.0
                else:
                    d = clip(v[..., 0], -1.0, 1.0)
            else:
                d = v[..., 0]
            v = torch.stack([d, d, d, v[..., 3]], dim=-1)
        else:
            # color -> depth: pick source channel for red
            if copy_mask == TF.RGB_COPY_GREEN:
                d = v[..., 1]
            elif copy_mask == TF.RGB_COPY_BLUE:
                d = v[..., 2]
            elif copy_mask == TF.RGB_COPY_ALPHA:
                d = v[..., 3]
            elif (fin & CONVF.UNORM) and (fin & CONVF.RGB_MASK) == CONVF.RGB_MASK:
                d = _luma(v)
            else:
                d = v[..., 0]
            if fout & CONVF.UNORM:
                if fin & CONVF.SNORM:
                    d = d * 0.5 + 0.5
                elif fin & CONVF.FLOAT:
                    d = clip(d, 0.0, 1.0)
            v = _set(v, 0, d)
            if fout & CONVF.STENCIL:
                # alpha -> stencil (green channel, 0..255)
                a = v[..., 3]
                if fin & CONVF.UNORM:
                    s = a * 255.0
                elif fin & CONVF.SNORM:
                    s = (a * 0.5 + 0.5) * 255.0
                else:
                    s = a
                v = _set(v, 1, s)
    elif fout & CONVF.DEPTH:
        # depth -> depth with float/unorm change
        if (diff & CONVF.FLOAT) and (fin & CONVF.FLOAT):
            v = _set(v, 0, clip(v[..., 0], 0.0, 1.0))
    elif fout & CONVF.UNORM:
        if fin & CONVF.SNORM:
            v = v * 0.5 + 0.5
        elif fin & CONVF.FLOAT:
            if not (fin & CONVF.POS_ONLY) and (flags & TF.FLOAT_X2BIAS):
                v = clip(v, -1.0, 1.0) * 0.5 + 0.5
            else:
                v = clip(v, 0.0, 1.0)
    elif fout & CONVF.SNORM:
        if fin & CONVF.UNORM:
            v = v * 2.0 - 1.0
        elif fin & CONVF.FLOAT:
            if (fin & CONVF.POS_ONLY) and (flags & TF.FLOAT_X2BIAS):
                v = clip(v, 0.0, 1.0) * 2.0 - 1.0
            else:
                v = clip(v, -1.0, 1.0)
    elif diff & CONVF.UNORM:
        # from UNORM to FLOAT
        if (fout & CONVF.FLOAT) and not (fout & CONVF.POS_ONLY) and \
                (flags & TF.FLOAT_X2BIAS):
            v = v * 2.0 - 1.0
    elif diff & CONVF.POS_ONLY:
        if flags & TF.FLOAT_X2BIAS:
            if (fin & CONVF.POS_ONLY) and (fout & CONVF.FLOAT):
                v = clip(v, 0.0, 1.0) * 2.0 - 1.0
            elif fout & CONVF.POS_ONLY:
                if fin & CONVF.FLOAT:
                    v = clip(v, -1.0, 1.0) * 0.5 + 0.5
                elif fin & CONVF.SNORM:
                    v = v * 0.5 + 0.5

    # channel count fixups (DirectXTexConvert.cpp:3595-3791)
    out_rgba = fout & CONVF.RGBA_MASK
    in_rgba = fin & CONVF.RGBA_MASK
    if out_rgba == CONVF.A and not (fin & CONVF.A):
        # color -> A8: grayscale or selected channel broadcast to all lanes
        if copy_mask & TF.RGB_COPY_GREEN:
            v = _splat(v, 1)
        elif copy_mask & TF.RGB_COPY_BLUE:
            v = _splat(v, 2)
        elif (fin & CONVF.UNORM) and (fin & CONVF.RGB_MASK) == CONVF.RGB_MASK \
                and not (copy_mask & TF.RGB_COPY_RED):
            v = _grayscale3(v)
        else:
            v = _splat(v, 0)
    elif in_rgba == CONVF.A and not (fout & CONVF.A):
        v = _splat(v, 3)
    elif (fin & CONVF.RGB_MASK) == CONVF.R:
        if (fout & CONVF.RGB_MASK) == CONVF.RGB_MASK:
            v = _select(v, _splat(v, 0), (True, True, True, False))
        elif (fout & CONVF.RGB_MASK) == (CONVF.R | CONVF.G):
            v = _select(v, _splat(v, 0), (True, True, False, False))
    elif (fin & CONVF.RGB_MASK) == CONVF.RGB_MASK:
        if (fout & CONVF.RGB_MASK) == CONVF.R:
            if copy_mask == TF.RGB_COPY_GREEN:
                v = _select(v, _splat(v, 1), (True, True, True, False))
            elif copy_mask == TF.RGB_COPY_BLUE:
                v = _select(v, _splat(v, 2), (True, True, True, False))
            elif copy_mask == TF.RGB_COPY_ALPHA:
                v = _select(v, _splat(v, 3), (True, True, True, False))
            elif (fin & CONVF.UNORM) and copy_mask != TF.RGB_COPY_RED:
                v = _select(v, _grayscale3(v), (True, True, True, False))
            # RGB_COPY_RED: leave as-is; the store keeps red
        elif (fout & CONVF.RGB_MASK) == (CONVF.R | CONVF.G):
            if (flags & TF.RGB_COPY_ALPHA) and (fin & CONVF.A):
                if copy_mask == (TF.RGB_COPY_GREEN | TF.RGB_COPY_ALPHA):
                    first = (1, 3)
                elif copy_mask == (TF.RGB_COPY_BLUE | TF.RGB_COPY_ALPHA):
                    first = (2, 3)
                else:  # RED | ALPHA and default
                    first = (0, 3)
                v = torch.stack([v[..., first[0]], v[..., first[1]],
                                 v[..., 2], v[..., 3]], dim=-1)
            else:
                rc = copy_mask & (TF.RGB_COPY_RED | TF.RGB_COPY_GREEN | TF.RGB_COPY_BLUE)
                if rc == (TF.RGB_COPY_RED | TF.RGB_COPY_BLUE):
                    v = torch.stack([v[..., 0], v[..., 2], v[..., 2],
                                     v[..., 3]], dim=-1)
                elif rc == (TF.RGB_COPY_GREEN | TF.RGB_COPY_BLUE):
                    v = torch.stack([v[..., 1], v[..., 2], v[..., 2],
                                     v[..., 3]], dim=-1)
                # RED|GREEN / default: unchanged
    return v


def _check_target(in_fmt: DXGIFormat, out_fmt: DXGIFormat) -> None:
    if traits.is_compressed(in_fmt) or traits.is_compressed(out_fmt):
        raise ValueError("convert: use compress/decompress for BC formats")
    if traits.is_planar(out_fmt) or traits.is_palettized(out_fmt) or \
            traits.is_typeless(out_fmt):
        raise ValueError(f"convert: invalid target {out_fmt!r}")
    if not is_packable(out_fmt):
        raise ValueError(f"convert: cannot store format {out_fmt!r}")


def convert(tex: Texture, out_fmt: DXGIFormat,
            filter_flags: TF = TF.DEFAULT,
            threshold: float = 0.5) -> Texture:
    """Convert a texture to a new format (public Convert,
    DirectXTexConvert.cpp:5091), on the texture's device.

    Values are transformed per ConvertScanline rules and quantized through
    the target wire format (pack+unpack), so the in-memory f32 planes carry
    exactly what a save/load through `out_fmt` would produce.
    """
    in_fmt = tex.metadata.format
    _check_target(in_fmt, out_fmt)
    if in_fmt == out_fmt:
        return tex
    new_levels = [_convert_level(lvl, in_fmt, out_fmt, filter_flags,
                                 threshold) for lvl in tex.levels]
    return tex.replace_levels(new_levels, tex.metadata.with_format(out_fmt))


def _convert_level(lvl, in_fmt, out_fmt, filter_flags, threshold):
    """One mip level of convert(): value transform + dither + requantize
    through the target wire format."""
    vals = convert_values(lvl, in_fmt, out_fmt, filter_flags)
    # TEX_FILTER_DITHER quantizes here; pack() then stores the
    # pre-quantized values losslessly
    vals = apply_dither(vals, out_fmt, filter_flags)
    n, h, w, _ = vals.shape
    flat = vals.reshape(-1, 4)
    requant = unpack(out_fmt, pack(out_fmt, flat, threshold), flat.shape[0])
    return requant.reshape(n, h, w, 4)


def convert_to_single_plane(tex_or_bytes, metadata: TexMetadata = None,
                            device=None) -> Texture:
    """ConvertToSinglePlane (DirectXTexConvert.cpp:5411).

    Accepts planar wire bytes + TexMetadata (as produced by the DDS loader
    for planar formats) and returns an RGBA Texture on `device` (CUDA
    unless named) labelled with the packed single-plane equivalent
    (NV12/NV11 -> YUY2, P010 -> Y210, P016 -> Y216).
    """
    if isinstance(tex_or_bytes, Texture):
        # already depacked by the loader; just relabel
        target = planar_to_single(tex_or_bytes.metadata.format)
        if target == FMT.UNKNOWN:
            raise ValueError("convert_to_single_plane: not a planar format")
        return tex_or_bytes.replace_levels(
            tex_or_bytes.levels, tex_or_bytes.metadata.with_format(target))

    meta = metadata
    target = planar_to_single(meta.format)
    if target == FMT.UNKNOWN:
        raise ValueError(f"convert_to_single_plane: unsupported {meta.format!r}")
    data = np.frombuffer(bytes(tex_or_bytes), np.uint8).copy()
    arr = unpack_planar_image(meta.format, data, meta.width, meta.height,
                              device)
    return Texture(meta.with_format(target), [arr[None]])


def convert_ex(tex: Texture, out_fmt: DXGIFormat,
               filter_flags: TF = TF.DEFAULT, threshold: float = 0.5,
               status_callback=None) -> Texture:
    """ConvertEx (DirectXTexConvert.cpp:5106, ConvertOptions +
    statusCallBack): per-mip progress reporting with cooperative abort
    (E_ABORT -> TexAbortError)."""
    if status_callback is None:
        return convert(tex, out_fmt, filter_flags, threshold)

    # validate exactly like convert() before reporting any progress
    in_fmt = tex.metadata.format
    _check_target(in_fmt, out_fmt)

    total = len(tex.levels)
    if status_callback(0, total) is False:
        raise TexAbortError("convert aborted by status callback")
    if in_fmt == out_fmt:
        for i in range(total):
            if status_callback(i + 1, total) is False:
                raise TexAbortError("convert aborted by status callback")
        return tex

    # level by level, so a False return skips the remaining levels' work
    # (the reference's statusCallBack contract, DirectXTex.h:828)
    new_levels = []
    for i, lvl in enumerate(tex.levels):
        new_levels.append(_convert_level(lvl, in_fmt, out_fmt,
                                         filter_flags, threshold))
        if status_callback(i + 1, total) is False:
            raise TexAbortError("convert aborted by status callback")
    return tex.replace_levels(new_levels, tex.metadata.with_format(out_fmt))
