"""Height-map -> normal-map (DirectXTexNormalMaps.cpp) on torch tensors.

The counterpart of directxtex_tpu/ops/normalmaps.py. The reference slides
a 3-row window and central-differences per pixel (ComputeNMap :27-240);
here the whole height field is evaluated at once on the texture's device:
the 3x3 Sobel-like taps become shifted-tensor sums, with wrap/mirror edge
semantics via torch.roll / edge padding (`_shift`, which BASELINE config
5's models.pipelines.asset_pipeline also takes). Square roots go through
numerics.sqrt (correctly rounded on the CPU and on CUDA, as XLA's), the
result is quantized through the target format's pack / unpack.
"""

from __future__ import annotations

import torch

from ..formats import traits
from ..formats.dxgi import FMT, DXGIFormat
from ..formats.packing import is_packable, pack, unpack
from ..numerics import clip, sqrt
from ..texture import Texture
from .convert import CONVF, get_convert_flags
from .flags import CNMAP_CHANNEL_MASK, CNMAP_FLAGS

__all__ = ["compute_normal_map"]

# luminance scale used by CNMAP_CHANNEL_LUMINANCE (DirectXTexNormalMaps.cpp:24)
_LUM_SCALE = (0.2125, 0.7154, 0.0721)


def _evaluate_height(img: torch.Tensor, flags: CNMAP_FLAGS) -> torch.Tensor:
    """[..., H, W, 4] -> [..., H, W] height per EvaluateColor (:27-47)."""
    ch = int(flags) & CNMAP_CHANNEL_MASK
    if ch in (0, int(CNMAP_FLAGS.CHANNEL_RED)):
        return img[..., 0]
    if ch == int(CNMAP_FLAGS.CHANNEL_GREEN):
        return img[..., 1]
    if ch == int(CNMAP_FLAGS.CHANNEL_BLUE):
        return img[..., 2]
    if ch == int(CNMAP_FLAGS.CHANNEL_ALPHA):
        return img[..., 3]
    if ch == int(CNMAP_FLAGS.CHANNEL_LUMINANCE):
        return (img[..., 0] * _LUM_SCALE[0] + img[..., 1] * _LUM_SCALE[1]
                + img[..., 2] * _LUM_SCALE[2])
    raise ValueError(f"invalid CNMAP channel selector {ch:#x}")


def _shift(h: torch.Tensor, dy: int, dx: int, mirror_u: bool,
           mirror_v: bool) -> torch.Tensor:
    """Neighbourhood fetch with wrap (default) or mirror edges, matching
    EvaluateRow/row setup (:63-74, :125-135): out[y, x] = h[y + dy,
    x + dx], wrapped by a roll or clamped to the edge. h is [..., H, W]."""
    out = h
    if dy:
        if mirror_v:
            padded = torch.cat([out[..., :1, :], out, out[..., -1:, :]],
                               dim=-2)
            out = padded[..., 1 + dy:padded.shape[-2] - 1 + dy, :]
        else:
            out = torch.roll(out, -dy, dims=-2)
    if dx:
        if mirror_u:
            padded = torch.cat([out[..., :1], out, out[..., -1:]], dim=-1)
            out = padded[..., 1 + dx:padded.shape[-1] - 1 + dx]
        else:
            out = torch.roll(out, -dx, dims=-1)
    return out


def compute_normal_map(tex: Texture, flags: CNMAP_FLAGS = CNMAP_FLAGS.DEFAULT,
                       amplitude: float = 1.0,
                       fmt: DXGIFormat = FMT.R8G8B8A8_UNORM) -> Texture:
    """Public ComputeNormalMap (DirectXTexNormalMaps.cpp:257)."""
    flags = CNMAP_FLAGS(flags)
    conv = get_convert_flags(fmt)
    if conv == 0 or not (conv & (CONVF.UNORM | CONVF.SNORM | CONVF.FLOAT)):
        raise ValueError(f"compute_normal_map: unsupported target {fmt!r}")
    if traits.is_compressed(fmt) or not is_packable(fmt):
        raise ValueError(f"compute_normal_map: cannot store {fmt!r}")

    mirror_u = bool(flags & CNMAP_FLAGS.MIRROR_U)
    mirror_v = bool(flags & CNMAP_FLAGS.MIRROR_V)
    invert = bool(flags & CNMAP_FLAGS.INVERT_SIGN)
    occlusion = bool(flags & CNMAP_FLAGS.COMPUTE_OCCLUSION)
    unorm_out = bool(conv & CONVF.UNORM)

    def one_level(lvl: torch.Tensor) -> torch.Tensor:
        h = _evaluate_height(lvl, flags)  # [N, H, W]
        nb = {}
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nb[(dy, dx)] = _shift(h, dy, dx, mirror_u, mirror_v)

        # central differencing over the 3x3 window (:175-179)
        tot_x = ((nb[(-1, -1)] - nb[(-1, 1)]) + (nb[(0, -1)] - nb[(0, 1)])
                 + (nb[(1, -1)] - nb[(1, 1)]))
        delta_zx = tot_x * (amplitude / 6.0)
        tot_y = ((nb[(-1, -1)] - nb[(1, -1)]) + (nb[(-1, 0)] - nb[(1, 0)])
                 + (nb[(-1, 1)] - nb[(1, 1)]))
        delta_zy = tot_y * (amplitude / 6.0)

        # normal = normalize(cross((-1,0,dzx), (0,-1,dzy))) = normalize of
        # (dzx, dzy, 1) (:181-184)
        nx = delta_zx
        ny = delta_zy
        nz = torch.ones_like(delta_zx)
        length = sqrt(nx * nx + ny * ny + nz * nz)
        normal = torch.stack([nx, ny, nz], dim=-1) / length[..., None]

        if occlusion:
            c = nb[(0, 0)]
            delta = torch.zeros_like(c)
            for key, v in nb.items():
                if key == (0, 0):
                    continue
                delta = delta + clip(v - c, 0.0, float("inf"))
            delta = delta * (0.125 * amplitude)
            r = sqrt(1.0 + delta * delta)
            alpha = torch.where(delta > 0.0, (r - delta) / r,
                                torch.ones_like(r))
        else:
            alpha = torch.ones_like(delta_zx)

        if unorm_out:
            scale = -0.5 if invert else 0.5
            normal = normal * scale + 0.5
        elif invert:
            normal = -normal

        out = torch.cat([normal, alpha[..., None]], dim=-1)
        # quantize through the target wire format
        n, hh, ww, _ = out.shape
        flat = out.reshape(-1, 4)
        return unpack(fmt, pack(fmt, flat), flat.shape[0]).reshape(
            n, hh, ww, 4)

    levels = [one_level(l) for l in tex.levels]
    return tex.replace_levels(levels, tex.metadata.with_format(fmt))
