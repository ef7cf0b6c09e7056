"""Premultiplied alpha conversion (DirectXTexPMAlpha.cpp) on torch tensors.

The counterpart of directxtex_tpu/ops/pmalpha.py: straight <->
premultiplied alpha, with optional sRGB-correct processing (the *Linear
variants wrap the multiply in sRGB<->linear transforms,
DirectXTexPMAlpha.cpp:55,143).
"""

from __future__ import annotations

import torch

from ..formats import traits
from ..texture import TexAlphaMode, Texture
from .colorspace import apply_linear_to_srgb, apply_srgb_to_linear
from .flags import TEX_PMALPHA_FLAGS as PM

__all__ = ["premultiply_alpha", "premultiply_values", "demultiply_values"]


def premultiply_values(rgba: torch.Tensor) -> torch.Tensor:
    """rgb *= a (PremultiplyAlpha_, DirectXTexPMAlpha.cpp:17)."""
    a = rgba[..., 3:4]
    return torch.cat([rgba[..., :3] * a, a], dim=-1)


def demultiply_values(rgba: torch.Tensor) -> torch.Tensor:
    """rgb /= a where a > 0 (DemultiplyAlpha, DirectXTexPMAlpha.cpp:102);
    the other pixels stay as they are."""
    a = rgba[..., 3:4]
    pos = a > 0
    rgb = torch.where(pos, rgba[..., :3] / torch.where(
        pos, a, torch.ones_like(a)), rgba[..., :3])
    return torch.cat([rgb, a], dim=-1)


def premultiply_alpha(tex: Texture, flags: PM = PM.DEFAULT) -> Texture:
    """Public PremultiplyAlpha (DirectXTexPMAlpha.cpp:214,265)."""
    flags = PM(flags)
    fmt = tex.metadata.format
    if traits.is_compressed(fmt) or traits.is_planar(fmt) or \
            traits.is_palettized(fmt) or traits.is_typeless(fmt):
        raise ValueError(f"premultiply_alpha: invalid format {fmt!r}")

    use_srgb = traits.is_srgb(fmt) or bool(flags & PM.SRGB)
    if flags & PM.IGNORE_SRGB:
        use_srgb = False
    reverse = bool(flags & PM.REVERSE)

    def xform(lvl):
        v = lvl
        if use_srgb:
            v = apply_srgb_to_linear(v)
        v = demultiply_values(v) if reverse else premultiply_values(v)
        if use_srgb:
            v = apply_linear_to_srgb(v)
        return v

    mode = TexAlphaMode.STRAIGHT if reverse else TexAlphaMode.PREMULTIPLIED
    meta = tex.metadata.with_alpha_mode(mode)
    return tex.replace_levels([xform(l) for l in tex.levels], meta)
