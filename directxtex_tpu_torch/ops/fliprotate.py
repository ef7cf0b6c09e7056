"""Flip / rotate (DirectXTexFlipRotate.cpp) on torch tensors.

The counterpart of directxtex_tpu/ops/fliprotate.py. The reference routes
through WIC's IWICBitmapFlipRotator (DirectXTexFlipRotate.cpp:23-50);
here they are layout transforms, torch.rot90 / torch.flip over the
[items, H, W, 4] levels on the texture's device. The result is exact.
"""

from __future__ import annotations

import dataclasses

import torch

from ..texture import Texture
from .flags import TEX_FR_FLAGS as FR

__all__ = ["flip_rotate"]


def flip_rotate(tex: Texture, flags: FR) -> Texture:
    """90-degree-multiple rotation plus optional horizontal/vertical flip.

    Matches TEX_FR_FLAGS semantics (DirectXTex.h:723-731): rotation applied
    first, then flips.
    """
    flags = FR(flags)
    rot = int(flags) & 0x3
    do_h = bool(flags & FR.FLIP_HORIZONTAL)
    do_v = bool(flags & FR.FLIP_VERTICAL)

    def xform(lvl):
        v = lvl
        if rot:
            # rot90 with k=-rot: TEX_FR_ROTATE90 is clockwise
            v = torch.rot90(v, k=-rot, dims=(1, 2))
        if do_h:
            v = torch.flip(v, dims=(2,))
        if do_v:
            v = torch.flip(v, dims=(1,))
        return v.contiguous()

    levels = [xform(l) for l in tex.levels]
    meta = tex.metadata
    if rot in (1, 3):
        meta = dataclasses.replace(meta, width=meta.height, height=meta.width)
    return tex.replace_levels(levels, dataclasses.replace(
        meta, mip_levels=len(levels)))
