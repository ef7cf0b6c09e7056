"""End-to-end texture pipelines on torch tensors (BASELINE.md configs).

The counterpart of directxtex_tpu/models/pipelines.py:
`bc_encode_pipeline` for every kind the JAX package takes (BC1, BC3,
BC4U, BC5U, every tier and flag of encode_bc7, BC6H_UF16), BASELINE
config 1 `mipped_compress_pipeline`, config 4 `hdr_cubemap_pipeline` and
config 5 `asset_pipeline`. (Config 2 has no pipeline function in the JAX
package either: benchmarks/run_all.py composes it.) The entry points run
on the card: `run()` keeps the device of a tensor it is given and moves a
numpy array to `device` (CUDA unless the caller names another, as the
CPU tests do).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bc import bc45, bc6h, bc67, bc123
from ..bc.common import image_to_blocks
from ..numerics import fdiv, rdiv, sqrt
from ..ops.colorspace import apply_linear_to_srgb, apply_srgb_to_linear
from ..ops.normalmaps import _shift
from ..utils.device import resolve

__all__ = ["bc_encode_pipeline", "mipped_compress_pipeline", "cube_faces",
           "hdr_cubemap_pipeline", "asset_pipeline"]


def _as_tensor(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        resolve(device))


def _encode(kind: str, blocks: torch.Tensor, flags: int = 0):
    if kind == "bc1":
        return bc123.encode_bc1(blocks, 0.5, flags)
    if kind == "bc3":
        return bc123.encode_bc3(blocks, flags)
    if kind == "bc4":
        return bc45.encode_bc4u(blocks)
    if kind == "bc5":
        return bc45.encode_bc5u(blocks)
    if kind == "bc7":
        return bc67.encode_bc7(blocks, flags)
    if kind == "bc6h":
        return bc6h.encode_bc6h(blocks, signed=False)
    raise ValueError(kind)


def bc_encode_pipeline(kind: str = "bc7", flags: int = 0, device=None):
    """[H, W, 4] f32 -> packed blocks [NB, 8 or 16] u8. `kind` is "bc1"
    (threshold 0.5), "bc3", "bc4" (BC4U), "bc5" (BC5U), "bc7" or "bc6h"
    (BC6H_UF16); another kind raises ValueError when run, as in the JAX
    package. "bc7" takes images with alpha as they are (encode_bc7
    searches mode 7 where a block has alpha) and any `flags` encode_bc7
    takes: QUICK (0x100000), MAXQUALITY (0x200000), USE_3SUBSETS
    (0x80000) and their unions; "bc1" and "bc3" take the BC_FLAGS bits
    (dither, uniform)."""

    def run(img) -> torch.Tensor:
        blocks, _, _ = image_to_blocks(_as_tensor(img, device))
        return _encode(kind, blocks, flags)

    return run


def _mip_chain_blocks(img: torch.Tensor, levels: int = 0, srgb: bool = True):
    """Config 1's mip glue: [H, W, 4] -> (every stored level's blocks
    concatenated [NB, 16, 4], blocks per level). The box chain is taken in
    linear light when `srgb` (sRGB -> linear first, each stored level
    linear -> sRGB), each level the mean of 2x2 texels, rows first."""
    work = apply_srgb_to_linear(img) if srgb else img
    h, w = img.shape[:2]
    lvl = work
    n_levels = levels or max(h, w).bit_length()
    all_blocks = []
    counts = []
    for _ in range(n_levels):
        store = apply_linear_to_srgb(lvl) if srgb else lvl
        blocks, _, _ = image_to_blocks(store)
        all_blocks.append(blocks)
        counts.append(blocks.shape[0])
        nh, nw = max(1, lvl.shape[0] // 2), max(1, lvl.shape[1] // 2)
        if lvl.shape[0] > 1:
            pair = lvl.reshape(nh, 2, lvl.shape[1], 4)
            lvl = (pair[:, 0] + pair[:, 1]) * 0.5
        if lvl.shape[1] > 1:
            pair = lvl.reshape(nh, nw, 2, 4)
            lvl = (pair[:, :, 0] + pair[:, :, 1]) * 0.5
    return torch.cat(all_blocks), counts


def mipped_compress_pipeline(kind: str = "bc1", levels: int = 0,
                             srgb: bool = True, flags: int = 0, device=None):
    """BASELINE config 1: image [H, W, 4] -> full box mip chain -> BC
    encode of every level, every level's blocks in one encode. Returns a
    tuple of [NB_level, 8 or 16] u8 tensors, the top level first."""

    def run(img) -> tuple:
        blocks, counts = _mip_chain_blocks(_as_tensor(img, device), levels,
                                          srgb)
        packed = _encode(kind, blocks, flags)
        return tuple(torch.split(packed, counts))

    return run


def cube_faces(eq: torch.Tensor) -> torch.Tensor:
    """Equirect [H, 2H, 4] -> the 6 cube faces [6, H/2, H/2, 4] (+X -X +Y
    -Y +Z -Z) by nearest sphere sampling, one row gather for all faces."""
    h, w = eq.shape[0], eq.shape[1]
    face = h // 2
    u = torch.arange(face, dtype=torch.float32, device=eq.device) + 0.5
    u = fdiv(u, face) * 2.0 - 1.0
    gv, gu = torch.meshgrid(u, u, indexing="ij")
    one = torch.ones_like(gu)
    dirs = [(one, -gv, -gu), (-one, -gv, gu), (gu, one, gv),
            (gu, -one, -gv), (gu, -gv, one), (-gu, -gv, -one)]
    idxs = []
    for dx, dy, dz in dirs:
        norm = sqrt(dx * dx + dy * dy + dz * dz)
        x, y, z = dx / norm, dy / norm, dz / norm
        lon = torch.atan2(x, z)
        lat = torch.asin(y.clamp(-1.0, 1.0))
        fu = (fdiv(lon, 2 * math.pi) + 0.5) * w
        fv = (0.5 - fdiv(lat, math.pi)) * h
        x0 = fu.to(torch.int32).clamp(0, w - 1)
        y0 = fv.to(torch.int32).clamp(0, h - 1)
        idxs.append(y0 * w + x0)
    rows = torch.stack(idxs).reshape(-1).to(torch.int64)
    return eq.reshape(-1, 4).index_select(0, rows).reshape(6, face, face, 4)


def hdr_cubemap_pipeline(device=None):
    """BASELINE config 4: equirect HDR [H, 2H, 4] -> 6 cube faces (H/2 x
    H/2) -> BC6H_UF16 blocks per face, all six faces in one encode (one K5
    launch on the card). Returns a tuple of 6 [NB_face, 16] u8 tensors."""

    def run(equirect) -> tuple:
        faces = cube_faces(_as_tensor(equirect, device))
        blocks = torch.cat([image_to_blocks(faces[i])[0] for i in range(6)])
        packed = bc6h.encode_bc6h(blocks, signed=False)
        per = blocks.shape[0] // 6
        return tuple(packed[i * per:(i + 1) * per] for i in range(6))

    return run


def _normal_map(heights: torch.Tensor) -> torch.Tensor:
    """Config 5's normal-map glue: height maps [N, H, W, 4] (height in
    red) -> normal maps [N, H, W, 4] f32 (xyz * 0.5 + 0.5, alpha 1) from
    the 3x3 taps with wrapped edges."""
    h = heights[..., 0]
    nb = {(dy, dx): _shift(h, dy, dx, False, False)
          for dy in (-1, 0, 1) for dx in (-1, 0, 1)}
    tx = ((nb[(-1, -1)] - nb[(-1, 1)]) + (nb[(0, -1)] - nb[(0, 1)])
          + (nb[(1, -1)] - nb[(1, 1)])) * (2.0 / 6.0)
    ty = ((nb[(-1, -1)] - nb[(1, -1)]) + (nb[(-1, 0)] - nb[(1, 0)])
          + (nb[(-1, 1)] - nb[(1, 1)])) * (2.0 / 6.0)
    ln = sqrt(tx * tx + ty * ty + 1.0)
    normal = torch.stack([tx / ln, ty / ln, rdiv(1.0, ln)], dim=-1) * 0.5 \
        + 0.5
    return torch.cat([normal, torch.ones_like(normal[..., :1])], dim=-1)


def asset_pipeline(flags: int = 0, device=None):
    """BASELINE config 5: height map -> normal map -> BC7, batched over a
    texture library [N, H, W, 4]. Returns [N, NB, 16] u8. Every image's
    blocks go through one encode_bc7 call (the JAX package vmaps it per
    image; each block's words are its own either way)."""

    def run(heights) -> torch.Tensor:
        rgba = _normal_map(_as_tensor(heights, device))
        blocks = torch.cat([image_to_blocks(img)[0] for img in rgba])
        return bc67.encode_bc7(blocks, flags).reshape(rgba.shape[0], -1, 16)

    return run
