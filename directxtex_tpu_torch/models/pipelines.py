"""End-to-end texture pipelines on torch tensors (BASELINE.md configs).

The counterpart of directxtex_tpu/models/pipelines.py for the kinds the
port has: `bc_encode_pipeline` for BC7 (every tier and flag of
encode_bc7, images with or without alpha) and BC6H_UF16, and
BASELINE config 4, `hdr_cubemap_pipeline`. The entry points run on the
card: `run()` keeps the device of a tensor it is given and moves a numpy
array to `device` (CUDA unless the caller names another, as the CPU tests
do).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bc import bc6h, bc67
from ..bc.common import image_to_blocks

__all__ = ["bc_encode_pipeline", "cube_faces", "hdr_cubemap_pipeline"]

_KINDS = ("bc7", "bc6h")


def _as_tensor(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.device(device or "cuda"))


def _encode(kind: str, blocks: torch.Tensor, flags: int = 0):
    if kind == "bc7":
        return bc67.encode_bc7(blocks, flags)
    return bc6h.encode_bc6h(blocks, signed=False)


def bc_encode_pipeline(kind: str = "bc7", flags: int = 0, device=None):
    """[H, W, 4] f32 -> packed blocks [NB, 16] u8. "bc7" takes images
    with alpha as they are (encode_bc7 searches mode 7 where a block has
    alpha) and any `flags` encode_bc7 takes: QUICK (0x100000),
    MAXQUALITY (0x200000), USE_3SUBSETS (0x80000) and their unions."""
    if kind not in _KINDS:
        raise NotImplementedError(
            f"kind {kind!r}: the port encodes {_KINDS} (BC1-BC5: ROADMAP.md "
            "queue 1)")

    def run(img) -> torch.Tensor:
        blocks, _, _ = image_to_blocks(_as_tensor(img, device))
        return _encode(kind, blocks, flags)

    return run


def _fdiv(a: torch.Tensor, b: float) -> torch.Tensor:
    """IEEE a / b for a python scalar b (torch on CUDA multiplies by the
    scalar's reciprocal), as the JAX package divides."""
    return torch.div(a, torch.full_like(a, b))


def cube_faces(eq: torch.Tensor) -> torch.Tensor:
    """Equirect [H, 2H, 4] -> the 6 cube faces [6, H/2, H/2, 4] (+X -X +Y
    -Y +Z -Z) by nearest sphere sampling, one row gather for all faces."""
    h, w = eq.shape[0], eq.shape[1]
    face = h // 2
    u = torch.arange(face, dtype=torch.float32, device=eq.device) + 0.5
    u = _fdiv(u, face) * 2.0 - 1.0
    gv, gu = torch.meshgrid(u, u, indexing="ij")
    one = torch.ones_like(gu)
    dirs = [(one, -gv, -gu), (-one, -gv, gu), (gu, one, gv),
            (gu, -one, -gv), (gu, -gv, one), (-gu, -gv, -one)]
    idxs = []
    for dx, dy, dz in dirs:
        norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
        x, y, z = dx / norm, dy / norm, dz / norm
        lon = torch.atan2(x, z)
        lat = torch.asin(y.clamp(-1.0, 1.0))
        fu = (_fdiv(lon, 2 * math.pi) + 0.5) * w
        fv = (0.5 - _fdiv(lat, math.pi)) * h
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
