"""BC4/BC5 codecs on torch tensors, batched over blocks (BC4BC5.cpp).

The counterpart of directxtex_tpu/bc/bc45.py. Decode follows
BC4_UNORM/BC4_SNORM::DecodeFromIndex exactly, including the 6-step + {0,1}
endpoint rule and the -128 -> -127 signed clamp (BC4BC5.cpp:39-151).
Encode = FindEndPointsBC4U/S (OptimizeAlpha with 6- vs 8-step selection by
boundary values, :183-293) + FindClosest (:325-377). Plain torch ops serve
the CPU and CUDA alike; u32 words are int64 values masked to 32 bits, and
packed blocks are their little-endian bytes.
"""

from __future__ import annotations

import torch

from ..numerics import fdiv
from .bc67 import _words_i32
from .common import optimize_alpha_t

__all__ = ["decode_bc4u", "decode_bc4s", "decode_bc5u", "decode_bc5s",
           "encode_bc4u", "encode_bc4s", "encode_bc5u", "encode_bc5s"]

_M32 = 0xFFFFFFFF


def words_of(blocks: torch.Tensor) -> torch.Tensor:
    """[NB, 4k] u8 -> [NB, k] int64 little-endian u32 words."""
    nb = blocks.shape[0]
    return (blocks.contiguous().view(torch.int32).reshape(nb, -1)
            .to(torch.int64) & _M32)


def bytes_of(words: torch.Tensor) -> torch.Tensor:
    """[NB, k] int64 u32 words -> [NB, 4k] u8, little-endian (as
    lax.bitcast_convert_type)."""
    return _words_i32(words & _M32).contiguous().view(torch.uint8).reshape(
        words.shape[0], -1)


def _bc4_palette(r0_code: torch.Tensor, r1_code: torch.Tensor,
                 signed: bool) -> torch.Tensor:
    """[NB] byte codes (int64) -> [NB, 8] f32 palette (DecodeFromIndex)."""
    if signed:
        s0 = torch.where(r0_code >= 128, r0_code - 256, r0_code)
        s1 = torch.where(r1_code >= 128, r1_code - 256, r1_code)
        f0 = fdiv(torch.where(s0 == -128, -127, s0).to(torch.float32), 127.0)
        f1 = fdiv(torch.where(s1 == -128, -127, s1).to(torch.float32), 127.0)
        # the comparison uses the *signed* byte values (red_0 > red_1)
        eight = s0 > s1
        lo_val, hi_val = -1.0, 1.0
    else:
        f0 = fdiv(r0_code.to(torch.float32), 255.0)
        f1 = fdiv(r1_code.to(torch.float32), 255.0)
        eight = r0_code > r1_code
        lo_val, hi_val = 0.0, 1.0

    i8 = torch.arange(1, 7, dtype=torch.float32, device=f0.device)
    p8 = fdiv(f0[:, None] * (7.0 - i8)[None] + f1[:, None] * i8[None], 7.0)
    pal8 = torch.cat([f0[:, None], f1[:, None], p8], dim=1)
    i6 = torch.arange(1, 5, dtype=torch.float32, device=f0.device)
    p6 = fdiv(f0[:, None] * (5.0 - i6)[None] + f1[:, None] * i6[None], 5.0)
    pal6 = torch.cat([f0[:, None], f1[:, None], p6,
                      torch.full_like(f0[:, None], lo_val),
                      torch.full_like(f0[:, None], hi_val)], dim=1)
    return torch.where(eight[:, None], pal8, pal6)


def _bc4_indices(words: torch.Tensor) -> torch.Tensor:
    """[NB, 2] u32 words (8-byte block) -> [NB, 16] 3-bit indices."""
    lo = (words[:, 0] >> 16) | ((words[:, 1] & 0xFF) << 16)
    hi = words[:, 1] >> 8
    sh = torch.arange(8, device=words.device) * 3
    idx_lo = (lo[:, None] >> sh[None, :]) & 7
    idx_hi = (hi[:, None] >> sh[None, :]) & 7
    return torch.cat([idx_lo, idx_hi], dim=1)


def _decode_bc4_channel(blocks8: torch.Tensor, signed: bool) -> torch.Tensor:
    words = words_of(blocks8)
    r0 = words[:, 0] & 0xFF
    r1 = (words[:, 0] >> 8) & 0xFF
    pal = _bc4_palette(r0, r1, signed)
    return torch.gather(pal, 1, _bc4_indices(words))


def _rg01(r: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
    z = torch.zeros_like(r)
    return torch.stack([r, z if g is None else g, z, torch.ones_like(r)],
                       dim=-1)


def decode_bc4u(blocks: torch.Tensor) -> torch.Tensor:
    """[NB, 8] u8 -> [NB, 16, 4] (r, 0, 0, 1) (D3DXDecodeBC4U)."""
    return _rg01(_decode_bc4_channel(blocks, False))


def decode_bc4s(blocks: torch.Tensor) -> torch.Tensor:
    return _rg01(_decode_bc4_channel(blocks, True))


def decode_bc5u(blocks: torch.Tensor) -> torch.Tensor:
    """[NB, 16] u8 -> [NB, 16, 4] (r, g, 0, 1) (D3DXDecodeBC5U)."""
    return _rg01(_decode_bc4_channel(blocks[:, :8], False),
                 _decode_bc4_channel(blocks[:, 8:], False))


def decode_bc5s(blocks: torch.Tensor) -> torch.Tensor:
    return _rg01(_decode_bc4_channel(blocks[:, :8], True),
                 _decode_bc4_channel(blocks[:, 8:], True))


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _float_to_snorm8(v: torch.Tensor) -> torch.Tensor:
    """FloatToSNorm (BC4BC5.cpp:158): clamp, scale by 127, round away from
    zero, truncate."""
    v = torch.nan_to_num(v)
    v = v.clamp(-1.0, 1.0) * 127.0
    v = torch.where(v >= 0, v + 0.5, v - 0.5)
    return v.to(torch.int32).to(torch.int64) & 0xFF


def _float_to_unorm8(v: torch.Tensor) -> torch.Tensor:
    """uint8_t(fStart * 255.0f): TRUNCATION (BC4BC5.cpp:219)."""
    return (v * 255.0).clamp(0, 255).to(torch.int64)


def pack3(idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[16, NB] 3-bit indices -> the two 24-bit halves [NB] int64."""
    sh = (torch.arange(8, device=idx.device) * 3)[:, None]
    return ((idx[:8] << sh).sum(dim=0), (idx[8:] << sh).sum(dim=0))


def _encode_bc4_channel(texels: torch.Tensor, signed: bool) -> torch.Tensor:
    """[NB, 16] float -> [NB, 2] int64 u32 words of the 8-byte BC4 block."""
    t = texels.to(torch.float32).t().contiguous()     # lane-major [16, NB]
    fmin = t.amin(dim=0)
    fmax = t.amax(dim=0)
    min_norm = -1.0 if signed else 0.0
    use_6 = (fmin == min_norm) | (fmax == 1.0)  # boundary -> 6-step codec

    x8, y8 = optimize_alpha_t(t, 8, signed)
    x6, y6 = optimize_alpha_t(t, 6, signed)
    to_code = _float_to_snorm8 if signed else _float_to_unorm8
    # 8-step: red_0 = end (max), red_1 = start (min) (BC4BC5.cpp:222-223)
    # 6-step: red_0 = start, red_1 = end (:233-234)
    r0 = torch.where(use_6, to_code(x6), to_code(y8))
    r1 = torch.where(use_6, to_code(y6), to_code(x8))

    pal = _bc4_palette(r0, r1, signed)  # [NB, 8] decode-exact gradient
    # FindClosest: the nearest palette entry, first one on a tie
    best = (t - pal[:, 0][None, :]).abs()
    idx = torch.zeros(t.shape, dtype=torch.int64, device=t.device)
    for k in range(1, 8):
        d = (t - pal[:, k][None, :]).abs()
        better = d < best
        best = torch.where(better, d, best)
        idx = torch.where(better, k, idx)

    half0, half1 = pack3(idx)
    word0 = r0 | (r1 << 8) | ((half0 & 0xFFFF) << 16)
    word1 = (half0 >> 16) | ((half1 & 0xFFFFFF) << 8)
    return torch.stack([word0, word1], dim=1)


def encode_bc4u(colors: torch.Tensor) -> torch.Tensor:
    """[NB, 16, 4] -> [NB, 8] u8 (D3DXEncodeBC4U)."""
    return bytes_of(_encode_bc4_channel(colors[..., 0], False))


def encode_bc4s(colors: torch.Tensor) -> torch.Tensor:
    return bytes_of(_encode_bc4_channel(colors[..., 0], True))


def encode_bc5u(colors: torch.Tensor) -> torch.Tensor:
    """[NB, 16, 4] -> [NB, 16] u8 (D3DXEncodeBC5U)."""
    return bytes_of(torch.cat([_encode_bc4_channel(colors[..., 0], False),
                               _encode_bc4_channel(colors[..., 1], False)],
                              dim=1))


def encode_bc5s(colors: torch.Tensor) -> torch.Tensor:
    return bytes_of(torch.cat([_encode_bc4_channel(colors[..., 0], True),
                               _encode_bc4_channel(colors[..., 1], True)],
                              dim=1))
