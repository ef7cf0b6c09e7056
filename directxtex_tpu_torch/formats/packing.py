"""Wire-format pack/unpack engine on torch tensors.

The counterpart of directxtex_tpu/formats/packing.py (the reference's
LoadScanline / StoreScanline, DirectXTexConvert.cpp:779-2790):
`unpack(fmt, bytes) -> [N, 4] f32` and `pack(fmt, [N, 4] f32) -> bytes`
over the 75 formats for which `is_packable` is true, as torch ops on the
tensor's device.

Channel fill rules are the JAX package's: missing G/B decode to 0, missing
A to 1; A8 decodes to (0, 0, 0, a); depth/stencil to (d, s, 0, 1). sRGB is
not applied here (the convert layer does it).

Words are held in int64 with explicit masks (torch's unsigned types lack
shifts and bitwise ops on some backends), and bytes are assembled with
shifts, so a tensor at any storage offset works. Every float-to-integer
cast goes through `_sat`, which does what XLA's conversion does (NaN to
0, saturation at the target's range, truncation toward zero): torch's
own cast of a NaN or out-of-range value differs between the CPU and CUDA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import constant, resolve
from .dxgi import FMT, DXGIFormat

__all__ = ["unpack", "pack", "unpack_image", "pack_image", "is_packable",
           "planar_to_single", "unpack_planar_image"]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _words(data: torch.Tensor, nbytes: int) -> torch.Tensor:
    """flat u8 -> [N] int64 little-endian words of `nbytes` bytes."""
    b = data.reshape(-1, nbytes).to(torch.int64)
    w = b[:, 0]
    for i in range(1, nbytes):
        w = w | (b[:, i] << (8 * i))
    return w


def _word_bytes(w: torch.Tensor, nbytes: int) -> torch.Tensor:
    """int64 words (their low `nbytes` bytes) -> flat u8, little-endian."""
    parts = [(w >> (8 * i)) & 0xFF for i in range(nbytes)]
    return torch.stack(parts, dim=-1).to(torch.uint8).reshape(-1)


def _sat(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """f32 -> int64 as XLA converts to an integer type of range [lo, hi]:
    NaN -> 0, saturating, truncating toward zero."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return x.clamp(lo, hi).to(torch.int64)


def _f32(c: float) -> float:
    """A python constant rounded to f32, as jnp rounds a weak-typed one."""
    return float(np.float32(c))


def _round_unorm(v: torch.Tensor, scale: float) -> torch.Tensor:
    """float [0,1] -> integer code, round-to-nearest (XMStore*N semantics).
    The multiply and the add round on their own, as eager jnp does."""
    v = v.clamp(0.0, 1.0)
    return _sat(torch.floor(v * scale + 0.5), 0, 4294967295)


def _round_snorm(v: torch.Tensor, scale: float) -> torch.Tensor:
    """float [-1,1] -> signed integer code, round-half-away-from-zero."""
    v = v.clamp(-1.0, 1.0) * scale
    r = torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5))
    return _sat(r, -2147483648, 2147483647)


def _sign_extend(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Sign-extend the low `bits` of a word."""
    m = 1 << (bits - 1)
    return ((v & ((1 << bits) - 1)) ^ m) - m


# exact decode tables: correctly rounded code / max, computed on the host
# as the JAX package computes them (numpy f32 division), kept per device
# (`constant`) so that a decode copies no table to the device after its
# first


def _unorm_decode(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Exact UNORM decode: correctly-rounded v / (2^bits - 1)."""
    maxc = (1 << bits) - 1
    if bits <= 10:
        tab = constant(("unorm", bits), lambda: (
            np.arange(maxc + 1, dtype=np.float32)
            / np.float32(maxc)).astype(np.float32), v.device)
        return tab[v.to(torch.int64)]
    f = v.to(torch.float32) * _f32(1.0 / maxc)
    return torch.where(v == maxc, torch.ones_like(f), f)


def _snorm_decode(code: torch.Tensor, bits: int) -> torch.Tensor:
    """Exact SNORM decode of signed int codes (most-negative clamps to -1)."""
    maxpos = (1 << (bits - 1)) - 1
    if bits <= 10:
        def make():
            codes = np.arange(-(maxpos + 1), maxpos + 1, dtype=np.float32)
            return np.maximum(codes / np.float32(maxpos),
                              -1.0).astype(np.float32)
        tab = constant(("snorm", bits), make, code.device)
        return tab[code.to(torch.int64) + (maxpos + 1)]
    f = code.to(torch.float32) * _f32(1.0 / maxpos)
    f = torch.where(code == maxpos, torch.ones_like(f), f)
    f = torch.where(code == -maxpos, -torch.ones_like(f), f)
    return torch.clamp(f, min=-1.0)


def _half_to_f32(u16: torch.Tensor) -> torch.Tensor:
    """Half bits -> f32, exactly. A NaN keeps its sign and payload and gets
    the quiet bit, as XLA and torch's CPU conversion give it; CUDA's
    conversion makes every NaN canonical, so NaNs are built from bits."""
    s16 = ((u16 + 32768) & 0xFFFF) - 32768
    f = s16.to(torch.int16).view(torch.float16).to(torch.float32)
    nan = (u16 & 0x7C00) == 0x7C00
    nan &= (u16 & 0x3FF) != 0
    bits = (((u16 >> 15) & 1) << 31) | 0x7FC00000 | ((u16 & 0x3FF) << 13)
    return torch.where(nan, _bits_f32(bits), f)


def _f32_to_half(f: torch.Tensor) -> torch.Tensor:
    """f32 -> half bits (round to nearest even, subnormal halves kept) as
    int64 in [0, 65535]. A NaN keeps its sign and the top of its payload
    and gets the quiet bit, as in XLA and torch's CPU conversion (CUDA's
    makes it canonical)."""
    h = f.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    w = _f32_bits(f)
    nan_h = (((w >> 31) & 1) << 15) | 0x7E00 | ((w >> 13) & 0x3FF)
    return torch.where(torch.isnan(f), nan_h, h)


def _f32_bits(f: torch.Tensor) -> torch.Tensor:
    return f.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _bits_f32(w: torch.Tensor) -> torch.Tensor:
    s32 = ((w + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return s32.to(torch.int32).view(torch.float32)


def _exp2i(e: torch.Tensor) -> torch.Tensor:
    """2**e for integer e in the normal f32 range, exactly (what XLA's
    exp2 gives there)."""
    return _bits_f32((e.to(torch.int64) + 127) << 23)


# ---------------------------------------------------------------------------
# small-float families (11:11:10, 9995E, Xbox 7e3/6e4)
# ---------------------------------------------------------------------------

def _float_from_small(code: torch.Tensor, mant_bits: int, exp_bits: int,
                      exp_bias: int) -> torch.Tensor:
    """Unsigned small float -> f32 (denormals included, matching
    XMLoadFloat3PK)."""
    mant = (code & ((1 << mant_bits) - 1)).to(torch.float32)
    exp = (code >> mant_bits) & ((1 << exp_bits) - 1)
    max_exp = (1 << exp_bits) - 1
    frac = mant / float(1 << mant_bits)
    normal = (1.0 + frac) * _exp2i(exp - exp_bias)
    denorm = frac * _f32(2.0 ** (1 - exp_bias))
    value = torch.where(exp == 0, denorm, normal)
    inf = torch.where(mant == 0, torch.full_like(mant, float("inf")),
                      torch.full_like(mant, float("nan")))
    return torch.where(exp == max_exp, inf, value)


def _small_from_float(f: torch.Tensor, mant_bits: int, exp_bits: int,
                      exp_bias: int) -> torch.Tensor:
    """f32 -> unsigned small float code, with the JAX package's integer
    rounding (half away from zero; an f32 subnormal is taken with the
    implicit 1, as there)."""
    max_exp = (1 << exp_bits) - 1
    f = torch.maximum(f.to(torch.float32), torch.zeros_like(f))
    bits = _f32_bits(f)
    f_exp = ((bits >> 23) & 0xFF) - 127
    t_exp = f_exp + exp_bias
    f_mant = (bits & 0x7FFFFF) | 0x800000
    shift = 23 - mant_bits
    rounded = (f_mant + (1 << (shift - 1))) >> shift
    carry = rounded >> (mant_bits + 1)
    rounded = torch.where(carry > 0, rounded >> 1, rounded)
    t_exp = t_exp + carry
    mant_field = rounded & ((1 << mant_bits) - 1)
    code = (t_exp.clamp(0, max_exp) << mant_bits) | mant_field
    denorm_shift = (1 - exp_bias - f_exp + shift).clamp(0, 31)
    denorm = f_mant >> denorm_shift
    code = torch.where(t_exp <= 0, denorm & ((1 << mant_bits) - 1), code)
    max_code = ((max_exp - 1) << mant_bits) | ((1 << mant_bits) - 1)
    code = torch.where(t_exp > max_exp - 1, torch.full_like(code, max_code),
                       code)
    nan_code = (max_exp << mant_bits) | 1
    code = torch.where(torch.isnan(f), torch.full_like(code, nan_code), code)
    return torch.where(f == 0.0, torch.zeros_like(code), code)


def _f32_to_9995e(rgb: torch.Tensor) -> torch.Tensor:
    """[N,3] f32 -> [N] R9G9B9E5 shared-exponent words (XMStoreFloat3SE)."""
    maxf = 511.0 / 512.0 * 32768.0
    r, g, b = (torch.nan_to_num(rgb[:, i]).clamp(0.0, maxf) for i in range(3))
    max_c = torch.maximum(torch.maximum(r, g), b)
    biased_exp = (_f32_bits(max_c) >> 23) & 0xFF
    exp_shared = (biased_exp - 127 + 16).clamp(0, 31)

    def mants(e):
        scale = _exp2i(e - 15 - 9)
        return [torch.floor(torch.div(c, scale) + 0.5) for c in (r, g, b)]

    rm, gm, bm = mants(exp_shared)
    over = torch.maximum(torch.maximum(rm, gm), bm) > 511
    exp_shared = torch.where(over, exp_shared + 1, exp_shared)
    rm, gm, bm = (_sat(torch.clamp(m, max=511.0), 0, 4294967295)
                  for m in mants(exp_shared))
    return rm | (gm << 9) | (bm << 18) | (exp_shared << 27)


def _9995e_to_f32(w: torch.Tensor) -> torch.Tensor:
    """[N] words -> [N,3] f32 (XMLoadFloat3SE: value = m * 2^(e-24))."""
    scale = _exp2i((w >> 27) - 24)
    return torch.stack([((w >> s) & 0x1FF).to(torch.float32) * scale
                        for s in (0, 9, 18)], dim=-1)


# ---------------------------------------------------------------------------
# YUV <-> RGB (studio swing, exact integer math from LoadScanline)
# ---------------------------------------------------------------------------

def _dot_shift16(terms) -> torch.Tensor:
    """Exact (sum c_i * x_i + 32768) >> 16, in int64 as the reference does
    (the JAX package splits it into two int32 limbs; the result is the
    same integer)."""
    acc = 32768
    for c, x in terms:
        acc = acc + c * x
    return acc >> 16


def _yuv8_to_rgb(y, u, v):
    """8-bit BT.601-ish integer conversion (DirectXTexConvert.cpp:1296-1316)."""
    y_, u_, v_ = y - 16, u - 128, v - 128
    r = (298 * y_ + 409 * v_ + 128) >> 8
    g = (298 * y_ - 100 * u_ - 208 * v_ + 128) >> 8
    b = (298 * y_ + 516 * u_ + 128) >> 8
    return tuple(_unorm_decode(c.clamp(0, 255), 8) for c in (r, g, b))


def _rgb_to_yuv8(r, g, b):
    """Inverse of _yuv8_to_rgb (StoreScanline AYUV math)."""
    ri, gi, bi = (_round_unorm(c, 255.0) for c in (r, g, b))
    y = ((66 * ri + 129 * gi + 25 * bi + 128) >> 8) + 16
    u = ((-38 * ri - 74 * gi + 112 * bi + 128) >> 8) + 128
    v = ((112 * ri - 94 * gi - 18 * bi + 128) >> 8) + 128
    return tuple(c.clamp(0, 255) for c in (y, u, v))


def _yuv10_to_rgb(y, u, v):
    """10-bit conversion (Y410/Y210, DirectXTexConvert.cpp:1328-1360)."""
    y_, u_, v_ = y - 64, u - 512, v - 512
    r = _dot_shift16([(76533, y_), (104905, v_)])
    g = _dot_shift16([(76533, y_), (-25747, u_), (-53425, v_)])
    b = _dot_shift16([(76533, y_), (132590, u_)])
    return tuple(_unorm_decode(c.clamp(0, 1023), 10) for c in (r, g, b))


def _yuv16_to_rgb(y, u, v):
    """16-bit conversion (Y416/Y216, DirectXTexConvert.cpp:1363-1397)."""
    y_, u_, v_ = y - 4096, u - 32768, v - 32768
    r = _dot_shift16([(76607, y_), (105006, v_)])
    g = _dot_shift16([(76607, y_), (-25772, u_), (-53477, v_)])
    b = _dot_shift16([(76607, y_), (132718, u_)])
    return tuple(_unorm_decode(c.clamp(0, 65535), 16) for c in (r, g, b))


def _rgb_to_yuv10(r, g, b):
    ri, gi, bi = (_round_unorm(c, 1023.0) for c in (r, g, b))
    y = _dot_shift16([(16780, ri), (32942, gi), (6544, bi)]) + 64
    u = _dot_shift16([(-9683, ri), (-19017, gi), (28700, bi)]) + 512
    v = _dot_shift16([(28700, ri), (-24033, gi), (-4667, bi)]) + 512
    return tuple(c.clamp(0, 1023) for c in (y, u, v))


def _rgb_to_yuv16(r, g, b):
    ri, gi, bi = (_round_unorm(c, 65535.0) for c in (r, g, b))
    y = _dot_shift16([(16763, ri), (32910, gi), (6537, bi)]) + 4096
    u = _dot_shift16([(-9674, ri), (-18998, gi), (28672, bi)]) + 32768
    v = _dot_shift16([(28672, ri), (-24010, gi), (-4662, bi)]) + 32768
    return tuple(c.clamp(0, 65535) for c in (y, u, v))


# ---------------------------------------------------------------------------
# descriptor table for the regular formats (the JAX package's, verbatim)
# ---------------------------------------------------------------------------
# kinds: 'f32', 'f16', 'unorm16', 'snorm16', 'uint16', 'sint16',
#        'unorm8', 'snorm8', 'uint8', 'sint8', 'uint32', 'sint32'
# channels: how many consecutive typed elements per pixel
# order: destination RGBA channel of each element (None = discard)

@dataclasses.dataclass(frozen=True)
class _ChanDesc:
    kind: str
    channels: int
    order: tuple = (0, 1, 2, 3)


_CHAN_FORMATS: dict[DXGIFormat, _ChanDesc] = {
    FMT.R32G32B32A32_FLOAT: _ChanDesc("f32", 4),
    FMT.R32G32B32A32_UINT: _ChanDesc("uint32", 4),
    FMT.R32G32B32A32_SINT: _ChanDesc("sint32", 4),
    FMT.R32G32B32_FLOAT: _ChanDesc("f32", 3),
    FMT.R32G32B32_UINT: _ChanDesc("uint32", 3),
    FMT.R32G32B32_SINT: _ChanDesc("sint32", 3),
    FMT.R16G16B16A16_FLOAT: _ChanDesc("f16", 4),
    FMT.R16G16B16A16_UNORM: _ChanDesc("unorm16", 4),
    FMT.R16G16B16A16_UINT: _ChanDesc("uint16", 4),
    FMT.R16G16B16A16_SNORM: _ChanDesc("snorm16", 4),
    FMT.R16G16B16A16_SINT: _ChanDesc("sint16", 4),
    FMT.R32G32_FLOAT: _ChanDesc("f32", 2),
    FMT.R32G32_UINT: _ChanDesc("uint32", 2),
    FMT.R32G32_SINT: _ChanDesc("sint32", 2),
    FMT.R8G8B8A8_UNORM: _ChanDesc("unorm8", 4),
    FMT.R8G8B8A8_UNORM_SRGB: _ChanDesc("unorm8", 4),
    FMT.R8G8B8A8_UINT: _ChanDesc("uint8", 4),
    FMT.R8G8B8A8_SNORM: _ChanDesc("snorm8", 4),
    FMT.R8G8B8A8_SINT: _ChanDesc("sint8", 4),
    FMT.R16G16_FLOAT: _ChanDesc("f16", 2),
    FMT.R16G16_UNORM: _ChanDesc("unorm16", 2),
    FMT.R16G16_UINT: _ChanDesc("uint16", 2),
    FMT.R16G16_SNORM: _ChanDesc("snorm16", 2),
    FMT.R16G16_SINT: _ChanDesc("sint16", 2),
    FMT.D32_FLOAT: _ChanDesc("f32", 1),
    FMT.R32_FLOAT: _ChanDesc("f32", 1),
    FMT.R32_UINT: _ChanDesc("uint32", 1),
    FMT.R32_SINT: _ChanDesc("sint32", 1),
    FMT.R8G8_UNORM: _ChanDesc("unorm8", 2),
    FMT.R8G8_UINT: _ChanDesc("uint8", 2),
    FMT.R8G8_SNORM: _ChanDesc("snorm8", 2),
    FMT.R8G8_SINT: _ChanDesc("sint8", 2),
    FMT.R16_FLOAT: _ChanDesc("f16", 1),
    FMT.D16_UNORM: _ChanDesc("unorm16", 1),
    FMT.R16_UNORM: _ChanDesc("unorm16", 1),
    FMT.R16_UINT: _ChanDesc("uint16", 1),
    FMT.R16_SNORM: _ChanDesc("snorm16", 1),
    FMT.R16_SINT: _ChanDesc("sint16", 1),
    FMT.R8_UNORM: _ChanDesc("unorm8", 1),
    FMT.R8_UINT: _ChanDesc("uint8", 1),
    FMT.R8_SNORM: _ChanDesc("snorm8", 1),
    FMT.R8_SINT: _ChanDesc("sint8", 1),
    FMT.A8_UNORM: _ChanDesc("unorm8", 1, order=(3,)),
    FMT.B8G8R8A8_UNORM: _ChanDesc("unorm8", 4, order=(2, 1, 0, 3)),
    FMT.B8G8R8A8_UNORM_SRGB: _ChanDesc("unorm8", 4, order=(2, 1, 0, 3)),
    FMT.B8G8R8X8_UNORM: _ChanDesc("unorm8", 4, order=(2, 1, 0, None)),
    FMT.B8G8R8X8_UNORM_SRGB: _ChanDesc("unorm8", 4, order=(2, 1, 0, None)),
}

# element kind -> (bytes, signed, decode)
_KIND_BYTES = {"f32": 4, "uint32": 4, "sint32": 4, "f16": 2, "unorm16": 2,
               "uint16": 2, "snorm16": 2, "sint16": 2, "unorm8": 1,
               "uint8": 1, "snorm8": 1, "sint8": 1}


def _decode_elems(raw: torch.Tensor, kind: str, n: int) -> torch.Tensor:
    """flat u8 -> [N, n] f32 per element kind."""
    nb = _KIND_BYTES[kind]
    w = _words(raw, nb)
    if kind == "f32":
        f = _bits_f32(w)
    elif kind == "f16":
        f = _half_to_f32(w)
    elif kind.startswith("unorm"):
        f = _unorm_decode(w, 8 * nb)
    elif kind.startswith("snorm"):
        f = _snorm_decode(_sign_extend(w, 8 * nb), 8 * nb)
    elif kind.startswith("sint"):
        f = _sign_extend(w, 8 * nb).to(torch.float32)
    else:  # uint
        f = w.to(torch.float32)
    return f.reshape(-1, n)


def _encode_elems(vals: torch.Tensor, kind: str) -> torch.Tensor:
    """[N, n] f32 -> flat u8 per element kind."""
    flat = vals.reshape(-1)
    if kind == "f32":
        return flat.contiguous().view(torch.uint8).reshape(-1)
    if kind == "uint32":
        w = _sat(flat.clamp(0, 4294967040.0), 0, 4294967295)
    elif kind == "sint32":
        w = _sat(flat.clamp(-2147483648.0, 2147483520.0),
                 -2147483648, 2147483647)
    elif kind == "f16":
        w = _f32_to_half(flat)
    elif kind == "unorm16":
        w = _round_unorm(flat, 65535.0)
    elif kind == "uint16":
        w = _sat(flat.clamp(0, 65535), 0, 65535)
    elif kind == "snorm16":
        w = _round_snorm(flat, 32767.0)
    elif kind == "sint16":
        w = _sat(flat.clamp(-32768, 32767), -2147483648, 2147483647)
    elif kind == "unorm8":
        w = _round_unorm(flat, 255.0)
    elif kind == "uint8":
        w = _sat(flat.clamp(0, 255), 0, 255)
    elif kind == "snorm8":
        w = _round_snorm(flat, 127.0)
    elif kind == "sint8":
        w = _sat(flat.clamp(-128, 127), -2147483648, 2147483647)
    else:
        raise ValueError(kind)
    return _word_bytes(w, _KIND_BYTES[kind])


# packed bitfield formats: word bits, per-RGBA (shift, bits, scale-kind)
# scale-kind: 'unorm' (v/max), 'one' (value as-is 0/1), 'uint'
_BITFIELD_FORMATS: dict[DXGIFormat, tuple] = {
    # fmt: (word_bits, [(dest_chan, shift, bits, kind)], default_alpha)
    FMT.B5G6R5_UNORM: (16, [(2, 0, 5, "unorm"), (1, 5, 6, "unorm"),
                            (0, 11, 5, "unorm")], 1.0),
    FMT.B5G5R5A1_UNORM: (16, [(2, 0, 5, "unorm"), (1, 5, 5, "unorm"),
                              (0, 10, 5, "unorm"), (3, 15, 1, "one")], None),
    FMT.B4G4R4A4_UNORM: (16, [(2, 0, 4, "unorm"), (1, 4, 4, "unorm"),
                              (0, 8, 4, "unorm"), (3, 12, 4, "unorm")], None),
    FMT.A4B4G4R4_UNORM: (16, [(3, 0, 4, "unorm"), (2, 4, 4, "unorm"),
                              (1, 8, 4, "unorm"), (0, 12, 4, "unorm")], None),
    FMT.XBOX_R4G4_UNORM: (8, [(0, 0, 4, "unorm"), (1, 4, 4, "unorm")], 1.0),
    FMT.R10G10B10A2_UNORM: (32, [(0, 0, 10, "unorm"), (1, 10, 10, "unorm"),
                                 (2, 20, 10, "unorm"), (3, 30, 2, "unorm")], None),
    FMT.R10G10B10A2_UINT: (32, [(0, 0, 10, "uint"), (1, 10, 10, "uint"),
                                (2, 20, 10, "uint"), (3, 30, 2, "uint")], None),
}


def is_packable(fmt: DXGIFormat) -> bool:
    """True if this format is supported by unpack()/pack().

    Matches the reference LoadScanline coverage: everything valid except
    fully-typeless, compressed (use bc decoders), planar, palettized.
    """
    if fmt in _CHAN_FORMATS or fmt in _BITFIELD_FORMATS:
        return True
    return fmt in _SPECIAL_UNPACK


def _rgba(cols: list, count: int, like: torch.Tensor) -> torch.Tensor:
    """[count, 4] f32 from four columns, None -> 0, alpha None -> 1."""
    out = []
    for i, c in enumerate(cols):
        if c is None:
            c = torch.full((count,), 1.0 if i == 3 else 0.0,
                           dtype=torch.float32, device=like.device)
        out.append(c)
    return torch.stack(out, dim=-1)


_TORCH_DTYPES = {np.uint8: torch.uint8, np.float32: torch.float32}


def _tensor(data, dtype, device) -> torch.Tensor:
    """`data` as a tensor of numpy type `dtype`: a tensor stays on its
    device unless `device` names another; an array goes to `device`, else
    to CUDA."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=_TORCH_DTYPES[dtype])
    arr = np.ascontiguousarray(np.asarray(data, dtype=dtype))
    return torch.from_numpy(arr).to(resolve(device))


# ---------------------------------------------------------------------------
# main entry points
# ---------------------------------------------------------------------------

def unpack(fmt: DXGIFormat, data, count: int, device=None) -> torch.Tensor:
    """Decode `count` pixels of wire format `fmt` from flat u8 data: a
    tensor on its device, an array on `device` (CUDA unless named).
    Returns [count, 4] float32 RGBA. Mirrors LoadScanline
    (DirectXTexConvert.cpp:779)."""
    data = _tensor(data, np.uint8, device).reshape(-1)

    desc = _CHAN_FORMATS.get(fmt)
    if desc is not None:
        elems = _decode_elems(data, desc.kind, desc.channels)[:count]
        cols = [None, None, None, None]
        for i, dest in enumerate(desc.order[: desc.channels]):
            if dest is not None:
                cols[dest] = elems[:, i]
        return _rgba(cols, count, data)

    bf = _BITFIELD_FORMATS.get(fmt)
    if bf is not None:
        word_bits, fields, default_a = bf
        words = _words(data, word_bits // 8)[:count]
        cols = [None, None, None, None]
        if default_a is not None:
            cols[3] = torch.full((count,), default_a, dtype=torch.float32,
                                 device=data.device)
        for dest, shift, bits, kind in fields:
            v = (words >> shift) & ((1 << bits) - 1)
            cols[dest] = (_unorm_decode(v, bits) if kind == "unorm"
                          else v.to(torch.float32))
        return _rgba(cols, count, data)

    special = _SPECIAL_UNPACK.get(fmt)
    if special is not None:
        return special(data, count)

    raise ValueError(f"unpack: unsupported format {fmt!r}")


def pack(fmt: DXGIFormat, rgba, threshold: float = 0.5,
         device=None) -> torch.Tensor:
    """Encode [N,4] f32 RGBA to wire bytes, a flat u8 tensor on the input
    tensor's device (an array goes to `device`, CUDA unless named).
    Mirrors StoreScanline (DirectXTexConvert.cpp:1643). `threshold`
    controls 1-bit alpha."""
    rgba = _tensor(rgba, np.float32, device)
    count = rgba.shape[0]

    desc = _CHAN_FORMATS.get(fmt)
    if desc is not None:
        cols = []
        for dest in desc.order[: desc.channels]:
            if dest is None:          # X channel -> 1
                cols.append(torch.ones((count,), dtype=torch.float32,
                                       device=rgba.device))
            else:
                cols.append(rgba[:, dest])
        return _encode_elems(torch.stack(cols, dim=-1), desc.kind)

    bf = _BITFIELD_FORMATS.get(fmt)
    if bf is not None:
        word_bits, fields, _default_a = bf
        words = torch.zeros((count,), dtype=torch.int64, device=rgba.device)
        for dest, shift, bits, kind in fields:
            v = rgba[:, dest]
            if kind == "unorm":
                code = _round_unorm(v, float((1 << bits) - 1))
            elif kind == "one":
                code = (v > threshold).to(torch.int64)
            else:
                code = _sat(v.clamp(0, float((1 << bits) - 1)), 0,
                            4294967295)
            words = words | (code << shift)
        return _word_bytes(words, word_bits // 8)

    special = _SPECIAL_PACK.get(fmt)
    if special is not None:
        return special(rgba, threshold)

    raise ValueError(f"pack: unsupported format {fmt!r}")


# ---------------------------------------------------------------------------
# special formats
# ---------------------------------------------------------------------------

def _ten_ten_ten_two(w, chan) -> torch.Tensor:
    """Three 10-bit channels at bits 0, 10, 20 and a 2-bit UNORM alpha."""
    a = _unorm_decode((w >> 30) & 0x3, 2)
    return torch.stack([chan((w >> s) & 0x3FF) for s in (0, 10, 20)]
                       + [a], dim=-1)


def _pack_ten_ten_ten_two(rgba, chan) -> torch.Tensor:
    a = _round_unorm(rgba[:, 3], 3.0)
    w = (chan(rgba[:, 0]) | (chan(rgba[:, 1]) << 10)
         | (chan(rgba[:, 2]) << 20) | (a << 30))
    return _word_bytes(w, 4)


def _unpack_r11g11b10(data, count):
    w = _words(data, 4)[:count]
    r = _float_from_small(w & 0x7FF, 6, 5, 15)
    g = _float_from_small((w >> 11) & 0x7FF, 6, 5, 15)
    b = _float_from_small((w >> 22) & 0x3FF, 5, 5, 15)
    return torch.stack([r, g, b, torch.ones_like(r)], dim=-1)


def _pack_r11g11b10(rgba, threshold):
    r = _small_from_float(rgba[:, 0], 6, 5, 15)
    g = _small_from_float(rgba[:, 1], 6, 5, 15)
    b = _small_from_float(rgba[:, 2], 5, 5, 15)
    return _word_bytes(r | (g << 11) | (b << 22), 4)


def _unpack_9995e(data, count):
    rgb = _9995e_to_f32(_words(data, 4)[:count])
    return torch.cat([rgb, torch.ones_like(rgb[:, :1])], dim=-1)


def _pack_9995e(rgba, threshold):
    return _word_bytes(_f32_to_9995e(rgba[:, :3]), 4)


def _unpack_xr_bias(data, count):
    def chan(c):
        v = c - 0x180
        f = v.to(torch.float32) * _f32(1.0 / 510.0)
        return torch.where(v == 510, torch.ones_like(f), f)
    return _ten_ten_ten_two(_words(data, 4)[:count], chan)


def _pack_xr_bias(rgba, threshold):
    lo, hi = _f32(-0.7529412), _f32(1.2529412)

    def chan(v):
        code = torch.floor(v.clamp(lo, hi) * 510.0 + 0.5)
        return (_sat(code, -2147483648, 2147483647) + 0x180) & 0x3FF
    return _pack_ten_ten_ten_two(rgba, chan)


def _unpack_r10g10b10_snorm_a2(data, count):
    return _ten_ten_ten_two(_words(data, 4)[:count],
                            lambda c: _snorm_decode(_sign_extend(c, 10), 10))


def _pack_r10g10b10_snorm_a2(rgba, threshold):
    return _pack_ten_ten_ten_two(
        rgba, lambda v: _round_snorm(v, 511.0) & 0x3FF)


def _unpack_7e3(data, count):
    return _ten_ten_ten_two(_words(data, 4)[:count],
                            lambda c: _float_from_small(c, 7, 3, 3))


def _pack_7e3(rgba, threshold):
    return _pack_ten_ten_ten_two(rgba,
                                 lambda v: _small_from_float(v, 7, 3, 3))


def _unpack_6e4(data, count):
    return _ten_ten_ten_two(_words(data, 4)[:count],
                            lambda c: _float_from_small(c, 6, 4, 7))


def _pack_6e4(rgba, threshold):
    return _pack_ten_ten_ten_two(rgba,
                                 lambda v: _small_from_float(v, 6, 4, 7))


def _unpack_d24s8(data, count):
    w = _words(data, 4)[:count]
    d = _unorm_decode(w & 0xFFFFFF, 24)
    s = ((w >> 24) & 0xFF).to(torch.float32)
    return _rgba([d, s, None, None], count, data)


def _pack_d24s8(rgba, threshold):
    d = _round_unorm(rgba[:, 0], 16777215.0)
    s = _sat(rgba[:, 1].clamp(0, 255), 0, 4294967295)
    return _word_bytes(d | (s << 24), 4)


def _unpack_r24x8(data, count):
    w = _words(data, 4)[:count]
    return _rgba([_unorm_decode(w & 0xFFFFFF, 24), None, None, None], count,
                 data)


def _pack_r24x8(rgba, threshold):
    return _word_bytes(_round_unorm(rgba[:, 0], 16777215.0), 4)


def _unpack_x24g8(data, count):
    w = _words(data, 4)[:count]
    return _rgba([None, ((w >> 24) & 0xFF).to(torch.float32), None, None],
                 count, data)


def _pack_x24g8(rgba, threshold):
    s = _sat(rgba[:, 1].clamp(0, 255), 0, 4294967295)
    return _word_bytes(s << 24, 4)


def _pairs(data, count):
    pairs = data.reshape(-1, 8)[:count]
    d = _bits_f32(_words(pairs[:, 0:4].reshape(-1), 4))
    return d, pairs[:, 4].to(torch.float32)


def _unpack_d32s8x24(data, count):
    d, s = _pairs(data, count)
    return _rgba([d, s, None, None], count, data)


def _pack_d32s8x24(rgba, threshold):
    d = rgba[:, 0].contiguous().view(torch.uint8).reshape(-1, 4)
    s = _sat(rgba[:, 1].clamp(0, 255), 0, 255).to(torch.uint8)[:, None]
    zeros = torch.zeros_like(s)
    return torch.cat([d, s, zeros, zeros, zeros], dim=-1).reshape(-1)


def _unpack_r32x8x24(data, count):
    d, _ = _pairs(data, count)
    return _rgba([d, None, None, None], count, data)


def _unpack_x32g8x24(data, count):
    _, s = _pairs(data, count)
    return _rgba([None, s, None, None], count, data)


def _unpack_r1(data, count):
    shifts = torch.arange(7, -1, -1, device=data.device)
    bits = (data.to(torch.int64)[:, None] >> shifts) & 1
    vals = bits.to(torch.float32).reshape(-1)[:count]
    return _rgba([vals, None, None, None], count, data)


def _pack_r1(rgba, threshold):
    v = (rgba[:, 0] > 0.5).to(torch.int64)
    pad = (-v.shape[0]) % 8
    v = torch.nn.functional.pad(v, (0, pad)).reshape(-1, 8)
    shifts = torch.arange(7, -1, -1, device=v.device)
    return (v << shifts).sum(dim=-1).to(torch.uint8)


def _two_pixels(r, g0, g1, b, count):
    """Pixels (r, g0, b, 1), (r, g1, b, 1) per group, interleaved."""
    one = torch.ones_like(r)
    p0 = torch.stack([r, g0, b, one], dim=-1)
    p1 = torch.stack([r, g1, b, one], dim=-1)
    return torch.stack([p0, p1], dim=1).reshape(-1, 4)[:count]


def _unpack_rgbg(data, count):
    """R8G8_B8G8: each 4-byte group decodes 2 pixels (r,g0,b | r,g1,b)."""
    q = _unorm_decode(data.reshape(-1, 4), 8)
    return _two_pixels(q[:, 0], q[:, 1], q[:, 3], q[:, 2], count)


def _pair_codes(rgba):
    # r/b come from the first pixel of each pair (StoreScanline
    # DirectXTexConvert.cpp:2060-2077)
    pairs = rgba.reshape(-1, 2, 4)
    return tuple(_round_unorm(c, 255.0) for c in (
        pairs[:, 0, 0], pairs[:, 0, 1], pairs[:, 1, 1], pairs[:, 0, 2]))


def _pack_rgbg(rgba, threshold):
    r, g0, g1, b = _pair_codes(rgba)
    return _word_bytes(r | (g0 << 8) | (b << 16) | (g1 << 24), 4)


def _unpack_grgb(data, count):
    """G8R8_G8B8: bytes (g0, r, g1, b) -> pixels (r,g0,b),(r,g1,b)."""
    q = _unorm_decode(data.reshape(-1, 4), 8)
    return _two_pixels(q[:, 1], q[:, 0], q[:, 2], q[:, 3], count)


def _pack_grgb(rgba, threshold):
    r, g0, g1, b = _pair_codes(rgba)
    return _word_bytes(g0 | (r << 8) | (g1 << 16) | (b << 24), 4)


def _unpack_ayuv(data, count):
    q = data.reshape(-1, 4)[:count].to(torch.int64)
    v, u, y, a = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r, g, b = _yuv8_to_rgb(y, u, v)
    return torch.stack([r, g, b, _unorm_decode(a, 8)], dim=-1)


def _pack_ayuv(rgba, threshold):
    y, u, v = _rgb_to_yuv8(rgba[:, 0], rgba[:, 1], rgba[:, 2])
    a = _round_unorm(rgba[:, 3], 255.0)
    return _word_bytes(v | (u << 8) | (y << 16) | (a << 24), 4)


def _unpack_y410(data, count):
    w = _words(data, 4)[:count]
    u, y, v = w & 0x3FF, (w >> 10) & 0x3FF, (w >> 20) & 0x3FF
    r, g, b = _yuv10_to_rgb(y, u, v)
    return torch.stack([r, g, b, _unorm_decode((w >> 30) & 0x3, 2)], dim=-1)


def _pack_y410(rgba, threshold):
    y, u, v = _rgb_to_yuv10(rgba[:, 0], rgba[:, 1], rgba[:, 2])
    a = _round_unorm(rgba[:, 3], 3.0)
    return _word_bytes(u | (y << 10) | (v << 20) | (a << 30), 4)


def _unpack_y416(data, count):
    q = _words(data, 2).reshape(-1, 4)[:count]
    u, y, v, a = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r, g, b = _yuv16_to_rgb(y, u, v)
    return torch.stack([r, g, b, _unorm_decode(a, 16)], dim=-1)


def _pack_y416(rgba, threshold):
    y, u, v = _rgb_to_yuv16(rgba[:, 0], rgba[:, 1], rgba[:, 2])
    a = _round_unorm(rgba[:, 3], 65535.0)
    return _word_bytes(torch.stack([u, y, v, a], dim=-1).reshape(-1) & 0xFFFF,
                       2)


def _yuv_pairs(y0, u, y1, v, to_rgb, count):
    r0, g0, b0 = to_rgb(y0, u, v)
    r1, g1, b1 = to_rgb(y1, u, v)
    one = torch.ones_like(r0)
    p0 = torch.stack([r0, g0, b0, one], dim=-1)
    p1 = torch.stack([r1, g1, b1, one], dim=-1)
    return torch.stack([p0, p1], dim=1).reshape(-1, 4)[:count]


def _yuv_of_pairs(rgba, to_yuv):
    pairs = rgba.reshape(-1, 2, 4)
    y0, u0, v0 = to_yuv(pairs[:, 0, 0], pairs[:, 0, 1], pairs[:, 0, 2])
    y1, u1, v1 = to_yuv(pairs[:, 1, 0], pairs[:, 1, 1], pairs[:, 1, 2])
    return y0, (u0 + u1) >> 1, y1, (v0 + v1) >> 1


def _unpack_yuy2(data, count):
    q = data.reshape(-1, 4)[:count // 2 + count % 2].to(torch.int64)
    return _yuv_pairs(q[:, 0], q[:, 1], q[:, 2], q[:, 3], _yuv8_to_rgb,
                      count)


def _pack_yuy2(rgba, threshold):
    y0, u, y1, v = _yuv_of_pairs(rgba, _rgb_to_yuv8)
    return _word_bytes(y0 | (u << 8) | (y1 << 16) | (v << 24), 4)


def _unpack_y210(data, count):
    q = _words(data, 2).reshape(-1, 4)[:count // 2 + count % 2] >> 6
    return _yuv_pairs(q[:, 0], q[:, 1], q[:, 2], q[:, 3], _yuv10_to_rgb,
                      count)


def _pack_y210(rgba, threshold):
    y0, u, y1, v = _yuv_of_pairs(rgba, _rgb_to_yuv10)
    out = torch.stack([y0 << 6, u << 6, y1 << 6, v << 6], dim=-1)
    return _word_bytes(out.reshape(-1) & 0xFFFF, 2)


def _unpack_y216(data, count):
    q = _words(data, 2).reshape(-1, 4)[:count // 2 + count % 2]
    return _yuv_pairs(q[:, 0], q[:, 1], q[:, 2], q[:, 3], _yuv16_to_rgb,
                      count)


def _pack_y216(rgba, threshold):
    y0, u, y1, v = _yuv_of_pairs(rgba, _rgb_to_yuv16)
    out = torch.stack([y0, u, y1, v], dim=-1)
    return _word_bytes(out.reshape(-1) & 0xFFFF, 2)


_SPECIAL_UNPACK = {
    FMT.R11G11B10_FLOAT: _unpack_r11g11b10,
    FMT.R9G9B9E5_SHAREDEXP: _unpack_9995e,
    FMT.R10G10B10_XR_BIAS_A2_UNORM: _unpack_xr_bias,
    FMT.XBOX_R10G10B10_SNORM_A2_UNORM: _unpack_r10g10b10_snorm_a2,
    FMT.XBOX_R10G10B10_7E3_A2_FLOAT: _unpack_7e3,
    FMT.XBOX_R10G10B10_6E4_A2_FLOAT: _unpack_6e4,
    FMT.D24_UNORM_S8_UINT: _unpack_d24s8,
    FMT.R24_UNORM_X8_TYPELESS: _unpack_r24x8,
    FMT.X24_TYPELESS_G8_UINT: _unpack_x24g8,
    FMT.D32_FLOAT_S8X24_UINT: _unpack_d32s8x24,
    FMT.R32_FLOAT_X8X24_TYPELESS: _unpack_r32x8x24,
    FMT.X32_TYPELESS_G8X24_UINT: _unpack_x32g8x24,
    FMT.R1_UNORM: _unpack_r1,
    FMT.R8G8_B8G8_UNORM: _unpack_rgbg,
    FMT.G8R8_G8B8_UNORM: _unpack_grgb,
    FMT.AYUV: _unpack_ayuv,
    FMT.Y410: _unpack_y410,
    FMT.Y416: _unpack_y416,
    FMT.YUY2: _unpack_yuy2,
    FMT.Y210: _unpack_y210,
    FMT.Y216: _unpack_y216,
}

_SPECIAL_PACK = {
    FMT.R11G11B10_FLOAT: _pack_r11g11b10,
    FMT.R9G9B9E5_SHAREDEXP: _pack_9995e,
    FMT.R10G10B10_XR_BIAS_A2_UNORM: _pack_xr_bias,
    FMT.XBOX_R10G10B10_SNORM_A2_UNORM: _pack_r10g10b10_snorm_a2,
    FMT.XBOX_R10G10B10_7E3_A2_FLOAT: _pack_7e3,
    FMT.XBOX_R10G10B10_6E4_A2_FLOAT: _pack_6e4,
    FMT.D24_UNORM_S8_UINT: _pack_d24s8,
    FMT.R24_UNORM_X8_TYPELESS: _pack_r24x8,
    FMT.X24_TYPELESS_G8_UINT: _pack_x24g8,
    FMT.D32_FLOAT_S8X24_UINT: _pack_d32s8x24,
    FMT.R1_UNORM: _pack_r1,
    FMT.R8G8_B8G8_UNORM: _pack_rgbg,
    FMT.G8R8_G8B8_UNORM: _pack_grgb,
    FMT.AYUV: _pack_ayuv,
    FMT.Y410: _pack_y410,
    FMT.Y416: _pack_y416,
    FMT.YUY2: _pack_yuy2,
    FMT.Y210: _pack_y210,
    FMT.Y216: _pack_y216,
}


# ---------------------------------------------------------------------------
# image-level wrappers
# ---------------------------------------------------------------------------

def unpack_image(fmt: DXGIFormat, data, width: int, height: int,
                 device=None) -> torch.Tensor:
    """Flat wire bytes (no row padding) -> [H, W, 4] f32."""
    return unpack(fmt, data, width * height, device).reshape(height, width,
                                                             4)


def pack_image(fmt: DXGIFormat, rgba, threshold: float = 0.5,
               device=None) -> torch.Tensor:
    """[H, W, 4] f32 -> flat wire bytes (tightly packed rows)."""
    h, w, _ = rgba.shape
    return pack(fmt, rgba.reshape(h * w, 4), threshold, device)


# ---------------------------------------------------------------------------
# planar YUV image decode (ConvertToSinglePlane support)
# ---------------------------------------------------------------------------

def planar_to_single(fmt: DXGIFormat) -> DXGIFormat:
    """PlanarToSingle (DirectXTexConvert.cpp:4916)."""
    if fmt in (FMT.NV12, FMT.NV11):
        return FMT.YUY2
    if fmt == FMT.P010:
        return FMT.Y210
    if fmt == FMT.P016:
        return FMT.Y216
    return FMT.UNKNOWN


def _chroma(uv: torch.Tensor, rows: int, cols: int, height: int,
            width: int):
    """[h', w', 2] chroma -> two [height, width] planes, each sample
    repeated over the luma it covers."""
    out = []
    for i in range(2):
        c = uv[..., i]
        if rows > 1:
            c = c.repeat_interleave(rows, dim=0)
        c = c.repeat_interleave(cols, dim=1)
        out.append(c[:height, :width])
    return out


def unpack_planar_image(fmt: DXGIFormat, data, width: int, height: int,
                        device=None) -> torch.Tensor:
    """Planar wire bytes -> [H, W, 4] f32 RGBA.

    Equivalent to ConvertToSinglePlane (DirectXTexConvert.cpp:5411) followed
    by decoding the packed 4:2:2 result: the 4:2:0/4:1:1 chroma is duplicated
    across the covered luma samples (CONVERT_420_TO_422 semantics).
    """
    data = _tensor(data, np.uint8, device).reshape(-1)
    n = width * height
    if fmt in (FMT.NV12, FMT.OPAQUE_420, FMT.NV11, FMT.P208):
        y = data[:n].reshape(height, width).to(torch.int64)
        if fmt == FMT.NV11:
            cw, ch, rows, cols = (width + 3) // 4, height, 1, 4
        elif fmt == FMT.P208:
            cw, ch, rows, cols = (width + 1) // 2, height, 1, 2
        else:
            cw, ch, rows, cols = (width + 1) // 2, height // 2, 2, 2
        uv = data[n:n + ch * cw * 2].reshape(ch, cw, 2).to(torch.int64)
        u, v = _chroma(uv, rows, cols, height, width)
        r, g, b = _yuv8_to_rgb(y, u, v)
        return torch.stack([r, g, b, torch.ones_like(r)], dim=-1)
    if fmt in (FMT.P010, FMT.P016):
        w16 = _words(data, 2)
        y = w16[:n].reshape(height, width)
        cw = (width + 1) // 2
        uv = w16[n:n + (height // 2) * cw * 2].reshape(height // 2, cw, 2)
        u, v = _chroma(uv, 2, 2, height, width)
        if fmt == FMT.P010:
            r, g, b = _yuv10_to_rgb(y >> 6, u >> 6, v >> 6)
        else:
            r, g, b = _yuv16_to_rgb(y, u, v)
        return torch.stack([r, g, b, torch.ones_like(r)], dim=-1)
    raise ValueError(f"unpack_planar_image: unsupported format {fmt!r}")
