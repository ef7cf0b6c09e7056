"""BC6H codec on torch tensors — decode, the shared-fit default search and
the mid / maxq winner-refine tiers.

The PyTorch counterpart of the BC6H half of directxtex_tpu/bc/bc67.py
(reference: BC6HBC7.cpp). Layouts follow the JAX package: F16-int pixels
are lane-major [16, 3, NB] int32 inside the codec and channel-major
[48, NB] int32 (row = channel * 16 + pixel) at the kernel edges; packed
blocks are 4 u32 words per block, handed across function edges as int32
bit patterns and computed on as int64 holding the u32 value (torch has no
uint32 shifts on the CPU).

The wrappers of the CUDA kernels (cuda_kernels.py, csrc/) are
`bc6h_decode_words` (K4), `bc6h_search_words` (K5), `bc6h_refine_words`
(K6), `bc6h_1region_words` (K10), `bc6h_shape_picks` (the shape ranking)
and `bc6h_2region_words` (K11). Each takes a CUDA tensor to its kernel
and a CPU tensor to its plain version; nothing else decides. The plain
versions take every 16-pixel and per-channel sum in index order, as the
kernels do, so kernel and twin agree bit for bit wherever the arithmetic
allows (the kernels build with --fmad=false).

Search: the JAX package's shared-fit path (BC6H_SHARED_FIT, keep-better
off): the four one-region rows 10-13 off one precision-free trajectory,
then the top 4 of the 32 two-region shapes (off-axis ranking at
axis_w=0), one trajectory per candidate, a quantize + rescore (+ one
quantized refit below 11 bits) per precision group, and a fold in the
order rows 10-13, then rows 0-9 with candidates in rank order, strict `<`.
With BC6H_SHARED_FIT off (read at call time, as the JAX package does),
every (row, candidate) gets the full quantized-domain evaluation instead
(_bc6h_eval_candidate, BC6H_REFIT_ROUNDS LS rounds), run as K10 (rows
10-13), the shape ranking, one K11 launch per precision group and a
strict-`<` fold over their results (_search_unshared).
"""

from __future__ import annotations

import functools

import torch

from . import cuda_kernels
from .bc67 import (BC7_SHAPE_CANDIDATES, _check_words, _div, _gb_t,
                   _index_layout, _on_cuda, _pal_weight, _pal_weight_f,
                   _put_dynamic, _put_static, _read_indices,
                   _shape_estimates_table, _sum0, _tables, _top4_merge_plain,
                   _top_k_shapes, _words_i32, _words_i64)
from .bc67_tables import BC6H_DESC, BC6H_MODE_INFO, BC6H_MODE_TO_INFO

__all__ = ["decode_bc6h", "encode_bc6h", "refine_bc6h_words",
           "bc6h_decode_words", "bc6h_search_words", "bc6h_refine_words",
           "bc6h_1region_words", "bc6h_shape_picks", "bc6h_2region_words"]

_F16MAX = 0x7BFF

# Shipped settings of the JAX package's default search (bc67.py:2064-2115),
# pinned equal to it by tests/test_torch_tables.py with the ladders and
# flags below: shared-fit LS rounds,
# the precision below which a group gets a quantized refit round, and the
# LS magnitude cap in F16-int units.
BC6H_SHARED_ROUNDS = 3
BC6H_GROUP_REFIT_MINPREC = 11
BC6H_LS_MAG_CAP = 1024.0
# the search's setting (bc67.py:2076): one shared fit trajectory per
# region family (K5), or the full evaluation per (row, candidate) with
# BC6H_REFIT_ROUNDS quantized LS rounds (bc67.py:2064; K10, K11)
BC6H_SHARED_FIT = True
BC6H_REFIT_ROUNDS = 2
# the float keep-better guard of the shared trajectory (bc67.py:2093),
# off in the JAX package, which measured bitwise-identical words without
# it on every HDR probe content (bc67.py:2084-2092). The port does not
# implement it: encode_bc6h raises with it on.
BC6H_SHARED_KEEPBETTER = False

# winner-refine ladders (rounds, deltas), bc67.py:2918-2932
BC6H_LADDER_LIGHT = (1, (1,))
BC6H_LADDER_FULL = (2, (16, 4, 1))
BC6H_LADDER_MID = (1, (4, 1))
BC6H_LADDER_MAXQ = (2, (32, 16, 8, 4, 2, 1))

# encode flags (bc67.py:383-384)
_BC7_MAXQUALITY = 0x200000   # TEX_COMPRESS_BC7_MAXQUALITY: the maxq tier
_BC6H_MID = 0x400000         # the mid tier (texconv -bc b)


def _shl(x, n):
    """x << n for a per-block shift tensor n (x a python int or tensor)."""
    if not torch.is_tensor(x):
        x = torch.full_like(n, x)
    return torch.bitwise_left_shift(x, n)


@functools.lru_cache(maxsize=None)
def _header_runs(row: int):
    """Contiguous (field id, field bit, position, length) runs of the
    row's header descriptor (BC6H_DESC), NA bits skipped."""
    hb = 82 if BC6H_MODE_INFO[row][1] else 65
    desc = BC6H_DESC[row]
    runs = []
    pos = 0
    while pos < hb:
        fid, fbit = int(desc[pos, 0]), int(desc[pos, 1])
        ln = 1
        while (pos + ln < hb and int(desc[pos + ln, 0]) == fid
               and int(desc[pos + ln, 1]) == fbit + ln):
            ln += 1
        if fid:
            runs.append((fid, fbit, pos, ln))
        pos += ln
    return tuple(runs)


# ---------------------------------------------------------------------------
# decode (bc67.py:2118-2333)
# ---------------------------------------------------------------------------

def _bc6h_unquantize(comp, bits: int, signed: bool):
    """D3DX_BC6H::Unquantize (BC6HBC7.cpp:1892)."""
    if signed:
        if bits >= 16:
            return comp
        s = comp < 0
        c = comp.abs()
        unq = torch.where(c == 0, 0,
                          torch.where(c >= (1 << (bits - 1)) - 1, 0x7FFF,
                                      ((c << 15) + 0x4000) >> (bits - 1)))
        return torch.where(s, -unq, unq)
    if bits >= 15:
        return comp
    return torch.where(comp == 0, 0,
                       torch.where(comp == (1 << bits) - 1, 0xFFFF,
                                   ((comp << 16) + 0x8000) >> bits))


def _bc6h_finish_unquantize(comp, signed: bool):
    """FinishUnquantize (BC6HBC7.cpp:1930): scale by 31/32 (S) or 31/64."""
    if signed:
        return torch.where(comp < 0, -(((-comp) * 31) >> 5), (comp * 31) >> 5)
    return (comp * 31) >> 6


def _bc6h_int_to_half_bits(comp, signed: bool):
    """INT2F16 (BC6HBC7.cpp:559): sign-magnitude int -> half bit pattern."""
    if signed:
        mag = comp.abs() & 0x7FFF
        return torch.where(comp < 0, mag | 0x8000, mag)
    return comp & 0xFFFF


def _sext(v, bits: int):
    """Sign-extend the low `bits` bits of v."""
    v = v & ((1 << bits) - 1)
    return torch.where(v >= (1 << (bits - 1)), v - (1 << bits), v)


def _bc6h_unpack_endpoints(words, row: int, signed: bool):
    """Shape + absolute quantized endpoints of every block read as mode row
    `row` (Decode :1719-1736 + TransformInverse :1153, before Unquantize).
    words [4, NB] int64 -> (shape [NB], {(region, end, ch): [NB]} int64)."""
    _, partitions, transformed, _, precW, precX, precY, precZ = \
        BC6H_MODE_INFO[row]
    zero = torch.zeros_like(words[0])
    fields = {fid: zero for fid in range(2, 15)}
    for fid, fbit, pos, ln in _header_runs(row):
        if fid >= 2:
            fields[fid] = fields[fid] | (_gb_t(words, pos, ln) << fbit)

    e = {}
    for ch, base in ((0, 3), (1, 7), (2, 11)):
        e[(0, 0, ch)] = fields[base + 0]
        e[(0, 1, ch)] = fields[base + 1]
        e[(1, 0, ch)] = fields[base + 2]
        e[(1, 1, ch)] = fields[base + 3]
    if signed:
        for ch in range(3):
            e[(0, 0, ch)] = _sext(e[(0, 0, ch)], precW[ch])
    if signed or transformed:
        for ch in range(3):
            e[(0, 1, ch)] = _sext(e[(0, 1, ch)], precX[ch])
            if partitions:
                e[(1, 0, ch)] = _sext(e[(1, 0, ch)], precY[ch])
                e[(1, 1, ch)] = _sext(e[(1, 1, ch)], precZ[ch])
    if transformed:
        for ch in range(3):
            mask = (1 << precW[ch]) - 1
            for key in ((0, 1, ch), (1, 0, ch), (1, 1, ch)):
                v = (e[key] + e[(0, 0, ch)]) & mask
                e[key] = _sext(v, precW[ch]) if signed else v
    return fields[2], e


def _decode_bc6h_mode_rows(words, row: int, signed: bool):
    """Decode ALL blocks as mode row `row`. words [4, NB] int64 ->
    [16][3] lists of [NB] int64 half-bit rows."""
    _, partitions, _, iprec, precW, _, _, _ = BC6H_MODE_INFO[row]
    hb = 82 if partitions else 65
    shape, e = _bc6h_unpack_endpoints(words, row, signed)
    u = {k: _bc6h_unquantize(v, precW[k[2]], signed) for k, v in e.items()}
    a2 = pp = None
    if partitions:
        tabs = _tables(words.device)
        pp = tabs["pp", 1][shape]
        a2 = tabs["pa", 1][shape] & 0xF
    idx, _ = _read_indices(words, hb, iprec, a2, None)
    out_px = []
    for i in range(16):
        w = _pal_weight(idx[i], 1 << iprec)
        px = []
        for ch in range(3):
            if partitions:
                r0 = ((pp >> (2 * i)) & 1) == 0
                e0 = torch.where(r0, u[(0, 0, ch)], u[(1, 0, ch)])
                e1 = torch.where(r0, u[(0, 1, ch)], u[(1, 1, ch)])
            else:
                e0, e1 = u[(0, 0, ch)], u[(0, 1, ch)]
            comp = (e0 * (64 - w) + e1 * w + 32) >> 6
            comp = _bc6h_finish_unquantize(comp, signed)
            px.append(_bc6h_int_to_half_bits(comp, signed))
        out_px.append(px)
    return out_px


def _mode_rows(words):
    """Mode row per block (ms_aModeToInfo :1069); -1 for reserved modes.
    words [4, NB] int64."""
    b5 = words[0] & 0x1F
    header_mode = torch.where((b5 & 3) < 2, b5 & 3, b5)
    tab = torch.tensor(BC6H_MODE_TO_INFO, dtype=torch.int64,
                       device=words.device)
    return tab[header_mode]


def _bc6h_decode_plain(words_i32: torch.Tensor, signed: bool) -> torch.Tensor:
    """Plain twin of K4: words [4, NB] int32 -> half bits [48, NB] int32
    (row = pixel * 3 + channel); reserved modes decode to 0."""
    words = _words_i64(words_i32)
    rowv = _mode_rows(words)
    out = torch.zeros((16, 3, words.shape[1]), dtype=torch.int64,
                      device=words.device)
    for r in range(14):
        res = torch.stack([torch.stack(px) for px in
                           _decode_bc6h_mode_rows(words, r, signed)])
        out = torch.where(rowv[None, None, :] == r, res, out)
    return out.reshape(48, -1).to(torch.int32)


def bc6h_decode_words(words: torch.Tensor, signed: bool) -> torch.Tensor:
    """K4 wrapper: words [4, NB] int32 (u32 bit patterns) -> half bits
    [48, NB] int32. A CUDA tensor launches the kernel, a CPU tensor runs
    the plain twin."""
    _check_words(words)
    if _on_cuda(words):
        return cuda_kernels.bc6h_decode(words, signed)
    return _bc6h_decode_plain(words, signed)


def _half_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """int32 half bit patterns (0..0xFFFF) -> f32 values."""
    b16 = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16)
    return b16.view(torch.float16).to(torch.float32)


def _check_blocks_u8(blocks: torch.Tensor) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 \
            or blocks.shape[1] != 16:
        raise ValueError(f"blocks must be [NB, 16] uint8, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")


def _bc6h_decode_f32_plain(blocks: torch.Tensor, signed: bool
                           ) -> torch.Tensor:
    """Plain twin of K4's f32 epilogue: [NB, 16] u8 -> [NB, 16, 4] f32,
    the half-bits twin followed by decode's conversion (alpha 1)."""
    words = blocks.contiguous().view(torch.int32).t().contiguous()
    rgb = _half_bits_to_f32(_bc6h_decode_plain(words, signed))
    rgb = rgb.reshape(16, 3, -1).permute(2, 0, 1)
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def decode_bc6h(blocks: torch.Tensor, signed: bool) -> torch.Tensor:
    """[NB, 16] u8 -> [NB, 16, 4] f32 (D3DXDecodeBC6HU/S, bit-exact);
    alpha 1, reserved modes black. A CUDA tensor is one K4 launch that
    reads the packed blocks and writes the f32 texels; a CPU tensor runs
    the plain twin."""
    _check_blocks_u8(blocks)
    if _on_cuda(blocks):
        return cuda_kernels.bc6h_decode_blocks(blocks, signed)
    return _bc6h_decode_f32_plain(blocks, signed)


# ---------------------------------------------------------------------------
# encode primitives (bc67.py:2348-2715)
# ---------------------------------------------------------------------------

def _f16_to_int(rgb: torch.Tensor, signed: bool) -> torch.Tensor:
    """float -> sign-magnitude F16-int (INTColor::F16ToINT :534): f32 ->
    f16 round-to-nearest-even, magnitude clamped to F16MAX, negatives 0
    when unsigned. Any shape; int32 out."""
    h = rgb.to(torch.float32).to(torch.float16).view(torch.int16)
    h = h.to(torch.int32) & 0xFFFF
    mag = (h & 0x7FFF).clamp(max=_F16MAX)
    neg = (h & 0x8000) != 0
    if signed:
        return torch.where(neg, -mag, mag)
    return torch.where(neg, 0, mag)


def _bc6h_quantize(v, prec: int, signed: bool):
    """D3DX_BC6H::Quantize (BC6HBC7.cpp:1864) on non-negative magnitudes."""
    if signed:
        a = v.abs()
        q = a if prec >= 16 else torch.div(a << (prec - 1), _F16MAX + 1,
                                           rounding_mode="floor")
        return torch.where(v < 0, -q, q)
    return v if prec >= 15 else torch.div(v << prec, _F16MAX + 1,
                                          rounding_mode="floor")


def _quantize_f(ef, precW, signed: bool):
    """Float endpoints [3, NB] -> quantized at precW (round half even)."""
    return torch.stack([_bc6h_quantize(
        torch.round(ef[c]).to(torch.int32), precW[c], signed)
        for c in range(3)])


def _nbits_fit(v, prec: int, is_signed_field: bool):
    """True where v fits a prec-bit (two's complement if signed) field."""
    if is_signed_field:
        return (v >= -(1 << (prec - 1))) & (v <= (1 << (prec - 1)) - 1)
    return (v >= 0) & (v <= (1 << prec) - 1)


def _project_snap(p64, K: int):
    """Nearest palette index from the 64ths projection p64 (int32)."""
    kf = torch.round(p64 * ((K - 1) / 64.0)).to(torch.int32).clamp(0, K - 1)
    wk = _pal_weight(kf, K)
    wkp = _pal_weight((kf + 1).clamp(max=K - 1), K)
    wkm = _pal_weight((kf - 1).clamp(min=0), K)
    up = (kf < K - 1) & (2.0 * p64 > (wk + wkp).to(torch.float32))
    dn = (kf > 0) & (2.0 * p64 < (wk + wkm).to(torch.float32))
    return torch.where(up, kf + 1, torch.where(dn, kf - 1, kf))


def _palette_err_u(px3, mask, u0, u1, iprec: int, signed: bool):
    """Unquantized endpoints u0/u1 (3 rows [NB]) -> indices [16, NB] and
    the masked error [NB] against the finished palette (the body of
    _bc6h_palette_err_t / _bc6h_palette_err_dyn). px3: 3 x [16, NB]."""
    K = 1 << iprec
    f0 = [_bc6h_finish_unquantize(u0[c], signed).to(torch.float32)
          for c in range(3)]
    f1 = [_bc6h_finish_unquantize(u1[c], signed).to(torch.float32)
          for c in range(3)]
    dot = torch.zeros(px3[0].shape, dtype=torch.float32,
                      device=px3[0].device)
    span = torch.zeros_like(f0[0])
    for c in range(3):
        e = f1[c] - f0[c]
        dot = dot + (px3[c].to(torch.float32) - f0[c][None, :]) * e[None, :]
        span = span + e * e
    p64 = (dot * _div(64.0, torch.where(span > 0, span, 1.0))[None, :]) \
        .clamp(0.0, 64.0)
    idx = _project_snap(p64, K)
    wk = _pal_weight(idx, K)
    best = torch.zeros_like(dot)
    for c in range(3):
        pal = (u0[c][None, :] * (64 - wk) + u1[c][None, :] * wk + 32) >> 6
        pal = _bc6h_finish_unquantize(pal, signed)
        dd = (px3[c] - pal).to(torch.float32)
        best = best + dd * dd
    return idx, _sum0(torch.where(mask, best, 0.0))


def _px3(px_int):
    return tuple(px_int[:, c, :] for c in range(3))


def _bc6h_palette_err_t(px_int, mask, q0, q1, precW, iprec, signed):
    """Quantized endpoints -> palette -> indices + masked error
    (bc67.py:2379). px_int [16, 3, NB]; q0/q1 [3, NB]; mask [16, NB]."""
    u0 = [_bc6h_unquantize(q0[c], precW[c], signed) for c in range(3)]
    u1 = [_bc6h_unquantize(q1[c], precW[c], signed) for c in range(3)]
    return _palette_err_u(_px3(px_int), mask, u0, u1, iprec, signed)


def _bc6h_palette_err_f(px_f, e0, e1, iprec: int):
    """Float-endpoint palette assignment, the precision-free step of the
    shared fit (bc67.py:2425 with score=False: keep-better is off).
    px_f [16, 3, NB]; e0/e1 [3, NB]. Returns integer-valued f32 idx."""
    K = 1 << iprec
    dot = torch.zeros_like(px_f[:, 0, :])
    span = torch.zeros_like(e0[0])
    for c in range(3):
        e = e1[c] - e0[c]
        dot = dot + (px_f[:, c, :] - e0[c][None, :]) * e[None, :]
        span = span + e * e
    p64 = (dot * _div(64.0, torch.where(span > 0, span, 1.0))[None, :]) \
        .clamp(0.0, 64.0)
    kf = torch.round(p64 * ((K - 1) / 64.0)).clamp(0.0, K - 1.0)
    wk = _pal_weight_f(kf, K)
    wkp = _pal_weight_f((kf + 1.0).clamp(max=K - 1.0), K)
    wkm = _pal_weight_f((kf - 1.0).clamp(min=0.0), K)
    up = (kf < K - 1) & (2.0 * p64 > wk + wkp)
    dn = (kf > 0) & (2.0 * p64 < wk + wkm)
    return torch.where(up, kf + 1.0, torch.where(dn, kf - 1.0, kf))


def _mag_cap(px_f, mask):
    """Per-channel LS magnitude cap [3, NB] (BC6H_LS_MAG_CAP)."""
    m3 = mask[:, None, :]
    mi = torch.where(m3, px_f, 1e9).amin(dim=0)
    ma = torch.where(m3, px_f, -1e9).amax(dim=0)
    return mi, ma, torch.maximum(mi.abs(), ma.abs()) + BC6H_LS_MAG_CAP


def _bc6h_ls_refit(px_f, x, mask, e0, e1, cap, signed: bool):
    """Least-squares endpoint refit at per-pixel weights x = w/64, clipped
    to the F16-int range and the magnitude cap; e0/e1 pass through where
    the system is singular (bc67.py:2489-2513)."""
    lim = float(_F16MAX)
    lo = -lim if signed else 0.0
    mm = mask.to(torch.float32)
    a = (1.0 - x) * mm
    b = x * mm
    A = _sum0(a * a)
    B = _sum0(a * b)
    C = _sum0(b * b)
    det = A * C - B * B
    ok = det.abs() > 1e-6
    inv = _div(1.0, torch.where(ok, det, 1.0))
    rows0, rows1 = [], []
    for c in range(3):
        r0 = _sum0(a * px_f[:, c, :])
        r1 = _sum0(b * px_f[:, c, :])
        lo_c = torch.clamp(-cap[c], min=lo)
        hi_c = torch.clamp(cap[c], max=lim)
        n0 = torch.minimum(torch.maximum((C * r0 - B * r1) * inv, lo_c), hi_c)
        n1 = torch.minimum(torch.maximum((A * r1 - B * r0) * inv, lo_c), hi_c)
        rows0.append(torch.where(ok, n0, e0[c]))
        rows1.append(torch.where(ok, n1, e1[c]))
    return torch.stack(rows0), torch.stack(rows1)


def _bc6h_shared_fit(px_f, mask_list, iprec: int, signed: bool):
    """One precision-free fit trajectory per subset (bc67.py:2464): min/max
    endpoints, float-palette assignment, BC6H_SHARED_ROUNDS LS rounds.
    Returns per-subset (e0, e1) [3, NB] f32."""
    out = []
    for mask in mask_list:
        mi, ma, cap = _mag_cap(px_f, mask)
        idx_b = _bc6h_palette_err_f(px_f, mi, ma, iprec)
        e0f, e1f = mi, ma
        for r in range(BC6H_SHARED_ROUNDS):
            x = _pal_weight_f(idx_b, 1 << iprec) * (1 / 64)
            e0f, e1f = _bc6h_ls_refit(px_f, x, mask, e0f, e1f, cap, signed)
            if r < BC6H_SHARED_ROUNDS - 1:
                idx_b = _bc6h_palette_err_f(px_f, e0f, e1f, iprec)
        out.append((e0f, e1f))
    return out


def _anchor_index(idx_full, anchor):
    if isinstance(anchor, int):
        return idx_full[anchor]
    return torch.gather(idx_full, 0, anchor[None, :].to(torch.int64))[0]


def _bc6h_group_rescore(px_int, mask_list, anchors, shared, row: int,
                        signed: bool):
    """Quantize the shared-fit endpoints at the row group's precision,
    rescore exactly, one quantized-domain LS refit round below
    BC6H_GROUP_REFIT_MINPREC bits, anchor swaps (bc67.py:2529).
    Returns (total_err, anchor-fixed q_pairs, idx_full)."""
    _, _, _, iprec, precW, _, _, _ = BC6H_MODE_INFO[row]
    px_f = px_int.to(torch.float32)
    idx_full = torch.zeros_like(px_int[:, 0, :])
    total_err = torch.zeros(px_int.shape[2], dtype=torch.float32,
                            device=px_int.device)

    q_pairs = []
    for sub, mask in enumerate(mask_list):
        e0, e1 = shared[sub]
        q0, q1 = _quantize_f(e0, precW, signed), _quantize_f(e1, precW, signed)
        idx, err = _bc6h_palette_err_t(px_int, mask, q0, q1, precW, iprec,
                                       signed)
        if precW[0] < BC6H_GROUP_REFIT_MINPREC:
            _, _, cap = _mag_cap(px_f, mask)
            x = _pal_weight(idx, 1 << iprec).to(torch.float32) * (1 / 64)
            r0, r1 = _bc6h_ls_refit(px_f, x, mask, e0, e1, cap, signed)
            q0r, q1r = (_quantize_f(r0, precW, signed),
                        _quantize_f(r1, precW, signed))
            idx_r, err_r = _bc6h_palette_err_t(px_int, mask, q0r, q1r,
                                               precW, iprec, signed)
            better = err_r < err
            q0 = torch.where(better[None, :], q0r, q0)
            q1 = torch.where(better[None, :], q1r, q1)
            idx = torch.where(better[None, :], idx_r, idx)
            err = torch.minimum(err_r, err)
        total_err = total_err + err
        q_pairs.append((q0, q1))
        idx_full = torch.where(mask, idx, idx_full)
    fixed, idx_full = _anchor_swap(idx_full, mask_list, anchors, q_pairs,
                                   iprec)
    return total_err, fixed, idx_full


def _anchor_swap(idx_full, mask_list, anchors, q_pairs, iprec: int):
    """SwapIndices (:2228): a subset whose anchor index has its MSB set
    swaps endpoints and inverts its indices."""
    msb = 1 << (iprec - 1)
    maxi = (1 << iprec) - 1
    fixed = []
    for sub, (mask, anchor) in enumerate(zip(mask_list, anchors)):
        swap = (_anchor_index(idx_full, anchor) & msb) != 0
        q0, q1 = q_pairs[sub]
        fixed.append((torch.where(swap[None, :], q1, q0),
                      torch.where(swap[None, :], q0, q1)))
        idx_full = torch.where(swap[None, :] & mask, maxi - idx_full,
                               idx_full)
    return fixed, idx_full


def _bc6h_transform_fit_t(q_pairs, total_err, row: int, signed: bool):
    """Delta transform + endpoint-fit check on anchor-fixed quantized
    endpoints (TransformForward + EndPointsFit :1948).
    Returns (err with inf where it does not fit, field-masked pairs)."""
    _, partitions, transformed, _, precW, precX, precY, precZ = \
        BC6H_MODE_INFO[row]
    base = q_pairs[0][0]
    fit = torch.ones_like(total_err, dtype=torch.bool)
    deltas = [(q_pairs[0][1], precX)]
    if partitions:
        deltas.append((q_pairs[1][0], precY))
        deltas.append((q_pairs[1][1], precZ))
    if transformed:
        stored = []
        for val, prec in deltas:
            d = val - base
            for c in range(3):
                fit = fit & _nbits_fit(d[c], prec[c], True)
            stored.append(d)
    else:
        stored = [v for v, _ in deltas]
        for val, prec in deltas:
            for c in range(3):
                fit = fit & _nbits_fit(val[c], prec[c], signed)
    for c in range(3):
        fit = fit & _nbits_fit(base[c], precW[c], signed)

    def field_mask(v, prec):
        return torch.stack([v[c] & ((1 << prec[c]) - 1) for c in range(3)])

    pairs = [(field_mask(base, precW), field_mask(stored[0], precX))]
    if partitions:
        pairs.append((field_mask(stored[1], precY),
                      field_mask(stored[2], precZ)))
    return torch.where(fit, total_err, float("inf")), pairs


def _bc6h_row_groups(rows=range(10)):
    """Consecutive 2-region rows sharing (iprec, precW): their quantized
    rescore is identical, only delta-fit and emit differ."""
    groups = []
    for row in rows:
        key = (BC6H_MODE_INFO[row][3], BC6H_MODE_INFO[row][4])
        if groups and groups[-1][0] == key:
            groups[-1][1].append(row)
        else:
            groups.append((key, [row]))
    return [tuple(rs) for _, rs in groups]


def _bc6h_emit(row: int, shape, q_pairs, idx, nb: int, device):
    """Pack one candidate per block into words [4, NB] int64 (EmitBlock
    :2330). shape: python int or [NB] tensor; q_pairs: per-region pairs of
    [3, NB] field-masked values; idx [16, NB] anchor-fixed indices."""
    mode_val, partitions, _, iprec, _, _, _, _ = BC6H_MODE_INFO[row]
    hb = 82 if partitions else 65

    def as_row(v):
        if isinstance(v, int):
            return torch.full((nb,), v, dtype=torch.int64, device=device)
        return v.to(torch.int64)

    fields = {2: as_row(shape)}
    for ch, base in ((0, 3), (1, 7), (2, 11)):
        fields[base + 0] = q_pairs[0][0][ch]
        fields[base + 1] = q_pairs[0][1][ch]
        if partitions:
            fields[base + 2] = q_pairs[1][0][ch]
            fields[base + 3] = q_pairs[1][1][ch]
    words = [torch.zeros(nb, dtype=torch.int64, device=device)
             for _ in range(4)]
    for fid, fbit, pos, ln in _header_runs(row):
        if fid == 1:
            v = as_row((mode_val >> fbit) & ((1 << ln) - 1))
        elif fid in fields:
            v = (fields[fid].to(torch.int64) >> fbit) & ((1 << ln) - 1)
        else:
            continue
        _put_static(words, v, pos, ln)
    if partitions:
        offs = _tables(device)["offs", 1, iprec][as_row(shape)].t() + hb
        for i in range(16):
            _put_dynamic(words, as_row(idx[i]), offs[i])
    else:
        offs, nbits = _index_layout(0, iprec)
        for i in range(16):
            _put_static(words, as_row(idx[i]), hb + int(offs[0, i]),
                        int(nbits[0, i]))
    return torch.stack(words)


# ---------------------------------------------------------------------------
# search (bc67.py:3423-3502)
# ---------------------------------------------------------------------------

# blocks per plain-search slice (bounds the shape-sum planes at full size;
# results are per block, so slicing changes nothing)
_PLAIN_SEARCH_SLICE = 32768


def _px_lane_major(px: torch.Tensor) -> torch.Tensor:
    """[48, NB] channel-major -> [16, 3, NB]."""
    return px.reshape(3, 16, -1).permute(1, 0, 2)


def _search_slice(px_int, signed: bool):
    nb = px_int.shape[2]
    dev = px_int.device
    px_f = px_int.to(torch.float32)
    ones = torch.ones((16, nb), dtype=torch.bool, device=dev)
    best_err = torch.full((nb,), float("inf"), device=dev)
    best_words = torch.zeros((4, nb), dtype=torch.int64, device=dev)

    def fold(err, words):
        nonlocal best_err, best_words
        better = err < best_err
        best_err = torch.minimum(err, best_err)
        best_words = torch.where(better[None, :], words, best_words)

    shared1 = _bc6h_shared_fit(px_f, [ones], BC6H_MODE_INFO[10][3], signed)
    for row in range(10, 14):
        terr, q_pairs, idx = _bc6h_group_rescore(px_int, [ones], [0],
                                                 shared1, row, signed)
        err, pairs = _bc6h_transform_fit_t(q_pairs, terr, row, signed)
        fold(err, _bc6h_emit(row, 0, pairs, idx, nb, dev))

    tabs = _tables(dev)
    px4 = torch.cat([px_f, torch.zeros_like(px_f[:, :1, :])], dim=1)
    # axis_w=0: the HDR probe measured best at the pure off-axis residual
    ests = _shape_estimates_table(px4, n_shapes=32, axis_w=0.0)
    cands = []
    for s_blk in _top_k_shapes(ests, BC7_SHAPE_CANDIDATES):
        pmask = tabs["parts1"][s_blk].t()
        mask_list = [pmask == 0, pmask == 1]
        anchors = [0, tabs["fix1"][s_blk, 1]]
        shared = _bc6h_shared_fit(px_f, mask_list, BC6H_MODE_INFO[0][3],
                                  signed)
        cands.append((s_blk, mask_list, anchors, shared))
    for rows in _bc6h_row_groups():
        rescored = [(s_blk,) + _bc6h_group_rescore(
            px_int, mask_list, anchors, shared, rows[0], signed)
            for s_blk, mask_list, anchors, shared in cands]
        for row in rows:
            for s_blk, terr, q_pairs, idx in rescored:
                err, pairs = _bc6h_transform_fit_t(q_pairs, terr, row, signed)
                fold(err, _bc6h_emit(row, s_blk, pairs, idx, nb, dev))
    return best_err, best_words


def _check_px48(px: torch.Tensor, nb: int | None = None) -> None:
    if px.dtype != torch.int32 or px.dim() != 2 or px.shape[0] != 48 \
            or (nb is not None and px.shape[1] != nb):
        raise ValueError(f"px must be [48, NB] int32, got "
                         f"{tuple(px.shape)} {px.dtype}")


def _plain_slices(px: torch.Tensor, fn, *extra):
    """fn(px_int, *extra) -> (err, words int64) over _PLAIN_SEARCH_SLICE
    blocks at a time, px_int the slice's [16, 3, n] pixels and each extra
    [C, NB] tensor sliced alike: (err [NB], words [4, NB] int32)."""
    errs, words = [], []
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        sl = slice(s, s + _PLAIN_SEARCH_SLICE)
        err, w = fn(_px_lane_major(px[:, sl]), *(e[:, sl] for e in extra))
        errs.append(err)
        words.append(_words_i32(w))
    return torch.cat(errs), torch.cat(words, dim=1)


def _bc6h_search_plain(px: torch.Tensor, signed: bool):
    """Plain twin of K5: px [48, NB] int32 F16-ints (row = channel * 16 +
    pixel) -> (err [NB] f32, words [4, NB] int32)."""
    return _plain_slices(px, lambda p: _search_slice(p, signed))


# K5's lane jobs in plain form (used by the tests and chip_smoke.py; the
# search itself is _bc6h_search_plain): the one-region job (rows 10-13,
# positions 0-3 of the twin's fold order) and candidate job k (rows 0-9
# on shape candidate rank k, position 4 + 4 * row + k), each keeping its
# best by (error, position), then a fold of the jobs by the same order

def _beats(best, err, order):
    """Where (err, order) [NB] beats best = (err, order, words): a lower
    error, or an equal one at an earlier position (K5's `beats`)."""
    return (err < best[0]) | ((err == best[0]) & (order < best[1]))


def _keep_beating(best, err, order, words):
    """best updated to (err, order, words) where they beat it."""
    win = _beats(best, err, order)
    return (torch.where(win, err, best[0]), torch.where(win, order, best[1]),
            torch.where(win[None, :], words, best[2]))


def _search_jobs_slice(px_int, signed: bool):
    nb = px_int.shape[2]
    dev = px_int.device
    px_f = px_int.to(torch.float32)
    ones = torch.ones((16, nb), dtype=torch.bool, device=dev)

    def none():
        return (torch.full((nb,), float("inf"), device=dev),
                torch.full((nb,), -1, dtype=torch.int64, device=dev),
                torch.zeros((4, nb), dtype=torch.int64, device=dev))

    def at(order):
        return torch.full((nb,), order, dtype=torch.int64, device=dev)

    one = none()
    shared1 = _bc6h_shared_fit(px_f, [ones], BC6H_MODE_INFO[10][3], signed)
    for row in range(10, 14):
        terr, q_pairs, idx = _bc6h_group_rescore(px_int, [ones], [0],
                                                 shared1, row, signed)
        err, pairs = _bc6h_transform_fit_t(q_pairs, terr, row, signed)
        one = _keep_beating(one, err, at(row - 10),
                            _bc6h_emit(row, 0, pairs, idx, nb, dev))
    jobs = [one]
    tabs = _tables(dev)
    px4 = torch.cat([px_f, torch.zeros_like(px_f[:, :1, :])], dim=1)
    ests = _shape_estimates_table(px4, n_shapes=32, axis_w=0.0)
    for k, s_blk in enumerate(_top_k_shapes(ests, BC7_SHAPE_CANDIDATES)):
        pmask = tabs["parts1"][s_blk].t()
        mask_list = [pmask == 0, pmask == 1]
        anchors = [0, tabs["fix1"][s_blk, 1]]
        shared = _bc6h_shared_fit(px_f, mask_list, BC6H_MODE_INFO[0][3],
                                  signed)
        best = none()
        for rows in _bc6h_row_groups():
            terr, q_pairs, idx = _bc6h_group_rescore(
                px_int, mask_list, anchors, shared, rows[0], signed)
            for row in rows:
                err, pairs = _bc6h_transform_fit_t(q_pairs, terr, row, signed)
                best = _keep_beating(best, err, at(4 + 4 * row + k),
                                     _bc6h_emit(row, s_blk, pairs, idx, nb,
                                                dev))
        jobs.append(best)
    return jobs


def _bc6h_search_jobs_plain(px: torch.Tensor, signed: bool):
    """Plain twin of K5's jobs: px [48, NB] int32 F16-ints -> [(err [NB]
    f32, order [NB] int64, words [4, NB] int32)] of the one-region job and
    candidate jobs 0-3, each its best row by (error, position in the twin's
    fold order); order -1 where no row of the job fits."""
    parts = [_search_jobs_slice(_px_lane_major(px[:, s:s + _PLAIN_SEARCH_SLICE]),
                                signed)
             for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE)]
    return [(torch.cat([p[j][0] for p in parts]),
             torch.cat([p[j][1] for p in parts]),
             torch.cat([_words_i32(p[j][2]) for p in parts], dim=1))
            for j in range(len(parts[0]))]


def _bc6h_jobs_fold_plain(jobs):
    """Plain twin of K5's fold: the jobs' (err, order, words) folded by
    (error, position) in the order given -> (err [NB], words [4, NB])."""
    best = (torch.full_like(jobs[0][0], float("inf")),
            torch.full_like(jobs[0][1], -1), torch.zeros_like(jobs[0][2]))
    for err, order, words in jobs:
        best = _keep_beating(best, err, order, words)
    return best[0], best[2]


def bc6h_search_words(px: torch.Tensor, signed: bool):
    """K5 wrapper: the whole shared-fit search. px [48, NB] int32 F16-ints
    -> (err [NB] f32, words [4, NB] int32). A CUDA tensor launches the
    kernel, a CPU tensor runs the plain twin."""
    _check_px48(px)
    if _on_cuda(px):
        return cuda_kernels.bc6h_encode(px, signed)
    return _bc6h_search_plain(px, signed)


# ---------------------------------------------------------------------------
# the BC6H_SHARED_FIT=False search (bc67.py:3219-3335, :3497-3535)
# ---------------------------------------------------------------------------

def _bc6h_eval_subsets(px_int, mask_list, anchors, row: int, signed: bool):
    """The full quantized-domain evaluation of one candidate up to its
    anchor swaps (_bc6h_eval_candidate, bc67.py:3219-3310): per subset the
    min/max box quantized at the row's precision and rescored exactly,
    then BC6H_REFIT_ROUNDS LS rounds at the integer palette weights of the
    latest indices, each requantized and rescored, the last kept where it
    scores strictly lower. Rows sharing (precW, iprec) get the same
    result. Returns (total_err, anchor-fixed q_pairs, idx_full)."""
    _, _, _, iprec, precW, _, _, _ = BC6H_MODE_INFO[row]
    px_f = px_int.to(torch.float32)
    idx_full = torch.zeros_like(px_int[:, 0, :])
    total_err = torch.zeros(px_int.shape[2], dtype=torch.float32,
                            device=px_int.device)
    q_pairs = []
    for mask in mask_list:
        mi, ma, cap = _mag_cap(px_f, mask)
        q0, q1 = _quantize_f(mi, precW, signed), _quantize_f(ma, precW, signed)
        idx, err = _bc6h_palette_err_t(px_int, mask, q0, q1, precW, iprec,
                                       signed)
        e0f, e1f = mi, ma
        idx_b, err_b = idx, err
        q0b, q1b = q0, q1
        for _ in range(BC6H_REFIT_ROUNDS):
            x = _pal_weight(idx_b, 1 << iprec).to(torch.float32) * (1 / 64)
            e0f, e1f = _bc6h_ls_refit(px_f, x, mask, e0f, e1f, cap, signed)
            q0b, q1b = (_quantize_f(e0f, precW, signed),
                        _quantize_f(e1f, precW, signed))
            idx_b, err_b = _bc6h_palette_err_t(px_int, mask, q0b, q1b, precW,
                                               iprec, signed)
        better = err_b < err
        q0 = torch.where(better[None, :], q0b, q0)
        q1 = torch.where(better[None, :], q1b, q1)
        idx = torch.where(better[None, :], idx_b, idx)
        err = torch.minimum(err_b, err)
        total_err = total_err + err
        q_pairs.append((q0, q1))
        idx_full = torch.where(mask, idx, idx_full)
    fixed, idx_full = _anchor_swap(idx_full, mask_list, anchors, q_pairs,
                                   iprec)
    return total_err, fixed, idx_full


def _bc6h_eval_candidate(px_int, mask_list, anchors, row: int,
                         signed: bool):
    """One (row, shape) candidate end to end (bc67.py:3219): the subset
    evaluation, then the row's delta transform and fit. px_int [16, 3, NB];
    masks [16, NB]. Returns (err [NB], field-masked pairs, idx [16, NB])."""
    total_err, q_pairs, idx = _bc6h_eval_subsets(px_int, mask_list, anchors,
                                                 row, signed)
    err, pairs = _bc6h_transform_fit_t(q_pairs, total_err, row, signed)
    return err, pairs, idx


def _fold_first(best, err, words):
    """One step of the kernels' in-launch fold: None takes the first
    candidate as it is (an infinite error included), then a strict `<`."""
    if best is None:
        return err, words
    better = err < best[0]
    return (torch.where(better, err, best[0]),
            torch.where(better[None, :], words, best[1]))


# the one-region rows, in K10's fold order
ONE_REGION_ROWS = (10, 11, 12, 13)


def _one_region_row(px_int, row: int, signed: bool):
    """One-region row `row` of every block evaluated in full, its anchor
    swap, delta fit and emit: (err [NB], words [4, NB] int64)."""
    nb = px_int.shape[2]
    ones = torch.ones((16, nb), dtype=torch.bool, device=px_int.device)
    err, pairs, idx = _bc6h_eval_candidate(px_int, [ones], [0], row, signed)
    return err, _bc6h_emit(row, 0, pairs, idx, nb, px_int.device)


def _bc6h_1region_rows_plain(px: torch.Tensor, signed: bool):
    """K10's rows, each evaluated in full: px [48, NB] int32 F16-ints ->
    [(err [NB] f32, words [4, NB] int32)] in ONE_REGION_ROWS order."""
    _check_px48(px)
    return [_plain_slices(px, lambda p, row=row: _one_region_row(p, row,
                                                                 signed))
            for row in ONE_REGION_ROWS]


def _bc6h_1region_plain(px: torch.Tensor, signed: bool):
    """Plain twin of K10 (_k_bc6h_1region): px [48, NB] int32 F16-ints ->
    (err [NB] f32, words [4, NB] int32), rows 10-13 each evaluated in full
    (_bc6h_1region_rows_plain), folded in row order: row 10 taken as it
    is (an infinite error included), then a strict `<`."""
    best = None
    for err, words in _bc6h_1region_rows_plain(px, signed):
        best = _fold_first(best, err, words)
    return best


def _check_rows(rows) -> tuple:
    rows = tuple(int(r) for r in rows)
    keys = {(BC6H_MODE_INFO[r][3], BC6H_MODE_INFO[r][4]) for r in rows
            if r in range(10)}
    if not rows or len(keys) != 1 or not all(r in range(10) for r in rows):
        raise ValueError(f"rows {rows}: two-region rows (0-9) that share "
                         f"one precision group")
    return rows


def _two_region_slice(px_int, s_blks, rows: tuple, signed: bool):
    nb = px_int.shape[2]
    dev = px_int.device
    tabs = _tables(dev)
    cands = []
    for s_blk in s_blks.to(torch.int64):
        pmask = tabs["parts1"][s_blk].t()
        mask_list = [pmask == 0, pmask == 1]
        anchors = [0, tabs["fix1"][s_blk, 1]]
        cands.append((s_blk,) + _bc6h_eval_subsets(
            px_int, mask_list, anchors, rows[0], signed))
    best = None
    for row in rows:
        best_row = None
        for s_blk, terr, q_pairs, idx in cands:
            err, pairs = _bc6h_transform_fit_t(q_pairs, terr, row, signed)
            best_row = _fold_first(best_row, err, _bc6h_emit(
                row, s_blk, pairs, idx, nb, dev))
        best = _fold_first(best, *best_row)
    return best


def _bc6h_2region_plain(px: torch.Tensor, s_blks: torch.Tensor, rows,
                        signed: bool):
    """Plain twin of K11 (_k_bc6h_group): px [48, NB] int32 F16-ints,
    s_blks [C, NB] int32 shapes 0..31, rows: two-region rows sharing one
    (precW, iprec) -> (err [NB] f32, words [4, NB] int32). Each candidate
    is evaluated in full once, at rows[0]; each row applies its own delta
    fit and emit; the fold runs within a row over the candidates, then
    across the rows, each with a strict `<` from its first entry."""
    rows = _check_rows(rows)
    return _plain_slices(
        px, lambda p, sb: _two_region_slice(p, sb, rows, signed), s_blks)


def _bc6h_shape_table(px: torch.Tensor) -> torch.Tensor:
    """The ranking's table: px [48, NB] int32 F16-ints -> [32, NB] f32,
    the off-axis estimate (axis_w 0, RGB and a zero alpha plane) of each
    of the 32 two-region shapes."""
    px_f = _px_lane_major(px).to(torch.float32)
    px4 = torch.cat([px_f, torch.zeros_like(px_f[:, :1, :])], dim=1)
    return _shape_estimates_table(px4, n_shapes=32, axis_w=0.0)


def _bc6h_shapes_plain(px: torch.Tensor) -> torch.Tensor:
    """Plain twin of the BC6H shape ranking: px [48, NB] int32 F16-ints ->
    s_blks [4, NB] int32, the BC7_SHAPE_CANDIDATES shapes of least
    off-axis estimate (axis_w 0, RGB and a zero alpha plane) of the 32
    two-region shapes, in rank order (a tie keeps the lower shape)."""
    out = []
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        ests = _bc6h_shape_table(px[:, s:s + _PLAIN_SEARCH_SLICE])
        out.append(torch.stack(_top_k_shapes(ests, BC7_SHAPE_CANDIDATES)))
    return torch.cat(out, dim=1).to(torch.int32)


def _bc6h_shapes_slices_plain(px: torch.Tensor,
                              n_slices: int = 4) -> torch.Tensor:
    """Plain form of the ranking's team: warp w ranks shapes w, w +
    n_slices, ... of the same table into a local top 4 and the slices'
    lists are merged by (estimate, shape), the lower shape first on an
    equal estimate (_top4_merge_plain). px [48, NB] -> s_blks [4, NB]
    int32, equal to _bc6h_shapes_plain."""
    out = []
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        ests = _bc6h_shape_table(px[:, s:s + _PLAIN_SEARCH_SLICE])
        out.append(torch.stack(_top4_merge_plain(ests, n_slices)))
    return torch.cat(out, dim=1).to(torch.int32)


def bc6h_1region_words(px: torch.Tensor, signed: bool):
    """K10 wrapper: rows 10-13 each evaluated in full, folded. px [48, NB]
    int32 F16-ints -> (err [NB] f32, words [4, NB] int32). A CUDA tensor
    launches the kernel, a CPU tensor runs the plain twin."""
    _check_px48(px)
    if _on_cuda(px):
        return cuda_kernels.bc6h_1region(px, signed)
    return _bc6h_1region_plain(px, signed)


def bc6h_shape_picks(px: torch.Tensor) -> torch.Tensor:
    """The shape ranking's wrapper: px [48, NB] int32 F16-ints -> s_blks
    [4, NB] int32. A CUDA tensor launches the kernel, a CPU tensor runs
    the plain twin."""
    _check_px48(px)
    if _on_cuda(px):
        return cuda_kernels.bc6h_shapes(px)
    return _bc6h_shapes_plain(px)


def bc6h_2region_words(px: torch.Tensor, s_blks: torch.Tensor, group: int,
                       signed: bool):
    """K11 wrapper for one group: the rows of precision group `group` (an
    index into _bc6h_row_groups()) over the candidates s_blks [C, NB]
    int32. px [48, NB] int32 F16-ints -> (err [NB] f32, words [4, NB]
    int32). A CUDA tensor launches the kernel, a CPU tensor runs the plain
    twin."""
    groups = _bc6h_row_groups()
    if group not in range(len(groups)):
        raise ValueError(f"group {group}: the precision groups are "
                         f"0-{len(groups) - 1}, {groups}")
    return bc6h_2region_groups_words(px, s_blks, (group,), signed)


def bc6h_2region_groups_words(px: torch.Tensor, s_blks: torch.Tensor,
                              groups, signed: bool):
    """K11 wrapper: the rows of the precision groups `groups` (indices into
    _bc6h_row_groups(), ascending) over the candidates s_blks [C, NB]
    int32, in one launch. px [48, NB] int32 F16-ints -> (err [NB] f32,
    words [4, NB] int32): the least error, the first in (row, candidate)
    order, and where no row fits the first group's first row's first
    candidate's words. A CUDA tensor launches the kernel, a CPU tensor
    runs the plain twin (_bc6h_2region_groups_plain)."""
    _check_px48(px)
    if s_blks.dtype != torch.int32 or s_blks.dim() != 2 \
            or s_blks.shape[1] != px.shape[1]:
        raise ValueError(f"s_blks must be [C, NB] int32, got "
                         f"{tuple(s_blks.shape)} {s_blks.dtype}")
    groups = _check_groups(groups)
    if _on_cuda(px, s_blks):
        return cuda_kernels.bc6h_2region(px, s_blks, groups, signed)
    return _bc6h_2region_groups_plain(px, s_blks, groups, signed)


def _check_groups(groups) -> tuple:
    groups = tuple(int(g) for g in groups)
    n = len(_bc6h_row_groups())
    if not groups or list(groups) != sorted(set(groups)) \
            or not all(g in range(n) for g in groups):
        raise ValueError(f"groups {groups}: precision groups 0-{n - 1}, "
                         f"ascending, each once")
    return groups


def _bc6h_2region_groups_plain(px: torch.Tensor, s_blks: torch.Tensor,
                               groups, signed: bool):
    """Plain twin of K11 over several precision groups: each group's
    _bc6h_2region_plain, folded in group order from the first group's
    result as it is, then with a strict `<` (the flat fold over (row,
    candidate) in row order). -> (err [NB] f32, words [4, NB] int32)."""
    all_groups = _bc6h_row_groups()
    best = None
    for g in _check_groups(groups):
        best = _fold_first(best, *_bc6h_2region_plain(px, s_blks,
                                                      all_groups[g], signed))
    return best


# K11's lane jobs in plain form (used by the tests and chip_smoke.py; the
# twin itself is _bc6h_2region_groups_plain): job j = k + C * i is
# candidate rank k on the i-th group of the mask, keeping its best row by
# (error, position row * C + k) from (inf, past the last position); job j
# runs on warp j % 4, and the warps' bests fold by the same order

_NO_POSITION = 1 << 31


def _two_region_jobs_slice(px_int, s_blks, groups, signed: bool):
    nb = px_int.shape[2]
    dev = px_int.device
    tabs = _tables(dev)
    n_cand = s_blks.shape[0]
    all_groups = _bc6h_row_groups()
    jobs = []
    for g in groups:
        rows = all_groups[g]
        for k, s_blk in enumerate(s_blks.to(torch.int64)):
            pmask = tabs["parts1"][s_blk].t()
            mask_list = [pmask == 0, pmask == 1]
            anchors = [0, tabs["fix1"][s_blk, 1]]
            terr, q_pairs, idx = _bc6h_eval_subsets(
                px_int, mask_list, anchors, rows[0], signed)
            best = (torch.full((nb,), float("inf"), device=dev),
                    torch.full((nb,), _NO_POSITION, dtype=torch.int64,
                               device=dev),
                    torch.zeros((4, nb), dtype=torch.int64, device=dev))
            for row in rows:
                err, pairs = _bc6h_transform_fit_t(q_pairs, terr, row, signed)
                best = _keep_beating(
                    best, err,
                    torch.full((nb,), row * n_cand + k, dtype=torch.int64,
                               device=dev),
                    _bc6h_emit(row, s_blk, pairs, idx, nb, dev))
            jobs.append(best)
    return jobs


def _bc6h_2region_jobs_plain(px: torch.Tensor, s_blks: torch.Tensor, groups,
                             signed: bool):
    """Plain twin of K11's lane jobs: px [48, NB] int32 F16-ints, s_blks
    [C, NB] int32 -> [(err [NB] f32, order [NB] int64, words [4, NB]
    int32)] in job order (j = k + C * i: candidate rank k, the i-th group
    of `groups`), each its best row by (error, position row * C + k)."""
    _check_px48(px)
    groups = _check_groups(groups)
    parts = [_two_region_jobs_slice(
        _px_lane_major(px[:, s:s + _PLAIN_SEARCH_SLICE]),
        s_blks[:, s:s + _PLAIN_SEARCH_SLICE], groups, signed)
        for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE)]
    return [(torch.cat([p[j][0] for p in parts]),
             torch.cat([p[j][1] for p in parts]),
             torch.cat([_words_i32(p[j][2]) for p in parts], dim=1))
            for j in range(len(parts[0]))]


def _bc6h_2region_jobs_fold_plain(jobs, n_warps: int = 4):
    """Plain twin of K11's fold: job j on warp j % n_warps, each warp's
    best of its jobs by (error, position), then the warps' bests by the
    same, each from (inf, past the last position, zero words) -> (err
    [NB] f32, words [4, NB] int32)."""
    def none():
        return (torch.full_like(jobs[0][0], float("inf")),
                torch.full_like(jobs[0][1], _NO_POSITION),
                torch.zeros_like(jobs[0][2]))

    fold = none()
    for w in range(n_warps):
        best = none()
        for err, order, words in jobs[w::n_warps]:
            best = _keep_beating(best, err, order, words)
        fold = _keep_beating(fold, *best)
    return fold[0], fold[2]


def _search_unshared(px: torch.Tensor, signed: bool):
    """The BC6H_SHARED_FIT=False search (bc67.py:3497-3535): K10 (rows
    10-13), the shape ranking, one K11 launch over the six precision
    groups, then a strict-`<` fold over (K10, K11) from (inf, zero words).
    Every piece runs where px lies (kernel or plain twin). px [48, NB]
    int32 F16-ints -> (err [NB] f32, words [4, NB] int32).

    The nested folds (within a row, across the groups' rows, across the
    launches) pick the first least error in (row, candidate) order, which
    is the jnp path's one flat fold. Where every two-region row reads inf
    on a block, K11 hands its first candidate's words to this fold, which
    never takes an infinite error: where every row reads inf the words
    stay zero, as in the jnp path."""
    _check_px48(px)
    s_blks = bc6h_shape_picks(px)
    return _fold_launches([
        bc6h_1region_words(px, signed),
        bc6h_2region_groups_words(px, s_blks,
                                  range(len(_bc6h_row_groups())), signed)])


def _fold_launches(results):
    """The unshared search's fold: a strict `<` over [(err [NB], words
    [4, NB] int32), ...] in order, from (inf, zero words)."""
    best_err = torch.full_like(results[0][0], float("inf"))
    best_words = torch.zeros_like(results[0][1])
    for err, words in results:
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_words = torch.where(better[None, :], words, best_words)
    return best_err, best_words


# ---------------------------------------------------------------------------
# winner-refine (bc67.py:2729-3216): per-block precision as a tensor
# ---------------------------------------------------------------------------

def _bc6h_unquantize_dyn(comp, bits, signed: bool):
    """_bc6h_unquantize with per-block bit widths bits [NB]."""
    if signed:
        c = comp.abs()
        bm1 = (bits - 1).clamp(min=0)
        unq = torch.where(c == 0, 0,
                          torch.where(c >= _shl(1, bm1) - 1, 0x7FFF,
                                      ((c << 15) + 0x4000) >> bm1))
        unq = torch.where(bits >= 16, c, unq)
        return torch.where(comp < 0, -unq, unq)
    full = bits >= 15
    safe = torch.where(full, 0, comp)
    unq = torch.where(comp == 0, 0,
                      torch.where(comp == _shl(1, bits) - 1, 0xFFFF,
                                  ((safe << 16) + 0x8000) >> bits))
    return torch.where(full, comp, unq)


def _bc6h_quantize_dyn(v, precw, signed: bool):
    """_bc6h_quantize with per-block precision precw [NB]."""
    if signed:
        a = v.abs()
        full = precw >= 16
        safe = torch.where(full, 0, a)
        q = torch.where(full, a, torch.div(
            safe << (precw - 1).clamp(min=0), _F16MAX + 1,
            rounding_mode="floor"))
        return torch.where(v < 0, -q, q)
    full = precw >= 15
    safe = torch.where(full, 0, v)
    return torch.where(full, v, torch.div(safe << precw, _F16MAX + 1,
                                          rounding_mode="floor"))


def _bc6h_palette_err_dyn(px3, mask, q0, q1, precw, iprec: int, signed):
    """_bc6h_palette_err_t with per-block endpoint precision precw [NB]."""
    u0 = [_bc6h_unquantize_dyn(q0[c], precw, signed) for c in range(3)]
    u1 = [_bc6h_unquantize_dyn(q1[c], precw, signed) for c in range(3)]
    return _palette_err_u(px3, mask, u0, u1, iprec, signed)


def _bc6h_cherr_dyn(px_c, mask, u0c, u1c, wk, signed: bool):
    """One channel's masked SSE at fixed palette weights wk [16, NB]."""
    pal = (u0c[None, :] * (64 - wk) + u1c[None, :] * wk + 32) >> 6
    pal = _bc6h_finish_unquantize(pal, signed)
    d = (px_c - pal).to(torch.float32)
    return _sum0(torch.where(mask, d * d, 0.0))


def _bc6h_ladder_caps(px3, mask, q0, q1, precw, signed: bool):
    """Per-channel q-space magnitude cap of the ladders (bc67.py:2808)."""
    caps = []
    for c in range(3):
        capint = torch.where(mask, px3[c].abs(), 0).amax(dim=0) \
            + int(BC6H_LS_MAG_CAP)
        capq = _bc6h_quantize_dyn(capint, precw, signed)
        caps.append(torch.maximum(capq, torch.maximum(q0[c].abs(),
                                                      q1[c].abs())))
    return caps


def _ladder_bounds(px3, mask, q0, q1, precw, signed: bool, remap: bool):
    if signed:
        qhi = torch.where(precw >= 16, _F16MAX, _shl(1, precw - 1) - 1)
        qlo = -qhi
    elif remap:
        # the full field range (PerturbOne clips to the field, not the
        # source): how bright values become reachable at W16
        qhi = _shl(1, precw) - 1
        qlo = torch.zeros_like(qhi)
    else:
        qhi = torch.where(precw >= 15, _F16MAX, _shl(1, precw) - 1)
        qlo = torch.zeros_like(qhi)
    caps = _bc6h_ladder_caps(px3, mask, q0, q1, precw, signed)
    return ([torch.maximum(qlo, -caps[c]) for c in range(3)],
            [torch.minimum(qhi, caps[c]) for c in range(3)])


def _bc6h_perturb_dyn(px3, mask, q0, q1, wk, precw, signed, rounds: int,
                      deltas):
    """Fixed-index per-channel endpoint ladder (bc67.py:2825).
    Returns (q0, q1, err, err0)."""
    qlo_c, qhi_c = _ladder_bounds(px3, mask, q0, q1, precw, signed, False)
    q0r = [q0[c] for c in range(3)]
    q1r = [q1[c] for c in range(3)]
    ch_err = [_bc6h_cherr_dyn(px3[c], mask,
                              _bc6h_unquantize_dyn(q0r[c], precw, signed),
                              _bc6h_unquantize_dyn(q1r[c], precw, signed),
                              wk, signed) for c in range(3)]
    err0 = sum(ch_err)
    for _ in range(rounds):
        for c in range(3):
            base = ch_err[c]
            for which in (0, 1):
                rows = q0r if which == 0 else q1r
                other_u = _bc6h_unquantize_dyn(
                    (q1r if which == 0 else q0r)[c], precw, signed)
                for delta in deltas:
                    for sgn in (delta, -delta):
                        qt = torch.minimum(torch.maximum(rows[c] + sgn,
                                                         qlo_c[c]), qhi_c[c])
                        ut = _bc6h_unquantize_dyn(qt, precw, signed)
                        e = (_bc6h_cherr_dyn(px3[c], mask, ut, other_u, wk,
                                             signed) if which == 0 else
                             _bc6h_cherr_dyn(px3[c], mask, other_u, ut, wk,
                                             signed))
                        better = e < base
                        rows[c] = torch.where(better, qt, rows[c])
                        base = torch.minimum(e, base)
            ch_err[c] = base
    return torch.stack(q0r), torch.stack(q1r), sum(ch_err), err0


def _bc6h_perturb_remap_dyn(px3, mask, q0, q1, precw, iprec: int, signed,
                            rounds: int, deltas):
    """Re-mapping endpoint ladder: every probe re-assigns indices
    (PerturbOne's MapColors, BC6HBC7.cpp:2128; bc67.py:2873).
    Returns (q0, q1, idx, err, err0)."""
    qlo_c, qhi_c = _ladder_bounds(px3, mask, q0, q1, precw, signed, True)
    q0r = [q0[c] for c in range(3)]
    q1r = [q1[c] for c in range(3)]
    idx, err = _bc6h_palette_err_dyn(px3, mask, q0r, q1r, precw, iprec,
                                     signed)
    err0 = err
    for _ in range(rounds):
        for c in range(3):
            for which in (0, 1):
                rows = q0r if which == 0 else q1r
                for delta in deltas:
                    for sgn in (delta, -delta):
                        qt = torch.minimum(torch.maximum(rows[c] + sgn,
                                                         qlo_c[c]), qhi_c[c])
                        keep, rows[c] = rows[c], qt
                        idx_t, err_t = _bc6h_palette_err_dyn(
                            px3, mask, q0r, q1r, precw, iprec, signed)
                        bt = err_t < err
                        rows[c] = torch.where(bt, qt, keep)
                        idx = torch.where(bt[None, :], idx_t, idx)
                        err = torch.minimum(err_t, err)
    return torch.stack(q0r), torch.stack(q1r), idx, err, err0


def _refine_bc6h_core(px3, words, ladder, signed: bool, remap: bool,
                      cross2: bool, ladder2=None):
    """The lane-major refine body (bc67.py:2964). px3: 3 x [16, NB] int32;
    words [4, NB] int64. Returns refined words [4, NB] int64."""
    nb = words.shape[1]
    dev = words.device
    ladder_b = ladder2 if ladder2 is not None else ladder
    row_idx = _mode_rows(words)

    qm = {k: torch.zeros((3, nb), dtype=torch.int32, device=dev)
          for k in ((0, 0), (0, 1), (1, 0), (1, 1))}
    shape = torch.zeros(nb, dtype=torch.int64, device=dev)
    precw = torch.full((nb,), 10, dtype=torch.int32, device=dev)
    for row in range(14):
        hit = row_idx == row
        s_r, e = _bc6h_unpack_endpoints(words, row, signed)
        info = BC6H_MODE_INFO[row]
        precw = torch.where(hit, info[4][0], precw)
        if info[1]:
            shape = torch.where(hit, s_r, shape)
        for key in qm:
            if info[1] or key[0] == 0:
                vals = torch.stack([e[(key[0], key[1], c)]
                                    for c in range(3)]).to(torch.int32)
                qm[key] = torch.where(hit[None, :], vals, qm[key])

    ones = torch.ones((16, nb), dtype=torch.bool, device=dev)
    out = words

    def unq(q):
        return _bc6h_unquantize_dyn(q, precw, signed)

    # ---- unit A: one-region rows 10-13, laddered at all four precisions
    idx1 = torch.stack(_read_indices(words, 65, 4, None, None)[0]) \
        .to(torch.int32)
    wk1 = _pal_weight(idx1, 16)
    ef = [torch.stack([_bc6h_finish_unquantize(unq(qm[(0, e)][c]), signed)
                       for c in range(3)]) for e in (0, 1)]
    unit_a = {}
    err1_old = None
    if remap:
        # acceptance bar: the winner's error at its STORED indices
        err1_old = torch.zeros(nb, dtype=torch.float32, device=dev)
        for c in range(3):
            err1_old = err1_old + _bc6h_cherr_dyn(
                px3[c], ones, unq(qm[(0, 0)][c]), unq(qm[(0, 1)][c]), wk1,
                signed)
    for row in range(10, 14):
        prec_a = BC6H_MODE_INFO[row][4][0]
        p_a = torch.full((nb,), prec_a, dtype=torch.int32, device=dev)
        same = precw == prec_a
        q0s = torch.where(same[None, :], qm[(0, 0)], torch.stack(
            [_bc6h_quantize(ef[0][c], prec_a, signed) for c in range(3)]))
        q1s = torch.where(same[None, :], qm[(0, 1)], torch.stack(
            [_bc6h_quantize(ef[1][c], prec_a, signed) for c in range(3)]))
        if remap:
            q0n, q1n, idx1f, err1_new, err0 = _bc6h_perturb_remap_dyn(
                px3, ones, q0s, q1s, p_a, 4, signed, ladder[0], ladder[1])
        else:
            q0n, q1n, err_l, err0 = _bc6h_perturb_dyn(
                px3, ones, q0s, q1s, wk1, p_a, signed, ladder[0], ladder[1])
            idx_t, err_t = _bc6h_palette_err_dyn(px3, ones, q0n, q1n, p_a, 4,
                                                 signed)
            keep = err_t < err_l
            idx1f = torch.where(keep[None, :], idx_t, idx1)
            err1_new = torch.minimum(err_t, err_l)
            err1_old = torch.where(same, err0, float("inf")
                                   if err1_old is None else err1_old)
        swap = (idx1f[0] & 8) != 0
        q0a = torch.where(swap[None, :], q1n, q0n)
        q1a = torch.where(swap[None, :], q0n, q1n)
        idx1f = torch.where(swap[None, :], 15 - idx1f, idx1f)
        unit_a[row] = (err1_new, q0a, q1a, idx1f)

    # ---- unit B: two-region rows 0-9
    tabs = _tables(dev)
    pp = tabs["pp", 1][shape]
    a2 = tabs["pa", 1][shape] & 0xF
    pm = torch.stack([(pp >> (2 * i)) & 1 for i in range(16)])
    mask_list = [pm == 0, pm == 1]
    idx2 = torch.stack(_read_indices(words, 82, 3, a2, None)[0]) \
        .to(torch.int32)
    wk2 = _pal_weight(idx2, 8)
    err2_stored = None
    if remap:
        err2_stored = torch.zeros(nb, dtype=torch.float32, device=dev)
        for sub, mask_s in enumerate(mask_list):
            for c in range(3):
                err2_stored = err2_stored + _bc6h_cherr_dyn(
                    px3[c], mask_s, unq(qm[(sub, 0)][c]),
                    unq(qm[(sub, 1)][c]), wk2, signed)

    if cross2:
        groups = _bc6h_row_groups()
        ef2 = {(sub, e): [_bc6h_finish_unquantize(unq(qm[(sub, e)][c]),
                                                  signed) for c in range(3)]
               for sub in (0, 1) for e in (0, 1)}
    else:
        groups = [None]

    unit_b = []
    err2_old = err2_stored
    for g in groups:
        if g is None:
            p_b, same = precw, None
        else:
            prec_b = BC6H_MODE_INFO[g[0]][4][0]
            p_b = torch.full((nb,), prec_b, dtype=torch.int32, device=dev)
            same = precw == prec_b
        q2 = {}
        err2_new = torch.zeros(nb, dtype=torch.float32, device=dev)
        err2_pre = torch.zeros(nb, dtype=torch.float32, device=dev)
        idx2f = idx2
        for sub, mask in enumerate(mask_list):
            if g is None:
                q0s, q1s = qm[(sub, 0)], qm[(sub, 1)]
            else:
                q0s = torch.where(same[None, :], qm[(sub, 0)], torch.stack(
                    [_bc6h_quantize(ef2[(sub, 0)][c], prec_b, signed)
                     for c in range(3)]))
                q1s = torch.where(same[None, :], qm[(sub, 1)], torch.stack(
                    [_bc6h_quantize(ef2[(sub, 1)][c], prec_b, signed)
                     for c in range(3)]))
            if remap:
                q0n2, q1n2, idx_t2, err_n2, err02 = _bc6h_perturb_remap_dyn(
                    px3, mask, q0s, q1s, p_b, 3, signed, ladder_b[0],
                    ladder_b[1])
                idx2f = torch.where(mask, idx_t2, idx2f)
            else:
                q0n2, q1n2, err_l2, err02 = _bc6h_perturb_dyn(
                    px3, mask, q0s, q1s, wk2, p_b, signed, ladder_b[0],
                    ladder_b[1])
                idx_t2, err_t2 = _bc6h_palette_err_dyn(px3, mask, q0n2, q1n2,
                                                       p_b, 3, signed)
                keep2 = err_t2 < err_l2
                idx2f = torch.where(keep2[None, :] & mask, idx_t2, idx2f)
                err_n2 = torch.minimum(err_t2, err_l2)
            q2[sub] = (q0n2, q1n2)
            err2_new = err2_new + err_n2
            err2_pre = err2_pre + err02
        fixed, idx2f = _anchor_swap(idx2f, mask_list, (0, a2),
                                    [q2[0], q2[1]], 3)
        unit_b.append((g, err2_new, fixed, idx2f))
        if not remap:
            if g is None:
                err2_old = err2_pre
            else:
                prev = torch.full((nb,), float("inf"), device=dev) \
                    if err2_old is None else err2_old
                err2_old = torch.where(same, err2_pre, prev)

    # ---- per-row delta transform + fit + emit, fold where improved
    best1 = err1_old
    for row in range(10, 14):
        err1_new, q0a, q1a, idx1f = unit_a[row]
        errf, pairs = _bc6h_transform_fit_t([(q0a, q1a)], err1_new, row,
                                            signed)
        wn = _bc6h_emit(row, 0, pairs, idx1f, nb, dev)
        better = (row_idx >= 10) & (errf < best1)
        best1 = torch.where(better, errf, best1)
        out = torch.where(better[None, :], wn, out)

    is2 = (row_idx >= 0) & (row_idx <= 9)
    best2 = err2_old
    for g, err2_new, fixed, idx2f in unit_b:
        for row in (range(10) if g is None else g):
            errf, pairs = _bc6h_transform_fit_t(fixed, err2_new, row, signed)
            wn = _bc6h_emit(row, shape, pairs, idx2f, nb, dev)
            gate = is2 if g is not None else (row_idx == row)
            better = gate & (errf < best2)
            best2 = torch.where(better, errf, best2)
            out = torch.where(better[None, :], wn, out)
    return out


def _check_ladder(ladder):
    """(rounds, deltas) with 0 <= rounds and 1..8 deltas in 1..255."""
    rounds, deltas = ladder
    deltas = tuple(int(d) for d in deltas)
    if int(rounds) < 0 or not 1 <= len(deltas) <= 8 \
            or not all(1 <= d <= 255 for d in deltas):
        raise ValueError(f"ladder must be (rounds >= 0, 1-8 deltas in "
                         f"1..255), got {ladder}")
    return int(rounds), deltas


def _unit_buckets_plain(words: torch.Tensor):
    """Plain twin of K6's bucket pass: words [4, NB] int32 -> (counts [3]
    int32, per unit the [counts[u]] int32 indices of its blocks in
    ascending order): unit 0 the one-region winners (rows 10-13), 1 the
    two-region winners (rows 0-9), 2 the reserved modes."""
    rows = _mode_rows(_words_i64(words))
    units = (rows >= 10, (rows >= 0) & (rows < 10), rows < 0)
    buckets = tuple(torch.nonzero(u).flatten().to(torch.int32)
                    for u in units)
    counts = torch.tensor([len(b) for b in buckets], dtype=torch.int32,
                          device=words.device)
    return counts, buckets


def _bc6h_refine_plain(px: torch.Tensor, words_i32: torch.Tensor, ladder,
                       signed: bool, remap: bool = False,
                       cross2: bool = False, ladder2=None) -> torch.Tensor:
    """Plain twin of K6: px [48, NB] int32 F16-ints, words [4, NB] int32 ->
    refined words [4, NB] int32."""
    px3 = tuple(px.reshape(3, 16, -1))
    out = _refine_bc6h_core(px3, _words_i64(words_i32), ladder, signed,
                            remap, cross2, ladder2)
    return _words_i32(out)


def bc6h_refine_words(px: torch.Tensor, words: torch.Tensor, ladder,
                      signed: bool, remap: bool = False,
                      cross2: bool = False, ladder2=None) -> torch.Tensor:
    """K6 wrapper: the winner-refine ladder. px [48, NB] int32, words
    [4, NB] int32 -> words [4, NB] int32. A CUDA tensor launches the
    kernel, a CPU tensor runs the plain twin."""
    _check_words(words)
    _check_px48(px, words.shape[1])
    ladder = _check_ladder(ladder)
    ladder2 = ladder if ladder2 is None else _check_ladder(ladder2)
    if _on_cuda(px, words):
        return cuda_kernels.bc6h_refine(px, words, ladder, ladder2, signed,
                                        remap, cross2)
    return _bc6h_refine_plain(px, words, ladder, signed, remap, cross2,
                              ladder2)


def refine_bc6h_words(px_int: torch.Tensor, words: torch.Tensor, ladder,
                      signed: bool, remap: bool = False, cross2: bool = False,
                      ladder2=None) -> torch.Tensor:
    """Winner-refine pass (bc67.py:2935): unpack each block's winning state,
    run the quantized-endpoint ladder on it, re-emit where the error drops
    and the row's delta transform still fits. px_int [16, 3, NB] int32
    F16-ints; words [NB, 4] int32 (u32 bit patterns). Returns [NB, 4]."""
    px = px_int.permute(1, 0, 2).reshape(48, -1).contiguous()
    out = bc6h_refine_words(px, words.t().contiguous(), ladder, signed,
                            remap, cross2, ladder2)
    return out.t().contiguous()


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def px_of_blocks(blocks: torch.Tensor, signed: bool) -> torch.Tensor:
    """[NB, 16, >=3] float -> [48, NB] int32 F16-ints, row = channel * 16 +
    pixel (the kernels' layout)."""
    rgb = _f16_to_int(blocks[..., :3], signed)          # [NB, 16, 3]
    return rgb.permute(2, 1, 0).reshape(48, -1).contiguous()


def encode_bc6h(blocks: torch.Tensor, signed: bool, flags: int = 0,
                rows_sel=None) -> torch.Tensor:
    """[NB, 16, 4] f32 -> [NB, 16] u8 (D3DXEncodeBC6HU/S, BC6HBC7.cpp:1817).

    The default tier is the shared-fit search (K5 on a CUDA tensor), or
    with BC6H_SHARED_FIT off (read at each call) the full evaluation per
    (row, candidate) (_search_unshared: K10, the shape ranking and one
    K11 launch for all six precision groups on a CUDA tensor). The
    mid tier (_BC6H_MID, texconv -bc b) adds one re-mapping ladder round at
    the winner's own precision (BC6H_LADDER_MID); the maxq tier
    (_BC7_MAXQUALITY) the full re-mapping ladder over every two-region
    precision group (BC6H_LADDER_MAXQ, cross2). Both refines run as K6.
    Other flag bits (dither, uniform, USE_3SUBSETS, QUICK) are ignored, as
    in the JAX package (bc67.py:3364-3365). rows_sel, and
    BC6H_SHARED_KEEPBETTER on, raise NotImplementedError before any
    work."""
    if rows_sel is not None:
        raise NotImplementedError(
            "rows_sel is a profiling scope of the JAX package and is not "
            "ported (ROADMAP.md queue 2, levers kept out of the kernels)")
    if BC6H_SHARED_KEEPBETTER:
        raise NotImplementedError(
            "BC6H_SHARED_KEEPBETTER is not ported: the JAX package measured "
            "bitwise-identical words without the guard on every HDR probe "
            "content (bc67.py:2084-2092) and ships it off")
    if blocks.dim() != 3 or blocks.shape[1] != 16 or blocks.shape[2] < 3:
        raise ValueError(f"blocks must be [NB, 16, 4], got "
                         f"{tuple(blocks.shape)}")
    nb = blocks.shape[0]
    px = px_of_blocks(blocks, signed)
    if BC6H_SHARED_FIT:
        _, words = bc6h_search_words(px, signed)
    else:
        _, words = _search_unshared(px, signed)
    maxq = bool(flags & _BC7_MAXQUALITY)
    if flags & _BC6H_MID:
        # with maxq set too, the JAX package runs mid first (bc67.py:3405)
        words = bc6h_refine_words(px, words, BC6H_LADDER_MID, signed,
                                  remap=True, cross2=False)
    if maxq:
        words = bc6h_refine_words(px, words, BC6H_LADDER_MAXQ, signed,
                                  remap=True, cross2=True)
    return words.t().contiguous().view(torch.uint8).reshape(nb, 16)
