"""BC7 codec on torch tensors — the default tier (with or without alpha,
at any alpha weight), the QUICK tier, the MAXQUALITY tier and
USE_3SUBSETS (modes 0 and 2) in either of them.

The PyTorch counterpart of directxtex_tpu/bc/bc67.py (reference:
BC6HBC7.cpp). Layouts follow the JAX package: pixel planes are lane-major
[16, 4, NB] int32 (block index minor), packed blocks are 4 u32 words per
block. torch has no usable uint32 on the CPU, so the plain code computes on
the words as int64 holding the u32 value (masked to 32 bits after every
left shift) and hands them across function edges as int32 tensors holding
the u32 bit pattern.

Six wrappers here take their CUDA kernels (cuda_kernels.py, csrc/) or
their plain twins: `bc7_decode_words` (K1), `bc7_search_words` (K2, and
K9 + K7 for modes 0 and 2), `bc7_refine_words` (K3),
`bc7_partition_shapes` (K9), `bc7_partition_mode` (K7) and
`bc7_single_modes` (K8: modes 4, 5 and 6, each mode's winner). Each takes a
CUDA tensor to its kernel and a CPU tensor to its plain version; nothing
else decides. The plain versions take every 16-pixel and per-channel sum
in index order, as the kernels do, so kernel and twin agree bit for bit
wherever the arithmetic allows (no FMA contraction: the kernels build
with --fmad=false).

Encode follows the JAX package's jnp path exactly. The default tier: off-
axis shape ranking, the shared float trajectory for modes 1/3 and for
modes 4/5, mode 6, mode 7 on the blocks with alpha, cross-mode fold in the
order (1, 3, 5, 6, 7, 4) with strict `<`, then one LADDER_MOMENT
winner-refine over modes (1, 3, 5, 7, 4). The QUICK tier searches mode 6
alone and skips the refine. The MAXQUALITY tier fits every mode on its
own (modes 1/3 per shape candidate, modes 4/5 per rotation and, for mode
4, per index mode) and refines the winner twice over every searched mode:
LADDER_MOMENT, then the exact LADDER_FULL ladder. USE_3SUBSETS ranks the
three-subset shapes off-axis (mode 0 over shapes 0..15), evaluates the
top 4 for each of modes 0 and 2 on its own, folds them first, and keeps
both modes in the refine scope. `alpha_weight` scales the alpha
channel's squared error in scoring and index assignment only (under
modes 4/5 the alpha channel sits where the rotation put it).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import cuda_kernels
from ..numerics import rdiv as _div, sqrt as _sqrt, sum0 as _sum0
from .bc67_tables import (BC6H_DESC, BC6H_MODE_INFO, BC6H_MODE_TO_INFO,
                          FIXUPS, PARTITIONS, WEIGHTS2, WEIGHTS3, WEIGHTS4)

__all__ = ["decode_bc7", "encode_bc7", "refine_bc7_words", "tables_as_numpy",
           "bc7_decode_words", "bc7_search_words", "bc7_refine_words",
           "bc7_partition_shapes", "bc7_partition_mode", "bc7_single_modes"]

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class _BC7Mode:
    """ms_aInfo (BC6HBC7.cpp:1106-1125)."""
    partitions: int       # uPartitions (subsets - 1)
    partition_bits: int
    p_bits: int
    rotation_bits: int
    index_mode_bits: int
    index_prec: int
    index_prec2: int
    rgba_prec: tuple      # (r, g, b, a)
    rgba_prec_p: tuple    # with p-bit


_BC7_MODES = [
    _BC7Mode(2, 4, 6, 0, 0, 3, 0, (4, 4, 4, 0), (5, 5, 5, 0)),
    _BC7Mode(1, 6, 2, 0, 0, 3, 0, (6, 6, 6, 0), (7, 7, 7, 0)),
    _BC7Mode(2, 6, 0, 0, 0, 2, 0, (5, 5, 5, 0), (5, 5, 5, 0)),
    _BC7Mode(1, 6, 4, 0, 0, 2, 0, (7, 7, 7, 0), (8, 8, 8, 0)),
    _BC7Mode(0, 0, 0, 2, 1, 2, 3, (5, 5, 5, 6), (5, 5, 5, 6)),
    _BC7Mode(0, 0, 0, 2, 0, 2, 2, (7, 7, 7, 8), (7, 7, 7, 8)),
    _BC7Mode(0, 0, 2, 0, 0, 4, 0, (7, 7, 7, 7), (8, 8, 8, 8)),
    _BC7Mode(1, 6, 4, 0, 0, 2, 0, (5, 5, 5, 5), (6, 6, 6, 6)),
]

# Search constants of the default tier, carried across from the JAX
# package (bc67.py:990-991, :1201-1240, :1506) and pinned equal to it by
# tests/test_torch_tables.py.
BC7_SHAPE_CANDIDATES = 4
_ON_AXIS_W = 0.05
_MODE4_IMS = (0,)
_MODE45_ROTS = (0, 1, 2, 3)
_POWER_ITERS = 3
BC7_SHARED2SUB_IPREC = 3
BC7_SHARED2SUB_ROUNDS = 1
BC7_SHARED45_ROUNDS = 1
# the maxq tier's mode-4 index modes (bc67.py:1953)
_MODE4_IMS_MAXQ = (0, 1)
# refine ladders (bc67.py:724-725, :814): the analytic moment step, and
# the exact perturbation ladders as (rounds, deltas)
LADDER_MOMENT = "moment"
LADDER_FULL = (2, (2, 1))
LADDER_LIGHT = (1, (1,))

# encode_bc7's flags (bc67.py:381-383)
_BC7_QUICK = 0x100000
_BC7_USE_3SUBSETS = 0x80000
_BC7_MAXQUALITY = 0x200000

# search modes in fold order and winner-refine scopes of the tiers the
# port runs (bc67.py:1955-1970): the default tier for opaque images and
# for images with alpha (mode 6 out of the refine), QUICK (no refine);
# the maxq tier refines every mode it searched
SEARCH_MODES = (1, 3, 5, 6, 4)
REFINE_MODES = (1, 3, 5, 4)
SEARCH_MODES_ALPHA = (1, 3, 5, 6, 7, 4)
REFINE_MODES_ALPHA = (1, 3, 5, 7, 4)
SEARCH_MODES_QUICK = (6,)
# USE_3SUBSETS (bc67.py:1958): modes 0 and 2 first in the fold and in
# every tier's refine scope
SEARCH_MODES_3 = (0, 2) + SEARCH_MODES
SEARCH_MODES_3_ALPHA = (0, 2) + SEARCH_MODES_ALPHA
REFINE_MODES_3 = (0, 2) + REFINE_MODES
REFINE_MODES_3_ALPHA = (0, 2) + REFINE_MODES_ALPHA
# the search's tier, an explicit argument of the search (one mode tuple
# serves both tiers): shared fits and mode-4 index mode 0 (default), or
# every mode fitted on its own and both mode-4 index modes (maxq)
TIER_DEFAULT = cuda_kernels.TIER_DEFAULT
TIER_MAXQ = cuda_kernels.TIER_MAXQ


def tables_as_numpy() -> dict:
    """The codec's carried state: the BC6H/BC7 spec tables and the BC7
    search and refine constants."""
    return {
        "PARTITIONS": PARTITIONS, "FIXUPS": FIXUPS,
        "WEIGHTS2": WEIGHTS2, "WEIGHTS3": WEIGHTS3, "WEIGHTS4": WEIGHTS4,
        "BC6H_DESC": BC6H_DESC, "BC6H_MODE_INFO": BC6H_MODE_INFO,
        "BC6H_MODE_TO_INFO": BC6H_MODE_TO_INFO,
        "BC7_SHAPE_CANDIDATES": BC7_SHAPE_CANDIDATES,
        "_ON_AXIS_W": _ON_AXIS_W,
        "_MODE4_IMS": _MODE4_IMS,
        "_MODE45_ROTS": _MODE45_ROTS,
        "_POWER_ITERS": _POWER_ITERS,
        "BC7_SHARED2SUB_IPREC": BC7_SHARED2SUB_IPREC,
        "BC7_SHARED2SUB_ROUNDS": BC7_SHARED2SUB_ROUNDS,
        "BC7_SHARED45_ROUNDS": BC7_SHARED45_ROUNDS,
        "LADDER_MOMENT": LADDER_MOMENT,
        "LADDER_FULL": LADDER_FULL,
        "LADDER_LIGHT": LADDER_LIGHT,
        "_BC7_QUICK": _BC7_QUICK,
        "_BC7_USE_3SUBSETS": _BC7_USE_3SUBSETS,
        "_BC7_MAXQUALITY": _BC7_MAXQUALITY,
    }


# ---------------------------------------------------------------------------
# per-device constant tables
# ---------------------------------------------------------------------------

def _packed_shape_tables_bc7(partitions: int, n_shapes: int):
    """(pp, pa) python-int tables: 2-bit/px partition ids, 4-bit anchors."""
    pp = tuple(int(sum(int(PARTITIONS[partitions][s, i]) << (2 * i)
                       for i in range(16))) for s in range(n_shapes))
    pa = tuple(int(FIXUPS[partitions, s, 1])
               | (int(FIXUPS[partitions, s, 2]) << 4)
               for s in range(n_shapes))
    return pp, pa


def _index_layout(n_partitions: int, prec: int):
    """Per-shape index bit layout: (offsets [64, 16], nbits [64, 16])."""
    offsets = np.zeros((64, 16), np.int64)
    nbits = np.zeros((64, 16), np.int64)
    for s in range(64):
        anchors = {0}
        for p in range(1, n_partitions + 1):
            anchors.add(int(FIXUPS[n_partitions, s, p]))
        off = 0
        for i in range(16):
            nb = prec - 1 if i in anchors else prec
            offsets[s, i] = off
            nbits[s, i] = nb
            off += nb
    return offsets, nbits


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """Constant tables on `device`, built once per device."""
    t = {}
    for parts in (1, 2):
        pp, pa = _packed_shape_tables_bc7(parts, 64)
        t["pp", parts] = torch.tensor(pp, dtype=torch.int64, device=device)
        t["pa", parts] = torch.tensor(pa, dtype=torch.int64, device=device)
    for parts in (1, 2):
        t[f"parts{parts}"] = torch.tensor(PARTITIONS[parts],
                                          dtype=torch.int32, device=device)
        t[f"fix{parts}"] = torch.tensor(FIXUPS[parts], dtype=torch.int64,
                                        device=device)
        # per-shape index layouts: modes 1 (3-bit) and 3, 7 (2-bit) with
        # two subsets, modes 0 (3-bit) and 2 (2-bit) with three
        for prec in (3, 2):
            t["offs", parts, prec] = torch.tensor(
                _index_layout(parts, prec)[0], device=device)
    return t


@functools.lru_cache(maxsize=None)
def _est_tables(device: torch.device, n_shapes: int, partitions: int = 1):
    """Shape-estimate masks [(partitions + 1) * n_shapes, 16] (rows = every
    (subset, shape) pair of the first n_shapes shapes of the class,
    subset-major) and their inverse pixel counts."""
    m_host = np.concatenate([(PARTITIONS[partitions][:n_shapes] == p)
                             .astype(np.float32)
                             for p in range(partitions + 1)], axis=0)
    n_inv = 1.0 / np.maximum(m_host.sum(axis=1), 1.0)
    return (torch.tensor(m_host, device=device),
            torch.tensor(n_inv, dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# bit reads over lane-major int64 words [4, NB]
# ---------------------------------------------------------------------------

def _words_i64(words_i32: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 u32 values."""
    return words_i32.to(torch.int64) & _M32


def _words_i32(words_i64: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 bit patterns (two's-complement wrap)."""
    return torch.where(words_i64 >= (1 << 31), words_i64 - (1 << 32),
                       words_i64).to(torch.int32)


def _gb_t(words, start: int, n: int):
    """Static-offset bit read over words [4, NB] -> [NB] int64."""
    if n == 0:
        return torch.zeros(words.shape[1], dtype=torch.int64,
                           device=words.device)
    wi, sh = start // 32, start % 32
    v = words[wi] >> sh
    if sh + n > 32:
        v = v | ((words[wi + 1] << (32 - sh)) & _M32)
    return v & ((1 << n) - 1)


def _gb_dyn_t(words, start, width_minus, base_width: int):
    """Bit read at per-block offsets. start [NB] int64; width =
    base_width - width_minus (width_minus in {0, 1})."""
    wi = start >> 5
    sh = start & 31
    w0 = words[0]
    w1n = words[1]
    for k in (1, 2, 3):
        hit = wi == k
        w0 = torch.where(hit, words[k], w0)
        w1n = torch.where(hit, words[min(k + 1, 3)], w1n)
    lo = w0 >> sh
    hi = torch.where(sh == 0, 0, (w1n << ((32 - sh) & 31)) & _M32)
    mask = torch.where(width_minus != 0, (1 << (base_width - 1)) - 1,
                       (1 << base_width) - 1)
    return (lo | hi) & mask


def _read_indices(words, base_bit: int, prec: int, a2, a3):
    """Anchor-compressed index reads -> (vals [16][NB] int64, nbits).
    a2/a3: per-block anchor pixels of subsets 1/2 ([NB] or None)."""
    vals = []
    for i in range(16):
        if a2 is not None:
            before = (1 if i > 0 else 0) + (a2 < i).to(torch.int64)
            is_anchor = (a2 == i) | (i == 0)
            if a3 is not None:
                before = before + (a3 < i).to(torch.int64)
                is_anchor = is_anchor | (a3 == i)
            start = base_bit + prec * i - before
            vals.append(_gb_dyn_t(words, start, is_anchor, prec))
        else:
            # single subset: only pixel 0 is an anchor; offsets static
            width = prec - (1 if i == 0 else 0)
            start = base_bit + prec * i - (1 if i > 0 else 0)
            vals.append(_gb_t(words, start, width))
    n_anchors = 1 + (0 if a2 is None else 1) + (0 if a3 is None else 1)
    return vals, 16 * prec - n_anchors


def _pal_weight(k, K: int):
    """round(64k/(K-1)) — the g_aWeights2/3/4 tables — as the JAX
    package's exact multiply-shift (bc67.py:454)."""
    m = -(-65536 // (2 * K - 2))
    return ((128 * k + (K - 1)) * m) >> 16


def _pal_weight_f(kf, K: int):
    """_pal_weight on an f32 index plane: floor(64k/(K-1) + 1/2)."""
    return torch.floor(kf * (64.0 / (K - 1)) + 0.5)


def _unquantize(c, prec: int):
    """(c << (8-p)) | (c >> (2p-8)) (BC6HBC7.cpp:826)."""
    if prec >= 8:
        return c
    c = (c << (8 - prec)) & 0xFF
    return c | (c >> prec)


def _mode_of(words) -> torch.Tensor:
    """Lowest set bit of byte 0 (8 = reserved). words [4, NB] int64."""
    b0 = words[0] & 0xFF
    mode = torch.full_like(b0, 8)
    for mv in range(8):
        hit = (b0 & (1 << mv)) != 0
        mode = torch.where((mode == 8) & hit, mv, mode)
    return mode


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode_bc7_mode_rows(words, mode: int):
    """Decode ALL blocks assuming `mode`. words [4, NB] int64 ->
    [16][4] lists of [NB] int64 texel rows (0..255)."""
    m = _BC7_MODES[mode]
    tabs = _tables(words.device)
    nb = words.shape[1]
    n_sub = m.partitions + 1
    n_ep = n_sub * 2
    bit = mode + 1

    shape = _gb_t(words, bit, m.partition_bits)
    bit += m.partition_bits
    rotation = _gb_t(words, bit, m.rotation_bits)
    bit += m.rotation_bits
    index_mode = _gb_t(words, bit, m.index_mode_bits)
    bit += m.index_mode_bits

    ep = [[None] * 4 for _ in range(n_ep)]
    for ch in range(4):
        prec = m.rgba_prec[ch]
        if prec == 0:
            for e in range(n_ep):
                ep[e][ch] = torch.full((nb,), 255, dtype=torch.int64,
                                       device=words.device)
            continue
        for e in range(n_ep):
            ep[e][ch] = _gb_t(words, bit, prec)
            bit += prec

    if m.p_bits:
        pbits = []
        for _ in range(m.p_bits):
            pbits.append(_gb_t(words, bit, 1))
            bit += 1
        for e in range(n_ep):
            pi = e * m.p_bits // n_ep
            for ch in range(4):
                if m.rgba_prec[ch] != m.rgba_prec_p[ch]:
                    ep[e][ch] = (ep[e][ch] << 1) | pbits[pi]

    for ch in range(4):
        prec = m.rgba_prec_p[ch]
        if prec == 0 or prec >= 8:
            continue
        for e in range(n_ep):
            ep[e][ch] = _unquantize(ep[e][ch], prec)

    a2 = a3 = None
    if m.partitions:
        pp = tabs["pp", m.partitions][shape]
        pa = tabs["pa", m.partitions][shape]
        a2 = pa & 0xF
        if m.partitions == 2:
            a3 = (pa >> 4) & 0xF

    w1, total1 = _read_indices(words, bit, m.index_prec, a2, a3)
    bit += total1
    w2 = _read_indices(words, bit, m.index_prec2, None, None)[0] \
        if m.index_prec2 else w1

    K1 = 1 << m.index_prec
    K2 = 1 << m.index_prec2 if m.index_prec2 else K1
    swap = index_mode == 1

    out_px = []
    for i in range(16):
        e0 = [ep[0][ch] for ch in range(4)]
        e1 = [ep[1][ch] for ch in range(4)]
        if m.partitions:
            reg = (pp >> (2 * i)) & 3
            for sv in range(1, n_sub):
                hit = reg == sv
                e0 = [torch.where(hit, ep[2 * sv][ch], e0[ch])
                      for ch in range(4)]
                e1 = [torch.where(hit, ep[2 * sv + 1][ch], e1[ch])
                      for ch in range(4)]

        wc = _pal_weight(w1[i], K1)
        if m.index_prec2:
            wa = _pal_weight(w2[i], K2)
            wc, wa = (torch.where(swap, wa, wc), torch.where(swap, wc, wa))
        else:
            wa = wc
        px = [((64 - wc) * e0[ch] + wc * e1[ch] + 32) >> 6
              for ch in range(3)]
        px.append(((64 - wa) * e0[3] + wa * e1[3] + 32) >> 6)

        if m.rotation_bits:
            r, g, b, al = px
            nr = torch.where(rotation == 1, al, r)
            ng = torch.where(rotation == 2, al, g)
            nbl = torch.where(rotation == 3, al, b)
            na = torch.where(rotation == 1, r, torch.where(
                rotation == 2, g, torch.where(rotation == 3, b, al)))
            px = [nr, ng, nbl, na]
        out_px.append(px)
    return out_px


def _bc7_decode_plain(words_i32: torch.Tensor) -> torch.Tensor:
    """Plain twin of K1: words [4, NB] int32 -> texels [64, NB] int32
    (row = pixel * 4 + channel); the reserved mode decodes to 0."""
    words = _words_i64(words_i32)
    mode = _mode_of(words)
    out = torch.zeros((16, 4, words.shape[1]), dtype=torch.int64,
                      device=words.device)
    for mv in range(8):
        res = torch.stack([torch.stack(px) for px in
                           _decode_bc7_mode_rows(words, mv)])
        out = torch.where(mode[None, None, :] == mv, res, out)
    return out.reshape(64, -1).to(torch.int32)


def _check_words(words: torch.Tensor) -> None:
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[0] != 4:
        raise ValueError(f"words must be [4, NB] int32, got "
                         f"{tuple(words.shape)} {words.dtype}")


def _check_px(px: torch.Tensor, nb: int | None = None) -> None:
    if px.dtype != torch.int32 or px.dim() != 2 or px.shape[0] != 64 \
            or (nb is not None and px.shape[1] != nb):
        raise ValueError(f"px must be [64, NB] int32, got "
                         f"{tuple(px.shape)} {px.dtype}")


def _on_cuda(*ts: torch.Tensor) -> bool:
    """The kernel gate: CUDA tensors go to the kernel, CPU tensors to the
    plain twin (the analog of pallas_kernels._use_pallas)."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, "
                     f"got {sorted(kinds)}")


def bc7_decode_words(words: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: words [4, NB] int32 (u32 bit patterns) -> texels
    [64, NB] int32. A CUDA tensor launches the kernel, a CPU tensor runs
    the plain twin."""
    _check_words(words)
    if _on_cuda(words):
        return cuda_kernels.bc7_decode(words)
    return _bc7_decode_plain(words)


def _bc7_decode_f32_plain(blocks: torch.Tensor) -> torch.Tensor:
    """Plain twin of K1's f32 epilogue: [NB, 16] u8 -> [NB, 16, 4] f32,
    the words twin followed by decode's conversion."""
    # little-endian bytes -> u32 words, lane-major [4, NB]
    words = blocks.contiguous().view(torch.int32).t().contiguous()
    out = _bc7_decode_plain(words)
    # float(c) * f32(1/255) — the reference's c * (1/255) (BC6HBC7.cpp:427)
    outf = out.clamp(0, 255).to(torch.float32) * (1 / 255)
    return outf.reshape(16, 4, -1).permute(2, 0, 1).contiguous()


def _index_field(i: int, prec: int, a2: int = 16, a3: int = 16):
    """(bit offset from the index set's start, width) of pixel i's index
    in a set of prec-bit indices whose anchor pixels (pixel 0 and the
    fixups a2, a3; 16 = none) hold one bit less: the closed form that the
    decode kernels take per lane (dec::index_offset / index_width in
    csrc/decode_lanes.cuh) in place of the sequential walk."""
    before = (i > 0) + (a2 < i) + (a3 < i)
    anchor = i == 0 or i == a2 or i == a3
    return prec * i - before, prec - anchor


def decode_bc7(blocks: torch.Tensor) -> torch.Tensor:
    """[NB, 16] u8 -> [NB, 16, 4] f32 (D3DXDecodeBC7, bit-exact). A CUDA
    tensor is one K1 launch that reads the packed blocks and writes the
    f32 texels; a CPU tensor runs the plain twin."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 \
            or blocks.shape[1] != 16:
        raise ValueError(f"blocks must be [NB, 16] uint8, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    if _on_cuda(blocks):
        return cuda_kernels.bc7_decode_blocks(blocks)
    return _bc7_decode_f32_plain(blocks)


# ---------------------------------------------------------------------------
# encode primitives (bc67.py:387-699, :1002-1085)
# ---------------------------------------------------------------------------

def _quantize_u8(c, prec: int):
    """Quantize (BC6HBC7.cpp:806): (min(255, c + (1 << (7-p)))) >> (8-p)."""
    if prec >= 8:
        return c
    return (c + (1 << (7 - prec))).clamp(max=255) >> (8 - prec)


def _quantize_endpoints_t(e0f, e1f, m: _BC7Mode):
    """Float endpoints [4, NB] (u8 scale) -> (q0, q1 [4, NB] codes without
    the p bit, p0, p1 [NB]) with the p-bit majority vote."""
    e0 = torch.round(e0f).clamp(0, 255).to(torch.int32)
    e1 = torch.round(e1f).clamp(0, 255).to(torch.int32)
    zero = torch.zeros_like(e0[0])
    q0_rows, q1_rows = [], []
    vote0 = vote1 = zero
    nvote = 0
    for ch in range(4):
        prec, prec_p = m.rgba_prec[ch], m.rgba_prec_p[ch]
        if prec == 0:
            q0_rows.append(zero)
            q1_rows.append(zero)
        elif prec != prec_p:
            f0 = _quantize_u8(e0[ch], prec_p)
            f1 = _quantize_u8(e1[ch], prec_p)
            vote0 = vote0 + (f0 & 1)
            vote1 = vote1 + (f1 & 1)
            nvote += 1
            q0_rows.append(f0 >> 1)
            q1_rows.append(f1 >> 1)
        else:
            q0_rows.append(_quantize_u8(e0[ch], prec))
            q1_rows.append(_quantize_u8(e1[ch], prec))
    if nvote:
        p0 = (vote0 > (nvote >> 1)).to(torch.int32)
        p1 = (vote1 > (nvote >> 1)).to(torch.int32)
    else:
        p0 = p1 = zero
    return torch.stack(q0_rows), torch.stack(q1_rows), p0, p1


def _unquant_channel_t(q, p, prec: int, prec_p: int):
    """One endpoint channel: codes + p bit -> unquantized u8 value."""
    c = ((q << 1) | p) if prec != prec_p else q
    return _unquantize(c, prec_p)


def _unquantize_with_p_t(q0, q1, p0, p1, m: _BC7Mode, shared_p: bool):
    """Quantized codes [4, NB] + p-bits -> unquantized u8 endpoints."""
    if shared_p:
        p1 = p0
    u0_rows, u1_rows = [], []
    for ch in range(4):
        prec, prec_p = m.rgba_prec[ch], m.rgba_prec_p[ch]
        if prec == 0:
            u0_rows.append(torch.full_like(p0, 255))
            u1_rows.append(torch.full_like(p1, 255))
            continue
        u0_rows.append(_unquant_channel_t(q0[ch], p0, prec, prec_p))
        u1_rows.append(_unquant_channel_t(q1[ch], p1, prec, prec_p))
    return torch.stack(u0_rows), torch.stack(u1_rows)


def _assign_indices_t(px_i, u0, u1, prec: int, mask, ch_start: int = 0,
                      ch_end: int = 4, aw: float = 1.0, alpha_ch: int = 3,
                      w_rows=None):
    """Projection-based index assignment (BC7Encode.hlsl:501-533): project
    each pixel onto the endpoint axis, snap to the nearest interpolation
    weight, score with the exact integer palette over channels
    [ch_start, ch_end). px_i [16, 4, NB] int32; u0/u1 [4, NB].
    The squared error of channel alpha_ch is scaled by aw (scoring only;
    the projection stays unweighted); w_rows, per-channel [NB] weights,
    take its place where the alpha channel differs per block (refine of
    modes 4/5). Returns (idx [16, NB] int32, err [NB] f32)."""
    K = 1 << prec
    d0 = [px_i[:, c, :] - u0[c][None, :] for c in range(ch_start, ch_end)]
    e = [u1[c] - u0[c] for c in range(ch_start, ch_end)]
    dot = torch.zeros_like(d0[0])
    span = torch.zeros_like(e[0])
    for d, ee in zip(d0, e):
        dot = dot + d * ee[None, :]
        span = span + ee * ee
    dot = dot.to(torch.float32)
    span = span.to(torch.float32)
    p64 = (dot * _div(64.0, torch.where(span > 0, span, 1.0))[None, :]) \
        .clamp(0.0, 64.0)
    kf = torch.round(p64 * ((K - 1) / 64.0)).to(torch.int32).clamp(0, K - 1)
    # nearest-weight correction: the uniform inverse can land one off
    # because the weight table itself is rounded
    wk = _pal_weight(kf, K)
    wkp = _pal_weight((kf + 1).clamp(max=K - 1), K)
    wkm = _pal_weight((kf - 1).clamp(min=0), K)
    up = (kf < K - 1) & (2.0 * p64 > (wk + wkp).to(torch.float32))
    dn = (kf > 0) & (2.0 * p64 < (wk + wkm).to(torch.float32))
    idx = torch.where(up, kf + 1, torch.where(dn, kf - 1, kf))
    wk = _pal_weight(idx, K)
    # exact integer palette: u0 + ((w (u1-u0) + 32) >> 6)
    dist = torch.zeros_like(p64)
    for c, d, ee in zip(range(ch_start, ch_end), d0, e):
        r = (d - ((wk * ee[None, :] + 32) >> 6)).to(torch.float32)
        dist = dist + _weighted_sq(r, c, aw, alpha_ch, w_rows)
    return idx, _sum0(torch.where(mask, dist, 0.0))


def _weighted_sq(r, c: int, aw: float, alpha_ch: int, w_rows):
    """r * r of channel c, times its alpha weight (bc67.py:510-519)."""
    if w_rows is not None:
        return r * r * w_rows[c][None, :]
    if c == alpha_ch and aw != 1.0:
        return r * r * aw
    return r * r


def _ls_refit(px_f, x, mask, e0, e1, ch_start: int, ch_end: int):
    """Least-squares endpoint refit with per-pixel weights x = w/64 over
    channels [ch_start, ch_end); other rows pass through."""
    m = mask.to(torch.float32)
    a = (1.0 - x) * m
    b = x * m
    A = _sum0(a * a)
    B = _sum0(a * b)
    C = _sum0(b * b)
    det = A * C - B * B
    ok = torch.abs(det) > 1e-6
    inv = _div(1.0, torch.where(ok, det, 1.0))
    e0_rows = [e0[c] for c in range(4)]
    e1_rows = [e1[c] for c in range(4)]
    for c in range(ch_start, ch_end):
        r0 = _sum0(a * px_f[:, c, :])
        r1 = _sum0(b * px_f[:, c, :])
        n0 = ((C * r0 - B * r1) * inv).clamp(0.0, 255.0)
        n1 = ((A * r1 - B * r0) * inv).clamp(0.0, 255.0)
        e0_rows[c] = torch.where(ok, n0, e0_rows[c])
        e1_rows[c] = torch.where(ok, n1, e1_rows[c])
    return torch.stack(e0_rows), torch.stack(e1_rows)


def _ls_refit_t(px_f, idx, mask, prec: int, e0, e1, ch_start=0, ch_end=4):
    """LS refit from an int32 index plane (bc67.py:524)."""
    x = _pal_weight(idx, 1 << prec).to(torch.float32) * (1 / 64)
    return _ls_refit(px_f, x, mask, e0, e1, ch_start, ch_end)


def _ls_refit_f_t(px_f, idx_f, mask, iprec: int, e0, e1, ch_start=0,
                  ch_end=3):
    """LS refit from an f32 index plane (bc67.py:1056)."""
    x = _pal_weight_f(idx_f, 1 << iprec) * (1 / 64)
    return _ls_refit(px_f, x, mask, e0, e1, ch_start, ch_end)


def _minmax_axis_endpoints_t(px_f, mask, with_alpha: bool):
    """Initial endpoints: masked min/max box + best-diagonal axis pick
    (OptimizeRGBA init, BC6HBC7.cpp:1392-1460). px_f [16, 4, NB];
    mask [16, NB]. Returns e0, e1 [4, NB]."""
    m = mask[:, None, :]
    mi = torch.where(m, px_f, 1e9).amin(dim=0)                   # [4, NB]
    ma = torch.where(m, px_f, -1e9).amax(dim=0)
    mid = (mi + ma) * 0.5
    ab = ma - mi
    nch = 4 if with_alpha else 3
    fab = _sum0(ab[:nch] * ab[:nch])
    dirv = ab / torch.where(fab > 0, fab, 1.0)[None, :]
    pt = (px_f - mid[None, :, :]) * dirv[None, :, :] * m           # [16,4,NB]

    best_score = torch.full_like(fab, -1.0)
    best_sg = torch.ones_like(fab)
    best_sb = torch.ones_like(fab)
    best_sa = torch.ones_like(fab)
    signs = [(sg, sb, sa)
             for sg in (1.0, -1.0) for sb in (1.0, -1.0)
             for sa in ((1.0, -1.0) if with_alpha else (1.0,))]
    for sg, sb, sa in signs:
        f = pt[:, 0, :] + sg * pt[:, 1, :] + sb * pt[:, 2, :]
        if with_alpha:
            f = f + sa * pt[:, 3, :]
        score = _sum0(f * f)
        better = score > best_score
        best_score = torch.where(better, score, best_score)
        best_sg = torch.where(better, sg, best_sg)
        best_sb = torch.where(better, sb, best_sb)
        best_sa = torch.where(better, sa, best_sa)

    def flip(lo, hi, sgn):
        return torch.where(sgn < 0, hi, lo), torch.where(sgn < 0, lo, hi)

    g0, g1 = flip(mi[1], ma[1], best_sg)
    b0, b1 = flip(mi[2], ma[2], best_sb)
    if with_alpha:
        a0, a1 = flip(mi[3], ma[3], best_sa)
    else:
        a0, a1 = mi[3], ma[3]
    return torch.stack([mi[0], g0, b0, a0]), torch.stack([ma[0], g1, b1, a1])


def _float_assign_ch_t(px_f, e0, e1, iprec: int, ch_start: int,
                       ch_end: int):
    """Float-endpoint palette assignment over a channel range: the
    precision-free trajectory step of the shared fits (bc67.py:1002, with
    BC7_SHARED_KEEPBETTER off, so the index plane only). Returns idx as an
    integer-valued f32 plane [16, NB]."""
    K = 1 << iprec
    dot = torch.zeros_like(px_f[:, 0, :])
    span = torch.zeros_like(e0[0])
    for c in range(ch_start, ch_end):
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


def _put_static(words, v, offset: int, nbits: int) -> None:
    """OR value rows [NB] int64 into words (list of 4 int64 rows) at a
    static bit offset (_scatter_bits, bc67.py:601)."""
    wi, sh = offset // 32, offset % 32
    words[wi] = words[wi] | ((v << sh) & _M32)
    if sh and sh + nbits > 32:
        words[wi + 1] = words[wi + 1] | (v >> (32 - sh))


def _put_dynamic(words, v, offset) -> None:
    """OR value rows [NB] int64 into words at per-block bit offsets."""
    wi = offset >> 5
    sh = offset & 31
    for w in range(4):
        lo = torch.where(wi == w, (v << sh) & _M32, 0)
        hi = torch.where((wi == w - 1) & (sh != 0),
                         v >> ((32 - sh) & 31), 0)
        words[w] = words[w] | lo | hi


def _emit_bc7(mode_id: int, shape, rotation, index_mode, q0_list, q1_list,
              p0_list, p1_list, idx1, idx2, nb: int, device):
    """Pack one candidate into words [4, NB] int64 (EmitBlock,
    BC6HBC7.cpp:3221). shape/rotation/index_mode: python int or [NB]
    tensor; q0_list/q1_list: per-subset [4, NB] codes; idx1/idx2 [16, NB]
    full-precision indices (anchor compression via the per-shape layout
    tables)."""
    m = _BC7_MODES[mode_id]
    n_sub = m.partitions + 1

    def row(v):
        if isinstance(v, int):
            return torch.full((nb,), v, dtype=torch.int64, device=device)
        return v.to(torch.int64)

    words = [torch.zeros(nb, dtype=torch.int64, device=device)
             for _ in range(4)]
    _put_static(words, row(1 << mode_id), 0, mode_id + 1)
    bit = mode_id + 1
    for val, n in ((shape, m.partition_bits), (rotation, m.rotation_bits),
                   (index_mode, m.index_mode_bits)):
        if n:
            _put_static(words, row(val), bit, n)
            bit += n
    for ch in range(4):
        prec = m.rgba_prec[ch]
        if prec == 0:
            continue
        for sub in range(n_sub):
            _put_static(words, row(q0_list[sub][ch]), bit, prec)
            bit += prec
            _put_static(words, row(q1_list[sub][ch]), bit, prec)
            bit += prec
    if m.p_bits:
        for sub in range(n_sub):
            _put_static(words, row(p0_list[sub]), bit, 1)
            bit += 1
            if m.p_bits != n_sub:          # per-endpoint (not mode 1's shared)
                _put_static(words, row(p1_list[sub]), bit, 1)
                bit += 1
    # index section 1: anchor-compressed widths depend on the shape
    if m.partitions:
        tabs = _tables(device)
        offs = tabs["offs", m.partitions, m.index_prec][row(shape)].t() + bit
        for i in range(16):
            _put_dynamic(words, row(idx1[i]), offs[i])
        bit += 16 * m.index_prec - n_sub
    else:
        offs, nbits = _index_layout(0, m.index_prec)
        for i in range(16):
            _put_static(words, row(idx1[i]), bit + int(offs[0, i]),
                        int(nbits[0, i]))
        bit += 16 * m.index_prec - 1
    if m.index_prec2 and idx2 is not None:
        offs, nbits = _index_layout(0, m.index_prec2)
        for i in range(16):
            _put_static(words, row(idx2[i]), bit + int(offs[0, i]),
                        int(nbits[0, i]))
    return torch.stack(words)


def _anchor_swaps(idx_full, mask_list, anchors, prec: int, q0s, q1s, p0s,
                  p1s):
    """Anchor fixes (AssignIndices, BC6HBC7.cpp:3181-3194): a subset whose
    anchor index has its MSB set swaps endpoints and inverts indices.
    Updates the per-subset lists in place; returns the new index plane."""
    msb = 1 << (prec - 1)
    maxi = (1 << prec) - 1
    for sub, (mask, anchor) in enumerate(zip(mask_list, anchors)):
        if isinstance(anchor, int):
            a_idx = idx_full[anchor]
        else:
            a_idx = torch.gather(idx_full, 0, anchor[None, :])[0]
        swap = (a_idx & msb) != 0
        q0s[sub], q1s[sub] = (torch.where(swap[None, :], q1s[sub], q0s[sub]),
                              torch.where(swap[None, :], q0s[sub], q1s[sub]))
        p0s[sub], p1s[sub] = (torch.where(swap, p1s[sub], p0s[sub]),
                              torch.where(swap, p0s[sub], p1s[sub]))
        idx_full = torch.where(swap[None, :] & mask, maxi - idx_full,
                               idx_full)
    return idx_full


def _dual_anchor_fix(w1, w2, prec1: int, prec2: int):
    """Independent anchor fixes of the two index sets of modes 4/5
    (BC6HBC7.cpp:3196-3216). Returns (w1, w2, swap1, swap2)."""
    msb1, maxi1 = 1 << (prec1 - 1), (1 << prec1) - 1
    msb2, maxi2 = 1 << (prec2 - 1), (1 << prec2) - 1
    swap1 = (w1[0] & msb1) != 0
    swap2 = (w2[0] & msb2) != 0
    w1 = torch.where(swap1[None, :], maxi1 - w1, w1)
    w2 = torch.where(swap2[None, :], maxi2 - w2, w2)
    return w1, w2, swap1, swap2


# ---------------------------------------------------------------------------
# search (bc67.py:908-1595, :2003-2041)
# ---------------------------------------------------------------------------

def _shape_estimates_table(px_f, n_shapes: int = 64,
                           axis_w: float = _ON_AXIS_W, partitions: int = 1):
    """[n_shapes, NB] off-axis error proxy for the first n_shapes shapes
    of a partition class (_shape_estimates_table(off_axis=True),
    bc67.py:1243): per (shape, subset) the within-subset RGB SSE minus
    (1 - axis_w)x its dominant-axis variance (3 power iterations), floored
    at 0, summed over the subsets in subset order. px_f [16, 4, NB];
    partitions 1 (two subsets) or 2 (three). BC7 ranks its shapes at
    _ON_AXIS_W, BC6H its 32 two-subset shapes at axis_w=0 with a zero
    alpha plane."""
    masks, n_inv = _est_tables(px_f.device, n_shapes, partitions)
    mu = _sum0(px_f) * (1 / 16)                       # [4, NB]
    xc = px_f - mu[None, :, :]                        # [16, 4, NB]
    q = _sum0((xc * xc).transpose(0, 1))              # [16, NB]
    pairs = [(a, b) for a in range(3) for b in range(a, 3)]
    rhs = torch.cat([q[:, None, :], xc,
                     torch.stack([xc[:, a, :] * xc[:, b, :]
                                  for a, b in pairs], dim=1)], dim=1)
    # masked 16-pixel sums for every (subset, shape) row, in pixel order
    s_all = masks[:, 0, None, None] * rhs[0][None]
    for k in range(1, 16):
        s_all = s_all + masks[:, k, None, None] * rhs[k][None]

    est = torch.zeros_like(s_all[:n_shapes, 0])
    for p in range(partitions + 1):
        sp = s_all[p * n_shapes:(p + 1) * n_shapes]   # [S, 11, NB]
        ninv = n_inv[p * n_shapes:(p + 1) * n_shapes][:, None]
        s1 = sp[:, 1:5]
        sse = sp[:, 0] - _sum0((s1 * s1).transpose(0, 1)) * ninv
        cov = {}
        for k, (a, b) in enumerate(pairs):
            cov[a, b] = cov[b, a] = \
                sp[:, 5 + k] - sp[:, 1 + a] * sp[:, 1 + b] * ninv
        # dominant eigenvalue by unrolled power iteration
        v = [torch.ones_like(sse) for _ in range(3)]
        for _ in range(_POWER_ITERS):
            w = [cov[a, 0] * v[0] + cov[a, 1] * v[1] + cov[a, 2] * v[2]
                 for a in range(3)]
            nrm = _sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
            inv = _div(1.0, nrm.clamp(min=1e-20))
            v = [x * inv for x in w]
        lam = sum((v[a] * (cov[a, 0] * v[0] + cov[a, 1] * v[1]
                           + cov[a, 2] * v[2]) for a in range(1, 3)),
                  start=v[0] * (cov[0, 0] * v[0] + cov[0, 1] * v[1]
                                + cov[0, 2] * v[2]))
        est = est + (sse - lam * (1.0 - axis_w)).clamp(min=0.0)
    return est


def _top_k_shapes(ests, k: int):
    """Per-block indices of the k smallest estimates (first index wins a
    tie, as jnp.argmin). ests [S, NB]."""
    picks = []
    work = ests
    rows = torch.arange(ests.shape[0], device=ests.device)[:, None]
    for _ in range(min(k, ests.shape[0])):
        s_blk = torch.argmin(work, dim=0)
        picks.append(s_blk)
        work = torch.where(rows == s_blk[None, :], float("inf"), work)
    return picks


def _top4_merge_plain(ests, n_slices: int = 4):
    """Plain twin of K2 opaque's slice-and-merge ranking: warp w of a CTA
    ranks the shapes w, w + n_slices, ... and keeps its top 4 by
    (estimate, shape); the four lists are merged by the same total order,
    the lower shape first on an equal estimate. Returns what
    _top_k_shapes(ests, 4) returns: 4 [NB] int64 shape indices in rank
    order. ests [S, NB]."""
    nb = ests.shape[1]
    entries = []
    for w in range(n_slices):
        sub = ests[w::n_slices]
        for p in _top_k_shapes(sub, 4):
            entries.append((torch.gather(sub, 0, p[None])[0],
                            p * n_slices + w))
    bv = [torch.full((nb,), float("inf"), device=ests.device)] * 4
    bi = [torch.full((nb,), ests.shape[0], dtype=torch.int64,
                     device=ests.device)] * 4

    def before(e1, s1, e2, s2):
        return (e1 < e2) | ((e1 == e2) & (s1 < s2))

    for e, s in entries:
        ins = before(e, s, bv[3], bi[3])
        bv[3] = torch.where(ins, e, bv[3])
        bi[3] = torch.where(ins, s, bi[3])
        for j in (2, 1, 0):
            sw = before(bv[j + 1], bi[j + 1], bv[j], bi[j])
            bv[j], bv[j + 1] = (torch.where(sw, bv[j + 1], bv[j]),
                                torch.where(sw, bv[j], bv[j + 1]))
            bi[j], bi[j + 1] = (torch.where(sw, bi[j + 1], bi[j]),
                                torch.where(sw, bi[j], bi[j + 1]))
    return bi


def _eval_2sub_shared(px_i, px_f, mask_list, anchors, mode_ids,
                      aw: float = 1.0):
    """One shape candidate for the 2-subset family (bc67.py:1088): ONE
    float trajectory per subset steers both modes' endpoint fits; each mode
    quantizes it at its own precision and rescores exactly once.
    Returns {mode_id: (err, q0s, q1s, p0s, p1s, idx)}."""
    iprec_s = BC7_SHARED2SUB_IPREC
    shared = []
    for mask in mask_list:
        e0c, e1c = _minmax_axis_endpoints_t(px_f, mask, with_alpha=False)
        idx_b = _float_assign_ch_t(px_f, e0c, e1c, iprec_s, 0, 3)
        for r in range(BC7_SHARED2SUB_ROUNDS):
            e0c, e1c = _ls_refit_f_t(px_f, idx_b, mask, iprec_s, e0c, e1c)
            if r < BC7_SHARED2SUB_ROUNDS - 1:
                idx_b = _float_assign_ch_t(px_f, e0c, e1c, iprec_s, 0, 3)
        shared.append((e0c, e1c))

    out = {}
    for mode_id in mode_ids:
        m = _BC7_MODES[mode_id]
        shared_p = m.p_bits == (m.partitions + 1) and m.p_bits > 0
        prec = m.index_prec
        total_err = torch.zeros_like(px_f[0, 0])
        q0s, q1s, p0s, p1s = [], [], [], []
        idx_full = torch.zeros_like(px_i[:, 0, :])
        for sub, mask in enumerate(mask_list):
            e0c, e1c = shared[sub]
            q0, q1, p0, p1 = _quantize_endpoints_t(e0c, e1c, m)
            u0, u1 = _unquantize_with_p_t(q0, q1, p0, p1, m, shared_p)
            idx, err = _assign_indices_t(px_i, u0, u1, prec, mask, aw=aw)
            total_err = total_err + err
            q0s.append(q0)
            q1s.append(q1)
            p0s.append(p0)
            p1s.append(p1)
            idx_full = torch.where(mask, idx, idx_full)
        idx_full = _anchor_swaps(idx_full, mask_list, anchors, prec,
                                 q0s, q1s, p0s, p1s)
        out[mode_id] = (total_err, q0s, q1s, p0s, p1s, idx_full)
    return out


def _try_2sub_modes_shared(px_i, px_f, ests, aw: float = 1.0):
    """Modes 1 and 3 (bc67.py:1169): the top BC7_SHAPE_CANDIDATES shapes,
    each evaluated for both modes off one float trajectory, folded per
    mode. Returns {mode_id: (err [NB], words [4, NB] int64)}."""
    tabs = _tables(px_i.device)
    nb = px_i.shape[2]
    best = {mode_id: (torch.full((nb,), float("inf"), device=px_i.device),
                      torch.zeros((4, nb), dtype=torch.int64,
                                  device=px_i.device))
            for mode_id in (1, 3)}
    for s_blk in _top_k_shapes(ests, BC7_SHAPE_CANDIDATES):
        pmask = tabs["parts1"][s_blk].t()                    # [16, NB]
        mask_list = [pmask == 0, pmask == 1]
        anchors = [0, tabs["fix1"][s_blk, 1]]
        evals = _eval_2sub_shared(px_i, px_f, mask_list, anchors, (1, 3),
                                  aw)
        for mode_id in (1, 3):
            err, q0s, q1s, p0s, p1s, idx = evals[mode_id]
            words = _emit_bc7(mode_id, s_blk, 0, 0, q0s, q1s, p0s, p1s,
                              idx, None, nb, px_i.device)
            b_err, b_words = best[mode_id]
            better = err < b_err
            best[mode_id] = (torch.minimum(err, b_err),
                             torch.where(better[None, :], words, b_words))
    return best


def _shared_p(m: _BC7Mode) -> bool:
    """One p bit per subset, shared by both endpoints (mode 1)."""
    return m.p_bits == (m.partitions + 1) and m.p_bits > 0


def _fit_subset_plain(px_i, px_f, mask, mode_id: int, aw: float = 1.0):
    """One subset of a mode fitted on its own (_eval_subset_candidate's
    per-subset part, bc67.py:908): axis fit, quantize and assign, one LS
    refit and re-assign, keep the better. Returns (err [NB], q0, q1 [4, NB],
    p0, p1 [NB], idx [16, NB] of all 16 pixels; the caller keeps those in
    `mask`)."""
    m = _BC7_MODES[mode_id]
    shared_p = _shared_p(m)
    prec = m.index_prec

    def qpal(e0f_, e1f_):
        q0, q1, p0, p1 = _quantize_endpoints_t(e0f_, e1f_, m)
        u0, u1 = _unquantize_with_p_t(q0, q1, p0, p1, m, shared_p)
        idx, err = _assign_indices_t(px_i, u0, u1, prec, mask, aw=aw)
        return q0, q1, p0, p1, idx, err

    e0f, e1f = _minmax_axis_endpoints_t(px_f, mask,
                                        with_alpha=m.rgba_prec[3] > 0)
    q0a, q1a, p0a, p1a, idx_a, err_a = qpal(e0f, e1f)
    e0c, e1c = _ls_refit_t(px_f, idx_a, mask, prec, e0f, e1f)
    q0b, q1b, p0b, p1b, idx_r, err_r = qpal(e0c, e1c)
    better = err_r < err_a
    return (torch.where(better, err_r, err_a),
            torch.where(better[None, :], q0b, q0a),
            torch.where(better[None, :], q1b, q1a),
            torch.where(better, p0b, p0a), torch.where(better, p1b, p1a),
            torch.where(better[None, :], idx_r, idx_a))


def _eval_subset_candidate(px_i, px_f, mask_list, anchors, mode_id: int,
                           aw: float = 1.0):
    """One (mode, shape) candidate (bc67.py:908): each subset fitted on its
    own (_fit_subset_plain), then anchor swaps. Returns (err [NB], q0s,
    q1s, p0s, p1s [lists], idx [16, NB])."""
    prec = _BC7_MODES[mode_id].index_prec
    total_err = torch.zeros_like(px_f[0, 0])
    q0s, q1s, p0s, p1s = [], [], [], []
    idx_full = torch.zeros_like(px_i[:, 0, :])
    for mask in mask_list:
        err, q0, q1, p0, p1, idx = _fit_subset_plain(px_i, px_f, mask,
                                                     mode_id, aw)
        q0s.append(q0)
        q1s.append(q1)
        p0s.append(p0)
        p1s.append(p1)
        total_err = total_err + err
        idx_full = torch.where(mask, idx, idx_full)
    idx_full = _anchor_swaps(idx_full, mask_list, anchors, prec,
                             q0s, q1s, p0s, p1s)
    return total_err, q0s, q1s, p0s, p1s, idx_full


def _try_mode6(px_i, px_f, aw: float = 1.0):
    """Mode 6 (_try_single_mode(6), bc67.py:1438): one subset, joint RGBA
    indices. Returns (err [NB], words [4, NB] int64)."""
    nb = px_i.shape[2]
    mask = torch.ones((16, nb), dtype=torch.bool, device=px_i.device)
    err, q0s, q1s, p0s, p1s, idx = _eval_subset_candidate(
        px_i, px_f, [mask], [0], 6, aw)
    return err, _emit_bc7(6, 0, 0, 0, q0s, q1s, p0s, p1s, idx, None, nb,
                          px_i.device)


# blocks per plain-search slice: bounds the [192, 11, n] shape-sum planes
# when the plain twins run at full image size (results are per block, so
# slicing changes nothing)
_PLAIN_SEARCH_SLICE = 32768


def _partition_candidates(px_i, px_f, s_blks, mode_id: int,
                          aw: float = 1.0):
    """One partition mode (0, 1, 2, 3, 7) over given shape candidates
    (_try_partition_mode's candidate loop, bc67.py:1370-1384): each
    candidate evaluated on its own (per subset: axis fit, one LS refit,
    keep the better; then anchor swaps), emitted, and folded with a strict
    `<`. s_blks: a list of [NB] shape rows. Returns (err [NB], words
    [4, NB] int64)."""
    m = _BC7_MODES[mode_id]
    tabs = _tables(px_i.device)
    nb = px_i.shape[2]
    best_err = torch.full((nb,), float("inf"), device=px_i.device)
    best_words = torch.zeros((4, nb), dtype=torch.int64, device=px_i.device)
    for s_blk in s_blks:
        s_blk = s_blk.to(torch.int64)
        pmask = tabs[f"parts{m.partitions}"][s_blk].t()      # [16, NB]
        mask_list = [pmask == p for p in range(m.partitions + 1)]
        anchors = [0] + [tabs[f"fix{m.partitions}"][s_blk, p]
                         for p in range(1, m.partitions + 1)]
        err, q0s, q1s, p0s, p1s, idx = _eval_subset_candidate(
            px_i, px_f, mask_list, anchors, mode_id, aw)
        words = _emit_bc7(mode_id, s_blk, 0, 0, q0s, q1s, p0s, p1s, idx,
                          None, nb, px_i.device)
        better = err < best_err
        best_err = torch.minimum(err, best_err)
        best_words = torch.where(better[None, :], words, best_words)
    return best_err, best_words


def _try_partition_mode(px_i, px_f, mode_id: int, ests, aw: float = 1.0):
    """One partition mode fitted on its own (_try_partition_mode,
    bc67.py:1337, jnp branch): modes 0 and 2 (USE_3SUBSETS, on the
    three-subset ranking), modes 1 and 3 in the maxq tier and mode 7 in
    every tier (on the two-subset ranking). The K9 twin's top-k of the
    shape estimates `ests` (mode 0 ranks only shapes 0..15, its partition
    field's), then the K7 twin's candidate evaluation. Returns (err [NB],
    words [4, NB] int64); mode 7's opaque blocks are not masked here (the
    search does that)."""
    ests = ests[:1 << _BC7_MODES[mode_id].partition_bits]
    return _partition_candidates(
        px_i, px_f, _top_k_shapes(ests, BC7_SHAPE_CANDIDATES), mode_id, aw)


def _partition_shapes_plain(px: torch.Tensor, partitions: int,
                            n_shapes: int, n_cand: int) -> torch.Tensor:
    """Plain twin of K9: px [64, NB] int32 -> the n_cand shapes of least
    off-axis estimate per block, s_blks [n_cand, NB] int32, in rank order
    (a tie keeps the lower shape first)."""
    out = []
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        px_f = px[:, s:s + _PLAIN_SEARCH_SLICE].reshape(16, 4, -1) \
            .to(torch.float32)
        ests = _shape_estimates_table(px_f, n_shapes, partitions=partitions)
        out.append(torch.stack(_top_k_shapes(ests, n_cand)))
    return torch.cat(out, dim=1).to(torch.int32)


def _partition_mode_plain(px: torch.Tensor, s_blks: torch.Tensor,
                          mode_id: int, aw: float = 1.0):
    """Plain twin of K7: px [64, NB] int32, s_blks [C, NB] int32 shape
    candidates -> (err [NB] f32, words [4, NB] int32) of mode_id (0, 1, 2,
    3 or 7), the best candidate by a strict `<` in candidate order."""
    errs, words = [], []
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        px_i = px[:, s:s + _PLAIN_SEARCH_SLICE].reshape(16, 4, -1)
        sb = s_blks[:, s:s + _PLAIN_SEARCH_SLICE]
        err, w = _partition_candidates(px_i, px_i.to(torch.float32),
                                       list(sb), mode_id, aw)
        errs.append(err)
        words.append(_words_i32(w))
    return torch.cat(errs), torch.cat(words, dim=1)


def _check_partition_shapes(partitions: int, n_shapes: int, n_cand: int):
    if partitions not in (1, 2) or not 1 <= n_shapes <= 64 \
            or not 1 <= n_cand <= n_shapes:
        raise ValueError(f"partition shapes: partitions 1 or 2, 1-64 "
                         f"shapes, 1..n_shapes candidates; got "
                         f"{(partitions, n_shapes, n_cand)}")


def bc7_partition_shapes(px: torch.Tensor, partitions: int, n_shapes: int,
                         n_cand: int = BC7_SHAPE_CANDIDATES) -> torch.Tensor:
    """K9 wrapper (partition_shapes_pallas, off-axis at _ON_AXIS_W): px
    [64, NB] int32 -> s_blks [n_cand, NB] int32, the top n_cand of the
    first n_shapes shapes with partitions + 1 subsets. A CUDA tensor
    launches the kernel, a CPU tensor runs the plain twin."""
    _check_px(px)
    _check_partition_shapes(partitions, n_shapes, n_cand)
    if _on_cuda(px):
        return cuda_kernels.bc7_partition_shapes(px, partitions, n_shapes,
                                                 n_cand)
    return _partition_shapes_plain(px, partitions, n_shapes, n_cand)


def bc7_partition_mode(px: torch.Tensor, s_blks: torch.Tensor, mode_id: int,
                       aw: float = 1.0):
    """K7 wrapper (partition_mode_pallas): px [64, NB] int32, s_blks
    [C, NB] int32 -> (err [NB] f32, words [4, NB] int32) of partition mode
    mode_id (0, 1, 2, 3 or 7). A CUDA tensor launches the kernel, a CPU
    tensor runs the plain twin."""
    _check_px(px)
    if s_blks.dtype != torch.int32 or s_blks.dim() != 2 \
            or s_blks.shape[1] != px.shape[1]:
        raise ValueError(f"s_blks must be [C, NB] int32, got "
                         f"{tuple(s_blks.shape)} {s_blks.dtype}")
    if mode_id not in (0, 1, 2, 3, 7):
        raise ValueError(f"partition modes are 0, 1, 2, 3, 7; got {mode_id}")
    if _on_cuda(px, s_blks):
        return cuda_kernels.bc7_partition_mode(px, s_blks, mode_id, aw)
    return _partition_mode_plain(px, s_blks, mode_id, aw)


def _rotate(px, rot: int):
    """Modes 4/5 rotation: swap channel rot-1 with alpha (plane copy)."""
    if rot == 0:
        return px
    perm = [0, 1, 2, 3]
    perm[rot - 1], perm[3] = 3, rot - 1
    return px[:, perm, :]


def _try_modes45_shared(px_i, px_f, aw: float = 1.0):
    """Modes 4 and 5 at index-mode 0 (bc67.py:1509): per rotation ONE float
    trajectory (color at 2-bit, alpha at 3-bit index width) steers both
    modes; each quantizes and rescores exactly once. The alpha weight
    rides the true alpha channel, which rotation rot moves to rot - 1.
    Returns {mode_id: (err [NB], words [4, NB] int64)}."""
    nb = px_i.shape[2]
    mask = torch.ones((16, nb), dtype=torch.bool, device=px_i.device)
    best = {mode_id: (torch.full((nb,), float("inf"), device=px_i.device),
                      torch.zeros((4, nb), dtype=torch.int64,
                                  device=px_i.device))
            for mode_id in (4, 5)}
    for rot in _MODE45_ROTS:
        pr_i, pr_f = _rotate(px_i, rot), _rotate(px_f, rot)
        alpha_ch = 3 if rot == 0 else rot - 1
        e0f, e1f = _minmax_axis_endpoints_t(pr_f, mask, with_alpha=False)
        e0f = torch.cat([e0f[:3], pr_f[:, 3, :].amin(dim=0)[None]])
        e1f = torch.cat([e1f[:3], pr_f[:, 3, :].amax(dim=0)[None]])

        cidx = _float_assign_ch_t(pr_f, e0f, e1f, 2, 0, 3)
        aidx = _float_assign_ch_t(pr_f, e0f, e1f, 3, 3, 4)
        e0s, e1s = e0f, e1f
        for r in range(BC7_SHARED45_ROUNDS):
            e0s, e1s = _ls_refit_f_t(pr_f, cidx, mask, 2, e0s, e1s, 0, 3)
            e0s, e1s = _ls_refit_f_t(pr_f, aidx, mask, 3, e0s, e1s, 3, 4)
            if r < BC7_SHARED45_ROUNDS - 1:
                cidx = _float_assign_ch_t(pr_f, e0s, e1s, 2, 0, 3)
                aidx = _float_assign_ch_t(pr_f, e0s, e1s, 3, 3, 4)

        for mode_id in (4, 5):
            m = _BC7_MODES[mode_id]
            cprec, aprec = m.index_prec, m.index_prec2       # index-mode 0
            q0, q1, p0, p1 = _quantize_endpoints_t(e0s, e1s, m)
            u0, u1 = _unquantize_with_p_t(q0, q1, p0, p1, m, False)
            w1, cerr = _assign_indices_t(pr_i, u0, u1, cprec, mask, 0, 3,
                                         aw, alpha_ch)
            w2, aerr = _assign_indices_t(pr_i, u0, u1, aprec, mask, 3, 4,
                                         aw, alpha_ch)
            err = cerr + aerr
            w1, w2, swap1, swap2 = _dual_anchor_fix(w1, w2, cprec, aprec)
            do_swap = torch.stack([swap1, swap1, swap1, swap2])
            q0f = torch.where(do_swap, q1, q0)
            q1f = torch.where(do_swap, q0, q1)
            words = _emit_bc7(mode_id, 0, rot, 0, [q0f], [q1f], [p0], [p1],
                              w1, w2, nb, px_i.device)
            b_err, b_words = best[mode_id]
            better = err < b_err
            best[mode_id] = (torch.minimum(err, b_err),
                             torch.where(better[None, :], words, b_words))
    return best


def _dual_eval_t(pr_i, pr_f, mode_id: int, im: int, aw: float = 1.0,
                 alpha_ch: int = 3):
    """One (rotation, index mode) candidate of mode 4 or 5 fitted on its
    own (_dual_eval_ref, bc67.py:1387): RGB axis fit with alpha min/max
    endpoints, quantize, colour and alpha assignment at the index mode's
    two precisions, one LS refit per group, re-evaluate, keep the better.
    pr_i/pr_f: the rotated pixels. Returns (q0, q1 [4, NB], cidx, aidx
    [16, NB], err [NB])."""
    m = _BC7_MODES[mode_id]
    mask = torch.ones((16, pr_i.shape[2]), dtype=torch.bool,
                      device=pr_i.device)
    cprec = m.index_prec2 if im else m.index_prec
    aprec = m.index_prec if im else m.index_prec2

    def qpal(e0f_, e1f_):
        q0, q1, p0, p1 = _quantize_endpoints_t(e0f_, e1f_, m)
        u0, u1 = _unquantize_with_p_t(q0, q1, p0, p1, m, False)
        cidx, cerr = _assign_indices_t(pr_i, u0, u1, cprec, mask, 0, 3, aw,
                                       alpha_ch)
        aidx, aerr = _assign_indices_t(pr_i, u0, u1, aprec, mask, 3, 4, aw,
                                       alpha_ch)
        return q0, q1, cidx, aidx, cerr + aerr

    e0f, e1f = _minmax_axis_endpoints_t(pr_f, mask, with_alpha=False)
    e0f = torch.cat([e0f[:3], pr_f[:, 3, :].amin(dim=0)[None]])
    e1f = torch.cat([e1f[:3], pr_f[:, 3, :].amax(dim=0)[None]])
    q0, q1, cidx, aidx, err = qpal(e0f, e1f)
    e0c, e1c = _ls_refit_t(pr_f, cidx, mask, cprec, e0f, e1f, 0, 3)
    e0c, e1c = _ls_refit_t(pr_f, aidx, mask, aprec, e0c, e1c, 3, 4)
    q0b, q1b, cidx_b, aidx_b, err_b = qpal(e0c, e1c)
    better = err_b < err
    return (torch.where(better[None, :], q0b, q0),
            torch.where(better[None, :], q1b, q1),
            torch.where(better[None, :], cidx_b, cidx),
            torch.where(better[None, :], aidx_b, aidx),
            torch.minimum(err_b, err))


def _try_single_mode45(px_i, px_f, mode_id: int, aw: float = 1.0,
                       m4_ims: tuple = _MODE4_IMS_MAXQ):
    """Mode 4 or 5 with every (rotation, index mode) candidate fitted on
    its own (_try_single_mode, bc67.py:1438): mode 4 over rotations 0-3 x
    index modes m4_ims (the maxq tier's (0, 1) by default; K8 takes
    _MODE4_IMS), mode 5 over rotations 0-3 at index mode 0; independent
    colour and alpha anchor fixes per candidate, fold with a strict `<`.
    Returns (err [NB], words [4, NB] int64)."""
    m = _BC7_MODES[mode_id]
    nb = px_i.shape[2]
    ims = tuple(m4_ims) if m.index_mode_bits else (0,)
    best_err = torch.full((nb,), float("inf"), device=px_i.device)
    best_words = torch.zeros((4, nb), dtype=torch.int64, device=px_i.device)
    for rot in _MODE45_ROTS:
        for im in ims:
            err, words = _mode45_candidate(px_i, px_f, mode_id, rot, im, aw)
            better = err < best_err
            best_err = torch.minimum(err, best_err)
            best_words = torch.where(better[None, :], words, best_words)
    return best_err, best_words


def _mode45_candidate(px_i, px_f, mode_id: int, rot: int, im: int,
                      aw: float = 1.0):
    """One (rotation, index mode) candidate of mode 4 or 5 fitted on its
    own, anchor-fixed and emitted (_try_single_mode45's loop body).
    Returns (err [NB], words [4, NB] int64)."""
    m = _BC7_MODES[mode_id]
    nb = px_i.shape[2]
    zero = torch.zeros(nb, dtype=torch.int32, device=px_i.device)
    pr_i, pr_f = _rotate(px_i, rot), _rotate(px_f, rot)
    alpha_ch = 3 if rot == 0 else rot - 1
    q0, q1, cidx, aidx, err = _dual_eval_t(pr_i, pr_f, mode_id, im, aw,
                                           alpha_ch)
    w1, w2 = (cidx, aidx) if im == 0 else (aidx, cidx)
    w1, w2, swap1, swap2 = _dual_anchor_fix(w1, w2, m.index_prec,
                                            m.index_prec2)
    swap_rgb, swap_a = (swap1, swap2) if im == 0 else (swap2, swap1)
    do_swap = torch.stack([swap_rgb, swap_rgb, swap_rgb, swap_a])
    return err, _emit_bc7(mode_id, 0, rot, im,
                          [torch.where(do_swap, q1, q0)],
                          [torch.where(do_swap, q0, q1)], [zero], [zero],
                          w1, w2, nb, px_i.device)


def _single_modes_plain(px: torch.Tensor, aw: float = 1.0) -> dict:
    """Plain twin of K8: px [64, NB] int32 (0..255) -> {mode: (err [NB]
    f32, words [4, NB] int32)} for modes 4, 5 and 6, each the best of its
    candidates (rotations 0-3; mode 4 at index modes _MODE4_IMS) by a
    strict `<`."""
    out = {m: ([], []) for m in (4, 5, 6)}
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        px_i = px[:, s:s + _PLAIN_SEARCH_SLICE].reshape(16, 4, -1)
        px_f = px_i.to(torch.float32)
        res = {m: _try_single_mode45(px_i, px_f, m, aw, _MODE4_IMS)
               for m in (4, 5)}
        res[6] = _try_mode6(px_i, px_f, aw)
        for m, (err, words) in res.items():
            out[m][0].append(err)
            out[m][1].append(_words_i32(words))
    return {m: (torch.cat(e), torch.cat(w, dim=1))
            for m, (e, w) in out.items()}


def bc7_single_modes(px: torch.Tensor, aw: float = 1.0) -> dict:
    """K8 wrapper (single_modes_pallas at its defaults): px [64, NB] int32
    (0..255) -> {4: (err, words), 5: ..., 6: ...}, each mode's best over
    rotations 0-3 (mode 4 at index mode 0) with every candidate fitted on
    its own; err [NB] f32, words [4, NB] int32; the alpha channel's
    squared error weighted by aw. A CUDA tensor launches the kernel, a CPU
    tensor runs the plain twin."""
    _check_px(px)
    if _on_cuda(px):
        err, words = cuda_kernels.bc7_single_modes(px, aw)
        return {m: (err[k], words[k]) for k, m in enumerate((4, 5, 6))}
    return _single_modes_plain(px, aw)


# K8's team's nine evaluations of a block, in the order of their result
# slots (bc7_single_modes.cu's SingleSlot): (mode, rotation). The kernel
# runs them as five jobs: one per rotation (its mode 4 at index mode 0,
# then mode 5), and mode 6.
SINGLE_MODES_JOBS = (tuple((4, r) for r in _MODE45_ROTS)
                     + tuple((5, r) for r in _MODE45_ROTS) + ((6, 0),))


def _single_modes_jobs_plain(px: torch.Tensor, aw: float = 1.0):
    """Plain twin of K8's team jobs: px [64, NB] int32 (0..255) -> [(err
    [NB] f32, words [4, NB] int32)] in SINGLE_MODES_JOBS order: mode 4 at
    index mode 0 and mode 5 per rotation, and mode 6, each candidate
    fitted on its own."""
    jobs = [([], []) for _ in SINGLE_MODES_JOBS]
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        px_i = px[:, s:s + _PLAIN_SEARCH_SLICE].reshape(16, 4, -1)
        px_f = px_i.to(torch.float32)
        for j, (mode_id, rot) in enumerate(SINGLE_MODES_JOBS):
            if mode_id == 6:
                err, w = _try_mode6(px_i, px_f, aw)
            else:
                err, w = _mode45_candidate(px_i, px_f, mode_id, rot, 0, aw)
            jobs[j][0].append(err)
            jobs[j][1].append(_words_i32(w))
    return [(torch.cat(e), torch.cat(w, dim=1)) for e, w in jobs]


def _fold_strict(pairs):
    """[(err [NB], words [4, NB])] folded in order from (inf, zero words),
    each taken where its error is strictly below the best so far: a tie
    keeps the earlier entry, as the kernels' keep_if_better does."""
    best_err = torch.full_like(pairs[0][0], float("inf"))
    best_words = torch.zeros_like(pairs[0][1])
    for err, words in pairs:
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_words = torch.where(better[None, :], words, best_words)
    return best_err, best_words


def _single_modes_fold_plain(jobs) -> dict:
    """Plain twin of K8's team fold: results in SINGLE_MODES_JOBS order ->
    {mode: (err [NB] f32, words [4, NB] int32)}: modes 4 and 5 each over
    rotations 0-3 in order with a strict `<` from (inf, zero words), mode
    6 as it is. Equals _single_modes_plain."""
    out = {m: _fold_strict([jobs[j] for j, job in enumerate(SINGLE_MODES_JOBS)
                            if job[0] == m]) for m in (4, 5)}
    out[6] = jobs[SINGLE_MODES_JOBS.index((6, 0))]
    return out


def _check_search(modes, tier: str) -> tuple:
    modes = tuple(modes)
    if tier not in (TIER_DEFAULT, TIER_MAXQ):
        raise ValueError(f"tier {tier!r}: the search tiers are "
                         f"{TIER_DEFAULT!r} and {TIER_MAXQ!r}")
    searches = (SEARCH_MODES, SEARCH_MODES_ALPHA, SEARCH_MODES_QUICK,
                SEARCH_MODES_3, SEARCH_MODES_3_ALPHA)
    if modes not in searches:
        raise ValueError(f"search modes {modes}: the searches are "
                         f"{searches}")
    return modes


def _bc7_search_plain(px: torch.Tensor, modes=SEARCH_MODES,
                      aw: float = 1.0, tier: str = TIER_DEFAULT):
    """Plain twin of the search (K2, and K9 + K7 for modes 0 and 2): px
    [64, NB] int32 (0..255) -> (err [NB] f32, words [4, NB] int32).
    `modes` (one of the five search tuples) are folded in their order with
    a strict `<`; mode 7 scores inf on a block whose alpha is 255
    everywhere (bc67.py:2034). `tier` TIER_DEFAULT shares one float
    trajectory between modes 1 and 3 and between modes 4 and 5 (mode 4 at
    index mode 0); TIER_MAXQ fits each of them on its own and searches
    both mode-4 index modes. Mode 6 (and so QUICK) and modes 0 and 2 (on
    the three-subset ranking, mode 0 over shapes 0..15) are the same
    search in both tiers."""
    modes = _check_search(modes, tier)
    errs, words = [], []
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        px_i = px[:, s:s + _PLAIN_SEARCH_SLICE].reshape(16, 4, -1)
        px_f = px_i.to(torch.float32)
        nb = px_i.shape[2]
        res = {6: _try_mode6(px_i, px_f, aw)}
        if 0 in modes:
            ests3 = _shape_estimates_table(px_f, partitions=2)
            for mode_id in (0, 2):
                res[mode_id] = _try_partition_mode(px_i, px_f, mode_id,
                                                   ests3, aw)
        if 1 in modes:
            ests = _shape_estimates_table(px_f)
            if tier == TIER_MAXQ:
                for mode_id in (1, 3):
                    res[mode_id] = _try_partition_mode(px_i, px_f, mode_id,
                                                       ests, aw)
                for mode_id in (4, 5):
                    res[mode_id] = _try_single_mode45(px_i, px_f, mode_id,
                                                      aw)
            else:
                res.update(_try_2sub_modes_shared(px_i, px_f, ests, aw))
                res.update(_try_modes45_shared(px_i, px_f, aw))
        if 7 in modes:
            err7, words7 = _try_partition_mode(px_i, px_f, 7, ests, aw)
            has_alpha = (px_i[:, 3, :] != 255).any(dim=0)
            res[7] = (torch.where(has_alpha, err7, float("inf")), words7)
        best_err = torch.full((nb,), float("inf"), device=px.device)
        best_words = torch.zeros((4, nb), dtype=torch.int64,
                                 device=px.device)
        for mode_id in modes:
            err, w = res[mode_id]
            better = err < best_err
            best_err = torch.minimum(err, best_err)
            best_words = torch.where(better[None, :], w, best_words)
        errs.append(best_err)
        words.append(_words_i32(best_words))
    return torch.cat(errs), torch.cat(words, dim=1)


def _has_alpha(px: torch.Tensor) -> torch.Tensor:
    """[NB] bool: the blocks of px [64, NB] with some alpha below 255."""
    return (px.reshape(16, 4, -1)[:, 3, :] != 255).any(dim=0)


def _alpha_list_plain(px: torch.Tensor) -> torch.Tensor:
    """Plain twin of mode 7's list pass: px [64, NB] int32 -> the [n]
    int32 indices of the blocks with some alpha below 255, ascending."""
    return torch.nonzero(_has_alpha(px)).flatten().to(torch.int32)


def _take7(err_f: torch.Tensor, words_f: torch.Tensor,
           err7: torch.Tensor) -> torch.Tensor:
    """[NB] bool: where mode 7 (err7) takes a block from the fold F of
    (1, 3, 5, 6, 4) (err_f, words_f [4, NB] int32) in the fold order
    (1, 3, 5, 6, 7, 4): below F's error, or equal to it where F is mode 4
    (mode 4 comes after 7, so it beat the modes before 7 but not 7)."""
    after4 = _mode_of(_words_i64(words_f)) == 4
    return torch.where(after4, err7 <= err_f, err7 < err_f)


def _mode7_fold_plain(px: torch.Tensor, picks: torch.Tensor,
                      err: torch.Tensor, words: torch.Tensor,
                      aw: float = 1.0):
    """Plain twin of the mode-7 launch: mode 7 (K7's twin) on picks [4, NB]
    of the blocks with alpha, folded into a (1, 3, 5, 6, 4) search's err
    [NB] and words [4, NB] int32 by _take7. Returns (err, words)."""
    return _fold_mode7(px, picks, err, words,
                       lambda p, s: _partition_mode_plain(p, s, 7, aw))


def _mode7_jobs_plain(px: torch.Tensor, picks: torch.Tensor,
                      err: torch.Tensor, words: torch.Tensor,
                      aw: float = 1.0):
    """The mode-7 launch's team in plain form (used by the tests and
    chip_smoke.py): over the listed blocks, candidate rank k a job
    (_partition_jobs_plain, both subsets in one pass), the jobs folded in
    rank order (_partition_jobs_fold_plain), then _take7. Returns (err,
    words), _mode7_fold_plain's."""
    return _fold_mode7(px, picks, err, words,
                       lambda p, s: _partition_jobs_fold_plain(
                           _partition_jobs_plain(p, s, 7, aw)))


def _fold_mode7(px, picks, err, words, mode7):
    """mode7(px, picks) [(err, words)] of the blocks with alpha, gathered,
    folded into (err, words) by _take7."""
    blocks = _alpha_list_plain(px).to(torch.int64)
    err, words = err.clone(), words.clone()
    if not len(blocks):
        return err, words
    err7, words7 = mode7(px[:, blocks], picks[:, blocks])
    take = _take7(err[blocks], words[:, blocks], err7)
    err[blocks] = torch.where(take, err7, err[blocks])
    words[:, blocks] = torch.where(take[None, :], words7, words[:, blocks])
    return err, words


# ---------------------------------------------------------------------------
# The teams in plain form: the fit of all subsets in one pass, K2's maxq
# team's 21 evaluations of a block and their fold, K9's two lists and K7's
# candidate jobs and their fold (used by the tests and chip_smoke.py; the
# search itself is _bc7_search_plain)
# ---------------------------------------------------------------------------

def _pick_pix(sid, arrs):
    """Per pixel its own subset's value: arrs[s] [C, NB] where sid [16,
    NB] (int64 subset ids) is s. Returns [16, C, NB]."""
    out = arrs[0][None].expand(sid.shape[0], *arrs[0].shape)
    for s in range(1, len(arrs)):
        out = torch.where((sid == s)[:, None, :], arrs[s][None], out)
    return out


def _own_sums(sid, terms, n_sub: int):
    """Each subset's sum of its own pixels' terms [16, NB] in pixel order,
    skipping the other subsets' pixels (a running sum from 0.0, as the
    kernels' fits in one pass add). Returns [sum over subset 0, ...]."""
    sums = []
    for s in range(n_sub):
        acc = torch.zeros_like(terms[0])
        for i in range(terms.shape[0]):
            acc = torch.where(sid[i] == s, acc + terms[i], acc)
        sums.append(acc)
    return sums


def _minmax_axis_ns_t(px_f, sid, n_sub: int, with_alpha: bool):
    """_minmax_axis_endpoints_t of every subset in one pass over the
    pixels: each pixel projected on its own subset's box and scored into
    its own subset's sums. sid [16, NB] int64: each pixel's subset.
    Returns ([e0 of each subset], [e1 of each]) [4, NB] each."""
    boxes, mids, dirvs = [], [], []
    nch = 4 if with_alpha else 3
    for sub in range(n_sub):
        m = (sid == sub)[:, None, :]
        mi = torch.where(m, px_f, 1e9).amin(dim=0)
        ma = torch.where(m, px_f, -1e9).amax(dim=0)
        ab = ma - mi
        fab = _sum0(ab[:nch] * ab[:nch])
        boxes.append((mi, ma))
        mids.append((mi + ma) * 0.5)
        dirvs.append(ab / torch.where(fab > 0, fab, 1.0)[None, :])
    pt = (px_f - _pick_pix(sid, mids)) * _pick_pix(sid, dirvs)
    signs = [(sg, sb, sa)
             for sg in (1.0, -1.0) for sb in (1.0, -1.0)
             for sa in ((1.0, -1.0) if with_alpha else (1.0,))]
    best = [[torch.full_like(boxes[0][0][0], -1.0)] + [
        torch.ones_like(boxes[0][0][0]) for _ in range(3)]
        for _ in range(n_sub)]
    for sg, sb, sa in signs:
        f = pt[:, 0, :] + sg * pt[:, 1, :] + sb * pt[:, 2, :]
        if with_alpha:
            f = f + sa * pt[:, 3, :]
        for sub, score in enumerate(_own_sums(sid, f * f, n_sub)):
            b = best[sub]
            better = score > b[0]
            best[sub] = [torch.where(better, score, b[0]),
                         torch.where(better, sg, b[1]),
                         torch.where(better, sb, b[2]),
                         torch.where(better, sa, b[3])]
    e0s, e1s = [], []
    for sub in range(n_sub):
        mi, ma = boxes[sub]
        _, bsg, bsb, bsa = best[sub]

        def flip(lo, hi, sgn):
            return torch.where(sgn < 0, hi, lo), torch.where(sgn < 0, lo, hi)

        g0, g1 = flip(mi[1], ma[1], bsg)
        b0, b1 = flip(mi[2], ma[2], bsb)
        a0, a1 = flip(mi[3], ma[3], bsa) if with_alpha else (mi[3], ma[3])
        e0s.append(torch.stack([mi[0], g0, b0, a0]))
        e1s.append(torch.stack([ma[0], g1, b1, a1]))
    return e0s, e1s


def _assign_ns_t(px_i, u0s, u1s, sid, prec: int, aw: float = 1.0):
    """_assign_indices_t over channels 0-3 of every subset in one pass:
    each pixel projected on, and scored against, its own subset's
    endpoints (u0s / u1s: each subset's [4, NB]). Returns (idx [16, NB] of
    every pixel, [err of each subset])."""
    K = 1 << prec
    n_sub = len(u0s)
    e_sub = [[u1s[s][c] - u0s[s][c] for c in range(4)] for s in range(n_sub)]
    s64 = []
    for s in range(n_sub):
        span = torch.zeros_like(e_sub[s][0])
        for ee in e_sub[s]:
            span = span + ee * ee
        span = span.to(torch.float32)
        s64.append(_div(64.0, torch.where(span > 0, span, 1.0)))
    u0 = _pick_pix(sid, u0s)
    e = _pick_pix(sid, [torch.stack(es) for es in e_sub])
    d0 = [px_i[:, c, :] - u0[:, c, :] for c in range(4)]
    dot = torch.zeros_like(d0[0])
    for c in range(4):
        dot = dot + d0[c] * e[:, c, :]
    p64 = (dot.to(torch.float32)
           * _pick_pix(sid, [v[None] for v in s64])[:, 0, :]) \
        .clamp(0.0, 64.0)
    kf = torch.round(p64 * ((K - 1) / 64.0)).to(torch.int32).clamp(0, K - 1)
    wk = _pal_weight(kf, K)
    wkp = _pal_weight((kf + 1).clamp(max=K - 1), K)
    wkm = _pal_weight((kf - 1).clamp(min=0), K)
    up = (kf < K - 1) & (2.0 * p64 > (wk + wkp).to(torch.float32))
    dn = (kf > 0) & (2.0 * p64 < (wk + wkm).to(torch.float32))
    idx = torch.where(up, kf + 1, torch.where(dn, kf - 1, kf))
    wk = _pal_weight(idx, K)
    dist = torch.zeros_like(p64)
    for c in range(4):
        r = (d0[c] - ((wk * e[:, c, :] + 32) >> 6)).to(torch.float32)
        dist = dist + _weighted_sq(r, c, aw, 3, None)
    return idx, _own_sums(sid, dist, n_sub)


def _ls_refit_ns_t(px_f, idx, sid, prec: int, e0s, e1s):
    """_ls_refit_t over channels 0-3 of every subset in one pass, each
    pixel weighed into its own subset's sums. Returns (e0s, e1s)."""
    n_sub = len(e0s)
    x = _pal_weight(idx, 1 << prec).to(torch.float32) * (1 / 64)
    a, b = 1.0 - x, x
    A, B, C = (_own_sums(sid, a * a, n_sub), _own_sums(sid, a * b, n_sub),
               _own_sums(sid, b * b, n_sub))
    r0 = [_own_sums(sid, a * px_f[:, c, :], n_sub) for c in range(4)]
    r1 = [_own_sums(sid, b * px_f[:, c, :], n_sub) for c in range(4)]
    out0, out1 = [], []
    for s in range(n_sub):
        det = A[s] * C[s] - B[s] * B[s]
        ok = torch.abs(det) > 1e-6
        inv = _div(1.0, torch.where(ok, det, 1.0))
        rows0, rows1 = [], []
        for c in range(4):
            n0 = ((C[s] * r0[c][s] - B[s] * r1[c][s]) * inv).clamp(0.0, 255.0)
            n1 = ((A[s] * r1[c][s] - B[s] * r0[c][s]) * inv).clamp(0.0, 255.0)
            rows0.append(torch.where(ok, n0, e0s[s][c]))
            rows1.append(torch.where(ok, n1, e1s[s][c]))
        out0.append(torch.stack(rows0))
        out1.append(torch.stack(rows1))
    return out0, out1


def _fit_ns_plain(px_i, px_f, sid, n_sub: int, mode_id: int,
                  aw: float = 1.0):
    """Plain twin of the kernels' fit in one pass (fit_ns<M, NS, W>,
    bc7_encode.cuh): the n_sub subsets of partition mode mode_id (two for
    1, 3 and 7, three for 0 and 2) fitted in one pass per step, each pixel
    on its own subset's state (sid [16, NB] int64: each pixel's subset),
    each subset keeping its better fit by its own strict `<`. Returns
    ([err [NB]] per subset, [q0], [q1], [p0], [p1], idx [16, NB]): what
    _fit_subset_plain gives for each subset, the index plane of each pixel
    from its own subset's fit."""
    m = _BC7_MODES[mode_id]
    shared_p = _shared_p(m)
    prec = m.index_prec
    subs = range(n_sub)

    def qpal(e0s_, e1s_):
        qs = [_quantize_endpoints_t(e0s_[s], e1s_[s], m) for s in subs]
        us = [_unquantize_with_p_t(*qs[s], m, shared_p) for s in subs]
        idx, errs = _assign_ns_t(px_i, [u[0] for u in us],
                                 [u[1] for u in us], sid, prec, aw)
        return qs, idx, errs

    e0s, e1s = _minmax_axis_ns_t(px_f, sid, n_sub, m.rgba_prec[3] > 0)
    qa, idx_a, err_a = qpal(e0s, e1s)
    e0c, e1c = _ls_refit_ns_t(px_f, idx_a, sid, prec, e0s, e1s)
    qb, idx_b, err_b = qpal(e0c, e1c)
    errs, q0s, q1s, p0s, p1s = [], [], [], [], []
    idx = idx_a
    for s in subs:
        better = err_b[s] < err_a[s]
        errs.append(torch.where(better, err_b[s], err_a[s]))
        q0s.append(torch.where(better[None, :], qb[s][0], qa[s][0]))
        q1s.append(torch.where(better[None, :], qb[s][1], qa[s][1]))
        p0s.append(torch.where(better, qb[s][2], qa[s][2]))
        p1s.append(torch.where(better, qb[s][3], qa[s][3]))
        idx = torch.where((sid == s) & better[None, :], idx_b, idx)
    return errs, q0s, q1s, p0s, p1s, idx


def _eval_partition_ns_plain(px_i, px_f, s_blk, mode_id: int,
                             aw: float = 1.0):
    """Partition mode mode_id (0, 1, 2, 3, 7) on the shapes s_blk [NB] by
    the fit in one pass, anchor swaps, emit (the kernels'
    eval_partition_ns). Returns (err [NB], words [4, NB] int64)."""
    m = _BC7_MODES[mode_id]
    tabs = _tables(px_i.device)
    s_blk = s_blk.to(torch.int64)
    sid = tabs[f"parts{m.partitions}"][s_blk].t().to(torch.int64)
    n_sub = m.partitions + 1
    errs, q0s, q1s, p0s, p1s, idx = _fit_ns_plain(px_i, px_f, sid, n_sub,
                                                  mode_id, aw)
    total = torch.zeros_like(px_f[0, 0])
    for err in errs:
        total = total + err
    anchors = [0] + [tabs[f"fix{m.partitions}"][s_blk, p]
                     for p in range(1, n_sub)]
    idx = _anchor_swaps(idx, [sid == s for s in range(n_sub)], anchors,
                        m.index_prec, q0s, q1s, p0s, p1s)
    return total, _emit_bc7(mode_id, s_blk, 0, 0, q0s, q1s, p0s, p1s, idx,
                            None, px_i.shape[2], px_i.device)


def _mode6_job_plain(px: torch.Tensor, aw: float = 1.0):
    """Plain form of the mode-6 job of K2's maxq team and K8's team
    (eval_mode6_packed, bc7_encode.cuh): mode 6 by the fit in one pass at
    one subset (_fit_ns_plain), then the anchor swap and the emit. px [64,
    NB] int32 (0..255) -> (err [NB] f32, words [4, NB] int32), equal to
    _bc7_search_plain(px, SEARCH_MODES_QUICK, aw) bit for bit."""
    errs, words = [], []
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        px_i = px[:, s:s + _PLAIN_SEARCH_SLICE].reshape(16, 4, -1)
        px_f = px_i.to(torch.float32)
        nb = px_i.shape[2]
        sid = torch.zeros((16, nb), dtype=torch.int64, device=px.device)
        err, q0s, q1s, p0s, p1s, idx = _fit_ns_plain(px_i, px_f, sid, 1, 6,
                                                     aw)
        idx = _anchor_swaps(idx, [sid == 0], [0], _BC7_MODES[6].index_prec,
                            q0s, q1s, p0s, p1s)
        errs.append(err[0])
        words.append(_words_i32(_emit_bc7(6, 0, 0, 0, q0s, q1s, p0s, p1s,
                                          idx, None, nb, px.device)))
    return torch.cat(errs), torch.cat(words, dim=1)


# K2's maxq team's 21 evaluations of a block, in the order of their result
# slots (bc7_encode.cuh's MaxqSlot): (mode, candidate rank or rotation,
# index mode). The kernel runs them as 13 jobs: one per candidate and
# mode 1 or 3, one per rotation (its modes 5, 4 at index mode 0 and 4 at
# index mode 1 in turn), and mode 6.
MAXQ_JOBS = (tuple((1, k, 0) for k in range(4))
             + tuple((3, k, 0) for k in range(4))
             + tuple((5, r, 0) for r in range(4))
             + tuple((4, r, im) for r in range(4) for im in (0, 1))
             + ((6, 0, 0),))


def _maxq_jobs_plain(px: torch.Tensor, aw: float = 1.0):
    """Plain twin of K2's maxq team's evaluations: px [64, NB] int32 (0..255) ->
    (picks [4, NB] int32, the top 4 of the 64 two-subset shapes; [(err
    [NB] f32, words [4, NB] int32)] in MAXQ_JOBS order): modes 1 and 3 on
    each candidate by the paired fit, mode 5 and mode 4 at each index mode
    per rotation, mode 6, each fitted on its own."""
    picks, jobs = [], [([], []) for _ in MAXQ_JOBS]
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        px_i = px[:, s:s + _PLAIN_SEARCH_SLICE].reshape(16, 4, -1)
        px_f = px_i.to(torch.float32)
        cands = _top_k_shapes(_shape_estimates_table(px_f),
                              BC7_SHAPE_CANDIDATES)
        picks.append(torch.stack(cands).to(torch.int32))
        for j, (mode_id, a, im) in enumerate(MAXQ_JOBS):
            if mode_id in (1, 3):
                err, w = _eval_partition_ns_plain(px_i, px_f, cands[a],
                                                  mode_id, aw)
            elif mode_id in (4, 5):
                err, w = _mode45_candidate(px_i, px_f, mode_id, a, im, aw)
            else:
                err, w = _try_mode6(px_i, px_f, aw)
            jobs[j][0].append(err)
            jobs[j][1].append(_words_i32(w))
    return torch.cat(picks, dim=1), [(torch.cat(e), torch.cat(w, dim=1))
                                     for e, w in jobs]


def _maxq_fold_plain(jobs):
    """Plain twin of the maxq team's fold: results in MAXQ_JOBS order ->
    (err [NB], words [4, NB] int32): each mode's best over its jobs in
    slot order (candidates in rank order; mode 4 rotation-major, index
    mode 0 before 1), then the modes in the order (1, 3, 5, 6, 4), each a
    strict `<`."""
    per_mode = {m: _fold_strict([jobs[j] for j, job in enumerate(MAXQ_JOBS)
                                 if job[0] == m]) for m in (1, 3, 5, 6, 4)}
    return _fold_strict([per_mode[m] for m in (1, 3, 5, 6, 4)])


def _shape_lists_of_table(ests, n_slices: int = 4):
    """Plain twin of K9's two lists: slice w of the shapes (w, w +
    n_slices, ...) ranked into a local top 4 by (estimate, shape) and the
    slices' lists merged by the same order (all S shapes), and a running
    top 4 over the estimates of shapes 0..15 in shape order. ests [S, NB],
    S >= 16. Returns (the top 4 of shapes 0..15, of all S), each 4 [NB]
    int64 shape indices in rank order: _top_k_shapes(ests[:16], 4) and
    _top_k_shapes(ests, 4)."""
    return (_top_k_shapes(ests[:16], 4), _top4_merge_plain(ests, n_slices))


def _shape_lists_plain(px: torch.Tensor):
    """Plain form of K9's one launch on the USE_3SUBSETS path: px [64, NB]
    int32 -> (s16, s64) [4, NB] int32, the top 4 of the three-subset
    shapes 0..15 and of all 64, both from one 64-shape estimate table
    (a shape's estimate does not depend on how many are ranked)."""
    out16, out64 = [], []
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        px_f = px[:, s:s + _PLAIN_SEARCH_SLICE].reshape(16, 4, -1) \
            .to(torch.float32)
        s16, s64 = _shape_lists_of_table(
            _shape_estimates_table(px_f, 64, partitions=2))
        out16.append(torch.stack(s16))
        out64.append(torch.stack(s64))
    return (torch.cat(out16, dim=1).to(torch.int32),
            torch.cat(out64, dim=1).to(torch.int32))


def _partition_jobs_plain(px: torch.Tensor, s_blks: torch.Tensor,
                          mode_id: int, aw: float = 1.0):
    """Plain twin of K7's team jobs: px [64, NB] int32, s_blks [C, NB]
    int32 -> [(err [NB] f32, words [4, NB] int32)] per candidate rank,
    each candidate's subsets fitted in one pass (_eval_partition_ns_plain)."""
    jobs = [([], []) for _ in range(s_blks.shape[0])]
    for s in range(0, px.shape[1], _PLAIN_SEARCH_SLICE):
        px_i = px[:, s:s + _PLAIN_SEARCH_SLICE].reshape(16, 4, -1)
        px_f = px_i.to(torch.float32)
        for k, s_blk in enumerate(s_blks[:, s:s + _PLAIN_SEARCH_SLICE]):
            err, w = _eval_partition_ns_plain(px_i, px_f, s_blk, mode_id, aw)
            jobs[k][0].append(err)
            jobs[k][1].append(_words_i32(w))
    return [(torch.cat(e), torch.cat(w, dim=1)) for e, w in jobs]


def _partition_jobs_fold_plain(jobs, n_warps: int = 4):
    """Plain twin of K7's fold: candidate rank k on warp k % n_warps, each
    warp's best of its jobs by a strict `<` in rank order, then the warps'
    bests by (error, rank). Returns (err [NB], words [4, NB] int32): the
    strict-`<` fold in rank order of _partition_candidates."""
    nb = jobs[0][0].shape[0]
    dev = jobs[0][0].device
    fold_err = torch.full((nb,), float("inf"), device=dev)
    fold_words = torch.zeros_like(jobs[0][1])
    fold_rank = torch.full((nb,), len(jobs) + 1, device=dev)
    for w in range(n_warps):
        err = torch.full((nb,), float("inf"), device=dev)
        words = torch.zeros_like(jobs[0][1])
        rank = torch.full((nb,), len(jobs), device=dev)
        for k in range(w, len(jobs), n_warps):
            better = jobs[k][0] < err
            err = torch.where(better, jobs[k][0], err)
            words = torch.where(better[None, :], jobs[k][1], words)
            rank = torch.where(better, k, rank)
        take = (err < fold_err) | ((err == fold_err) & (rank < fold_rank))
        fold_err = torch.where(take, err, fold_err)
        fold_words = torch.where(take[None, :], words, fold_words)
        fold_rank = torch.where(take, rank, fold_rank)
    return fold_err, fold_words


def bc7_search_words(px: torch.Tensor, modes=SEARCH_MODES,
                     aw: float = 1.0, tier: str = TIER_DEFAULT):
    """The whole search of one tier. px [64, NB] int32 (texels 0..255,
    row = pixel * 4 + channel) -> (err [NB] f32, words [4, NB] int32);
    `modes` is SEARCH_MODES (opaque), SEARCH_MODES_ALPHA (with mode 7),
    SEARCH_MODES_QUICK, or SEARCH_MODES_3 / SEARCH_MODES_3_ALPHA
    (USE_3SUBSETS), `tier` TIER_DEFAULT or TIER_MAXQ. A CUDA tensor
    launches the kernels (K2; with modes 0 and 2 first one K9 launch that
    ranks for both, and K7 for each of them; with mode 7 K2's search
    without it, then mode 7's list pass and launch), a CPU tensor runs the
    plain twin."""
    _check_px(px)
    modes = _check_search(modes, tier)
    if not _on_cuda(px):
        return _bc7_search_plain(px, modes, aw, tier)
    if modes[:2] != (0, 2):
        return cuda_kernels.bc7_encode(px, modes, aw, tier)
    # modes 0 and 2 never share a fit, so both tiers search them the same
    # way (pallas_kernels.py:1910-1921): K9 ranks the three-subset shapes
    # once, for mode 2 all 64 and for mode 0 only shapes 0..15 (its 4-bit
    # partition field's), K7 evaluates each mode's top 4; K2 searches the
    # other modes
    s0, s2 = cuda_kernels.bc7_partition_shapes_3sub(px)
    err0, words0 = cuda_kernels.bc7_partition_mode(px, s0, 0, aw)
    err2, words2 = cuda_kernels.bc7_partition_mode(px, s2, 2, aw)
    err_r, words_r = cuda_kernels.bc7_encode(px, modes[2:], aw, tier)
    # Modes 0 and 2 come first in the fold order, so the strict-`<` fold
    # of (0, 2, rest...) is the fold of the rest (K2's own), taken only
    # where it is strictly below the fold of (0, 2): the same words and
    # errors as one fold over the whole list.
    take2 = err2 < err0
    err02 = torch.where(take2, err2, err0)
    words02 = torch.where(take2[None, :], words2, words0)
    take_r = err_r < err02
    return (torch.where(take_r, err_r, err02),
            torch.where(take_r[None, :], words_r, words02))


# ---------------------------------------------------------------------------
# winner-refine: LADDER_MOMENT and the exact ladders (bc67.py:728-905,
# :1597-1896)
# ---------------------------------------------------------------------------

def _bc7_unpack_mode(words, mode: int):
    """Unpack encoder state assuming `mode` (the EmitBlock inverse).
    words [4, NB] int64. Returns (shape, rot, im [NB]; q0s/q1s per-subset
    [4, NB] codes WITHOUT the p bit; p0s/p1s per-subset [NB]; idx1, idx2
    [16, NB] full-precision indices, idx2 None without a second set), all
    int32."""
    m = _BC7_MODES[mode]
    nb = words.shape[1]
    n_sub = m.partitions + 1
    n_ep = n_sub * 2
    bit = mode + 1

    def i32(x):
        return x.to(torch.int32)

    shape = _gb_t(words, bit, m.partition_bits)
    bit += m.partition_bits
    rot = _gb_t(words, bit, m.rotation_bits)
    bit += m.rotation_bits
    im = _gb_t(words, bit, m.index_mode_bits)
    bit += m.index_mode_bits

    zero = torch.zeros(nb, dtype=torch.int64, device=words.device)
    ep = [[zero] * 4 for _ in range(n_ep)]
    for ch in range(4):
        prec = m.rgba_prec[ch]
        if prec == 0:
            continue
        for e in range(n_ep):
            ep[e][ch] = _gb_t(words, bit, prec)
            bit += prec
    p0s = [zero] * n_sub
    p1s = [zero] * n_sub
    if m.p_bits:
        pbits = []
        for _ in range(m.p_bits):
            pbits.append(_gb_t(words, bit, 1))
            bit += 1
        for sub in range(n_sub):
            if m.p_bits == n_sub:            # shared p-bit (mode 1)
                p0s[sub] = p1s[sub] = pbits[sub]
            else:
                p0s[sub] = pbits[2 * sub]
                p1s[sub] = pbits[2 * sub + 1]

    a2 = a3 = None
    if m.partitions:
        pa = _tables(words.device)["pa", m.partitions][shape]
        a2 = pa & 0xF
        if m.partitions == 2:
            a3 = (pa >> 4) & 0xF
    idx1, total1 = _read_indices(words, bit, m.index_prec, a2, a3)
    bit += total1
    idx2 = None
    if m.index_prec2:
        idx2 = i32(torch.stack(_read_indices(words, bit, m.index_prec2,
                                             None, None)[0]))
    q0s = [i32(torch.stack([ep[2 * sub][ch] for ch in range(4)]))
           for sub in range(n_sub)]
    q1s = [i32(torch.stack([ep[2 * sub + 1][ch] for ch in range(4)]))
           for sub in range(n_sub)]
    return (i32(shape), i32(rot), i32(im), q0s, q1s,
            [i32(p) for p in p0s], [i32(p) for p in p1s],
            i32(torch.stack(idx1)), idx2)


def _moment_channels_t(px_i, mask, m: _BC7Mode, shared_p: bool, q0, q1,
                       p0, p1, wk_ch, aw: float = 1.0, alpha_ch: int = 3,
                       w_rows=None):
    """Analytic single-step endpoint move per channel (LADDER_MOMENT,
    bc67.py:817): the exact quadratic model of the fixed-index error over
    the joint {-1, 0, +1}^2 q-step grid, argmin per channel. All sums are
    exact in f32 (integers and 64ths). wk_ch: per-channel [16, NB]
    palette weights. Returns (q0, q1 [4, NB], err0 [NB]) with err0 the
    pre-move fixed-index error, alpha-weighted as _assign_indices_t (the
    move itself is weight-independent: a weight scales a channel's
    quadratic uniformly)."""
    p1u = p0 if shared_p else p1
    q0r = [q0[c] for c in range(4)]
    q1r = [q1[c] for c in range(4)]
    err0 = torch.zeros(px_i.shape[2], dtype=torch.float32,
                       device=px_i.device)
    zero = torch.zeros_like(err0)
    moments = {}
    for c in range(4):
        if m.rgba_prec[c] == 0:
            d = (px_i[:, c, :] - 255).to(torch.float32)
            err0 = err0 + _sum0(torch.where(
                mask, _weighted_sq(d, c, aw, alpha_ch, w_rows), 0.0))
            continue
        prec, prec_p = m.rgba_prec[c], m.rgba_prec_p[c]
        maxq = (1 << prec) - 1
        u0c = _unquant_channel_t(q0r[c], p0, prec, prec_p)
        u1c = _unquant_channel_t(q1r[c], p1u, prec, prec_p)
        wk = wk_ch[c]
        pal = ((64 - wk) * u0c[None, :] + wk * u1c[None, :] + 32) >> 6
        r = (px_i[:, c, :] - pal).to(torch.float32)
        err0 = err0 + _sum0(torch.where(
            mask, _weighted_sq(r, c, aw, alpha_ch, w_rows), 0.0))

        if id(wk) not in moments:
            a = (64 - wk).to(torch.float32) * (1 / 64)
            b = wk.to(torch.float32) * (1 / 64)
            moments[id(wk)] = (
                a, b,
                _sum0(torch.where(mask, a * a, 0.0)),
                _sum0(torch.where(mask, a * b, 0.0)),
                _sum0(torch.where(mask, b * b, 0.0)))
        a, b, saa, sab, sbb = moments[id(wk)]
        sra = _sum0(torch.where(mask, r * a, 0.0))
        srb = _sum0(torch.where(mask, r * b, 0.0))

        # exact unquantized steps of a ±1 q move (0 at the field rail)
        q0p, q0m = (q0r[c] + 1).clamp(max=maxq), (q0r[c] - 1).clamp(min=0)
        q1p, q1m = (q1r[c] + 1).clamp(max=maxq), (q1r[c] - 1).clamp(min=0)
        d0 = {0: zero,
              1: (_unquant_channel_t(q0p, p0, prec, prec_p) - u0c)
              .to(torch.float32),
              -1: (_unquant_channel_t(q0m, p0, prec, prec_p) - u0c)
              .to(torch.float32)}
        d1 = {0: zero,
              1: (_unquant_channel_t(q1p, p1u, prec, prec_p) - u1c)
              .to(torch.float32),
              -1: (_unquant_channel_t(q1m, p1u, prec, prec_p) - u1c)
              .to(torch.float32)}
        qs0 = {0: q0r[c], 1: q0p, -1: q0m}
        qs1 = {0: q1r[c], 1: q1p, -1: q1m}

        best = zero
        bq0, bq1 = q0r[c], q1r[c]
        for s0 in (0, 1, -1):
            for s1 in (0, 1, -1):
                if s0 == 0 and s1 == 0:
                    continue
                e0, e1 = d0[s0], d1[s1]
                de = (e0 * e0 * saa + e1 * e1 * sbb
                      + 2.0 * e0 * e1 * sab
                      - 2.0 * (e0 * sra + e1 * srb))
                better = de < best
                best = torch.minimum(de, best)
                bq0 = torch.where(better, qs0[s0], bq0)
                bq1 = torch.where(better, qs1[s1], bq1)
        q0r[c] = bq0
        q1r[c] = bq1
    return torch.stack(q0r), torch.stack(q1r), err0


def _perturb_channels_t(px_i, mask, m: _BC7Mode, shared_p: bool, q0, q1,
                        p0, p1, wk_ch, ladder, aw: float = 1.0,
                        alpha_ch: int = 3, w_rows=None):
    """The exact perturbation ladder (LADDER_FULL, LADDER_LIGHT;
    bc67.py:728): with the indices fixed, each encoded channel's two
    endpoint codes try +-delta steps in the order round -> channel ->
    endpoint -> delta -> sign, keeping a step where the channel's exact
    fixed-index error drops (strict `<`). ladder = (rounds, deltas).
    Errors are alpha-weighted as _assign_indices_t. Returns (q0, q1
    [4, NB], err_l, err0 [NB]): the ladder's final and the pre-ladder
    fixed-index errors."""
    rounds, deltas = ladder
    p1u = p0 if shared_p else p1
    q0r = [q0[c] for c in range(4)]
    q1r = [q1[c] for c in range(4)]

    def cherr(c, u0c, u1c):
        wk = wk_ch[c]
        r = (px_i[:, c, :] - (((64 - wk) * u0c[None, :] + wk * u1c[None, :]
                               + 32) >> 6)).to(torch.float32)
        return _sum0(torch.where(
            mask, _weighted_sq(r, c, aw, alpha_ch, w_rows), 0.0))

    full = torch.full_like(p0, 255)
    ch_err = []
    for c in range(4):
        if m.rgba_prec[c] == 0:          # decodes as 255: a constant term
            ch_err.append(cherr(c, full, full))
            continue
        prec, prec_p = m.rgba_prec[c], m.rgba_prec_p[c]
        ch_err.append(cherr(c, _unquant_channel_t(q0r[c], p0, prec, prec_p),
                            _unquant_channel_t(q1r[c], p1u, prec, prec_p)))
    err0 = sum(ch_err)
    for _ in range(rounds):
        for c in range(4):
            if m.rgba_prec[c] == 0:
                continue
            prec, prec_p = m.rgba_prec[c], m.rgba_prec_p[c]
            maxq = (1 << prec) - 1
            base = ch_err[c]
            for which in (0, 1):
                rows, pbit = (q0r, p0) if which == 0 else (q1r, p1u)
                other_u = (_unquant_channel_t(q1r[c], p1u, prec, prec_p)
                           if which == 0 else
                           _unquant_channel_t(q0r[c], p0, prec, prec_p))
                for delta in deltas:
                    for sgn in (delta, -delta):
                        qt = (rows[c] + sgn).clamp(0, maxq)
                        ut = _unquant_channel_t(qt, pbit, prec, prec_p)
                        e = (cherr(c, ut, other_u) if which == 0 else
                             cherr(c, other_u, ut))
                        better = e < base
                        rows[c] = torch.where(better, qt, rows[c])
                        base = torch.minimum(e, base)
            ch_err[c] = base
    return torch.stack(q0r), torch.stack(q1r), sum(ch_err), err0


def _ladder_move(px_i, mask, m: _BC7Mode, shared_p: bool, q0, q1, p0, p1,
                 wk_ch, ladder, aw: float = 1.0, w_rows=None):
    """One ladder's endpoint move with the indices fixed. Returns (q0,
    q1, err_l, err0): err_l is the ladder's own fixed-index error, None
    for LADDER_MOMENT (the JAX package's +inf, which every finite
    re-assignment error beats)."""
    if ladder == LADDER_MOMENT:
        q0t, q1t, err0 = _moment_channels_t(px_i, mask, m, shared_p, q0, q1,
                                            p0, p1, wk_ch, aw,
                                            w_rows=w_rows)
        return q0t, q1t, None, err0
    return _perturb_channels_t(px_i, mask, m, shared_p, q0, q1, p0, p1,
                               wk_ch, ladder, aw, w_rows=w_rows)


def _keep_reassigned(err_t, err_l):
    """The re-assignment's indices stand where they beat the ladder's own
    fixed-index error (bc67.py:1732-1734): (keep [NB] or None, the
    error to hold against err0)."""
    if err_l is None:
        return None, err_t
    return err_t < err_l, torch.minimum(err_t, err_l)


def _refine_mode_subsets(px_i, words, mode_id: int, ladder=LADDER_MOMENT,
                         aw: float = 1.0):
    """Winner-refine one partition-family mode (0-3, 6, 7): unpack, the
    ladder's endpoint move per subset with indices fixed, one
    re-assignment, keep per subset where the error drops, anchor swaps,
    re-emit. Returns (err_new, err_old [NB], words [4, NB] int64)."""
    m = _BC7_MODES[mode_id]
    nb = px_i.shape[2]
    n_sub = m.partitions + 1
    shared_p = m.p_bits == n_sub and m.p_bits > 0
    prec = m.index_prec
    shape, _, _, q0s, q1s, p0s, p1s, idx_full, _ = _bc7_unpack_mode(
        words, mode_id)

    if m.partitions:
        tabs = _tables(px_i.device)
        pp = tabs["pp", m.partitions][shape]
        pa = tabs["pa", m.partitions][shape]
        pm = torch.stack([(pp >> (2 * i)) & 3 for i in range(16)])
        mask_list = [pm == p for p in range(n_sub)]
        anchors = [0, pa & 0xF] + ([(pa >> 4) & 0xF]
                                   if m.partitions == 2 else [])
    else:                                 # mode 6: one subset
        mask_list = [torch.ones((16, nb), dtype=torch.bool,
                                device=px_i.device)]
        anchors = [0]

    wk = _pal_weight(idx_full, 1 << prec)
    err_new = torch.zeros(nb, dtype=torch.float32, device=px_i.device)
    err_old = torch.zeros_like(err_new)
    for sub, mask in enumerate(mask_list):
        q0t, q1t, err_l, err0 = _ladder_move(
            px_i, mask, m, shared_p, q0s[sub], q1s[sub], p0s[sub], p1s[sub],
            [wk] * 4, ladder, aw)
        u0, u1 = _unquantize_with_p_t(q0t, q1t, p0s[sub], p1s[sub], m,
                                      shared_p)
        idx_t, err_t = _assign_indices_t(px_i, u0, u1, prec, mask, aw=aw)
        keep, err_t = _keep_reassigned(err_t, err_l)
        bt = err_t < err0
        q0s[sub] = torch.where(bt[None, :], q0t, q0s[sub])
        q1s[sub] = torch.where(bt[None, :], q1t, q1s[sub])
        take = bt if keep is None else bt & keep
        idx_full = torch.where(take[None, :] & mask, idx_t, idx_full)
        err_new = err_new + torch.minimum(err_t, err0)
        err_old = err_old + err0

    idx_full = _anchor_swaps(idx_full, mask_list, anchors, prec,
                             q0s, q1s, p0s, p1s)
    return err_new, err_old, _emit_bc7(mode_id, shape, 0, 0, q0s, q1s, p0s,
                                       p1s, idx_full, None, nb, px_i.device)


def _refine_mode45(px_i, words, mode_id: int, ladder=LADDER_MOMENT,
                   aw: float = 1.0):
    """Winner-refine modes 4/5: per-block rotation and index mode, the
    ladder's move with separate color/alpha weight planes, dual
    re-assignment, independent anchor fixes; the alpha weight rides the
    rotated alpha channel per block. Returns (err_new, err_old [NB],
    words)."""
    m = _BC7_MODES[mode_id]
    nb = px_i.shape[2]
    mask = torch.ones((16, nb), dtype=torch.bool, device=px_i.device)
    prec1, prec2 = m.index_prec, m.index_prec2
    _, rot, im, q0s, q1s, p0s, p1s, w1, w2 = _bc7_unpack_mode(words,
                                                              mode_id)
    q0, q1, p0, p1 = q0s[0], q1s[0], p0s[0], p1s[0]

    # rotated pixel planes (channel rot-1 <-> alpha), per block
    pr = [torch.where((rot == c + 1)[None, :], px_i[:, 3, :], px_i[:, c, :])
          for c in range(3)]
    pal = px_i[:, 3, :]
    for c in range(3):
        pal = torch.where((rot == c + 1)[None, :], px_i[:, c, :], pal)
    pr_i = torch.stack(pr + [pal], dim=1)

    # per-block alpha-weight rows: the true alpha sits at rot-1 in rotated
    # space (3 when unrotated)
    w_rows = None
    if aw != 1.0:
        w_rows = [torch.where((rot == 0) if c == 3 else (rot == c + 1),
                              aw, 1.0).to(torch.float32) for c in range(4)]

    im0 = im == 0
    im0_16 = im0[None, :]
    cidx = torch.where(im0_16, w1, w2)
    aidx = torch.where(im0_16, w2, w1)
    wkc = torch.where(im0_16, _pal_weight(cidx, 1 << prec1),
                      _pal_weight(cidx, 1 << prec2))
    wka = torch.where(im0_16, _pal_weight(aidx, 1 << prec2),
                      _pal_weight(aidx, 1 << prec1))

    q0t, q1t, err_l, err0 = _ladder_move(pr_i, mask, m, False, q0, q1, p0,
                                         p1, [wkc, wkc, wkc, wka], ladder,
                                         w_rows=w_rows)
    u0, u1 = _unquantize_with_p_t(q0t, q1t, p0, p1, m, False)
    cidx_t, cerr = _assign_indices_t(pr_i, u0, u1, prec1, mask, 0, 3,
                                     w_rows=w_rows)
    aidx_t, aerr = _assign_indices_t(pr_i, u0, u1, prec2, mask, 3, 4,
                                     w_rows=w_rows)
    err_t = cerr + aerr
    if m.index_mode_bits:
        cidx_b, cerr_b = _assign_indices_t(pr_i, u0, u1, prec2, mask, 0, 3,
                                           w_rows=w_rows)
        aidx_b, aerr_b = _assign_indices_t(pr_i, u0, u1, prec1, mask, 3, 4,
                                           w_rows=w_rows)
        cidx_t = torch.where(im0_16, cidx_t, cidx_b)
        aidx_t = torch.where(im0_16, aidx_t, aidx_b)
        err_t = torch.where(im0, err_t, cerr_b + aerr_b)

    keep, err_t = _keep_reassigned(err_t, err_l)
    bt = err_t < err0
    take = (bt if keep is None else bt & keep)[None, :]
    q0f = torch.where(bt[None, :], q0t, q0)
    q1f = torch.where(bt[None, :], q1t, q1)
    cidx = torch.where(take, cidx_t, cidx)
    aidx = torch.where(take, aidx_t, aidx)
    err_new = torch.minimum(err_t, err0)

    w1n = torch.where(im0_16, cidx, aidx)
    w2n = torch.where(im0_16, aidx, cidx)
    w1n, w2n, swap1, swap2 = _dual_anchor_fix(w1n, w2n, prec1, prec2)
    swap_rgb = torch.where(im0, swap1, swap2)
    swap_a = torch.where(im0, swap2, swap1)
    do_swap = torch.stack([swap_rgb, swap_rgb, swap_rgb, swap_a])
    q0e = torch.where(do_swap, q1f, q0f)
    q1e = torch.where(do_swap, q0f, q1f)
    return err_new, err0, _emit_bc7(mode_id, 0, rot, im, [q0e], [q1e],
                                    [p0], [p1], w1n, w2n, nb, px_i.device)


# the modes the refine takes (bc67.py:1865-1896)
_REFINE_SCOPE = (0, 1, 2, 3, 4, 5, 6, 7)


def _check_refine_modes(modes) -> tuple:
    modes = tuple(modes)
    if not set(modes) <= set(_REFINE_SCOPE):
        raise ValueError(f"refine modes {modes}: the BC7 modes are "
                         f"{_REFINE_SCOPE}")
    return modes


def _check_ladder(ladder):
    """LADDER_MOMENT, or an exact ladder (rounds, deltas) of ints, any
    count of each, as the JAX package takes it (K3's launcher checks the
    limits of its own launch arguments)."""
    if ladder == LADDER_MOMENT:
        return ladder
    try:
        rounds, deltas = ladder
        return int(rounds), tuple(int(d) for d in deltas)
    except (TypeError, ValueError):
        raise ValueError(f"ladder {ladder!r}: LADDER_MOMENT or (rounds, "
                         "deltas)") from None


def _mode_buckets_plain(words: torch.Tensor, mode_mask: int):
    """Plain twin of K3's bucket pass: words [4, NB] int32 -> (counts [8]
    int32, per mode the [counts[m]] int32 indices of its blocks in
    ascending order). A mode outside mode_mask, and the reserved mode,
    get no bucket."""
    mode = _mode_of(_words_i64(words))
    buckets = tuple(
        torch.nonzero(mode == m).flatten().to(torch.int32)
        if (mode_mask >> m) & 1
        else torch.zeros(0, dtype=torch.int32, device=words.device)
        for m in range(8))
    counts = torch.tensor([len(b) for b in buckets], dtype=torch.int32,
                          device=words.device)
    return counts, buckets


def _bc7_refine_plain(px: torch.Tensor, words_i32: torch.Tensor,
                      modes=REFINE_MODES, aw: float = 1.0,
                      ladder=LADDER_MOMENT) -> torch.Tensor:
    """Plain twin of K3: px [64, NB] int32, words [4, NB] int32 ->
    refined words [4, NB] int32. A block is re-emitted only where its own
    mode is in `modes` and the error drops; others pass through."""
    ladder = _check_ladder(ladder)
    px_i = px.reshape(16, 4, -1)
    words = _words_i64(words_i32)
    mode = _mode_of(words)
    out = words
    for mv in _check_refine_modes(modes):
        refine = _refine_mode45 if mv in (4, 5) else _refine_mode_subsets
        err_new, err0, wn = refine(px_i, words, mv, ladder, aw)
        better = (mode == mv) & (err_new < err0)
        out = torch.where(better[None, :], wn, out)
    return _words_i32(out)


def bc7_refine_words(px: torch.Tensor, words: torch.Tensor,
                     modes=REFINE_MODES, aw: float = 1.0,
                     ladder=LADDER_MOMENT) -> torch.Tensor:
    """K3 wrapper: winner-refine with one ladder (LADDER_MOMENT or an
    exact (rounds, deltas) ladder) over `modes`, a subset of 0..7. px
    [64, NB] int32, words [4, NB] int32 -> words [4, NB] int32. A CUDA
    tensor launches the kernels (the bucket pass, then one launch per mode
    in scope), a CPU tensor runs the plain twin."""
    _check_words(words)
    _check_px(px, words.shape[1])
    modes = _check_refine_modes(modes)
    ladder = _check_ladder(ladder)
    if _on_cuda(px, words):
        return cuda_kernels.bc7_refine(px, words, modes, aw, ladder)
    return _bc7_refine_plain(px, words, modes, aw, ladder)


def refine_bc7_words(px_i: torch.Tensor, words: torch.Tensor,
                     ladder=LADDER_MOMENT, aw: float = 1.0,
                     modes: tuple = REFINE_MODES) -> torch.Tensor:
    """Winner-refine pass (bc67.py:1865): unpack each block's winning state
    from its packed words, move its endpoints by the ladder (LADDER_MOMENT,
    LADDER_FULL, LADDER_LIGHT or another (rounds, deltas)) with the
    indices fixed, re-assign indices once and re-emit where the error
    improved.

    px_i [16, 4, NB] int32 LDR pixels; words [NB, 4] int32 (u32 bit
    patterns). Returns refined words [NB, 4] int32."""
    nb = px_i.shape[2]
    out = bc7_refine_words(px_i.reshape(64, nb).contiguous(),
                           words.t().contiguous(), modes, aw, ladder)
    return out.t().contiguous()


def _quantize_ldr(blocks: torch.Tensor) -> torch.Tensor:
    """[NB, 16, 4] f32 -> lane-major [16, 4, NB] int32 with the
    reference's +0.01 rounding bias (BC6HBC7.cpp:2794): x*255 and +0.01
    are two rounded f32 ops, then clamp and truncate."""
    x = blocks.to(torch.float32).permute(1, 2, 0) * 255.0
    return (x + 0.01).clamp(0.0, 255.0).to(torch.int32)


def encode_bc7(blocks: torch.Tensor, flags: int = 0, opaque: bool = False,
               alpha_weight: float = 1.0) -> torch.Tensor:
    """[NB, 16, 4] f32 -> [NB, 16] u8 (D3DXEncodeBC7, BC6HBC7.cpp:2783).
    On a CUDA tensor the search and the refines run as kernels (K2, K3;
    with USE_3SUBSETS also K9 and K7).

    The default tier searches modes (1, 3, 5, 6, 7, 4) and refines the
    winner with one MOMENT pass over (1, 3, 5, 7, 4); QUICK (0x100000)
    searches mode 6 alone, with no refine; MAXQUALITY (0x200000) fits
    every mode on its own and refines twice, MOMENT then LADDER_FULL, over
    every searched mode (QUICK|MAXQUALITY: mode 6, refined twice).
    USE_3SUBSETS (0x80000) puts modes 0 and 2 first in the search and in
    the refine scope of either tier; with QUICK it changes nothing.
    `opaque=True` is the caller's promise that alpha is 1 everywhere and
    drops mode 7. With the default `opaque=False` the port checks the
    quantized alpha (one host sync) and drops mode 7 where no block has
    alpha: mode 7 scores inf on every opaque block in the JAX package too,
    so the words are the same. `alpha_weight` scales the alpha channel's
    squared error in scoring. Other flag bits are ignored, as in the JAX
    package."""
    if blocks.dim() != 3 or blocks.shape[1:] != (16, 4):
        raise ValueError(f"blocks must be [NB, 16, 4], got "
                         f"{tuple(blocks.shape)}")
    nb = blocks.shape[0]
    px = _quantize_ldr(blocks).reshape(64, nb).contiguous()
    maxq = bool(flags & _BC7_MAXQUALITY)
    tier = TIER_MAXQ if maxq else TIER_DEFAULT
    if flags & _BC7_QUICK:
        search, refine = SEARCH_MODES_QUICK, ()
    else:
        # has_alpha of bc67.py:1915, on the quantized alpha rows
        alpha = not opaque and bool(
            (px.reshape(16, 4, nb)[:, 3, :] != 255).any())
        search, refine = ((SEARCH_MODES_ALPHA, REFINE_MODES_ALPHA) if alpha
                          else (SEARCH_MODES, REFINE_MODES))
        if flags & _BC7_USE_3SUBSETS:
            search, refine = (0, 2) + search, (0, 2) + refine
    ladders = (LADDER_MOMENT,)
    if maxq:                       # the whole search scope, twice
        refine, ladders = search, (LADDER_MOMENT, LADDER_FULL)
    _, words = bc7_search_words(px, search, alpha_weight, tier)
    if refine:
        for ladder in ladders:
            words = bc7_refine_words(px, words, refine, alpha_weight,
                                     ladder)
    return words.t().contiguous().view(torch.uint8).reshape(nb, 16)
