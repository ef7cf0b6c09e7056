"""EXR B44 / B44A block codec (numpy, vectorized over blocks), the port's
copy of directxtex_tpu/io/exr_b44.py: host byte work, whose chunk bytes
the EXR reader copies to the device once.

Semantics follow OpenEXR's ImfB44Compressor (the adapter the reference
uses via RgbaInputFile, Auxiliary/DirectXTexEXR.cpp:17-31): HALF
channels are stored as 4x4 blocks of 14 bytes — a full 16-bit base
value, a shift, and fifteen 6-bit chain deltas — while non-HALF
channels are stored verbatim. B44A additionally collapses uniform
blocks to 3 bytes (base value + 0xfc marker).

Wire-format details honored here:
- HALF values are made monotonic before packing (negatives are
  complemented, positives get the sign bit set) and restored after
  unpacking; NaN/Inf flush to 0x8000 (-> 0.0 after restore).
- Chain order within a block: s4,s8,s12 (first column), then each row
  extends rightward (s1,s5,s9,s13, s2,..., s3,...), all mod 2^16.
- A six-bit delta v reconstructs as s_prev + (v << shift) - (0x20 <<
  shift); pack searches the smallest shift with all deltas in
  [-0x20, 0x1f].
- Block scan order is row-major over (y, x) 4x4 tiles per channel;
  channels appear in channel-list order within the chunk.
"""

from __future__ import annotations

import numpy as np

# unpack14 chain: (dst, src) pairs in wire order; deltas are packed as
# 6-bit fields starting at bit offset 18 (after base u16 + 6-bit shift)
_CHAIN = [(4, 0), (8, 4), (12, 8),
          (1, 0), (5, 4), (9, 8), (13, 12),
          (2, 1), (6, 5), (10, 9), (14, 13),
          (3, 2), (7, 6), (11, 10), (15, 14)]


def _fwd_transform(s: np.ndarray) -> np.ndarray:
    """HALF bits -> monotonic u16 (pack side). NaN/Inf -> 0x8000."""
    s = s.astype(np.uint16)
    t = np.where(s & 0x8000, ~s, s | np.uint16(0x8000)).astype(np.uint16)
    return np.where((s & 0x7C00) == 0x7C00, np.uint16(0x8000), t)


def _inv_transform(t: np.ndarray) -> np.ndarray:
    """Monotonic u16 -> HALF bits (unpack side)."""
    t = t.astype(np.uint16)
    return np.where(t & 0x8000, t & np.uint16(0x7FFF), ~t).astype(np.uint16)


def _extract_six(b: np.ndarray) -> np.ndarray:
    """b [N, 14] u16 -> fifteen 6-bit deltas [N, 15] in chain order."""
    out = np.empty((b.shape[0], 15), np.uint16)
    bit = 22                       # after 16-bit base + 6-bit shift field
    for i in range(15):
        byte, off = bit >> 3, bit & 7
        v = (b[:, byte] << 8) | (b[:, byte + 1] if byte + 1 < 14 else 0)
        out[:, i] = (v >> (10 - off)) & 0x3F
        bit += 6
    return out


def _insert_six(vals: np.ndarray, nb: int) -> np.ndarray:
    """Inverse of _extract_six: [N, 15] 6-bit deltas -> [N, 14] bytes
    with the shift/base fields zeroed (caller ORs them in)."""
    acc = np.zeros((nb, 14), np.uint16)
    bit = 22
    for i in range(15):
        byte, off = bit >> 3, bit & 7
        v = vals[:, i].astype(np.uint32) << (10 - off)
        acc[:, byte] |= (v >> 8).astype(np.uint16)
        if byte + 1 < 14:
            acc[:, byte + 1] |= (v & 0xFF).astype(np.uint16)
        bit += 6
    return acc


def unpack_blocks(b14: np.ndarray) -> np.ndarray:
    """[N, 14] u8 blocks -> [N, 16] u16 HALF bits (unpack14)."""
    b = b14.astype(np.uint16)
    s = np.empty((b.shape[0], 16), np.uint16)
    s[:, 0] = (b[:, 0] << 8) | b[:, 1]
    # clamp: valid HALF data needs shift <= 16; larger values only occur
    # in malformed input and would make the numpy u16 shift undefined
    shift = np.minimum(b[:, 2] >> 2, 16).astype(np.uint32)
    bias = ((np.uint32(0x20) << shift) & 0xFFFF).astype(np.uint16)
    six = _extract_six(b)
    for i, (dst, src) in enumerate(_CHAIN):
        d = ((six[:, i].astype(np.uint32) << shift) & 0xFFFF) \
            .astype(np.uint16)
        s[:, dst] = (s[:, src] + d - bias).astype(np.uint16)
    return _inv_transform(s)


def pack_blocks(s16: np.ndarray, flat_ok: bool):
    """[N, 16] u16 HALF bits -> (bytes, sizes [N]) per block (pack14 /
    pack3). flat_ok: emit 3-byte uniform blocks (B44A)."""
    t = _fwd_transform(s16)                          # [N, 16]
    n = t.shape[0]

    # smallest shift with all chain deltas in [-0x20, 0x1f]; elementwise
    # over blocks (shift <= 16 always terminates: all-zero deltas)
    shift = np.zeros(n, np.uint16)
    pend = np.ones(n, bool)
    r = np.zeros((n, 15), np.int32)
    for _ in range(17):
        if not pend.any():
            break
        ts = (t[pend] >> shift[pend, None]).astype(np.int32)
        rr = np.stack([ts[:, d] - ts[:, sflat]
                       for d, sflat in _CHAIN], axis=1)
        ok = (rr >= -0x20).all(axis=1) & (rr <= 0x1F).all(axis=1)
        idx = np.flatnonzero(pend)
        r[idx[ok]] = rr[ok]
        shift[idx[~ok]] += 1
        pend[idx[ok]] = False

    six = (r + 0x20).astype(np.uint16)               # [N, 15] in 0..0x3f
    b = _insert_six(six, n)
    b[:, 0] = t[:, 0] >> 8
    b[:, 1] = t[:, 0] & 0xFF
    b[:, 2] |= shift << 2
    blocks = b.astype(np.uint8)

    sizes = np.full(n, 14, np.int64)
    if flat_ok:
        flat = (t == t[:, :1]).all(axis=1)
        sizes[flat] = 3
        blocks[flat, 2] = 0xFC
    # each block's first sizes[i] bytes, in block order
    keep = np.arange(14)[None, :] < sizes[:, None]
    return blocks[keep].tobytes(), sizes


def uncompress(raw: bytes, layout, width: int, expected: int) -> np.ndarray:
    """B44/B44A chunk decode. layout: [(name, pixel_type, nlines)] in
    channel order (pixel_type 1 = HALF). Returns the scanline-interleaved
    uncompressed chunk bytes (same contract as the other codecs)."""
    src = np.frombuffer(raw, np.uint8)
    pos = 0
    planes = []
    ny0 = max(ny for _, _, ny in layout)
    for _, pt, ny in layout:
        if pt != 1:                                  # FLOAT/UINT: verbatim
            n = ny * width * 4
            if pos + n > len(src):
                raise ValueError("EXR: truncated B44 chunk")
            planes.append(src[pos:pos + n].view(np.uint8)
                          .reshape(ny, width * 4))
            pos += n
            continue
        nbx, nby = -(-width // 4), -(-ny // 4)
        nblk = nbx * nby
        # block sizes depend on the per-block flat marker: scan first
        # (a chunk with no flat block, as B44 writes, needs no scan)
        sizes = np.full(nblk, 14, np.int64)
        p = pos + 14 * nblk
        if p <= len(src) and (src[pos + 2:p:14] < 0xFC).all():
            nblk_scan = 0
        else:
            nblk_scan = nblk
            p = pos
        for i in range(nblk_scan):
            if p + 3 > len(src):
                raise ValueError("EXR: truncated B44 chunk")
            if src[p + 2] >= 0xFC:
                sizes[i] = 3
            else:
                sizes[i] = 14
                if p + 14 > len(src):
                    raise ValueError("EXR: truncated B44 chunk")
            p += sizes[i]
        offs = pos + np.concatenate([[0], np.cumsum(sizes)[:-1]])
        pos = p

        s_all = np.empty((nblk, 16), np.uint16)
        full = sizes == 14
        if full.any():
            idx = offs[full][:, None] + np.arange(14)
            s_all[full] = unpack_blocks(src[idx])
        if (~full).any():
            o3 = offs[~full]
            base = ((src[o3].astype(np.uint16) << 8)
                    | src[o3 + 1]).astype(np.uint16)
            s_all[~full] = _inv_transform(base)[:, None]

        grid = (s_all.reshape(nby, nbx, 4, 4)
                .transpose(0, 2, 1, 3).reshape(nby * 4, nbx * 4))
        planes.append(grid[:ny, :width].astype('<u2').view(np.uint8)
                      .reshape(ny, width * 2))

    out = np.empty(expected, np.uint8)
    opos = 0
    for y in range(ny0):
        for (name, pt, ny), plane in zip(layout, planes):
            if y >= ny:
                continue
            row = plane[y]
            out[opos:opos + row.size] = row
            opos += row.size
    if opos != expected:
        raise ValueError("EXR: B44 chunk size mismatch")
    return out


def compress(buf: np.ndarray, layout, width: int, flat_ok: bool) -> bytes:
    """B44/B44A chunk encode of scanline-interleaved chunk bytes."""
    pos = 0
    ny0 = max(ny for _, _, ny in layout)
    planes = {}
    for y in range(ny0):
        for name, pt, ny in layout:
            if y >= ny:
                continue
            stride = width * (2 if pt == 1 else 4)
            planes.setdefault(name, []).append(buf[pos:pos + stride])
            pos += stride
    out = bytearray()
    for name, pt, ny in layout:
        plane = np.concatenate(planes[name]).reshape(ny, -1)
        if pt != 1:
            out += plane.tobytes()
            continue
        half = plane.view('<u2')                     # [ny, width]
        nbx, nby = -(-width // 4), -(-ny // 4)
        padded = np.empty((nby * 4, nbx * 4), np.uint16)
        padded[:ny, :width] = half
        padded[ny:] = padded[ny - 1:ny]              # edge-replicate pad
        padded[:, width:] = padded[:, width - 1:width]
        blocks = (padded.reshape(nby, 4, nbx, 4)
                  .transpose(0, 2, 1, 3).reshape(nby * nbx, 16))
        data, _ = pack_blocks(blocks, flat_ok)
        out += data
    return bytes(out)
