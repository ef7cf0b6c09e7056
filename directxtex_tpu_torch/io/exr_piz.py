"""PIZ (wavelet + Huffman) codec for the port's EXR reader / writer, its
copy of directxtex_tpu/io/exr_piz.py, implemented from the OpenEXR file-
format specification (the reference adapter, Auxiliary/DirectXTexEXR.cpp:
17-31, reads PIZ via the OpenEXR library's RgbaInputFile; there is no
OpenEXR dependency here).

Layout of one PIZ-compressed chunk (32 scanlines):

  u16 minNonZero, u16 maxNonZero        -- range of non-zero bitmap bytes
  u8  bitmap[minNonZero..maxNonZero]    -- 65536-value presence bitmap
  i32 length                            -- Huffman stream byte length
  huf stream:
      u32 im, u32 iM, u32 tableLength, u32 nBits, u32 reserved
      packed 6-bit canonical code lengths for symbols im..iM
      MSB-first bit stream of nBits bits
  decoded u16s: per channel, a contiguous (ny, nx*size) plane, 2D-wavelet
  transformed (14-bit lifting when the value range allows, mod-2^16
  otherwise), values remapped through the bitmap-derived LUT.

The Huffman coder is byte-serial and runs in the port's native piz.cpp
(`huf_uncompress` / `huf_compress`; no fallback); `_huf_uncompress_py` /
`_huf_compress_py` are its numpy twins, for tests. The bitmap, LUT and
wavelet are numpy on the host; the EXR reader copies the decoded chunk
bytes to the device once.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import native

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3
HUF_ENCBITS = 16
HUF_DECBITS = 14
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1

_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN  # 6

_A_OFFSET = 1 << 15
_MOD_MASK = (1 << 16) - 1


# ---------------------------------------------------------------------------
# bitmap / LUT
# ---------------------------------------------------------------------------

def bitmap_from_data(data: np.ndarray):
    """(bitmap u8[BITMAP_SIZE], minNonZero, maxNonZero) for u16 data."""
    present = np.zeros(USHORT_RANGE, np.uint8)
    present[data] = 1
    present[0] = 0  # zero is always present implicitly
    bitmap = np.packbits(present, bitorder="little")
    nz = np.nonzero(bitmap)[0]
    if len(nz) == 0:
        return bitmap, 1, 0  # min > max: empty
    return bitmap, int(nz[0]), int(nz[-1])


def forward_lut_from_bitmap(bitmap: np.ndarray):
    """(lut u16[USHORT_RANGE], maxValue): data -> compact indices."""
    bits = np.unpackbits(bitmap.reshape(-1, 1), axis=1,
                         bitorder="little").reshape(-1)
    bits[0] = 1
    lut = (np.cumsum(bits) - 1).astype(np.uint16)
    lut[bits == 0] = 0
    max_value = int(np.cumsum(bits)[-1] - 1)
    return lut, max_value


def reverse_lut_from_bitmap(bitmap: np.ndarray):
    """(lut u16[USHORT_RANGE], maxValue): compact indices -> data."""
    bits = np.unpackbits(bitmap.reshape(-1, 1), axis=1,
                         bitorder="little").reshape(-1)
    bits[0] = 1
    vals = np.nonzero(bits)[0].astype(np.uint16)
    lut = np.zeros(USHORT_RANGE, np.uint16)
    lut[:len(vals)] = vals
    return lut, len(vals) - 1


# ---------------------------------------------------------------------------
# Huffman coding
# ---------------------------------------------------------------------------

def _canonical_code_table(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes from lengths: value = (code << 6) | length."""
    n = np.zeros(59, np.int64)
    cnt = np.bincount(lengths, minlength=59)
    n[:len(cnt[:59])] = cnt[:59]
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    hcode = lengths.astype(np.int64).copy()
    for i in range(len(hcode)):
        l = int(lengths[i])
        if l > 0:
            hcode[i] = l | (n[l] << 6)
            n[l] += 1
    return hcode


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def bits(self, n: int) -> int:
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _unpack_enc_table(data: bytes, im: int, iM: int):
    """Packed 6-bit lengths with zero-run codes -> lengths[HUF_ENCSIZE]."""
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    br = _BitReader(data)
    i = im
    while i <= iM:
        l = br.bits(6)
        if l == _LONG_ZEROCODE_RUN:
            run = br.bits(8) + _SHORTEST_LONG_RUN
            if i + run > iM + 1:
                raise ValueError("EXR: corrupt PIZ code table")
            i += run
        elif l >= _SHORT_ZEROCODE_RUN:
            run = l - _SHORT_ZEROCODE_RUN + 2
            if i + run > iM + 1:
                raise ValueError("EXR: corrupt PIZ code table")
            i += run
        else:
            lengths[i] = l
            i += 1
    return _canonical_code_table(lengths), br.pos


def _pack_enc_table(hcode: np.ndarray, im: int, iM: int) -> bytes:
    out = bytearray()
    c = 0
    lc = 0

    def put(v, n):
        nonlocal c, lc
        c = (c << n) | v
        lc += n
        while lc >= 8:
            lc -= 8
            out.append((c >> lc) & 0xFF)

    i = im
    while i <= iM:
        l = int(hcode[i]) & 63
        if l == 0:
            # count zero run
            j = i
            while j <= iM and (int(hcode[j]) & 63) == 0:
                j += 1
                if j - i == 255 + _SHORTEST_LONG_RUN:
                    break
            run = j - i
            if run >= _SHORTEST_LONG_RUN:
                put(_LONG_ZEROCODE_RUN, 6)
                put(run - _SHORTEST_LONG_RUN, 8)
                i = j
                continue
            if run >= 2:
                put(_SHORT_ZEROCODE_RUN + run - 2, 6)
                i = j
                continue
        put(l, 6)
        i += 1
    if lc:
        out.append((c << (8 - lc)) & 0xFF)
    return bytes(out)


def huf_uncompress(data: bytes, n_raw: int) -> np.ndarray:
    """Huffman stream -> u16[n_raw] (the port's native piz.cpp)."""
    if n_raw == 0:
        return np.zeros(0, np.uint16)
    return native.piz_huf_uncompress(data, n_raw)


def _huf_uncompress_py(data: bytes, n_raw: int) -> np.ndarray:
    """Numpy twin of the native decoder: the format oracle, for tests."""
    if len(data) < 20:
        raise ValueError("EXR: PIZ huffman header truncated")
    im, iM, _tl, n_bits, _ = struct.unpack_from("<5I", data, 0)
    if im >= HUF_ENCSIZE or iM >= HUF_ENCSIZE:
        raise ValueError("EXR: corrupt PIZ huffman header")
    hcode, used = _unpack_enc_table(data[20:], im, iM)

    # decode table: short codes resolved via a 14-bit prefix LUT
    codes = (hcode >> 6).astype(np.int64)
    lens = (hcode & 63).astype(np.int64)
    short_lit = np.full(HUF_DECSIZE, -1, np.int64)
    short_len = np.zeros(HUF_DECSIZE, np.int64)
    long_codes = {}
    for sym in np.nonzero(lens)[0]:
        l = int(lens[sym])
        cd = int(codes[sym])
        if l <= HUF_DECBITS:
            base = cd << (HUF_DECBITS - l)
            n = 1 << (HUF_DECBITS - l)
            if base + n > HUF_DECSIZE:
                raise ValueError("EXR: corrupt PIZ code table")
            short_lit[base:base + n] = sym
            short_len[base:base + n] = l
        else:
            long_codes[(cd, l)] = int(sym)

    out = np.empty(n_raw, np.uint16)
    pos_out = 0
    rlc = iM
    stream = data[20 + used:]
    c = 0
    lc = 0
    pos = 0
    n_stream = len(stream)
    n_bytes = (n_bits + 7) // 8
    if n_bytes > n_stream:
        raise ValueError("EXR: PIZ huffman stream truncated")

    def out_sym(sym):
        nonlocal pos_out, c, lc, pos
        if sym == rlc:
            # run-length: next 8 bits repeat the previous value
            while lc < 8:
                if pos >= n_bytes:
                    raise ValueError("EXR: corrupt PIZ run-length code")
                c = (c << 8) | stream[pos]
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            if pos_out == 0 or pos_out + cs > n_raw:
                raise ValueError("EXR: corrupt PIZ data")
            out[pos_out:pos_out + cs] = out[pos_out - 1]
            pos_out += cs
        else:
            if pos_out >= n_raw:
                raise ValueError("EXR: corrupt PIZ data")
            out[pos_out] = sym
            pos_out += 1

    while pos < n_bytes:
        c = (c << 8) | stream[pos]
        pos += 1
        lc += 8
        while lc >= HUF_DECBITS:
            idx = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
            sym = int(short_lit[idx])
            if sym >= 0:
                lc -= int(short_len[idx])
                out_sym(sym)
            else:
                # long code: extend bit by bit
                found = False
                for l in range(HUF_DECBITS + 1, 59):
                    while lc < l and pos < n_bytes:
                        c = (c << 8) | stream[pos]
                        pos += 1
                        lc += 8
                    if lc < l:
                        break
                    cd = (c >> (lc - l)) & ((1 << l) - 1)
                    if (cd, l) in long_codes:
                        lc -= l
                        out_sym(long_codes[(cd, l)])
                        found = True
                        break
                if not found:
                    raise ValueError("EXR: corrupt PIZ huffman stream")

    # tail: drop the padding bits of the final byte, then flush whole codes
    pad = n_bytes * 8 - n_bits
    c >>= pad
    lc -= pad
    while lc > 0:
        idx = (c << (HUF_DECBITS - lc)) & HUF_DECMASK
        sym = int(short_lit[idx])
        if sym < 0 or int(short_len[idx]) > lc:
            raise ValueError("EXR: corrupt PIZ huffman stream tail")
        lc -= int(short_len[idx])
        out_sym(sym)
    if pos_out != n_raw:
        raise ValueError("EXR: PIZ output size mismatch "
                         f"({pos_out} != {n_raw})")
    return out


def huf_compress(raw: np.ndarray) -> bytes:
    """u16 data -> Huffman stream (hufCompress layout), by the port's
    native piz.cpp (byte-identical to `_huf_compress_py`; tests hold
    both ways)."""
    if len(raw) == 0:
        return b""
    return native.piz_huf_compress(raw)


def _huf_compress_py(raw: np.ndarray) -> bytes:
    """Numpy twin of the native encoder: the format oracle, for tests."""
    if len(raw) == 0:
        return b""
    freq = np.bincount(raw, minlength=HUF_ENCSIZE).astype(np.int64)
    lengths, im, iM = _build_code_lengths(freq)
    hcode = _canonical_code_table(lengths)

    table = _pack_enc_table(hcode, im, iM)

    # encode with run-length of repeats via the rlc symbol (iM)
    out = bytearray()
    c = 0
    lc = 0

    def put(code_len):
        nonlocal c, lc
        cd = int(code_len) >> 6
        l = int(code_len) & 63
        c = (c << l) | cd
        lc += l
        while lc >= 8:
            lc -= 8
            out.append((c >> lc) & 0xFF)

    def put_bits(v, n):
        nonlocal c, lc
        c = (c << n) | v
        lc += n
        while lc >= 8:
            lc -= 8
            out.append((c >> lc) & 0xFF)

    rlc = iM
    i = 0
    n = len(raw)
    vals = raw.astype(np.int64)
    # find runs of equal values
    change = np.nonzero(np.diff(vals))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    for s, e in zip(starts, ends):
        v = int(vals[s])
        run = int(e - s)
        put(hcode[v])
        run -= 1
        # emit runs: rlc takes an 8-bit count of additional repeats
        while run >= 255:
            # cheaper of (255 repeats) vs literal emission isn't modeled;
            # the format allows chains of rlc codes
            put(hcode[rlc])
            put_bits(255, 8)
            run -= 255
        if run > 0:
            cost_rl = (int(hcode[rlc]) & 63) + 8
            cost_lit = (int(hcode[v]) & 63) * run
            if cost_rl < cost_lit:
                put(hcode[rlc])
                put_bits(run, 8)
            else:
                for _ in range(run):
                    put(hcode[v])
    n_bits = len(out) * 8 + lc
    if lc:
        out.append((c << (8 - lc)) & 0xFF)

    head = struct.pack("<5I", im, iM, len(table), n_bits, 0)
    return head + table + bytes(out)


def _build_code_lengths(freq: np.ndarray):
    """Package-merge-free length-limited Huffman: plain Huffman tree, then
    clamp to 58 bits (depths beyond 58 never occur for 2^16 symbols).
    Returns (lengths, im, iM) where iM indexes the run-length symbol slot
    one past the largest used symbol."""
    import heapq
    nz = np.nonzero(freq)[0]
    im = int(nz[0]) if len(nz) else 0
    iM = int(nz[-1]) + 1 if len(nz) else 1  # rlc symbol slot
    work = freq.copy()
    work[iM] += 1  # reserve the run-length code
    syms = np.nonzero(work)[0]
    if len(syms) == 1:
        lengths = np.zeros(HUF_ENCSIZE, np.int64)
        lengths[syms[0]] = 1
        return lengths, im, iM
    heap = [(int(work[s]), int(s), (int(s),)) for s in syms]
    heapq.heapify(heap)
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    while len(heap) > 1:
        fa, _, la = heapq.heappop(heap)
        fb, tb, lb = heapq.heappop(heap)
        for s in la:
            lengths[s] += 1
        for s in lb:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, tb, la + lb))
    np.clip(lengths, 0, 58, out=lengths)
    return lengths, im, iM


# ---------------------------------------------------------------------------
# 2D wavelet (wav2En/Decode)
# ---------------------------------------------------------------------------

def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (ai - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc14(a, b):
    asx = a.astype(np.int16).astype(np.int32)
    bs = b.astype(np.int16).astype(np.int32)
    ms = (asx + bs) >> 1
    ds = asx - bs
    return ms.astype(np.uint16), ds.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    b = (m - (d >> 1)) & _MOD_MASK
    a = (d + b - _A_OFFSET) & _MOD_MASK
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    bi = b.astype(np.int32)
    m = (ao + bi) >> 1
    d = ao - bi
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def wav2_decode(buf: np.ndarray, nx: int, ox: int, ny: int, oy: int,
                mx: int) -> None:
    """In-place inverse 2D wavelet on a strided u16 view (wav2Decode)."""
    w14 = mx < (1 << 14)
    dec = _wdec14 if w14 else _wdec16
    view = np.lib.stride_tricks.as_strided(
        buf, shape=(ny, nx), strides=(oy * 2, ox * 2))

    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1

    while p >= 1:
        y_idx = np.arange(0, ny - p2 + 1, p2)
        x_idx = np.arange(0, nx - p2 + 1, p2)
        if len(y_idx) and len(x_idx):
            g00 = view[np.ix_(y_idx, x_idx)]
            g01 = view[np.ix_(y_idx, x_idx + p)]
            g10 = view[np.ix_(y_idx + p, x_idx)]
            g11 = view[np.ix_(y_idx + p, x_idx + p)]
            i00, i10 = dec(g00, g10)
            i01, i11 = dec(g01, g11)
            a00, a01 = dec(i00, i01)
            a10, a11 = dec(i10, i11)
            view[np.ix_(y_idx, x_idx)] = a00
            view[np.ix_(y_idx, x_idx + p)] = a01
            view[np.ix_(y_idx + p, x_idx)] = a10
            view[np.ix_(y_idx + p, x_idx + p)] = a11
        if nx & p and len(y_idx):
            # odd remainder column: vertical pairs only
            xl = x_idx[-1] + p2 if len(x_idx) else 0
            if xl < nx:
                c0 = view[np.ix_(y_idx, [xl])]
                c1 = view[np.ix_(y_idx + p, [xl])]
                a0, a1 = dec(c0, c1)
                view[np.ix_(y_idx, [xl])] = a0
                view[np.ix_(y_idx + p, [xl])] = a1
        if ny & p and len(x_idx):
            yl = y_idx[-1] + p2 if len(y_idx) else 0
            if yl < ny:
                r0 = view[np.ix_([yl], x_idx)]
                r1 = view[np.ix_([yl], x_idx + p)]
                a0, a1 = dec(r0, r1)
                view[np.ix_([yl], x_idx)] = a0
                view[np.ix_([yl], x_idx + p)] = a1
        p2 = p
        p >>= 1


def wav2_encode(buf: np.ndarray, nx: int, ox: int, ny: int, oy: int,
                mx: int) -> None:
    """In-place forward 2D wavelet (wav2Encode)."""
    w14 = mx < (1 << 14)
    enc = _wenc14 if w14 else _wenc16
    view = np.lib.stride_tricks.as_strided(
        buf, shape=(ny, nx), strides=(oy * 2, ox * 2))

    n = min(nx, ny)
    # forward passes run fine-to-coarse, mirroring the decode levels
    p = 1
    p2 = 2
    while p2 <= n:
        y_idx = np.arange(0, ny - p2 + 1, p2)
        x_idx = np.arange(0, nx - p2 + 1, p2)
        if len(y_idx) and len(x_idx):
            a00 = view[np.ix_(y_idx, x_idx)]
            a01 = view[np.ix_(y_idx, x_idx + p)]
            a10 = view[np.ix_(y_idx + p, x_idx)]
            a11 = view[np.ix_(y_idx + p, x_idx + p)]
            i00, i01 = enc(a00, a01)
            i10, i11 = enc(a10, a11)
            g00, g10 = enc(i00, i10)
            g01, g11 = enc(i01, i11)
            view[np.ix_(y_idx, x_idx)] = g00
            view[np.ix_(y_idx, x_idx + p)] = g01
            view[np.ix_(y_idx + p, x_idx)] = g10
            view[np.ix_(y_idx + p, x_idx + p)] = g11
        if nx & p and len(y_idx):
            xl = x_idx[-1] + p2 if len(x_idx) else 0
            if xl < nx:
                c0 = view[np.ix_(y_idx, [xl])]
                c1 = view[np.ix_(y_idx + p, [xl])]
                a0, a1 = enc(c0, c1)
                view[np.ix_(y_idx, [xl])] = a0
                view[np.ix_(y_idx + p, [xl])] = a1
        if ny & p and len(x_idx):
            yl = y_idx[-1] + p2 if len(y_idx) else 0
            if yl < ny:
                r0 = view[np.ix_([yl], x_idx)]
                r1 = view[np.ix_([yl], x_idx + p)]
                a0, a1 = enc(r0, r1)
                view[np.ix_([yl], x_idx)] = a0
                view[np.ix_([yl], x_idx + p)] = a1
        p = p2
        p2 <<= 1


# ---------------------------------------------------------------------------
# chunk-level API
# ---------------------------------------------------------------------------

def piz_uncompress(raw: bytes, chan_layout, width: int) -> np.ndarray:
    """One PIZ chunk -> scanline-interleaved bytes (same layout as the
    NONE/ZIP paths in io/exr.py). chan_layout: list of (name, n_u16s)
    where n_u16s = 1 for half, 2 for float/uint, for ny scanlines.
    Returns np.uint8 array. chan_layout entries carry ny via tuples
    (name, size_u16, ny)."""
    pos = 0
    min_nz, max_nz = struct.unpack_from("<2H", raw, pos)
    pos += 4
    if max_nz >= BITMAP_SIZE:
        raise ValueError("EXR: corrupt PIZ bitmap")
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        n = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(raw, np.uint8, n, pos)
        pos += n
    lut, max_value = reverse_lut_from_bitmap(bitmap)

    (length,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    if length < 0 or pos + length > len(raw):
        raise ValueError("EXR: corrupt PIZ chunk")

    total = sum(size * ny * width for _, size, ny in chan_layout)
    data = huf_uncompress(raw[pos:pos + length], total)

    # per-channel wavelet decode on planes
    off = 0
    planes = []
    for _, size, ny in chan_layout:
        nxs = width * size
        plane = data[off:off + nxs * ny]
        off += nxs * ny
        for j in range(size):
            wav2_decode(plane[j:], width, size, ny, nxs, max_value)
        planes.append(plane.reshape(ny, nxs))
    data = data  # planes are views into data

    np.take(lut, data, out=data)  # applyLut

    # interleave to scanline order: line y = concat of each channel's row
    ny0 = chan_layout[0][2]
    rows = []
    for y in range(ny0):
        for plane, (_, size, ny) in zip(planes, chan_layout):
            if y < ny:
                rows.append(plane[y])
    return np.concatenate(rows).view(np.uint8) if rows \
        else np.zeros(0, np.uint8)


def piz_compress(buf: np.ndarray, chan_layout, width: int) -> bytes:
    """Scanline-interleaved u8 chunk data -> PIZ chunk bytes."""
    u16 = np.frombuffer(np.ascontiguousarray(buf).tobytes(), np.uint16)
    # de-interleave scanlines into channel planes
    planes = []
    off = 0
    ny0 = chan_layout[0][2]
    plane_bufs = [np.empty(size * ny * width, np.uint16)
                  for _, size, ny in chan_layout]
    for y in range(ny0):
        for plane, (_, size, ny) in zip(plane_bufs, chan_layout):
            if y < ny:
                nxs = width * size
                plane[y * nxs:(y + 1) * nxs] = u16[off:off + nxs]
                off += nxs
    data = np.concatenate(plane_bufs) if plane_bufs \
        else np.zeros(0, np.uint16)

    bitmap, min_nz, max_nz = bitmap_from_data(data)
    lut, max_value = forward_lut_from_bitmap(bitmap)
    np.take(lut, data, out=data)

    off = 0
    for _, size, ny in chan_layout:
        nxs = width * size
        plane = data[off:off + nxs * ny]
        off += nxs * ny
        for j in range(size):
            wav2_encode(plane[j:], width, size, ny, nxs, max_value)

    huf = huf_compress(data)
    head = struct.pack("<2H", min_nz, max_nz)
    bm = bitmap[min_nz:max_nz + 1].tobytes() if min_nz <= max_nz else b""
    return head + bm + struct.pack("<i", len(huf)) + huf
