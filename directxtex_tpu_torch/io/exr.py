"""OpenEXR (.exr) container codec on torch tensors.

The counterpart of directxtex_tpu/io/exr.py, which mirrors the reference's
OpenEXR adapter (Auxiliary/DirectXTexEXR.cpp: LoadFromEXRFile /
SaveToEXRFile through RgbaInputFile / RgbaOutputFile as half RGBA <->
R16G16B16A16_FLOAT). It reads and writes the container directly:
single-part scanline images, HALF / FLOAT / UINT channels, NONE / RLE /
ZIPS / ZIP / PIZ / B44 / B44A compression for read and write plus PXR24
read. PIZ is exr_piz.py (its Huffman coder the port's native piz.cpp),
B44 exr_b44.py. DWAA / DWAB (lossy DCT) go through the official OpenEXR
library by the port's adapter (native/exr_openexr.cpp) where OpenEXR's
headers are, the dependency the reference's whole EXR path has, and raise
ValueError elsewhere. Tiled, deep and multi-part files are rejected, as
the adapter's RgbaInputFile would.

A load parses the header and decompresses every chunk on the host into
one scanline-ordered byte image, copies it to the device once and
converts the channels there (halves by formats.packing._half_to_f32, the
same bits on the CPU and on CUDA). Load returns f32 RGBA with metadata
format R16G16B16A16_FLOAT (Auxiliary/DirectXTexEXR.cpp:172-183); missing
channels: G / B -> 0, A -> 1, a lone 'Y' broadcasts to RGB. A save rounds
to half on the texture's device, makes one D2H copy and compresses on the
host (ZIP by default).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np
import torch

from .. import native
from ..formats.dxgi import FMT
from ..formats.packing import _bits_f32, _f32_to_half, _half_to_f32, _words
from ..texture import TexDimension, TexMetadata, Texture
from ..utils.device import resolve
from . import exr_b44, exr_piz

__all__ = [
    "get_metadata_from_exr_memory", "load_from_exr_memory",
    "save_to_exr_memory", "load_from_exr_file", "save_to_exr_file",
]

_MAGIC = 0x01312F76

# compression ids (OpenEXR ImfCompression.h)
_NONE, _RLE, _ZIPS, _ZIP, _PIZ, _PXR24, _B44, _B44A, _DWAA, _DWAB = range(10)
_LINES_PER_BLOCK = {_NONE: 1, _RLE: 1, _ZIPS: 1, _ZIP: 16, _PIZ: 32,
                    _PXR24: 16, _B44: 32, _B44A: 32}
# writer-supported subset (PXR24 is decode-only: it is lossy for float
# channels, and the reference's adapter never writes it; B44/B44A are
# lossy too but write-supported since the half-RGBA writer matches
# their HALF-only fast path)
_WRITE_COMPRESSIONS = (_NONE, _RLE, _ZIPS, _ZIP, _PIZ, _B44, _B44A)
_PIXEL_DTYPE = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bytes(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("EXR: truncated file")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self.bytes(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.bytes(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.bytes(8))[0]

    def cstr(self, maxlen: int = 256) -> bytes:
        end = self.data.find(b"\0", self.pos)
        if end < 0 or end - self.pos > maxlen:
            raise ValueError("EXR: unterminated string")
        s = self.data[self.pos:end]
        self.pos = end + 1
        return s


def _parse_channels(raw: bytes):
    """chlist attribute -> [(name, pixel_type, x_samp, y_samp)]."""
    r = _Reader(raw)
    out = []
    while True:
        if r.pos >= len(raw) or raw[r.pos] == 0:
            break
        name = r.cstr().decode("latin-1")
        ptype = r.i32()
        r.bytes(4)  # pLinear + reserved
        xs = r.i32()
        ys = r.i32()
        if ptype not in _PIXEL_DTYPE:
            raise ValueError(f"EXR: bad pixel type {ptype}")
        out.append((name, ptype, xs, ys))
    return out


def _parse_header(data: bytes):
    r = _Reader(data)
    if r.u32() != _MAGIC:
        raise ValueError("EXR: bad magic")
    version = r.u32()
    if version & 0xFF != 2:
        raise ValueError(f"EXR: unsupported version {version & 0xFF}")
    if version & 0x200:
        raise ValueError("EXR: tiled images not supported")
    if version & 0x800:
        raise ValueError("EXR: deep data not supported")
    if version & 0x1000:
        raise ValueError("EXR: multi-part files not supported")

    attrs = {}
    while True:
        name = r.cstr()
        if not name:
            break
        atype = r.cstr()
        size = r.i32()
        if size < 0 or size > len(data):
            raise ValueError("EXR: bad attribute size")
        attrs[name.decode("latin-1")] = (atype.decode("latin-1"),
                                         r.bytes(size))

    for req in ("channels", "compression", "dataWindow", "lineOrder"):
        if req not in attrs:
            raise ValueError(f"EXR: missing required attribute {req}")

    channels = _parse_channels(attrs["channels"][1])
    compression = attrs["compression"][1][0]
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    line_order = attrs["lineOrder"][1][0]
    if line_order > 1:
        raise ValueError("EXR: random line order not supported")
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    if width <= 0 or height <= 0 or width > 1 << 24 or height > 1 << 24:
        raise ValueError("EXR: bad data window")
    for name, _, xs, ys in channels:
        if xs != 1 or ys != 1:
            raise ValueError(
                f"EXR: subsampled channel {name!r} not supported")
    return {
        "channels": channels, "compression": compression,
        "width": width, "height": height,
        "ymin": ymin, "line_order": line_order,
        "header_end": r.pos, "attrs": attrs,
    }


def _unpredict(buf: np.ndarray) -> np.ndarray:
    """Undo the ZIP/RLE byte predictor: running delta then de-interleave
    (OpenEXR ImfZip.cpp uncompress path)."""
    d = buf.astype(np.int64)
    d[1:] -= 128
    d = np.cumsum(d) & 0xFF
    out = np.empty_like(buf)
    half = (len(buf) + 1) // 2
    out[0::2] = d[:half].astype(np.uint8)
    out[1::2] = d[half:].astype(np.uint8)
    return out


def _predict(buf: np.ndarray) -> np.ndarray:
    """ZIP/RLE byte predictor: interleave-split then delta encode."""
    half = (len(buf) + 1) // 2
    t = np.empty_like(buf)
    t[:half] = buf[0::2]
    t[half:] = buf[1::2]
    d = t.astype(np.int16)
    d[1:] = d[1:] - d[:-1] + (128 + 256)
    return d.astype(np.uint8)


def _rle_decode(src: bytes, expected: int) -> np.ndarray:
    out = np.empty(expected, np.uint8)
    pos = 0
    i = 0
    n = len(src)
    while i < n and pos < expected:
        count = src[i]
        i += 1
        if count > 127:  # negative signed char: literal run
            run = 256 - count
            if i + run > n or pos + run > expected:
                raise ValueError("EXR: corrupt RLE data")
            out[pos:pos + run] = np.frombuffer(src, np.uint8, run, i)
            i += run
            pos += run
        else:
            run = count + 1
            if i >= n or pos + run > expected:
                raise ValueError("EXR: corrupt RLE data")
            out[pos:pos + run] = src[i]
            i += 1
            pos += run
    if pos != expected:
        raise ValueError("EXR: RLE output size mismatch")
    return out


def _rle_encode_py(buf: np.ndarray) -> bytes:
    """The JAX package's RLE encoder, a loop over bytes: the twin that
    `_rle_encode` is held to, for tests."""
    out = bytearray()
    n = len(buf)
    i = 0
    while i < n:
        # find run length of identical bytes
        j = i + 1
        while j < n and j - i < 128 and buf[j] == buf[i]:
            j += 1
        if j - i >= 3:
            out.append(j - i - 1)
            out.append(int(buf[i]))
            i = j
        else:
            # literal run until next >=3 repeat or 127 bytes
            j = i
            while j < n and j - i < 127:
                if (j + 2 < n and buf[j] == buf[j + 1] == buf[j + 2]):
                    break
                j += 1
            out.append(256 - (j - i))
            out.extend(buf[i:j].tobytes())
            i = j
    return bytes(out)


def _rle_encode(buf: np.ndarray) -> bytes:
    """`_rle_encode_py`'s packets, with the run lengths and the next run of
    three found by numpy: a loop over packets, not bytes."""
    buf = np.ascontiguousarray(buf, np.uint8)
    n = len(buf)
    if n == 0:
        return b""
    starts = np.concatenate([[0], np.flatnonzero(buf[1:] != buf[:-1]) + 1])
    ends = np.concatenate([starts[1:], [n]])
    run = np.repeat(ends, ends - starts) - np.arange(n)   # equal bytes from i
    # the least j >= i where three equal bytes start (n where none does)
    at = np.where(run >= 3, np.arange(n), n)
    next_three = np.minimum.accumulate(at[::-1])[::-1]
    out = bytearray()
    i = 0
    while i < n:
        r = min(int(run[i]), 128)
        if r >= 3:
            out.append(r - 1)
            out.append(int(buf[i]))
            i += r
        else:
            j = min(int(next_three[i]), i + 127)
            out.append(256 - (j - i))
            out += buf[i:j].tobytes()
            i = j
    return bytes(out)


def _pxr24_uncompress(raw: bytes, layout, width: int,
                      expected: int) -> np.ndarray:
    """PXR24 chunk decode (ImfPxr24Compressor semantics): zlib, then per
    (scanline, channel) byte-planes with a running 32-bit delta sum.
    layout: list of (name, pixel_type, nlines)."""
    buf = np.frombuffer(zlib.decompress(raw), np.uint8)
    out = np.empty(expected, np.uint8)
    pos = 0
    opos = 0
    ny0 = max(ny for _, _, ny in layout)
    for y in range(ny0):
        for _, pt, ny in layout:
            if y >= ny:
                continue
            n = width
            if pt == 1:  # HALF: 2 byte planes, 16-bit deltas
                if pos + 2 * n > len(buf):
                    raise ValueError("EXR: truncated PXR24 chunk")
                d = (buf[pos:pos + n].astype(np.uint64) << 8) \
                    | buf[pos + n:pos + 2 * n]
                pos += 2 * n
                px = np.cumsum(d).astype(np.uint16)
                out[opos:opos + 2 * n] = px.view(np.uint8)
                opos += 2 * n
            elif pt == 2:  # FLOAT: 3 byte planes, 24-bit deltas, <<8
                if pos + 3 * n > len(buf):
                    raise ValueError("EXR: truncated PXR24 chunk")
                d = (buf[pos:pos + n].astype(np.uint64) << 24) \
                    | (buf[pos + n:pos + 2 * n].astype(np.uint64) << 16) \
                    | (buf[pos + 2 * n:pos + 3 * n].astype(np.uint64) << 8)
                pos += 3 * n
                px = np.cumsum(d).astype(np.uint32)
                out[opos:opos + 4 * n] = px.view(np.uint8)
                opos += 4 * n
            else:  # UINT: 4 byte planes, 32-bit deltas
                if pos + 4 * n > len(buf):
                    raise ValueError("EXR: truncated PXR24 chunk")
                d = (buf[pos:pos + n].astype(np.uint64) << 24) \
                    | (buf[pos + n:pos + 2 * n].astype(np.uint64) << 16) \
                    | (buf[pos + 2 * n:pos + 3 * n].astype(np.uint64) << 8) \
                    | buf[pos + 3 * n:pos + 4 * n]
                pos += 4 * n
                px = np.cumsum(d).astype(np.uint32)
                out[opos:opos + 4 * n] = px.view(np.uint8)
                opos += 4 * n
    if opos != expected:
        raise ValueError("EXR: PXR24 chunk size mismatch")
    return out


def _piz_layout(layout):
    """(name, pixel_type, ny) -> (name, u16s_per_pixel, ny)."""
    return [(n, 1 if pt == 1 else 2, ny) for n, pt, ny in layout]


def _decompress_chunk(raw: bytes, compression: int, expected: int,
                      layout=None, width: int = 0) -> np.ndarray:
    if compression == _NONE or len(raw) >= expected:
        # OpenEXR stores chunks raw when compression didn't shrink them
        if len(raw) != expected and compression == _NONE:
            raise ValueError("EXR: bad uncompressed chunk size")
        if len(raw) == expected:
            return np.frombuffer(raw, np.uint8)
    if compression in (_ZIP, _ZIPS):
        buf = np.frombuffer(zlib.decompress(raw), np.uint8)
        if len(buf) != expected:
            raise ValueError("EXR: zip chunk size mismatch")
        return _unpredict(buf)
    if compression == _RLE:
        return _unpredict(_rle_decode(raw, expected))
    if compression == _PIZ:
        out = exr_piz.piz_uncompress(raw, _piz_layout(layout), width)
        if len(out) != expected:
            raise ValueError("EXR: PIZ chunk size mismatch")
        return out
    if compression == _PXR24:
        return _pxr24_uncompress(raw, layout, width, expected)
    if compression in (_B44, _B44A):
        return exr_b44.uncompress(raw, layout, width, expected)
    raise ValueError(f"EXR: compression {compression} not supported "
                     "(NONE/RLE/ZIPS/ZIP/PIZ/PXR24/B44/B44A only)")


def _metadata(width: int, height: int) -> TexMetadata:
    return TexMetadata(
        width=width, height=height, depth=1, array_size=1, mip_levels=1,
        format=FMT.R16G16B16A16_FLOAT, dimension=TexDimension.TEXTURE2D)


def get_metadata_from_exr_memory(data: bytes) -> TexMetadata:
    """GetMetadataFromEXRFile (Auxiliary/DirectXTexEXR.cpp:112-183)."""
    h = _parse_header(bytes(data))
    return _metadata(h["width"], h["height"])


@dataclasses.dataclass
class _Plan:
    """The device stage's recipe. kind "lines": the payload is the
    uncompressed scanlines, [height, line bytes], each line the channels'
    rows in `channels` order; kind "halves": [H, W, 4] half bits from
    OpenEXR."""
    kind: str
    width: int
    height: int
    channels: list


def _host_parse(data: bytes):
    """Header and every chunk on the host -> (payload u8, plan)."""
    data = bytes(data)
    h = _parse_header(data)
    width, height = h["width"], h["height"]
    comp = h["compression"]
    if comp not in _LINES_PER_BLOCK:
        halves = native.openexr_read_half(data)
        if halves is None:
            raise ValueError(
                f"EXR: compression {comp} not supported (NONE/RLE/ZIPS/ZIP/"
                "PIZ/PXR24/B44/B44A natively; DWAA/DWAB need the OpenEXR "
                "adapter shim)")
        return halves.view(np.uint8), _Plan("halves", width, height, [])
    lpb = _LINES_PER_BLOCK[comp]
    nchunks = (height + lpb - 1) // lpb

    r = _Reader(data)
    r.pos = h["header_end"]
    offsets = [r.u64() for _ in range(nchunks)]

    chans = [(name, pt) for name, pt, _, _ in h["channels"]]
    line = sum(_PIXEL_DTYPE[pt].itemsize for _, pt in chans) * width
    lines = np.zeros((height, line), np.uint8)
    for off in offsets:
        rr = _Reader(data)
        rr.pos = off
        y = rr.i32() - h["ymin"]
        size = rr.i32()
        if y < 0 or y >= height:
            raise ValueError("EXR: chunk scanline out of range")
        nlines = min(lpb, height - y)
        raw = rr.bytes(size)
        layout = [(name, pt, nlines) for name, pt in chans]
        buf = _decompress_chunk(raw, comp, line * nlines, layout=layout,
                                width=width)
        lines[y:y + nlines] = np.asarray(buf).reshape(nlines, line)
    return lines, _Plan("lines", width, height, chans)


def _device_decode(payload: torch.Tensor, plan: _Plan) -> Texture:
    height, width = plan.height, plan.width
    meta = _metadata(width, height)
    if plan.kind == "halves":
        rgba = _half_to_f32(_words(payload.reshape(-1), 2)).reshape(
            height, width, 4)
        return Texture(meta, [rgba[None]])

    planes = {}
    col = 0
    for name, pt in plan.channels:
        size = _PIXEL_DTYPE[pt].itemsize
        words = _words(payload[:, col:col + width * size].reshape(-1),
                       size).reshape(height, width)
        col += width * size
        if pt == 1:
            planes[name] = _half_to_f32(words)
        elif pt == 2:
            planes[name] = _bits_f32(words)
        else:                              # UINT -> float
            planes[name] = words.to(torch.float32)

    def zeros():
        return torch.zeros((height, width), dtype=torch.float32,
                           device=payload.device)

    if "R" in planes or "G" in planes or "B" in planes:
        red = planes.get("R", None)
        grn = planes.get("G", None)
        blu = planes.get("B", None)
        red, grn, blu = (c if c is not None else zeros()
                         for c in (red, grn, blu))
    elif "Y" in planes:
        red = grn = blu = planes["Y"]
    else:
        red = grn = blu = planes[plan.channels[0][0]]
    alpha = planes["A"] if "A" in planes else torch.ones_like(red)
    rgba = torch.stack([red, grn, blu, alpha], dim=-1)
    return Texture(meta, [rgba[None]])


def load_from_exr_memory(data: bytes, device=None) -> Texture:
    """LoadFromEXRFile semantics: decode to RGBA (half precision data,
    f32 planes on `device`, CUDA unless named)."""
    payload, plan = _host_parse(data)
    return _device_decode(torch.from_numpy(payload).to(resolve(device)),
                          plan)


def load_from_exr_file(path, device=None) -> Texture:
    with open(path, "rb") as f:
        return load_from_exr_memory(f.read(), device)


def _attr(name: bytes, atype: bytes, value: bytes) -> bytes:
    return name + b"\0" + atype + b"\0" + struct.pack("<i", len(value)) \
        + value


def _halves(tex: Texture, mip: int, item: int) -> np.ndarray:
    """[H, W, 4] half bits of one image, rounded on the texture's device
    and copied to the host once."""
    img = tex.levels[mip][item]
    return _f32_to_half(img).to(torch.int16).cpu().numpy().view(np.uint16)


def save_to_exr_memory(tex: Texture, mip: int = 0, item: int = 0,
                       compression: int = _ZIP) -> bytes:
    """SaveToEXRFile (Auxiliary/DirectXTexEXR.cpp:320+): half RGBA
    scanlines, ZIP compression by default."""
    if compression in (_DWAA, _DWAB):
        data = native.openexr_write_half(_halves(tex, mip, item),
                                         compression)
        if data is None:
            raise ValueError("EXR: DWAA/DWAB save needs the OpenEXR "
                             "adapter shim")
        return data
    if compression not in _WRITE_COMPRESSIONS:
        raise ValueError("EXR: unsupported save compression")
    halves = _halves(tex, mip, item)
    height, width = halves.shape[:2]
    # a line is the A, B, G, R rows in turn (alphabetical, as OpenEXR
    # writes)
    chan_names = ["A", "B", "G", "R"]
    lines = np.ascontiguousarray(halves[..., ::-1].transpose(0, 2, 1))

    chlist = b""
    for n in chan_names:
        chlist += n.encode() + b"\0" + struct.pack("<i", 1) \
            + b"\0\0\0\0" + struct.pack("<ii", 1, 1)
    chlist += b"\0"
    box = struct.pack("<4i", 0, 0, width - 1, height - 1)

    header = struct.pack("<II", _MAGIC, 2)
    header += _attr(b"channels", b"chlist", chlist)
    header += _attr(b"compression", b"compression",
                    bytes([compression]))
    header += _attr(b"dataWindow", b"box2i", box)
    header += _attr(b"displayWindow", b"box2i", box)
    header += _attr(b"lineOrder", b"lineOrder", b"\0")
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    lpb = _LINES_PER_BLOCK[compression]
    nchunks = (height + lpb - 1) // lpb
    chunks = []
    for c in range(nchunks):
        y = c * lpb
        nlines = min(lpb, height - y)
        raw = lines[y:y + nlines].reshape(-1).view(np.uint8)
        if compression in (_ZIP, _ZIPS):
            packed = zlib.compress(_predict(raw).tobytes())
        elif compression == _RLE:
            packed = _rle_encode(_predict(raw))
        elif compression == _PIZ:
            layout = [(n, 1, nlines) for n in chan_names]  # half channels
            packed = exr_piz.piz_compress(raw, layout, width)
        elif compression in (_B44, _B44A):
            layout = [(n, 1, nlines) for n in chan_names]
            packed = exr_b44.compress(raw, layout, width,
                                      flat_ok=compression == _B44A)
        else:
            packed = raw.tobytes()
        if len(packed) >= len(raw):
            packed = raw.tobytes()  # store raw when compression loses
        chunks.append((y, packed))

    offset_base = len(header) + 8 * nchunks
    out = [header]
    off = offset_base
    for y, packed in chunks:
        out.append(struct.pack("<Q", off))
        off += 8 + len(packed)
    for y, packed in chunks:
        out.append(struct.pack("<ii", y, len(packed)))
        out.append(packed)
    return b"".join(out)


def save_to_exr_file(tex: Texture, path, **kwargs) -> None:
    with open(path, "wb") as f:
        f.write(save_to_exr_memory(tex, **kwargs))
