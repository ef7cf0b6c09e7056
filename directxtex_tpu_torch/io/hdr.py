"""Radiance HDR (.hdr, RGBE) container codec on torch tensors.

The counterpart of directxtex_tpu/io/hdr.py (DirectXTexHDR.cpp):
'#?RADIANCE'/'#?RGBE' signatures, only FORMAT=32-bit_rle_rgbe
(DirectXTexHDR.cpp:46-60), only '-Y h +X w' orientation (:14-26), EXPOSURE
tag applied on load (:175-202), adaptive new-style RLE plus old-style run
support on decode (:755-885), new-style RLE on encode (:413+). Pixels
decode to R32G32B32A32_FLOAT with value = ldexp(mantissa + 0.5, e - 136)
/ exposure (:894-896).

A load parses the header and decodes the scanlines on the host (the
port's native rle_codec.cpp; `_decode_scanlines_py` is its numpy twin,
for tests), copies the RGBE bytes to the device once and decodes them
there. The power 2^(e - 136) is exact (a table of ldexpf's values, every
one of them a normal or subnormal f32), where the JAX package's XLA
`exp2` misses most exponents, and the two roundings stay the JAX
package's: power x f32(1 / exposure), then x (m + 0.5). A save converts
to RGBE on the texture's device in f64 (numpy's arithmetic there), makes
one D2H copy of the RGBE bytes and RLE-encodes them on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from ..formats.dxgi import FMT
from ..texture import TexDimension, TexMetadata, Texture
from ..utils.device import constant, resolve

__all__ = [
    "get_metadata_from_hdr_memory", "load_from_hdr_memory",
    "save_to_hdr_memory", "load_from_hdr_file", "save_to_hdr_file",
]


def _parse_header(data: bytes):
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("HDR: missing Radiance signature")
    # scan header lines
    pos = 0
    exposure = 1.0
    found_format = False
    n = len(data)
    # find end of signature line
    while pos < n and data[pos] not in (0x0A,):
        pos += 1
    pos += 1
    while pos < n:
        eol = data.find(b"\n", pos)
        if eol < 0:
            raise ValueError("HDR: truncated header")
        line = data[pos:eol].strip()
        pos = eol + 1
        if not line:
            break  # blank line ends header
        if line.startswith(b"#"):
            continue
        if line.startswith(b"FORMAT="):
            fmtv = line[len(b"FORMAT="):].strip()
            if fmtv != b"32-bit_rle_rgbe":
                raise ValueError(f"HDR: unsupported FORMAT {fmtv!r}")
            found_format = True
        elif line.startswith(b"EXPOSURE="):
            try:
                e = float(line[len(b"EXPOSURE="):])
            except ValueError:
                e = 0.0
            if 1e-12 <= e <= 1e12:
                # strange exposure values are ignored (DirectXTexHDR.cpp:199)
                exposure *= e
    if not found_format:
        raise ValueError("HDR: FORMAT line not found")
    # resolution line
    eol = data.find(b"\n", pos)
    if eol < 0:
        raise ValueError("HDR: missing resolution line")
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError("HDR: only '-Y height +X width' orientation supported")
    height = int(res[1])
    width = int(res[3])
    if width == 0 or height == 0:
        raise ValueError("HDR: zero-sized image")
    return width, height, exposure, pos


def get_metadata_from_hdr_memory(data: bytes) -> TexMetadata:
    w, h, _, _ = _parse_header(bytes(data))
    return TexMetadata(width=w, height=h, format=FMT.R32G32B32A32_FLOAT,
                       dimension=TexDimension.TEXTURE2D)


def _decode_scanlines_py(data: bytes, offset: int, width: int,
                         height: int) -> np.ndarray:
    """Numpy twin of the native scanline decode (both RLE styles) ->
    [H, W, 4] uint8: the JAX package's Python decoder, for tests."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    pos = offset
    n = len(src)
    for y in range(height):
        if pos + 4 > n:
            raise ValueError("HDR: pixel data truncated")
        c0, c1, c2, c3 = src[pos:pos + 4]
        if c0 == 2 and c1 == 2 and c2 < 128:
            # adaptive (new-style) RLE
            if ((int(c2) << 8) + int(c3)) != width:
                raise ValueError("HDR: scanline width mismatch")
            pos += 4
            for ch in range(4):
                x = 0
                while x < width:
                    if pos + 2 > n:
                        raise ValueError("HDR: RLE truncated")
                    run = int(src[pos])
                    if run > 128:
                        run &= 127
                        if x + run > width:
                            raise ValueError("HDR: RLE run overflow")
                        out[y, x:x + run, ch] = src[pos + 1]
                        pos += 2
                    else:
                        if pos + 1 + run > n or x + run > width:
                            raise ValueError("HDR: RLE literal overflow")
                        out[y, x:x + run, ch] = src[pos + 1:pos + 1 + run]
                        pos += 1 + run
                    x += run
        else:
            # flat scanline with optional old-style runs (1,1,1,count<<shift)
            x = 0
            prev = np.zeros(4, np.uint8)
            bit_shift = 0
            while x < width:
                if pos + 4 > n:
                    raise ValueError("HDR: pixel data truncated")
                px = src[pos:pos + 4]
                pos += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    if bit_shift > 24:
                        raise ValueError("HDR: invalid old-style run")
                    span = int(px[3]) << bit_shift
                    if x + span > width:
                        raise ValueError("HDR: old-style run overflow")
                    out[y, x:x + span] = prev
                    x += span
                    bit_shift += 8
                else:
                    out[y, x] = px
                    prev = px
                    bit_shift = 0
                    x += 1
    return out


def _pow2_table() -> np.ndarray:
    """2^(e - 136) for e = 0..255, exactly (ldexpf's values; e < 10 gives
    a subnormal)."""
    return np.ldexp(np.float32(1.0), np.arange(256) - 136).astype(np.float32)


@dataclasses.dataclass
class _Plan:
    width: int
    height: int
    exposure: float


def _host_parse(data: bytes):
    """Header and scanlines on the host -> ([H, W, 4] u8 RGBE, plan)."""
    data = bytes(data)
    width, height, exposure, offset = _parse_header(data)
    rgbe = native.hdr_decode_scanlines(data, offset, width, height)
    return rgbe, _Plan(width, height, exposure)


def _device_decode(rgbe: torch.Tensor, plan: _Plan) -> Texture:
    """[H, W, 4] u8 RGBE -> f32 RGBA (alpha 1) on rgbe's device:
    (m + 0.5) x (2^(e - 136) x f32(1 / exposure)), each product rounded
    to f32."""
    pow2 = constant("hdr_pow2", _pow2_table, rgbe.device)
    scale = pow2[rgbe[..., 3].to(torch.int64)] * float(
        np.float32(1.0 / plan.exposure))
    rgb = (rgbe[..., :3].to(torch.float32) + 0.5) * scale[..., None]
    meta = TexMetadata(width=plan.width, height=plan.height,
                       format=FMT.R32G32B32A32_FLOAT,
                       dimension=TexDimension.TEXTURE2D)
    return Texture(meta, [torch.cat([rgb, torch.ones_like(rgb[..., :1])],
                                    -1)[None]])


def load_from_hdr_memory(data: bytes, device=None) -> Texture:
    """LoadFromHDRMemory (DirectXTexHDR.cpp:697), on `device` (CUDA
    unless named)."""
    rgbe, plan = _host_parse(data)
    return _device_decode(torch.from_numpy(rgbe).to(resolve(device)), plan)


def _float_to_rgbe(img: torch.Tensor) -> torch.Tensor:
    """[H, W, >=3] f32 -> [H, W, 4] u8 RGBE (DirectXTexHDR.cpp:368-405),
    on img's device in f64: the JAX package's numpy arithmetic."""
    rgb = torch.nan_to_num(img[..., :3].to(torch.float64)).clamp_min(0.0)
    max_xyz = rgb.amax(dim=-1)
    mant, exp = torch.frexp(max_xyz)
    big = max_xyz > 1e-32
    scale = torch.where(big, mant * 256.0 / torch.where(
        big, max_xyz, torch.ones_like(max_xyz)), torch.zeros_like(max_xyz))
    codes = (rgb * scale[..., None]).to(torch.uint8)
    e = ((exp.to(torch.int64) + 128) & 0xFF).to(torch.uint8)
    nonzero = (codes != 0).any(dim=-1) & big
    zero = torch.zeros_like(e)
    return torch.cat([torch.where(nonzero[..., None], codes, zero[..., None]),
                      torch.where(nonzero, e, zero)[..., None]], -1)


def _encode_rle_channel_py(ch: np.ndarray) -> bytes:
    """Numpy twin of the native new-style per-channel RLE (runs >= 4
    become repeat packets): the JAX package's Python encoder, for
    tests."""
    n = len(ch)
    out = bytearray()
    # find run boundaries
    i = 0
    while i < n:
        # measure run of identical bytes
        run = 1
        while i + run < n and run < 127 and ch[i + run] == ch[i]:
            run += 1
        if run >= 4:
            out.append(0x80 | run)
            out.append(int(ch[i]))
            i += run
        else:
            # literal: collect until next run of >=4 or 128 bytes
            start = i
            i += run
            while i < n and (i - start) < 128:
                run = 1
                while i + run < n and run < 127 and ch[i + run] == ch[i]:
                    run += 1
                if run >= 4:
                    break
                i += run
            count = min(i - start, 128)
            i = start + count
            out.append(count)
            out.extend(ch[start:start + count].tobytes())
    return bytes(out)


def save_to_hdr_memory(tex: Texture, mip: int = 0, item: int = 0) -> bytes:
    """SaveToHDRMemory (DirectXTexHDR.cpp): new-style RLE writer."""
    rgbe = _float_to_rgbe(tex.image(mip, item)).cpu().numpy()
    h, w = rgbe.shape[:2]

    header = (b"#?RADIANCE\n"
              b"FORMAT=32-bit_rle_rgbe\n"
              b"\n" + f"-Y {h} +X {w}\n".encode())
    if not 8 <= w <= 32767:
        return header + rgbe.tobytes()
    body = []
    planes = np.ascontiguousarray(rgbe.transpose(0, 2, 1))   # [H, 4, W]
    for y in range(h):
        body.append(bytes([2, 2, (w >> 8) & 0x7F, w & 0xFF]))
        for ch in range(4):
            body.append(native.hdr_encode_rle_channel(planes[y, ch]))
    return header + b"".join(body)


def load_from_hdr_file(path, device=None) -> Texture:
    with open(path, "rb") as f:
        return load_from_hdr_memory(f.read(), device)


def save_to_hdr_file(tex: Texture, path) -> None:
    with open(path, "wb") as f:
        f.write(save_to_hdr_memory(tex))
