"""Portable PixMap / FloatMap / HalfMap codecs on torch tensors.

The counterpart of directxtex_tpu/io/ppm.py (Texconv/PortablePixMap.cpp):
PPM P3 (ascii) and P6 (binary), 8/16-bit maxval -> R8G8B8A8 /
R16G16B16A16; PFM 'PF' (color) / 'Pf' (gray) float maps and PHM 'PH' /
'Ph' half maps, the sign of the scale giving the byte order, rows bottom-
up -> R32G32B32A32_FLOAT / R32_FLOAT and R16G16B16A16_FLOAT / R16_FLOAT.

The header is read on the host; the sample bytes go to the device in one
copy and are assembled, flipped and scaled there. A save builds its
samples on the texture's device and makes one D2H copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import numerics
from ..formats import packing
from ..formats.dxgi import FMT
from ..formats.packing import _bits_f32, _f32_to_half, _half_to_f32
from ..texture import TexDimension, TexMetadata, Texture
from ..utils.device import resolve
from .wic import to_rgba8

__all__ = ["load_from_ppm_memory", "save_to_ppm_memory",
           "load_from_pfm_memory", "save_to_pfm_memory",
           "load_from_phm_memory", "save_to_phm_memory",
           "load_from_ppm_file", "save_to_ppm_file",
           "load_from_pfm_file", "save_to_pfm_file",
           "load_from_phm_file", "save_to_phm_file"]


def _read_tokens(data: bytes, count: int, pos: int):
    """Read whitespace/comment-delimited tokens (PPM header grammar)."""
    toks = []
    n = len(data)
    while len(toks) < count:
        while pos < n and data[pos:pos + 1].isspace():
            pos += 1
        if pos < n and data[pos:pos + 1] == b"#":
            eol = data.find(b"\n", pos)
            pos = n if eol < 0 else eol + 1
            continue
        start = pos
        while pos < n and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("PPM: truncated header")
        toks.append(data[start:pos])
    return toks, pos


@dataclasses.dataclass
class _Plan:
    """The device stage's recipe: the sample layout of the payload and the
    texture's metadata."""
    kind: str            # "u8", "u16be", "i32" (ascii), "f32", "f16"
    little: bool         # byte order of f32 / f16 samples
    nchan: int
    bottom_up: bool
    scale: float         # PPM: maxval (divisor); PFM / PHM: multiplier
    metadata: TexMetadata


def _words(b: torch.Tensor, nbytes: int, little: bool) -> torch.Tensor:
    """flat u8 -> int64 words of `nbytes` bytes in the given order."""
    if not little:
        b = b.reshape(-1, nbytes).flip(-1)
    return packing._words(b.reshape(-1), nbytes)


def _device_decode(payload: torch.Tensor, plan: _Plan) -> Texture:
    meta = plan.metadata
    h, w, c = meta.height, meta.width, plan.nchan
    if plan.kind == "i32":
        vals = payload.view(torch.int32).to(torch.float32)
    elif plan.kind == "u8":
        vals = payload.to(torch.float32)
    elif plan.kind == "u16be":
        vals = _words(payload, 2, False).to(torch.float32)
    elif plan.kind == "f32":
        vals = _bits_f32(_words(payload, 4, plan.little))
    else:
        vals = _half_to_f32(_words(payload, 2, plan.little))
    arr = vals.reshape(h, w, c)
    if plan.kind in ("i32", "u8", "u16be"):
        arr = numerics.fdiv(arr, plan.scale)
    else:
        if plan.bottom_up:
            arr = arr.flip(0)
        if abs(plan.scale) not in (0.0, 1.0):
            arr = arr * float(np.float32(abs(plan.scale)))
    parts = [arr]
    if c == 1:
        parts.append(arr.new_zeros((h, w, 2)))
    parts.append(arr.new_ones((h, w, 1)))
    return Texture(meta, [torch.cat(parts, -1)[None]])


def _load(parse, data: bytes, device) -> Texture:
    payload, plan = parse(bytes(data))
    return _device_decode(torch.from_numpy(payload).to(resolve(device)),
                          plan)


def _host_parse_ppm(data: bytes):
    if data[:2] not in (b"P3", b"P6"):
        raise ValueError("PPM: bad magic (want P3 or P6)")
    ascii_mode = data[:2] == b"P3"
    toks, pos = _read_tokens(data, 3, 2)
    w, h, maxval = (int(t) for t in toks)
    if w <= 0 or h <= 0 or not (0 < maxval < 65536):
        raise ValueError("PPM: invalid dimensions or maxval")
    npix = w * h
    if ascii_mode:
        vals, _ = _read_tokens(data, npix * 3, pos)
        payload, kind = np.array([int(v) for v in vals], np.int32), "i32"
        payload = payload.view(np.uint8)
    else:
        pos += 1  # single whitespace after maxval
        nbytes = npix * 3 * (1 if maxval < 256 else 2)
        if len(data) - pos < nbytes:
            raise ValueError("PPM: pixel data truncated")
        payload = np.frombuffer(data, np.uint8, nbytes, pos).copy()
        kind = "u8" if maxval < 256 else "u16be"
    fmt = FMT.R8G8B8A8_UNORM if maxval < 256 else FMT.R16G16B16A16_UNORM
    return payload, _Plan(kind, True, 3, False, float(maxval),
                          TexMetadata(width=w, height=h, format=fmt))


def _host_parse_float_map(data: bytes, magic: tuple, kind: str, what: str):
    """PFM / PHM: (payload, plan). magic: (color, gray) two-byte tags."""
    if data[:2] not in magic:
        raise ValueError(f"{what}: bad magic (want {magic[0].decode()} or "
                         f"{magic[1].decode()})")
    color = data[:2] == magic[0]
    toks, pos = _read_tokens(data, 3, 2)
    w, h = int(toks[0]), int(toks[1])
    scale = float(toks[2])
    pos += 1
    nchan = 3 if color else 1
    nbytes = w * h * nchan * (4 if kind == "f32" else 2)
    if len(data) - pos < nbytes:
        raise ValueError(f"{what}: pixel data truncated")
    payload = np.frombuffer(data, np.uint8, nbytes, pos).copy()
    if kind == "f32":
        fmt = FMT.R32G32B32A32_FLOAT if color else FMT.R32_FLOAT
    else:
        fmt = FMT.R16G16B16A16_FLOAT if color else FMT.R16_FLOAT
    return payload, _Plan(kind, scale < 0, nchan, True, scale,
                          TexMetadata(width=w, height=h, format=fmt))


def _host_parse_pfm(data: bytes):
    return _host_parse_float_map(data, (b"PF", b"Pf"), "f32", "PFM")


def _host_parse_phm(data: bytes):
    """PHM (Portable Half Map): binary half floats (LoadFromPortablePixMapHDR
    half16 path, Texconv/PortablePixMap.cpp:447-481)."""
    return _host_parse_float_map(data, (b"PH", b"Ph"), "f16", "PHM")


def load_from_ppm_memory(data: bytes, device=None) -> Texture:
    return _load(_host_parse_ppm, data, device)


def load_from_pfm_memory(data: bytes, device=None) -> Texture:
    return _load(_host_parse_pfm, data, device)


def load_from_phm_memory(data: bytes, device=None) -> Texture:
    return _load(_host_parse_phm, data, device)


def save_to_ppm_memory(tex: Texture, mip: int = 0, item: int = 0) -> bytes:
    img = tex.image(mip, item)
    h, w = img.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + to_rgba8(img[..., :3]).tobytes()


def save_to_pfm_memory(tex: Texture, mip: int = 0, item: int = 0) -> bytes:
    img = tex.image(mip, item)
    h, w = img.shape[:2]
    body = img.flip(0)[..., :3].contiguous().cpu().numpy().astype("<f4")
    return b"PF\n%d %d\n-1.0\n" % (w, h) + body.tobytes()


def save_to_phm_memory(tex: Texture, mip: int = 0, item: int = 0) -> bytes:
    img = tex.image(mip, item)
    h, w = img.shape[:2]
    halves = _f32_to_half(img.flip(0)[..., :3]).to(torch.int32)
    body = halves.cpu().numpy().astype("<u2")
    return b"PH\n%d %d\n-1.0\n" % (w, h) + body.tobytes()


def load_from_ppm_file(path, device=None) -> Texture:
    with open(path, "rb") as f:
        return load_from_ppm_memory(f.read(), device)


def save_to_ppm_file(tex: Texture, path) -> None:
    with open(path, "wb") as f:
        f.write(save_to_ppm_memory(tex))


def load_from_pfm_file(path, device=None) -> Texture:
    with open(path, "rb") as f:
        return load_from_pfm_memory(f.read(), device)


def save_to_pfm_file(tex: Texture, path) -> None:
    with open(path, "wb") as f:
        f.write(save_to_pfm_memory(tex))


def load_from_phm_file(path, device=None) -> Texture:
    with open(path, "rb") as f:
        return load_from_phm_memory(f.read(), device)


def save_to_phm_file(tex: Texture, path) -> None:
    with open(path, "wb") as f:
        f.write(save_to_phm_memory(tex))
