"""Compress / Decompress ops (DirectXTexCompress.cpp) on torch tensors.

The counterpart of directxtex_tpu/ops/compress.py: every (texture, level,
item) becomes blocks (`image_to_blocks`, edge-replicated), all of them
concatenate into one encoder call, and the packed words are cut back into
per-level block bytes. The encoders are the port's bc123, bc45, bc67 and
bc6h, on the texture's device: on CUDA, BC7 runs K2 and K3 (and mode 7's
launch where a block has alpha), BC6H K5, and decompress K1 / K4.

The JAX package pads the batch up to a coarse grid of block counts so
that XLA reuses its traces (`_bucket_size`); every encoder here works
block by block and has no trace cache, so the port encodes the real
blocks only (tests/test_torch_compress_dds.py holds the words equal).
"""

from __future__ import annotations

import dataclasses

import torch

from ..bc import bc45, bc6h, bc67, bc123
from ..bc.common import blocks_to_image, image_to_blocks
from ..formats.dxgi import FMT, DXGIFormat
from ..formats import traits
from ..texture import CompressedTexture, Texture
from ..utils.errors import TexAbortError
from .convert import convert_values
from .flags import TEX_COMPRESS_FLAGS as TC
from .flags import TEX_FILTER_FLAGS as TF

__all__ = ["compress", "compress_ex", "compress_many", "decompress",
           "default_decompress_format"]


def _bc_flags(compress_flags: TC) -> int:
    """GetBCFlags (DirectXTexCompress.cpp:26): pass-through of the dither/
    uniform/BC7 mode bits (values are kept identical across enums)."""
    mask = (TC.RGB_DITHER | TC.A_DITHER | TC.DITHER | TC.UNIFORM
            | TC.BC7_USE_3SUBSETS | TC.BC7_QUICK | TC.BC7_MAXQUALITY
            | TC.BC6H_MID)
    return int(compress_flags & mask)


def _srgb_flags(compress_flags: TC) -> TF:
    """GetSRGBFlags (DirectXTexCompress.cpp:36)."""
    return TF(int(compress_flags & (TC.SRGB_IN | TC.SRGB_OUT)))


# channel-copy cflags from DetermineEncoderSettings
# (DirectXTexCompress.cpp:56-59): BC4 keeps RED (not grayscale), BC5
# keeps RED+GREEN, on the RGB->R / RGB->RG convert rules
_CHANNEL_CFLAGS = {
    "bc4u": TF.RGB_COPY_RED, "bc4s": TF.RGB_COPY_RED,
    "bc5u": TF.RGB_COPY_RED | TF.RGB_COPY_GREEN,
    "bc5s": TF.RGB_COPY_RED | TF.RGB_COPY_GREEN,
}


# target format -> encoder kind (the JAX package's table also carries
# bytes per block, for its padding, which the port does not do)
_ENCODERS = {
    FMT.BC1_UNORM: "bc1", FMT.BC1_UNORM_SRGB: "bc1",
    FMT.BC2_UNORM: "bc2", FMT.BC2_UNORM_SRGB: "bc2",
    FMT.BC3_UNORM: "bc3", FMT.BC3_UNORM_SRGB: "bc3",
    FMT.BC4_UNORM: "bc4u", FMT.BC4_SNORM: "bc4s",
    FMT.BC5_UNORM: "bc5u", FMT.BC5_SNORM: "bc5s",
    FMT.BC6H_UF16: "bc6hu", FMT.BC6H_SF16: "bc6hs",
    FMT.BC7_UNORM: "bc7", FMT.BC7_UNORM_SRGB: "bc7",
}


def _encode_blocks(kind: str, blocks: torch.Tensor, threshold: float,
                   bcflags: int, opaque: bool = False,
                   alpha_weight: float = 1.0) -> torch.Tensor:
    if kind == "bc1":
        return bc123.encode_bc1(blocks, threshold, bcflags)
    if kind == "bc2":
        return bc123.encode_bc2(blocks, bcflags)
    if kind == "bc3":
        return bc123.encode_bc3(blocks, bcflags)
    if kind == "bc4u":
        return bc45.encode_bc4u(blocks)
    if kind == "bc4s":
        return bc45.encode_bc4s(blocks)
    if kind == "bc5u":
        return bc45.encode_bc5u(blocks)
    if kind == "bc5s":
        return bc45.encode_bc5s(blocks)
    if kind == "bc6hu":
        return bc6h.encode_bc6h(blocks, signed=False, flags=bcflags)
    if kind == "bc6hs":
        return bc6h.encode_bc6h(blocks, signed=True, flags=bcflags)
    if kind == "bc7":
        return bc67.encode_bc7(blocks, bcflags, opaque=opaque,
                               alpha_weight=alpha_weight)
    raise AssertionError(kind)


_DECODERS = {
    FMT.BC1_UNORM: "bc1", FMT.BC1_UNORM_SRGB: "bc1", FMT.BC1_TYPELESS: "bc1",
    FMT.BC2_UNORM: "bc2", FMT.BC2_UNORM_SRGB: "bc2", FMT.BC2_TYPELESS: "bc2",
    FMT.BC3_UNORM: "bc3", FMT.BC3_UNORM_SRGB: "bc3", FMT.BC3_TYPELESS: "bc3",
    FMT.BC4_UNORM: "bc4u", FMT.BC4_SNORM: "bc4s", FMT.BC4_TYPELESS: "bc4u",
    FMT.BC5_UNORM: "bc5u", FMT.BC5_SNORM: "bc5s", FMT.BC5_TYPELESS: "bc5u",
    FMT.BC6H_UF16: "bc6hu", FMT.BC6H_SF16: "bc6hs", FMT.BC6H_TYPELESS: "bc6hu",
    FMT.BC7_UNORM: "bc7", FMT.BC7_UNORM_SRGB: "bc7", FMT.BC7_TYPELESS: "bc7",
}


def _decode_blocks(kind: str, raw: torch.Tensor) -> torch.Tensor:
    if kind == "bc1":
        return bc123.decode_bc1(raw)
    if kind == "bc2":
        return bc123.decode_bc2(raw)
    if kind == "bc3":
        return bc123.decode_bc3(raw)
    if kind == "bc4u":
        return bc45.decode_bc4u(raw)
    if kind == "bc4s":
        return bc45.decode_bc4s(raw)
    if kind == "bc5u":
        return bc45.decode_bc5u(raw)
    if kind == "bc5s":
        return bc45.decode_bc5s(raw)
    if kind == "bc6hu":
        return bc6h.decode_bc6h(raw, signed=False)
    if kind == "bc6hs":
        return bc6h.decode_bc6h(raw, signed=True)
    if kind == "bc7":
        return bc67.decode_bc7(raw)
    raise AssertionError(kind)


def default_decompress_format(bcfmt: DXGIFormat) -> DXGIFormat:
    """DefaultDecompress target map (DirectXTexCompress.cpp:377-421)."""
    m = {
        FMT.BC1_TYPELESS: FMT.R8G8B8A8_UNORM, FMT.BC1_UNORM: FMT.R8G8B8A8_UNORM,
        FMT.BC1_UNORM_SRGB: FMT.R8G8B8A8_UNORM_SRGB,
        FMT.BC2_TYPELESS: FMT.R8G8B8A8_UNORM, FMT.BC2_UNORM: FMT.R8G8B8A8_UNORM,
        FMT.BC2_UNORM_SRGB: FMT.R8G8B8A8_UNORM_SRGB,
        FMT.BC3_TYPELESS: FMT.R8G8B8A8_UNORM, FMT.BC3_UNORM: FMT.R8G8B8A8_UNORM,
        FMT.BC3_UNORM_SRGB: FMT.R8G8B8A8_UNORM_SRGB,
        FMT.BC4_TYPELESS: FMT.R8_UNORM, FMT.BC4_UNORM: FMT.R8_UNORM,
        FMT.BC4_SNORM: FMT.R8_SNORM,
        FMT.BC5_TYPELESS: FMT.R8G8_UNORM, FMT.BC5_UNORM: FMT.R8G8_UNORM,
        FMT.BC5_SNORM: FMT.R8G8_SNORM,
        FMT.BC6H_TYPELESS: FMT.R16G16B16A16_FLOAT,
        FMT.BC6H_UF16: FMT.R16G16B16A16_FLOAT,
        FMT.BC6H_SF16: FMT.R16G16B16A16_FLOAT,
        FMT.BC7_TYPELESS: FMT.R8G8B8A8_UNORM, FMT.BC7_UNORM: FMT.R8G8B8A8_UNORM,
        FMT.BC7_UNORM_SRGB: FMT.R8G8B8A8_UNORM_SRGB,
    }
    if bcfmt not in m:
        raise ValueError(f"decompress: not a BC format: {bcfmt!r}")
    return m[bcfmt]


def compress(tex: Texture, fmt: DXGIFormat,
             flags: TC = TC.DEFAULT,
             threshold: float = 0.5,
             alpha_weight: float = 1.0) -> CompressedTexture:
    """Public Compress (DirectXTexCompress.cpp:632).

    Encodes every mip/item of `tex` to BC format `fmt` in one encoder call
    on the texture's device. `alpha_weight` scales BC7 alpha error like the
    reference GPU encoder's CompressOptions.alphaWeight (DirectXTex.h:926,
    BC7Encode.hlsl:241).
    """
    return compress_many([tex], fmt, flags, threshold, alpha_weight)[0]


def _bc7_opaque(levels) -> bool:
    """The IsAlphaAllOpaque-style hint that drops BC7's mode 7: alpha is
    at least 1 on every level given (one bool read from the device)."""
    return bool(torch.stack([(lvl[..., 3] >= 1.0).all()
                             for lvl in levels]).all())


def _settings(texs, fmt: DXGIFormat, flags: TC):
    """Validate a compress call over `texs`: (encoder kind, BC flags,
    convert flags, BC7's opaque hint)."""
    flags = TC(flags)
    if fmt not in _ENCODERS:
        raise ValueError(f"compress: target must be a BC format, got {fmt!r}")
    if any(traits.is_compressed(tex.metadata.format) for tex in texs):
        raise ValueError("compress: source is already compressed")
    kind = _ENCODERS[fmt]
    cflags = _srgb_flags(flags) | _CHANNEL_CFLAGS.get(kind, TF(0))
    # for a batch the opaque hint must hold for EVERY texture
    opaque = kind == "bc7" and _bc7_opaque(
        [lvl for tex in texs for lvl in tex.levels])
    return kind, _bc_flags(flags), cflags, opaque


def _level_blocks(tex: Texture, fmt: DXGIFormat, cflags: TF):
    """Level by level, the blocks of each item of `tex`: its values
    converted toward `fmt`, edge-replicated to whole blocks."""
    for lvl in tex.levels:
        vals = convert_values(lvl, tex.metadata.format, fmt, cflags)
        yield [image_to_blocks(vals[i])[0] for i in range(lvl.shape[0])]


def _compressed(tex: Texture, fmt: DXGIFormat, levels) -> CompressedTexture:
    meta = dataclasses.replace(tex.metadata.with_format(fmt),
                               mip_levels=len(levels))
    return CompressedTexture(meta, levels)


def compress_many(texs, fmt: DXGIFormat, flags: TC = TC.DEFAULT,
                  threshold: float = 0.5,
                  alpha_weight: float = 1.0) -> list[CompressedTexture]:
    """Batch Compress across textures: blocks from every (texture, level,
    item) concatenate into ONE encoder call (SURVEY §2.4's batch design,
    "many files -> one batched device call"). Textures need not share
    dimensions, but share one device. Returns one CompressedTexture per
    input, in order."""
    kind, bcflags, cflags, opaque = _settings(texs, fmt, flags)
    all_blocks = []
    tex_counts = []  # per texture: [(n_items, blocks_per_item)]
    for tex in texs:
        tex_counts.append([])
        for items in _level_blocks(tex, fmt, cflags):
            all_blocks.extend(items)
            tex_counts[-1].append((len(items), items[0].shape[0]))
    packed = _encode_blocks(kind, torch.cat(all_blocks), threshold, bcflags,
                            opaque, alpha_weight)

    out = []
    off = 0
    for tex, counts in zip(texs, tex_counts):
        levels = []
        for n, per_item in counts:
            levels.append(packed[off:off + n * per_item].reshape(n, -1))
            off += n * per_item
        out.append(_compressed(tex, fmt, levels))
    return out


def decompress(ctex: CompressedTexture,
               fmt: DXGIFormat = FMT.UNKNOWN) -> Texture:
    """Public Decompress (DirectXTexCompress.cpp:852): one decoder call over
    every (level, item) on the texture's device."""
    bcfmt = ctex.metadata.format
    # promote TYPELESS -> UNORM (DecompressBC :451)
    bcfmt = traits.make_typeless_unorm(bcfmt)
    if bcfmt == FMT.BC6H_TYPELESS:
        bcfmt = FMT.BC6H_UF16
    if bcfmt not in _DECODERS:
        raise ValueError(f"decompress: not a BC format: {bcfmt!r}")
    if fmt == FMT.UNKNOWN:
        fmt = default_decompress_format(bcfmt)
    if traits.is_compressed(fmt) or traits.is_typeless(fmt):
        raise ValueError(f"decompress: invalid target {fmt!r}")
    kind = _DECODERS[bcfmt]
    bpb = traits.bytes_per_block(bcfmt)

    meta = ctex.metadata
    raws = []
    shapes = []
    for mip in range(ctex.mip_levels):
        w, h, _d = meta.mip_dims(mip)
        lvl = torch.as_tensor(ctex.levels[mip])
        raws.append(lvl.reshape(-1, bpb))
        shapes.append((lvl.shape[0], h, w, lvl.shape[1] // bpb))
    texels = _decode_blocks(kind, torch.cat(raws))

    levels = []
    off = 0
    for n, h, w, per_item in shapes:
        outs = []
        for _ in range(n):
            img = blocks_to_image(texels[off:off + per_item], h, w)
            outs.append(convert_values(img, bcfmt, fmt, TF.DEFAULT))
            off += per_item
        levels.append(torch.stack(outs))
    return Texture(meta.with_format(fmt), levels)


def compress_ex(tex: Texture, fmt: DXGIFormat,
                flags: TC = TC.DEFAULT, threshold: float = 0.5,
                status_callback=None,
                alpha_weight: float = 1.0) -> CompressedTexture:
    """CompressEx (DirectXTexCompress.cpp:664, CompressOptions +
    statusCallBack, DirectXTex.h:922-962): like compress(), reporting
    (done, total) between per-item encoder calls. A callback returning
    False aborts with TexAbortError (E_ABORT semantics)."""
    if status_callback is None:
        return compress(tex, fmt, flags, threshold, alpha_weight)

    total = sum(int(lvl.shape[0]) for lvl in tex.levels)
    done = 0
    if status_callback(0, total) is False:
        raise TexAbortError("compress aborted by status callback")

    kind, bcflags, cflags, opaque = _settings([tex], fmt, flags)
    levels = []
    for items in _level_blocks(tex, fmt, cflags):
        outs = []
        for blocks in items:
            outs.append(_encode_blocks(kind, blocks, threshold, bcflags,
                                       opaque, alpha_weight).reshape(-1))
            done += 1
            if status_callback(done, total) is False:
                raise TexAbortError("compress aborted by status callback")
        levels.append(torch.stack(outs))
    return _compressed(tex, fmt, levels)
