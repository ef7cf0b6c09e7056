"""Texture containers over torch tensors on an explicit device.

The counterpart of directxtex_tpu/texture.py. `TexDimension`,
`TexAlphaMode`, `TexMiscFlag(2)` and `TexMetadata` are the JAX package's,
verbatim; `Texture` and `CompressedTexture` are plain classes (no pytree)
holding one tensor per mip level:

    Texture.levels[mip]            f32 [array_size or depth, H, W, 4]
    CompressedTexture.levels[mip]  u8  [array_size or depth, block bytes]

`metadata.format` is the wire format the texture came from or is saved
as; a Texture's pixels are always f32 RGBA. The constructors put the data
on CUDA unless the caller names a device (the CPU tests name "cpu").
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np
import torch

from .formats.dxgi import FMT, DXGIFormat
from .formats import traits
from .utils.device import resolve

__all__ = ["TexDimension", "TexAlphaMode", "TexMiscFlag", "TexMiscFlag2",
           "TexMetadata", "Texture", "CompressedTexture"]


class TexDimension(enum.IntEnum):
    """Matches D3D11_RESOURCE_DIMENSION subset (DirectXTex.h:180-185)."""
    TEXTURE1D = 2
    TEXTURE2D = 3
    TEXTURE3D = 4


class TexAlphaMode(enum.IntEnum):
    """Matches TEX_ALPHA_MODE (DirectXTex.h:166-173)."""
    UNKNOWN = 0
    STRAIGHT = 1
    PREMULTIPLIED = 2
    OPAQUE = 3
    CUSTOM = 4


class TexMiscFlag(enum.IntFlag):
    TEXTURECUBE = 0x4


class TexMiscFlag2(enum.IntFlag):
    ALPHA_MODE_MASK = 0x7


@dataclasses.dataclass(frozen=True)
class TexMetadata:
    """Mirrors the reference TexMetadata (DirectXTex.h:187-216)."""
    width: int
    height: int = 1
    depth: int = 1
    array_size: int = 1
    mip_levels: int = 1
    misc_flags: int = 0
    misc_flags2: int = 0
    format: DXGIFormat = FMT.R8G8B8A8_UNORM
    dimension: TexDimension = TexDimension.TEXTURE2D

    # -- predicates (DirectXTex.h:199-215) --
    def is_cubemap(self) -> bool:
        return bool(self.misc_flags & TexMiscFlag.TEXTURECUBE)

    def is_pm_alpha(self) -> bool:
        return self.alpha_mode() == TexAlphaMode.PREMULTIPLIED

    def alpha_mode(self) -> TexAlphaMode:
        return TexAlphaMode(self.misc_flags2 & TexMiscFlag2.ALPHA_MODE_MASK)

    def with_alpha_mode(self, mode: TexAlphaMode) -> "TexMetadata":
        flags2 = (self.misc_flags2 & ~int(TexMiscFlag2.ALPHA_MODE_MASK)) | int(mode)
        return dataclasses.replace(self, misc_flags2=flags2)

    def is_volumemap(self) -> bool:
        return self.dimension == TexDimension.TEXTURE3D

    def with_format(self, fmt: DXGIFormat) -> "TexMetadata":
        return dataclasses.replace(self, format=fmt)

    def mip_dims(self, mip: int) -> tuple[int, int, int]:
        """(width, height, depth) of a mip level."""
        w = max(1, self.width >> mip)
        h = max(1, self.height >> mip)
        d = max(1, self.depth >> mip) if self.dimension == TexDimension.TEXTURE3D else self.depth
        return w, h, d

    def compute_index(self, mip: int, item: int, slice_: int = 0) -> int:
        """Linear subresource index (DirectXTexUtil.cpp TexMetadata::ComputeIndex)."""
        if mip >= self.mip_levels:
            raise IndexError("mip out of range")
        if self.dimension in (TexDimension.TEXTURE1D, TexDimension.TEXTURE2D):
            if slice_ > 0 or item >= self.array_size:
                raise IndexError("item/slice out of range")
            return item * self.mip_levels + mip
        # TEXTURE3D
        if item > 0:
            raise IndexError("volume textures have no array items")
        index = 0
        d = self.depth
        for level in range(mip):
            index += d
            if d > 1:
                d >>= 1
        if slice_ >= d:
            raise IndexError("slice out of range")
        return index + slice_


def _metadata_of(meta) -> TexMetadata:
    """A TexMetadata, or the dict `dataclasses.asdict` gives of one (the
    JAX package's too): enum fields are taken by value."""
    if isinstance(meta, TexMetadata):
        return meta
    d = dict(meta)
    d["format"] = DXGIFormat(int(d["format"]))
    d["dimension"] = TexDimension(int(d["dimension"]))
    return TexMetadata(**d)


class Texture:
    """A full texture: mip chain x array items, f32 RGBA on one device.

    Replaces ScratchImage (DirectXTex.h:437-498). `levels[m]` has shape
    [items_or_depth, H_m, W_m, 4]. Cube maps store 6*n items in +X,-X,+Y,-Y,
    +Z,-Z order, matching the DDS layout.
    """

    def __init__(self, metadata: TexMetadata,
                 levels: Sequence[torch.Tensor]):
        self.metadata = metadata
        self.levels = list(levels)

    # -- constructors --
    @classmethod
    def from_array(
        cls,
        data,
        fmt: DXGIFormat = FMT.R8G8B8A8_UNORM,
        *,
        is_cube: bool = False,
        dimension: TexDimension | None = None,
        alpha_mode: TexAlphaMode = TexAlphaMode.UNKNOWN,
        device=None,
    ) -> "Texture":
        """Build a single-mip texture from an array or tensor.

        Accepts [H,W,C], [N,H,W,C], or [D,H,W,C] with `dimension=TEXTURE3D`;
        C in {1,2,3,4}. Data is converted to float32 RGBA (missing G/B -> 0,
        missing A -> 1) on `device` (CUDA unless named).
        """
        if torch.is_tensor(data):
            arr = data.to(resolve(device))
        else:   # a copy: the texture never shares the caller's memory
            arr = torch.from_numpy(np.array(data)).to(resolve(device))
        if arr.dim() == 3:
            arr = arr[None]
        if arr.dim() != 4:
            raise ValueError(f"expected rank 3 or 4 array, got shape "
                             f"{tuple(arr.shape)}")
        n, h, w, c = arr.shape
        if c > 4:
            raise ValueError(f"expected <=4 channels, got {c}")
        arr = arr.to(torch.float32)
        if c < 4:
            parts = [arr]
            if c < 3:
                parts.append(arr.new_zeros((n, h, w, 3 - c)))
            parts.append(arr.new_ones((n, h, w, 1)))
            arr = torch.cat(parts, dim=-1)
        dim = dimension or TexDimension.TEXTURE2D
        misc = int(TexMiscFlag.TEXTURECUBE) if is_cube else 0
        meta = TexMetadata(
            width=w, height=h,
            depth=n if dim == TexDimension.TEXTURE3D else 1,
            array_size=1 if dim == TexDimension.TEXTURE3D else n,
            mip_levels=1, misc_flags=misc,
            misc_flags2=int(alpha_mode),
            format=fmt, dimension=dim,
        )
        return cls(meta, [arr.contiguous()])

    @classmethod
    def from_levels(cls, metadata, levels, device=None) -> "Texture":
        """A texture from its metadata (a TexMetadata or its
        `dataclasses.asdict`) and one f32 [items, H, W, 4] array per mip,
        put on `device` (CUDA unless named)."""
        dev = resolve(device)
        return cls(_metadata_of(metadata), [
            torch.from_numpy(np.array(lvl, np.float32)).to(dev)
            for lvl in levels])

    # -- accessors --
    @property
    def width(self) -> int:
        return self.metadata.width

    @property
    def height(self) -> int:
        return self.metadata.height

    @property
    def format(self) -> DXGIFormat:
        return self.metadata.format

    @property
    def mip_levels(self) -> int:
        return len(self.levels)

    @property
    def array_size(self) -> int:
        return self.metadata.array_size

    @property
    def device(self) -> torch.device:
        return self.levels[0].device

    def image(self, mip: int = 0, item: int = 0) -> torch.Tensor:
        """One [H, W, 4] image, analogous to ScratchImage::GetImage."""
        return self.levels[mip][item]

    def to_numpy(self, mip: int = 0, item: int = 0) -> np.ndarray:
        return self.image(mip, item).cpu().numpy()

    def replace_levels(self, levels: Sequence[torch.Tensor],
                       metadata: TexMetadata | None = None) -> "Texture":
        meta = metadata if metadata is not None else dataclasses.replace(
            self.metadata, mip_levels=len(levels))
        return Texture(meta, levels)

    def is_alpha_all_opaque(self) -> bool:
        """ScratchImage::IsAlphaAllOpaque (DirectXTexImage.cpp): one bool
        read from the device for the whole chain."""
        if not traits.has_alpha(self.metadata.format):
            return False
        return not bool(torch.stack([(lvl[..., 3] < 1.0).any()
                                     for lvl in self.levels]).any())

    def __repr__(self) -> str:
        m = self.metadata
        return (f"Texture({m.format.name}, {m.width}x{m.height}"
                f"{f'x{m.depth}' if m.dimension == TexDimension.TEXTURE3D else ''}, "
                f"items={m.array_size}, mips={self.mip_levels}"
                f"{', cube' if m.is_cubemap() else ''}, {self.device})")


class CompressedTexture:
    """A block-compressed (BC1-BC7) texture held as raw block bytes.

    The reference keeps compressed subresources as byte buffers inside
    ScratchImage and converts only via explicit Compress/Decompress
    (DirectXTexCompress.cpp:632,852). Here `levels[m]` is a uint8 tensor of
    shape [items_or_depth, n_blocks_y * n_blocks_x * bytes_per_block].
    """

    def __init__(self, metadata: TexMetadata,
                 levels: Sequence[torch.Tensor]):
        self.metadata = metadata
        self.levels = list(levels)

    @property
    def format(self) -> DXGIFormat:
        return self.metadata.format

    @property
    def mip_levels(self) -> int:
        return len(self.levels)

    @property
    def array_size(self) -> int:
        return self.metadata.array_size

    @property
    def device(self) -> torch.device:
        return self.levels[0].device

    def level_bytes(self, mip: int, item: int = 0) -> np.ndarray:
        return self.levels[mip][item].cpu().numpy()

    def __repr__(self) -> str:
        m = self.metadata
        return (f"CompressedTexture({m.format.name}, {m.width}x{m.height}, "
                f"items={m.array_size}, mips={self.mip_levels}, "
                f"{self.device})")
