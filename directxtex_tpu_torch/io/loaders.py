"""Runtime loader / capture fast paths on torch tensors.

The counterpart of directxtex_tpu/io/loaders.py, equivalents of the
reference's standalone modules (SURVEY.md §2.3):
- DDSTextureLoader: runtime DDS -> device resource without pixel conversion
  -> `create_texture_from_dds` uploads BC payloads as-is (decode on the
  device on demand) or RGBA planes directly.
- WICTextureLoader: image file -> 2D texture with resize + autogen mips ->
  `create_texture_from_image`.
- ScreenGrab: GPU resource -> file -> the two savers work on any tensor.

Each loads onto `device` (CUDA unless named).
"""

from __future__ import annotations

import torch

from ..formats.dxgi import FMT
from ..texture import CompressedTexture, Texture

__all__ = ["create_texture_from_dds", "create_texture_from_image",
           "capture_texture", "save_dds_texture_to_file",
           "save_image_texture_to_file"]


def create_texture_from_dds(source, *, decompress_now: bool = False,
                            device=None):
    """CreateDDSTextureFromMemory/File equivalent
    (DDSTextureLoader11.h:65-117): one parse, one upload, no per-pixel
    conversion. BC payloads stay compressed unless decompress_now."""
    from .dds import load_from_dds_file, load_from_dds_memory

    if isinstance(source, (bytes, bytearray, memoryview)):
        tex = load_from_dds_memory(bytes(source), device=device)
    else:
        tex = load_from_dds_file(source, device=device)
    if decompress_now and isinstance(tex, CompressedTexture):
        from ..ops import decompress
        tex = decompress(tex)
    return tex


def create_texture_from_image(source, *, max_size: int = 0,
                              gen_mips: bool = True,
                              device=None) -> Texture:
    """WICTextureLoader equivalent (WICTextureLoader11.h:63-88): load any
    image file, optionally clamp to max_size (power-of-2 fit like the
    reference) and autogen a full mip chain."""
    from . import load_texture
    from ..ops import generate_mipmaps, resize

    tex = load_texture(source, device=device)
    if isinstance(tex, CompressedTexture):
        from ..ops import decompress
        tex = decompress(tex)
    if max_size and max(tex.metadata.width, tex.metadata.height) > max_size:
        ratio = max_size / max(tex.metadata.width, tex.metadata.height)
        w = max(1, int(tex.metadata.width * ratio))
        h = max(1, int(tex.metadata.height * ratio))
        tex = resize(tex, w, h)
    if gen_mips:
        tex = generate_mipmaps(tex)
    return tex


def capture_texture(array, fmt: FMT = FMT.R8G8B8A8_UNORM,
                    device=None) -> Texture:
    """CaptureTexture equivalent (DirectXTexD3D11.cpp:795): wrap an array
    or tensor ([H,W,C] or [N,H,W,C]) as a Texture for saving / analysis.
    A tensor stays on its device unless `device` names another; an array
    goes to `device` (CUDA unless named)."""
    if torch.is_tensor(array) and device is None:
        device = array.device
    return Texture.from_array(array, fmt=fmt, device=device)


def save_dds_texture_to_file(array_or_tex, path, fmt: FMT | None = None):
    """SaveDDSTextureToFile equivalent (ScreenGrab11.h:33)."""
    from .dds import save_to_dds_file

    tex = array_or_tex
    if not isinstance(tex, (Texture, CompressedTexture)):
        tex = capture_texture(tex, fmt or FMT.R8G8B8A8_UNORM)
    save_to_dds_file(tex, path)


def save_image_texture_to_file(array_or_tex, path, fmt: FMT | None = None):
    """SaveWICTextureToFile equivalent (ScreenGrab11.h:36)."""
    from . import save_texture

    tex = array_or_tex
    if not isinstance(tex, (Texture, CompressedTexture)):
        tex = capture_texture(tex, fmt or FMT.R8G8B8A8_UNORM)
    save_texture(tex, path)
