"""Container I/O on torch tensors: DDS, TGA, HDR, PPM / PFM / PHM, EXR,
the PNG / JPEG / BMP / TIFF / GIF bridge (Pillow) and HEIF (libheif), and
the runtime loaders. Its `__all__` is the JAX package's io's.

Every loader takes `device=None`, meaning CUDA unless the caller names a
device. Headers and byte streams are parsed on the host (numpy and the
port's native C++); each file's pixels go to the device in one copy and
are decoded there. A save makes one copy back to the host.
"""

import os

from .dds import (
    DDS_FLAGS, DDSMetaData, encode_dds_header, get_metadata_from_dds_memory,
    load_from_dds_file, load_from_dds_memory, save_to_dds_file,
    save_to_dds_memory,
)
from .loaders import (
    capture_texture, create_texture_from_dds, create_texture_from_image,
    save_dds_texture_to_file, save_image_texture_to_file,
)
from .hdr import (
    get_metadata_from_hdr_memory, load_from_hdr_file, load_from_hdr_memory,
    save_to_hdr_file, save_to_hdr_memory,
)
from .tga import (
    TGA_FLAGS, get_metadata_from_tga_memory, load_from_tga_file,
    load_from_tga_memory, save_to_tga_file, save_to_tga_memory,
)
from .ppm import (
    load_from_pfm_file, load_from_pfm_memory, load_from_phm_file,
    load_from_phm_memory, load_from_ppm_file, load_from_ppm_memory,
    save_to_pfm_file, save_to_pfm_memory, save_to_phm_file,
    save_to_phm_memory, save_to_ppm_file, save_to_ppm_memory,
)
from .exr import (
    get_metadata_from_exr_memory, load_from_exr_file, load_from_exr_memory,
    save_to_exr_file, save_to_exr_memory,
)
from .wic import (
    WIC_CODEC, WIC_FLAGS, load_from_wic_file, load_from_wic_memory,
    save_to_wic_file, save_to_wic_memory,
)

__all__ = [
    "DDS_FLAGS", "DDSMetaData", "TGA_FLAGS", "WIC_CODEC", "WIC_FLAGS",
    "encode_dds_header",
    "get_metadata_from_dds_memory", "get_metadata_from_hdr_memory",
    "get_metadata_from_tga_memory",
    "load_from_dds_file", "load_from_dds_memory",
    "load_from_exr_file", "load_from_exr_memory",
    "get_metadata_from_exr_memory",
    "load_from_hdr_file", "load_from_hdr_memory",
    "load_from_tga_file", "load_from_tga_memory",
    "load_from_wic_file", "load_from_wic_memory",
    "save_to_dds_file", "save_to_dds_memory",
    "save_to_exr_file", "save_to_exr_memory",
    "save_to_hdr_file", "save_to_hdr_memory",
    "save_to_tga_file", "save_to_tga_memory",
    "save_to_wic_file", "save_to_wic_memory",
]


def load_texture(path, device=None, **kwargs):
    """Extension-dispatched loader (texconv-style), on `device` (CUDA
    unless named)."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".dds":
        return load_from_dds_file(path, device=device, **kwargs)
    if ext == ".tga":
        return load_from_tga_file(path, device=device, **kwargs)
    if ext == ".hdr":
        return load_from_hdr_file(path, device)
    if ext == ".exr":
        return load_from_exr_file(path, device)
    if ext in (".ppm", ".pnm"):
        return load_from_ppm_file(path, device)
    if ext == ".pfm":
        return load_from_pfm_file(path, device)
    if ext == ".phm":
        return load_from_phm_file(path, device)
    return load_from_wic_file(path, device=device, **kwargs)


def save_texture(tex, path, **kwargs):
    """Extension-dispatched saver."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".dds":
        return save_to_dds_file(tex, path, **kwargs)
    if ext == ".tga":
        return save_to_tga_file(tex, path, **kwargs)
    if ext == ".hdr":
        return save_to_hdr_file(tex, path)
    if ext == ".exr":
        return save_to_exr_file(tex, path)
    if ext in (".ppm", ".pnm"):
        return save_to_ppm_file(tex, path)
    if ext == ".pfm":
        return save_to_pfm_file(tex, path)
    if ext == ".phm":
        return save_to_phm_file(tex, path)
    return save_to_wic_file(tex, path, **kwargs)
