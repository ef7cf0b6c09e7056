"""directxtex_tpu_torch — the PyTorch / CUDA port of directxtex_tpu.

The JAX package beside it is the reference; this package holds the same
functions on torch tensors, with the TPU's Pallas kernels rewritten as
hand-written CUDA kernels for Hopper (sm_90a). It has the BC7 default
tier on images with or without alpha, at any alpha weight (search,
MOMENT winner-refine, decode), the BC7 QUICK and MAXQUALITY tiers
(the maxq search, MOMENT then the exact LADDER_FULL refine), BC7
USE_3SUBSETS (modes 0 and 2) in either of those tiers, the BC6H
codec (decode, the shared-fit search, the mid and maxq refine tiers),
BC1-BC5 (bc.bc123, bc.bc45, as plain torch ops), sRGB conversion
(ops.colorspace) and the five BASELINE pipelines (models.pipelines:
bc_encode_pipeline, mipped_compress_pipeline for config 1,
hdr_cubemap_pipeline for config 4, asset_pipeline for config 5; config
2 is composed from the codecs, as benchmarks/run_all.py does).

Above the codecs it has the format core and the compress driver: the
DXGI format space and its traits (formats), the wire-format pack / unpack
of every packable format (formats.packing), format conversion with the
ordered dither (ops.convert), `Texture` / `CompressedTexture` over torch
tensors on an explicit device (texture), compress / decompress
(ops.compress) and DDS read / write (io.dds). A texture in a DDS file goes
through load_from_dds_memory -> compress -> save_to_dds_memory on the
card, with the BC kernels below.

Between load and compress it has texconv's image ops, as torch ops on the
texture's device: flip / rotate (ops.fliprotate), resize (ops.resize: two
products with host-built filter matrices), 2D and 3D mipmaps and alpha
coverage (ops.mipmaps), premultiplied alpha (ops.pmalpha), the normal map
(ops.normalmaps), color rotation and PQ (ops.rotatecolor), MSE / PSNR
(ops.misc), and the Floyd-Steinberg diffusion dither, which runs on the
host in the package's own C++ (native, built with g++ at first use).

Around them it has the container loaders (io: TGA, HDR, PPM / PFM / PHM,
EXR, the Pillow and libheif bridges, the runtime loaders; headers and
byte streams parsed on the host, the byte-serial codecs in native's C++,
each file's pixels copied to the device once and decoded there), the
texconv tool (tools.texconv) and the timing helpers (utils.timing). It
imports torch and numpy only, never jax.
"""

from .formats import DXGIFormat, FMT
from .texture import (CompressedTexture, TexAlphaMode, TexDimension,
                      TexMetadata, Texture)

__version__ = "0.1.0"
