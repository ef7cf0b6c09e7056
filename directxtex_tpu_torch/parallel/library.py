"""Texture-library scale-out: whole asset libraries over the mesh, on
torch tensors.

The counterpart of directxtex_tpu/parallel/library.py. Many same-sized
textures are loaded in a thread pool (host parsing, one H2D copy a file,
decode and resize on the device) into one [N, H, W, 4] batch, N is split
over the mesh, and each shard's images, with their box mip chains where
asked, go through ONE encoder call over all their blocks (the one-dispatch
structure of the JAX package's jitted function); the packed blocks are
then cut back per image and level.

The JAX package's mip chain fails to reshape a level with an odd side
above 1 (a 12 x 12 image); the port raises ValueError there.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from ..formats.dxgi import DXGIFormat
from ..ops.mipmaps import _halve
from ..utils.device import resolve
from .sharding import Mesh, _shards

__all__ = ["compress_library_fn", "load_library", "compress_library"]


def _box_chain(batch: torch.Tensor) -> list[torch.Tensor]:
    """[n, H, W, 4] -> its full box mip chain, rows halved before columns,
    as the JAX function's loop; each halving (a + b) / 2, XLA's 2-term
    mean."""
    h, w = batch.shape[1:3]
    levels, lvl = [], batch
    for _ in range(max(h, w).bit_length()):
        levels.append(lvl)
        lh, lw = lvl.shape[1:3]
        if (lh > 1 and lh % 2) or (lw > 1 and lw % 2):
            raise ValueError(
                f"compress_library_fn(mips=True): a {lh} x {lw} level has "
                f"an odd side above 1; the JAX package fails to reshape "
                f"here (ROADMAP queue 3)")
        if lh > 1:
            lvl = _halve(lvl, 1)
        if lw > 1:
            lvl = _halve(lvl, 2)
    return levels


def compress_library_fn(fmt: DXGIFormat, mesh: Mesh,
                        threshold: float = 0.5, bcflags: int = 0,
                        mips: bool = False):
    """A [N, H, W, 4] -> packed blocks function, N split over `mesh`.

    The returned function takes the batch (split into equal shards) or
    its shards, and returns one entry per level (one without mips): the
    list of each shard's [n_shard, blocks_per_image, bytes] u8 blocks on
    its device. Each shard's images, every level of them with mips=True,
    go through one encoder call on the shard's device."""
    from ..bc.common import image_to_blocks
    from ..ops.compress import _ENCODERS, _encode_blocks

    if fmt not in _ENCODERS:
        raise ValueError(f"not a BC format: {fmt!r}")
    kind = _ENCODERS[fmt]

    def encode_shard(batch: torch.Tensor) -> list[torch.Tensor]:
        n = batch.shape[0]
        levels = _box_chain(batch) if mips else [batch]
        blocks = [[image_to_blocks(lvl[i])[0] for i in range(n)]
                  for lvl in levels]
        per_image = [b[0].shape[0] for b in blocks]
        packed = _encode_blocks(
            kind, torch.cat([b for lvl in blocks for b in lvl]), threshold,
            bcflags)
        out, off = [], 0
        for c in per_image:
            out.append(packed[off:off + n * c].reshape(n, c, -1))
            off += n * c
        return out

    def fn(batch):
        per_shard = [encode_shard(s) for s in _shards(batch, mesh)]
        return tuple(list(lv) for lv in zip(*per_shard))
    return fn


def load_library(paths: Sequence[str], width: int, height: int,
                 workers: int = 8, device=None) -> torch.Tensor:
    """Many image files as one [N, height, width, 4] f32 batch on `device`
    (CUDA unless named).

    Files load in a thread pool (the native parsers release the GIL);
    each goes to the device once, is decompressed there if it is BC, and
    is resized there only if its size differs from (width, height)."""
    from ..io import load_texture
    from ..ops import decompress
    from ..ops.resize import resize_array
    from ..texture import CompressedTexture

    dev = resolve(device)

    def load_one(p):
        t = load_texture(p, device=dev)
        if isinstance(t, CompressedTexture):
            t = decompress(t)
        img = t.levels[0][0]
        if tuple(img.shape[:2]) != (height, width):
            img = resize_array(img, width, height)
        return img

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return torch.stack(list(pool.map(load_one, paths)))


def compress_library(paths: Sequence[str], fmt: DXGIFormat, mesh: Mesh,
                     width: int, height: int, *, threshold: float = 0.5,
                     bcflags: int = 0,
                     mips: bool = False) -> list[np.ndarray]:
    """End to end: files -> a batch split over the mesh -> one encoder call
    a shard.

    Returns one numpy array per level, [N, blocks_per_image, bytes] (one
    entry when mips=False). N is split as evenly as it goes
    (torch.tensor_split), where the JAX function pads it to a multiple of
    the mesh size; the words are the same."""
    batch = load_library(paths, width, height, device=mesh.devices[0])
    parts = [(c, d) for c, d in zip(batch.tensor_split(mesh.size),
                                    mesh.devices) if c.shape[0]]
    fn = compress_library_fn(fmt, Mesh(tuple(d for _, d in parts),
                                       mesh.axis), threshold, bcflags, mips)
    levels = fn([c.to(d) for c, d in parts])
    return [torch.cat([s.to(mesh.devices[0]) for s in lvl]).cpu().numpy()
            for lvl in levels]
