"""Spatial sharding for huge textures: rows over the mesh, halo rows
between neighbours, on torch tensors.

The counterpart of directxtex_tpu/parallel/spatial.py. One image's row
axis is split over the mesh (`rows_sharding`); every pixel op stays on
its shard, and only the filter-tap halo rows cross between neighbouring
shards, each a `.to(device)` copy (the analog of JAX's `ppermute`). A
sharded image is a list of row shards, one per mesh entry, on its
entry's device; the functions below take such a list or a whole tensor,
which they split, and return a list.

Where the JAX package goes wrong the port raises ValueError: a halo
wider than a shard's rows (JAX's `x[-halo:]` then returns fewer rows and
the slab comes out short), and a box mip over odd rows or columns.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import numerics
from .sharding import Mesh, Sharding, _shards

__all__ = ["rows_sharding", "halo_exchange_rows", "sharded_normal_map",
           "sharded_box_mip"]


def rows_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (row) axis of an image over the mesh."""
    return Sharding(mesh, 0)


def halo_exchange_rows(shards, halo: int,
                       wrap: bool = True) -> list[torch.Tensor]:
    """Each [H_loc, ...] row shard as [H_loc + 2 * halo, ...] with its
    neighbours' rows attached, on its own device.

    Shards are ordered top to bottom. The top halo is the previous shard's
    last `halo` rows, the bottom halo the next shard's first rows. With
    wrap=False the image's first and last rows repeat at the global edges
    (clamp, as jnp.pad mode="edge"). A single shard wraps onto itself."""
    shards = list(shards)
    n = len(shards)
    if halo < 0:
        raise ValueError(f"halo {halo} < 0")
    short = [s.shape[0] for s in shards if s.shape[0] < halo]
    if short:
        raise ValueError(
            f"halo {halo} exceeds a shard's {min(short)} rows; the JAX "
            f"package returns a short slab here (ROADMAP queue 3)")
    out = []
    for i, x in enumerate(shards):
        if halo == 0:
            out.append(x)
            continue
        if wrap:
            top = shards[(i - 1) % n][-halo:].to(x.device)
            bot = shards[(i + 1) % n][:halo].to(x.device)
        else:
            top = (x[:1].expand(halo, *x.shape[1:]) if i == 0
                   else shards[i - 1][-halo:].to(x.device))
            bot = (x[-1:].expand(halo, *x.shape[1:]) if i == n - 1
                   else shards[i + 1][:halo].to(x.device))
        out.append(torch.cat([top, x, bot]))
    return out


def _shift_cols(h: torch.Tensor, dx: int, mirror_u: bool) -> torch.Tensor:
    """Column shift with wrap or clamp: the full width is on each shard."""
    if dx == 0:
        return h
    if mirror_u:
        padded = torch.cat([h[:, :1], h, h[:, -1:]], dim=1)
        return padded[:, 1 + dx:padded.shape[1] - 1 + dx]
    return torch.roll(h, -dx, dims=1)


def _normal_map_local(slab: torch.Tensor, step: float, scale: float,
                      mirror_u: bool) -> torch.Tensor:
    """The 3x3 central differences of a [H_loc + 2, W] slab ->
    [H_loc, W, 4], term for term as the JAX package's local function,
    each operation rounded on its own."""
    nb = {}
    for dy in (-1, 0, 1):
        rows = slab[1 + dy:slab.shape[0] - 1 + dy]
        for dx in (-1, 0, 1):
            nb[(dy, dx)] = _shift_cols(rows, dx, mirror_u)
    tot_x = ((nb[(-1, -1)] - nb[(-1, 1)]) + (nb[(0, -1)] - nb[(0, 1)])
             + (nb[(1, -1)] - nb[(1, 1)]))
    tot_y = ((nb[(-1, -1)] - nb[(1, -1)]) + (nb[(-1, 0)] - nb[(1, 0)])
             + (nb[(-1, 1)] - nb[(1, 1)]))
    nx = tot_x * torch.full_like(tot_x, step)
    ny = tot_y * torch.full_like(tot_y, step)
    nz = torch.ones_like(nx)
    length = numerics.sqrt(nx * nx + ny * ny + nz * nz)
    normal = torch.div(torch.stack([nx, ny, nz], dim=-1), length[..., None])
    normal = normal * scale + 0.5
    return torch.cat([normal, torch.ones_like(nx)[..., None]], dim=-1)


def sharded_normal_map(mesh: Mesh, amplitude: float = 1.0,
                       mirror_u: bool = False, mirror_v: bool = False,
                       invert_sign: bool = False):
    """A height field -> normal map function over a rows-sharded image.

    The JAX package's 3x3 central differences with UNORM biasing
    (ComputeNMap, DirectXTexNormalMaps.cpp:175-184); only one halo row
    each way crosses between shards. The returned function takes an
    [H, W] tensor (split over the mesh's rows) or its row shards and
    returns the [H_loc, W, 4] shards. amplitude / 6 is rounded to f32
    once, as JAX's weak-typed scalar is."""
    step = float(np.float32(amplitude / 6.0))
    scale = -0.5 if invert_sign else 0.5

    def fn(height):
        slabs = halo_exchange_rows(_shards(height, mesh), 1,
                                   wrap=not mirror_v)
        return [_normal_map_local(s, step, scale, mirror_u) for s in slabs]
    return fn


def _box_local(img: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> [H/2, W/2, C]: each 2x2 group's sum as XLA orders it
    for a mean over both pair axes, (row 0's pair) + (row 1's pair), times
    f32(1/4)."""
    h, w, c = img.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"box mip of a {h} x {w} shard: rows and columns must be even; "
            f"the JAX package fails to reshape here")
    x = img.reshape(h // 2, 2, w // 2, 2, c)
    s = (x[:, 0, :, 0] + x[:, 0, :, 1]) + (x[:, 1, :, 0] + x[:, 1, :, 1])
    return s * 0.25


def sharded_box_mip(mesh: Mesh):
    """One 2x box halving over a rows-sharded [H, W, C] image.

    Each shard's rows must be even (ValueError otherwise: H a multiple of
    2 * mesh size): every 2-row group is then on one shard and nothing
    crosses between shards. The returned function takes the image or its
    row shards and returns the [H_loc / 2, W / 2, C] shards."""
    def fn(img):
        return [_box_local(s) for s in _shards(img, mesh)]
    return fn
