"""The device mesh and data parallelism over the batch axis, on torch
tensors.

The counterpart of directxtex_tpu/parallel/sharding.py. JAX's mesh is
single-controller: one process drives every device, and `shard_map` runs
the local function once per shard. The port keeps that shape: a `Mesh` is
a tuple of `torch.device`s held by one process, a sharded tensor is a
list of shards (one per mesh entry, each on its entry's device), and a
sharded function runs its local function shard by shard. A device may
appear more than once, so that a mesh of ("cuda:0",) * 4 runs the
multi-shard code with real shards on one card, as the JAX tests run on
eight virtual CPU devices. Work queued on different devices runs
concurrently: CUDA launches return before their kernels end.

No per-image communication exists; the only cross-shard step is the MSE's
psum analog, which adds the shards' partial sums on the mesh's first
device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

__all__ = ["Mesh", "Sharding", "make_mesh", "batch_sharding", "replicated",
           "shard_batch", "sharded_compress_fn", "sharded_mse", "gather"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices in shard order and the axis' name."""
    devices: tuple[torch.device, ...]
    axis: str = "batch"

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: `dim` split into mesh.size contiguous
    chunks, one per entry, or (dim None) a full copy on every entry."""
    mesh: Mesh
    dim: int | None = 0

    def place(self, t: torch.Tensor) -> list[torch.Tensor]:
        """The shards of `t`, each on its entry's device. A split dimension
        must be a multiple of the mesh size (as jax.device_put requires)."""
        devs = self.mesh.devices
        if self.dim is None:
            return [t.to(d) for d in devs]
        n = t.shape[self.dim]
        if n % len(devs):
            raise ValueError(
                f"dimension {self.dim} of shape {tuple(t.shape)} ({n}) is "
                f"not a multiple of the mesh size {len(devs)}")
        return [c.to(d) for c, d in zip(t.chunk(len(devs), self.dim), devs)]


def make_mesh(devices: Sequence | None = None, axis: str = "batch") -> Mesh:
    """A 1-D mesh over the given devices (names or torch.devices; one may
    repeat), else over every CUDA device. The CPU is used only where the
    caller names it."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("make_mesh: no CUDA device; name the devices "
                             "(e.g. ('cpu',) * 8)")
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: an empty device list")
    return Mesh(devs, axis)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading dimension over the mesh."""
    return Sharding(mesh, 0)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(arr: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """[N, ...] as mesh.size shards of N / mesh.size rows, each on its
    device; ValueError where N is not a multiple of the mesh size."""
    return batch_sharding(mesh).place(arr)


def _shards(x, mesh: Mesh) -> list[torch.Tensor]:
    """A list of shards as given, or a tensor split over the batch axis."""
    if torch.is_tensor(x):
        return shard_batch(x, mesh)
    if len(x) != mesh.size:
        raise ValueError(f"{len(x)} shards for a mesh of {mesh.size}")
    return list(x)


def gather(shards: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The shards concatenated along dim 0 on `device` (the first shard's
    device unless named)."""
    dev = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(dev) for s in shards])


def sharded_compress_fn(encode_block_fn: Callable, mesh: Mesh) -> Callable:
    """An encode function [N, 16, 4] -> [N, B] over the mesh: the returned
    function takes the block shards (or the whole tensor, which it shards)
    and returns one result per shard, each computed on its shard's device.
    Blocks are independent, so no shard reads another."""
    def fn(blocks):
        return [encode_block_fn(s) for s in _shards(blocks, mesh)]
    return fn


def sharded_mse(mesh: Mesh) -> Callable:
    """Batch-sharded MSE: each shard's sum of squared differences and its
    count, the partials added on the mesh's first device (the psum), then
    one division. The returned function takes two tensors or two lists of
    shards and returns an f32 scalar on mesh.devices[0]."""
    def fn(a, b):
        sums, counts = [], []
        for sa, sb in zip(_shards(a, mesh), _shards(b, mesh)):
            d = sa.to(torch.float32) - sb.to(torch.float32)
            sums.append((d * d).sum())
            counts.append(float(d.numel()))
        root = mesh.devices[0]
        s = sums[0].to(root)
        for p in sums[1:]:
            s = s + p.to(root)
        return torch.div(s, torch.full_like(s, float(sum(counts))))
    return fn
