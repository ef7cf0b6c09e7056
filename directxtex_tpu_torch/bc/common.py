"""Shared BC codec helpers: block layout.

The PyTorch counterpart of directxtex_tpu/bc/common.py (image_to_blocks /
blocks_to_image). OptimizeAlpha serves BC1-BC5 only and comes with that
port.
"""

from __future__ import annotations

import torch

__all__ = ["image_to_blocks", "blocks_to_image"]


def image_to_blocks(img: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """[H, W, C] -> ([NB, 16, C], nbh, nbw) with edge replication for
    partial blocks (DirectXTexCompress.cpp:159-187 semantics).

    Pixels within a block are in raster order (row-major), matching the
    reference's LoadScanline x4 ordering.
    """
    h, w, c = img.shape
    nbh = (h + 3) // 4
    nbw = (w + 3) // 4
    if h % 4 or w % 4:
        rows = torch.arange(nbh * 4, device=img.device).clamp_(max=h - 1)
        cols = torch.arange(nbw * 4, device=img.device).clamp_(max=w - 1)
        img = img[rows][:, cols]
    blocks = img.reshape(nbh, 4, nbw, 4, c).permute(0, 2, 1, 3, 4)
    return blocks.reshape(nbh * nbw, 16, c), nbh, nbw


def blocks_to_image(blocks: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """[NB, 16, C] -> [H, W, C], cropping any partial-block padding."""
    nbh = (height + 3) // 4
    nbw = (width + 3) // 4
    c = blocks.shape[-1]
    img = blocks.reshape(nbh, nbw, 4, 4, c).permute(0, 2, 1, 3, 4)
    img = img.reshape(nbh * 4, nbw * 4, c)
    return img[:height, :width]
