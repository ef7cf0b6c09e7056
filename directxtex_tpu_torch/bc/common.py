"""Shared BC codec helpers: block layout and OptimizeAlpha.

The PyTorch counterpart of directxtex_tpu/bc/common.py (image_to_blocks /
blocks_to_image, and optimize_alpha_t / optimize_alpha, the endpoint fit
of the BC3 alpha and BC4/BC5 channels).
"""

from __future__ import annotations

import numpy as np
import torch

from ..numerics import rdiv, sum0

__all__ = ["image_to_blocks", "blocks_to_image", "optimize_alpha",
           "optimize_alpha_t"]


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


def optimize_alpha_t(points: torch.Tensor, csteps: int,
                     signed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched OptimizeAlpha (BC.h:187-311) over lane-major [16, NB] f32
    planes: eight Newton least-squares rounds, unrolled, a block frozen
    once it stops or converges. Returns the endpoints (fX, fY), each [NB],
    clamped to the codec's range."""
    if csteps == 6:
        pC = [5/5, 4/5, 3/5, 2/5, 1/5, 0/5, 0.0, 0.0]
        pD = [0/5, 1/5, 2/5, 3/5, 4/5, 5/5, 0.0, 0.0]
    else:
        pC = [7/7, 6/7, 5/7, 4/7, 3/7, 2/7, 1/7, 0/7]
        pD = [0/7, 1/7, 2/7, 3/7, 4/7, 5/7, 6/7, 7/7]
    min_value = -1.0 if signed else 0.0
    max_value = 1.0

    if csteps == 8:
        fX = points.amin(dim=0)
        fY = points.amax(dim=0)
    else:
        # min/max excluding values at the codec boundary (BC.h:216-230)
        fX = torch.where(points > min_value, points, max_value).amin(dim=0)
        fY = torch.where(points < max_value, points, min_value).amax(dim=0)
        fY = torch.where(fX == fY, max_value, fY)

    fsteps = float(csteps - 1)
    done = torch.zeros(points.shape[1], dtype=torch.bool,
                       device=points.device)
    for _ in range(8):
        stop_now = (fY - fX) < (1.0 / 256.0)
        active = ~(done | stop_now)
        span = fY - fX
        scale = rdiv(fsteps, torch.where(span == 0, 1.0, span))
        fdot = (points - fX) * scale                      # [16, NB]
        # uint32_t(fDot + 0.5): round half-up
        istep_mid = torch.floor(fdot + 0.5).to(torch.int32)
        if csteps == 6:
            lo = torch.where(points <= (fX + min_value) * 0.5, 6, 0)
            hi = torch.where(points >= (fY + max_value) * 0.5, 7, csteps - 1)
        else:
            lo = torch.zeros_like(istep_mid)
            hi = torch.full_like(istep_mid, csteps - 1)
        istep = torch.where(fdot <= 0.0, lo,
                            torch.where(fdot >= fsteps, hi, istep_mid))
        # pC / pD per pixel from the exact table constants by selects
        pc = torch.zeros_like(points)
        pd = torch.zeros_like(points)
        for k in range(csteps):
            hit = istep == k
            pc = torch.where(hit, float(np.float32(pC[k])), pc)
            pd = torch.where(hit, float(np.float32(pD[k])), pd)
        diff = (pc * fX + pd * fY) - points
        dX = sum0(pc * diff)
        dY = sum0(pd * diff)
        d2X = sum0(pc * pc)
        d2Y = sum0(pd * pd)
        nX = torch.where(d2X > 0, fX - dX / torch.where(d2X > 0, d2X, 1.0),
                         fX)
        nY = torch.where(d2Y > 0, fY - dY / torch.where(d2Y > 0, d2Y, 1.0),
                         fY)
        swap = nX > nY
        nX, nY = torch.where(swap, nY, nX), torch.where(swap, nX, nY)
        converged = (dX * dX < 1.0 / 64.0) & (dY * dY < 1.0 / 64.0)
        fX = torch.where(active, nX, fX)
        fY = torch.where(active, nY, fY)
        done = done | stop_now | (active & converged)
    return fX.clamp(min_value, max_value), fY.clamp(min_value, max_value)


def optimize_alpha(points: torch.Tensor, csteps: int,
                   signed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """[NB, 16]-layout wrapper around optimize_alpha_t."""
    return optimize_alpha_t(points.to(torch.float32).t().contiguous(),
                            csteps, signed)
