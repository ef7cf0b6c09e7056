"""Height-map neighbourhood fetch (DirectXTexNormalMaps.cpp).

The port's part of directxtex_tpu/ops/normalmaps.py: `_shift`, which
BASELINE config 5 (models.pipelines.asset_pipeline) takes for its 3x3
taps. compute_normal_map needs Texture and the format packing, which the
port does not have yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch

__all__: list[str] = []


def _shift(h: torch.Tensor, dy: int, dx: int, mirror_u: bool,
           mirror_v: bool) -> torch.Tensor:
    """Neighbourhood fetch with wrap (default) or mirror edges, matching
    EvaluateRow/row setup (:63-74, :125-135): out[y, x] = h[y + dy,
    x + dx], wrapped by a roll or clamped to the edge. h is [..., H, W]."""
    out = h
    if dy:
        if mirror_v:
            padded = torch.cat([out[..., :1, :], out, out[..., -1:, :]],
                               dim=-2)
            out = padded[..., 1 + dy:padded.shape[-2] - 1 + dy, :]
        else:
            out = torch.roll(out, -dy, dims=-2)
    if dx:
        if mirror_u:
            padded = torch.cat([out[..., :1], out, out[..., -1:]], dim=-1)
            out = padded[..., 1 + dx:padded.shape[-1] - 1 + dx]
        else:
            out = torch.roll(out, -dx, dims=-1)
    return out
