"""Colorspace transforms: sRGB <-> linear and helpers.

The counterpart of directxtex_tpu/ops/colorspace.py (DirectXMath's
XMColorSRGBToRGB / XMColorRGBToSRGB). Alpha passes through. `pow` runs
through numerics.power (f64, rounded once to f32), which gives the same
bits on the CPU and on CUDA; XLA's own pow differs from it by at most
1 ulp on a small share of values.
"""

from __future__ import annotations

import torch

from ..numerics import power

__all__ = ["srgb_to_linear", "linear_to_srgb", "apply_srgb_to_linear",
           "apply_linear_to_srgb", "GRAYSCALE"]

# g_Grayscale (DirectXTexConvert.cpp:194); used for RGB -> luminance
GRAYSCALE = (0.2125, 0.7154, 0.0721)


def srgb_to_linear(v: torch.Tensor) -> torch.Tensor:
    """Per-component sRGB -> linear (XMColorSRGBToRGB)."""
    v = v.clamp(0.0, 1.0)
    linear = v * (1.0 / 12.92)
    exp = power((v + 0.055) * (1.0 / 1.055), 2.4)
    return torch.where(v < 0.04045, linear, exp)


def linear_to_srgb(v: torch.Tensor) -> torch.Tensor:
    """Per-component linear -> sRGB (XMColorRGBToSRGB)."""
    v = v.clamp(0.0, 1.0)
    small = v * 12.92
    big = 1.055 * power(v, 1.0 / 2.4) - 0.055
    return torch.where(v < 0.0031308, small, big)


def apply_srgb_to_linear(rgba: torch.Tensor) -> torch.Tensor:
    """sRGB->linear on RGB, alpha untouched. rgba is [..., 4]."""
    return torch.cat([srgb_to_linear(rgba[..., :3]), rgba[..., 3:4]], dim=-1)


def apply_linear_to_srgb(rgba: torch.Tensor) -> torch.Tensor:
    """linear->sRGB on RGB, alpha untouched. rgba is [..., 4]."""
    return torch.cat([linear_to_srgb(rgba[..., :3]), rgba[..., 3:4]], dim=-1)
