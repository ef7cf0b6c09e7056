"""Color-primary rotations and HDR10 (ST.2084 PQ) transfer functions, on
torch tensors.

The counterpart of directxtex_tpu/ops/rotatecolor.py, texconv's
-rotatecolor stage (Texconv/texconv.cpp:2696-2965): 3x3 primary matrices
between Rec.709 / Rec.2020 / DCI-P3-D65 plus the PQ encode/decode used for
the HDR10 variants, parameterised by the paper-white level in nits
(texconv default 200). The matrices are applied as one einsum over the RGB
planes; `pow` goes through numerics.power.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..numerics import clip, power
from ..utils.device import constant

__all__ = ["ROTATE_COLOR", "rotate_color", "pq_encode", "pq_decode",
           "DEFAULT_PAPER_WHITE_NITS"]

DEFAULT_PAPER_WHITE_NITS = 200.0


class ROTATE_COLOR(enum.Enum):
    """texconv -rotatecolor values (Texconv/texconv.cpp:254-263)."""
    _709_TO_HDR10 = "709toHDR10"
    HDR10_TO_709 = "HDR10to709"
    _709_TO_2020 = "709to2020"
    _2020_TO_709 = "2020to709"
    P3D65_TO_HDR10 = "P3D65toHDR10"
    P3D65_TO_2020 = "P3D65to2020"
    _709_TO_P3D65 = "709toP3D65"
    P3D65_TO_709 = "P3D65to709"


# Primary conversion matrices (row-major, out = M @ rgb).
# Values match texconv's c_from709to2020 et al. (Texconv/texconv.cpp:209-252).
_M_709_TO_2020 = np.array([
    [0.6274040, 0.3292820, 0.0433136],
    [0.0690970, 0.9195400, 0.0113612],
    [0.0163916, 0.0880132, 0.8955950]], np.float32)
_M_2020_TO_709 = np.array([
    [1.6604910, -0.5876411, -0.0728499],
    [-0.1245505, 1.1328999, -0.0083494],
    [-0.0181508, -0.1005789, 1.1187297]], np.float32)
_M_P3D65_TO_2020 = np.array([
    [0.7538330, 0.1985973, 0.0475697],
    [0.0457438, 0.9417772, 0.0124790],
    [-0.0012119, 0.0176017, 0.9836086]], np.float32)
_M_709_TO_P3D65 = np.array([
    [0.8224619, 0.1775380, 0.0000000],
    [0.0331941, 0.9668058, 0.0000000],
    [0.0170827, 0.0723974, 0.9105199]], np.float32)
_M_P3D65_TO_709 = np.array([
    [1.2249401, -0.2249404, 0.0000000],
    [-0.0420569, 1.0420571, 0.0000000],
    [-0.0196376, -0.0786361, 1.0982735]], np.float32)

# SMPTE ST.2084 perceptual quantizer constants
_PQ_M1 = 2610.0 / 16384.0
_PQ_M2 = 2523.0 / 4096.0 * 128.0
_PQ_C1 = 3424.0 / 4096.0
_PQ_C2 = 2413.0 / 4096.0 * 32.0
_PQ_C3 = 2392.0 / 4096.0 * 32.0


def pq_encode(v: torch.Tensor,
              paper_white_nits: float = DEFAULT_PAPER_WHITE_NITS):
    """Linear scene value (1.0 = paper white) -> ST.2084 signal."""
    L = clip(v * (paper_white_nits / 10000.0), 0.0, 1.0)
    Lm = power(L, _PQ_M1)
    return power((_PQ_C1 + _PQ_C2 * Lm) / (1.0 + _PQ_C3 * Lm), _PQ_M2)


def pq_decode(n: torch.Tensor,
              paper_white_nits: float = DEFAULT_PAPER_WHITE_NITS):
    """ST.2084 signal -> linear scene value (1.0 = paper white)."""
    n = clip(n, 0.0, 1.0)
    np_ = power(n, 1.0 / _PQ_M2)
    L = power(clip(np_ - _PQ_C1, 0.0, float("inf"))
              / (_PQ_C2 - _PQ_C3 * np_), 1.0 / _PQ_M1)
    return L * (10000.0 / paper_white_nits)


def _apply_mat(rgba: torch.Tensor, name: str) -> torch.Tensor:
    m = constant(("rotate_color", name), lambda: globals()[name],
                 rgba.device)
    rgb = torch.einsum("...c,kc->...k", rgba[..., :3], m)
    return torch.cat([rgb, rgba[..., 3:4]], dim=-1)


def rotate_color(rgba: torch.Tensor, rotation: ROTATE_COLOR,
                 paper_white_nits: float = DEFAULT_PAPER_WHITE_NITS):
    """Apply one -rotatecolor transform to [..., 4] linear float pixels."""
    r = ROTATE_COLOR(rotation)
    if r is ROTATE_COLOR._709_TO_2020:
        return _apply_mat(rgba, "_M_709_TO_2020")
    if r is ROTATE_COLOR._2020_TO_709:
        return _apply_mat(rgba, "_M_2020_TO_709")
    if r is ROTATE_COLOR._709_TO_P3D65:
        return _apply_mat(rgba, "_M_709_TO_P3D65")
    if r is ROTATE_COLOR.P3D65_TO_709:
        return _apply_mat(rgba, "_M_P3D65_TO_709")
    if r is ROTATE_COLOR.P3D65_TO_2020:
        return _apply_mat(rgba, "_M_P3D65_TO_2020")
    if r is ROTATE_COLOR._709_TO_HDR10:
        out = _apply_mat(rgba, "_M_709_TO_2020")
        return torch.cat(
            [pq_encode(out[..., :3], paper_white_nits), out[..., 3:4]], -1)
    if r is ROTATE_COLOR.P3D65_TO_HDR10:
        out = _apply_mat(rgba, "_M_P3D65_TO_2020")
        return torch.cat(
            [pq_encode(out[..., :3], paper_white_nits), out[..., 3:4]], -1)
    if r is ROTATE_COLOR.HDR10_TO_709:
        lin = torch.cat(
            [pq_decode(rgba[..., :3], paper_white_nits), rgba[..., 3:4]], -1)
        return _apply_mat(lin, "_M_2020_TO_709")
    raise ValueError(f"unknown color rotation: {rotation!r}")
