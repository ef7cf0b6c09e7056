"""BC1/BC2/BC3 (DXT1-5) codecs on torch tensors, batched over blocks.

The counterpart of directxtex_tpu/bc/bc123.py (reference BC.cpp):
Decode565/Encode565 (:36-61), OptimizeRGB (:65-314) -- min/max box init,
4-diagonal axis selection, 8-iteration Newton least-squares -- DecodeBC1
(:318) with the 3-colour + transparent mode, EncodeBC1 (:370) with the
colour-key path, and the BC2/BC3 alpha codecs (:801-1141). The
Floyd-Steinberg dither (BC_FLAGS_DITHER_*) is the 16-step sequential
error diffusion inside the block, in the JAX package's order.

Plain torch ops serve the CPU and CUDA alike, on lane-major [16, NB]
planes. Every division by a tensor is IEEE and every per-block sum runs
in the order XLA's CPU code takes (numerics): in pixel order, except the
sums of the Newton loop of OptimizeRGB, which the JAX package runs as a
compiled `lax.fori_loop` whose fused sums fold halves. So the words equal
the JAX package's run without FMA contraction (XLA contracts `a*b + c`
inside a compiled loop body; torch's eager ops never do).

    decode_bc1(blocks_u8 [NB, 8])  -> [NB, 16, 4] f32
    encode_bc1(colors [NB, 16, 4]) -> [NB, 8] u8
"""

from __future__ import annotations

import numpy as np
import torch

from ..numerics import rdiv, sum0, sum_halves
from .bc45 import bytes_of, pack3, words_of
from .common import optimize_alpha_t

__all__ = [
    "BC_FLAGS_DITHER_RGB", "BC_FLAGS_DITHER_A", "BC_FLAGS_UNIFORM",
    "decode_bc1", "decode_bc2", "decode_bc3",
    "encode_bc1", "encode_bc2", "encode_bc3",
]

# BC_FLAGS (BC.h:30-48)
BC_FLAGS_DITHER_RGB = 0x10000
BC_FLAGS_DITHER_A = 0x20000
BC_FLAGS_UNIFORM = 0x40000

# perceptual luminance weights (BC.cpp:30-31)
_LUM = (0.2125 / 0.7154, 1.0, 0.0721 / 0.7154)
_LUM_INV = (0.7154 / 0.2125, 1.0, 0.7154 / 0.0721)

# the exact f32 constants of Decode565 (c * (1.0f/31.0f), BC.cpp:38-40)
_INV5 = float(np.float32(1.0 / 31.0))
_INV6 = float(np.float32(1.0 / 63.0))
_INV255 = float(np.float32(1.0 / 255.0))
_INV15 = float(np.float32(1.0 / 15.0))
_TINY = float(np.finfo(np.float32).tiny)


def _decode565_planes(w: torch.Tensor):
    """[...] 565 words -> (r, g, b) f32 (Decode565, BC.cpp:36)."""
    return (((w >> 11) & 31).to(torch.float32) * _INV5,
            ((w >> 5) & 63).to(torch.float32) * _INV6,
            (w & 31).to(torch.float32) * _INV5)


def _encode565_planes(r, g, b) -> torch.Tensor:
    """f32 planes -> int64 565 words (Encode565, BC.cpp:44)."""
    def q(c, n):
        return torch.floor(c.clamp(0.0, 1.0) * n + 0.5).to(torch.int64)
    return (q(r, 31.0) << 11) | (q(g, 63.0) << 5) | q(b, 31.0)


def _quantize565_planes(r, g, b):
    """Quantize channel planes to the 565 grid as floats (BC.cpp:433)."""
    return (torch.floor(r * 31.0 + 0.5) * _INV5,
            torch.floor(g * 63.0 + 0.5) * _INV6,
            torch.floor(b * 31.0 + 0.5) * _INV5)


def _decode_bc1_planes_t(w0, w1, bitmap, isbc1: bool) -> torch.Tensor:
    """Core DecodeBC1 (BC.cpp:318), lane-major: [NB] words -> [16, 4, NB]
    f32."""
    r0, g0, b0 = _decode565_planes(w0)
    r1, g1, b1 = _decode565_planes(w1)
    one = torch.ones_like(r0)
    c0 = [r0, g0, b0, one]
    c1 = [r1, g1, b1, one]
    three = (w0 <= w1) if isbc1 else torch.zeros_like(w0, dtype=torch.bool)
    t13 = float(np.float32(1.0 / 3.0))
    t23 = float(np.float32(2.0 / 3.0))
    c2 = [torch.where(three, a + 0.5 * (b - a), a + t13 * (b - a))
          for a, b in zip(c0, c1)]
    c3 = [torch.where(three, torch.zeros_like(a), a + t23 * (b - a))
          for a, b in zip(c0, c1)]  # 3-colour mode: transparent black
    pal = torch.stack([torch.stack(c) for c in (c0, c1, c2, c3)])  # [4,4,NB]
    shifts = torch.arange(16, device=bitmap.device) * 2
    idx = (bitmap[None, :] >> shifts[:, None]) & 3                   # [16,NB]
    return torch.gather(pal.permute(2, 0, 1), 1,
                        idx.t()[:, :, None].expand(-1, -1, 4)).permute(1, 2, 0)


def decode_bc1(blocks: torch.Tensor) -> torch.Tensor:
    """[NB, 8] u8 -> [NB, 16, 4] f32 (D3DXDecodeBC1, BC.cpp:731)."""
    words = words_of(blocks)
    out = _decode_bc1_planes_t(words[:, 0] & 0xFFFF, words[:, 0] >> 16,
                               words[:, 1], True)
    return out.permute(2, 0, 1).contiguous()


def decode_bc2(blocks: torch.Tensor) -> torch.Tensor:
    """[NB, 16] u8 -> [NB, 16, 4] f32 (D3DXDecodeBC2, BC.cpp:802)."""
    words = words_of(blocks)  # [NB, 4]: a0 a1 rgb bitmap
    out = _decode_bc1_planes_t(words[:, 2] & 0xFFFF, words[:, 2] >> 16,
                               words[:, 3], False).clone()
    # explicit 4-bit alpha from words 0..1
    sh = torch.arange(8, device=words.device) * 4
    codes = torch.cat([(words[:, 0][None] >> sh[:, None]) & 0xF,
                       (words[:, 1][None] >> sh[:, None]) & 0xF])
    out[:, 3, :] = codes.to(torch.float32) * _INV15
    return out.permute(2, 0, 1).contiguous()


def decode_bc3(blocks: torch.Tensor) -> torch.Tensor:
    """[NB, 16] u8 -> [NB, 16, 4] f32 (D3DXDecodeBC3, BC.cpp:902)."""
    words = words_of(blocks)
    out = _decode_bc1_planes_t(words[:, 2] & 0xFFFF, words[:, 2] >> 16,
                               words[:, 3], False).clone()
    a0 = words[:, 0] & 0xFF
    a1 = (words[:, 0] >> 8) & 0xFF
    # alpha palette as 8 [NB] planes (BC.cpp:915-930)
    f0 = a0.to(torch.float32) * _INV255
    f1 = a1.to(torch.float32) * _INV255
    eight = a0 > a1
    inv7 = float(np.float32(1.0 / 7.0))
    inv5 = float(np.float32(1.0 / 5.0))
    pal = [f0, f1]
    for k in range(2, 8):
        p8 = (f0 * float(8 - k) + f1 * float(k - 1)) * inv7
        if k < 6:
            p6 = (f0 * float(6 - k) + f1 * float(k - 1)) * inv5
        else:
            p6 = torch.full_like(f0, 0.0 if k == 6 else 1.0)
        pal.append(torch.where(eight, p8, p6))
    pal = torch.stack(pal)                                          # [8, NB]
    # 3-bit indices: 48 bits across bytes 2..7
    lo = (words[:, 0] >> 16) | ((words[:, 1] & 0xFF) << 16)
    hi = words[:, 1] >> 8
    sh = torch.arange(8, device=words.device) * 3
    idx = torch.cat([(lo[None] >> sh[:, None]) & 7,
                     (hi[None] >> sh[:, None]) & 7])               # [16, NB]
    out[:, 3, :] = torch.gather(pal, 0, idx)
    return out.permute(2, 0, 1).contiguous()


# ---------------------------------------------------------------------------
# encode, lane-major [16, NB] planes
# ---------------------------------------------------------------------------

def _optimize_rgb_t(pr, pg, pb, csteps: int, uniform: bool):
    """Batched OptimizeRGB (BC.cpp:65) over [16, NB] channel planes.
    Returns endpoint planes ((Xr, Xg, Xb), (Yr, Yg, Yb)), each [NB]."""
    pC = [2 / 2, 1 / 2, 0 / 2] if csteps == 3 else [3 / 3, 2 / 3, 1 / 3, 0 / 3]
    pD = [0 / 2, 1 / 2, 2 / 2] if csteps == 3 else [0 / 3, 1 / 3, 2 / 3, 3 / 3]

    init = (1.0, 1.0, 1.0) if uniform else _LUM
    Xr = pr.amin(dim=0).clamp(max=init[0])
    Xg = pg.amin(dim=0).clamp(max=init[1])
    Xb = pb.amin(dim=0).clamp(max=init[2])
    Yr = pr.amax(dim=0).clamp(min=0.0)
    Yg = pg.amax(dim=0).clamp(min=0.0)
    Yb = pb.amax(dim=0).clamp(min=0.0)

    ABr, ABg, ABb = Yr - Xr, Yg - Xg, Yb - Xb
    fAB = ABr * ABr + ABg * ABg + ABb * ABb
    single = fAB < _TINY

    inv = rdiv(1.0, torch.where(single, 1.0, fAB))
    Dr, Dg, Db = ABr * inv, ABg * inv, ABb * inv
    Mr, Mg, Mb = (Xr + Yr) * 0.5, (Xg + Yg) * 0.5, (Xb + Yb) * 0.5
    Ptr = (pr - Mr) * Dr
    Ptg = (pg - Mg) * Dg
    Ptb = (pb - Mb) * Db
    f0 = Ptr + Ptg + Ptb
    f1 = Ptr + Ptg - Ptb
    f2 = Ptr - Ptg + Ptb
    f3 = Ptr - Ptg - Ptb
    d0, d1, d2, d3 = (sum0(f * f) for f in (f0, f1, f2, f3))
    # argmax over the four diagonals (BC.cpp:174-194)
    best01 = torch.where(d1 > d0, 1, 0)
    bv01 = torch.maximum(d0, d1)
    best23 = torch.where(d3 > d2, 3, 2)
    bv23 = torch.maximum(d2, d3)
    idirmax = torch.where(bv23 > bv01, best23, best01)
    swap_g = (idirmax & 2) != 0
    swap_b = (idirmax & 1) != 0
    Xg, Yg = torch.where(swap_g, Yg, Xg), torch.where(swap_g, Xg, Yg)
    Xb, Yb = torch.where(swap_b, Yb, Xb), torch.where(swap_b, Xb, Yb)

    done = single | (fAB < 1.0 / 4096.0)
    fsteps = float(csteps - 1)
    eps = (0.25 / 64.0) * (0.25 / 64.0)
    # the JAX package's lax.fori_loop: its compiled sums fold halves
    for _ in range(8):
        Dr, Dg, Db = Yr - Xr, Yg - Xg, Yb - Xb
        flen = Dr * Dr + Dg * Dg + Db * Db
        stop = flen < (1.0 / 4096.0)
        scale = rdiv(fsteps, torch.where(stop, 1.0, flen))
        Dr, Dg, Db = Dr * scale, Dg * scale, Db * scale

        fdot = (pr - Xr) * Dr + (pg - Xg) * Dg + (pb - Xb) * Db  # [16, NB]
        istep = torch.where(
            fdot <= 0.0, 0,
            torch.where(fdot >= fsteps, csteps - 1,
                        torch.floor(fdot + 0.5).to(torch.int32)))
        zero = torch.zeros_like(Xr)
        d2X, d2Y = zero, zero
        dXr = dXg = dXb = dYr = dYg = dYb = zero
        for k in range(csteps):
            m = (istep == k).to(torch.float32)              # [16, NB]
            sr = Xr * pC[k] + Yr * pD[k]
            sg = Xg * pC[k] + Yg * pD[k]
            sb = Xb * pC[k] + Yb * pD[k]
            diffr = m * (sr - pr)
            diffg = m * (sg - pg)
            diffb = m * (sb - pb)
            cnt = sum_halves(m)
            fc = pC[k] * (1.0 / 8.0)
            fd = pD[k] * (1.0 / 8.0)
            tr, tg, tb = (sum_halves(diffr), sum_halves(diffg),
                          sum_halves(diffb))
            d2X = d2X + cnt * (fc * pC[k])
            d2Y = d2Y + cnt * (fd * pD[k])
            dXr = dXr + fc * tr
            dXg = dXg + fc * tg
            dXb = dXb + fc * tb
            dYr = dYr + fd * tr
            dYg = dYg + fd * tg
            dYb = dYb + fd * tb

        okX = d2X > 0
        invX = rdiv(1.0, torch.where(okX, d2X, 1.0))
        nXr = torch.where(okX, Xr - dXr * invX, Xr)
        nXg = torch.where(okX, Xg - dXg * invX, Xg)
        nXb = torch.where(okX, Xb - dXb * invX, Xb)
        okY = d2Y > 0
        invY = rdiv(1.0, torch.where(okY, d2Y, 1.0))
        nYr = torch.where(okY, Yr - dYr * invY, Yr)
        nYg = torch.where(okY, Yg - dYg * invY, Yg)
        nYb = torch.where(okY, Yb - dYb * invY, Yb)

        conv = ((dXr * dXr < eps) & (dXg * dXg < eps) & (dXb * dXb < eps)
                & (dYr * dYr < eps) & (dYg * dYg < eps) & (dYb * dYb < eps))
        act = ~(done | stop)
        Xr = torch.where(act, nXr, Xr)
        Xg = torch.where(act, nXg, Xg)
        Xb = torch.where(act, nXb, Xb)
        Yr = torch.where(act, nYr, Yr)
        Yg = torch.where(act, nYg, Yg)
        Yb = torch.where(act, nYb, Yb)
        done = done | stop | (act & conv)
    return (Xr, Xg, Xb), (Yr, Yg, Yb)


def _fs_dither_quantize(values: torch.Tensor, quantize_fn) -> torch.Tensor:
    """Floyd-Steinberg error diffusion over the 16 raster-order pixels of
    each block (EncodeBC1 dither, BC.cpp:414-489), in the JAX package's
    order: pixel i's error goes right, down-left, down and down-right in
    that order, a weight of 0 adding 0 at the clamped index min(i + o, 15).
    values: [16, NB, C]. Returns the quantized values [16, NB, C]."""
    values = values.to(torch.float32)
    error = [torch.zeros_like(values[0]) for _ in range(16)]
    qs = []
    for i in range(16):
        v = values[i] + error[i]
        q = quantize_fn(v)
        diff = v - q
        w_right = 7.0 / 16.0 if (i & 3) != 3 else 0.0
        w_dl = 3.0 / 16.0 if i < 12 and (i & 3) != 0 else 0.0
        w_down = 5.0 / 16.0 if i < 12 else 0.0
        w_dr = 1.0 / 16.0 if i < 12 and (i & 3) != 3 else 0.0
        for offset, wgt in ((1, w_right), (3, w_dl), (4, w_down), (5, w_dr)):
            j = min(i + offset, 15)
            error[j] = error[j] + (diff * wgt if wgt > 0 else 0.0)
        qs.append(q)
    return torch.stack(qs)


def _quantize565_stacked(v: torch.Tensor) -> torch.Tensor:
    return torch.stack(_quantize565_planes(v[..., 0], v[..., 1], v[..., 2]),
                       dim=-1)


def _encode_bc1_core(color: torch.Tensor, alpha: torch.Tensor,
                     color_key: bool, threshold: float,
                     flags: int) -> torch.Tensor:
    """EncodeBC1 (BC.cpp:370). color [NB, 16, 3] straight RGB, alpha
    [NB, 16]. Returns [NB, 2] int64 u32 words."""
    nb = color.shape[0]
    dev = color.device
    uniform = bool(flags & BC_FLAGS_UNIFORM)
    dither = bool(flags & BC_FLAGS_DITHER_RGB)

    ct = color.to(torch.float32).permute(1, 2, 0)                # [16,3,NB]
    at = alpha.to(torch.float32).t()                             # [16,NB]
    pr, pg, pb = ct[:, 0], ct[:, 1], ct[:, 2]

    if color_key:
        transparent = at < threshold
        n_key = transparent.sum(dim=0)
        all_key = n_key == 16
        three = n_key > 0
    else:
        transparent = torch.zeros_like(at, dtype=torch.bool)
        all_key = torch.zeros(nb, dtype=torch.bool, device=dev)
        three = torch.zeros(nb, dtype=torch.bool, device=dev)

    # 565-grid quantization (+ optional FS dithering), BC.cpp:408-490
    if dither:
        q = _fs_dither_quantize(torch.stack([pr, pg, pb], dim=-1),
                                _quantize565_stacked)
        qr, qg, qb = q[..., 0], q[..., 1], q[..., 2]
    else:
        qr, qg, qb = _quantize565_planes(pr, pg, pb)
    if not uniform:
        qr, qg, qb = qr * _LUM[0], qg * _LUM[1], qb * _LUM[2]
        wr, wg, wb = pr * _LUM[0], pg * _LUM[1], pb * _LUM[2]
    else:
        wr, wg, wb = pr, pg, pb

    # endpoint optimization; both step counts, selected per block
    X, Y = _optimize_rgb_t(qr, qg, qb, 4, uniform)
    if color_key:
        X3, Y3 = _optimize_rgb_t(qr, qg, qb, 3, uniform)
        X = [torch.where(three, a, b) for a, b in zip(X3, X)]
        Y = [torch.where(three, a, b) for a, b in zip(Y3, Y)]

    inv = (1.0, 1.0, 1.0) if uniform else _LUM_INV
    wA = _encode565_planes(*(c * s for c, s in zip(X, inv)))
    wB = _encode565_planes(*(c * s for c, s in zip(Y, inv)))

    lum = (1.0, 1.0, 1.0) if uniform else _LUM
    cA = [c * s for c, s in zip(_decode565_planes(wA), lum)]
    cB = [c * s for c, s in zip(_decode565_planes(wB), lum)]

    # endpoint storage order: 4-colour needs w0 > w1; 3-colour w0 <= w1
    keep = three == (wA <= wB)
    w0 = torch.where(keep, wA, wB)
    w1 = torch.where(keep, wB, wA)
    s0r, s0g, s0b = (torch.where(keep, a, b) for a, b in zip(cA, cB))
    s1r, s1g, s1b = (torch.where(keep, b, a) for a, b in zip(cA, cB))

    csteps_f = torch.where(three, 2.0, 3.0)
    dr, dg, db = s1r - s0r, s1g - s0g, s1b - s0b
    lensq = dr * dr + dg * dg + db * db
    fscale = torch.where(wA != wB,
                         csteps_f / torch.where(lensq == 0, 1.0, lensq), 0.0)
    dr, dg, db = dr * fscale, dg * fscale, db * fscale

    fdot = (wr - s0r) * dr + (wg - s0g) * dg + (wb - s0b) * db  # [16, NB]
    raw = torch.minimum(torch.floor(fdot + 0.5).to(torch.int32).clamp(min=0),
                        torch.where(three, 2, 3).to(torch.int32))
    # pSteps3 = [0, 2, 1], pSteps4 = [0, 2, 3, 1]
    m3 = torch.where(raw == 0, 0, torch.where(raw == 1, 2, 1))
    m4 = torch.where(raw == 0, 0, torch.where(
        raw == 1, 2, torch.where(raw == 2, 3, 1)))
    mapped = torch.where(three, m3, m4)
    istep = torch.where(fdot <= 0.0, 0,
                        torch.where(fdot >= csteps_f, 1, mapped))
    istep = torch.where(transparent & three, 3, istep)
    degen = ~three & (wA == wB)
    istep = torch.where(degen, 0, istep).to(torch.int64)

    shifts = (torch.arange(16, device=dev) * 2)[:, None]
    bitmap = (istep << shifts).sum(dim=0)

    w0 = torch.where(all_key, 0x0000, w0)
    w1 = torch.where(all_key, 0xFFFF, w1)
    bitmap = torch.where(all_key, 0xFFFFFFFF, bitmap)
    return torch.stack([w0 | (w1 << 16), bitmap], dim=1)


def encode_bc1(colors: torch.Tensor, threshold: float = 0.5,
               flags: int = 0) -> torch.Tensor:
    """[NB, 16, 4] f32 -> [NB, 8] u8 (D3DXEncodeBC1, BC.cpp:738)."""
    colors = colors.to(torch.float32)
    return bytes_of(_encode_bc1_core(colors[..., :3], colors[..., 3], True,
                                     threshold, flags))


def _alpha_halves(codes: torch.Tensor, bits: int):
    """[16, NB] codes -> two [NB] int64 words of 8 codes each."""
    sh = (torch.arange(8, device=codes.device) * bits)[:, None]
    return (codes[:8] << sh).sum(dim=0), (codes[8:] << sh).sum(dim=0)


def encode_bc2(colors: torch.Tensor, flags: int = 0) -> torch.Tensor:
    """[NB, 16, 4] f32 -> [NB, 16] u8 (D3DXEncodeBC2, BC.cpp:828)."""
    colors = colors.to(torch.float32)
    at = colors[..., 3].t()                                       # [16, NB]
    if flags & BC_FLAGS_DITHER_A:
        q = _fs_dither_quantize(
            at[..., None], lambda v: torch.floor(v * 15.0 + 0.5) * _INV15)
        at_q = q[..., 0]
    else:
        at_q = at
    codes = torch.floor(at_q * 15.0 + 0.5).clamp(0, 15).to(torch.int64)
    a0, a1 = _alpha_halves(codes, 4)
    rgb = _encode_bc1_core(colors[..., :3], colors[..., 3], False, 0.0, flags)
    return bytes_of(torch.cat([a0[:, None], a1[:, None], rgb], dim=1))


def encode_bc3(colors: torch.Tensor, flags: int = 0) -> torch.Tensor:
    """[NB, 16, 4] f32 -> [NB, 16] u8 (D3DXEncodeBC3, BC.cpp:944)."""
    colors = colors.to(torch.float32)
    at = colors[..., 3].t()                                       # [16, NB]

    # quantize alpha to the A8 grid (+ optional dithering), BC.cpp:957-1005
    if flags & BC_FLAGS_DITHER_A:
        fq = _fs_dither_quantize(
            at[..., None], lambda v: torch.floor(v * 255.0 + 0.5) * _INV255)
        falpha = fq[..., 0]
    else:
        falpha = torch.floor(at * 255.0 + 0.5) * _INV255
    fmin = falpha.amin(dim=0)
    fmax = falpha.amax(dim=0)

    all_opaque = fmin == 1.0
    six_steps = (fmin == 0.0) | (fmax == 1.0)

    x6, y6 = optimize_alpha_t(falpha, 6, False)
    x8, y8 = optimize_alpha_t(falpha, 8, False)
    fx = torch.where(six_steps, x6, x8)
    fy = torch.where(six_steps, y6, y8)

    bA = torch.floor(fx * 255.0 + 0.5).to(torch.int64)
    bB = torch.floor(fy * 255.0 + 0.5).to(torch.int64)
    fA = bA.to(torch.float32) * _INV255
    fB = bB.to(torch.float32) * _INV255

    degen8 = ~six_steps & (bA == bB)
    a_lo = torch.where(six_steps, bA, bB)
    a_hi = torch.where(six_steps, bB, bA)
    s0 = torch.where(six_steps, fA, fB)
    s1 = torch.where(six_steps, fB, fA)

    csteps_f = torch.where(six_steps, 5.0, 7.0)
    fscale = torch.where(s0 != s1, csteps_f / (s1 - s0), 0.0)

    # index assignment reads the pre-quantization alpha (BC.cpp:1102)
    fdot = (at - s0) * fscale                                     # [16, NB]
    raw = torch.minimum(torch.floor(fdot + 0.5).to(torch.int32).clamp(min=0),
                        torch.where(six_steps, 5, 7).to(torch.int32))
    # pSteps6 = [0, 2, 3, 4, 5, 1]; pSteps8 = [0, 2, 3, 4, 5, 6, 7, 1]
    m6 = torch.where(raw == 0, 0, torch.where(raw == 5, 1, raw + 1))
    m8 = torch.where(raw == 0, 0, torch.where(raw == 7, 1, raw + 1))
    mapped = torch.where(six_steps, m6, m8)
    lo6 = torch.where(at <= s0 * 0.5, 6, 0)
    hi6 = torch.where(at >= (s1 + 1.0) * 0.5, 7, 1)
    lo = torch.where(six_steps, lo6, 0)
    hi = torch.where(six_steps, hi6, 1)
    istep = torch.where(fdot <= 0.0, lo,
                        torch.where(fdot >= csteps_f, hi, mapped))

    zero_bits = all_opaque | degen8
    istep = torch.where(zero_bits, 0, istep).to(torch.int64)
    a_lo = torch.where(all_opaque, 0xFF, a_lo)
    a_hi = torch.where(all_opaque, 0xFF, a_hi)

    half0, half1 = pack3(istep)
    word0 = a_lo | (a_hi << 8) | ((half0 & 0xFFFF) << 16)
    word1 = (half0 >> 16) | ((half1 & 0xFFFFFF) << 8)

    rgb = _encode_bc1_core(colors[..., :3], colors[..., 3], False, 0.0, flags)
    return bytes_of(torch.cat([word0[:, None], word1[:, None], rgb], dim=1))
