"""Generator of last_teams.npz: the JAX package's outputs that
tests/test_torch_last_teams.py holds K10's and K2 quick's plain twins and
their plain forms (K10's rows folded row 10 first, the maxq team's mode-6
job) against, frozen so that the test runs no JAX.

K10, per signed (keys prefixed "u_" unsigned, "s_" signed): px, F16-int
pixels [48, NB] int32 (row = channel * 16 + pixel), and k10_err [NB] f32,
k10_words [4, NB] u32: the JAX package's _k_bc6h_1region (rows 10-13,
folded in row order from row 10's result; pallas_kernels.py:3445) run
eagerly on the pixels as floats. The 264 blocks, numpy seed 43:
  0-199   random HDR, F16-ints of halves in [0, 8) (signed: [-2, 2), the
          first 40 sign-crossing: pixels 0-7 below -2, 8-15 above 2);
  200-215 flat blocks of one value each, four of each: 0 (every row
          scores 0, so all four tie), 0x7BFF, 0x3C00, and -0x7BFF
          (signed) or 0x1234 (unsigned);
  216-231 two levels per channel, 0x7BFF and 0 (signed: -0x7BFF);
  232-263 two levels per channel near the top of the int16 range (the
          high level in 0x7C00..0x7FFF, the low 8..400 below it; signed:
          the block negated in half of them), on which rows 10-12
          overflow their endpoint fields and row 13 its deltas: no row
          fits most of them.
K2 quick: blocks [NB, 16, 4] f32 and quick_aw1 / quick_aw2, the JAX
package's encode_bc7(flags=0x100000) at alpha weights 1.0 and 2.0 ([NB,
16] u8). The 176 blocks, numpy seed 44:
  0-31    random opaque;       32-63   random with random alpha;
  64-79   flat (one colour; the first 8 opaque);
  80-95   two colours (each pixel one of two RGBA colours);
  96-111  full-range alpha (alpha 0 on pixels 0-7, 1 on 8-15; random
          RGB);
  112-127 descending gradients (pixel 0 the brightest and most opaque,
          so its index has bit 3 set before the anchor swap);
  128-143 the first 16x16 texels of corpus.npz's albedo (opaque);
  144-175 the first 16x32 texels of alphagrad (alpha).
Run from the repository root (about 20 s):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_last_teams.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

N_BIMODAL = 40


def _halves_to_int(h: np.ndarray, signed: bool) -> np.ndarray:
    """f32 values -> F16-ints, as the JAX package's _f16_to_int: the
    half's magnitude bits capped at 0x7BFF, negated for a negative half
    where signed, 0 for it where unsigned."""
    bits = h.astype(np.float16).view(np.uint16).astype(np.int32)
    mag = np.minimum(bits & 0x7FFF, 0x7BFF)
    if signed:
        return np.where(bits & 0x8000, -mag, mag)
    return np.where(bits & 0x8000, 0, mag)


def k10_px(signed: bool) -> np.ndarray:
    """[48, 264] int32 F16-int pixels (module docstring)."""
    rng = np.random.default_rng(43)
    scale = 4.0 if signed else 8.0
    rgb = rng.random((200, 16, 3)).astype(np.float32) * scale
    if signed:
        rgb -= scale / 2
        rgb[:N_BIMODAL, 8:, :] += scale
        rgb[:N_BIMODAL, :8, :] -= scale
    rand = _halves_to_int(rgb, signed).transpose(2, 1, 0).reshape(48, -1)
    lo = -0x7BFF if signed else 0
    flat_vals = (0, 0x7BFF, 0x3C00, -0x7BFF if signed else 0x1234)
    flat = np.repeat(np.array(flat_vals, np.int32), 4)[None, :] \
        * np.ones((48, 1), np.int32)
    two = np.where(rng.random((48, 16)) < 0.5, 0x7BFF, lo)
    hi = rng.integers(0x7C00, 0x8000, (1, 32))
    top = np.where(rng.random((48, 32)) < rng.random((1, 32)), hi,
                   hi - rng.integers(8, 400, (1, 32)))
    if signed:
        top[:, 1::2] *= -1
    return np.concatenate([rand, flat, two, top], axis=1).astype(np.int32)


def quick_blocks() -> np.ndarray:
    """[176, 16, 4] f32 blocks (module docstring)."""
    rng = np.random.default_rng(44)
    rand = rng.random((64, 16, 4)).astype(np.float32)
    rand[:32, :, 3] = 1.0
    flat = np.repeat(rng.random((16, 1, 4)).astype(np.float32), 16, axis=1)
    flat[:8, :, 3] = 1.0
    cols = rng.random((16, 2, 4)).astype(np.float32)
    pick = rng.integers(0, 2, (16, 16))
    two = np.take_along_axis(cols, pick[:, :, None], axis=1)
    full = rng.random((16, 16, 4)).astype(np.float32)
    full[:, :8, 3] = 0.0
    full[:, 8:, 3] = 1.0
    ramp = np.linspace(1.0, 0.0, 16, dtype=np.float32)[None, :, None]
    grad = np.clip(ramp * rng.uniform(0.6, 1.0, (16, 1, 4))
                   + rng.uniform(0.0, 0.2, (16, 1, 4)), 0, 1) \
        .astype(np.float32)
    corpus = np.load(os.path.join(HERE, "corpus.npz"))

    def crop(img):
        h, w = img.shape[:2]
        return img.reshape(h // 4, 4, w // 4, 4, 4).transpose(0, 2, 1, 3, 4) \
            .reshape(-1, 16, 4).astype(np.float32)

    return np.concatenate([rand, flat, two, full, grad,
                           crop(corpus["albedo"][:16, :16]),
                           crop(corpus["alphagrad"][:16, :32])])


def main() -> None:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67
    from directxtex_tpu.bc import pallas_kernels as pk

    out = {}
    for signed in (False, True):
        pre = "s_" if signed else "u_"
        px = k10_px(signed)
        xf3 = [jnp.asarray(px[c * 16:(c + 1) * 16].astype(np.float32))
               for c in range(3)]
        err, words = pk._k_bc6h_1region(xf3, signed)
        out[pre + "px"] = px
        out[pre + "k10_err"] = np.asarray(err, np.float32)
        out[pre + "k10_words"] = np.asarray(words, np.uint32)
    blocks = quick_blocks()
    out["blocks"] = blocks
    for aw in (1.0, 2.0):
        out[f"quick_aw{aw:g}"] = np.asarray(jbc67.encode_bc7(
            jnp.asarray(blocks), flags=0x100000, alpha_weight=aw))
    np.savez_compressed(os.path.join(HERE, "last_teams.npz"), **out)


if __name__ == "__main__":
    main()
