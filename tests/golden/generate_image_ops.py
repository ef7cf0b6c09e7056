"""Generator of image_ops.npz: the JAX package's resize, mipmaps (2D and
3D), alpha coverage, normal map, color rotation / PQ and MSE / PSNR
outputs, frozen so that tests/test_torch_image_ops.py and
tests/test_torch_mipmaps_resize.py hold the PyTorch port's ops/ against
them without running the JAX ops (each new shape traces its operations
anew).

The cases and their inputs are defined here, at module level with numpy
only, so that the tests build the same inputs from the same seeds:

  resize_cases()      (key, format, [n, h, w], (width, height), flags)
  mip_cases()         (key, format, [n, h, w], flags, levels)
  mip3d_cases()       (key, format, [d, h, w], flags, levels)
  coverage_cases()    (key, [h, w], filter flags, alpha reference)
  normal_cases()      (key, [n, h, w], flags, amplitude, target format)
  rotate_cases()      (key, rotation value, paper-white nits)
  mse_cases()         (key, channels, flags, fmt1, fmt2)

Keys in the file: "<key>" (the output; "<key>_l<m>" per mip level),
"<key>_scale<m>" (the coverage scales' effect is in the levels),
"<key>_cov" (calculate_alpha_coverage of the base), "<key>_mse" /
"<key>_mse_v" / "<key>_psnr", "pq_enc_<nits>" / "pq_dec_<nits>".

XLA runs with its default CPU flags: every op here is an eager jnp call
(no fused loop body), and the tests hold the products (resize, filtered
mips) to a tolerance, not to bits.

Run from the repository root (about half a minute):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_image_ops.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# TEX_FILTER_FLAGS values (directxtex_tpu/ops/flags.py)
WRAP, MIRROR = 0x7, 0x70
SEPARATE_ALPHA, SRGB_IN = 0x100, 0x1000000
POINT, LINEAR, CUBIC, BOX, TRIANGLE = (0x100000, 0x200000, 0x300000,
                                       0x400000, 0x500000)
FILTERS = {"default": 0, "point": POINT, "linear": LINEAR, "cubic": CUBIC,
           "box": BOX, "triangle": TRIANGLE}
# CNMAP_FLAGS values
CH_RED, CH_GREEN, CH_BLUE, CH_ALPHA, CH_LUM = 1, 2, 3, 4, 5
MIRROR_U, MIRROR_V, INVERT, OCCLUSION = 0x1000, 0x2000, 0x4000, 0x8000
# CMSE_FLAGS values
IMAGE1_SRGB, IMAGE2_SRGB = 0x1, 0x2
IGNORE_RED, IGNORE_GREEN, IGNORE_BLUE, IGNORE_ALPHA = 0x10, 0x20, 0x40, 0x80
IMAGE1_X2, IMAGE2_X2 = 0x100, 0x200


def image(seed: int, shape, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """[*shape, 4] f32 uniform in [lo, hi) from a seed; a few exact 0s and
    1s in alpha, so that premultiply / coverage meet their edges."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(lo, hi, tuple(shape) + (4,)).astype(np.float32)
    a = v[..., 3].reshape(-1)
    a[rng.choice(a.size, max(1, a.size // 10), replace=False)] = 0.0
    a[rng.choice(a.size, max(1, a.size // 10), replace=False)] = 1.0
    return v


def resize_cases():
    out = []
    sizes = [((2, 24, 40), (30, 17)), ((1, 7, 9), (20, 13)),
             ((1, 16, 24), (12, 8))]
    for name, mode in FILTERS.items():
        for k, (shape, wh) in enumerate(sizes):
            out.append((f"rs_{name}_{k}", "R8G8B8A8_UNORM", shape, wh, mode))
        out.append((f"rs_{name}_sep_srgb", "R8G8B8A8_UNORM_SRGB",
                    (1, 24, 40), (30, 17), mode | SEPARATE_ALPHA))
        out.append((f"rs_{name}_wrap", "R32G32B32A32_FLOAT", (1, 12, 20),
                    (7, 9), mode | WRAP | SRGB_IN))
        out.append((f"rs_{name}_mirror", "R32G32B32A32_FLOAT", (1, 12, 20),
                    (27, 5), mode | MIRROR | SEPARATE_ALPHA))
    for k, (shape, wh) in enumerate([((1, 1, 1), (3, 2)), ((1, 1, 2), (1, 1)),
                                     ((1, 3, 5), (10, 6)),
                                     ((1, 6, 10), (5, 3))]):
        for name in ("linear", "cubic", "default"):
            out.append((f"rs_corner{k}_{name}", "R8G8B8A8_UNORM", shape, wh,
                        FILTERS[name]))
    return out


def mip_cases():
    out = []
    for name, mode in FILTERS.items():
        out.append((f"mip_{name}", "R8G8B8A8_UNORM", (2, 16, 32), mode, 0))
        out.append((f"mip_{name}_srgb", "R8G8B8A8_UNORM_SRGB", (1, 8, 16),
                    mode, 0))
    for name in ("linear", "cubic", "triangle"):
        out.append((f"mip_{name}_odd", "R8G8B8A8_UNORM", (1, 12, 20),
                    FILTERS[name], 0))
        out.append((f"mip_{name}_odd_wrap", "R32G32B32A32_FLOAT", (1, 12, 20),
                    FILTERS[name] | WRAP, 0))
        out.append((f"mip_{name}_odd_mirror", "R32G32B32A32_FLOAT",
                    (1, 6, 10), FILTERS[name] | MIRROR | SRGB_IN, 0))
        out.append((f"mip_{name}_35", "R8G8B8A8_UNORM", (1, 3, 5),
                    FILTERS[name], 0))
        out.append((f"mip_{name}_12", "R8G8B8A8_UNORM", (1, 1, 2),
                    FILTERS[name], 0))
    out.append(("mip_box_levels3", "R8G8B8A8_UNORM", (1, 32, 32), BOX, 3))
    out.append(("mip_linear_levels2", "R8G8B8A8_UNORM", (1, 12, 20),
                LINEAR, 2))
    return out


def mip3d_cases():
    out = []
    for name, mode in FILTERS.items():
        out.append((f"m3_{name}", "R32G32B32A32_FLOAT", (8, 4, 16), mode, 0))
    for name in ("linear", "cubic", "triangle"):
        out.append((f"m3_{name}_odd", "R32G32B32A32_FLOAT", (6, 5, 12),
                    FILTERS[name], 0))
        out.append((f"m3_{name}_wrap_srgb", "R8G8B8A8_UNORM_SRGB", (4, 6, 8),
                    FILTERS[name] | WRAP, 0))
        out.append((f"m3_{name}_mirror", "R32G32B32A32_FLOAT", (4, 6, 8),
                    FILTERS[name] | MIRROR, 2))
    out.append(("m3_box_srgb", "R8G8B8A8_UNORM_SRGB", (4, 8, 8), BOX, 0))
    return out


def coverage_cases():
    return [("cov_box_50", (32, 32), BOX, 0.5),
            ("cov_box_25", (32, 64), BOX, 0.25),
            ("cov_linear_90", (12, 20), LINEAR, 0.9),
            ("cov_tri_70", (16, 16), TRIANGLE, 0.7)]


def normal_cases():
    out = []
    for ch in (0, CH_RED, CH_GREEN, CH_BLUE, CH_ALPHA, CH_LUM):
        out.append((f"nm_ch{ch}", (2, 9, 13), ch, 1.0, "R8G8B8A8_UNORM"))
    flag_sets = [MIRROR_U, MIRROR_V, MIRROR_U | MIRROR_V, INVERT, OCCLUSION,
                 CH_LUM | MIRROR_U | MIRROR_V | OCCLUSION,
                 CH_GREEN | INVERT | OCCLUSION | MIRROR_V]
    for k, f in enumerate(flag_sets):
        for fmt in ("R8G8B8A8_UNORM", "R8G8B8A8_SNORM",
                    "R16G16B16A16_FLOAT", "R32G32B32A32_FLOAT",
                    "R10G10B10A2_UNORM", "R16G16B16A16_SNORM"):
            out.append((f"nm_f{k}_{fmt}", (1, 11, 7), f, 2.0, fmt))
    for k, shape in enumerate([(1, 1, 1), (1, 1, 2), (1, 3, 5), (1, 6, 10)]):
        out.append((f"nm_corner{k}", shape, CH_LUM | OCCLUSION, 0.37,
                    "R8G8B8A8_UNORM"))
        out.append((f"nm_corner{k}_mirror", shape,
                    CH_RED | MIRROR_U | MIRROR_V | INVERT, 3.0,
                    "R16G16B16A16_FLOAT"))
    return out


ROTATIONS = ("709toHDR10", "HDR10to709", "709to2020", "2020to709",
             "P3D65toHDR10", "P3D65to2020", "709toP3D65", "P3D65to709")
NITS = (200.0, 80.0)


def rotate_cases():
    return [(f"rot_{r}_{int(n)}", r, n) for r in ROTATIONS for n in NITS]


def rotate_input() -> np.ndarray:
    """[2, 16, 24, 4] HDR-ish linear values in [-0.25, 6); PQ signals
    for HDR10to709 take the same values (clipped to [0, 1] there)."""
    return image(71, (2, 16, 24), -0.25, 6.0)


def pq_input() -> np.ndarray:
    """[4096] values: 0, 1, a ramp over [0, 60] and uniform draws."""
    rng = np.random.default_rng(72)
    v = np.concatenate([np.array([0.0, 1.0, 1e-4, 50.0], np.float32),
                        np.linspace(0.0, 60.0, 2044, dtype=np.float32),
                        rng.uniform(0.0, 1.0, 2048).astype(np.float32)])
    return v.astype(np.float32)


def mse_cases():
    return [("mse_default", 4, 0, None, None),
            ("mse_srgb", 4, IMAGE1_SRGB | IMAGE2_SRGB, None, None),
            ("mse_srgb1_x2", 4, IMAGE1_SRGB | IMAGE2_X2, None, None),
            ("mse_x2", 4, IMAGE1_X2 | IMAGE2_X2, None, None),
            ("mse_ignore_rb", 4, IGNORE_RED | IGNORE_BLUE, None, None),
            ("mse_ignore_ga", 4, IGNORE_GREEN | IGNORE_ALPHA, None, None),
            ("mse_rgb", 3, 0, None, None),
            ("mse_fmt_srgb", 4, 0, "R8G8B8A8_UNORM_SRGB", "BC7_UNORM_SRGB"),
            ("mse_fmt_bgrx", 4, 0, "B8G8R8X8_UNORM", "B8G8R8X8_UNORM_SRGB"),
            ("mse_fmt_bc1", 4, IMAGE2_X2, "BC1_UNORM_SRGB", "BC3_UNORM")]


def mse_inputs(channels: int):
    """Two [20, 28, channels] images 0.05 apart on average."""
    a = image(81, (20, 28))
    b = np.clip(a + np.random.default_rng(82).normal(
        0, 0.05, a.shape).astype(np.float32), 0, 1).astype(np.float32)
    return a[..., :channels], b[..., :channels]


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax.numpy as jnp

    from directxtex_tpu.formats import FMT
    from directxtex_tpu.ops import misc, rotatecolor
    from directxtex_tpu.ops.flags import CMSE_FLAGS, CNMAP_FLAGS
    from directxtex_tpu.ops.flags import TEX_FILTER_FLAGS as TF
    from directxtex_tpu.ops.mipmaps import (calculate_alpha_coverage,
                                            generate_mipmaps,
                                            generate_mipmaps_3d,
                                            scale_mipmaps_alpha_for_coverage)
    from directxtex_tpu.ops.normalmaps import compute_normal_map
    from directxtex_tpu.ops.resize import resize
    from directxtex_tpu.texture import TexDimension, Texture

    out = {}
    for i, (key, fmt, shape, (w, h), flags) in enumerate(resize_cases()):
        tex = Texture.from_array(image(100 + i, shape), getattr(FMT, fmt))
        out[key] = np.asarray(resize(tex, w, h, TF(flags)).levels[0])
    for i, (key, fmt, shape, flags, levels) in enumerate(mip_cases()):
        tex = Texture.from_array(image(200 + i, shape), getattr(FMT, fmt))
        for m, lvl in enumerate(generate_mipmaps(tex, TF(flags),
                                                 levels).levels):
            out[f"{key}_l{m}"] = np.asarray(lvl)
    for i, (key, fmt, shape, flags, levels) in enumerate(mip3d_cases()):
        tex = Texture.from_array(image(300 + i, shape), getattr(FMT, fmt),
                                 dimension=TexDimension.TEXTURE3D)
        for m, lvl in enumerate(generate_mipmaps_3d(tex, TF(flags),
                                                    levels).levels):
            out[f"{key}_l{m}"] = np.asarray(lvl)
    for i, (key, shape, flags, ref) in enumerate(coverage_cases()):
        tex = Texture.from_array(image(400 + i, (1,) + tuple(shape)))
        chain = generate_mipmaps(tex, TF(flags))
        out[f"{key}_cov"] = np.asarray(calculate_alpha_coverage(
            chain.levels[0][..., 3], ref))
        for m, lvl in enumerate(scale_mipmaps_alpha_for_coverage(
                chain, ref).levels):
            out[f"{key}_l{m}"] = np.asarray(lvl)
    for i, (key, shape, flags, amp, fmt) in enumerate(normal_cases()):
        tex = Texture.from_array(image(500 + i, shape))
        out[key] = np.asarray(compute_normal_map(
            tex, CNMAP_FLAGS(flags), amp, getattr(FMT, fmt)).levels[0])
    rgba = jnp.asarray(rotate_input())
    for key, rot, nits in rotate_cases():
        out[key] = np.asarray(rotatecolor.rotate_color(rgba, rot, nits))
    pq = jnp.asarray(pq_input())
    for nits in NITS:
        out[f"pq_enc_{int(nits)}"] = np.asarray(rotatecolor.pq_encode(pq,
                                                                      nits))
        out[f"pq_dec_{int(nits)}"] = np.asarray(rotatecolor.pq_decode(
            jnp.clip(pq, 0.0, 1.0), nits))
    for key, ch, flags, f1, f2 in mse_cases():
        a, b = mse_inputs(ch)
        s, v = misc.compute_mse(a, b, CMSE_FLAGS(flags),
                                getattr(FMT, f1) if f1 else None,
                                getattr(FMT, f2) if f2 else None)
        out[f"{key}_mse"] = np.asarray(s)
        out[f"{key}_mse_v"] = np.asarray(v)
        out[f"{key}_psnr"] = np.asarray(misc.compute_psnr(a, b,
                                                          CMSE_FLAGS(flags)))
    np.savez_compressed(os.path.join(HERE, "image_ops.npz"), **out)
    print(len(out), "arrays,",
          os.path.getsize(os.path.join(HERE, "image_ops.npz")), "bytes")


if __name__ == "__main__":
    main()
