"""Generator of compress_dds.npz: the JAX package's compress / decompress
outputs that tests/test_torch_compress_dds.py and chip_smoke.py's phase 30
hold the PyTorch port's format core and compress driver against, frozen so
that neither runs the JAX encoders.

The outputs are taken with XLA's CPU code limited to AVX
(XLA_FLAGS=--xla_cpu_max_isa=AVX, set here before JAX is imported), as
generate_bc12345.py does: with FMA, XLA contracts `a*b + c` inside a
compiled loop body (BC1-BC3's OptimizeRGB), which the port's eager torch
ops never do.

Keys:
  hdr512 content: `hdr512_image(corpus)` below, a 512 x 512 HDR image made
      of corpus.npz's 128^2 hdr_china and hdr_flower (a 4 x 4 grid of the
      two, each tile turned and exposed differently), rounded through
      f16 as an R16G16B16A16_FLOAT DDS stores it; 16,384 BC blocks.
  hdr512_words, hdr512_mid_words [16384, 16] u8: the JAX package's
      compress(BC6H_UF16) of it, default and BC6H_MID tiers.
  hdr512_int_err, hdr512_mid_int_err: their aggregate F16-int error (the
      codec's INTColor norm, summed over blocks); hdr512_log_psnr,
      hdr512_mid_log_psnr: their log-domain PSNR (tests/test_golden.py's
      HDR metric).
  <tex>_l<m> [1, h, w, 4] f32: the small textures' levels. "ldr" and
      "hdru" / "hdrs" are 12 x 20 chains of five levels (12x20, 6x10, 3x5,
      1x2, 1x1) from alphagrad / albedo, hdr_china and hdr_signed; "tiny1",
      "tiny2", "tiny610" are single levels of 1x1, 2x2 and 6x10 from
      photo_flower; the LDR ones are R8G8B8A8_UNORM textures, the HDR ones
      R32G32B32A32_FLOAT.
  <tex>_<FORMAT>[_f<flags>]_w<m> u8 and _d<m> f32: compress(tex, FORMAT,
      flags) level m's block bytes, and decompress() of it, level m.

Run from the repository root (about two minutes):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_compress_dds.py
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_max_isa=AVX").strip()

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

SMALL_CHAIN = [(12, 20), (6, 10), (3, 5), (1, 2), (1, 1)]   # (h, w)
LDR_FORMATS = ["BC1_UNORM", "BC1_UNORM_SRGB", "BC2_UNORM", "BC3_UNORM",
               "BC4_UNORM", "BC4_SNORM", "BC5_UNORM", "BC5_SNORM"]
LDR_FLAGGED = [("BC1_UNORM", 0x10000), ("BC3_UNORM", 0x40000)]
TINY = {"tiny1": (1, 1), "tiny2": (2, 2), "tiny610": (6, 10)}
TINY_FORMATS = ["BC1_UNORM", "BC3_UNORM", "BC6H_UF16"]


def hdr512_image(corpus) -> np.ndarray:
    """[512, 512, 4] f32: a 4 x 4 grid of corpus.npz's 128^2 hdr_china and
    hdr_flower in turn, tile (i, j) turned by (i + j) quarter turns and
    exposed by 2 ** ((i - j) / 2), then rounded through f16 (the values an
    R16G16B16A16_FLOAT DDS holds). Alpha 1."""
    tiles = (corpus["hdr_china"], corpus["hdr_flower"])
    rows = []
    for i in range(4):
        row = []
        for j in range(4):
            t = np.rot90(tiles[(i + j) % 2][..., :3], i + j)
            row.append(t * np.float32(2.0 ** ((i - j) / 2)))
        rows.append(np.concatenate(row, axis=1))
    rgb = np.concatenate(rows, axis=0).astype(np.float16).astype(np.float32)
    return np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)


def log_psnr(dec: np.ndarray, src: np.ndarray) -> float:
    """Log-domain PSNR of HDR RGB (tests/test_golden.py)."""
    a = np.maximum(dec[..., :3], 0) + 1e-4
    b = np.maximum(src[..., :3], 0) + 1e-4
    m = float(np.mean((np.log2(a) - np.log2(b)) ** 2))
    return 10 * np.log10(36.0 / max(m, 1e-30))


def small_textures(corpus) -> dict:
    """name -> list of [1, h, w, 4] f32 levels."""
    out = {}
    ag, al = corpus["alphagrad"], corpus["albedo"]
    ldr = []
    for m, (h, w) in enumerate(SMALL_CHAIN):
        src = ag if m % 2 == 0 else al
        ldr.append(src[8 * m:8 * m + h, 4 * m:4 * m + w][None])
    out["ldr"] = ldr
    for name, key in (("hdru", "hdr_china"), ("hdrs", "hdr_signed")):
        out[name] = [corpus[key][16 * m:16 * m + h, 8 * m:8 * m + w][None]
                     for m, (h, w) in enumerate(SMALL_CHAIN)]
    pf = corpus["photo_flower"]
    for name, (h, w) in TINY.items():
        out[name] = [pf[40:40 + h, 60:60 + w][None]]
    return {k: [np.ascontiguousarray(x, np.float32) for x in v]
            for k, v in out.items()}


def cases():
    """(texture, format name, flags) of the small textures' frozen runs."""
    out = [("ldr", f, 0) for f in LDR_FORMATS]
    out += [("ldr", f, fl) for f, fl in LDR_FLAGGED]
    out += [("hdru", "BC6H_UF16", 0), ("hdrs", "BC6H_SF16", 0)]
    out += [(t, f, 0) for t in TINY for f in TINY_FORMATS]
    return out


def source_format(tex: str) -> str:
    """The small textures' format: RGBA8 for the LDR ones, RGBA32F for
    the HDR ones."""
    return "R32G32B32A32_FLOAT" if tex.startswith("hdr") else "R8G8B8A8_UNORM"


def case_key(tex: str, fmt: str, flags: int) -> str:
    return f"{tex}_{fmt}" + (f"_f{flags:x}" if flags else "")


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67
    from directxtex_tpu.formats import FMT
    from directxtex_tpu.ops.compress import compress, decompress
    from directxtex_tpu.texture import TexMetadata, Texture

    corpus = np.load(os.path.join(HERE, "corpus.npz"))
    out = {}

    # the 512^2 HDR gate (ROADMAP queue 3's large-content BC6H gate)
    img = hdr512_image(corpus)
    tex = Texture.from_array(img, FMT.R16G16B16A16_FLOAT)
    px = np.asarray(bc67._f16_to_int(jnp.asarray(np.transpose(
        img.reshape(128, 4, 128, 4, 4).transpose(0, 2, 1, 3, 4)
        .reshape(-1, 16, 4)[..., :3], (1, 2, 0))), False))
    for key, flags in (("hdr512", 0), ("hdr512_mid", int(bc67._BC6H_MID))):
        ct = compress(tex, FMT.BC6H_UF16, flags)
        words = np.asarray(ct.levels[0]).reshape(-1, 16)
        dec = np.asarray(bc67.decode_bc6h(jnp.asarray(words), False))
        di = np.asarray(bc67._f16_to_int(jnp.asarray(np.transpose(
            dec[..., :3], (1, 2, 0))), False))
        src = img.reshape(128, 4, 128, 4, 4).transpose(0, 2, 1, 3, 4)
        out[key + "_words"] = words
        out[key + "_int_err"] = np.float64(
            ((di - px).astype(np.float64) ** 2).sum())
        out[key + "_log_psnr"] = np.float64(log_psnr(
            dec, src.reshape(-1, 16, 4)))
        print(key, out[key + "_int_err"], out[key + "_log_psnr"])

    textures = small_textures(corpus)
    for name, levels in textures.items():
        for m, lvl in enumerate(levels):
            out[f"{name}_l{m}"] = lvl
    for name, fmt, flags in cases():
        levels = [jnp.asarray(x) for x in textures[name]]
        h, w = levels[0].shape[1:3]
        meta = TexMetadata(width=w, height=h, mip_levels=len(levels),
                           format=getattr(FMT, source_format(name)))
        ct = compress(Texture(meta, levels), getattr(FMT, fmt), flags)
        back = decompress(ct)
        key = case_key(name, fmt, flags)
        for m in range(len(levels)):
            out[f"{key}_w{m}"] = np.asarray(ct.levels[m])
            out[f"{key}_d{m}"] = np.asarray(back.levels[m])
        print(key, [out[f"{key}_w{m}"].shape for m in range(len(levels))])

    np.savez_compressed(os.path.join(HERE, "compress_dds.npz"), **out)


if __name__ == "__main__":
    main()
