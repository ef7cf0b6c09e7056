"""Generator of bc12345.npz: the JAX package's BC1-BC5 encodes, its
OptimizeAlpha, its sRGB conversion and BASELINE configs 1, 2 and 5 at
small sizes, frozen for tests/test_torch_bc12345.py,
tests/test_torch_colorspace.py and tests/test_torch_configs.py, which hold
the PyTorch port to them word for word without running JAX.

The outputs are taken with XLA's CPU code limited to AVX
(XLA_FLAGS=--xla_cpu_max_isa=AVX, set here before JAX is imported): with
FMA instructions XLA contracts `a*b + c` inside a compiled computation
(the bodies of `_optimize_rgb_t`'s `lax.fori_loop` and the dither's
`lax.scan`), which moves a few BC1 words, and torch's eager ops never
contract. The script reruns the encoders in a child process with the
default flags and prints how many words of each differ.

Keys (numpy seeds in brackets):
  blocks [1280, 16, 4] f32, the encoder input:
      0-1023     config 1's content (benchmarks/run_all.py:61-69) at
                 128^2 [0];
      1024-1087  random RGBA, alpha uniform (the colour key in part) [5];
      1088-1103  alpha below 0.5 everywhere (every pixel keyed) [5];
      1104-1119  one colour a block, alpha 1 [5];
      1120-1135  two colours a block, alpha 0 or 1, 0.5 exactly on
                 pixel 0 of half of them [5];
      1136-1151  every channel 0 or 1 (the codecs' boundaries) [5];
      1152-1167  grey ramps, alpha descending [5];
      1168-1231  the top-left 32 x 32 texels of corpus.npz's albedo;
      1232-1279  the top-left 16 x 48 texels of alphagrad.
  bc1_<flags>, bc2_<flags>, bc3_<flags> (flags as 0x%x), bc4u, bc5u:
      the encodes of blocks; bc4s, bc5s: of blocks * 2 - 1.
  oa_<u|s><6|8>_x / _y [2560] f32: optimize_alpha_t on the red and the
      alpha channels of blocks ([16, 2560] planes; signed: * 2 - 1).
  srgb_x [32768] f32: linspace(-0.05, 1.05) then uniform [7];
      srgb_to_linear, linear_to_srgb: the JAX package's on srgb_x.
  c1_srgb<0|1>_blocks / _words: mipped_compress_pipeline("bc1",
      srgb=...) on config 1's content at 32^2 [0]: the encoder's input
      (every level's blocks) and its output, every level concatenated.
  c2_img [2, 16, 16, 4]: run_all.py:86-112's batch at 16^2 [1];
      c2_pm its sRGB -> linear, premultiplied batch (the encoders'
      input) and c2_bc3 / c2_bc4 / c2_bc5 [2, 16, 8 or 16] the step's
      words.
  c5_heights [2, 10, 18, 4]: run_all.py:156-170's library at 10 x 18
      [3]; c5_normal [2, 10, 18, 4] the normal maps asset_pipeline
      encodes; c5_words [2, 15, 16] asset_pipeline()'s output.

Run from the repository root (about 3 minutes):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_bc12345.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

_DEFAULT_FLAGS = "--default-flags" in sys.argv
_XLA_FLAGS = os.environ.get("XLA_FLAGS", "")
if not _DEFAULT_FLAGS:
    os.environ["XLA_FLAGS"] = (_XLA_FLAGS + " --xla_cpu_max_isa=AVX").strip()

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

BC1_FLAGS = (0x0, 0x10000, 0x40000, 0x50000)
BC23_FLAGS = (0x0, 0x20000, 0x30000)


def config1_image(size: int) -> np.ndarray:
    """benchmarks/run_all.py:61-69's content at size^2."""
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, size, dtype=np.float32)
    gx, gy = np.meshgrid(x, x)
    return np.clip(np.stack([gx, gy, gx * gy, np.ones_like(gx)], -1)
                   + rng.normal(0, .02, (size, size, 4)), 0, 1
                   ).astype(np.float32)


def special_blocks() -> np.ndarray:
    """Blocks 1024-1167 of the module docstring."""
    rng = np.random.default_rng(5)
    rnd = rng.random((64, 16, 4), dtype=np.float32)
    keyed = rng.random((16, 16, 4), dtype=np.float32)
    keyed[..., 3] *= 0.49
    flat = np.repeat(rng.random((16, 1, 4), dtype=np.float32), 16, axis=1)
    flat[..., 3] = 1
    cols = rng.random((16, 2, 4), dtype=np.float32)
    cols[..., 3] = np.round(cols[..., 3])
    pick = rng.integers(0, 2, (16, 16))
    two = np.take_along_axis(cols, pick[..., None], axis=1)
    two[:8, 0, 3] = 0.5
    edge = rng.integers(0, 2, (16, 16, 4)).astype(np.float32)
    ramp = np.linspace(0, 1, 16, dtype=np.float32)[None, :, None] \
        * rng.random((16, 1, 1), dtype=np.float32)
    grey = np.concatenate([np.repeat(ramp, 3, axis=2), ramp[:, ::-1]],
                          axis=2)
    return np.concatenate([rnd, keyed, flat, two, edge, grey]
                          ).astype(np.float32)


def corpus_blocks() -> np.ndarray:
    """Blocks 1168-1279: albedo's and alphagrad's top-left crops."""
    from directxtex_tpu.bc.common import image_to_blocks
    corpus = np.load(os.path.join(HERE, "corpus.npz"))
    return np.concatenate([
        np.asarray(image_to_blocks(corpus["albedo"][:32, :32])[0]),
        np.asarray(image_to_blocks(corpus["alphagrad"][:16, :48])[0])])


def make_blocks() -> np.ndarray:
    from directxtex_tpu.bc.common import image_to_blocks
    c1 = np.asarray(image_to_blocks(config1_image(128))[0])
    return np.concatenate([c1, special_blocks(), corpus_blocks()]
                          ).astype(np.float32)


def srgb_inputs() -> np.ndarray:
    return np.concatenate([
        np.linspace(-0.05, 1.05, 16384, dtype=np.float32),
        np.random.default_rng(7).random(16384, dtype=np.float32)])


def encoder_outputs(blocks: np.ndarray) -> dict:
    """The BC1-BC5 words of blocks (bc4s / bc5s of blocks * 2 - 1)."""
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc123, bc45
    b = jnp.asarray(blocks)
    sb = jnp.asarray(blocks * np.float32(2) - np.float32(1))
    out = {}
    for f in BC1_FLAGS:
        out[f"bc1_{f:#x}"] = np.asarray(bc123.encode_bc1(b, 0.5, f))
    for f in BC23_FLAGS:
        out[f"bc2_{f:#x}"] = np.asarray(bc123.encode_bc2(b, f))
        out[f"bc3_{f:#x}"] = np.asarray(bc123.encode_bc3(b, f))
    out["bc4u"] = np.asarray(bc45.encode_bc4u(b))
    out["bc5u"] = np.asarray(bc45.encode_bc5u(b))
    out["bc4s"] = np.asarray(bc45.encode_bc4s(sb))
    out["bc5s"] = np.asarray(bc45.encode_bc5s(sb))
    return out


def config1_outputs() -> dict:
    """mipped_compress_pipeline("bc1") at 32^2, both srgb settings: the
    encoder's input (recorded at the pipeline's _encode) and output."""
    import jax.numpy as jnp

    from directxtex_tpu.models import pipelines
    img = jnp.asarray(config1_image(32))
    out = {}
    encode = pipelines._encode
    for srgb in (False, True):
        seen = []

        def recording(kind, blocks, flags=0):
            seen.append(np.asarray(blocks))
            return encode(kind, blocks, flags)

        pipelines._encode = recording
        try:
            levels = pipelines.mipped_compress_pipeline(
                "bc1", srgb=srgb)(img)
        finally:
            pipelines._encode = encode
        out[f"c1_srgb{int(srgb)}_blocks"] = seen[0]
        out[f"c1_srgb{int(srgb)}_words"] = np.concatenate(
            [np.asarray(lv) for lv in levels])
    return out


def config2_outputs() -> dict:
    """benchmarks/run_all.py:86-112's step on a 2 x 16^2 batch."""
    import jax
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc123, bc45
    from directxtex_tpu.bc.common import image_to_blocks
    from directxtex_tpu.ops.colorspace import apply_srgb_to_linear
    batch = np.random.default_rng(1).random((2, 16, 16, 4)).astype(
        np.float32)
    lin = apply_srgb_to_linear(jnp.asarray(batch))
    pm = lin.at[..., :3].mul(lin[..., 3:4])

    def enc(img):
        blocks, _, _ = image_to_blocks(img)
        return (bc123.encode_bc3(blocks, 0), bc45.encode_bc4u(blocks),
                bc45.encode_bc5u(blocks))

    bc3, bc4, bc5 = jax.vmap(enc)(pm)
    return {"c2_img": batch, "c2_pm": np.asarray(pm),
            "c2_bc3": np.asarray(bc3), "c2_bc4": np.asarray(bc4),
            "c2_bc5": np.asarray(bc5)}


def config5_outputs() -> dict:
    """asset_pipeline() on a 2 x 10 x 18 library, with the normal maps it
    hands its vmap (recorded there)."""
    import types

    import jax
    import jax.numpy as jnp

    from directxtex_tpu.models import pipelines
    heights = np.random.default_rng(3).random((2, 10, 18, 4)).astype(
        np.float32)
    seen = []

    def vmap(fn):
        def run(x):
            seen.append(np.asarray(x))
            return jax.vmap(fn)(x)
        return run

    pipelines.jax = types.SimpleNamespace(vmap=vmap)
    try:
        words = pipelines.asset_pipeline()(jnp.asarray(heights))
    finally:
        pipelines.jax = jax
    return {"c5_heights": heights, "c5_normal": seen[0],
            "c5_words": np.asarray(words)}


def default_flag_run(path: str) -> None:
    """The encoders and configs 1 and 2 with XLA's default CPU flags."""
    blocks = np.load(path)["blocks"]
    np.savez(path, **encoder_outputs(blocks), **config1_outputs(),
             **config2_outputs())


def main() -> None:
    import jax
    import jax.numpy as jnp

    from directxtex_tpu.bc.common import optimize_alpha_t
    from directxtex_tpu.ops import colorspace

    blocks = make_blocks()
    out = {"blocks": blocks}
    out.update(encoder_outputs(blocks))
    planes = np.concatenate([blocks[..., 0], blocks[..., 3]]).T
    for signed in (False, True):
        pts = planes * np.float32(2) - np.float32(1) if signed else planes
        for steps in (6, 8):
            x, y = optimize_alpha_t(jnp.asarray(pts), steps, signed)
            key = f"oa_{'s' if signed else 'u'}{steps}"
            out[key + "_x"] = np.asarray(x)
            out[key + "_y"] = np.asarray(y)
    xs = srgb_inputs()
    out["srgb_x"] = xs
    out["srgb_to_linear"] = np.asarray(colorspace.srgb_to_linear(
        jnp.asarray(xs)))
    out["linear_to_srgb"] = np.asarray(colorspace.linear_to_srgb(
        jnp.asarray(xs)))
    out.update(config1_outputs())
    out.update(config2_outputs())
    out.update(config5_outputs())
    print("jax", jax.__version__, "XLA_FLAGS", os.environ["XLA_FLAGS"])

    # the same encoders and configs 1 and 2 with XLA's default CPU flags
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "default.npz")
        np.savez(path, blocks=blocks)
        env = dict(os.environ, XLA_FLAGS=_XLA_FLAGS)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--default-flags", path], env=env, check=True)
        default = dict(np.load(path))
    for key in sorted(default):
        a, b = out[key], default[key]
        n = int(np.any((a != b).reshape(a.shape[0], -1), axis=1).sum())
        print(f"{key}: {n} of {a.shape[0]} differ from a default-flag run")

    dst = os.path.join(HERE, "bc12345.npz")
    np.savez_compressed(dst, **out)
    print("wrote", dst, os.path.getsize(dst), "bytes")


if __name__ == "__main__":
    if _DEFAULT_FLAGS:
        default_flag_run(sys.argv[sys.argv.index("--default-flags") + 1])
    else:
        main()
