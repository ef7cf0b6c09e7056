"""Generator of search_jobs.npz: the JAX package's search words that
tests/test_torch_search_jobs.py holds the plain forms of K2's maxq team
(its jobs and their fold) and of K5's lane jobs against, frozen so that
the test runs no JAX.

BC7 ("bc7_"): 160 blocks, numpy seed 23: 96 random RGBA blocks (the first
48 opaque), 16 flat blocks (one colour, half of them with alpha), 16
two-tone blocks (a random two-subset shape's subsets in two colours) and
32 blocks of the first 16x32 texels of corpus.npz's tworegion content,
read as [NB, 16, 4] f32 blocks row by row of 4x4. Keys: bc7_blocks, and
bc7_search_aw1 / bc7_search_aw2, the words [NB, 4] u32 that the JAX
package's MAXQUALITY encode_bc7(opaque=True) at alpha_weight 1.0 / 2.0
hands to its first refine: its (1, 3, 5, 6, 4) search.

BC6H ("u_" unsigned, "s_" signed): 128 blocks, numpy seed 31 + signed: 64
random blocks (x 8.0; signed x 4.0 - 2.0), 16 flat, 16 two-tone, 32 with
non-negative first rows and every other pixel 0 (blocks on which shape
candidates tie).
Keys: {u,s}_blocks, {u,s}_words (the JAX package's default encode_bc6h,
[NB, 4] u32) and {u,s}_px_int (its F16-int pixels [16, 3, NB]). Run from
the repository root (about two minutes):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_search_jobs.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def bc7_blocks() -> np.ndarray:
    from directxtex_tpu.bc.bc67_tables import PARTITIONS

    rng = np.random.default_rng(23)
    rand = rng.random((96, 16, 4)).astype(np.float32)
    rand[:48, :, 3] = 1.0
    flat = np.repeat(rng.random((16, 1, 4)).astype(np.float32), 16, axis=1)
    flat[:8, :, 3] = 1.0
    parts = np.asarray(PARTITIONS[1])[rng.integers(0, 64, 16)]   # [16, 16]
    cols = rng.random((16, 2, 4)).astype(np.float32)
    cols[:, :, 3] = 1.0
    two = np.take_along_axis(cols, parts[:, :, None].repeat(4, axis=2),
                             axis=1)
    img = np.load(os.path.join(HERE, "corpus.npz"))["tworegion"][:16, :32]
    crop = img.reshape(4, 4, 8, 4, 4).transpose(0, 2, 1, 3, 4) \
        .reshape(32, 16, 4).astype(np.float32)
    return np.concatenate([rand, flat, two.astype(np.float32), crop])


def bc6h_blocks(signed: bool) -> np.ndarray:
    from directxtex_tpu.bc.bc67_tables import PARTITIONS

    rng = np.random.default_rng(31 + signed)
    scale, off = (4.0, -2.0) if signed else (8.0, 0.0)
    rand = rng.random((64, 16, 3)).astype(np.float32) * scale + off
    flat = np.repeat(rng.random((16, 1, 3)).astype(np.float32) * scale + off,
                     16, axis=1)
    parts = np.asarray(PARTITIONS[1])[rng.integers(0, 32, 16)]
    cols = rng.random((16, 2, 3)).astype(np.float32) * scale + off
    two = np.take_along_axis(cols, parts[:, :, None].repeat(3, axis=2),
                             axis=1)
    sparse = rng.random((32, 16, 3)).astype(np.float32) * scale
    sparse[:, 4:] = 0.0
    rgb = np.concatenate([rand, flat, two, sparse]).astype(np.float32)
    return np.concatenate([rgb, np.ones(rgb.shape[:2] + (1,), np.float32)],
                          -1)


def search_words(blocks: np.ndarray, aw: float) -> np.ndarray:
    """The words the JAX maxq encode hands to its first refine."""
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67

    seen = []
    orig = jbc67.refine_bc7_words

    def record(px_i, words, ladder, **kw):
        seen.append(np.asarray(words))
        return orig(px_i, words, ladder, **kw)

    jbc67.refine_bc7_words = record
    try:
        jbc67.encode_bc7(jnp.asarray(blocks), flags=0x200000, opaque=True,
                         alpha_weight=aw)
    finally:
        jbc67.refine_bc7_words = orig
    return seen[0].astype(np.uint32)


def main() -> None:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67

    out = {"bc7_blocks": bc7_blocks()}
    for aw, key in ((1.0, "bc7_search_aw1"), (2.0, "bc7_search_aw2")):
        out[key] = search_words(out["bc7_blocks"], aw)
    for signed in (False, True):
        pre = "s_" if signed else "u_"
        blocks = bc6h_blocks(signed)
        out[pre + "blocks"] = blocks
        out[pre + "words"] = np.asarray(jbc67.encode_bc6h(
            jnp.asarray(blocks), signed)).view(np.uint32).reshape(-1, 4)
        out[pre + "px_int"] = np.asarray(jbc67._f16_to_int(
            jnp.asarray(np.transpose(blocks[..., :3], (1, 2, 0))), signed))
    np.savez_compressed(os.path.join(HERE, "search_jobs.npz"), **out)
    print("search_jobs.npz written:", sorted(out))


if __name__ == "__main__":
    main()
