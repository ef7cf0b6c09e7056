"""Generator of k8_single_modes.npz: the JAX package's single-mode
evaluations (_try_single_mode, the twin of single_modes_pallas) that
tests/test_torch_k8_ranking_teams.py holds the plain form of K8's team
(its jobs and their fold) against, frozen so that the test runs no JAX.

112 blocks, numpy seed 41: 32 random opaque RGBA blocks, 32 random blocks
with random alpha, 16 flat blocks (one colour; the first 8 opaque), then
the 16 blocks of the first 16x16 texels of corpus.npz's albedo (opaque)
and the 16 of alphagrad's (alpha), read as [NB, 16, 4] f32 blocks row by
row of 4x4. Keys: blocks; px, the texels [16, 4, NB] int32 (0..255) the
evaluations take; and per mode m in 4, 5, 6 and alpha weight 1.0 / 2.0
err_m{m}_aw{1,2} ([NB] f32) and words_m{m}_aw{1,2} ([NB, 4] u32). Run
from the repository root (about 15 s):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_k8_single_modes.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def blocks() -> np.ndarray:
    rng = np.random.default_rng(41)
    rand = rng.random((64, 16, 4)).astype(np.float32)
    rand[:32, :, 3] = 1.0
    flat = np.repeat(rng.random((16, 1, 4)).astype(np.float32), 16, axis=1)
    flat[:8, :, 3] = 1.0
    corpus = np.load(os.path.join(HERE, "corpus.npz"))
    crops = [corpus[c][:16, :16].reshape(4, 4, 4, 4, 4)
             .transpose(0, 2, 1, 3, 4).reshape(16, 16, 4).astype(np.float32)
             for c in ("albedo", "alphagrad")]
    return np.concatenate([rand, flat, *crops])


def main() -> None:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67

    blk = blocks()
    px = np.clip(np.transpose(blk, (1, 2, 0)) * np.float32(255.0)
                 + np.float32(0.01), 0, 255).astype(np.int32)
    pj = jnp.asarray(px)
    out = {"blocks": blk, "px": px}
    for aw in (1.0, 2.0):
        for m in (4, 5, 6):
            err, words = jbc67._try_single_mode(pj, pj.astype(jnp.float32),
                                                m, aw=aw)
            out[f"err_m{m}_aw{aw:g}"] = np.asarray(err, np.float32)
            out[f"words_m{m}_aw{aw:g}"] = np.asarray(words, np.uint32)
    np.savez_compressed(os.path.join(HERE, "k8_single_modes.npz"), **out)


if __name__ == "__main__":
    main()
