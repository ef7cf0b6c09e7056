"""Generator of bc6h_refine_jobs.npz: the JAX package's BC6H winner-refine
outputs that tests/test_torch_bc6h_refine_jobs.py holds the PyTorch
port's refine (its plain twin and the lane-job form of kernel K6) against,
frozen because an eager JAX maxq refine takes about half a minute on a
CPU, past that module's time budget.

Two batches per signed (keys prefixed "u_" unsigned, "s_" signed):
  - "rt_": the 64 blocks of tests/test_torch_bc6h_refine.py (numpy seed
    29 + signed; a quarter flat, a quarter two-tone): rt_blocks, the JAX
    package's default encode_bc6h words rt_words [NB, 4] u32, and
    refine_bc6h_words of those at BC6H_LADDER_MID (remap, no cross2) and
    BC6H_LADDER_MAXQ (remap, cross2): rt_mid, rt_maxq;
  - the 520-block batch of bc6h_unshared.npz ({u,s}_blocks) with its
    frozen BC6H_SHARED_FIT=False search words ({u,s}_search): maxq, the
    refine of those words at BC6H_LADDER_MAXQ with cross2 (their mid
    refine is bc6h_unshared.npz's {u,s}_mid).
Words are [NB, 4] u32. Run from the repository root:

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_bc6h_refine_jobs.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def refine_test_blocks(signed: bool, nb: int = 64, seed: int = 29):
    """tests/test_torch_bc6h_refine.py's _blocks."""
    rng = np.random.default_rng(seed + signed)
    rgb = rng.random((nb, 16, 3)).astype(np.float32) * 6.0
    if signed:
        rgb -= 3.0
    rgb[::4] = rgb[::4, :1] * (1.0 + 0.01 * rng.random((16, 1), np.float32))
    rgb[1::4, 8:] = rgb[1::4, :1] * 0.25
    return np.concatenate([rgb, np.ones((nb, 16, 1), np.float32)], -1)


def refine(blocks: np.ndarray, words: np.ndarray, signed: bool, ladder,
           cross2: bool) -> np.ndarray:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67

    px_int = jbc67._f16_to_int(
        jnp.asarray(np.transpose(blocks[..., :3], (1, 2, 0))), signed)
    return np.asarray(jbc67.refine_bc6h_words(
        px_int, jnp.asarray(words), ladder, signed, remap=True,
        cross2=cross2))


def main() -> None:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67

    unshared = np.load(os.path.join(HERE, "bc6h_unshared.npz"))
    out = {}
    for signed in (False, True):
        pre = "s_" if signed else "u_"
        blocks = refine_test_blocks(signed)
        words = np.asarray(jbc67.encode_bc6h(jnp.asarray(blocks), signed)) \
            .view(np.uint32).reshape(-1, 4)
        out[pre + "rt_blocks"] = blocks
        out[pre + "rt_words"] = words
        out[pre + "rt_mid"] = refine(blocks, words, signed,
                                     jbc67.BC6H_LADDER_MID, False)
        out[pre + "rt_maxq"] = refine(blocks, words, signed,
                                      jbc67.BC6H_LADDER_MAXQ, True)
        search = unshared[pre + "search"].view(np.uint32).reshape(-1, 4)
        out[pre + "maxq"] = refine(unshared[pre + "blocks"], search, signed,
                                   jbc67.BC6H_LADDER_MAXQ, True)
    np.savez_compressed(os.path.join(HERE, "bc6h_refine_jobs.npz"), **out)
    print("bc6h_refine_jobs.npz written:", sorted(out))


if __name__ == "__main__":
    main()
