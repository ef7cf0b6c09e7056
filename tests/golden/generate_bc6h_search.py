"""Generator of bc6h_search.npz: the JAX package's default encode_bc6h
that tests/test_torch_bc6h_search.py holds the PyTorch port's BC6H search
against, frozen so that the test runs no JAX (its live references took
about 29 s of the test run).

Per signed ("u_" unsigned, "s_" signed), that test's batch: the 200-block
random / bimodal set of benchmarks/verify_bc6h_tpu.py:41-52 (numpy seed
17), then 32x32 crops of the five HDR contents of corpus.npz cut into
blocks by the JAX package's image_to_blocks. Keys: {u,s}_blocks [NB, 16,
4] f32, {u,s}_ref [NB, 16] u8 (encode_bc6h) and {u,s}_px_int [16, 3, NB]
int32 (the JAX package's F16-int pixels). Run from the repository root
(about half a minute):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_bc6h_search.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

HDR = ("hdr", "hdr_china", "hdr_flower", "hdr_sun", "hdr_signed")
N_BIMODAL = 40


def random_set(signed: bool) -> np.ndarray:
    """benchmarks/verify_bc6h_tpu.py:41-52: 200 random blocks, the first
    40 signed ones sign-crossing bimodal."""
    rng = np.random.default_rng(17)
    scale = 4.0 if signed else 8.0
    rgb = rng.random((200, 16, 3)).astype(np.float32) * scale
    if signed:
        rgb -= scale / 2
        rgb[:N_BIMODAL, 8:, :] += scale
        rgb[:N_BIMODAL, :8, :] -= scale
    return np.concatenate([rgb, np.ones((200, 16, 1), np.float32)], -1)


def main() -> None:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67
    from directxtex_tpu.bc.common import image_to_blocks

    corpus = np.load(os.path.join(HERE, "corpus.npz"))
    crops = [np.asarray(image_to_blocks(jnp.asarray(corpus[c][:32, :32]))[0])
             for c in HDR]
    out = {}
    for signed in (False, True):
        pre = "s_" if signed else "u_"
        blocks = np.concatenate([random_set(signed)] + crops)
        out[pre + "blocks"] = blocks
        out[pre + "ref"] = np.asarray(jbc67.encode_bc6h(jnp.asarray(blocks),
                                                        signed))
        out[pre + "px_int"] = np.asarray(jbc67._f16_to_int(
            jnp.asarray(np.transpose(blocks[..., :3], (1, 2, 0))), signed))
    np.savez_compressed(os.path.join(HERE, "bc6h_search.npz"), **out)
    print("bc6h_search.npz written:", sorted(out))


if __name__ == "__main__":
    main()
