"""Generator of bc7_maxq.npz: the JAX package's MAXQUALITY outputs that
tests/test_torch_bc7_maxq.py holds the PyTorch port's maxq tier against,
frozen so that the test runs no JAX (its live references took about 24 s
of the test run).

The batch is that test's: 200 random RGBA blocks (numpy seed 11, the
first half opaque) and 32x32 crops of corpus.npz's alphagrad ([16:48,
16:48]) and albedo ([:32, :32]) cut into blocks by the JAX package's
image_to_blocks. Keys:
  blocks [NB, 16, 4] f32 and px [16, 4, NB] int32 (texels 0..255);
  search, moment: the words [NB, 4] u32 that the JAX maxq encode_bc7 hands
    to its first (LADDER_MOMENT) and second (LADDER_FULL) refine, and the
    ladders and modes it passed (search_ladder, moment_ladder as reprs,
    refine_modes);
  encoded [NB, 16] u8: that encode's output;
  family4_err / family4_words, family5_err / family5_words: its modes-4/5
    family (_try_single_mode) per mode;
  full, light: refine_bc7_words of `search` at LADDER_FULL and
    LADDER_LIGHT, alpha weight 2.0, over (1, 3, 5, 6, 7, 4);
  quick_maxq [NB, 16] u8: encode_bc7(QUICK | MAXQUALITY), and the
    (ladder repr, modes) of its two refines (quick_ladders, quick_modes).
Run from the repository root (about a minute):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_bc7_maxq.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

MAXQ = 0x200000
QUICK = 0x100000
SCOPE = (1, 3, 5, 6, 7, 4)


def encode_recording(blocks, flags):
    """encode_bc7, recording what its search hands to each refine (words,
    ladder, modes) and its modes-4/5 family's (err, words) by mode."""
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67

    seen, family = [], {}
    orig_refine, orig_single = jbc67.refine_bc7_words, jbc67._try_single_mode

    def record(px_i, words, ladder, **kw):
        seen.append((np.asarray(words), ladder, kw.get("modes")))
        return orig_refine(px_i, words, ladder, **kw)

    def single(px_i, px_f, mode_id, **kw):
        out = orig_single(px_i, px_f, mode_id, **kw)
        family[mode_id] = tuple(np.asarray(o) for o in out)
        return out

    jbc67.refine_bc7_words, jbc67._try_single_mode = record, single
    try:
        out = np.asarray(jbc67.encode_bc7(jnp.asarray(blocks), flags=flags))
    finally:
        jbc67.refine_bc7_words = orig_refine
        jbc67._try_single_mode = orig_single
    return seen, family, out


def main() -> None:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67
    from directxtex_tpu.bc.common import image_to_blocks

    corpus = np.load(os.path.join(HERE, "corpus.npz"))
    rng = np.random.default_rng(11)
    mixed = rng.random((200, 16, 4)).astype(np.float32)
    mixed[:100, :, 3] = 1.0
    crops = [np.array(image_to_blocks(jnp.asarray(img))[0])
             for img in (corpus["alphagrad"][16:48, 16:48],
                         corpus["albedo"][:32, :32])]
    blocks = np.concatenate([mixed] + crops)
    px = np.clip(np.transpose(blocks, (1, 2, 0)) * np.float32(255.0)
                 + np.float32(0.01), 0, 255).astype(np.int32)
    seen, family, out = encode_recording(blocks, MAXQ)
    (search, lad0, modes0), (moment, lad1, modes1) = seen
    assert modes0 == modes1
    ref = {"blocks": blocks, "px": px, "search": search, "moment": moment,
           "encoded": out, "search_ladder": np.array(repr(lad0)),
           "moment_ladder": np.array(repr(lad1)),
           "refine_modes": np.array(modes0, np.int32)}
    for mode in (4, 5):
        ref[f"family{mode}_err"], ref[f"family{mode}_words"] = family[mode]
    words = jnp.asarray(search)
    for name, ladder in (("full", jbc67.LADDER_FULL),
                         ("light", jbc67.LADDER_LIGHT)):
        ref[name] = np.asarray(jbc67.refine_bc7_words(
            jnp.asarray(px), words, ladder, aw=2.0, modes=SCOPE))
    seen_q, _, ref["quick_maxq"] = encode_recording(blocks, QUICK | MAXQ)
    ref["quick_ladders"] = np.array([repr(s[1]) for s in seen_q])
    ref["quick_modes"] = np.array([s[2] for s in seen_q], np.int32)
    np.savez_compressed(os.path.join(HERE, "bc7_maxq.npz"), **ref)
    print("bc7_maxq.npz written:", sorted(ref))


if __name__ == "__main__":
    main()
