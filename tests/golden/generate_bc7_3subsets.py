"""Generator of bc7_3subsets.npz: the JAX package's jnp outputs that
tests/test_torch_bc7_3subsets.py holds the PyTorch port's USE_3SUBSETS
twins against, frozen because the eager JAX calls take about 45 s on a
CPU, past that module's time budget.

The batch, 256 blocks:
  - 64 synthetic blocks: each takes a random three-subset shape of
    PARTITIONS[2]; each subset is a gradient between two random colours
    along its own random direction across the block, with a little
    noise (numpy seed 23), opaque. Modes 0 and 2 win most of these;
  - 32x32 crops of corpus.npz's albedo and photo_china (opaque);
  - the 32x32 crop [16:48, 16:48] of alphagrad (with alpha).

What is frozen, from the JAX package's encode_bc7 with flags 0x80000 and
0x280000 at alpha weights 1.0 and 2.0 (four calls, each recording the
words its search hands to each refine), the three-subset estimate table
and modes 0 and 2's (err, words) that its jnp search computed, the top-4
picks of that table over 16 and 64 shapes, and refine_bc7_words over
modes (0, 2) alone at alpha weight 2.0, MOMENT then LADDER_LIGHT, from
the weight-2.0 search's words. Run from the repository root:

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_bc7_3subsets.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

USE3, MAXQ = 0x80000, 0x200000
FLAGS = (USE3, USE3 | MAXQ)
AWS = (1.0, 2.0)


def three_gradient_blocks(nb: int = 64, seed: int = 23) -> np.ndarray:
    from directxtex_tpu.bc.bc67_tables import PARTITIONS

    rng = np.random.default_rng(seed)
    yy, xx = np.divmod(np.arange(16), 4)
    pos = np.stack([xx, yy], axis=1).astype(np.float32) / 3.0
    blocks = np.empty((nb, 16, 4), np.float32)
    blocks[..., 3] = 1.0
    for b in range(nb):
        shape = PARTITIONS[2][rng.integers(64)]
        for p in range(3):
            c0, c1 = rng.random(3), rng.random(3)
            ang = rng.random() * 2 * np.pi
            t = pos @ np.array([np.cos(ang), np.sin(ang)])
            t = (t - t.min()) / max(np.ptp(t), 1e-6)
            px = c0[None, :] + t[:, None] * (c1 - c0)[None, :]
            px += (rng.random((16, 3)) - 0.5) * 0.02
            blocks[b, shape == p, :3] = px[shape == p]
    blocks[..., :3] = np.clip(blocks[..., :3], 0, 1)
    return blocks


def make_batch() -> np.ndarray:
    import jax.numpy as jnp

    from directxtex_tpu.bc.common import image_to_blocks

    corpus = np.load(os.path.join(HERE, "corpus.npz"))
    crops = [corpus["albedo"][:32, :32], corpus["photo_china"][:32, :32],
             corpus["alphagrad"][16:48, 16:48]]
    return np.concatenate([three_gradient_blocks()] + [
        np.asarray(image_to_blocks(jnp.asarray(c))[0]) for c in crops])


def encode_recording(blocks, flags, aw):
    """encode_bc7, recording the words its search hands to each refine
    (with the ladder and the modes), its three-subset estimate table and
    modes 0 and 2's (err, words)."""
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67

    seen, rec = [], {}
    orig = (jbc67.refine_bc7_words, jbc67._shape_estimates_table,
            jbc67._try_partition_mode)

    def refine(px_i, words, ladder, **kw):
        seen.append((np.asarray(words), ladder, kw.get("modes")))
        return orig[0](px_i, words, ladder, **kw)

    def table(px_f, partitions, *a, **kw):
        out = orig[1](px_f, partitions, *a, **kw)
        if partitions == 2:
            rec["table"] = np.asarray(out)
        return out

    def mode(px_i, px_f, mode_id, **kw):
        out = orig[2](px_i, px_f, mode_id, **kw)
        if mode_id in (0, 2):
            rec[mode_id] = tuple(np.asarray(o) for o in out)
        return out

    (jbc67.refine_bc7_words, jbc67._shape_estimates_table,
     jbc67._try_partition_mode) = refine, table, mode
    try:
        out = np.asarray(jbc67.encode_bc7(jnp.asarray(blocks), flags=flags,
                                          alpha_weight=aw))
    finally:
        (jbc67.refine_bc7_words, jbc67._shape_estimates_table,
         jbc67._try_partition_mode) = orig
    return seen, rec, out


def main() -> None:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67

    blocks = make_batch()
    px = np.clip(np.transpose(blocks, (1, 2, 0)) * np.float32(255.0)
                 + np.float32(0.01), 0, 255).astype(np.int32)
    out = {"blocks": blocks}
    for flags in FLAGS:
        maxq = bool(flags & MAXQ)
        scope = tuple(m for m in (0, 2, 1, 3, 5, 6, 7, 4) if maxq or m != 6)
        ladders = ((jbc67.LADDER_MOMENT, jbc67.LADDER_FULL) if maxq
                   else (jbc67.LADDER_MOMENT,))
        for aw in AWS:
            seen, rec, enc = encode_recording(blocks, flags, aw)
            assert [(s[1], s[2]) for s in seen] == [(lad, scope)
                                                    for lad in ladders]
            key = f"{'maxq' if maxq else 'default'}_aw{aw:g}"
            out[f"{key}_search"] = seen[0][0]
            if maxq:
                out[f"{key}_moment"] = seen[1][0]
            out[f"{key}_encoded"] = enc
            if not maxq and aw == 1.0:
                out["table"] = rec["table"]
                for m in (0, 2):
                    out[f"mode{m}_err"], out[f"mode{m}_words"] = rec[m]
    for n in (16, 64):
        out[f"picks{n}"] = np.stack([np.asarray(p) for p in jbc67._top_k_shapes(
            jnp.asarray(out["table"][:n]), 4)]).astype(np.int32)
    words = jnp.asarray(out["default_aw2_search"])
    for name, ladder in (("moment", jbc67.LADDER_MOMENT),
                         ("light", jbc67.LADDER_LIGHT)):
        words = jbc67.refine_bc7_words(jnp.asarray(px), words, ladder,
                                       aw=2.0, modes=(0, 2))
        out[f"alone_aw2_{name}"] = np.asarray(words)
    np.savez_compressed(os.path.join(HERE, "bc7_3subsets.npz"), **out)
    print("bc7_3subsets.npz written:", sorted(out))


if __name__ == "__main__":
    main()
