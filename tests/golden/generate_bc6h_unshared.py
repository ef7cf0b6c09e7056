"""Generator of bc6h_unshared.npz: the JAX package's jnp outputs that
tests/test_torch_bc6h_unshared.py holds the PyTorch port's
BC6H_SHARED_FIT=False search against, frozen because the eager JAX calls
take minutes on a CPU, past that module's time budget.

The batch, per signed: the 200-block random set of
benchmarks/verify_bc6h_tpu.py:41-52 (numpy seed 17; the first 40 signed
blocks sign-crossing bimodal), then 32x32 crops of the five HDR contents
of corpus.npz (64 blocks each), 520 blocks in all.

What is frozen, per signed (keys prefixed "u_" unsigned, "s_" signed):
  - k10_err, k10_words: rows 10-13, each through _bc6h_eval_candidate and
    _bc6h_emit, folded from (inf, zero words) with a strict `<`
    (tests/test_pallas.py:130-141);
  - picks [4, NB]: _top_k_shapes of _shape_estimates_table(RGB and a zero
    alpha plane, 1, 3, n_shapes=32, off_axis=True, axis_w=0.0), the
    ranking of the jnp search;
  - rows_<r..>_err, rows_<r..>_words for the row sets (2,) and every
    precision group of _bc6h_row_groups(): those rows over the picks, each
    (row, pick) through _bc6h_eval_candidate and _bc6h_emit, folded from
    (inf, zero words) with a strict `<`, rows outer (the jnp search's
    order);
  - search, mid: encode_bc6h with bc67.BC6H_SHARED_FIT set to False,
    flags 0 and _BC6H_MID;
  - shared: encode_bc6h with the flag at its shipped value (True).
And, keyed "corpus_<content>": encode_bc6h with the flag off on each
whole HDR corpus content (hdr_signed encoded signed, as
tests/test_golden.py gates it), the words the flag-off BC6H gates of
chip_smoke.py decode for the JAX package's own PSNR.
Words are [NB, 4] u32, encodes [NB, 16] u8. Run from the repository root:

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_bc6h_unshared.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

HDR = ("hdr", "hdr_china", "hdr_flower", "hdr_sun", "hdr_signed")
N_BIMODAL = 40
ROW_SETS = ((2,), (0,), (1,), (2, 3, 4), (5,), (6, 7, 8), (9,))


def random_set(signed: bool) -> np.ndarray:
    rng = np.random.default_rng(17)
    scale = 4.0 if signed else 8.0
    rgb = rng.random((200, 16, 3)).astype(np.float32) * scale
    if signed:
        rgb -= scale / 2
        rgb[:N_BIMODAL, 8:, :] += scale
        rgb[:N_BIMODAL, :8, :] -= scale
    return np.concatenate([rgb, np.ones((200, 16, 1), np.float32)], -1)


def make_batch(signed: bool) -> np.ndarray:
    import jax.numpy as jnp

    from directxtex_tpu.bc.common import image_to_blocks

    corpus = np.load(os.path.join(HERE, "corpus.npz"))
    crops = [np.asarray(image_to_blocks(jnp.asarray(corpus[c][:32, :32]))[0])
             for c in HDR]
    return np.concatenate([random_set(signed)] + crops)


def row_key(rows) -> str:
    return "rows_" + "".join(str(r) for r in rows)


def references(blocks: np.ndarray, signed: bool) -> dict:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67

    nb = blocks.shape[0]
    rgb = np.transpose(blocks[..., :3], (1, 2, 0))
    px_int = jbc67._f16_to_int(jnp.asarray(rgb), signed)
    px_f = px_int.astype(jnp.float32)
    out = {}

    def fold(cands):
        be = jnp.full((nb,), jnp.inf, jnp.float32)
        bw = jnp.zeros((nb, 4), jnp.uint32)
        for mask_list, anchors, row, shape in cands:
            err, pairs, idx = jbc67._bc6h_eval_candidate(
                px_int, px_f, mask_list, anchors, row, signed)
            words = jbc67._bc6h_emit(row, shape, pairs, idx, nb)
            bt = err < be
            be = jnp.minimum(err, be)
            bw = jnp.where(bt[:, None], words, bw)
        return np.asarray(be), np.asarray(bw)

    ones = jnp.ones((16, nb), bool)
    out["k10_err"], out["k10_words"] = fold(
        [([ones], [0], row, 0) for row in range(10, 14)])

    px4 = jnp.concatenate([px_f, jnp.zeros((16, 1, nb), jnp.float32)], axis=1)
    ests = jbc67._shape_estimates_table(px4, 1, 3, n_shapes=32,
                                        off_axis=True, axis_w=0.0)
    picks = jbc67._top_k_shapes(ests, jbc67.BC7_SHAPE_CANDIDATES)
    out["picks"] = np.stack([np.asarray(p) for p in picks]).astype(np.int32)

    parts_tab = jnp.asarray(jbc67.PARTITIONS[1])
    fix_tab = jnp.asarray(jbc67.FIXUPS[1])
    cand_masks = []
    for s_blk in picks:
        pmask = parts_tab[s_blk].T
        cand_masks.append(([pmask == 0, pmask == 1],
                           [0, fix_tab[s_blk, 1].astype(jnp.int32)],
                           s_blk.astype(jnp.uint32)))
    for rows in ROW_SETS:
        err, words = fold([(ml, an, row, shape) for row in rows
                           for ml, an, shape in cand_masks])
        out[row_key(rows) + "_err"], out[row_key(rows) + "_words"] = \
            err, words

    x = jnp.asarray(blocks)
    out["shared"] = np.asarray(jbc67.encode_bc6h(x, signed))
    saved = jbc67.BC6H_SHARED_FIT
    jbc67.BC6H_SHARED_FIT = False
    try:
        out["search"] = np.asarray(jbc67.encode_bc6h(x, signed))
        out["mid"] = np.asarray(jbc67.encode_bc6h(x, signed,
                                                  jbc67._BC6H_MID))
    finally:
        jbc67.BC6H_SHARED_FIT = saved
    return out


def corpus_encodes() -> dict:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67
    from directxtex_tpu.bc.common import image_to_blocks

    corpus = np.load(os.path.join(HERE, "corpus.npz"))
    out = {}
    saved = jbc67.BC6H_SHARED_FIT
    jbc67.BC6H_SHARED_FIT = False
    try:
        for c in HDR:
            blocks = image_to_blocks(jnp.asarray(corpus[c]))[0]
            out["corpus_" + c] = np.asarray(jbc67.encode_bc6h(
                blocks, c == "hdr_signed"))
    finally:
        jbc67.BC6H_SHARED_FIT = saved
    return out


def main() -> None:
    out = {}
    for signed in (False, True):
        blocks = make_batch(signed)
        pre = "s_" if signed else "u_"
        out[pre + "blocks"] = blocks
        for k, v in references(blocks, signed).items():
            out[pre + k] = v
    out.update(corpus_encodes())
    np.savez_compressed(os.path.join(HERE, "bc6h_unshared.npz"), **out)
    print("bc6h_unshared.npz written:", sorted(out))


if __name__ == "__main__":
    main()
