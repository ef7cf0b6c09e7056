"""Generator of jax_refs.npz: JAX package outputs that the PyTorch port's
tests used to compute live, frozen so that those tests run no JAX call
(each took several seconds to tens of seconds of the tier-1 run).

What is frozen, per test:

- tests/test_torch_bc7_encode.py, on its contents (32x32 crops of
  corpus.npz's albedo and photo_china cut into blocks by the JAX
  package's image_to_blocks, and its 64 noisy blocks half with alpha,
  numpy seed 19):
    enc_{name}_px                  [16, 4, NB] int32 texels;
    enc_{name}_table, _picks       the two-subset estimate table
                                   (_shape_estimates_table(px_f, 1, 4,
                                   off_axis=True)) and its top-4 picks;
    enc_{name}_mode{m}             [NB, 4] u32 words of modes 1 and 3
                                   (_try_2sub_modes_shared), 6
                                   (_try_single_mode) and 4 and 5
                                   (_try_modes45_shared);
    enc_{name}_refine_in, _refine  the port's default search words
                                   (bc7_search_words) and the JAX
                                   package's LADDER_MOMENT refine of them
                                   over (1, 3, 5, 4).
- tests/test_torch_bc7_slice.py: slice_{content} the JAX package's
  encode_bc7(opaque=True) [NB, 16] u8 of a 32x32 crop of each opaque
  corpus content, and slice_default the default call on albedo's.
- tests/test_torch_pipelines.py: for run_all.py's input at a small face
  (equirect 16x32, numpy seed 2, x4.0), cubemap_blocks the blocks the
  JAX hdr_cubemap_pipeline hands to encode_bc6h, cubemap_ref its words
  [24, 16] u8 and cubemap_px_int their F16-int pixels [16, 3, NB].
- tests/test_torch_bc6h_refine.py, per signed ("u" / "s") on its 64
  random HDR blocks: refine6_{u,s}_words the port's encode_bc6h words it
  refines, _px_int the JAX package's F16-int pixels, and the JAX
  package's refine_bc6h_words of those words: _mid (BC6H_LADDER_MID,
  remap), _light_cross2 (BC6H_LADDER_LIGHT, remap, cross2) and _fixed
  (BC6H_LADDER_FULL without remap).
- tests/test_torch_3sub_team.py, on the batch of bc7_3subsets.npz:
  k7_picks2 the two-subset top-4 picks of the JAX search's table, and
  k7_mode{m}_aw{w}_err / _words: _try_partition_mode's jnp evaluation of
  modes 1, 3 and 7 on those picks and of modes 0 and 2 on
  bc7_3subsets.npz's picks16 / picks64, at alpha weights 1.0 and 2.0.

Run from the repository root (about two minutes):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_jax_refs.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(HERE))

OPAQUE = ("albedo", "tworegion", "normal", "photo_china", "photo_flower")


def bc7_encode_refs(out: dict, corpus) -> None:
    import jax.numpy as jnp
    import torch

    from directxtex_tpu.bc import bc67 as jbc67
    from directxtex_tpu_torch.bc import bc67
    from test_torch_bc7_encode import _contents

    for name, (_, px) in _contents(corpus).items():
        pre = f"enc_{name}_"
        pj = jnp.asarray(px)
        pjf = pj.astype(jnp.float32)
        out[pre + "px"] = px
        table = jbc67._shape_estimates_table(pjf, 1, 4, off_axis=True)
        out[pre + "table"] = np.asarray(table)
        out[pre + "picks"] = np.stack([np.asarray(s) for s in
                                       jbc67._top_k_shapes(table, 4)])
        fam = jbc67._try_2sub_modes_shared(pj, pjf, (1, 3), table)
        fam[6] = jbc67._try_single_mode(pj, pjf, 6)
        fam.update(jbc67._try_modes45_shared(pj, pjf))
        for mode in (1, 3, 6, 4, 5):
            out[pre + f"mode{mode}"] = np.asarray(fam[mode][1])
        nb = px.shape[2]
        _, words = bc67.bc7_search_words(
            torch.from_numpy(px).reshape(64, nb).contiguous())
        w_nb4 = words.t().contiguous().numpy().view(np.uint32)
        out[pre + "refine_in"] = w_nb4
        out[pre + "refine"] = np.asarray(jbc67.refine_bc7_words(
            pj, jnp.asarray(w_nb4), jbc67.LADDER_MOMENT, modes=(1, 3, 5, 4)))


def bc7_slice_refs(out: dict, corpus) -> None:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67
    from test_torch_bc7_encode import _pixels

    for content in OPAQUE:
        blocks, _ = _pixels(corpus[content][:32, :32])
        out[f"slice_{content}"] = np.asarray(
            jbc67.encode_bc7(jnp.asarray(blocks), opaque=True))
    blocks, _ = _pixels(corpus["albedo"][:32, :32])
    out["slice_default"] = np.asarray(jbc67.encode_bc7(jnp.asarray(blocks)))


def cubemap_refs(out: dict) -> None:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67
    from directxtex_tpu.models import pipelines as jpipelines

    eq = (np.random.default_rng(2).random((16, 32, 4)).astype(np.float32)
          * 4.0)
    seen = {}
    encode = jbc67.encode_bc6h

    def capture(blocks, signed):
        seen["blocks"] = np.asarray(blocks)
        return encode(blocks, signed)

    jbc67.encode_bc6h = capture
    try:
        ref = np.concatenate([np.asarray(f) for f in
                              jpipelines.hdr_cubemap_pipeline()(
                                  jnp.asarray(eq))])
    finally:
        jbc67.encode_bc6h = encode
    out["cubemap_blocks"] = seen["blocks"]
    out["cubemap_ref"] = ref
    out["cubemap_px_int"] = np.asarray(jbc67._f16_to_int(jnp.asarray(
        np.transpose(seen["blocks"][..., :3], (1, 2, 0))), False))


def bc6h_refine_refs(out: dict) -> None:
    import jax.numpy as jnp
    import torch

    from directxtex_tpu.bc import bc67 as jbc67
    from directxtex_tpu_torch.bc import bc6h
    from test_torch_bc6h_refine import _blocks

    for signed in (False, True):
        pre = f"refine6_{'s' if signed else 'u'}_"
        blocks = _blocks(signed)
        nb = blocks.shape[0]
        words = bc6h.encode_bc6h(torch.from_numpy(blocks), signed).numpy() \
            .view(np.uint32).reshape(nb, 4)
        px_int = np.array(jbc67._f16_to_int(
            jnp.asarray(np.transpose(blocks[..., :3], (1, 2, 0))), signed))
        out[pre + "words"] = words
        out[pre + "px_int"] = px_int
        for name, ladder, remap, cross2 in (
                ("mid", jbc67.BC6H_LADDER_MID, True, False),
                ("light_cross2", jbc67.BC6H_LADDER_LIGHT, True, True),
                ("fixed", jbc67.BC6H_LADDER_FULL, False, False)):
            out[pre + name] = np.asarray(jbc67.refine_bc6h_words(
                jnp.asarray(px_int), jnp.asarray(words), ladder, signed,
                remap=remap, cross2=cross2))


def k7_refs(out: dict) -> None:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67

    sub3 = np.load(os.path.join(HERE, "bc7_3subsets.npz"))
    blocks = sub3["blocks"]
    px = np.clip(np.transpose(blocks, (1, 2, 0)) * np.float32(255.0)
                 + np.float32(0.01), 0, 255).astype(np.int32)
    pj = jnp.asarray(px)
    pjf = pj.astype(jnp.float32)
    ests = {1: jbc67._shape_estimates_table(pjf, 1, 4, off_axis=True),
            2: jnp.asarray(sub3["table"])}
    out["k7_picks2"] = np.stack([np.asarray(s) for s in
                                 jbc67._top_k_shapes(ests[1], 4)]) \
        .astype(np.int32)
    for mode, parts in ((0, 2), (2, 2), (1, 1), (3, 1), (7, 1)):
        for aw in (1.0, 2.0):
            err, words = jbc67._try_partition_mode(pj, pjf, mode,
                                                   ests=ests[parts], aw=aw)
            key = f"k7_mode{mode}_aw{aw:g}"
            out[key + "_err"] = np.asarray(err)
            out[key + "_words"] = np.asarray(words)


def main() -> None:
    corpus = np.load(os.path.join(HERE, "corpus.npz"))
    out: dict = {}
    bc7_encode_refs(out, corpus)
    bc7_slice_refs(out, corpus)
    cubemap_refs(out)
    bc6h_refine_refs(out)
    k7_refs(out)
    np.savez_compressed(os.path.join(HERE, "jax_refs.npz"), **out)
    print("jax_refs.npz written:", sorted(out))


if __name__ == "__main__":
    main()
