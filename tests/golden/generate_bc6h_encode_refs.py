"""Generator of bc6h_encode_refs.npz: the JAX package's outputs that
tests/test_torch_bc6h_encode.py holds the port's BC6H encode steps
against, on the inputs that test draws (its helpers), frozen so that the
test runs no JAX call (it took 26 s of the tier-1 run).

Keys, per signedness (prefix "u_" unsigned, "s_" signed):

- f16_to_int: _f16_to_int of the 4,096 values of _f16_inputs();
- px: _f16_to_int of _rgb_lane(signed), the F16-int pixels [16, 3, 64]
  of the float-step tests;
- quantize{p}, unquantize{p} (p in PRECS), finish, unquantize_dyn,
  quantize_dyn: the quantize steps on _quant_inputs(signed);
- fit{row}_err, fit{row}_pairs ([n_regions, 2, 3, 64]), fit{row}_words
  ([64, 4] u32) for rows 0-13: _bc6h_transform_fit_t on _fit_inputs and
  _bc6h_emit of its pairs;
- shared_fit0, shared_fit1 ([n_regions, 2, 3, 64]): _bc6h_shared_fit of
  px on _shared_fit_cases (two-region, one-region);
- rescore{row}_shared, _err, _pairs, _idx for the rows of RESCORE_ROWS:
  _bc6h_shared_fit and _bc6h_group_rescore on _rescore_case(row);
- shape_table ([32, 64]) and shape_picks ([4, 64]): the 32-shape off-axis
  table at axis_w 0 of px with a zero alpha plane, and its top 4.

Run from the repository root (about half a minute):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_bc6h_encode_refs.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> None:
    import jax.numpy as jnp

    from directxtex_tpu.bc import bc67 as jbc67
    from test_torch_bc6h_encode import (PRECS, RESCORE_ROWS, _f16_inputs,
                                        _fit_inputs, _quant_inputs,
                                        _rescore_case, _rgb_lane,
                                        _shared_fit_cases)

    def stack(pairs):
        return np.stack([np.stack([np.asarray(q) for q in p])
                         for p in pairs])

    out = {}
    for signed in (False, True):
        pre = "s_" if signed else "u_"
        out[pre + "f16_to_int"] = np.asarray(jbc67._f16_to_int(
            jnp.asarray(_f16_inputs()), signed))
        px = np.asarray(jbc67._f16_to_int(jnp.asarray(_rgb_lane(signed)),
                                          signed))
        out[pre + "px"] = px
        nb = px.shape[2]
        x = _quant_inputs(signed)
        v = jnp.asarray(x["v"])
        for prec in PRECS:
            out[pre + f"quantize{prec}"] = np.asarray(
                jbc67._bc6h_quantize(v, prec, signed))
            out[pre + f"unquantize{prec}"] = np.asarray(
                jbc67._bc6h_unquantize(jnp.asarray(x[f"c{prec}"]), prec,
                                       signed))
        out[pre + "finish"] = np.asarray(jbc67._bc6h_finish_unquantize(
            jnp.asarray(x["u"]), signed))
        p = jnp.asarray(x["p"])
        out[pre + "unquantize_dyn"] = np.asarray(jbc67._bc6h_unquantize_dyn(
            jnp.asarray(x["cd"]), p, signed))
        out[pre + "quantize_dyn"] = np.asarray(jbc67._bc6h_quantize_dyn(
            v, p, signed))
        for row, (pairs, err, shape, idx) in enumerate(_fit_inputs(signed,
                                                                   nb)):
            key = f"{pre}fit{row}_"
            r_err, r_pairs = jbc67._bc6h_transform_fit_t(
                [tuple(jnp.asarray(q) for q in p) for p in pairs],
                jnp.asarray(err), row, signed, nb)
            out[key + "err"] = np.asarray(r_err)
            out[key + "pairs"] = stack(r_pairs)
            parts = jbc67.BC6H_MODE_INFO[row][1]
            out[key + "words"] = np.asarray(jbc67._bc6h_emit(
                row, jnp.asarray(shape) if parts else 0,
                [tuple(jnp.asarray(np.asarray(q)) for q in p)
                 for p in r_pairs], jnp.asarray(idx), nb))
        pxf = jnp.asarray(px, jnp.float32)
        for case, (masks, iprec) in enumerate(_shared_fit_cases(nb)):
            out[f"{pre}shared_fit{case}"] = stack(jbc67._bc6h_shared_fit(
                pxf, [jnp.asarray(m) for m in masks], iprec, signed))
        for row in RESCORE_ROWS:
            key = f"{pre}rescore{row}_"
            masks, anchors = _rescore_case(row, nb)
            iprec = jbc67.BC6H_MODE_INFO[row][3]
            shared = jbc67._bc6h_shared_fit(
                pxf, [jnp.asarray(m) for m in masks], iprec, signed)
            r_err, r_pairs, r_idx = jbc67._bc6h_group_rescore(
                jnp.asarray(px), [jnp.asarray(m) for m in masks],
                [a if isinstance(a, int) else jnp.asarray(a)
                 for a in anchors], shared, row, signed)
            out[key + "shared"] = stack(shared)
            out[key + "err"] = np.asarray(r_err)
            out[key + "pairs"] = stack(r_pairs)
            out[key + "idx"] = np.asarray(r_idx)
        px4 = np.concatenate([px.astype(np.float32),
                              np.zeros_like(px[:, :1], np.float32)], axis=1)
        table = np.asarray(jbc67._shape_estimates_table(
            jnp.asarray(px4), 1, 3, n_shapes=32, off_axis=True, axis_w=0.0))
        out[pre + "shape_table"] = table
        out[pre + "shape_picks"] = np.stack(
            [np.asarray(s) for s in jbc67._top_k_shapes(jnp.asarray(table),
                                                        4)])
    np.savez_compressed(os.path.join(HERE, "bc6h_encode_refs.npz"), **out)
    print("bc6h_encode_refs.npz written:", len(out), "arrays")


if __name__ == "__main__":
    main()
