"""What each CUDA kernel's function needs, in elementwise operations per
4x4 block: the counts behind chip_smoke.py's `bound_ms` (its *_OPS
constants). Run as a script to print them:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_op_counts.py

The counts come from the JAX twins' jaxprs, one operation per output
element of every elementwise primitive as `benchmarks/roofline.py
--flops` counts, tightened to the work the function needs rather than
what a lane-parallel TPU twin computes:

- an operation whose inputs are all known when the function is traced
  (tables, all-true masks, fixed precisions) is folded and costs nothing;
- a select on a known predicate, a multiply by a known 1, an add or
  subtract of a known 0, an `and` with a known true and a min (max) with
  a known +inf (-inf) cost nothing: that is the twins' lane masking;
- a product with a known matrix costs one add per entry equal to 1 and
  two per other nonzero entry, times the other operand's free size (the
  shape table's 0/1 mask matmul);
- a two-region candidate's per-pixel work is counted over its subsets'
  own pixels, 16 in all: the subset fits are traced on two 8-pixel
  subsets with all-true masks (the cost is linear in the pixel count, so
  any split of the 16 gives the same total); a three-region candidate
  (modes 0 and 2) the same way on subsets of 5, 5 and 6 pixels;
- the decoders and the refines do one mode's (one unit's) work per
  block, so they are counted per mode, mode row or winner class, and
  chip_smoke.py weighs each count by the blocks of its run that have it.

The tests pin the counting rules on small functions."""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.core import Literal

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu.bc.bc67_tables import BC6H_MODE_INFO, FIXUPS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NB = 256          # blocks traced; every count is divided by it

# benchmarks/roofline.py's elementwise primitives
_ARITH = {"add", "sub", "mul", "div", "max", "min", "neg", "abs",
          "floor", "round", "sign", "integer_pow", "pow", "rsqrt",
          "sqrt", "exp", "log", "and", "or", "xor", "not",
          "shift_left", "shift_right_logical", "shift_right_arithmetic",
          "rem", "select_n", "eq", "ne", "lt", "le", "gt", "ge",
          "nextafter", "clamp"}


def _all(x, c) -> bool:
    return x is not None and bool(np.all(x == c))


def _eval(eqn, ins):
    subfuns, params = eqn.primitive.get_bind_params(eqn.params)
    out = eqn.primitive.bind(*subfuns, *[jnp.asarray(x) for x in ins],
                             **params)
    outs = out if eqn.primitive.multiple_results else [out]
    return [np.asarray(o) for o in outs]


def _cost(eqn, ins) -> float:
    name = eqn.primitive.name

    def size(v):
        return float(np.prod(v.aval.shape)) or 1.0

    if name == "dot_general":
        (lc, rc), (lb, _) = eqn.params["dimension_numbers"]
        lhs, rhs = eqn.invars
        if not lb and (ins[0] is not None or ins[1] is not None):
            known, other, oc = ((ins[0], rhs, rc) if ins[0] is not None
                                else (ins[1], lhs, lc))
            free = float(np.prod([n for d, n in enumerate(other.aval.shape)
                                  if d not in oc]))
            ones = float(np.sum(known == 1))
            rest = float(np.sum((known != 0) & (known != 1)))
            return (ones + 2.0 * rest) * free
        k = float(np.prod([lhs.aval.shape[d] for d in lc]))
        return 2.0 * size(eqn.outvars[0]) * k
    if name in ("reduce_sum", "reduce_max", "reduce_min"):
        return size(eqn.invars[0])
    if name not in _ARITH:
        return 0.0
    is_bool = [x is not None and x.dtype == np.bool_ for x in ins]
    if name == "select_n" and ins[0] is not None:
        return 0.0
    if name == "mul" and any(_all(x, 1) for x in ins):
        return 0.0
    if name == "add" and any(_all(x, 0) for x in ins):
        return 0.0
    if name == "sub" and _all(ins[1], 0):
        return 0.0
    if name == "and" and any(b and _all(x, True) for b, x in zip(is_bool,
                                                                  ins)):
        return 0.0
    if name == "or" and any(b and _all(x, False) for b, x in zip(is_bool,
                                                                  ins)):
        return 0.0
    if name == "min" and any(_all(x, np.inf) for x in ins):
        return 0.0
    if name == "max" and any(_all(x, -np.inf) for x in ins):
        return 0.0
    return sum(size(o) for o in eqn.outvars)


def _walk(jaxpr, consts, known_in, tighten=True):
    """(operations, known output values) of a jaxpr whose inputs are
    known where known_in holds an array, unknown where it holds None.
    tighten=False knows nothing: roofline.py's plain count."""
    env = {v: np.asarray(c) for v, c in zip(jaxpr.constvars, consts)}
    env.update({v: k for v, k in zip(jaxpr.invars, known_in)
                if k is not None})

    def val(a):
        if not tighten:
            return None
        if isinstance(a, Literal):
            return np.asarray(a.val, dtype=a.aval.dtype)
        return env.get(a)

    total = 0.0
    for eqn in jaxpr.eqns:
        ins = [val(a) for a in eqn.invars]
        subs = [p for p in eqn.params.values() if hasattr(p, "consts")]
        subs += [s for p in eqn.params.values()
                 if isinstance(p, (list, tuple))
                 for s in p if hasattr(s, "consts")]
        if all(x is not None for x in ins):
            outs = _eval(eqn, ins)
        elif len(subs) == 1 and eqn.primitive.name in (
                "jit", "pjit", "closed_call", "custom_jvp_call",
                "custom_vjp_call", "remat", "checkpoint"):
            ops, outs = _walk(subs[0].jaxpr, subs[0].consts, ins, tighten)
            total += ops
        else:
            for s in subs:      # loops and branches: nothing known inside
                total += _walk(s.jaxpr, s.consts,
                               [None] * len(s.jaxpr.invars), tighten)[0]
            total += _cost(eqn, ins)
            outs = [None] * len(eqn.outvars)
        for v, o in zip(eqn.outvars, outs):
            if o is not None:
                env[v] = o
    return total, [val(v) for v in jaxpr.outvars]


def needed_ops(fn, *args, tighten: bool = True) -> float:
    """Operations `fn` needs on unknown inputs shaped like `args`."""
    closed = jax.make_jaxpr(fn)(*args)
    return _walk(closed.jaxpr, closed.consts,
                 [None] * len(closed.jaxpr.invars), tighten)[0]


@contextlib.contextmanager
def _patched(**fns):
    old = {k: getattr(jbc67, k) for k in fns}
    for k, f in fns.items():
        setattr(jbc67, k, f)
    try:
        yield
    finally:
        for k, f in old.items():
            setattr(jbc67, k, f)


def _ones8(nb):
    return jnp.ones((8, nb), bool)


def _widen(idx):
    """An 8-pixel subset's index plane stands for both subsets' 16."""
    return jnp.concatenate([idx, idx])


# -- the two-region helpers on two 8-pixel subsets -------------------------
_ORIG = {k: getattr(jbc67, k) for k in (
    "_bc6h_shared_fit", "_bc6h_group_rescore", "_eval_2sub_shared",
    "_eval_subset_candidate", "_moment_channels_t", "_perturb_channels_t",
    "_assign_indices_t", "_bc6h_eval_candidate")}


def _shared_fit8(px_f, mask_list, iprec, signed):
    f = _ORIG["_bc6h_shared_fit"]
    if len(mask_list) == 1:
        return f(px_f, mask_list, iprec, signed)
    return f(px_f[:8], [_ones8(px_f.shape[2])] * 2, iprec, signed)


def _group_rescore8(px_int, mask_list, anchors, shared, row, signed):
    f = _ORIG["_bc6h_group_rescore"]
    if len(mask_list) == 1:
        return f(px_int, mask_list, anchors, shared, row, signed)
    terr, fixed, idx = f(px_int[:8], [_ones8(px_int.shape[2])] * 2, [0, 0],
                         shared, row, signed)
    return terr, fixed, _widen(idx)


def _bc6h_eval8(px_int, px_f, row, signed):
    """_bc6h_eval_candidate of a two-region row on two 8-pixel subsets."""
    err, pairs, idx = _ORIG["_bc6h_eval_candidate"](
        px_int[:8], px_f[:8], [_ones8(px_int.shape[2])] * 2, [0, 0], row,
        signed)
    return err, pairs, _widen(idx)


def _eval_2sub8(px_i, px_f, mask_list, anchors, mode_ids, aw=1.0):
    out = _ORIG["_eval_2sub_shared"](px_i[:8], px_f[:8],
                                     [_ones8(px_i.shape[2])] * 2, [0, 0],
                                     mode_ids, aw=aw)
    return {m: v[:5] + (_widen(v[5]),) for m, v in out.items()}


def _eval_subset8(px_i, px_f, mask_list, anchors, mode_id, aw=1.0):
    f = _ORIG["_eval_subset_candidate"]
    if len(mask_list) == 1:
        return f(px_i, px_f, mask_list, anchors, mode_id, aw=aw)
    out = f(px_i[:8], px_f[:8], [_ones8(px_i.shape[2])] * 2, [0, 0],
            mode_id, aw=aw)
    return out[:5] + (_widen(out[5]),)


def _moment8(px_i, mask, m, shared_p, q0, q1, p0, p1, wk_ch, **kw):
    return _ORIG["_moment_channels_t"](
        px_i[:8], _ones8(px_i.shape[2]), m, shared_p, q0, q1, p0, p1,
        [w[:8] for w in wk_ch], **kw)


def _perturb8(px_i, mask, m, shared_p, q0, q1, p0, p1, wk_ch, **kw):
    return _ORIG["_perturb_channels_t"](
        px_i[:8], _ones8(px_i.shape[2]), m, shared_p, q0, q1, p0, p1,
        [w[:8] for w in wk_ch], **kw)


def _assign8(px_i, u0, u1, prec, mask, *a, **kw):
    idx, err = _ORIG["_assign_indices_t"](px_i[:8], u0, u1, prec,
                                          _ones8(px_i.shape[2]), *a, **kw)
    return _widen(idx), err


# -- the three-region helpers on subsets of 5, 5 and 6 pixels ----------------
_SPLIT3 = ((0, 5), (5, 10), (10, 16))


def _widen16(idx):
    """A subset's index plane stands for all 16 pixels."""
    return jnp.concatenate([idx] * (-(-16 // idx.shape[0])))[:16]


def _eval_subset_split(px_i, px_f, mask_list, anchors, mode_id, aw=1.0):
    """_eval_subset8, and for three subsets one single-subset evaluation
    per (5, 5, 6)-pixel slice: per-subset fits and anchor swaps over the
    subsets' own 16 pixels, and two adds of their errors."""
    if len(mask_list) != 3:
        return _eval_subset8(px_i, px_f, mask_list, anchors, mode_id, aw)
    f = _ORIG["_eval_subset_candidate"]
    err, q0s, q1s, p0s, p1s, idx = 0.0, [], [], [], [], []
    for lo, hi in _SPLIT3:
        e, q0, q1, p0, p1, ix = f(px_i[lo:hi], px_f[lo:hi],
                                  [jnp.ones((hi - lo, px_i.shape[2]), bool)],
                                  [0], mode_id, aw=aw)
        err = err + e
        q0s, q1s, p0s, p1s = q0s + q0, q1s + q1, p0s + p0, p1s + p1
        idx.append(ix)
    return err, q0s, q1s, p0s, p1s, jnp.concatenate(idx)


def _cycling(fn):
    """One subset's refine step on the next (5, 5, 6)-pixel slice: the
    refine calls it once per subset, in subset order."""
    state = {"k": 0}

    def sliced(px_i, *a, **kw):
        lo, hi = _SPLIT3[state["k"] % 3]
        state["k"] += 1
        return fn(px_i[lo:hi], hi - lo, *a, **kw)
    return sliced


def _moment3(p, n, mask, m, shared_p, q0, q1, p0, p1, wk_ch, **kw):
    return _ORIG["_moment_channels_t"](
        p, jnp.ones((n, p.shape[2]), bool), m, shared_p, q0, q1, p0, p1,
        [w[:n] for w in wk_ch], **kw)


def _perturb3(p, n, mask, m, shared_p, q0, q1, p0, p1, wk_ch, **kw):
    return _ORIG["_perturb_channels_t"](
        p, jnp.ones((n, p.shape[2]), bool), m, shared_p, q0, q1, p0, p1,
        [w[:n] for w in wk_ch], **kw)


def _assign3(p, n, u0, u1, prec, mask, *a, **kw):
    idx, err = _ORIG["_assign_indices_t"](p, u0, u1, prec,
                                          jnp.ones((n, p.shape[2]), bool),
                                          *a, **kw)
    return _widen16(idx), err


# -- inputs ------------------------------------------------------------------
def _ldr_blocks(nb):
    rng = np.random.default_rng(0)
    b = rng.random((nb, 16, 4)).astype(np.float32)
    b[..., 3] = 1.0
    return jnp.asarray(b)


def _hdr_blocks(nb):
    rng = np.random.default_rng(0)
    return jnp.asarray(rng.random((nb, 16, 4)).astype(np.float32) * 8.0)


def _words(nb):
    return jnp.zeros((4, nb), jnp.uint32)


# -- the kernels --------------------------------------------------------------
def _quantize(x):
    px_i = jnp.clip(jnp.transpose(x, (1, 2, 0)) * 255.0 + 0.01,
                    0.0, 255.0).astype(jnp.int32)
    return px_i, px_i.astype(jnp.float32)


def bc7_search_ops(variant: str = "opaque") -> float:
    """K2: a tier's search, from the [64, NB] texels (the LDR quantization
    is the wrapper's, outside the kernel). "opaque": the default tier's
    (1, 3, 5, 6, 4) search; "quick": mode 6 alone; "maxq": the maxq
    tier's (1, 3, 5, 6, 4) search (every mode fitted on its own). With
    mode 7 either search is followed by mode 7's launch, which costs
    BC7_PARTITION_OPS[7] a block with alpha."""
    b = _ldr_blocks(NB)
    kwargs = {"opaque": {"opaque": True},
              "quick": {"flags": jbc67._BC7_QUICK},
              "maxq": {"flags": jbc67._BC7_MAXQUALITY, "opaque": True}}[
                  variant]
    with _patched(refine_bc7_words=lambda p, w, ladder, **kw: w,
                  _eval_2sub_shared=_eval_2sub8,
                  _eval_subset_candidate=_eval_subset8):
        whole = needed_ops(lambda x: jbc67.encode_bc7(x, **kwargs), b)
    return (whole - needed_ops(_quantize, b)) / NB


def bc7_refine_ops(ladder=jbc67.LADDER_MOMENT) -> dict:
    """K3: the refine of a block whose winner is mode m with one ladder
    (LADDER_MOMENT, LADDER_FULL or LADDER_LIGHT); blocks of other modes
    pass through."""
    px = jnp.zeros((16, 4, NB), jnp.int32)
    w = jnp.zeros((NB, 4), jnp.uint32)
    out = {}
    for mode in (1, 3, 5, 6, 7, 4, 0, 2):
        ctx = (_patched(_moment_channels_t=_moment8,
                        _perturb_channels_t=_perturb8,
                        _assign_indices_t=_assign8) if mode in (1, 3, 7)
               else _patched(_moment_channels_t=_cycling(_moment3),
                             _perturb_channels_t=_cycling(_perturb3),
                             _assign_indices_t=_cycling(_assign3))
               if mode in (0, 2) else contextlib.nullcontext())
        with ctx:
            out[mode] = needed_ops(lambda p, x: jbc67.refine_bc7_words(
                p, x, ladder, modes=(mode,)), px, w) / NB
    return out


def bc7_shapes_ops(n_shapes: int) -> float:
    """K9: the three-subset estimate table over the first n_shapes shapes
    (off-axis, 3 power iterations) and its top 4, from the [64, NB]
    texels (USE_3SUBSETS: 16 shapes for mode 0, 64 for mode 2)."""
    def fn(p):
        ests = jbc67._shape_estimates_table(p.astype(jnp.float32), 2, 4,
                                            n_shapes=n_shapes, off_axis=True)
        return jbc67._top_k_shapes(ests, 4)
    return needed_ops(fn, jnp.zeros((16, 4, NB), jnp.int32)) / NB


def bc7_partition_ops() -> dict:
    """K7: one partition mode (0, 1, 2, 3, 7) over 4 given shape
    candidates, from the texels and the candidates: _try_partition_mode
    on an unknown estimate table, less the top 4 of that table (K9's)."""
    px = jnp.zeros((16, 4, NB), jnp.int32)
    out = {}
    for mode in (0, 1, 2, 3, 7):
        n = 1 << jbc67._BC7_MODES[mode].partition_bits
        ests = jnp.zeros((64, NB), jnp.float32)
        with _patched(_eval_subset_candidate=_eval_subset_split):
            whole = needed_ops(lambda p, e: jbc67._try_partition_mode(
                p, p.astype(jnp.float32), mode, ests=e), px, ests)
        top = needed_ops(lambda e: jbc67._top_k_shapes(e[:n], 4), ests)
        out[mode] = (whole - top) / NB
    return out


def bc7_single_modes_ops() -> float:
    """K8: modes 4, 5 and 6 each over their candidates (_try_single_mode
    at its defaults: rotations 0-3, mode 4 at index mode 0), from the
    [64, NB] texels."""
    def fn(p):
        pf = p.astype(jnp.float32)
        return [jbc67._try_single_mode(p, pf, m) for m in (4, 5, 6)]
    return needed_ops(fn, jnp.zeros((16, 4, NB), jnp.int32)) / NB


def _fold_first(best, err, words):
    """The kernels' in-launch fold: the first candidate as it is, then a
    strict `<`."""
    if best is None:
        return err, words
    bt = err < best[0]
    return (jnp.where(bt, err, best[0]),
            jnp.where(bt[:, None], words, best[1]))


def bc6h_1region_ops(signed: bool = False, nb: int = NB) -> float:
    """K10: rows 10-13, each evaluated in full (_bc6h_eval_candidate),
    emitted and folded, from the [48, NB] F16-int pixels."""
    def fn(p):
        pf = p.astype(jnp.float32)
        ones = jnp.ones((16, nb), bool)
        best = None
        for row in range(10, 14):
            err, pairs, idx = jbc67._bc6h_eval_candidate(p, pf, [ones], [0],
                                                         row, signed)
            best = _fold_first(best, err,
                               jbc67._bc6h_emit(row, 0, pairs, idx, nb))
        return best
    return needed_ops(fn, jnp.zeros((16, 3, nb), jnp.int32)) / nb


def _bc6h_rows_flat(rows, signed: bool, nb: int) -> float:
    """`rows` over 4 given candidates, each (row, candidate) evaluated in
    full on two 8-pixel subsets, emitted and folded (the jnp search's
    two-region loop)."""
    def fn(p, sb):
        pf = p.astype(jnp.float32)
        best = None
        for row in rows:
            for k in range(4):
                err, pairs, idx = _bc6h_eval8(p, pf, row, signed)
                best = _fold_first(best, err, jbc67._bc6h_emit(
                    row, sb[k].astype(jnp.uint32), pairs, idx, nb))
        return best
    return needed_ops(fn, jnp.zeros((16, 3, nb), jnp.int32),
                      jnp.zeros((4, nb), jnp.int32)) / nb


def bc6h_group_eval_ops(row: int, signed: bool = False,
                        nb: int = NB) -> float:
    """One two-region candidate's full evaluation up to its anchor swaps
    at a row's precision: _bc6h_eval_candidate on two 8-pixel subsets,
    less the row's delta fit (_bc6h_transform_fit_t), which it ends
    with."""
    def fit(q, e):
        return jbc67._bc6h_transform_fit_t([(q[0], q[1]), (q[2], q[3])], e,
                                           row, signed, nb)
    whole = needed_ops(lambda p: _bc6h_eval8(p, p.astype(jnp.float32), row,
                                             signed),
                       jnp.zeros((16, 3, nb), jnp.int32))
    tail = needed_ops(fit, jnp.zeros((4, 3, nb), jnp.int32),
                      jnp.zeros((nb,), jnp.float32))
    return (whole - tail) / nb


def bc6h_2region_ops(signed: bool = False, nb: int = NB) -> dict:
    """K11 per precision group (its rows as the key): each of 4 candidates
    evaluated in full once, then per row and candidate the delta fit, emit
    and fold — the jnp search's loop over the group's rows, less the
    evaluations that its rows past the first repeat."""
    out = {}
    for rows in jbc67._bc6h_row_groups():
        out[rows] = _bc6h_rows_flat(rows, signed, nb) - (len(rows) - 1) \
            * 4 * bc6h_group_eval_ops(rows[0], signed, nb)
    return out


def bc6h_shapes_ops() -> float:
    """The BC6H shape ranking: the 32-shape off-axis estimate table at
    axis_w 0 on RGB and a zero alpha plane, and its top 4, from the
    [48, NB] F16-int pixels."""
    def fn(p):
        pf = p.astype(jnp.float32)
        px4 = jnp.concatenate([pf, jnp.zeros_like(pf[:, :1, :])], axis=1)
        ests = jbc67._shape_estimates_table(px4, 1, 3, n_shapes=32,
                                            off_axis=True, axis_w=0.0)
        return jbc67._top_k_shapes(ests, 4)
    return needed_ops(fn, jnp.zeros((16, 3, NB), jnp.int32)) / NB


def bc7_decode_ops() -> list:
    """K1: per mode 0-7."""
    return [needed_ops(lambda x: jbc67._decode_bc7_mode_t(x, m),
                       _words(NB)) / NB for m in range(8)]


def bc6h_decode_ops(signed: bool = False) -> list:
    """K4: per mode row 0-13."""
    return [needed_ops(lambda x: jbc67._decode_bc6h_mode_rows(x, r, signed),
                       _words(NB)) / NB for r in range(14)]


def bc6h_search_ops(signed: bool = False) -> float:
    """K5: the shared-fit search from the [48, NB] F16-int pixels (the
    f32 -> F16-int conversion is the wrapper's, outside the kernel)."""
    b = _hdr_blocks(NB)

    def convert(x):
        return jbc67._f16_to_int(jnp.transpose(x[..., :3], (1, 2, 0)),
                                 signed)

    with _patched(_bc6h_shared_fit=_shared_fit8,
                  _bc6h_group_rescore=_group_rescore8):
        whole = needed_ops(lambda x: jbc67.encode_bc6h(x, signed), b)
    return (whole - needed_ops(convert, b)) / NB


def _unq(q, precw, signed):
    return jbc67._bc6h_unquantize_dyn(q, precw, signed)


def _fin(u, signed):
    return jbc67._bc6h_finish_unquantize(u, signed)


def _refine_one_region(px_int, words_t, row, signed, ladder):
    """A one-region winner (row 10-13) through the refine: its own row's
    unpack, the stored-index bar, the remap ladder at all four one-region
    precisions, anchor swap, delta fit, emit and fold per row."""
    nb = words_t.shape[1]
    px3 = tuple(px_int[:, c, :] for c in range(3))
    b5 = (words_t[0] & 0x1F).astype(jnp.int32)
    mode_val = jnp.where((b5 & 3) < 2, b5 & 3, b5)
    _, e = jbc67._bc6h_unpack_endpoints(words_t, row, signed)
    q0 = jnp.stack([e[(0, 0, c)] for c in range(3)]) + 0 * mode_val
    q1 = jnp.stack([e[(0, 1, c)] for c in range(3)])
    precw = jnp.full((nb,), BC6H_MODE_INFO[row][4][0], jnp.int32)
    ones = jnp.ones((16, nb), bool)
    idx1 = jnp.stack([jbc67._gb_t(words_t, 65 + 4 * i - (1 if i else 0),
                                  4 - (0 if i else 1)).astype(jnp.int32)
                      for i in range(16)])
    wk1 = jbc67._pal_weight(idx1, 16)
    ef = [jnp.stack([_fin(_unq(q[c], precw, signed), signed)
                     for c in range(3)]) for q in (q0, q1)]
    best = sum(jbc67._bc6h_cherr_dyn(px3[c], ones, _unq(q0[c], precw, signed),
                                     _unq(q1[c], precw, signed), wk1, signed)
               for c in range(3))
    out = words_t
    for r in range(10, 14):
        prec = BC6H_MODE_INFO[r][4][0]
        if r == row:
            q0s, q1s = q0, q1
        else:
            q0s, q1s = (jnp.stack([jbc67._bc6h_quantize(f[c], prec, signed)
                                   for c in range(3)]) for f in ef)
        q0n, q1n, idx, err, _ = jbc67._bc6h_perturb_remap_dyn(
            px3, ones, q0s, q1s, jnp.full((nb,), prec, jnp.int32), 4,
            signed, *ladder)
        swap = (idx[0] & 8) != 0
        q0a = jnp.where(swap[None, :], q1n, q0n)
        q1a = jnp.where(swap[None, :], q0n, q1n)
        idx = jnp.where(swap[None, :], 15 - idx, idx)
        errf, pairs = jbc67._bc6h_transform_fit_t([(q0a, q1a)], err, r,
                                                  signed, nb)
        wn = jnp.transpose(jbc67._bc6h_emit(r, 0, pairs, idx, nb))
        better = errf < best
        best = jnp.where(better, errf, best)
        out = jnp.where(better[None, :], wn, out)
    return out


def _refine_two_region(px_int, words_t, row, signed, ladder, cross2=True):
    """A two-region winner (row 0-9) through the refine: its own row's
    unpack and index read, the stored-index bar, the remap ladder per
    subset (each over its own pixels) at all six precision groups with
    cross2, else at its own row's precision only, anchor swaps, delta fit,
    emit and fold per row."""
    nb = words_t.shape[1]
    b5 = (words_t[0] & 0x1F).astype(jnp.int32)
    mode_val = jnp.where((b5 & 3) < 2, b5 & 3, b5)
    shape, e = jbc67._bc6h_unpack_endpoints(words_t, row, signed)
    qm = {(s, k): jnp.stack([e[(s, k, c)] for c in range(3)])
          for s in (0, 1) for k in (0, 1)}
    qm[(0, 0)] = qm[(0, 0)] + 0 * mode_val
    precw = jnp.full((nb,), BC6H_MODE_INFO[row][4][0], jnp.int32)
    a2 = jnp.asarray(FIXUPS[1][:32, 1].astype(np.int32))[shape]
    idx2 = []
    for i in range(16):
        before = (1 if i > 0 else 0) + (a2 < i).astype(jnp.int32)
        is_anchor = jnp.where((i == 0) | (a2 == i), 1, 0)
        idx2.append(jbc67._gb_dyn_t(words_t, 82 + 3 * i - before, is_anchor,
                                    3).astype(jnp.int32))
    wk2 = jbc67._pal_weight(jnp.stack(idx2), 8)
    px_s = [tuple(px_int[8 * s:8 * s + 8, c, :] for c in range(3))
            for s in (0, 1)]
    ones8 = _ones8(nb)
    best = sum(jbc67._bc6h_cherr_dyn(
        px_s[s][c], ones8, _unq(qm[(s, 0)][c], precw, signed),
        _unq(qm[(s, 1)][c], precw, signed), wk2[8 * s:8 * s + 8], signed)
        for s in (0, 1) for c in range(3))
    ef2 = {k: [_fin(_unq(q[c], precw, signed), signed) for c in range(3)]
           for k, q in qm.items()}
    out = words_t
    groups = jbc67._bc6h_row_groups() if cross2 else [(row,)]
    for g in groups:
        prec = BC6H_MODE_INFO[g[0]][4][0]
        q2, idx_s, err = {}, [], 0.0
        for s in (0, 1):
            if row in g:
                q0s, q1s = qm[(s, 0)], qm[(s, 1)]
            else:
                q0s, q1s = (jnp.stack([jbc67._bc6h_quantize(
                    ef2[(s, k)][c], prec, signed) for c in range(3)])
                    for k in (0, 1))
            q0n, q1n, idx, err_n, _ = jbc67._bc6h_perturb_remap_dyn(
                px_s[s], ones8, q0s, q1s, jnp.full((nb,), prec, jnp.int32),
                3, signed, *ladder)
            swap = (idx[0] & 4) != 0
            q2[s] = (jnp.where(swap[None, :], q1n, q0n),
                     jnp.where(swap[None, :], q0n, q1n))
            idx_s.append(jnp.where(swap[None, :], 7 - idx, idx))
            err = err + err_n
        idx16 = jnp.concatenate(idx_s)
        for r in g:
            errf, pairs = jbc67._bc6h_transform_fit_t([q2[0], q2[1]], err,
                                                      r, signed, nb)
            wn = jnp.transpose(jbc67._bc6h_emit(
                r, shape.astype(jnp.uint32), pairs, idx16, nb))
            better = errf < best
            best = jnp.where(better, errf, best)
            out = jnp.where(better[None, :], wn, out)
    return out


def bc6h_maxq_refine_ops(signed: bool = False) -> dict:
    """K6 at the maxq tier (remap ladder, cross2) for a one-region winner
    (row 10) and a two-region winner (row 0); reserved blocks pass
    through. Other rows of a class differ only in the unpack and in which
    precision group skips the re-quantization."""
    rng = np.random.default_rng(0)
    px = jnp.asarray(rng.integers(0, 0x7BFF, (16, 3, NB)).astype(np.int32))
    lad = jbc67.BC6H_LADDER_MAXQ
    return {
        "one_region": needed_ops(lambda p, w: _refine_one_region(
            p, w, 10, signed, lad), px, _words(NB)) / NB,
        "two_region": needed_ops(lambda p, w: _refine_two_region(
            p, w, 0, signed, lad), px, _words(NB)) / NB}


def bc6h_mid_refine_ops(signed: bool = False) -> dict:
    """K6 at the mid tier (BC6H_LADDER_MID, remap, no cross2): a
    one-region winner (row 10) at the four one-region precisions, and a
    two-region winner (row 0) at its own precision."""
    rng = np.random.default_rng(0)
    px = jnp.asarray(rng.integers(0, 0x7BFF, (16, 3, NB)).astype(np.int32))
    lad = jbc67.BC6H_LADDER_MID
    return {
        "one_region": needed_ops(lambda p, w: _refine_one_region(
            p, w, 10, signed, lad), px, _words(NB)) / NB,
        "two_region": needed_ops(lambda p, w: _refine_two_region(
            p, w, 0, signed, lad, cross2=False), px, _words(NB)) / NB}


def main() -> None:
    counts = {
        "BC7_DECODE_OPS": bc7_decode_ops(),
        "BC7_SEARCH_OPS": bc7_search_ops(),
        "BC7_SEARCH_QUICK_OPS": bc7_search_ops("quick"),
        "BC7_REFINE_OPS": bc7_refine_ops(),
        "BC7_SEARCH_MAXQ_OPS": bc7_search_ops("maxq"),
        "BC7_REFINE_FULL_OPS": bc7_refine_ops(jbc67.LADDER_FULL),
        "BC7_REFINE_LIGHT_OPS": bc7_refine_ops(jbc67.LADDER_LIGHT),
        "BC6H_DECODE_OPS": bc6h_decode_ops(),
        "BC6H_SEARCH_OPS": bc6h_search_ops(),
        "BC6H_REFINE_OPS": bc6h_maxq_refine_ops(),
        "BC6H_REFINE_MID_OPS": bc6h_mid_refine_ops(),
        "BC7_SHAPES_OPS": {n: bc7_shapes_ops(n) for n in (16, 64)},
        "BC7_PARTITION_OPS": bc7_partition_ops(),
        "BC7_SINGLE_MODES_OPS": bc7_single_modes_ops(),
        "BC6H_1REGION_OPS": bc6h_1region_ops(),
        "BC6H_SHAPES_OPS": bc6h_shapes_ops(),
        "BC6H_2REGION_OPS": [bc6h_2region_ops()[g]
                             for g in jbc67._bc6h_row_groups()],
    }
    print(json.dumps(counts))


# -- the counting rules --------------------------------------------------------
def _roofline_ops(fn, *args) -> float:
    return needed_ops(fn, *args, tighten=False)


def test_unmasked_function_counts_plainly():
    x = jnp.ones((16, 8), jnp.float32)

    def fn(a):
        b = jnp.clip(a * 3.0 - 1.0, 0.0, 2.0)
        return jnp.sum(b * b, axis=0) + jnp.max(a, axis=0)

    assert needed_ops(fn, x) == _roofline_ops(fn, x) == 16 * 8 * 7 + 8


def test_lane_masking_is_free():
    """A known all-true mask's select, multiply and and, and the known
    zero and inf starts of sums and minima, cost nothing."""
    x = jnp.ones((16, 8), jnp.float32)

    def fn(a):
        m = jnp.ones((16, 8), bool)
        sq = jnp.where(m, a * a, 0.0) * m.astype(jnp.float32)
        acc = jnp.zeros((16, 8), jnp.float32) + sq
        lo = jnp.minimum(jnp.full((16, 8), jnp.inf, jnp.float32), acc)
        return jnp.sum(lo, axis=0), m & (a > 0)

    # a * a, the sum and a > 0 are left
    assert needed_ops(fn, x) == 16 * 8 * 3
    assert _roofline_ops(fn, x) == 16 * 8 * 8


def test_known_matrix_product_counts_its_entries():
    """A 0/1 mask matrix costs one add per 1; other entries two ops."""
    x = jnp.ones((16, 5, 8), jnp.float32)
    m = np.zeros((4, 16), np.float32)
    m[0, :8] = m[1, 8:] = 1.0
    m[2, 3] = 0.5

    def fn(a):
        return jnp.einsum("mk,kqn->mqn", jnp.asarray(m), a)

    assert needed_ops(fn, x) == (16 + 2) * 5 * 8
    assert _roofline_ops(fn, x) == 2 * 4 * 5 * 8 * 16


def test_two_region_split_counts_sixteen_pixels():
    """Two 8-pixel subsets cost what one 16-pixel region costs plus one
    region's per-block work: the per-pixel work is counted over 16
    pixels in all, not 32."""
    rng = np.random.default_rng(1)
    px = jnp.asarray(rng.random((16, 3, 64)).astype(np.float32) * 1000)

    def one(p):
        return jbc67._bc6h_shared_fit(p, [jnp.ones((16, 64), bool)], 3,
                                      False)

    def two(p):
        return _shared_fit8(p, [jnp.ones((16, 64), bool)] * 2, 3, False)

    def one8(p):
        return jbc67._bc6h_shared_fit(p[:8], [_ones8(64)], 3, False)

    n1, n2, n8 = needed_ops(one, px), needed_ops(two, px), \
        needed_ops(one8, px)
    per_px = (n1 - n8) / 8            # linear in the pixel count
    assert per_px > 0
    assert n2 == 2 * n8 == n1 + (n8 - 8 * per_px)


def test_mode7_split_counts_sixteen_pixels():
    """A mode-7 candidate on two 8-pixel subsets costs its two subset
    fits over 8 pixels each, and one add of their errors: twice one
    8-pixel subset's count plus one, well below the lane-masked count
    (two subsets over all 16 pixels each)."""
    rng = np.random.default_rng(2)
    px = jnp.asarray(rng.integers(0, 256, (16, 4, 64)).astype(np.int32))

    def two(p):
        return _eval_subset8(p, p.astype(jnp.float32),
                             [jnp.ones((16, 64), bool)] * 2, [0, 0], 7)

    def one8(p):
        return _ORIG["_eval_subset_candidate"](
            p[:8], p[:8].astype(jnp.float32), [_ones8(64)], [0], 7)

    def masked(p):
        return _ORIG["_eval_subset_candidate"](
            p, p.astype(jnp.float32), [jnp.ones((16, 64), bool)] * 2,
            [0, 0], 7)

    n2, n8 = needed_ops(two, px) / 64, needed_ops(one8, px) / 64
    assert n8 > 0 and n2 == 2 * n8 + 1
    assert n2 < 0.6 * needed_ops(masked, px) / 64


def test_three_region_split_counts_sixteen_pixels():
    """A mode-0 candidate on subsets of 5, 5 and 6 pixels costs its three
    single-subset fits over those pixels and two adds of their errors,
    well below the lane-masked count (three subsets over all 16 pixels
    each)."""
    rng = np.random.default_rng(4)
    px = jnp.asarray(rng.integers(0, 256, (16, 4, 64)).astype(np.int32))
    ones = [jnp.ones((16, 64), bool)] * 3

    def three(p):
        return _eval_subset_split(p, p.astype(jnp.float32), ones, [0] * 3, 0)

    def one(p, lo, hi):
        return _ORIG["_eval_subset_candidate"](
            p[lo:hi], p[lo:hi].astype(jnp.float32),
            [jnp.ones((hi - lo, 64), bool)], [0], 0)

    def masked(p):
        return _ORIG["_eval_subset_candidate"](
            p, p.astype(jnp.float32), ones, [0] * 3, 0)

    n3 = needed_ops(three, px) / 64
    parts = sum(needed_ops(lambda p, lo=lo, hi=hi: one(p, lo, hi), px) / 64
                for lo, hi in _SPLIT3)
    assert parts > 0 and n3 == parts + 2
    assert n3 < 0.5 * needed_ops(masked, px) / 64


def test_ladder_split_counts_sixteen_pixels():
    """The exact ladder's work is linear in its subset's pixel count, so
    an 8-pixel trace of one subset stands for half of a 16-pixel block:
    16 pixels cost 8 pixels' count plus twice the step from 4 to 8, and
    an unknown 16-pixel mask costs more than the known one."""
    rng = np.random.default_rng(3)
    px = jnp.asarray(rng.integers(0, 256, (16, 4, 64)).astype(np.int32))
    m = jbc67._BC7_MODES[1]
    q = jnp.asarray(rng.integers(0, 64, (4, 64)).astype(np.int32))
    pb = jnp.zeros((64,), jnp.int32)
    wk = jnp.asarray(rng.integers(0, 65, (16, 64)).astype(np.int32))

    def run(p, n, mask=None):
        mask = jnp.ones((n, 64), bool) if mask is None else mask
        return _ORIG["_perturb_channels_t"](
            p[:n], mask, m, True, q, q, pb, pb, [wk[:n]] * 4,
            rounds=1, deltas=(1,))

    n16, n8, n4 = (needed_ops(lambda p: run(p, n), px) for n in (16, 8, 4))
    eight = needed_ops(lambda p: _perturb8(
        p, None, m, True, q, q, pb, pb, [wk] * 4, rounds=1,
        deltas=(1,)), px)
    masked = needed_ops(lambda p, k: run(p, 16, k > 0), px,
                        jnp.ones((16, 64), jnp.int32))
    assert eight == n8 and n8 - n4 > 0
    assert n16 == n8 + 2 * (n8 - n4)
    assert masked > n16


def test_group_rows_share_one_evaluation():
    """The rows of a precision group cost the same full evaluation (so
    K11's count may take one per candidate for the whole group), and a
    row's evaluation is most of its flat count."""
    nb = 16
    e2, e3 = (bc6h_group_eval_ops(r, nb=nb) for r in (2, 3))
    assert e2 == e3 > 0
    flat = _bc6h_rows_flat((2,), False, nb)
    assert flat / 2 < 4 * e2 < flat


def test_decode_counts_within_twins():
    """The per-row BC6H decode counts are positive and no larger than the
    whole twin's per-block count."""
    got = bc6h_decode_ops()
    whole = _roofline_ops(lambda x: jbc67.decode_bc6h(x, False),
                          jnp.zeros((NB, 16), jnp.uint8)) / NB
    assert len(got) == 14 and all(0 < g < whole for g in got)


if __name__ == "__main__":
    main()
