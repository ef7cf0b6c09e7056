"""BC6H encode of the PyTorch port (the plain twin of kernel K5) held
against the JAX package's jnp functions of the same names, on the same
F16-int pixels made with numpy. The JAX outputs are frozen in
tests/golden/bc6h_encode_refs.npz by tests/golden/generate_bc6h_encode_refs.py
from the inputs this module draws (the helpers below), so that the tests
run no JAX call.

Integer steps (F16 conversion, quantize / unquantize, delta fit, emit) are
exact. Float steps sum 16 pixels in index order here and in XLA's order
there; at F16-int magnitudes (up to 31743, squares and moments to ~1e10)
that moves the last bits, so they are compared with tolerances. The whole
search is held against the JAX encode in test_torch_bc6h_search.py."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc6h
from directxtex_tpu_torch.bc.bc67 import _shape_estimates_table, _top_k_shapes
from directxtex_tpu_torch.bc.bc67_tables import BC6H_MODE_INFO, FIXUPS

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
PRECS = (4, 5, 6, 7, 8, 9, 10, 11, 12, 16)
RESCORE_ROWS = (0, 1, 2, 10, 13)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    return np.load(GOLDEN / "bc6h_encode_refs.npz")


def _pre(signed):
    return "s_" if signed else "u_"


def _rgb_lane(signed, nb=64, seed=7):
    """Random HDR blocks as lane-major f32 [16, 3, NB], every fifth
    flat."""
    rng = np.random.default_rng(seed + signed)
    rgb = rng.random((nb, 16, 3)).astype(np.float32) * 6.0
    if signed:
        rgb -= 3.0
    rgb[::5] = rgb[::5, :1]
    return np.ascontiguousarray(np.transpose(rgb, (1, 2, 0)))


def _px(ref, signed):
    """F16-int pixels [16, 3, NB] of _rgb_lane: the JAX package's
    _f16_to_int, frozen (the port's is held equal to it below)."""
    return ref[_pre(signed) + "px"]


def _f16_inputs():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 6, 4096)) \
        .astype(np.float32)
    x[:8] = [np.inf, -np.inf, np.nan, 65504.0, 65520.0, -0.0, 6e-8, -7e4]
    return x


def _quant_inputs(signed):
    """The quantize test's inputs, drawn in its order: v; per precision
    c; u; per-block precisions p and their codes cd."""
    rng = np.random.default_rng(11)
    lo = -0x7BFF if signed else 0
    out = {"v": rng.integers(lo, 0x7C00, 2048).astype(np.int32)}
    for prec in PRECS:
        out[f"c{prec}"] = rng.integers(
            -(1 << (prec - 1)) if signed else 0,
            1 << (prec - 1 if signed else prec), 2048).astype(np.int32)
    out["u"] = rng.integers(-0x7FFF if signed else 0, 0x10000,
                            2048).astype(np.int32)
    p = rng.choice([6, 7, 8, 9, 10, 11, 12, 16], 2048).astype(np.int32)
    c = (rng.integers(0, 1 << 30, 2048) % (1 << (p - 1))).astype(np.int32)
    out["p"] = p
    out["cd"] = np.where(rng.random(2048) < 0.5, -c, c) if signed else c
    return out


# ---------------------------------------------------------------------------
# exact steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("signed", [False, True])
def test_f16_to_int_exact(ref, signed):
    pre = _pre(signed)
    got = bc6h._f16_to_int(torch.from_numpy(_f16_inputs()), signed).numpy()
    np.testing.assert_array_equal(got, ref[pre + "f16_to_int"])
    # the pixels the float-step tests take
    np.testing.assert_array_equal(
        bc6h._f16_to_int(torch.from_numpy(_rgb_lane(signed)),
                         signed).numpy(), _px(ref, signed))


@pytest.mark.parametrize("signed", [False, True])
def test_quantize_unquantize_exact(ref, signed):
    pre = _pre(signed)
    x = _quant_inputs(signed)
    v = torch.from_numpy(x["v"])
    for prec in PRECS:
        np.testing.assert_array_equal(
            bc6h._bc6h_quantize(v, prec, signed).numpy(),
            ref[pre + f"quantize{prec}"])
        np.testing.assert_array_equal(
            bc6h._bc6h_unquantize(torch.from_numpy(x[f"c{prec}"]), prec,
                                  signed).numpy(),
            ref[pre + f"unquantize{prec}"])
    np.testing.assert_array_equal(
        bc6h._bc6h_finish_unquantize(torch.from_numpy(x["u"]),
                                     signed).numpy(),
        ref[pre + "finish"])
    # per-block precision (the refine's dyn forms)
    p = torch.from_numpy(x["p"])
    np.testing.assert_array_equal(
        bc6h._bc6h_unquantize_dyn(torch.from_numpy(x["cd"]), p,
                                  signed).numpy(),
        ref[pre + "unquantize_dyn"])
    np.testing.assert_array_equal(
        bc6h._bc6h_quantize_dyn(v, p, signed).numpy(),
        ref[pre + "quantize_dyn"])


def _q_pairs(rng, row, signed, nb):
    """Random anchor-fixed quantized endpoints near the row's field
    limits, so some fit and some do not."""
    _, parts, tr, _, prec_w, prec_x, _, _ = BC6H_MODE_INFO[row]
    hi = (1 << (prec_w[0] - 1)) if signed else (1 << prec_w[0])
    lo = -hi if signed else 0
    base = rng.integers(lo, hi, (3, nb))
    # deltas up to 1.25x their field's reach (1/8 of an absolute field)
    reach = (5 << (min(prec_x) - 1)) // 4 if tr else (hi - lo) // 8
    pairs = []
    for _ in range(2 if parts else 1):
        spread = rng.integers(-reach, reach + 1, (2, 3, nb))
        pairs.append(tuple(np.clip(base + s, lo - 2, hi + 1).astype(np.int32)
                           for s in spread))
    pairs[0] = (base.astype(np.int32), pairs[0][1])
    return pairs


def _fit_inputs(signed, nb=64):
    """Per row 0-13, drawn in the fit-and-emit test's order: (pairs, err,
    shape, idx) with shape 0 for a one-region row."""
    rng = np.random.default_rng(23 + signed)
    out = []
    for row in range(14):
        pairs = _q_pairs(rng, row, signed, nb)
        err = rng.random(nb).astype(np.float32) * 100
        parts, iprec = BC6H_MODE_INFO[row][1], BC6H_MODE_INFO[row][3]
        shape = rng.integers(0, 32, nb).astype(np.int32) if parts else 0
        idx = rng.integers(0, 1 << iprec, (16, nb)).astype(np.int32)
        idx[0] &= (1 << (iprec - 1)) - 1
        if parts:
            a2 = FIXUPS[1, shape, 1]
            idx[a2, np.arange(nb)] &= (1 << (iprec - 1)) - 1
        out.append((pairs, err, shape, idx))
    return out


@pytest.mark.parametrize("signed", [False, True])
def test_transform_fit_and_emit_exact(ref, signed):
    nb = 64
    for row, (pairs, err, shape, idx) in enumerate(_fit_inputs(signed, nb)):
        key = f"{_pre(signed)}fit{row}_"
        ref_err = ref[key + "err"]
        ref_pairs = [(q[0], q[1]) for q in ref[key + "pairs"]]
        got_err, got_pairs = bc6h._bc6h_transform_fit_t(
            [tuple(torch.from_numpy(q) for q in p) for p in pairs],
            torch.from_numpy(err), row, signed)
        np.testing.assert_array_equal(got_err.numpy(), ref_err)
        assert 0 < np.isinf(ref_err).sum() < nb, row
        for gp, rp in zip(got_pairs, ref_pairs):
            for g, r in zip(gp, rp):
                np.testing.assert_array_equal(g.numpy(), r)
        parts = BC6H_MODE_INFO[row][1]
        ref_w = ref[key + "words"]
        got_w = bc6h._bc6h_emit(
            row, torch.from_numpy(shape) if parts else 0,
            [tuple(q for q in p) for p in got_pairs],
            torch.from_numpy(idx), nb, torch.device("cpu"))
        np.testing.assert_array_equal(got_w.numpy().T.astype(np.uint32),
                                      ref_w, err_msg=f"row {row}")


# ---------------------------------------------------------------------------
# float steps
# ---------------------------------------------------------------------------

def _masks(nb):
    m0 = np.zeros((16, nb), bool)
    m0[:8] = True
    m0[:, ::3] = np.roll(m0[:, ::3], 3, axis=0)
    return m0


def _shared_fit_cases(nb):
    """(masks, iprec) of the shared-fit test: two-region, one-region."""
    m0 = _masks(nb)
    return (([m0, ~m0], 3), ([np.ones((16, nb), bool)], 4))


def _rescore_case(row, nb):
    """(masks, anchors) of the group-rescore test's row: a second anchor
    of 15 for a two-region row."""
    m0 = _masks(nb)
    if BC6H_MODE_INFO[row][1]:
        return [m0, ~m0], [0, np.full(nb, 15, np.int32)]
    return [np.ones((16, nb), bool)], [0]


@pytest.mark.parametrize("signed", [False, True])
def test_shared_fit_close(ref, signed):
    """One-region and two-region trajectories; rtol 2e-6 as
    tests/test_pallas.py:592-596 holds the TPU kernel's (sum order; equal
    on these inputs)."""
    px = _px(ref, signed)
    nb = px.shape[2]
    pxf_t = torch.from_numpy(px.astype(np.float32))
    for case, (masks, iprec) in enumerate(_shared_fit_cases(nb)):
        want = ref[f"{_pre(signed)}shared_fit{case}"]
        got = bc6h._bc6h_shared_fit(pxf_t, [torch.from_numpy(m)
                                            for m in masks], iprec, signed)
        for (r0, r1), (g0, g1) in zip(want, got):
            np.testing.assert_allclose(g0.numpy(), r0, rtol=2e-6,
                                       atol=2e-2)
            np.testing.assert_allclose(g1.numpy(), r1, rtol=2e-6,
                                       atol=2e-2)


@pytest.mark.parametrize("signed", [False, True])
def test_group_rescore_close(ref, signed):
    """Precision groups with and without the quantized refit, one- and
    two-region, on the same (JAX) trajectory endpoints: errors within rtol
    1e-6 (f32 sums of squared F16-int differences in another order), and
    endpoints and indices equal except where the refit's keep-better
    comparison is a near-tie of the two errors (rtol 1e-5)."""
    px = _px(ref, signed)
    nb = px.shape[2]
    for row in RESCORE_ROWS:
        key = f"{_pre(signed)}rescore{row}_"
        masks, anchors = _rescore_case(row, nb)
        # the JAX package's trajectories, the same input to both rescores
        shared = ref[key + "shared"]
        r_err, r_idx = ref[key + "err"], ref[key + "idx"]
        r_pairs = [(q[0], q[1]) for q in ref[key + "pairs"]]
        g_err, g_pairs, g_idx = bc6h._bc6h_group_rescore(
            torch.from_numpy(px), [torch.from_numpy(m) for m in masks],
            [a if isinstance(a, int) else torch.from_numpy(a)
             for a in anchors],
            [tuple(torch.from_numpy(np.array(e)) for e in s)
             for s in shared], row, signed)
        g_err = g_err.numpy()
        np.testing.assert_allclose(g_err, r_err, rtol=1e-6)
        same = np.all(g_idx.numpy() == r_idx, axis=0)
        for gp, rp in zip(g_pairs, r_pairs):
            for g, r in zip(gp, rp):
                same &= np.all(g.numpy() == r, axis=0)
        np.testing.assert_allclose(g_err[~same], r_err[~same], rtol=1e-5)
        assert (~same).sum() <= max(2, nb // 25), (row, (~same).sum())


@pytest.mark.parametrize("signed", [False, True])
def test_shape_estimates_close(ref, signed):
    """The 32-shape off-axis table at axis_w=0 on RGB plus a zero alpha
    plane: values reach ~1e10, and the index-order sums differ from XLA's
    einsum in the last bits (measured up to 6.5e-7 relative, 1024
    absolute), so rtol 2e-6 with atol 0.5 for entries near 0; the top-4
    picks equal except where the estimates tie within that tolerance."""
    px = _px(ref, signed).astype(np.float32)
    px4 = np.concatenate([px, np.zeros_like(px[:, :1])], axis=1)
    table = ref[_pre(signed) + "shape_table"]
    got = _shape_estimates_table(torch.from_numpy(px4), n_shapes=32,
                                 axis_w=0.0).numpy()
    assert got.shape == (32, px.shape[2])
    np.testing.assert_allclose(got, table, rtol=2e-6, atol=0.5)
    picks_r = ref[_pre(signed) + "shape_picks"]
    picks_g = np.stack([s.numpy() for s in
                        _top_k_shapes(torch.from_numpy(got), 4)])
    for b in np.nonzero(np.any(picks_g != picks_r, axis=0))[0]:
        np.testing.assert_allclose(np.sort(table[picks_g[:, b], b]),
                                   np.sort(table[picks_r[:, b], b]),
                                   rtol=2e-6, atol=0.5)
