"""BC6H encode of the PyTorch port (the plain twin of kernel K5) held
against the JAX package's jnp functions of the same names, on the same
F16-int pixels made with numpy.

Integer steps (F16 conversion, quantize / unquantize, delta fit, emit) are
exact. Float steps sum 16 pixels in index order here and in XLA's order
there; at F16-int magnitudes (up to 31743, squares and moments to ~1e10)
that moves the last bits, so they are compared with tolerances. The whole
search is held against the JAX encode in test_torch_bc6h_search.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu_torch.bc import bc6h
from directxtex_tpu_torch.bc.bc67 import _shape_estimates_table, _top_k_shapes



def _px(signed, nb=64, seed=7):
    """F16-int pixels [16, 3, NB] of random HDR blocks, every fifth flat."""
    rng = np.random.default_rng(seed + signed)
    rgb = rng.random((nb, 16, 3)).astype(np.float32) * 6.0
    if signed:
        rgb -= 3.0
    rgb[::5] = rgb[::5, :1]
    lane = np.ascontiguousarray(np.transpose(rgb, (1, 2, 0)))
    return np.array(jbc67._f16_to_int(jnp.asarray(lane), signed))


# ---------------------------------------------------------------------------
# exact steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("signed", [False, True])
def test_f16_to_int_exact(signed):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 6, 4096)) \
        .astype(np.float32)
    x[:8] = [np.inf, -np.inf, np.nan, 65504.0, 65520.0, -0.0, 6e-8, -7e4]
    got = bc6h._f16_to_int(torch.from_numpy(x), signed).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jbc67._f16_to_int(jnp.asarray(x), signed)))


@pytest.mark.parametrize("signed", [False, True])
def test_quantize_unquantize_exact(signed):
    rng = np.random.default_rng(11)
    lo = -0x7BFF if signed else 0
    v = rng.integers(lo, 0x7C00, 2048).astype(np.int32)
    for prec in (4, 5, 6, 7, 8, 9, 10, 11, 12, 16):
        np.testing.assert_array_equal(
            bc6h._bc6h_quantize(torch.from_numpy(v), prec, signed).numpy(),
            np.asarray(jbc67._bc6h_quantize(jnp.asarray(v), prec, signed)))
        c = rng.integers(-(1 << (prec - 1)) if signed else 0,
                         1 << (prec - 1 if signed else prec),
                         2048).astype(np.int32)
        np.testing.assert_array_equal(
            bc6h._bc6h_unquantize(torch.from_numpy(c), prec, signed).numpy(),
            np.asarray(jbc67._bc6h_unquantize(jnp.asarray(c), prec, signed)))
    u = rng.integers(-0x7FFF if signed else 0, 0x10000, 2048).astype(np.int32)
    np.testing.assert_array_equal(
        bc6h._bc6h_finish_unquantize(torch.from_numpy(u), signed).numpy(),
        np.asarray(jbc67._bc6h_finish_unquantize(jnp.asarray(u), signed)))
    # per-block precision (the refine's dyn forms)
    p = rng.choice([6, 7, 8, 9, 10, 11, 12, 16], 2048).astype(np.int32)
    c = (rng.integers(0, 1 << 30, 2048) % (1 << (p - 1))).astype(np.int32)
    c = np.where(rng.random(2048) < 0.5, -c, c) if signed else c
    np.testing.assert_array_equal(
        bc6h._bc6h_unquantize_dyn(torch.from_numpy(c), torch.from_numpy(p),
                                  signed).numpy(),
        np.asarray(jbc67._bc6h_unquantize_dyn(jnp.asarray(c), jnp.asarray(p),
                                              signed)))
    np.testing.assert_array_equal(
        bc6h._bc6h_quantize_dyn(torch.from_numpy(v), torch.from_numpy(p),
                                signed).numpy(),
        np.asarray(jbc67._bc6h_quantize_dyn(jnp.asarray(v), jnp.asarray(p),
                                            signed)))


def _q_pairs(rng, row, signed, nb):
    """Random anchor-fixed quantized endpoints near the row's field
    limits, so some fit and some do not."""
    _, parts, tr, _, prec_w, prec_x, _, _ = jbc67.BC6H_MODE_INFO[row]
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


@pytest.mark.parametrize("signed", [False, True])
def test_transform_fit_and_emit_exact(signed):
    rng = np.random.default_rng(23 + signed)
    nb = 64
    for row in range(14):
        pairs = _q_pairs(rng, row, signed, nb)
        err = rng.random(nb).astype(np.float32) * 100
        ref_err, ref_pairs = jbc67._bc6h_transform_fit_t(
            [tuple(jnp.asarray(q) for q in p) for p in pairs],
            jnp.asarray(err), row, signed, nb)
        got_err, got_pairs = bc6h._bc6h_transform_fit_t(
            [tuple(torch.from_numpy(q) for q in p) for p in pairs],
            torch.from_numpy(err), row, signed)
        np.testing.assert_array_equal(got_err.numpy(), np.asarray(ref_err))
        assert 0 < np.isinf(np.asarray(ref_err)).sum() < nb, row
        for gp, rp in zip(got_pairs, ref_pairs):
            for g, r in zip(gp, rp):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        parts, iprec = jbc67.BC6H_MODE_INFO[row][1], \
            jbc67.BC6H_MODE_INFO[row][3]
        shape = rng.integers(0, 32, nb).astype(np.int32) if parts else 0
        idx = rng.integers(0, 1 << iprec, (16, nb)).astype(np.int32)
        idx[0] &= (1 << (iprec - 1)) - 1
        if parts:
            a2 = jbc67.FIXUPS[1, shape, 1]
            idx[a2, np.arange(nb)] &= (1 << (iprec - 1)) - 1
        ref_w = np.asarray(jbc67._bc6h_emit(
            row, jnp.asarray(shape) if parts else 0,
            [tuple(jnp.asarray(np.asarray(q)) for q in p)
             for p in ref_pairs], jnp.asarray(idx), nb))
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


@pytest.mark.parametrize("signed", [False, True])
def test_shared_fit_close(signed):
    """One-region and two-region trajectories; rtol 2e-6 as
    tests/test_pallas.py:592-596 holds the TPU kernel's (sum order; equal
    on these inputs)."""
    px = _px(signed)
    nb = px.shape[2]
    m0 = _masks(nb)
    pxf_j = jnp.asarray(px, jnp.float32)
    pxf_t = torch.from_numpy(px.astype(np.float32))
    for masks, iprec in (([m0, ~m0], 3), ([np.ones((16, nb), bool)], 4)):
        ref = jbc67._bc6h_shared_fit(pxf_j, [jnp.asarray(m) for m in masks],
                                     iprec, signed)
        got = bc6h._bc6h_shared_fit(pxf_t, [torch.from_numpy(m)
                                            for m in masks], iprec, signed)
        for (r0, r1), (g0, g1) in zip(ref, got):
            np.testing.assert_allclose(g0.numpy(), np.asarray(r0),
                                       rtol=2e-6, atol=2e-2)
            np.testing.assert_allclose(g1.numpy(), np.asarray(r1),
                                       rtol=2e-6, atol=2e-2)


@pytest.mark.parametrize("signed", [False, True])
def test_group_rescore_close(signed):
    """Precision groups with and without the quantized refit, one- and
    two-region, on the same (JAX) trajectory endpoints: errors within rtol
    1e-6 (f32 sums of squared F16-int differences in another order), and
    endpoints and indices equal except where the refit's keep-better
    comparison is a near-tie of the two errors (rtol 1e-5)."""
    px = _px(signed)
    nb = px.shape[2]
    m0 = _masks(nb)
    pxf = jnp.asarray(px, jnp.float32)
    ones = np.ones((16, nb), bool)
    a2 = np.full(nb, 15, np.int32)
    for row in (0, 1, 2, 10, 13):
        parts, iprec = jbc67.BC6H_MODE_INFO[row][1], \
            jbc67.BC6H_MODE_INFO[row][3]
        masks = [m0, ~m0] if parts else [ones]
        anchors = [0, a2] if parts else [0]
        shared = jbc67._bc6h_shared_fit(pxf, [jnp.asarray(m) for m in masks],
                                        iprec, signed)
        r_err, r_pairs, r_idx = jbc67._bc6h_group_rescore(
            jnp.asarray(px), [jnp.asarray(m) for m in masks],
            [0, jnp.asarray(a2)] if parts else [0], shared, row, signed)
        g_err, g_pairs, g_idx = bc6h._bc6h_group_rescore(
            torch.from_numpy(px), [torch.from_numpy(m) for m in masks],
            [0, torch.from_numpy(a2)] if parts else anchors,
            [tuple(torch.from_numpy(np.array(e)) for e in s)
             for s in shared], row, signed)
        r_err, g_err = np.asarray(r_err), g_err.numpy()
        np.testing.assert_allclose(g_err, r_err, rtol=1e-6)
        same = np.all(g_idx.numpy() == np.asarray(r_idx), axis=0)
        for gp, rp in zip(g_pairs, r_pairs):
            for g, r in zip(gp, rp):
                same &= np.all(g.numpy() == np.asarray(r), axis=0)
        np.testing.assert_allclose(g_err[~same], r_err[~same], rtol=1e-5)
        assert (~same).sum() <= max(2, nb // 25), (row, (~same).sum())


@pytest.mark.parametrize("signed", [False, True])
def test_shape_estimates_close(signed):
    """The 32-shape off-axis table at axis_w=0 on RGB plus a zero alpha
    plane: values reach ~1e10, and the index-order sums differ from XLA's
    einsum in the last bits (measured up to 6.5e-7 relative, 1024
    absolute), so rtol 2e-6 with atol 0.5 for entries near 0; the top-4
    picks equal except where the estimates tie within that tolerance."""
    px = _px(signed).astype(np.float32)
    px4 = np.concatenate([px, np.zeros_like(px[:, :1])], axis=1)
    ref = np.asarray(jbc67._shape_estimates_table(
        jnp.asarray(px4), 1, 3, n_shapes=32, off_axis=True, axis_w=0.0))
    got = _shape_estimates_table(torch.from_numpy(px4), n_shapes=32,
                                 axis_w=0.0).numpy()
    assert got.shape == (32, px.shape[2])
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=0.5)
    picks_r = np.stack([np.asarray(s) for s in
                        jbc67._top_k_shapes(jnp.asarray(ref), 4)])
    picks_g = np.stack([s.numpy() for s in
                        _top_k_shapes(torch.from_numpy(got), 4)])
    for b in np.nonzero(np.any(picks_g != picks_r, axis=0))[0]:
        np.testing.assert_allclose(np.sort(ref[picks_g[:, b], b]),
                                   np.sort(ref[picks_r[:, b], b]),
                                   rtol=2e-6, atol=0.5)
