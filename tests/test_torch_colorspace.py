"""The port's float helpers, sRGB conversion and the normal map's
neighbourhood fetch on the CPU.

- numerics.sqrt is numpy's correctly rounded f32 sqrt (torch's own f32
  sqrt on the CPU is not), numerics.power the f64 route with the exponent
  rounded to f32, rdiv / fdiv IEEE divisions.
- srgb_to_linear / linear_to_srgb are bit-equal to the f64-route formula
  evaluated in numpy, on the values of tests/golden/bc12345.npz; the JAX
  package's values are that formula with its pow at most 1 ulp away
  (XLA's pow is an approximation of its own), and the count of values
  that differ from JAX's is asserted small and printed.
- ops.normalmaps._shift equals the JAX package's for the four mirror
  settings.
- With numerics.sqrt, the BC7 and BC6H shape-estimate tables equal the
  JAX package's frozen tables bit for bit (torch's f32 sqrt moved their
  last bits).

Torch runs on one thread."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.ops import normalmaps as jnormalmaps
from directxtex_tpu_torch import numerics
from directxtex_tpu_torch.ops import colorspace, normalmaps

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
# srgb_x values on which the port may differ from JAX's: at most 1 in 200
# (XLA's pow moved 0.07% of uniform values by 1 ulp)
MAX_ULP_SHARE = 1 / 200


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frozen():
    return np.load(GOLDEN / "bc12345.npz")


def _values(n=1 << 20, seed=11):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, 4, n // 2),
                           rng.standard_normal(n // 2) ** 2 * 100]
                          ).astype(np.float32)


def test_sqrt_is_correctly_rounded():
    x = _values()
    got = numerics.sqrt(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.sqrt(x).view(np.uint32))


def test_power_is_the_f64_route():
    x = _values()[:1 << 16] / np.float32(400)
    for e in (2.4, 1.0 / 2.4):
        want = np.power(x.astype(np.float64),
                        np.float64(np.float32(e))).astype(np.float32)
        got = numerics.power(torch.from_numpy(x), e).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_divisions_are_ieee():
    x = _values(1 << 16) + np.float32(0.5)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(numerics.rdiv(1.0, t).numpy(),
                                  np.float32(1.0) / x)
    np.testing.assert_array_equal(numerics.fdiv(t, 7.0).numpy(),
                                  x / np.float32(7.0))
    np.testing.assert_array_equal(numerics.sum0(t.reshape(16, -1)).numpy(),
                                  _index_order_sum(x.reshape(16, -1)))


def _index_order_sum(x):
    s = x[0].copy()
    for row in x[1:]:
        s = s + row
    return s


def _numpy_srgb(x, to_linear: bool, nudge: int = 0):
    """The port's formulas in numpy: f32 operations, pow in f64 with the
    exponent rounded to f32, rounded once to f32 (and moved by `nudge`
    ulps)."""
    def pw(v, e):
        p = np.power(v.astype(np.float64),
                     np.float64(np.float32(e))).astype(np.float32)
        return np.nextafter(p, np.float32(nudge * np.inf)) if nudge else p
    v = np.clip(x, np.float32(0), np.float32(1))
    if to_linear:
        lin = v * np.float32(1.0 / 12.92)
        exp = pw((v + np.float32(0.055)) * np.float32(1.0 / 1.055), 2.4)
        return np.where(v < np.float32(0.04045), lin, exp)
    small = v * np.float32(12.92)
    big = np.float32(1.055) * pw(v, 1.0 / 2.4) - np.float32(0.055)
    return np.where(v < np.float32(0.0031308), small, big)


@pytest.mark.parametrize("name", ["srgb_to_linear", "linear_to_srgb"])
def test_srgb_conversion_matches(frozen, name):
    """Bit-equal to the numpy formula; JAX's value is that formula with
    its pow at most 1 ulp away (so within 1 ulp for srgb_to_linear; the
    1.055 * p - 0.055 of linear_to_srgb can carry it to 2)."""
    x = frozen["srgb_x"]
    to_linear = name == "srgb_to_linear"
    got = getattr(colorspace, name)(torch.from_numpy(x)).numpy()
    want = _numpy_srgb(x, to_linear)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    jax_out = frozen[name].view(np.uint32)
    near = np.zeros(x.shape, bool)
    for nudge in (-1, 0, 1):
        near |= _numpy_srgb(x, to_linear, nudge).view(np.uint32) == jax_out
    assert near.all(), x[~near][:8]
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - jax_out.view(np.int32).astype(np.int64))
    n = int((ulps != 0).sum())
    print(f"{name}: {n} of {x.size} values differ from JAX's "
          f"(ulps: {np.bincount(ulps).tolist()})")
    assert n <= MAX_ULP_SHARE * x.size
    if to_linear:
        assert ulps.max() <= 1


def test_apply_keeps_alpha():
    rgba = torch.from_numpy(np.random.default_rng(4).random(
        (8, 8, 4), dtype=np.float32))
    for fn, one in ((colorspace.apply_srgb_to_linear,
                     colorspace.srgb_to_linear),
                    (colorspace.apply_linear_to_srgb,
                     colorspace.linear_to_srgb)):
        out = fn(rgba)
        assert torch.equal(out[..., 3], rgba[..., 3])
        assert torch.equal(out[..., :3], one(rgba[..., :3]))
    assert colorspace.GRAYSCALE == (0.2125, 0.7154, 0.0721)


@pytest.mark.parametrize("mirror_u,mirror_v", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_shift_matches_jax(mirror_u, mirror_v):
    h = np.random.default_rng(9).random((2, 5, 7), dtype=np.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            want = np.asarray(jnormalmaps._shift(jnp.asarray(h), dy, dx,
                                                 mirror_u, mirror_v))
            got = normalmaps._shift(torch.from_numpy(h), dy, dx, mirror_u,
                                    mirror_v).numpy()
            np.testing.assert_array_equal(got, want)


def _tables():
    """(name, the port's table as a function of the sqrt it takes, JAX's
    frozen table): BC7 two- and three-subset shape estimates, BC6H's
    32-shape table unsigned and signed."""
    from directxtex_tpu_torch.bc import bc67
    refs = np.load(GOLDEN / "jax_refs.npz")
    out = []
    for k in sorted(f for f in refs.files
                    if f.startswith("enc_") and f.endswith("_px")):
        pxf = torch.from_numpy(refs[k].astype(np.float32))
        out.append((k[:-3], lambda pxf=pxf: bc67._shape_estimates_table(pxf),
                    refs[k[:-2] + "table"]))
    sub3 = np.load(GOLDEN / "bc7_3subsets.npz")
    px3 = bc67._quantize_ldr(torch.from_numpy(sub3["blocks"])).float()
    out.append(("3subsets", lambda: bc67._shape_estimates_table(
        px3, partitions=2), sub3["table"]))
    bc6 = np.load(GOLDEN / "bc6h_encode_refs.npz")
    for pre in ("u_", "s_"):
        px = bc6[pre + "px"].astype(np.float32)
        px4 = torch.from_numpy(np.concatenate([px, np.zeros_like(px[:, :1])],
                                              axis=1))
        out.append(("bc6h_" + pre, lambda px4=px4: bc67._shape_estimates_table(
            px4, n_shapes=32, axis_w=0.0), bc6[pre + "shape_table"]))
    return out


def test_shape_tables_equal_jax_with_ieee_sqrt(monkeypatch):
    """With numerics.sqrt the shape-estimate tables equal the JAX
    package's bit for bit; with torch's own f32 sqrt (the port before it
    took numerics.sqrt) they differ in the last bits, printed. The blocks
    of bc6h_unshared.npz whose top 4 the unshared ranking moves against
    JAX's are printed too (ROADMAP.md queue 3)."""
    from directxtex_tpu_torch.bc import bc6h, bc67
    tables = _tables()
    for name, table, ref in tables:
        np.testing.assert_array_equal(table().numpy(), ref, err_msg=name)
    unshared = np.load(GOLDEN / "bc6h_unshared.npz")
    for signed, pre in ((False, "u_"), (True, "s_")):
        px = bc6h.px_of_blocks(torch.from_numpy(unshared[pre + "blocks"]),
                               signed)
        moved = np.nonzero((bc6h._bc6h_shapes_plain(px).numpy()
                            != unshared[pre + "picks"]).any(axis=0))[0]
        print(f"bc6h_unshared {pre}: the ranking moves blocks {moved}")
    monkeypatch.setattr(bc67, "_sqrt", torch.sqrt)
    for name, table, ref in tables:
        d = np.abs(table().numpy().astype(np.float64) - ref)
        rel = d / np.maximum(np.abs(ref), 1.0)
        print(f"{name}: torch.sqrt's table differs by up to {d.max()} "
              f"({rel.max():.3g} relative)")
