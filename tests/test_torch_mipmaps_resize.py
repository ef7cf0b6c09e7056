"""The port's resize and mipmaps (directxtex_tpu_torch/ops/resize.py,
ops/mipmaps.py) held against the JAX package's on the CPU.

`filter_weights` (host numpy, copied verbatim) is pinned equal to the JAX
package's for every mode and boundary on several sizes, live. The JAX
package's resize, 2D and 3D mips and alpha-coverage outputs are frozen in
tests/golden/image_ops.npz (tests/golden/generate_image_ops.py, which
also defines the seeded inputs); the port runs them here on the same
inputs. Tolerances:

- bit for bit: point and box mips without sRGB, the alpha-coverage
  fraction and the coverage-scaled levels;
- within 4 ulp of the value or 1e-6 absolute (all data is in [0, 1]):
  resize, the filtered mips (2D and 3D), and every sRGB case - the two
  products round in XLA's summation order and torch's, and sRGB's `pow`
  is numerics.power against XLA's (ROADMAP queue 3).

The JAX package fails on three odd-size cases (box on an odd side, 2D and
3D; point on an odd side); the port raises ValueError there, and a test
shows both side by side.
"""

import importlib
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from directxtex_tpu.formats.dxgi import FMT as JFMT
from directxtex_tpu.ops.flags import TEX_FILTER_FLAGS as JTF
from directxtex_tpu.texture import TexDimension as JDim
from directxtex_tpu.texture import Texture as JTexture
from directxtex_tpu_torch.formats.dxgi import FMT
from directxtex_tpu_torch.ops.flags import TEX_FILTER_FLAGS as TF
from directxtex_tpu_torch.texture import TexDimension, Texture

# the modules (the ops package's names are the functions)
mipmaps = importlib.import_module("directxtex_tpu_torch.ops.mipmaps")
resize = importlib.import_module("directxtex_tpu_torch.ops.resize")
jmip = importlib.import_module("directxtex_tpu.ops.mipmaps")
jrs = importlib.import_module("directxtex_tpu.ops.resize")

GOLDEN = pathlib.Path(__file__).parent / "golden"
_spec = importlib.util.spec_from_file_location(
    "generate_image_ops", GOLDEN / "generate_image_ops.py")
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frozen():
    return np.load(GOLDEN / "image_ops.npz")


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _exact(got, want, what):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _close(got, want, what) -> int:
    """Within 4 ulp of the JAX value or 1e-6 absolute; returns the count
    of values that differ."""
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    tol = np.maximum(4 * np.spacing(np.abs(want)).astype(np.float64), 1e-6)
    bad = ~(d <= tol)
    assert not bad.any(), (what, d[bad].max(), int(bad.sum()))
    return int((_bits(got) != _bits(want)).sum())


def _n_levels(frozen, key) -> int:
    return sum(bool(re.fullmatch(re.escape(key) + r"_l\d+", k))
               for k in frozen.files)


def _tex(fmt, data, dim=None):
    return Texture.from_array(data, getattr(FMT, fmt), dimension=dim,
                              device="cpu")


# -- filter_weights ---------------------------------------------------------

SIZES = [(1, 1), (1, 3), (2, 1), (4, 2), (5, 2), (7, 3), (8, 4), (9, 4),
         (12, 5), (16, 23), (40, 30), (3, 8), (10, 10)]


@pytest.mark.parametrize("mode", list(gen.FILTERS.values()),
                         ids=list(gen.FILTERS))
def test_filter_weights_pinned(mode):
    """The host matrices equal the JAX package's, for every boundary."""
    for wrap, mirror in ((False, False), (True, False), (False, True)):
        for n_in, n_out in SIZES:
            got = resize.filter_weights(n_in, n_out, mode, wrap, mirror)
            want = jrs.filter_weights(n_in, n_out, mode, wrap, mirror)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    assert resize.filter_weights.cache_info().maxsize == 256


# -- resize -----------------------------------------------------------------

def _resize_case(case, i, frozen):
    key, fmt, shape, (w, h), flags = case
    tex = _tex(fmt, gen.image(100 + i, shape))
    out = resize.resize(tex, w, h, TF(flags))
    assert out.metadata.width == w and out.metadata.height == h
    assert out.metadata.mip_levels == 1 and out.metadata.format == tex.format
    return _close(out.levels[0], frozen[key], key)


@pytest.mark.parametrize("name", list(gen.FILTERS))
def test_resize_matches_jax(name, frozen):
    """Down, up and exact halving; SEPARATE_ALPHA on an sRGB format;
    WRAP with SRGB_IN; MIRROR with SEPARATE_ALPHA."""
    cases = list(enumerate(gen.resize_cases()))
    mine = [(i, c) for i, c in cases if c[0].startswith(f"rs_{name}_")]
    assert len(mine) == 6
    for i, c in mine:
        _resize_case(c, i, frozen)


def test_resize_corner_sizes(frozen):
    """1x1 -> 3x2, 1x2 -> 1x1, 3x5 -> 6x10, 6x10 -> 3x5."""
    cases = [(i, c) for i, c in enumerate(gen.resize_cases())
             if c[0].startswith("rs_corner")]
    assert len(cases) == 12
    for i, c in cases:
        _resize_case(c, i, frozen)


def test_resize_array_ranks_and_refusals():
    img = torch.from_numpy(gen.image(7, (2, 9, 14)))
    four = resize.resize_array(img, 5, 4, TF.CUBIC)
    three = resize.resize_array(img[1], 5, 4, TF.CUBIC)
    assert tuple(four.shape) == (2, 4, 5, 4)
    assert torch.equal(three, four[1])
    want = np.asarray(jrs.resize_array(img.numpy()[1], 5, 4, JTF.CUBIC))
    _close(three, want, "rank-3 resize_array")
    tex = _tex("R8G8B8A8_UNORM", gen.image(8, (1, 8, 8)))
    with pytest.raises(ValueError):
        resize.resize(tex, 0, 4)
    bc = Texture(tex.metadata.with_format(FMT.BC1_UNORM), tex.levels)
    with pytest.raises(ValueError):
        resize.resize(bc, 4, 4)
    # a weight matrix is copied to a device once
    a = resize.weights_on(9, 4, int(TF.CUBIC), False, False, "cpu")
    assert a is resize.weights_on(9, 4, int(TF.CUBIC), False, False, "cpu")


# -- 2D mipmaps -------------------------------------------------------------

def _mip_case(case, i, frozen, exact):
    key, fmt, shape, flags, levels = case
    tex = _tex(fmt, gen.image(200 + i, shape))
    out = mipmaps.generate_mipmaps(tex, TF(flags), levels)
    assert out.mip_levels == out.metadata.mip_levels == _n_levels(
        frozen, key), key
    for m, lvl in enumerate(out.levels):
        if exact and "SRGB" not in fmt:
            _exact(lvl, frozen[f"{key}_l{m}"], f"{key} level {m}")
        else:
            _close(lvl, frozen[f"{key}_l{m}"], f"{key} level {m}")


@pytest.mark.parametrize("name", list(gen.FILTERS))
def test_mipmaps_matches_jax(name, frozen):
    """Power-of-two chains (2 items), and on an sRGB format; point and
    box (and linear, which halves by the box) bit for bit."""
    cases = list(enumerate(gen.mip_cases()))
    for i, c in cases:
        if c[0] in (f"mip_{name}", f"mip_{name}_srgb"):
            _mip_case(c, i, frozen,
                      exact=name in ("point", "box", "default", "linear"))


@pytest.mark.parametrize("name", ["linear", "cubic", "triangle"])
def test_mipmaps_odd_sides_match_jax(name, frozen):
    """12x20 -> 6x10 -> 3x5 -> 1x2 -> 1x1 (linear halves the even levels
    by the box, the odd ones by the filter), WRAP, MIRROR with SRGB_IN,
    and chains from 3x5 and 1x2."""
    cases = list(enumerate(gen.mip_cases()))
    mine = [(i, c) for i, c in cases
            if c[0].startswith(f"mip_{name}_") and c[0] != f"mip_{name}_srgb"]
    assert len(mine) == 5 + (name == "linear")
    for i, c in mine:
        _mip_case(c, i, frozen, exact=False)


def test_mipmaps_levels_and_refusals(frozen):
    cases = list(enumerate(gen.mip_cases()))
    for i, c in cases:
        if c[0] == "mip_box_levels3":
            _mip_case(c, i, frozen, exact=True)
    tex = _tex("R8G8B8A8_UNORM", gen.image(9, (1, 32, 32)))
    with pytest.raises(ValueError):
        mipmaps.generate_mipmaps(tex, levels=10)
    with pytest.raises(ValueError):
        mipmaps.generate_mipmaps(tex, TF(0x600000))
    bc = Texture(tex.metadata.with_format(FMT.BC7_UNORM), tex.levels)
    with pytest.raises(ValueError):
        mipmaps.generate_mipmaps(bc)
    # a volume goes to generate_mipmaps_3d, as in the JAX package
    vol = _tex("R32G32B32A32_FLOAT", gen.image(10, (4, 4, 8)),
               TexDimension.TEXTURE3D)
    a = mipmaps.generate_mipmaps(vol, TF.BOX)
    b = mipmaps.generate_mipmaps_3d(vol, TF.BOX)
    assert [tuple(x.shape) for x in a.levels] == [
        (4, 4, 8, 4), (2, 2, 4, 4), (1, 1, 2, 4), (1, 1, 1, 4)]
    assert all(torch.equal(x, y) for x, y in zip(a.levels, b.levels))


# -- 3D mipmaps -------------------------------------------------------------

@pytest.mark.parametrize("name", list(gen.FILTERS))
def test_mipmaps_3d_matches_jax(name, frozen):
    """8x4x16 volumes for every filter; for the filtered ones also odd
    sides, WRAP on an sRGB format and MIRROR with a partial chain."""
    for i, (key, fmt, shape, flags, levels) in enumerate(gen.mip3d_cases()):
        if not (key == f"m3_{name}" or key.startswith(f"m3_{name}_")):
            continue
        tex = _tex(fmt, gen.image(300 + i, shape), TexDimension.TEXTURE3D)
        out = mipmaps.generate_mipmaps_3d(tex, TF(flags), levels)
        assert out.mip_levels == _n_levels(frozen, key), key
        exact = name in ("point", "box", "default") and "SRGB" not in fmt
        for m, lvl in enumerate(out.levels):
            (_exact if exact else _close)(lvl, frozen[f"{key}_l{m}"],
                                          f"{key} level {m}")


# -- alpha coverage ---------------------------------------------------------

@pytest.mark.parametrize("case", gen.coverage_cases(), ids=lambda c: c[0])
def test_alpha_coverage_matches_jax(case, frozen):
    """The coverage fraction and every scaled level, bit for bit: the
    bisection's ten steps take the JAX package's decisions."""
    key, shape, flags, ref = case
    i = gen.coverage_cases().index(case)
    tex = _tex("R8G8B8A8_UNORM", gen.image(400 + i, (1,) + tuple(shape)))
    chain = mipmaps.generate_mipmaps(tex, TF(flags))
    cov = mipmaps.calculate_alpha_coverage(chain.levels[0][..., 3], ref)
    assert torch.is_tensor(cov) and cov.dim() == 0
    _exact(cov, frozen[f"{key}_cov"], f"{key} coverage")
    out = mipmaps.scale_mipmaps_alpha_for_coverage(chain, ref)
    assert out.mip_levels == chain.mip_levels
    for m, lvl in enumerate(out.levels):
        _exact(lvl, frozen[f"{key}_l{m}"], f"{key} level {m}")
    # the scale is a device scalar; coverage with a tensor scale
    s = mipmaps._estimate_scale(chain.levels[1][..., 3], ref, cov)
    assert torch.is_tensor(s) and s.dim() == 0
    want = jmip.calculate_alpha_coverage(chain.levels[1][..., 3].numpy(),
                                         ref, float(s))
    _exact(mipmaps.calculate_alpha_coverage(chain.levels[1][..., 3], ref, s),
           np.asarray(want), f"{key} coverage at the scale")


# -- where the JAX package fails --------------------------------------------

def _both(shape, fmt="R8G8B8A8_UNORM", dim=None):
    data = gen.image(11, shape)
    jdim = JDim.TEXTURE3D if dim else None
    return (JTexture.from_array(data, getattr(JFMT, fmt), dimension=jdim),
            _tex(fmt, data, dim))


@pytest.mark.parametrize("flt", ["DEFAULT", "BOX"])
def test_box_on_an_odd_side_jax_fails_port_refuses(flt):
    """12x12 -> 6x6 -> 3x3: the JAX package's reshape raises TypeError at
    the odd level; the port raises ValueError naming the case. On 16x16
    (no odd side) both give the same chain."""
    jt, pt = _both((1, 12, 12))
    with pytest.raises(TypeError):
        jmip.generate_mipmaps(jt, getattr(JTF, flt))
    with pytest.raises(ValueError, match="odd side"):
        mipmaps.generate_mipmaps(pt, getattr(TF, flt))
    jt, pt = _both((4, 6, 8), "R32G32B32A32_FLOAT", TexDimension.TEXTURE3D)
    with pytest.raises(TypeError):
        jmip.generate_mipmaps_3d(jt, getattr(JTF, flt))
    with pytest.raises(ValueError, match="odd side"):
        mipmaps.generate_mipmaps_3d(pt, getattr(TF, flt))
    jt, pt = _both((1, 16, 16))
    a = jmip.generate_mipmaps(jt, getattr(JTF, flt)).levels
    b = mipmaps.generate_mipmaps(pt, getattr(TF, flt)).levels
    for x, y in zip(a, b):
        _exact(y, np.asarray(x), flt)


def test_point_on_an_odd_side_jax_leaves_its_sizes_port_refuses():
    """POINT from 12x12: the JAX package's 3x3 level gives 2x2, and its
    chain ends at 2x2 where its own mip count expects 1x1 (2D and 3D);
    the port raises ValueError."""
    jt, pt = _both((1, 12, 12))
    levels = jmip.generate_mipmaps(jt, JTF.POINT).levels
    assert [tuple(x.shape[1:3]) for x in levels] == [
        (12, 12), (6, 6), (3, 3), (2, 2)]
    with pytest.raises(ValueError, match="odd side"):
        mipmaps.generate_mipmaps(pt, TF.POINT)
    jt, pt = _both((6, 6, 6), "R32G32B32A32_FLOAT", TexDimension.TEXTURE3D)
    levels = jmip.generate_mipmaps_3d(jt, JTF.POINT).levels
    assert tuple(levels[-1].shape[:3]) == (2, 2, 2)
    with pytest.raises(ValueError, match="odd side"):
        mipmaps.generate_mipmaps_3d(pt, TF.POINT)
