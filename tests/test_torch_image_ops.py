"""The port's image ops (directxtex_tpu_torch/ops: fliprotate, pmalpha,
misc, normalmaps, rotatecolor, dither's diffusion branch and the ops
package's names) held against the JAX package's on the CPU.

Flip / rotate, premultiply, copy_rectangle, evaluate / transform_image
and the diffusion dither run the JAX package live (a few small eager
ops, or its host library); the normal map, rotate_color / PQ and MSE /
PSNR are held against its outputs frozen in tests/golden/image_ops.npz
(tests/golden/generate_image_ops.py defines the seeded inputs).
Tolerances:

- bit for bit: flip_rotate, premultiply / demultiply without sRGB,
  copy_rectangle, transform_image, compute_normal_map (every channel,
  flag and target), rotate_color's five matrix rotations, and the
  diffusion dither (against the JAX package's native fs_dither and the
  port's numpy twin);
- the `pow` values (sRGB premultiply, pq_encode / pq_decode and the
  rotations through them): numerics.power against XLA's `pow`, counted
  and held step by step - each `pow` within 2 ulp of XLA's on the same
  input, everything else bit for bit (ROADMAP queue 3);
- compute_mse / compute_psnr: relative 1e-6 (the sums' order).
"""

import importlib
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.formats.dxgi import FMT as JFMT
from directxtex_tpu.ops.flags import CMSE_FLAGS as JCMSE
from directxtex_tpu.ops.flags import TEX_FR_FLAGS as JFR
from directxtex_tpu.ops.flags import TEX_PMALPHA_FLAGS as JPM
from directxtex_tpu.texture import Texture as JTexture
from directxtex_tpu_torch.formats.dxgi import FMT
from directxtex_tpu_torch.ops.flags import CMSE_FLAGS, CNMAP_FLAGS
from directxtex_tpu_torch.ops.flags import TEX_FILTER_FLAGS as TF
from directxtex_tpu_torch.ops.flags import TEX_FR_FLAGS as FR
from directxtex_tpu_torch.ops.flags import TEX_PMALPHA_FLAGS as PM
from directxtex_tpu_torch.texture import TexAlphaMode, Texture

ops = importlib.import_module("directxtex_tpu_torch.ops")
fliprotate = importlib.import_module("directxtex_tpu_torch.ops.fliprotate")
pmalpha = importlib.import_module("directxtex_tpu_torch.ops.pmalpha")
misc = importlib.import_module("directxtex_tpu_torch.ops.misc")
normalmaps = importlib.import_module("directxtex_tpu_torch.ops.normalmaps")
rotatecolor = importlib.import_module("directxtex_tpu_torch.ops.rotatecolor")
dither = importlib.import_module("directxtex_tpu_torch.ops.dither")
native = importlib.import_module("directxtex_tpu_torch.native")
numerics = importlib.import_module("directxtex_tpu_torch.numerics")
jops = importlib.import_module("directxtex_tpu.ops")
jfliprotate = importlib.import_module("directxtex_tpu.ops.fliprotate")
jpmalpha = importlib.import_module("directxtex_tpu.ops.pmalpha")
jmisc = importlib.import_module("directxtex_tpu.ops.misc")
jnormalmaps = importlib.import_module("directxtex_tpu.ops.normalmaps")
jrotatecolor = importlib.import_module("directxtex_tpu.ops.rotatecolor")
jdither = importlib.import_module("directxtex_tpu.ops.dither")
jnative = importlib.import_module("directxtex_tpu.native")

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


def _np(a) -> np.ndarray:
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _exact(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _ulps(got, want) -> np.ndarray:
    """Distance in f32 ulps (order of the bit patterns; equal NaNs 0)."""
    def ordered(x):
        b = _bits(x).astype(np.int64)
        return np.where(b < 0, -(b & 0x7FFFFFFF), b)
    d = np.abs(ordered(_np(got)) - ordered(_np(want)))
    return np.where(np.isnan(_np(got)) & np.isnan(_np(want)), 0, d)


def _tex(fmt, data):
    return Texture.from_array(data, getattr(FMT, fmt), device="cpu")


def _jtex(fmt, data):
    return JTexture.from_array(data, getattr(JFMT, fmt))


# -- the package and its tables ---------------------------------------------

def test_ops_all_equals_jax():
    assert set(ops.__all__) == set(jops.__all__)
    assert len(ops.__all__) == len(set(ops.__all__))
    for name in ops.__all__:
        assert getattr(ops, name) is not None, name
    assert {"flip_rotate", "resize", "generate_mipmaps", "compute_mse",
            "premultiply_alpha", "compute_normal_map"} <= set(ops.__all__)


def test_tables_pinned():
    assert normalmaps._LUM_SCALE == jnormalmaps._LUM_SCALE
    np.testing.assert_array_equal(np.float32(misc._GAMMA22),
                                  np.asarray(jmisc._GAMMA22))
    assert [f.name for f in misc._SRGB_MSE_FORMATS] == [
        f.name for f in jmisc._SRGB_MSE_FORMATS]
    for name in ("_M_709_TO_2020", "_M_2020_TO_709", "_M_P3D65_TO_2020",
                 "_M_709_TO_P3D65", "_M_P3D65_TO_709"):
        a, b = getattr(rotatecolor, name), getattr(jrotatecolor, name)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for name in ("_PQ_M1", "_PQ_M2", "_PQ_C1", "_PQ_C2", "_PQ_C3",
                 "DEFAULT_PAPER_WHITE_NITS"):
        assert getattr(rotatecolor, name) == getattr(jrotatecolor, name)
    assert [(m.name, m.value) for m in rotatecolor.ROTATE_COLOR] == [
        (m.name, m.value) for m in jrotatecolor.ROTATE_COLOR]
    assert native.SOURCE.read_bytes() == (
        pathlib.Path(jnative.__file__).parent / "dither.cpp").read_bytes()


# -- flip / rotate ----------------------------------------------------------

@pytest.mark.parametrize("rot", [0, 1, 2, 3])
def test_flip_rotate_matches_jax(rot):
    """Every rotation with no flip, H, V and both, on a 2-item 3x5
    texture and a 1x2 one: pixels bit for bit, sizes swapped at 90 and
    270 degrees."""
    for shape in ((2, 3, 5), (1, 1, 2)):
        data = gen.image(600 + rot, shape)
        pt, jt = _tex("R8G8B8A8_UNORM", data), _jtex("R8G8B8A8_UNORM", data)
        for flip in (0, 0x08, 0x10, 0x18):
            got = fliprotate.flip_rotate(pt, FR(rot | flip))
            want = jfliprotate.flip_rotate(jt, JFR(rot | flip))
            _exact(got.levels[0], want.levels[0], f"{rot} {flip}")
            assert got.metadata.width == want.metadata.width
            assert got.metadata.height == want.metadata.height
            assert got.metadata.mip_levels == 1
            assert got.levels[0].is_contiguous()


# -- premultiplied alpha ----------------------------------------------------

PM_CASES = [("R8G8B8A8_UNORM", 0), ("R8G8B8A8_UNORM", 0x2),
            ("R32G32B32A32_FLOAT", 0x1), ("R8G8B8A8_UNORM_SRGB", 0),
            ("R8G8B8A8_UNORM_SRGB", 0x1 | 0x2), ("R8G8B8A8_UNORM", 0x3000000),
            ("B8G8R8A8_UNORM_SRGB", 0x2)]


@pytest.mark.parametrize("case", PM_CASES, ids=lambda c: f"{c[0]}_{c[1]:x}")
def test_premultiply_alpha_matches_jax(case):
    """Straight -> premultiplied and back (REVERSE), with IGNORE_SRGB and
    the SRGB flag; the alpha mode in the metadata. Without sRGB bit for
    bit; with it, `pow` within 2 ulp of XLA's and the multiply exact on
    the JAX package's linear values."""
    fmt, flags = case
    data = gen.image(610 + PM_CASES.index(case), (2, 6, 10))
    got = pmalpha.premultiply_alpha(_tex(fmt, data), PM(flags))
    want = jpmalpha.premultiply_alpha(_jtex(fmt, data), JPM(flags))
    mode = TexAlphaMode.STRAIGHT if flags & 0x2 else \
        TexAlphaMode.PREMULTIPLIED
    assert got.metadata.alpha_mode() == mode
    assert got.metadata.misc_flags2 == want.metadata.misc_flags2
    srgb = ("SRGB" in fmt or flags & 0x3000000) and not flags & 0x1
    if not srgb:
        _exact(got.levels[0], want.levels[0], str(case))
        return
    # step by step: sRGB -> linear, the multiply, linear -> sRGB
    from directxtex_tpu.ops import colorspace as jcs
    from directxtex_tpu_torch.ops import colorspace as cs
    lin_j = np.array(jcs.apply_srgb_to_linear(jnp.asarray(data)))
    assert _ulps(cs.apply_srgb_to_linear(torch.from_numpy(data)),
                 lin_j).max() <= 2
    f = pmalpha.demultiply_values if flags & 0x2 else \
        pmalpha.premultiply_values
    jf = jpmalpha.demultiply_values if flags & 0x2 else \
        jpmalpha.premultiply_values
    mid = f(torch.from_numpy(lin_j))
    _exact(mid, jf(jnp.asarray(lin_j)), "the multiply")
    assert _ulps(cs.apply_linear_to_srgb(mid), jcs.apply_linear_to_srgb(
        jnp.asarray(mid.numpy()))).max() <= 2
    assert _ulps(got.levels[0], want.levels[0]).max() <= 2 ** 8


def test_premultiply_edges_and_refusals():
    """a == 0 keeps its colour in demultiply; refused formats raise."""
    data = gen.image(620, (1, 4, 6))
    data[0, 0, 0, :3] = [0.3, -0.0, 0.7]
    data[0, 0, 0, 3] = 0.0
    v = torch.from_numpy(data)
    got = pmalpha.demultiply_values(v)
    _exact(got, jpmalpha.demultiply_values(jnp.asarray(data)))
    _exact(got[0, 0, 0], v[0, 0, 0])
    _exact(pmalpha.premultiply_values(v),
           jpmalpha.premultiply_values(jnp.asarray(data)))
    for fmt in (FMT.BC1_UNORM, FMT.NV12, FMT.P8, FMT.R8G8B8A8_TYPELESS):
        tex = Texture(_tex("R8G8B8A8_UNORM", data).metadata.with_format(fmt),
                      [v])
        with pytest.raises(ValueError):
            pmalpha.premultiply_alpha(tex)


# -- misc -------------------------------------------------------------------

def _mse_case(case, frozen):
    key, ch, flags, f1, f2 = case
    a, b = gen.mse_inputs(ch)
    s, v = misc.compute_mse(torch.from_numpy(a), torch.from_numpy(b),
                            CMSE_FLAGS(flags),
                            getattr(FMT, f1) if f1 else None,
                            getattr(FMT, f2) if f2 else None)
    assert s.dtype == v.dtype == torch.float32 and tuple(v.shape) == (4,)
    np.testing.assert_allclose(v.numpy(), frozen[f"{key}_mse_v"], rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(float(s), frozen[f"{key}_mse"], rtol=1e-6)
    np.testing.assert_allclose(float(misc.compute_psnr(
        torch.from_numpy(a), torch.from_numpy(b), CMSE_FLAGS(flags))),
        frozen[f"{key}_psnr"], rtol=1e-6)


@pytest.mark.parametrize("half", [0, 1])
def test_compute_mse_psnr_match_jax(half, frozen):
    """Default, gamma 2.2 on either image, X2 bias, ignored channels,
    RGB inputs and the flags each format implies."""
    for case in gen.mse_cases()[half::2]:
        _mse_case(case, frozen)


def test_compute_mse_on_numpy_and_implied_flags():
    a, b = gen.mse_inputs(4)
    s, v = misc.compute_mse(a, b, device="cpu")
    js, jv = jmisc.compute_mse(a, b)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6)
    for fmt in list(FMT)[:120]:
        for which in (1, 2):
            assert int(misc._implied_flags(fmt, which, CMSE_FLAGS(0))) == \
                int(jmisc._implied_flags(getattr(JFMT, fmt.name), which,
                                         JCMSE(0)))
    with pytest.raises(ValueError):
        misc.compute_mse(torch.zeros(4, 2), torch.zeros(4, 2))


def test_copy_rectangle_matches_jax():
    src, dst = gen.image(630, (7, 9)), gen.image(631, (5, 6))
    for rect, off in (((1, 2, 4, 3), (2, 1)), ((0, 0, 6, 5), (0, 0)),
                      ((8, 6, 1, 1), (5, 4))):
        got = misc.copy_rectangle(torch.from_numpy(src), rect,
                                  torch.from_numpy(dst), *off)
        _exact(got, jmisc.copy_rectangle(jnp.asarray(src), rect,
                                         jnp.asarray(dst), *off))
    d = torch.from_numpy(dst)
    misc.copy_rectangle(torch.from_numpy(src), (1, 2, 4, 3), d, 2, 1)
    assert torch.equal(d, torch.from_numpy(dst))     # dst is not written
    for rect, off in (((6, 0, 4, 1), (0, 0)), ((0, 0, 2, 2), (5, 0))):
        with pytest.raises(ValueError):
            misc.copy_rectangle(torch.from_numpy(src), rect, d, *off)


def test_evaluate_and_transform_image_match_jax():
    data = gen.image(640, (2, 4, 6))
    pt, jt = _tex("R8G8B8A8_UNORM", data), _jtex("R8G8B8A8_UNORM", data)
    seen, jseen = [], []
    misc.evaluate_image(pt, seen.append)
    jmisc.evaluate_image(jt, lambda p: jseen.append(np.asarray(p)))
    assert len(seen) == len(jseen) == 2
    for a, b in zip(seen, jseen):
        assert torch.is_tensor(a) and a.device == pt.device
        _exact(a, b)
    one = []
    plane = pt.levels[0][1]
    misc.evaluate_image(plane, one.append)
    assert one == [plane]
    got = misc.transform_image(pt, lambda p: p * 0.5 + p[..., 3:4])
    want = jmisc.transform_image(jt, lambda p: p * 0.5 + p[..., 3:4])
    _exact(got.levels[0], want.levels[0])
    with pytest.raises(ValueError):
        misc.transform_image(pt, lambda p: p[..., :3])


# -- normal map -------------------------------------------------------------

def _normal_case(case, i, frozen):
    key, shape, flags, amp, fmt = case
    tex = _tex("R8G8B8A8_UNORM", gen.image(500 + i, shape))
    out = normalmaps.compute_normal_map(tex, CNMAP_FLAGS(flags), amp,
                                        getattr(FMT, fmt))
    assert out.metadata.format == getattr(FMT, fmt)
    _exact(out.levels[0], frozen[key], key)


def _normal_cases(prefix):
    return [(i, c) for i, c in enumerate(gen.normal_cases())
            if c[0].startswith(prefix)]


def test_normal_map_channels_match_jax(frozen):
    """Every CNMAP channel (0 = red, R, G, B, A, luminance), 2 items."""
    cases = _normal_cases("nm_ch")
    assert len(cases) == 6
    for i, c in cases:
        _normal_case(c, i, frozen)


@pytest.mark.parametrize("k", range(7))
def test_normal_map_flags_and_targets_match_jax(k, frozen):
    """MIRROR_U / V, INVERT_SIGN, COMPUTE_OCCLUSION and mixes, into
    UNORM, SNORM and FLOAT targets (quantized by pack / unpack)."""
    cases = _normal_cases(f"nm_f{k}_")
    assert len(cases) == 6
    for i, c in cases:
        _normal_case(c, i, frozen)


def test_normal_map_corners_and_refusals(frozen):
    """1x1, 1x2, 3x5, 6x10; unsupported targets raise."""
    cases = _normal_cases("nm_corner")
    assert len(cases) == 8
    for i, c in cases:
        _normal_case(c, i, frozen)
    tex = _tex("R8G8B8A8_UNORM", gen.image(650, (1, 4, 4)))
    for fmt in (FMT.BC1_UNORM, FMT.R8G8B8A8_UINT, FMT.NV12):
        with pytest.raises(ValueError):
            normalmaps.compute_normal_map(tex, fmt=fmt)
    with pytest.raises(ValueError):
        normalmaps._evaluate_height(tex.levels[0], CNMAP_FLAGS(0x6))
    # the luminance weights, in the JAX package's order
    lum = normalmaps._evaluate_height(tex.levels[0], CNMAP_FLAGS(5))
    _exact(lum, jnormalmaps._evaluate_height(jnp.asarray(
        tex.levels[0].numpy()), 5))


# -- color rotation and PQ --------------------------------------------------

def test_rotate_color_matrices_match_jax(frozen):
    """709to2020, 2020to709, P3D65to2020, 709toP3D65, P3D65to709 at both
    paper whites: bit for bit (the einsum over three terms)."""
    rgba = torch.from_numpy(gen.rotate_input())
    for key, rot, nits in gen.rotate_cases():
        if "HDR10" in rot:
            continue
        got = rotatecolor.rotate_color(rgba, rot, nits)
        _exact(got, frozen[key], key)
        _exact(got[..., 3], rgba[..., 3].numpy(), key + " alpha")
    with pytest.raises(ValueError):
        rotatecolor.rotate_color(rgba, "709to601")


def _pq_steps(v, nits, encode):
    """The port's PQ with XLA's `pow` results fed in where numerics.power
    differs: returns (each pow's worst ulp distance, the port's result
    bit-equal to the JAX package's when its pows take XLA's values)."""
    worst = []

    def pw(x, e):
        mine = numerics.power(x, e)
        theirs = torch.from_numpy(np.array(jnp.power(
            jnp.asarray(x.numpy()), e)))
        worst.append(int(_ulps(mine, theirs).max()))
        return theirs

    saved = rotatecolor.power
    rotatecolor.power = pw
    try:
        f = rotatecolor.pq_encode if encode else rotatecolor.pq_decode
        out = f(v, nits)
    finally:
        rotatecolor.power = saved
    return worst, out


def test_pq_matches_jax_step_by_step(frozen):
    """pq_encode / pq_decode at both paper whites: every `pow` within 2
    ulp of XLA's on the same input, and with XLA's `pow` values the rest
    bit for bit; the values that differ end to end are counted."""
    v = torch.from_numpy(gen.pq_input())
    for nits in gen.NITS:
        for encode, key, x in ((True, f"pq_enc_{int(nits)}", v),
                               (False, f"pq_dec_{int(nits)}",
                                numerics.clip(v, 0.0, 1.0))):
            worst, with_xla_pow = _pq_steps(x, nits, encode)
            assert max(worst) <= 2, (key, worst)
            _exact(with_xla_pow, frozen[key], key)
            f = rotatecolor.pq_encode if encode else rotatecolor.pq_decode
            got = f(x, nits)
            n = int((_ulps(got, frozen[key]) > 0).sum())
            print(f"{key}: {n} of {got.numel()} values differ end to end, "
                  f"at most {int(_ulps(got, frozen[key]).max())} ulp")


def test_rotate_color_hdr10_match_jax(frozen):
    """709toHDR10, P3D65toHDR10 (matrix then PQ) and HDR10to709 (PQ then
    matrix): the matrix bit for bit, PQ as above."""
    rgba = torch.from_numpy(gen.rotate_input())
    for key, rot, nits in gen.rotate_cases():
        if "HDR10" not in rot:
            continue
        got = rotatecolor.rotate_color(rgba, rot, nits)
        want = frozen[key]
        _exact(got[..., 3], want[..., 3], key + " alpha")
        if rot == "HDR10to709":
            _, lin = _pq_steps(rgba[..., :3], nits, False)
            mat = rotatecolor._apply_mat(torch.cat([lin, rgba[..., 3:]], -1),
                                         "_M_2020_TO_709")
            _exact(mat, want, key)
        else:
            m = "_M_709_TO_2020" if rot.startswith("709") else \
                "_M_P3D65_TO_2020"
            mat = rotatecolor._apply_mat(rgba, m)
            worst, enc = _pq_steps(mat[..., :3], nits, True)
            assert max(worst) <= 2, (key, worst)
            _exact(enc, want[..., :3], key)


# -- the diffusion dither ---------------------------------------------------

DITHER_FORMATS = ["B5G6R5_UNORM", "R8G8B8A8_UNORM", "R8G8B8A8_SNORM",
                  "R10G10B10A2_UNORM", "B4G4R4A4_UNORM", "R16G16_SNORM"]


def test_diffusion_dither_equals_jax_native_and_twin():
    """The port's library equals the JAX package's native fs_dither and
    the numpy twin bit for bit, UNORM and SNORM (clampzero off), on
    values beyond the range too; the twin on a 9x13 crop."""
    for k, name in enumerate(DITHER_FORMATS):
        img = gen.image(660 + k, (24, 37), -1.2, 1.3)
        scales, clampzero = dither.dither_scales(getattr(FMT, name))
        sc = np.asarray(scales, np.float32)
        want = jnative.fs_dither(img.copy(), sc, clampzero)
        crop = np.ascontiguousarray(img[:9, :13])
        twin = dither._fs_dither_py(crop, sc, clampzero)
        got = img.copy()
        assert native.fs_dither(got, sc, clampzero) is got   # in place
        _exact(got, want, name)
        _exact(native.fs_dither(crop, sc, clampzero), twin, name + " twin")
    with pytest.raises(ValueError):
        native.fs_dither(img[:, ::2], sc, clampzero)
    assert native.library() is native.library()


def test_diffusion_dither_on_tensors():
    """diffusion_dither takes [N, H, W, 4] and [H, W, 4] tensors, gives
    the JAX package's values on the tensor's device, leaves its input
    and an undithered format alone."""
    vals = torch.from_numpy(gen.image(670, (2, 8, 11)))
    keep = vals.clone()
    got = dither.diffusion_dither(vals, FMT.B5G6R5_UNORM)
    assert got.device == vals.device and got.dtype == torch.float32
    assert torch.equal(vals, keep)
    want = jdither.diffusion_dither(vals.numpy(), JFMT.B5G6R5_UNORM)
    _exact(got, want)
    _exact(dither.diffusion_dither(vals[1], FMT.B5G6R5_UNORM), want[1])
    assert dither.diffusion_dither(vals, FMT.R16G16B16A16_FLOAT) is vals
    _exact(dither.apply_dither(vals, FMT.R8G8B8A8_UNORM,
                               TF.DITHER_DIFFUSION),
           jdither.apply_dither(vals.numpy(), JFMT.R8G8B8A8_UNORM,
                                int(TF.DITHER_DIFFUSION)))


def test_failed_dither_build_raises(monkeypatch, tmp_path):
    """No compiler, or a source that does not compile: RuntimeError, and
    no fall-through to the numpy twin."""
    monkeypatch.setattr(native, "_library", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    img = gen.image(680, (4, 4))
    with pytest.raises(RuntimeError, match="building dither.cpp failed"):
        native.fs_dither(img, np.full(4, 255, np.float32), True)
    monkeypatch.setattr(native, "CXX", "g++")
    bad = tmp_path / "dither.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="building dither.cpp failed"):
        dither.diffusion_dither(torch.from_numpy(img), FMT.R8G8B8A8_UNORM)
    assert not list((tmp_path / "build").glob("*.so"))
