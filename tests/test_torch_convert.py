"""The port's format conversion (directxtex_tpu_torch/ops/convert.py and
the ordered dither of ops/dither.py) held against the JAX package's eager
convert_values / convert / convert_ex on the CPU.

Inputs are made with a numpy seed: f32 RGBA in [-1.5, 2.5] with NaN,
+-inf and values beyond the formats' ranges placed among them (finite
values only where sRGB is applied). Without sRGB the converted values and
the requantized textures are equal bit for bit. With sRGB the port's
`numerics.power` differs from XLA's `pow` by an ulp or two on a few
values (ROADMAP queue 3), so the values are held to 2.5e-7 (2 ulp at 1.0)
and the requantized texels are equal wherever the converted values are.
XLA's CPU code flushes f32 subnormals to zero (inputs and results of its
arithmetic, FTZ / DAZ); torch does not, on the CPU or on CUDA, so the
port keeps them, as IEEE arithmetic and the reference do. The inputs of
the bit-equal comparisons hold no subnormal;
`test_the_port_keeps_subnormals_xla_flushes` shows the difference (ROADMAP
queue 3). TEX_FILTER_DITHER_DIFFUSION (the host Floyd-Steinberg of
directxtex_tpu_torch/native) equals the JAX package's bit for bit.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu import texture as jtexture
from directxtex_tpu.formats.dxgi import FMT as JFMT
from directxtex_tpu.ops.flags import TEX_FILTER_FLAGS as JTF
from directxtex_tpu_torch.formats.dxgi import FMT
from directxtex_tpu_torch.ops.flags import TEX_FILTER_FLAGS as TF
from directxtex_tpu_torch.texture import Texture
from directxtex_tpu_torch.utils.errors import TexAbortError

conv = importlib.import_module("directxtex_tpu_torch.ops.convert")
jconv = importlib.import_module("directxtex_tpu.ops.convert")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


H, W = 8, 12
SPECIAL = np.array([np.nan, np.inf, -np.inf, -0.0, 1.0, -1.0, 0.5, 1.5,
                    -2.5, 255.0, 300.0, -200.0, 1.2e-38, 65504.0, 7e4],
                   np.float32)


def _values(seed: int, special: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.5, 2.5, (1, H, W, 4)).astype(np.float32)
    if special:
        idx = rng.choice(v.size, SPECIAL.size * 2, replace=False)
        v.reshape(-1)[idx] = np.concatenate([SPECIAL, SPECIAL])
    return v


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _flush(v: np.ndarray) -> np.ndarray:
    """v with its f32 subnormals flushed to a zero of their sign."""
    tiny = (v != 0) & (np.abs(v) < np.finfo(np.float32).tiny)
    return np.where(tiny, np.copysign(np.float32(0), v), v).astype(
        np.float32)


def _has_srgb(i, o, flags) -> bool:
    return bool("SRGB" in i or "SRGB" in o or flags & int(TF.SRGB))


# (in, out, flags): sRGB in and out, depth and stencil, RGB_COPY_*, the
# UNORM / SNORM / FLOAT remaps with and without FLOAT_X2BIAS, POS_ONLY,
# channel fills
C = TF
PAIRS = [
    ("R8G8B8A8_UNORM", "R16G16B16A16_FLOAT", 0),
    ("R8G8B8A8_UNORM_SRGB", "R16G16B16A16_FLOAT", 0),
    ("R32G32B32A32_FLOAT", "R8G8B8A8_UNORM_SRGB", 0),
    ("R32G32B32A32_FLOAT", "B8G8R8A8_UNORM", int(C.SRGB_IN)),
    ("R32G32B32A32_FLOAT", "R8G8B8A8_UNORM", int(C.SRGB)),
    ("R10G10B10_XR_BIAS_A2_UNORM", "R8G8B8A8_UNORM_SRGB", 0),
    ("R32G32B32A32_FLOAT", "R8G8B8A8_SNORM", 0),
    ("R8G8B8A8_SNORM", "R8G8B8A8_UNORM", 0),
    ("R32G32B32A32_FLOAT", "R8G8B8A8_UNORM", int(C.FLOAT_X2BIAS)),
    ("R8G8B8A8_UNORM", "R32G32B32A32_FLOAT", int(C.FLOAT_X2BIAS)),
    ("R11G11B10_FLOAT", "R16G16B16A16_SNORM", int(C.FLOAT_X2BIAS)),
    ("R32G32B32A32_FLOAT", "R11G11B10_FLOAT", int(C.FLOAT_X2BIAS)),
    ("R8G8B8A8_SNORM", "R9G9B9E5_SHAREDEXP", int(C.FLOAT_X2BIAS)),
    ("R8G8B8A8_UNORM", "R8G8B8A8_SINT", 0),
    ("D24_UNORM_S8_UINT", "R8G8B8A8_UNORM", 0),
    ("D32_FLOAT_S8X24_UINT", "R8G8B8A8_SNORM", 0),
    ("D32_FLOAT_S8X24_UINT", "R32G32B32A32_FLOAT", 0),
    ("D32_FLOAT", "R16_FLOAT", 0),
    ("D32_FLOAT", "D16_UNORM", 0),
    ("R8G8B8A8_UNORM", "D32_FLOAT", 0),
    ("R8G8B8A8_UNORM", "D24_UNORM_S8_UINT", int(C.RGB_COPY_GREEN)),
    ("R8G8B8A8_SNORM", "D24_UNORM_S8_UINT", 0),
    ("R32G32B32A32_FLOAT", "D32_FLOAT_S8X24_UINT", int(C.RGB_COPY_ALPHA)),
    ("R8G8B8A8_UNORM", "A8_UNORM", 0),
    ("R8G8B8A8_UNORM", "A8_UNORM", int(C.RGB_COPY_BLUE)),
    ("A8_UNORM", "R8G8B8A8_UNORM", 0),
    ("R8_UNORM", "R8G8B8A8_UNORM", 0),
    ("R16_FLOAT", "R16G16_FLOAT", 0),
    ("R8G8B8A8_UNORM", "R8_UNORM", 0),
    ("R8G8B8A8_UNORM", "R8_UNORM", int(C.RGB_COPY_RED)),
    ("R8G8B8A8_UNORM", "R8_UNORM", int(C.RGB_COPY_GREEN)),
    ("R8G8B8A8_UNORM", "R16_UNORM", int(C.RGB_COPY_ALPHA)),
    ("R8G8B8A8_UNORM", "R8G8_UNORM", int(C.RGB_COPY_RED | C.RGB_COPY_ALPHA)),
    ("R8G8B8A8_UNORM", "R8G8_UNORM",
     int(C.RGB_COPY_GREEN | C.RGB_COPY_ALPHA)),
    ("R8G8B8A8_UNORM", "R8G8_UNORM", int(C.RGB_COPY_BLUE | C.RGB_COPY_ALPHA)),
    ("R8G8B8A8_UNORM", "R16G16_UNORM", int(C.RGB_COPY_RED | C.RGB_COPY_BLUE)),
    ("R8G8B8A8_UNORM", "R16G16_UNORM",
     int(C.RGB_COPY_GREEN | C.RGB_COPY_BLUE)),
    ("Y410", "R16G16B16A16_FLOAT", 0),
    ("B5G6R5_UNORM", "R8G8B8A8_UNORM", 0),
]


@pytest.mark.parametrize("batch", range(6))
def test_convert_values_matrix(batch):
    """Every pair of PAIRS (a sixth of them a case) through convert_values:
    bit for bit without sRGB, within 2 ulp with it."""
    for k, (i, o, f) in list(enumerate(PAIRS))[batch::6]:
        srgb = _has_srgb(i, o, f)
        v = _values(k, special=not srgb)
        got = conv.convert_values(torch.from_numpy(v), getattr(FMT, i),
                                  getattr(FMT, o), TF(f)).numpy()
        want = np.asarray(jconv.convert_values(
            jnp.asarray(v), getattr(JFMT, i), getattr(JFMT, o), JTF(f)))
        what = f"{i} -> {o} flags {f:#x}"
        assert got.shape == want.shape, what
        if srgb:
            np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-7,
                                       err_msg=what)
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=what)


def test_the_port_keeps_subnormals_xla_flushes():
    """A clip (FLOAT -> SNORM, FLOAT -> UNORM) of f32 subnormals: the
    port gives IEEE's value (numpy's), the JAX package that value with its
    subnormals flushed."""
    v = np.array([[1e-40, -1e-40, 3e-39, 0.5]], np.float32)
    for o, lo in (("R8G8B8A8_SNORM", -1.0), ("R8G8B8A8_UNORM", 0.0)):
        ieee = np.clip(v, np.float32(lo), np.float32(1.0))
        got = conv.convert_values(torch.from_numpy(v),
                                  FMT.R32G32B32A32_FLOAT,
                                  getattr(FMT, o)).numpy()
        want = np.asarray(jconv.convert_values(
            jnp.asarray(v), JFMT.R32G32B32A32_FLOAT, getattr(JFMT, o)))
        np.testing.assert_array_equal(_bits(got), _bits(ieee))
        np.testing.assert_array_equal(_bits(want), _bits(_flush(ieee)))
        assert (_bits(got) != _bits(want)).any()


def test_convert_values_refuses_what_jax_refuses():
    v = torch.zeros(2, 4)
    for i, o in (("P8", "R8_UNORM"), ("R8G8B8A8_UNORM", "UNKNOWN"),
                 ("NV12", "R8G8B8A8_UNORM")):
        with pytest.raises(ValueError):
            jconv.convert_values(jnp.zeros((2, 4)), getattr(JFMT, i),
                                 getattr(JFMT, o))
        with pytest.raises(ValueError):
            conv.convert_values(v, getattr(FMT, i), getattr(FMT, o))


def _textures(in_fmt: str, seed: int, special: bool):
    """The same two-level texture in both packages."""
    l0 = _values(seed, special)
    l1 = _values(seed + 1, special)[:, :4, :6]
    meta = jtexture.TexMetadata(width=W, height=H, mip_levels=2,
                                format=getattr(JFMT, in_fmt))
    jt = jtexture.Texture(meta, [jnp.asarray(l0), jnp.asarray(l1)])
    mt = Texture.from_levels(dataclasses.asdict(meta), [l0, l1], "cpu")
    return jt, mt


CONVERTS = [("R32G32B32A32_FLOAT", "R10G10B10A2_UNORM", 0),
            ("R32G32B32A32_FLOAT", "B5G6R5_UNORM", 0),
            ("R16G16B16A16_FLOAT", "R9G9B9E5_SHAREDEXP", 0),
            ("R8G8B8A8_UNORM", "R8G8_SNORM", int(C.RGB_COPY_ALPHA)),
            ("R32G32B32A32_FLOAT", "D24_UNORM_S8_UINT", 0),
            ("R32G32B32A32_FLOAT", "YUY2", 0),
            ("R8G8B8A8_UNORM_SRGB", "R16G16B16A16_FLOAT", 0),
            ("R32G32B32A32_FLOAT", "B8G8R8A8_UNORM_SRGB", 0)]


@pytest.mark.parametrize("in_fmt,out_fmt,flags", CONVERTS)
def test_convert_equals_jax(in_fmt, out_fmt, flags):
    srgb = _has_srgb(in_fmt, out_fmt, flags)
    jt, mt = _textures(in_fmt, 3, special=not srgb)
    want = jconv.convert(jt, getattr(JFMT, out_fmt), JTF(flags))
    got = conv.convert(mt, getattr(FMT, out_fmt), TF(flags))
    assert int(got.format) == int(want.format)
    assert dataclasses.asdict(got.metadata)["mip_levels"] == 2
    for m in range(2):
        g, w = got.levels[m].numpy(), np.asarray(want.levels[m])
        if not srgb:
            np.testing.assert_array_equal(_bits(g), _bits(w))
            continue
        # the requantized texels equal wherever the converted values do
        vals = conv.convert_values(mt.levels[m], getattr(FMT, in_fmt),
                                   getattr(FMT, out_fmt), TF(flags))
        jvals = np.asarray(jconv.convert_values(
            jnp.asarray(mt.levels[m].numpy()), getattr(JFMT, in_fmt),
            getattr(JFMT, out_fmt), JTF(flags)))
        same = (_bits(vals.numpy()) == _bits(jvals)).all(axis=-1)
        assert same.mean() > 0.9
        np.testing.assert_array_equal(_bits(g)[same], _bits(w)[same])
        np.testing.assert_allclose(g, w, rtol=0, atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("out_fmt", ["B5G6R5_UNORM", "R8G8B8A8_UNORM",
                                     "R10G10B10A2_UNORM", "R16G16_SNORM",
                                     "A8_UNORM", "R16G16B16A16_FLOAT"])
def test_ordered_dither_equals_jax(out_fmt):
    jt, mt = _textures("R32G32B32A32_FLOAT", 9, special=True)
    want = jconv.convert(jt, getattr(JFMT, out_fmt), JTF.DITHER)
    got = conv.convert(mt, getattr(FMT, out_fmt), TF.DITHER)
    for m in range(2):
        np.testing.assert_array_equal(_bits(got.levels[m].numpy()),
                                      _bits(np.asarray(want.levels[m])))
    dith = importlib.import_module("directxtex_tpu_torch.ops.dither")
    jdith = importlib.import_module("directxtex_tpu.ops.dither")
    v = _values(10)[0]
    np.testing.assert_array_equal(
        _bits(dith.ordered_dither(torch.from_numpy(v),
                                  getattr(FMT, out_fmt)).numpy()),
        _bits(np.asarray(jdith.ordered_dither(jnp.asarray(v),
                                              getattr(JFMT, out_fmt)))))


def test_diffusion_dither_is_not_ported_yet():
    """The acceptance check of TEX_FILTER_DITHER_DIFFUSION, under its old
    name: the port's convert(..., B5G6R5_UNORM, DITHER_DIFFUSION) equals
    the JAX package's (its native Floyd-Steinberg) bit for bit."""
    jt, mt = _textures("R32G32B32A32_FLOAT", 4, special=False)
    got = conv.convert(mt, FMT.B5G6R5_UNORM, TF.DITHER_DIFFUSION)
    want = jconv.convert(jt, JFMT.B5G6R5_UNORM, JTF.DITHER_DIFFUSION)
    assert got.metadata.format == FMT.B5G6R5_UNORM
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    # a format the dither does not take stores as it is, as in the JAX
    # package (StoreScanlineDither's format switch)
    got = conv.convert(mt, FMT.R16G16B16A16_FLOAT, TF.DITHER_DIFFUSION)
    want = conv.convert(mt, FMT.R16G16B16A16_FLOAT)
    assert torch.equal(got.levels[0], want.levels[0])


def test_convert_ex_reports_aborts_and_validates():
    jt, mt = _textures("R32G32B32A32_FLOAT", 5, special=False)
    calls, jcalls = [], []
    got = conv.convert_ex(mt, FMT.R10G10B10A2_UNORM,
                          status_callback=lambda d, t: calls.append((d, t)))
    want = jconv.convert_ex(jt, JFMT.R10G10B10A2_UNORM,
                            status_callback=lambda d, t: jcalls.append((d, t)))
    assert calls == jcalls == [(0, 2), (1, 2), (2, 2)]
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    same = conv.convert_ex(mt, FMT.R32G32B32A32_FLOAT,
                           status_callback=lambda d, t: None)
    assert same is mt
    for stop in (0, 1, 2):
        with pytest.raises(TexAbortError):
            conv.convert_ex(mt, FMT.R8_UNORM,
                            status_callback=lambda d, t: d < stop)
    for bad in (FMT.BC1_UNORM, FMT.NV12, FMT.R8G8B8A8_TYPELESS, FMT.P8):
        with pytest.raises(ValueError):
            conv.convert(mt, bad)
        with pytest.raises(ValueError):
            conv.convert_ex(mt, bad, status_callback=lambda d, t: None)


def test_convert_to_single_plane_relabels():
    w, h = 8, 6
    raw = np.random.default_rng(1).integers(
        0, 256, w * h + (h // 2) * (w // 2) * 2, np.uint8)
    meta = jtexture.TexMetadata(width=w, height=h, format=JFMT.NV12)
    want = jconv.convert_to_single_plane(raw.tobytes(), meta)
    mmeta = conv.TexMetadata(**{**dataclasses.asdict(meta),
                                "format": FMT.NV12})
    got = conv.convert_to_single_plane(raw.tobytes(), mmeta, device="cpu")
    assert got.format == FMT.YUY2 and int(want.format) == int(got.format)
    np.testing.assert_array_equal(_bits(got.levels[0].numpy()),
                                  _bits(np.asarray(want.levels[0])))
    again = conv.convert_to_single_plane(Texture(mmeta, got.levels))
    assert again.format == FMT.YUY2
    with pytest.raises(ValueError):
        conv.convert_to_single_plane(got)
