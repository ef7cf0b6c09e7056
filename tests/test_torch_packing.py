"""The port's wire-format codec (directxtex_tpu_torch/formats/packing.py)
held against the JAX package's eager pack / unpack, bit for bit, on every
one of the 75 formats for which `is_packable` is true and on the planar
formats the JAX package unpacks.

Inputs are made with a numpy seed: random bytes for unpack; for pack, f32
values in [-1.5, 2.5] with NaN (both signs), +-inf, -0, values above 1
and below -1, integers beyond the 8-, 16- and 32-bit ranges, half
subnormals and f32 subnormals placed among them. Outputs are compared as
bits (NaN payloads included).

One difference is recorded rather than equal (ROADMAP queue 3): XLA's CPU
`exp2` is an approximation that is not exact at integer exponents (e.g.
2**-15, 2**13), and the JAX package builds the powers of two of
R11G11B10_FLOAT's and R9G9B9E5_SHAREDEXP's decode with it; the port uses
the exact power (XMLoadFloat3PK / XMLoadFloat3SE's value).
`test_exp2_family_unpack` asserts that the two differ only on pixels whose
power of two XLA gets wrong, and that the port's value is exact there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from directxtex_tpu.formats import packing as jpacking
from directxtex_tpu.formats import traits as jtraits
from directxtex_tpu.formats.dxgi import FMT as JFMT
from directxtex_tpu_torch.formats import packing
from directxtex_tpu_torch.formats.dxgi import FMT


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 96  # pixels a case (even: the pair formats pack two at a time)

SPECIAL = np.array([
    np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1.0, 0.5, 1.5, -2.5,
    2.98e-8, 3e-8, 6e-5, 6.1e-5, 1e-40, -1e-40, 1.17e-38, 65504.0, 65520.0,
    7e4, 1e5, 300.4, -200.7, 70000.0, -3e9, 5e9, 4.3e9, 2.2e9, 0.49999997,
    254.5, 1e-3, 32767.5, -32768.6, 127.5, -128.5, 0.50196081, 1e-9,
    3.1e-5, 4e-3, 0.0625, 15.5, 260.0, 1.2529412, -0.7529412, 65535.5,
], np.float32)


def _values(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-1.5, 2.5, (N, 4)).astype(np.float32)
    idx = rng.choice(N * 4, 2 * SPECIAL.size, replace=False)
    vals.reshape(-1)[idx] = np.concatenate([SPECIAL, SPECIAL[::-1]])
    return vals


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _raw(fmt: FMT, seed: int) -> np.ndarray:
    bpp = jtraits.bits_per_pixel(JFMT(int(fmt)))
    return np.random.default_rng(seed).integers(
        0, 256, N * bpp // 8, dtype=np.uint8)


def _check_unpack(fmt: FMT, seed: int) -> None:
    raw = _raw(fmt, seed)
    want = np.asarray(jpacking.unpack(JFMT(int(fmt)), jnp.asarray(raw), N))
    got = packing.unpack(fmt, torch.from_numpy(raw), N).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=fmt.name)


def _check_pack(fmt: FMT, seed: int) -> None:
    vals = _values(seed)
    want = np.asarray(jpacking.pack(JFMT(int(fmt)), jnp.asarray(vals)))
    got = packing.pack(fmt, torch.from_numpy(vals)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want, err_msg=fmt.name)
    # threshold of the 1-bit alpha
    if fmt == FMT.B5G5R5A1_UNORM:
        want = np.asarray(jpacking.pack(JFMT(int(fmt)), jnp.asarray(vals),
                                        0.25))
        np.testing.assert_array_equal(
            packing.pack(fmt, torch.from_numpy(vals), 0.25).numpy(), want)


FAMILIES = {kind: [f for f, d in packing._CHAN_FORMATS.items()
                   if d.kind == kind]
            for kind in packing._KIND_BYTES}
FAMILIES.update({
    "bitfield16": [f for f, b in packing._BITFIELD_FORMATS.items()
                   if b[0] == 16],
    "bitfield8_32": [f for f, b in packing._BITFIELD_FORMATS.items()
                     if b[0] != 16],
    "small_float_a2": [FMT.XBOX_R10G10B10_7E3_A2_FLOAT,
                       FMT.XBOX_R10G10B10_6E4_A2_FLOAT],
    "ten_ten_ten_two": [FMT.R10G10B10_XR_BIAS_A2_UNORM,
                        FMT.XBOX_R10G10B10_SNORM_A2_UNORM],
    "depth_stencil": [FMT.D24_UNORM_S8_UINT, FMT.R24_UNORM_X8_TYPELESS,
                      FMT.X24_TYPELESS_G8_UINT, FMT.D32_FLOAT_S8X24_UINT,
                      FMT.R32_FLOAT_X8X24_TYPELESS,
                      FMT.X32_TYPELESS_G8X24_UINT],
    "r1": [FMT.R1_UNORM],
    "rgbg": [FMT.R8G8_B8G8_UNORM, FMT.G8R8_G8B8_UNORM],
    "yuv_444": [FMT.AYUV, FMT.Y410, FMT.Y416],
    "yuv_422": [FMT.YUY2, FMT.Y210, FMT.Y216],
})
EXP2_FAMILY = [FMT.R11G11B10_FLOAT, FMT.R9G9B9E5_SHAREDEXP]


def test_packable_formats_are_the_jax_packages_75():
    ours = {int(f) for f in FMT if packing.is_packable(f)}
    theirs = {int(f) for f in JFMT if jpacking.is_packable(f)}
    assert ours == theirs and len(ours) == 75
    grouped = [f for fs in FAMILIES.values() for f in fs] + EXP2_FAMILY
    assert sorted(int(f) for f in grouped) == sorted(ours)
    # 47 channel formats, 7 bitfield, 21 special (19 of them packable)
    assert len(packing._CHAN_FORMATS) == 47
    assert len(packing._BITFIELD_FORMATS) == 7
    assert len(packing._SPECIAL_UNPACK) == 21
    assert len(packing._SPECIAL_PACK) == 19


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_equals_jax(family):
    for seed, fmt in enumerate(FAMILIES[family]):
        _check_unpack(fmt, 100 + seed)
        if fmt in packing._SPECIAL_UNPACK and fmt not in packing._SPECIAL_PACK:
            with pytest.raises(ValueError):
                packing.pack(fmt, torch.zeros(N, 4))
            continue
        _check_pack(fmt, 200 + seed)


def _exact_small(code: np.ndarray, mant_bits: int) -> np.ndarray:
    """XMLoadFloat3PK's value of an unsigned 5-bit-exponent float."""
    mant = code & ((1 << mant_bits) - 1)
    exp = (code >> mant_bits) & 31
    frac = mant.astype(np.float64) / (1 << mant_bits)
    val = np.where(exp == 0, np.ldexp(frac, -14),
                   np.ldexp(1.0 + frac, exp.astype(np.int64) - 15))
    val = np.where(exp == 31, np.where(mant == 0, np.inf, np.nan), val)
    return val.astype(np.float32)


def _exp2_wrong(e: np.ndarray) -> np.ndarray:
    """Where XLA's exp2 misses 2**e."""
    got = np.asarray(jnp.exp2(jnp.asarray(e.astype(np.float32))))
    return got != np.ldexp(np.float32(1), e.astype(np.int64))


def test_exp2_family_unpack():
    moved = {}
    for seed, fmt in enumerate(EXP2_FAMILY):
        raw = _raw(fmt, 300 + seed)
        w = raw.view("<u4").astype(np.int64)
        want = np.asarray(jpacking.unpack(JFMT(int(fmt)), jnp.asarray(raw),
                                          N))
        got = packing.unpack(fmt, torch.from_numpy(raw), N).numpy()
        if fmt == FMT.R9G9B9E5_SHAREDEXP:
            e = (w >> 27) - 24
            exact = np.stack([np.ldexp(((w >> s) & 0x1FF).astype(np.float64),
                                       e) for s in (0, 9, 18)]
                             + [np.ones(N)], -1).astype(np.float32)
            wrong = np.repeat(_exp2_wrong(e)[:, None], 4, 1)
            wrong[:, 3] = False
        else:
            codes = [(w & 0x7FF, 6), ((w >> 11) & 0x7FF, 6),
                     ((w >> 22) & 0x3FF, 5)]
            exact = np.stack([_exact_small(c, m) for c, m in codes]
                             + [np.ones(N, np.float32)], -1)
            wrong = np.stack([_exp2_wrong(((c >> m) & 31) - 15)
                              & (((c >> m) & 31) != 0)
                              & (((c >> m) & 31) != 31) for c, m in codes]
                             + [np.zeros(N, bool)], -1)
        np.testing.assert_array_equal(_bits(got), _bits(exact))
        differ = _bits(got) != _bits(want)
        assert not (differ & ~wrong).any(), fmt.name
        moved[fmt.name] = int(differ.sum())
        _check_pack(fmt, 400 + seed)
    # the difference shows on this data (the test would pass vacuously
    # if XLA's exp2 became exact)
    assert all(moved.values()), moved


@pytest.mark.parametrize("fmt", [FMT.NV12, FMT.OPAQUE_420, FMT.P010,
                                 FMT.P016, FMT.NV11, FMT.P208])
@pytest.mark.parametrize("w,h", [(8, 6), (7, 6)])
def test_planar_unpack_equals_jax(fmt, w, h):
    if fmt in (FMT.P010, FMT.P016):
        nbytes = 2 * (w * h + (h // 2) * ((w + 1) // 2) * 2)
    elif fmt == FMT.NV11:
        nbytes = w * h + h * ((w + 3) // 4) * 2
    elif fmt == FMT.P208:
        nbytes = w * h + h * ((w + 1) // 2) * 2
    else:
        nbytes = w * h + (h // 2) * ((w + 1) // 2) * 2
    raw = np.random.default_rng(w * h + int(fmt)).integers(
        0, 256, nbytes, dtype=np.uint8)
    want = np.asarray(jpacking.unpack_planar_image(JFMT(int(fmt)),
                                                   jnp.asarray(raw), w, h))
    got = packing.unpack_planar_image(fmt, torch.from_numpy(raw), w, h)
    assert got.shape == (h, w, 4)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert packing.planar_to_single(fmt) == FMT(int(
        jpacking.planar_to_single(JFMT(int(fmt)))))


def test_image_wrappers_and_unsupported_formats():
    img = _values(7).reshape(8, 12, 4)
    for fmt in (FMT.R8G8B8A8_UNORM, FMT.R16G16B16A16_FLOAT, FMT.YUY2):
        jf = JFMT(int(fmt))
        raw = np.array(jpacking.pack_image(jf, jnp.asarray(img)))
        got = packing.pack_image(fmt, torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(got, raw)
        np.testing.assert_array_equal(
            _bits(packing.unpack_image(fmt, torch.from_numpy(raw), 12,
                                       8).numpy()),
            _bits(np.asarray(jpacking.unpack_image(jf, jnp.asarray(raw), 12,
                                                   8))))
    for fmt in (FMT.BC1_UNORM, FMT.NV12, FMT.P8, FMT.R8G8B8A8_TYPELESS):
        assert not packing.is_packable(fmt)
        with pytest.raises(ValueError):
            packing.unpack(fmt, torch.zeros(64, dtype=torch.uint8), 4)
        with pytest.raises(ValueError):
            packing.pack(fmt, torch.zeros(4, 4))


def test_casts_are_xlas():
    """The port's float-to-integer conversion is XLA's on the CPU (NaN ->
    0, saturating, toward zero), where torch's own cast is not defined."""
    x = SPECIAL
    for lo, hi, jdt in ((0, 4294967295, jnp.uint32),
                        (-2147483648, 2147483647, jnp.int32),
                        (0, 65535, jnp.uint16), (0, 255, jnp.uint8)):
        want = np.asarray(jnp.asarray(x).astype(jdt)).astype(np.int64)
        got = packing._sat(torch.from_numpy(x), lo, hi).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(jdt))


def test_subnormals_are_kept_on_both_sides():
    """Neither side flushes subnormals: half subnormals decode and encode
    exactly, and an f32 subnormal reaches the small-float encoders (which
    take it, in the JAX package and here, with the implicit 1)."""
    halves = np.arange(1, 1024, dtype=np.uint16)           # subnormal halves
    raw = halves.view(np.uint8)
    got = packing.unpack(FMT.R16_FLOAT, torch.from_numpy(raw), 1023)[:, 0]
    want = halves.view(np.float16).astype(np.float32)
    assert (want > 0).all() and (want < 6.2e-5).all()
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    back = packing.pack(FMT.R16_FLOAT, torch.stack(
        [got, got, got, got], -1)).numpy()
    np.testing.assert_array_equal(back, raw)
    sub = np.array([[1e-40, 1e-39, 1e-45, 2e-38]] * 2, np.float32)
    for fmt in (FMT.R11G11B10_FLOAT, FMT.XBOX_R10G10B10_7E3_A2_FLOAT,
                FMT.XBOX_R10G10B10_6E4_A2_FLOAT, FMT.R9G9B9E5_SHAREDEXP,
                FMT.R16G16B16A16_FLOAT):
        want = np.asarray(jpacking.pack(JFMT(int(fmt)), jnp.asarray(sub)))
        got = packing.pack(fmt, torch.from_numpy(sub)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=fmt.name)


def test_array_input_defaults_to_cuda():
    """An array goes to the device the caller names, else to CUDA; a
    tensor stays on its device unless another is named."""
    raw = np.arange(64, dtype=np.uint8)
    vals = np.linspace(0, 1, 16, dtype=np.float32).reshape(4, 4)
    planar = np.zeros(6 * 4 * 3 // 2, np.uint8)
    calls = (lambda **k: packing.unpack(FMT.R8G8B8A8_UNORM, raw, 16, **k),
             lambda **k: packing.unpack_image(FMT.R8_UNORM, raw, 8, 8, **k),
             lambda **k: packing.pack(FMT.R8G8B8A8_UNORM, vals, **k),
             lambda **k: packing.pack_image(FMT.R8_UNORM,
                                            vals.reshape(2, 2, 4), **k),
             lambda **k: packing.unpack_planar_image(FMT.NV12, planar, 6, 4,
                                                     **k))
    for call in calls:
        assert call(device="cpu").device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                call()
        else:
            assert call().device.type == "cuda"
    assert packing.pack(FMT.R8_UNORM,
                        torch.from_numpy(vals)).device.type == "cpu"
    np.testing.assert_array_equal(
        packing.unpack(FMT.R8G8B8A8_UNORM, raw, 16, device="cpu").numpy(),
        packing.unpack(FMT.R8G8B8A8_UNORM, torch.from_numpy(raw),
                       16).numpy())
