"""The port's compress driver, Texture and DDS I/O
(directxtex_tpu_torch/ops/compress.py, texture.py, io/dds.py) held against
the JAX package on the CPU.

- compress of corpus albedo[:16, :16] to BC1 and BC7 gives
  tests/golden/containers.npz's payloads (the JAX package's words);
- the golden DDS files load to containers.npz's values bit for bit, and
  rgba8_mips.dds is written back byte for byte;
- BC1-BC5 (and BC1 with sRGB, RGB dither, uniform) and BC6H through
  compress / decompress on small mip chains and on 1x1, 2x2 and 6x10
  textures, against the JAX package's outputs frozen in
  tests/golden/compress_dds.npz (tests/golden/generate_compress_dds.py,
  a run without FMA, as BC1-BC3 need); BC6H is judged by the codec's
  F16-int metric (tests/test_torch_bc6h_search.py's rule), its decode bit
  for bit;
- a 64^2 crop of the 512^2 HDR gate image, default and mid tiers, against
  the frozen JAX words of the same blocks;
- compress_many over mixed sizes equals per-texture calls; compress_ex
  and convert_ex report and abort;
- DDS save bytes equal the JAX package's for plain, legacy, volume, cube
  and BC textures, and legacy / planar files load to its values.

The JAX encoders are never called here (their outputs are frozen); the JAX
package's convert_values, pack / unpack and DDS code run eagerly on small
inputs. Torch runs on one thread.
"""

import dataclasses
import importlib
import importlib.util
import pathlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu import texture as jtexture
from directxtex_tpu.formats.dxgi import FMT as JFMT
from directxtex_tpu.io import dds as jdds
from directxtex_tpu_torch.bc import bc6h, bc67
from directxtex_tpu_torch.bc.common import image_to_blocks
from directxtex_tpu_torch.formats.dxgi import FMT
from directxtex_tpu_torch.io import dds
from directxtex_tpu_torch.texture import CompressedTexture, Texture
from directxtex_tpu_torch.utils.errors import TexAbortError

cmp = importlib.import_module("directxtex_tpu_torch.ops.compress")
conv = importlib.import_module("directxtex_tpu_torch.ops.convert")
jconv = importlib.import_module("directxtex_tpu.ops.convert")

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location(
    "generate_compress_dds", GOLDEN / "generate_compress_dds.py")
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
    return np.load(GOLDEN / "compress_dds.npz")


@pytest.fixture(scope="module")
def containers():
    return np.load(GOLDEN / "containers.npz")


@pytest.fixture(scope="module")
def corpus():
    return np.load(GOLDEN / "corpus.npz")


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _small_tex(frozen, name: str) -> Texture:
    levels = []
    m = 0
    while f"{name}_l{m}" in frozen:
        levels.append(frozen[f"{name}_l{m}"])
        m += 1
    h, w = levels[0].shape[1:3]
    meta = jtexture.TexMetadata(width=w, height=h, mip_levels=len(levels),
                                format=getattr(JFMT,
                                               gen.source_format(name)))
    return Texture.from_levels(dataclasses.asdict(meta), levels, "cpu")


def _int_err(words8: np.ndarray, blocks: np.ndarray, signed: bool):
    """Per-block F16-int SSE (the codec's INTColor norm)."""
    words = torch.from_numpy(np.ascontiguousarray(words8).reshape(-1, 16)
                             .view(np.int32)).t().contiguous()
    half = bc6h._half_bits_to_f32(bc6h._bc6h_decode_plain(words, signed))
    dec = bc6h._f16_to_int(half, signed).numpy().reshape(16, 3, -1)
    px = bc6h._f16_to_int(torch.from_numpy(np.ascontiguousarray(
        np.transpose(blocks[..., :3], (1, 2, 0)))), signed).numpy()
    return ((dec - px).astype(np.float64) ** 2).sum(axis=(0, 1))


def _assert_int_rule(got, ref, blocks, signed):
    """tests/test_torch_bc6h_search.py's rule: words differ on at most
    max(2, nb/25) blocks, there within 1.02x + 64 of the reference's
    F16-int error, in aggregate within 1.005x. Returns (blocks that
    differ, aggregate error, reference's)."""
    got = np.asarray(got).reshape(-1, 16)
    ref = np.asarray(ref).reshape(-1, 16)
    nb = ref.shape[0]
    differ = np.any(got != ref, axis=1)
    assert differ.sum() <= max(2, nb // 25), f"{differ.sum()}/{nb}"
    eg, er = _int_err(got, blocks, signed), _int_err(ref, blocks, signed)
    assert np.all(eg[differ] <= er[differ] * 1.02 + 64.0)
    assert eg.sum() <= er.sum() * 1.005
    return int(differ.sum()), float(eg.sum()), float(er.sum())


# ---------------------------------------------------------------------------
# the golden containers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,key", [(FMT.BC1_UNORM, "bc1_payload"),
                                     (FMT.BC7_UNORM, "bc7_payload")])
def test_compress_gives_the_golden_payloads(corpus, containers, fmt, key):
    tex = Texture.from_array(corpus["albedo"][:16, :16], device="cpu")
    ct = cmp.compress(tex, fmt)
    assert isinstance(ct, CompressedTexture) and ct.format == fmt
    assert ct.levels[0].dtype == torch.uint8
    np.testing.assert_array_equal(ct.levels[0].numpy(), containers[key])


@pytest.mark.parametrize("fname,key,fmt", [
    ("bc1.dds", "bc1_payload", FMT.BC1_UNORM),
    ("bc7_dx10.dds", "bc7_payload", FMT.BC7_UNORM)])
def test_golden_bc_dds_loads(containers, fname, key, fmt):
    raw = (GOLDEN / "containers" / fname).read_bytes()
    ct = dds.load_from_dds_memory(raw, device="cpu")
    assert isinstance(ct, CompressedTexture) and ct.format == fmt
    np.testing.assert_array_equal(ct.levels[0].numpy(), containers[key])
    assert dds.save_to_dds_memory(ct) == jdds.save_to_dds_memory(
        jdds.load_from_dds_memory(raw))


def test_golden_rgba8_mips_load_and_rewrite(containers):
    raw = (GOLDEN / "containers/rgba8_mips.dds").read_bytes()
    tex = dds.load_from_dds_memory(raw, device="cpu")
    n = int(containers["rgba8_mips_nlevels"])
    assert tex.mip_levels == n
    for i in range(n):
        np.testing.assert_array_equal(tex.levels[i].numpy(),
                                      containers[f"rgba8_mips_l{i}"])
    assert dds.save_to_dds_memory(tex) == raw
    meta = dds.get_metadata_from_dds_memory(raw)
    assert dataclasses.asdict(meta) == {
        k: (int(v) if hasattr(v, "value") else v) for k, v in
        dataclasses.asdict(jdds.get_metadata_from_dds_memory(raw)).items()}


# ---------------------------------------------------------------------------
# compress / decompress against the JAX package's frozen outputs
# ---------------------------------------------------------------------------

def _check_decompress(frozen, key, ct, n_levels):
    back = cmp.decompress(ct)
    for m in range(n_levels):
        np.testing.assert_array_equal(_bits(back.levels[m].numpy()),
                                      _bits(frozen[f"{key}_d{m}"]),
                                      err_msg=f"{key} level {m}")


LDR_CASES = [c for c in gen.cases() if c[0] == "ldr"]


@pytest.mark.parametrize("tex_name,fmt,flags", LDR_CASES)
def test_ldr_chain_compress_equals_jax(frozen, tex_name, fmt, flags):
    tex = _small_tex(frozen, tex_name)
    key = gen.case_key(tex_name, fmt, flags)
    ct = cmp.compress(tex, getattr(FMT, fmt), flags)
    assert ct.mip_levels == tex.mip_levels
    srgb = fmt.endswith("_SRGB")
    if srgb:
        # sRGB out: the port's pow differs from XLA's by an ulp on a few
        # values (ROADMAP queue 3); the words are equal on every block
        # whose encoder input is. Every level's pixels in one call each
        # (the conversion is elementwise).
        flat = torch.cat([lvl.reshape(-1, 4) for lvl in tex.levels])
        mine = conv.convert_values(flat, FMT.R8G8B8A8_UNORM,
                                   getattr(FMT, fmt))
        theirs = torch.from_numpy(np.array(jconv.convert_values(
            jnp.asarray(flat.numpy()), JFMT.R8G8B8A8_UNORM,
            getattr(JFMT, fmt))))
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=0,
                                   atol=2.5e-7)
        sizes = [lvl[0].numel() // 4 for lvl in tex.levels]
    for m, lvl in enumerate(tex.levels):
        got, want = ct.levels[m].numpy(), frozen[f"{key}_w{m}"]
        assert got.shape == want.shape
        if not srgb:
            np.testing.assert_array_equal(got, want, err_msg=f"level {m}")
            continue
        lo, hi = sum(sizes[:m]), sum(sizes[:m + 1])
        shape = lvl.shape[1:]
        same = np.all((image_to_blocks(mine[lo:hi].reshape(shape))[0] ==
                       image_to_blocks(theirs[lo:hi].reshape(shape))[0])
                      .reshape(-1, 64).numpy(), axis=1)
        bpb = got.shape[1] // same.size
        blocks_eq = np.all(got.reshape(-1, bpb) == want.reshape(-1, bpb),
                           axis=1)
        assert blocks_eq[same].all(), f"level {m}"
    if not srgb:
        _check_decompress(frozen, key, ct, tex.mip_levels)


@pytest.mark.parametrize("tex_name,fmt", [("hdru", "BC6H_UF16"),
                                          ("hdrs", "BC6H_SF16")])
def test_hdr_chain_compress_equals_jax(frozen, tex_name, fmt):
    tex = _small_tex(frozen, tex_name)
    key = gen.case_key(tex_name, fmt, 0)
    signed = fmt.endswith("SF16")
    ct = cmp.compress(tex, getattr(FMT, fmt))
    for m, lvl in enumerate(tex.levels):
        blocks = image_to_blocks(lvl[0])[0].numpy()
        _assert_int_rule(ct.levels[m].numpy(), frozen[f"{key}_w{m}"],
                         blocks, signed)
    # the JAX words decompress to the JAX package's values bit for bit
    jct = CompressedTexture(ct.metadata, [
        torch.from_numpy(frozen[f"{key}_w{m}"])
        for m in range(tex.mip_levels)])
    _check_decompress(frozen, key, jct, tex.mip_levels)


@pytest.mark.parametrize("tex_name", list(gen.TINY))
def test_tiny_textures(frozen, tex_name):
    tex = _small_tex(frozen, tex_name)
    for fmt in gen.TINY_FORMATS:
        key = gen.case_key(tex_name, fmt, 0)
        ct = cmp.compress(tex, getattr(FMT, fmt))
        if fmt.startswith("BC6H"):
            blocks = image_to_blocks(tex.levels[0][0])[0].numpy()
            _assert_int_rule(ct.levels[0].numpy(), frozen[key + "_w0"],
                             blocks, False)
            ct = CompressedTexture(ct.metadata,
                                   [torch.from_numpy(frozen[key + "_w0"])])
        else:
            np.testing.assert_array_equal(ct.levels[0].numpy(),
                                          frozen[key + "_w0"])
        _check_decompress(frozen, key, ct, 1)
    # BC7: compress's words are encode_bc7's on the edge-replicated blocks
    ct = cmp.compress(tex, FMT.BC7_UNORM)
    blocks = image_to_blocks(tex.levels[0][0])[0]
    np.testing.assert_array_equal(
        ct.levels[0].numpy().reshape(-1, 16),
        bc67.encode_bc7(blocks, opaque=True).numpy())
    back = cmp.decompress(ct)
    assert back.levels[0].shape == tex.levels[0].shape
    assert back.format == FMT.R8G8B8A8_UNORM


@pytest.mark.parametrize("mid", [False, True])
def test_hdr512_crop_against_the_frozen_gate(frozen, corpus, mid):
    """A 64^2 crop of the 512^2 gate image (its first 16 x 16 blocks) on
    the CPU, against the JAX package's words for the same blocks."""
    img = gen.hdr512_image(corpus)
    tex = Texture.from_array(img[:64, :64], FMT.R16G16B16A16_FLOAT,
                             device="cpu")
    ct = cmp.compress(tex, FMT.BC6H_UF16, bc6h._BC6H_MID if mid else 0)
    ref = frozen["hdr512_mid_words" if mid else "hdr512_words"]
    ref = ref.reshape(128, 128, 16)[:16, :16].reshape(-1, 16)
    blocks = image_to_blocks(torch.from_numpy(img[:64, :64]))[0].numpy()
    _assert_int_rule(ct.levels[0].numpy(), ref, blocks, False)
    dec = cmp.decompress(ct)
    assert dec.format == FMT.R16G16B16A16_FLOAT
    got = gen.log_psnr(dec.levels[0][0].numpy(), img[:64, :64])
    want = gen.log_psnr(cmp.decompress(CompressedTexture(
        ct.metadata, [torch.from_numpy(ref.reshape(1, -1))])
    ).levels[0][0].numpy(), img[:64, :64])
    assert got >= want - 0.05, (got, want)


@pytest.mark.parametrize("fmt", [FMT.BC1_UNORM, FMT.BC7_UNORM])
def test_compress_many_mixed_sizes_equals_per_texture(frozen, fmt):
    texs = [_small_tex(frozen, n) for n in ("ldr", "tiny610", "tiny1")]
    many = cmp.compress_many(texs, fmt)
    for tex, ct in zip(texs, many):
        one = cmp.compress(tex, fmt)
        assert ct.metadata == one.metadata
        for a, b in zip(ct.levels, one.levels):
            assert torch.equal(a, b)


def test_compress_ex_and_convert_ex_report_and_abort(frozen):
    tex = _small_tex(frozen, "ldr")
    calls = []
    ct = cmp.compress_ex(tex, FMT.BC1_UNORM,
                         status_callback=lambda d, t: calls.append((d, t)))
    assert calls == [(i, 5) for i in range(6)]
    one = cmp.compress(tex, FMT.BC1_UNORM)
    assert all(torch.equal(a, b) for a, b in zip(ct.levels, one.levels))
    for stop in (0, 2):
        with pytest.raises(TexAbortError):
            cmp.compress_ex(tex, FMT.BC1_UNORM,
                            status_callback=lambda d, t: d < stop)
        with pytest.raises(TexAbortError):
            conv.convert_ex(tex, FMT.B5G6R5_UNORM,
                            status_callback=lambda d, t: d < stop)
    with pytest.raises(ValueError):
        cmp.compress_ex(tex, FMT.R8_UNORM, status_callback=lambda d, t: 1)


def test_decompress_targets_and_errors(frozen):
    key = gen.case_key("ldr", "BC1_UNORM", 0)
    tex = _small_tex(frozen, "ldr")
    levels = [torch.from_numpy(frozen[f"{key}_w{m}"]) for m in range(5)]
    meta = dataclasses.replace(tex.metadata, format=FMT.BC1_TYPELESS)
    back = cmp.decompress(CompressedTexture(meta, levels))
    assert back.format == FMT.R8G8B8A8_UNORM
    np.testing.assert_array_equal(back.levels[2].numpy(), frozen[key + "_d2"])
    f16 = cmp.decompress(CompressedTexture(meta, levels),
                         FMT.R16G16B16A16_FLOAT)
    assert torch.equal(f16.levels[0], back.levels[0])
    with pytest.raises(ValueError):
        cmp.decompress(CompressedTexture(meta, levels), FMT.BC3_UNORM)
    with pytest.raises(ValueError):
        cmp.decompress(tex)
    with pytest.raises(ValueError):
        cmp.compress(tex, FMT.R8G8B8A8_UNORM)
    with pytest.raises(ValueError):
        cmp.compress(Texture(dataclasses.replace(
            tex.metadata, format=FMT.BC1_UNORM), tex.levels), FMT.BC3_UNORM)


# ---------------------------------------------------------------------------
# Texture
# ---------------------------------------------------------------------------

def test_texture_matches_jax_and_defaults_to_cuda(corpus):
    arr = corpus["alphagrad"][:8, :12].copy()
    for c in (1, 2, 3, 4):
        mine = Texture.from_array(arr[..., :c], device="cpu")
        theirs = jtexture.Texture.from_array(arr[..., :c])
        assert dataclasses.asdict(mine.metadata) == {
            k: (int(v) if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(theirs.metadata).items()}
        np.testing.assert_array_equal(mine.to_numpy(), theirs.to_numpy())
        assert mine.is_alpha_all_opaque() == theirs.is_alpha_all_opaque()
    arr[0, 0, 3] = np.nan            # NaN alpha reads as opaque in both
    arr[..., 3] = np.where(np.isnan(arr[..., 3]), np.nan, 1.0)
    for fmt in (JFMT.R8G8B8A8_UNORM, JFMT.B5G6R5_UNORM):
        theirs = jtexture.Texture.from_array(arr, fmt)
        mine = Texture.from_levels(dataclasses.asdict(theirs.metadata),
                                   [np.asarray(x) for x in theirs.levels],
                                   "cpu")
        assert mine.is_alpha_all_opaque() == theirs.is_alpha_all_opaque()
    vol = Texture.from_array(np.zeros((3, 4, 4, 4), np.float32),
                             dimension=3 + 1, device="cpu")
    assert vol.metadata.depth == 3 and vol.metadata.array_size == 1
    two = vol.replace_levels([vol.levels[0], vol.levels[0][:, :2, :2]])
    assert two.metadata.mip_levels == 2 and two.image(1, 2).shape == (2, 2, 4)
    # the default device is CUDA: on a machine without it that fails
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            Texture.from_array(arr)
        with pytest.raises((RuntimeError, AssertionError)):
            dds.load_from_dds_memory(
                (GOLDEN / "containers/bc1.dds").read_bytes())


# ---------------------------------------------------------------------------
# DDS writer and loader against the JAX package's
# ---------------------------------------------------------------------------

def _both(arr, fmt_name, **kw):
    jt = jtexture.Texture.from_array(arr, getattr(JFMT, fmt_name), **kw)
    kw = {k: v for k, v in kw.items()}
    mt = Texture.from_array(arr, getattr(FMT, fmt_name), device="cpu", **kw)
    return jt, mt


def _equal_textures(mine, theirs):
    assert type(mine).__name__ == type(theirs).__name__
    assert int(mine.metadata.format) == int(theirs.metadata.format)
    assert len(mine.levels) == len(theirs.levels)
    for a, b in zip(mine.levels, theirs.levels):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype == np.float32:
            np.testing.assert_array_equal(_bits(a), _bits(b))
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt_name", [
    "R8G8B8A8_UNORM", "B8G8R8X8_UNORM", "B5G6R5_UNORM",
    "R16G16B16A16_FLOAT", "R10G10B10A2_UNORM", "R8_UNORM", "YUY2"])
def test_dds_save_and_load_equal_jax(corpus, fmt_name):
    arr = corpus["photo_china"][:12, :20]
    jt, mt = _both(arr, fmt_name)
    want = jdds.save_to_dds_memory(jt)
    assert dds.save_to_dds_memory(mt) == want
    loaded = dds.load_from_dds_memory(want, device="cpu")
    _equal_textures(loaded, jdds.load_from_dds_memory(want))
    # the DX10 and DX9 headers of the same payload: the JAX package's
    # header bytes, the same pixels back
    for flags in (int(dds.DDS_FLAGS.FORCE_DX10_EXT),
                  int(dds.DDS_FLAGS.FORCE_DX9_LEGACY)):
        try:
            want = jdds.encode_dds_header(jt.metadata, flags)
        except ValueError:
            with pytest.raises(ValueError):
                dds.save_to_dds_memory(mt, flags)
            continue
        got = dds.save_to_dds_memory(mt, flags)
        assert got[:len(want)] == want
        again = dds.load_from_dds_memory(got, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(again.levels,
                                                     loaded.levels))


def test_dds_volume_cube_and_array(corpus):
    arr = corpus["photo_china"][:12, :20]
    vol = np.stack([arr, arr[::-1], arr[:, ::-1]])
    jt, mt = _both(vol, "R8G8B8A8_UNORM", dimension=jtexture.TexDimension(4))
    cube = np.stack([np.roll(arr, k, 0) for k in range(6)])
    jc, mc = _both(cube, "R8G8B8A8_UNORM", is_cube=True)
    ja, ma = _both(cube[:2], "R16G16B16A16_FLOAT")
    for j, m in ((jt, mt), (jc, mc), (ja, ma)):
        want = jdds.save_to_dds_memory(j)
        assert dds.save_to_dds_memory(m) == want
        _equal_textures(dds.load_from_dds_memory(want, device="cpu"),
                        jdds.load_from_dds_memory(want))


def _legacy_dds(pf: tuple, w: int, h: int, payload: bytes,
                caps2: int = 0, fourcc_tag: int = 0) -> bytes:
    hdr = struct.pack("<I 7I 11I 8I 5I", 0x20534444, 124, 0x1007, h, w, 0,
                      1, 1, *([0] * 9), fourcc_tag, 0, 32, *pf,
                      0x1000, caps2, 0, 0, 0)
    return hdr + payload


LEGACY = [  # (pixel format flags..masks, bytes a pixel, DDS_FLAGS)
    ((0x40, 0, 24, 0xFF0000, 0xFF00, 0xFF, 0), 3, 0),          # R8G8B8
    ((0x41, 0, 16, 0xE0, 0x1C, 0x3, 0xFF00), 2, 0),            # A8R3G3B2
    ((0x40, 0, 8, 0xE0, 0x1C, 0x3, 0), 1, 0),                  # R3G3B2
    ((0x20001, 0, 8, 0x0F, 0, 0, 0xF0), 1, 0),                 # A4L4
    ((0x41, 0, 16, 0x0F00, 0xF0, 0x0F, 0xF000), 2, 0x10),      # 4444 -> 8888
    ((0x40, 0, 16, 0xF800, 0x7E0, 0x1F, 0), 2, 0x10),          # 565 -> 8888
    ((0x41, 0, 16, 0x7C00, 0x3E0, 0x1F, 0x8000), 2, 0),        # A1R5G5B5
    ((0x20000, 0, 8, 0xFF, 0, 0, 0), 1, 0x20),                 # L8 expanded
    ((0x20001, 0, 16, 0xFF, 0, 0, 0xFF00), 2, 0x20),           # A8L8
    ((0x20000, 0, 16, 0xFFFF, 0, 0, 0), 2, 0x20),              # L16
    ((0x41, 0, 32, 0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000), 4, 0),  # swizzle
    ((0x40000, 0, 16, 0x1F, 0x3E0, 0xFC00, 0), 2, 0),          # L6V5U5
    ((0x40000, 0, 32, 0xFF, 0xFF00, 0xFF0000, 0), 4, 0),       # X8L8V8U8
    ((0x80001, 0, 32, 0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000), 4, 0),
    ((0x4, 0x59565955, 0, 0, 0, 0, 0), 2, 0),                  # UYVY
    ((0x41, 0, 32, 0xFF0000, 0xFF00, 0xFF, 0xFF000000), 4, 0x8),  # FORCE_RGB
]


@pytest.mark.parametrize("batch", [0, 1])
def test_legacy_dds_loads_equal_jax(batch):
    rng = np.random.default_rng(11 + batch)
    for pf, bpp, flags in LEGACY[batch::2]:
        w, h = 20, 12
        raw = _legacy_dds(pf, w, h, rng.integers(
            0, 256, w * h * bpp, dtype=np.uint8).tobytes())
        want = jdds.load_from_dds_memory(raw, flags)
        got = dds.load_from_dds_memory(raw, flags, device="cpu")
        _equal_textures(got, want)
        assert int(got.metadata.misc_flags2) == int(
            want.metadata.misc_flags2)
    # a palettized file (P8 with its 256-entry palette)
    pal = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype("<u4")
    raw = _legacy_dds((0x20, 0, 8, 0, 0, 0, 0), 20, 12,
                      pal.tobytes() + rng.integers(0, 256, 240, np.uint8)
                      .tobytes())
    _equal_textures(dds.load_from_dds_memory(raw, device="cpu"),
                    jdds.load_from_dds_memory(raw))
    for bad in (raw[:100], b"XDDS" + raw[4:], raw[:-3]):
        with pytest.raises(ValueError):
            jdds.load_from_dds_memory(bad)
        with pytest.raises(ValueError):
            dds.load_from_dds_memory(bad, device="cpu")


@pytest.mark.parametrize("fmt_name", ["NV12", "P010"])
def test_planar_dds_loads_equal_jax(fmt_name):
    w, h = 8, 6
    n = w * h + (h // 2) * (w // 2) * 2
    size = n * (2 if fmt_name == "P010" else 1)
    payload = np.random.default_rng(5).integers(0, 256, size, np.uint8)
    meta = jtexture.TexMetadata(width=w, height=h,
                                format=getattr(JFMT, fmt_name))
    raw = jdds.encode_dds_header(meta) + payload.tobytes()
    got = dds.load_from_dds_memory(raw, device="cpu")
    want = jdds.load_from_dds_memory(raw)
    _equal_textures(got, want)
    assert got.format == FMT.YUY2 if fmt_name == "NV12" else FMT.Y210
    one = conv.convert_to_single_plane(payload.tobytes(),
                                       dds.get_metadata_from_dds_memory(raw),
                                       device="cpu")
    assert torch.equal(one.levels[0], got.levels[0])
