"""The port's container loaders (directxtex_tpu_torch.io: TGA, HDR, PPM /
PFM / PHM, the Pillow bridge, HEIF, the runtime loaders) against the JAX
package's on the same bytes, on the CPU.

Tolerances: every loaded f32 plane is bit-equal to the JAX package's and
every saved byte string equal, except
- HDR pixels whose exponent XLA's `exp2` misses: there the port equals the
  exact formula (m + 0.5) x (2^(e - 136) x f32(1 / exposure)) bit for bit
  (test_hdr_decode_exact_power prints the counts);
- create_texture_from_image's resize and mips: each value within 4 ulp of
  the JAX package's or 1e-6 absolute (the products' summation order).
The native codecs equal their numpy twins exactly.
"""

import importlib
import io as _io
import pathlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.texture import Texture as JTexture
from directxtex_tpu_torch.formats import FMT
from directxtex_tpu_torch.texture import TexAlphaMode, Texture

tio = importlib.import_module("directxtex_tpu_torch.io")
tga = importlib.import_module("directxtex_tpu_torch.io.tga")
hdr = importlib.import_module("directxtex_tpu_torch.io.hdr")
ppm = importlib.import_module("directxtex_tpu_torch.io.ppm")
wic = importlib.import_module("directxtex_tpu_torch.io.wic")
heif = importlib.import_module("directxtex_tpu_torch.io.heif")
loaders = importlib.import_module("directxtex_tpu_torch.io.loaders")
native = importlib.import_module("directxtex_tpu_torch.native")
timing = importlib.import_module("directxtex_tpu_torch.utils.timing")
jio = importlib.import_module("directxtex_tpu.io")
jtga = importlib.import_module("directxtex_tpu.io.tga")
jhdr = importlib.import_module("directxtex_tpu.io.hdr")
jppm = importlib.import_module("directxtex_tpu.io.ppm")
jwic = importlib.import_module("directxtex_tpu.io.wic")
jheif = importlib.import_module("directxtex_tpu.io.heif")
jloaders = importlib.import_module("directxtex_tpu.io.loaders")
jnative = importlib.import_module("directxtex_tpu.native")

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planes(tex) -> np.ndarray:
    """Every level of a texture (either package's) as one f32 array."""
    return np.concatenate([np.asarray(
        lvl.cpu().numpy() if torch.is_tensor(lvl) else lvl,
        np.float32).reshape(-1) for lvl in tex.levels])


def _bit_equal(port_tex, jax_tex, what=""):
    a, b = _planes(port_tex), _planes(jax_tex)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                  err_msg=what)
    assert port_tex.metadata.format == jax_tex.metadata.format, what
    assert (port_tex.metadata.width, port_tex.metadata.height) == (
        jax_tex.metadata.width, jax_tex.metadata.height), what


def _image(h=13, w=17, seed=0, scale=1.0, alpha=None):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 4)) * scale).astype(np.float32)
    if alpha is not None:
        img[..., 3] = alpha
    return img


def _pair(img, fmt=FMT.R8G8B8A8_UNORM, alpha_mode=TexAlphaMode.UNKNOWN):
    from directxtex_tpu.formats import FMT as JFMT
    from directxtex_tpu.texture import TexAlphaMode as JAM
    return (Texture.from_array(img, fmt, alpha_mode=alpha_mode, device=CPU),
            JTexture.from_array(img, JFMT(int(fmt)),
                                alpha_mode=JAM(int(alpha_mode))))


def test_module_surface_and_sources_pinned():
    """io.__all__ is the JAX package's; the native sources are its copies;
    every loader's device argument defaults to CUDA."""
    assert sorted(tio.__all__) == sorted(jio.__all__)
    jdir = pathlib.Path(jnative.__file__).parent
    for name in ("rle_codec.cpp", "piz.cpp", "exr_openexr.cpp"):
        assert (native.NATIVE_DIR / name).read_bytes() == (
            jdir / name).read_bytes(), name
    assert [s.name for s in native.CODEC_SOURCES] == ["rle_codec.cpp",
                                                      "piz.cpp"]
    lib = str(native.codec_library()._name)
    assert lib.startswith(str(native.BUILD_DIR)) and "libdxt_codecs_" in lib
    data = tga.save_to_tga_memory(Texture.from_array(_image(2, 2),
                                                     device=CPU))
    if torch.cuda.is_available():
        assert tio.load_from_tga_memory(data).device.type == "cuda"
    else:   # the default is CUDA: without a card the copy raises
        with pytest.raises((RuntimeError, AssertionError)):
            tio.load_from_tga_memory(data)


# -- TGA ----------------------------------------------------------------------

SAVE_CASES = [
    [(FMT.R8G8B8A8_UNORM, 0, 0), (FMT.R8G8B8A8_UNORM_SRGB, 0, 0),
     (FMT.B8G8R8A8_UNORM, 1, 0)],
    [(FMT.B8G8R8X8_UNORM, 1, 0), (FMT.B8G8R8X8_UNORM_SRGB, 0x20, 0),
     (FMT.R8G8B8A8_UNORM, 0x10, TexAlphaMode.PREMULTIPLIED)],
    [(FMT.B5G5R5A1_UNORM, 0, 0), (FMT.R8_UNORM, 0x40, 0),
     (FMT.A8_UNORM, 0, 0)],
]


@pytest.mark.parametrize("cases", SAVE_CASES)
def test_tga_save_and_load_match_jax(cases):
    """The writer's bytes (raw 32 / 24 / 16 / 8 bpp, the TGA 2.0 footer's
    gamma and alpha attributes) and the reload with the same flags."""
    img = _image(alpha=np.linspace(0, 1, 17, dtype=np.float32)[None, :])
    for fmt, flags, alpha_mode in cases:
        t, j = _pair(img, fmt, alpha_mode)
        data = tga.save_to_tga_memory(t, flags)
        assert data == jtga.save_to_tga_memory(j, flags), fmt.name
        _bit_equal(tga.load_from_tga_memory(data, flags, device=CPU),
                   jtga.load_from_tga_memory(data, flags), fmt.name)
        assert tga.get_metadata_from_tga_memory(data, flags) == \
            _meta(jtga.get_metadata_from_tga_memory(data, flags))


def _meta(jmeta):
    from directxtex_tpu_torch.texture import _metadata_of
    import dataclasses
    return _metadata_of(dataclasses.asdict(jmeta))


def _tga_rle(px: np.ndarray) -> bytes:
    """RLE packets of [N, bpp] pixels: repeats as run packets (up to 128),
    the rest as raw packets (up to 128); a run packet may span rows."""
    out = bytearray()
    i, n = 0, len(px)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and (px[j] == px[i]).all():
            j += 1
        if j - i >= 2:
            out.append(0x80 | (j - i - 1))
            out += px[i].tobytes()
        else:
            j = i + 1
            while j < n and j - i < 128 and not (
                    j + 1 < n and (px[j] == px[j + 1]).all()):
                j += 1
            out.append(j - i - 1)
            out += px[i:j].tobytes()
        i = j
    return bytes(out)


def _tga_file(px, image_type, bpp, desc, cmap=None, footer=None) -> bytes:
    """A TGA of [H, W, bytes] pixels in file order."""
    h, w = px.shape[:2]
    flat = px.reshape(h * w, -1)
    body = _tga_rle(flat) if image_type & 8 else flat.tobytes()
    cm_type, cm_len, cm_size, cm = 0, 0, 0, b""
    if cmap is not None:
        cm_type, cm_len, cm_size, cm = 1, len(cmap), cmap.shape[1] * 8, \
            cmap.tobytes()
    head = struct.pack("<BBBHHBHHHHBB", 3, cm_type, image_type, 0, cm_len,
                       cm_size, 0, 0, w, h, bpp, desc) + b"abc"
    data = head + cm + body
    if footer is not None:
        gamma, attrs = footer
        ext = bytearray(495)
        struct.pack_into("<H", ext, 0, 495)
        struct.pack_into("<HH", ext, 478, *gamma)
        ext[494] = attrs
        data += bytes(ext) + struct.pack("<II", len(data), 0) + \
            b"TRUEVISION-XFILE.\x00"
    return data


def _blocky(h, w, c, seed):
    """[H, W, c] u8 with runs and noise (RLE packets of both kinds)."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    px[:, : w // 2] = px[:, :1]
    px[h // 2:, w // 3: w // 2] = 7
    return px


TGA_FILES = [
    # (image type, bpp, descriptor, flags, footer)
    (10, 32, 0x08, 0, None),                 # RLE, bottom-up
    (10, 32, 0x28, 1, ((22, 10), 3)),        # RLE, top-down, BGR, sRGB
    (10, 24, 0x10, 0, None),                 # RLE, right-to-left
    (2, 24, 0x30, 1, ((10, 10), 0)),         # raw, top-down right-to-left
    (2, 32, 0x20, 0, ((10, 10), 4)),         # raw, premultiplied footer
    (11, 8, 0x00, 0x80, None),               # RLE grey, DEFAULT_SRGB
    (3, 8, 0x20, 0x10, ((22, 10), 0)),       # raw grey, IGNORE_SRGB
    (10, 16, 0x21, 0, None),                 # RLE 5551
    (9, 8, 0x20, 0, "cmap24"),               # RLE colormapped, 24-bit
    (1, 8, 0x00, 1, "cmap32"),               # raw colormapped, 32-bit, BGR
]


@pytest.mark.parametrize("first", range(0, len(TGA_FILES), 2))
def test_tga_load_matches_jax(first):
    """RLE and raw, every depth, both origins in each axis, grey and
    colormapped, the TGA 2.0 footer, the sRGB flags: bit-equal planes and
    equal metadata (two files of TGA_FILES a case)."""
    for case in TGA_FILES[first:first + 2]:
        _tga_case(*case)


def _tga_case(image_type, bpp, desc, flags, footer):
    cmap = None
    if footer in ("cmap24", "cmap32"):
        rng = np.random.default_rng(bpp)
        cmap = rng.integers(0, 256, (40, 3 if footer == "cmap24" else 4),
                            dtype=np.uint8)
        px = (_blocky(9, 14, 1, 3) % 40).astype(np.uint8)
        footer = None
    else:
        px = _blocky(9, 14, bpp // 8, 3)
    data = _tga_file(px, image_type, bpp, desc, cmap, footer)
    got = tga.load_from_tga_memory(data, flags, device=CPU)
    want = jtga.load_from_tga_memory(data, flags)
    _bit_equal(got, want, f"type {image_type} bpp {bpp}")
    assert got.metadata == _meta(want.metadata)


def test_tga_all_zero_alpha_rule():
    """A 32 bpp file whose alpha is all zero loads opaque, unless
    ALLOW_ALL_ZERO_ALPHA; one nonzero alpha keeps them all."""
    px = _blocky(6, 8, 4, 5)
    px[..., 3] = 0
    for alpha, flags in ((0, 0), (9, 0), (0, 0x2), (9, 0x2)):
        px[2, 3, 3] = alpha
        data = _tga_file(px, 10, 32, 0x28, None, None)
        got = tga.load_from_tga_memory(data, flags, device=CPU)
        _bit_equal(got, jtga.load_from_tga_memory(data, flags))
        a = got.levels[0][..., 3]
        assert bool((a == 1).all()) == (alpha == 0 and flags == 0)


def test_tga_golden_and_native_rle_twin():
    """albedo.tga as the JAX package loads it, and the native RLE decode
    against its numpy twin on random packets (and truncation)."""
    data = (GOLDEN / "containers" / "albedo.tga").read_bytes()
    _bit_equal(tga.load_from_tga_memory(data, device=CPU),
               jtga.load_from_tga_memory(data))
    for bpp, seed in ((1, 0), (2, 1), (3, 2), (4, 3)):
        px = _blocky(17, 23, bpp, seed).reshape(-1, bpp)
        stream = np.frombuffer(_tga_rle(px), np.uint8)
        got = native.tga_rle_decode(stream.tobytes(), len(px), bpp)
        np.testing.assert_array_equal(got, tga._decode_rle_py(
            stream, bpp, len(px)))
        np.testing.assert_array_equal(got, px.reshape(-1))
        with pytest.raises(ValueError):
            native.tga_rle_decode(stream[:-3].tobytes(), len(px), bpp)
        with pytest.raises(ValueError):
            tga._decode_rle_py(stream[:-3], bpp, len(px))


# -- HDR ----------------------------------------------------------------------

def test_hdr_golden_and_saves_match_jax():
    """probe.hdr, and save bytes (RLE rows, a narrow flat file, zeros,
    NaN, +-inf and tiny values) with their reloads."""
    data = (GOLDEN / "containers" / "probe.hdr").read_bytes()
    _bit_equal(hdr.load_from_hdr_memory(data, device=CPU),
               jhdr.load_from_hdr_memory(data))
    for h, w in ((9, 40), (5, 6)):
        img = _image(h, w, 4, scale=60.0)
        img[0, :4, :3] = [[0, 0, 0], [np.nan, 1, 2], [np.inf, 1, -np.inf],
                          [1e-35, 2e-33, 0]]
        img[1:3, 5:30] = 0.25             # runs
        t, j = _pair(img, FMT.R32G32B32A32_FLOAT)
        out = hdr.save_to_hdr_memory(t)
        assert out == jhdr.save_to_hdr_memory(j)
        assert hdr.get_metadata_from_hdr_memory(out) == _meta(
            jhdr.get_metadata_from_hdr_memory(out))


def test_hdr_native_codecs_equal_numpy_twins():
    """The native scanline decode (new-style RLE, flat rows with old-style
    runs) and the per-channel RLE encode against their numpy twins."""
    rng = np.random.default_rng(7)
    row = rng.integers(0, 256, 300, dtype=np.uint8)
    row[20:90] = 3
    row[100:104] = 9
    row[200:203] = 1
    for ch in (row, row[:5], np.full(260, 4, np.uint8)):
        assert native.hdr_encode_rle_channel(ch) == \
            hdr._encode_rle_channel_py(ch)
    img = _image(7, 33, 8, scale=9.0)
    img[2:5, 4:20] = 1.5
    data = hdr.save_to_hdr_memory(Texture.from_array(img, device=CPU))
    w, h, _, off = hdr._parse_header(data)
    np.testing.assert_array_equal(
        native.hdr_decode_scanlines(data, off, w, h),
        hdr._decode_scanlines_py(data, off, w, h))
    # flat rows: a pixel, an old-style run of 3 (1, 1, 1, 3), pixels
    flat = np.array([[9, 8, 7, 130], [1, 1, 1, 3], [5, 6, 7, 128],
                     [1, 2, 3, 129]], np.uint8)
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=2.5\n\n-Y 2 +X 6\n"
    data = head + flat.tobytes() * 2
    np.testing.assert_array_equal(
        native.hdr_decode_scanlines(data, len(head), 6, 2),
        hdr._decode_scanlines_py(data, len(head), 6, 2))
    _bit_equal(hdr.load_from_hdr_memory(data, device=CPU),
               jhdr.load_from_hdr_memory(data))
    with pytest.raises(ValueError):
        native.hdr_decode_scanlines(data[:-5], len(head), 6, 2)


def test_hdr_decode_exact_power():
    """hdr_china and hdr_flower saved by the JAX package and reloaded: the
    port equals the JAX package wherever XLA's exp2 is exact for the
    pixel's exponent, and the exact formula everywhere (in the thousands
    of values apart on real content)."""
    corpus = np.load(GOLDEN / "corpus.npz")
    e = np.arange(256)
    xla = np.asarray(jnp.exp2((jnp.asarray(e) - 136).astype(jnp.float32)))
    exact = hdr._pow2_table()
    np.testing.assert_array_equal(exact, np.ldexp(np.float64(1.0), e - 136)
                                  .astype(np.float32))
    miss = xla.view(np.uint32) != exact.view(np.uint32)
    print(f"XLA exp2 misses {int(miss.sum())} of 256 exponents")
    counts = {}
    for name, expo in (("hdr_china", 1.0), ("hdr_flower", 1.0),
                       ("hdr_china", 0.37)):
        img = corpus[name].astype(np.float32)
        data = jhdr.save_to_hdr_memory(JTexture.from_array(img))
        if expo != 1.0:
            data = data.replace(b"FORMAT=", b"EXPOSURE=%g\nFORMAT=" % expo)
        got = hdr.load_from_hdr_memory(data, device=CPU).levels[0][0].numpy()
        want = np.asarray(jhdr.load_from_hdr_memory(data).levels[0][0])
        w, h, expo_p, off = hdr._parse_header(data)
        rgbe = hdr._decode_scanlines_py(data, off, w, h)
        scale = exact[rgbe[..., 3]] * np.float32(1.0 / expo_p)
        formula = (rgbe[..., :3].astype(np.float32) + np.float32(0.5)) \
            * scale[..., None]
        np.testing.assert_array_equal(got[..., :3].view(np.uint32),
                                      formula.view(np.uint32))
        np.testing.assert_array_equal(got[..., 3], 1.0)
        hit = ~miss[rgbe[..., 3]]
        np.testing.assert_array_equal(got[hit].view(np.uint32),
                                      want[hit].view(np.uint32))
        counts[f"{name}@{expo}"] = int(
            (got[..., :3].view(np.uint32) != want[..., :3].view(np.uint32))
            .sum())
    print("HDR values that differ from the JAX package:", counts)
    assert counts["hdr_china@1.0"] == 2895
    assert counts["hdr_flower@1.0"] == 1503


# -- PPM / PFM / PHM ----------------------------------------------------------

def _pfm(magic, w, h, scale, vals, dtype):
    return b"%s\n%d %d\n%s\n" % (magic, w, h, scale) + \
        vals.astype(dtype).tobytes()


PNM_FILES = {
    "p6_8": b"P6\n# comment\n5 3\n255\n" + bytes(range(45)),
    "p6_16": b"P6\n5 3\n1000\n" + np.arange(45, dtype=">u2").tobytes() * 1,
    "p3": b"P3\n3 2\n# c\n7\n" + b" ".join(b"%d" % (i % 8)
                                            for i in range(18)),
    "pf_le": _pfm(b"PF", 4, 3, b"-1.0", np.linspace(-2, 9, 36), "<f4"),
    "pf_be_scaled": _pfm(b"PF", 4, 3, b"2.5", np.linspace(-2, 9, 36), ">f4"),
    "pf_gray": _pfm(b"Pf", 4, 3, b"-0.5", np.linspace(0, 3, 12), "<f4"),
    "ph_le": _pfm(b"PH", 4, 3, b"-1.0", np.linspace(-2, 9, 36), "<f2"),
    "ph_gray_be": _pfm(b"Ph", 4, 3, b"3.0", np.linspace(0, 3, 12), ">f2"),
}


@pytest.mark.parametrize("kind", ["ppm", "pfm", "phm"])
def test_pnm_load_matches_jax(kind):
    """P6 at 8 and 16 bits, P3, PFM / PHM in color and grey, both byte
    orders, with and without a scale."""
    tag = {"ppm": "p", "pfm": "f", "phm": "h"}[kind]
    for name, data in sorted(PNM_FILES.items()):
        if name[1] != tag:
            continue
        got = getattr(ppm, f"load_from_{kind}_memory")(data, device=CPU)
        _bit_equal(got, getattr(jppm, f"load_from_{kind}_memory")(data),
                   name)


@pytest.mark.parametrize("kind", ["ppm", "pfm", "phm"])
def test_pnm_save_matches_jax(kind):
    img = _image(6, 7, 9, scale=3.0) - 0.5
    img[0, 0, :3] = [np.nan, 1e-9, 70000.0]
    t, j = _pair(img, FMT.R32G32B32A32_FLOAT)
    data = getattr(ppm, f"save_to_{kind}_memory")(t)
    assert data == getattr(jppm, f"save_to_{kind}_memory")(j)
    _bit_equal(getattr(ppm, f"load_from_{kind}_memory")(data, device=CPU),
               getattr(jppm, f"load_from_{kind}_memory")(data))


# -- Pillow bridge and HEIF ---------------------------------------------------

def _pil_bytes(mode, fmt, seed=0, frames=1):
    from PIL import Image
    rng = np.random.default_rng(seed)
    ims = []
    for k in range(frames):
        if mode == "F":
            im = Image.fromarray(rng.random((6, 9)).astype(np.float32) * 5)
        elif mode == "I;16":
            im = Image.fromarray(rng.integers(0, 65536, (6, 9),
                                              dtype=np.uint16))
        else:
            base = rng.integers(0, 256, (6, 9, 4), dtype=np.uint8)
            im = Image.fromarray(base, "RGBA").convert(mode)
        ims.append(im)
    buf = _io.BytesIO()
    ims[0].save(buf, format=fmt, save_all=frames > 1,
                **({"append_images": ims[1:]} if frames > 1 else {}))
    return buf.getvalue()


WIC_FILES = [
    [("RGBA", "PNG", 0), ("RGB", "BMP", 0), ("L", "PNG", 0)],
    [("I;16", "PNG", 0), ("F", "TIFF", 0), ("P", "GIF", 0)],
    [("LA", "PNG", 0x80 | 0x20), ("RGB", "JPEG", 0x40), ("P", "GIF", 0x10)],
]


@pytest.mark.parametrize("cases", WIC_FILES)
def test_wic_load_matches_jax(cases):
    """Each Pillow mode's mapping (RGBA8 / R8 / R16 / R32F), the sRGB
    flags, and ALL_FRAMES on a three-frame GIF."""
    for mode, fmt, flags in cases:
        data = _pil_bytes(mode, fmt, frames=3 if flags & 0x10 else 1)
        got = wic.load_from_wic_memory(data, flags, device=CPU)
        _bit_equal(got, jwic.load_from_wic_memory(data, flags),
                   f"{mode} {fmt}")
        assert got.metadata.array_size == (3 if flags & 0x10 else 1)


@pytest.mark.parametrize("codecs", [("PNG", "BMP"), ("TIFF", "JPEG")])
def test_wic_save_matches_jax(codecs):
    """Save bytes (quality on JPEG and PNG, NaN and out-of-range values)
    and the metadata queries of them."""
    img = _image(6, 9, 11)
    img[0, 0] = [np.nan, -1, 2, 0.5]
    t, j = _pair(img)
    for codec in codecs:
        c = wic.WIC_CODEC[codec]
        kw = {"quality": 0.8} if codec in ("JPEG", "PNG") else {}
        data = wic.save_to_wic_memory(t, c, **kw)
        assert data == jwic.save_to_wic_memory(j, jwic.WIC_CODEC[codec],
                                               **kw), codec
        meta = wic.get_metadata_queries_from_wic_memory(data)
        assert meta == jwic.get_metadata_queries_from_wic_memory(data)


def test_heif_matches_jax():
    """HEIC and AVIF through libheif (skipped where it is absent, as the
    JAX package's test skips): the port's save is the JAX package's bytes
    and either package's load of them is bit-equal."""
    if not heif.is_available() or not jheif.is_available():
        pytest.skip("libheif unavailable")
    img = _image(16, 24, 12, alpha=1.0)
    t, j = _pair(img, FMT.R8G8B8A8_UNORM_SRGB)
    for comp in ("hevc", "av1"):
        data = heif.save_to_heif_memory(t, compression=comp, quality=0.9)
        jdata = jheif.save_to_heif_memory(j, compression=comp, quality=0.9)
        _bit_equal(heif.load_from_heif_memory(jdata, device=CPU),
                   jheif.load_from_heif_memory(jdata), comp)
        _bit_equal(wic.load_from_wic_memory(data, device=CPU),
                   jwic.load_from_wic_memory(data), comp + " via wic")


# -- dispatch and the runtime loaders -----------------------------------------

@pytest.mark.parametrize("exts", [(".dds", ".tga"), (".hdr", ".exr"),
                                  (".ppm", ".pfm"), (".phm", ".png")])
def test_save_and_load_texture_dispatch(exts, tmp_path):
    """save_texture / load_texture by extension: the port's file equals the
    JAX package's, and their loads are bit-equal."""
    img = _image(8, 12, 13, alpha=0.5)
    t, j = _pair(img)
    for ext in exts:
        mine, theirs = tmp_path / ("a" + ext), tmp_path / ("b" + ext)
        tio.save_texture(t, mine)
        jio.save_texture(j, theirs)
        assert mine.read_bytes() == theirs.read_bytes(), ext
        _bit_equal(tio.load_texture(mine, device=CPU),
                   jio.load_texture(mine), ext)


def test_runtime_loaders_match_jax(tmp_path):
    """create_texture_from_dds (a BC payload kept and decompressed),
    create_texture_from_image (resize and mips within 4 ulp / 1e-6),
    capture_texture and the two ScreenGrab savers."""
    bc = (GOLDEN / "containers" / "bc1.dds").read_bytes()
    kept = loaders.create_texture_from_dds(bc, device=CPU)
    jkept = jloaders.create_texture_from_dds(bc)
    assert all(np.array_equal(a.numpy(), np.asarray(b))
               for a, b in zip(kept.levels, jkept.levels))
    _bit_equal(loaders.create_texture_from_dds(bc, decompress_now=True,
                                               device=CPU),
               jloaders.create_texture_from_dds(bc, decompress_now=True))
    png = tmp_path / "src.png"
    png.write_bytes(_pil_bytes("RGBA", "PNG", 3))
    got = loaders.create_texture_from_image(png, max_size=4, device=CPU)
    want = jloaders.create_texture_from_image(png, max_size=4)
    a, b = _planes(got), _planes(want)
    assert a.shape == b.shape and got.mip_levels == want.mip_levels
    ulp = np.spacing(np.abs(b).astype(np.float32))
    assert (np.abs(a - b) <= np.maximum(4 * ulp, 1e-6)).all()
    arr = _image(5, 6, 14)
    cap = loaders.capture_texture(torch.from_numpy(arr))
    assert cap.device.type == "cpu"
    _bit_equal(cap, jloaders.capture_texture(arr))
    for fn, name in (("save_dds_texture_to_file", "g.dds"),
                     ("save_image_texture_to_file", "g.png")):
        getattr(loaders, fn)(cap, tmp_path / ("t" + name))
        getattr(jloaders, fn)(arr, tmp_path / ("j" + name))
        assert (tmp_path / ("t" + name)).read_bytes() == (
            tmp_path / ("j" + name)).read_bytes()


def test_timing_helpers(tmp_path):
    """timed reports seconds after waiting for its device (the CPU's: no
    wait); profile_trace writes a non-empty Chrome trace."""
    lines = []
    with timing.timed("block", log=lines.append, device=CPU) as r:
        torch.ones(8).sum()
    assert r["seconds"] >= 0 and lines[0].startswith("[timing] block:")
    with timing.profile_trace(tmp_path / "prof", device=CPU) as out:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = pathlib.Path(out["path"])
    assert trace.parent == tmp_path / "prof" and trace.stat().st_size > 0
