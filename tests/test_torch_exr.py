"""The port's EXR codec (directxtex_tpu_torch.io.exr, exr_piz, exr_b44 and
the native PIZ Huffman coder) against the JAX package's and OpenEXR's own
decodes, on the CPU.

Tolerances: none. Every golden file of tests/golden/exr_official/ loads
bit-equal to the JAX reader and to decoded.npz (OpenEXR's decode); every
writer's bytes equal the JAX writer's; the native codecs equal their numpy
twins; the vectorized RLE encoder equals the loop it replaces.
"""

import importlib
import pathlib
import struct

import numpy as np
import pytest
import torch

from directxtex_tpu.texture import Texture as JTexture
from directxtex_tpu_torch.texture import Texture

exr = importlib.import_module("directxtex_tpu_torch.io.exr")
exr_piz = importlib.import_module("directxtex_tpu_torch.io.exr_piz")
exr_b44 = importlib.import_module("directxtex_tpu_torch.io.exr_b44")
native = importlib.import_module("directxtex_tpu_torch.native")
jexr = importlib.import_module("directxtex_tpu.io.exr")
jpiz = importlib.import_module("directxtex_tpu.io.exr_piz")

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
OFFICIAL = GOLDEN / "exr_official"
CPU = "cpu"
FILES = sorted(p.stem for p in OFFICIAL.glob("*.exr"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plane(tex) -> np.ndarray:
    lvl = tex.levels[0][0]
    return np.asarray(lvl.cpu().numpy() if torch.is_tensor(lvl) else lvl,
                      np.float32)


def _same_bits(a, b, what=""):
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                  err_msg=what)


def _image(h=37, w=61, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 4)) * 4.0).astype(np.float32)
    img[3:9, 10:30] = [0.5, 1.0, 2.0, 1.0]        # flat blocks and runs
    img[0, :6, 0] = [np.inf, -np.inf, 65520.0, 1e-7, -0.0, 7e4]
    return img


def _pair(img):
    return Texture.from_array(img, device=CPU), JTexture.from_array(img)


@pytest.mark.parametrize("name", FILES)
def test_official_file_matches_openexr_and_jax(name):
    """Each compression of exr_official (NONE, RLE, ZIPS, ZIP, PIZ, PXR24,
    B44, B44A, and DWAA / DWAB through the port's OpenEXR adapter) against
    OpenEXR's decode frozen in decoded.npz and the JAX reader."""
    if name.startswith("dwa") and native.openexr_library() is None:
        pytest.skip("OpenEXR's headers are absent: DWAA / DWAB raise "
                    "(test_dwa_without_the_adapter_raises)")
    data = (OFFICIAL / f"{name}.exr").read_bytes()
    got = _plane(exr.load_from_exr_memory(data, device=CPU))
    _same_bits(got, _plane(jexr.load_from_exr_memory(data)), name)
    want = np.load(OFFICIAL / "decoded.npz")[name]     # half bits
    _same_bits(got, want.view("<f2").astype(np.float32),
               name + " vs OpenEXR")
    assert exr.get_metadata_from_exr_memory(data).width == got.shape[1]


@pytest.mark.parametrize("name", ["probe_piz", "cpython_testdata"])
def test_container_goldens_match_jax(name):
    data = (GOLDEN / "containers" / f"{name}.exr").read_bytes()
    _same_bits(_plane(exr.load_from_exr_memory(data, device=CPU)),
               _plane(jexr.load_from_exr_memory(data)), name)


@pytest.mark.parametrize("compression", [exr._NONE, exr._RLE, exr._ZIPS,
                                         exr._ZIP, exr._PIZ, exr._B44,
                                         exr._B44A])
def test_save_bytes_match_jax(compression):
    """The writer's bytes (chunking with a short last chunk, raw chunks
    where compression loses, B44A's flat blocks) and their reload."""
    t, j = _pair(_image(45, 61, compression))
    data = exr.save_to_exr_memory(t, compression=compression)
    assert data == jexr.save_to_exr_memory(j, compression=compression)
    _same_bits(_plane(exr.load_from_exr_memory(data, device=CPU)),
               _plane(jexr.load_from_exr_memory(data)))


def test_dwa_through_the_adapter():
    """DWAA / DWAB save and load through the port's OpenEXR adapter: the
    JAX package's bytes, and either reader's planes of them."""
    if native.openexr_library() is None:
        pytest.skip("OpenEXR's headers are absent")
    t, j = _pair(_image(20, 33, 4))
    for comp in (exr._DWAA, exr._DWAB):
        data = exr.save_to_exr_memory(t, compression=comp)
        assert data == jexr.save_to_exr_memory(j, compression=comp)
        _same_bits(_plane(exr.load_from_exr_memory(data, device=CPU)),
                   _plane(jexr.load_from_exr_memory(data)))


def test_dwa_without_the_adapter_raises(monkeypatch):
    """Where OpenEXR's headers are absent there is no adapter, and DWAA /
    DWAB raise ValueError on load and save; the other compressions do not
    need it."""
    data = (OFFICIAL / "dwaa.exr").read_bytes()
    monkeypatch.setattr(native, "OPENEXR_INCLUDE",
                        native.NATIVE_DIR / "no-such-dir")
    assert native.openexr_library() is None
    with pytest.raises(ValueError, match="DWAA/DWAB"):
        exr.load_from_exr_memory(data, device=CPU)
    t, _ = _pair(_image(8, 8))
    with pytest.raises(ValueError, match="DWAA/DWAB"):
        exr.save_to_exr_memory(t, compression=exr._DWAB)
    zip_data = (OFFICIAL / "zip.exr").read_bytes()
    assert exr.load_from_exr_memory(zip_data, device=CPU).levels[0].shape == \
        (1, 57, 64, 4)


def _piz_inputs():
    rng = np.random.default_rng(5)
    yield rng.integers(0, 65536, 5000).astype(np.uint16)        # wide
    yield rng.integers(0, 9, 7000).astype(np.uint16)            # narrow
    runs = np.repeat(rng.integers(0, 300, 400), rng.integers(1, 700, 400))
    yield runs.astype(np.uint16)                                # long runs
    yield np.full(1000, 17, np.uint16)                          # one symbol


def test_piz_huffman_native_equals_twin():
    """The native encoder's stream equals the numpy twin's, and each
    decoder decodes the other's stream; a cut stream raises."""
    for raw in _piz_inputs():
        stream = exr_piz.huf_compress(raw)
        assert stream == exr_piz._huf_compress_py(raw)
        np.testing.assert_array_equal(
            exr_piz.huf_uncompress(stream, len(raw)), raw)
        np.testing.assert_array_equal(
            exr_piz._huf_uncompress_py(stream, len(raw)), raw)
        with pytest.raises(ValueError):
            exr_piz.huf_uncompress(stream[:len(stream) // 2], len(raw))


@pytest.mark.parametrize("shape", [(32, 61), (7, 5), (1, 9), (33, 1)])
def test_piz_wavelet_round_trip(shape):
    """wav2_encode then wav2_decode gives the data back, at 14-bit and
    full 16-bit ranges, in place on a strided channel view; equal to the
    JAX package's transform."""
    rng = np.random.default_rng(shape[0])
    ny, nx = shape
    for mx in (1 << 13, 65535):
        data = rng.integers(0, mx + 1, (ny, nx * 2)).astype(np.uint16)
        buf = data.reshape(-1).copy()
        jbuf = buf.copy()
        exr_piz.wav2_encode(buf[1:], nx, 2, ny, nx * 2, mx)
        jpiz.wav2_encode(jbuf[1:], nx, 2, ny, nx * 2, mx)
        np.testing.assert_array_equal(buf, jbuf)
        exr_piz.wav2_decode(buf[1:], nx, 2, ny, nx * 2, mx)
        np.testing.assert_array_equal(buf.reshape(ny, -1), data)


def test_piz_chunk_round_trip():
    """A PIZ chunk of two channels (half and float) compressed and
    decompressed gives the chunk's bytes back, and its bytes equal the
    JAX package's."""
    rng = np.random.default_rng(9)
    width, ny = 13, 32
    layout = [("A", 1, ny), ("Z", 2, ny)]
    raw = rng.integers(0, 256, ny * width * 6, dtype=np.uint8)
    raw[: width * 20] = 3
    packed = exr_piz.piz_compress(raw, layout, width)
    assert packed == jpiz.piz_compress(raw, layout, width)
    np.testing.assert_array_equal(
        exr_piz.piz_uncompress(packed, layout, width), raw)


def test_rle_encoder_equals_loop():
    """The vectorized EXR RLE encoder against the byte loop it replaces:
    runs of 1 to 300, runs of exactly three and two, literals longer than
    127, and the empty buffer."""
    rng = np.random.default_rng(11)
    parts = []
    for _ in range(300):
        v = int(rng.integers(0, 4))
        parts.append(np.full(int(rng.choice([1, 2, 3, 4, 127, 128, 129,
                                             300])), v, np.uint8))
        parts.append(rng.integers(0, 256, int(rng.integers(0, 200)),
                                  dtype=np.uint8))
    cases = [np.concatenate(parts), np.zeros(0, np.uint8),
             np.array([5, 5, 5], np.uint8), np.array([1, 2], np.uint8),
             np.tile(np.array([7, 7, 7, 8], np.uint8), 90)]
    for buf in cases:
        assert exr._rle_encode(buf) == exr._rle_encode_py(buf)
        if len(buf):
            np.testing.assert_array_equal(
                exr._rle_decode(exr._rle_encode(buf), len(buf)), buf)


def test_b44_codec_equals_jax():
    """B44 / B44A chunks: the port's vectorized byte assembly and its scan
    that skips a chunk with no flat block give the JAX package's bytes and
    planes."""
    jb44 = importlib.import_module("directxtex_tpu.io.exr_b44")
    rng = np.random.default_rng(13)
    width, ny = 10, 32
    half = rng.standard_normal((ny, 4 * width)).astype("<f2")
    half[:8, :8] = 1.5                                   # flat blocks
    raw = half.view(np.uint8).reshape(-1)
    layout = [(n, 1, ny) for n in "ABGR"]
    for flat_ok in (False, True):
        packed = exr_b44.compress(raw, layout, width, flat_ok)
        assert packed == jb44.compress(raw, layout, width, flat_ok)
        np.testing.assert_array_equal(
            exr_b44.uncompress(packed, layout, width, raw.size),
            jb44.uncompress(packed, layout, width, raw.size))


def test_channel_layouts_match_jax():
    """Hand-built NONE files: B, G, R only (alpha 1), a lone Y (grey), a
    FLOAT and a UINT channel, and a data window that does not start at 0;
    a bad magic, a tiled file and a truncated one raise."""
    h, w = 5, 7
    rng = np.random.default_rng(3)
    cases = {
        "bgr": [(b"B", 1), (b"G", 1), (b"R", 1)],
        "y": [(b"Y", 1)],
        "float_uint": [(b"A", 2), (b"G", 0), (b"R", 2)],
    }
    for key, chans in cases.items():
        chlist = b"".join(n + b"\0" + struct.pack("<i", pt) + b"\0\0\0\0"
                          + struct.pack("<ii", 1, 1) for n, pt in chans)
        box = struct.pack("<4i", 3, 10, 3 + w - 1, 10 + h - 1)
        hdr = struct.pack("<II", exr._MAGIC, 2)
        hdr += exr._attr(b"channels", b"chlist", chlist + b"\0")
        hdr += exr._attr(b"compression", b"compression", b"\0")
        hdr += exr._attr(b"dataWindow", b"box2i", box)
        hdr += exr._attr(b"displayWindow", b"box2i", box)
        hdr += exr._attr(b"lineOrder", b"lineOrder", b"\0")
        hdr += b"\0"
        size = sum(2 if pt == 1 else 4 for _, pt in chans) * w
        rows = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
                for _ in range(h)]
        if key == "float_uint":      # finite floats in the FLOAT rows
            rows = [np.concatenate([
                rng.random(w).astype("<f4").view(np.uint8),
                rng.integers(0, 2 ** 32, w, dtype=np.uint64).astype(
                    "<u4").view(np.uint8),
                rng.random(w).astype("<f4").view(np.uint8)]).tobytes()
                for _ in range(h)]
        out = bytearray(hdr)
        off = len(hdr) + 8 * h
        for r in rows:
            out += struct.pack("<Q", off)
            off += 8 + len(r)
        for y, r in enumerate(rows):
            out += struct.pack("<ii", 10 + y, len(r)) + r
        data = bytes(out)
        _same_bits(_plane(exr.load_from_exr_memory(data, device=CPU)),
                   _plane(jexr.load_from_exr_memory(data)), key)
    t, _ = _pair(_image(8, 8))
    good = exr.save_to_exr_memory(t)
    tiled = bytearray(good)
    struct.pack_into("<I", tiled, 4, struct.unpack_from("<I", good, 4)[0]
                     | 0x200)
    for bad, match in ((b"\0" * 64, "magic"), (bytes(tiled), "tiled"),
                       (good[:len(good) // 2], None)):
        with pytest.raises(ValueError, match=match):
            exr.load_from_exr_memory(bad, device=CPU)


def test_signalling_nan_halves():
    """A NaN half keeps its sign and payload in both packages; the port
    sets the quiet bit (as XLA and torch's CPU and CUDA builds do), where
    numpy, the JAX package's EXR reader, leaves a signalling NaN
    unquieted (ROADMAP queue 3). Every other half is bit-equal."""
    halves = np.array([0x7C01, 0xFC01, 0x7E55, 0x3C00, 0x7C00, 0x0001,
                       0x83FF, 0x7BFF], np.uint16)
    img = np.zeros((2, 4, 4), np.uint16)
    img.reshape(-1)[:8] = halves
    t, _ = _pair(np.zeros((2, 4, 4), np.float32))
    data = bytearray(exr.save_to_exr_memory(t, compression=exr._NONE))
    body = np.ascontiguousarray(img[..., ::-1].transpose(0, 2, 1))
    for y in range(2):            # each NONE chunk: y, size, A B G R rows
        end = len(data) - (1 - y) * (8 + 32)
        data[end - 32:end] = body[y].tobytes()
    got = _plane(exr.load_from_exr_memory(bytes(data), device=CPU))
    want = _plane(jexr.load_from_exr_memory(bytes(data)))
    g, w = got.reshape(-1).view(np.uint32), want.reshape(-1).view(np.uint32)
    sig = np.isnan(want.reshape(-1)) & ((w & 0x400000) == 0)
    np.testing.assert_array_equal(g[~sig], w[~sig])
    np.testing.assert_array_equal(g[sig], w[sig] | 0x400000)
    assert int(sig.sum()) == 2
