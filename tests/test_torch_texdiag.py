"""The port's texdiag (directxtex_tpu_torch.tools.texdiag) against the JAX
package's tool, on the CPU: `main(argv, device="cpu")` beside the JAX
tool's `main(argv)` on the same files, their printed lines compared.

Tolerances, per command:
- info, analyzebc, dumpbc, dumpdds and diff: the lines (and written
  files' bytes) equal the JAX tool's, text for text. dumpbc over every
  block of the BC7 and BC6H files is held to the JAX tool's lines frozen
  in tests/golden/texdiag.npz (tests/golden/generate_texdiag.py; the JAX
  tool decodes a block a call, 12-25 s a file); the rest run live;
- analyze and compare: the same lines, and every number in them within
  2e-6 of the JAX tool's (analyze reduces in f64 where the JAX tool
  reduces in numpy f32; compare's sums run in another order), PSNR
  within its last printed digit (0.01 dB); the count of lines whose text
  differs is printed.

The BC inputs are the port's own encodes on the CPU (its words are held
to the JAX package's by the codec tests).
"""

import contextlib
import importlib
import io
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.formats import FMT
from directxtex_tpu_torch.ops import compress, generate_mipmaps
from directxtex_tpu_torch.texture import Texture

texdiag = importlib.import_module("directxtex_tpu_torch.tools.texdiag")
tio = importlib.import_module("directxtex_tpu_torch.io")
jtexdiag = importlib.import_module("directxtex_tpu.tools.texdiag")

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
sys.path.insert(0, str(GOLDEN))
gen = importlib.import_module("generate_texdiag")

CPU = "cpu"
BC_FORMATS = ("BC7_UNORM", "BC6H_UF16", "BC6H_SF16", "BC1_UNORM",
              "BC2_UNORM", "BC3_UNORM", "BC4_UNORM", "BC4_SNORM",
              "BC5_UNORM", "BC5_SNORM")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frozen():
    return np.load(GOLDEN / "texdiag.npz")


@pytest.fixture(scope="module")
def files(tmp_path_factory, frozen):
    """The BC files of generate_texdiag.source_bytes, a BC7 file of mixed
    content (flat, two-region, alpha-graded and noisy blocks: partitions,
    rotations and both index modes), a float image with its mip
    chain (32 x 64), its copy with a little noise, a cube and a volume (DDS), a
    BC7_TYPELESS copy and an R16G16B16A16_TYPELESS image."""
    d = tmp_path_factory.mktemp("diag")
    out = {}
    for fmt in BC_FORMATS:
        data = gen.source_bytes(fmt)
        if f"src_{fmt}" in frozen:
            assert data == frozen[f"src_{fmt}"].tobytes(), fmt
        out[fmt] = d / f"{fmt}.dds"
        out[fmt].write_bytes(data)
    rng = np.random.default_rng(41)
    mixed = np.zeros((16, 48, 4), np.float32)
    mixed[..., 3] = 1
    mixed[:, :16, :3] = 0.8
    mixed[np.triu_indices(16)] = (0.1, 0.7, 0.2, 1.0)
    mixed[:, 16:32] = rng.random((16, 16, 4)) * 0.1 + 0.45
    mixed[:, 16:32, 3] = np.linspace(0, 1, 16)[None]
    mixed[:, 32:] = rng.random((16, 16, 4))
    tex = Texture.from_array(mixed, device=CPU)
    out["mixed"] = d / "mixed.dds"
    tio.save_texture(compress(tex, FMT.BC7_UNORM), str(out["mixed"]))
    img = rng.random((32, 64, 4)).astype(np.float32)
    out["float"] = d / "float.dds"
    tio.save_texture(generate_mipmaps(Texture.from_array(
        img, FMT.R32G32B32A32_FLOAT, device=CPU)), str(out["float"]))
    noisy = img + (rng.random(img.shape).astype(np.float32) - 0.5) * 0.02
    out["noisy"] = d / "noisy.dds"
    tio.save_texture(Texture.from_array(noisy, FMT.R32G32B32A32_FLOAT,
                                        device=CPU), str(out["noisy"]))
    out["cube"] = d / "cube.dds"
    tio.save_texture(generate_mipmaps(Texture.from_array(
        rng.random((6, 8, 8, 4)).astype(np.float32), is_cube=True,
        device=CPU)), str(out["cube"]))
    from directxtex_tpu_torch.texture import TexDimension
    out["volume"] = d / "volume.dds"
    tio.save_texture(Texture.from_array(
        rng.random((3, 4, 8, 4)).astype(np.float32),
        FMT.R16G16B16A16_FLOAT, dimension=TexDimension.TEXTURE3D,
        device=CPU), str(out["volume"]))
    ct = tio.load_texture(str(out["BC7_UNORM"]), device=CPU)
    out["bc7_typeless"] = d / "bc7_typeless.dds"
    tio.save_texture(type(ct)(ct.metadata.with_format(FMT.BC7_TYPELESS),
                              ct.levels), str(out["bc7_typeless"]))
    # an R16G16B16A16_UNORM file whose DX10 header names the TYPELESS
    # format (the savers write no TYPELESS pixels)
    data = bytearray(tio.save_to_dds_memory(Texture.from_array(
        img[:8, :8], FMT.R16G16B16A16_UNORM, device=CPU),
        tio.DDS_FLAGS.FORCE_DX10_EXT))
    assert data[84:88] == b"DX10"
    data[128:132] = int(FMT.R16G16B16A16_TYPELESS).to_bytes(4, "little")
    out["typeless"] = d / "typeless.dds"
    out["typeless"].write_bytes(bytes(data))
    return {k: str(v) for k, v in out.items()}


def _lines(mod, argv, **kw):
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = mod.main(["-nologo", *argv], **kw)
    return rc, o.getvalue().splitlines(), e.getvalue()


def _same(argv):
    got = _lines(texdiag, argv, device=CPU)
    want = _lines(jtexdiag, argv)
    assert got == want, (argv, got, want)
    return got


INFO = ["BC7_UNORM", "BC6H_SF16", "cube", "volume"]


@pytest.mark.parametrize("name", INFO)
def test_info_matches_jax(name, files):
    _same(["info", files[name]])


def test_typeless_and_dds_flags_match_jax(files):
    """-tu / -tf on an R16G16B16A16_TYPELESS file (both loaders refuse to
    unpack it: the same FAILED line, rc 1), -ignoremips, -permissive."""
    for flag in ("-tu", "-tf"):
        rc, lines, err = _same([flag, "info", files["typeless"]])
        assert rc == 1 and "FAILED" in err
    assert _same(["-ignoremips", "-permissive", "info",
                  files["cube"]])[0] == 0


def test_typeless_bc_promotion_where_jax_fails(files):
    """The JAX tool's -tu / -tf on a BC7_TYPELESS file fails
    (CompressedTexture has no replace_levels) and counts the file FAILED;
    the port promotes it to BC7_UNORM / analyzes it (ROADMAP queue 3)."""
    for argv in (["-tu", "info"], ["-tf", "analyzebc"]):
        rc, lines, err = _lines(jtexdiag, [*argv, files["bc7_typeless"]])
        assert rc == 1 and "replace_levels" in err
    rc, lines, _ = _lines(texdiag, ["-tu", "info", files["bc7_typeless"]],
                          device=CPU)
    assert rc == 0 and lines[6] == "      format: BC7_UNORM"
    got = _lines(texdiag, ["-tu", "analyzebc", files["bc7_typeless"]],
                 device=CPU)
    want = _same(["analyzebc", files["BC7_UNORM"]])
    assert got[0] == 0 and got[1] == want[1]


@pytest.mark.parametrize("name", BC_FORMATS + ("mixed",))
def test_analyzebc_matches_jax(name, files):
    rc, lines, _ = _same(["analyzebc", files[name]])
    assert rc == 0 and len(lines) >= 2


def test_analyzebc_mixed_content_has_every_histogram(files):
    lines = _same(["analyzebc", files["mixed"]])[1]
    text = "\n".join(lines)
    assert "partitions:" in text and "rotations:" in text, text
    assert "index modes:" in text, text


def test_analyzebc_refuses_uncompressed_as_jax(files):
    got = _lines(texdiag, ["analyzebc", files["float"]], device=CPU)
    want = _lines(jtexdiag, ["analyzebc", files["float"]])
    assert got[0] == want[0] == 1


@pytest.mark.parametrize("fmt", gen.DUMPBC_FORMATS)
def test_dumpbc_every_block_matches_frozen_jax(fmt, files, frozen):
    rc, lines, _ = _lines(texdiag, ["dumpbc", files[fmt]], device=CPU)
    assert rc == 0
    assert lines == str(frozen[f"dumpbc_{fmt}"]).splitlines()


@pytest.mark.parametrize("fmt", ["BC1_UNORM", "BC3_UNORM", "BC4_SNORM"])
def test_dumpbc_every_block_matches_jax(fmt, files):
    _same(["dumpbc", files[fmt]])


@pytest.mark.parametrize("fmt", ["BC7_UNORM", "BC6H_SF16", "BC5_SNORM"])
def test_dumpbc_target_matches_jax(fmt, files):
    """-targetx / -targety pick the block holding that pixel; a pixel
    outside the level, -m and -item as the JAX tool."""
    _same(["-targetx", "13", "-targety", "6", "dumpbc", files[fmt]])
    rc, lines, _ = _same(["-targetx", "24", "dumpbc", files[fmt]])
    assert rc == 1 and "out of range" in lines[0]


def test_dumpbc_mip_matches_jax(files, tmp_path):
    ct = compress(tio.load_texture(files["float"], device=CPU),
                  FMT.BC1_UNORM)
    path = str(tmp_path / "bc1mips.dds")
    tio.save_texture(ct, path)
    _same(["-m", "2", "dumpbc", path])
    _same(["-m", "1", "analyzebc", path])


def _numbers(line: str) -> list:
    return [float(v) for v in re.findall(r"-?\d+\.\d+", line)]


def _close_lines(argv, bound: float, psnr_bound: float = 0.0):
    got = _lines(texdiag, argv, device=CPU)
    want = _lines(jtexdiag, argv)
    assert got[0] == want[0] == 0
    a, b = got[1], want[1]
    assert len(a) == len(b)
    differ = 0
    for x, y in zip(a, b):
        assert re.sub(r"-?\d+\.\d+", "#", x) == re.sub(r"-?\d+\.\d+", "#",
                                                       y), (x, y)
        lim = psnr_bound if "PSNR" in x else bound
        assert np.allclose(_numbers(x), _numbers(y), rtol=0, atol=lim), \
            (x, y)
        differ += x != y
    print(f"{argv[0]}: {differ} of {len(a)} lines differ in text")


@pytest.mark.parametrize("name", ["float", "BC7_UNORM", "BC6H_UF16"])
def test_analyze_within_bound_of_jax(name, files):
    _close_lines(["analyze", files[name]], 2e-6)


@pytest.mark.parametrize("pair", [("float", "noisy"),
                                  ("float", "float")])
def test_compare_within_bound_of_jax(pair, files):
    _close_lines(["compare", files[pair[0]], files[pair[1]]], 2e-6, 0.01)


def test_compare_decoded_bc_within_bound_of_jax(files, tmp_path):
    """A source against its BC7 encode (decoded by K1 on CUDA)."""
    src = tmp_path / "src.dds"
    img = gen.source_image()
    tio.save_texture(Texture.from_array(img, FMT.R32G32B32A32_FLOAT,
                                        device=CPU), str(src))
    _close_lines(["compare", str(src), files["BC7_UNORM"]], 2e-6, 0.01)
    rc, lines, _ = _same(["compare", str(src), files["float"]])
    assert rc == 1 and "differ" in lines[0]


def test_diff_matches_jax(files, tmp_path):
    """|a - b| and the -c highlight at -t: the PNG bytes equal the JAX
    tool's; an existing output needs -y."""
    for extra in ([], ["-c", "00FF00", "-t", "0.004"]):
        got, want = tmp_path / "t.png", tmp_path / "j.png"
        args = ["-y", "diff", files["float"], files["noisy"], *extra]
        assert _lines(texdiag, [*args, "-o", str(got)], device=CPU)[0] == 0
        assert _lines(jtexdiag, [*args, "-o", str(want)])[0] == 0
        assert got.read_bytes() == want.read_bytes(), extra
    rc = _lines(texdiag, ["diff", files["float"], files["noisy"], "-o",
                          str(got)], device=CPU)[0]
    assert rc == 1


@pytest.mark.parametrize("name,ext", [("cube", "png"), ("volume", "dds"),
                                      ("BC7_UNORM", "tga")])
def test_dumpdds_matches_jax(name, ext, files, tmp_path, monkeypatch):
    """Every surface as its own file, named _itemNNN / _sliceNNN (+
    _mipNNN): the same names and bytes as the JAX tool's."""
    outs = {}
    for tag, mod, kw in (("t", texdiag, {"device": CPU}),
                         ("j", jtexdiag, {})):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        rc, lines, _ = _lines(mod, ["-ft", ext, "dumpdds", files[name]],
                              **kw)
        assert rc == 0
        outs[tag] = (lines, {p.name: p.read_bytes() for p in d.iterdir()})
    assert outs["t"] == outs["j"]
    assert len(outs["t"][1]) == {"cube": 24, "volume": 3, "BC7_UNORM": 1}[name]


def test_multi_file_loop_matches_jax(files, tmp_path):
    """Several files (one failing: not BC), -flist and -r wildcards: the
    same lines, FAILED lines and return codes."""
    flist = tmp_path / "list.txt"
    flist.write_text(f"# BC files\n{files['BC1_UNORM']}\n\n"
                     f"{files['float']}\n")
    for argv in (["analyzebc", "-flist", str(flist)],
                 ["-r", "info", str(pathlib.Path(files["BC1_UNORM"])
                                    .parent / "BC4*.dds")],
                 ["analyzebc", files["BC3_UNORM"], files["BC2_UNORM"]],
                 ["info", str(tmp_path / "none*.dds")],
                 ["compare", files["float"]]):
        _same(argv)


def test_version_matches_jax(capsys):
    assert texdiag.main(["-version"], device=CPU) == 0
    assert "texdiag" in capsys.readouterr().out
