"""The port's texassemble and ddsview (directxtex_tpu_torch.tools) against
the JAX package's tools, on the CPU: `main(argv, device="cpu")` beside the
JAX tool's `main(argv)` on the same source files.

Tolerances, per test:
- every output file's bytes equal the JAX tool's (DDS, PNG), except
  where a resize runs (from-mips, cube-from-mips with inputs of the wrong
  size, the -w / -ht size normalization): there the outputs are
  R32G32B32A32_FLOAT DDS files whose headers are equal and whose values
  are within 4 ulp of the JAX tool's or 1e-6 (the two products sum in
  another order), and the count of differing values is printed;
- a layout and its inverse give the cube's faces back bit for bit.
"""

import importlib
import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.formats import FMT
from directxtex_tpu_torch.ops import generate_mipmaps
from directxtex_tpu_torch.texture import TexAlphaMode, Texture

texassemble = importlib.import_module("directxtex_tpu_torch.tools.texassemble")
ddsview = importlib.import_module("directxtex_tpu_torch.tools.ddsview")
tio = importlib.import_module("directxtex_tpu_torch.io")
jtexassemble = importlib.import_module("directxtex_tpu.tools.texassemble")
jddsview = importlib.import_module("directxtex_tpu.tools.ddsview")

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _save(img, path, fmt=FMT.R8G8B8A8_UNORM, **kw):
    tio.save_texture(Texture.from_array(img, fmt, device=CPU, **kw),
                     str(path))
    return str(path)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """Six 8 x 8 RGBA PNG faces, two 12 x 6 float DDS images, a 16 x 16
    float DDS with a full mip chain, an HDR image, a premultiplied DDS, a
    BC7 cube and an animated GIF with transparent pixels, written by the
    port's savers (or Pillow)."""
    d = tmp_path_factory.mktemp("src")
    rng = np.random.default_rng(31)
    out = {"faces": [_save(rng.random((8, 8, 4)).astype(np.float32),
                           d / f"face{i}.png") for i in range(6)]}
    out["wide"] = [_save(rng.random((6, 12, 4)).astype(np.float32),
                         d / f"wide{i}.dds", FMT.R32G32B32A32_FLOAT)
                   for i in range(2)]
    chain = generate_mipmaps(Texture.from_array(
        rng.random((16, 16, 4)).astype(np.float32),
        FMT.R32G32B32A32_FLOAT, device=CPU))
    out["mipped"] = str(d / "mipped.dds")
    tio.save_texture(chain, out["mipped"])
    out["hdr"] = _save((rng.random((8, 8, 4)) * 12).astype(np.float32),
                       d / "env.hdr", FMT.R32G32B32A32_FLOAT)
    out["pm"] = _save(rng.random((8, 8, 4)).astype(np.float32),
                      d / "pm.dds", FMT.R16G16B16A16_FLOAT,
                      alpha_mode=TexAlphaMode.PREMULTIPLIED)
    from directxtex_tpu_torch.ops import compress
    cube = Texture.from_array(rng.random((6, 8, 8, 4)).astype(np.float32),
                              is_cube=True, device=CPU)
    out["bc7cube"] = str(d / "bc7cube.dds")
    tio.save_texture(compress(cube, FMT.BC7_UNORM), out["bc7cube"])
    from PIL import Image
    frames = []
    for k in range(3):
        px = rng.integers(0, 255, (8, 8), np.uint8)
        px[k:k + 3, 2:5] = 255          # index 255 is transparent
        frame = Image.fromarray(px, "P")
        frame.putpalette(list(rng.integers(0, 256, 768, np.uint8)))
        frames.append(frame)
    out["gif"] = str(d / "anim.gif")
    frames[0].save(out["gif"], save_all=True, append_images=frames[1:],
                   transparency=255, disposal=2)
    return out


def _both(tmp_path, mod_args, name):
    """texassemble on the port (CPU) and on the JAX package; the two
    output paths."""
    got, want = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
    assert texassemble.main(["-nologo", "-y", *mod_args(got)],
                            device=CPU) == 0
    assert jtexassemble.main(["-nologo", "-y", *mod_args(want)]) == 0
    return got, want


def _same_bytes(tmp_path, args, files, name):
    got, want = _both(tmp_path, lambda o: ["-o", str(o), *args, *files],
                      name)
    assert got.read_bytes() == want.read_bytes(), name
    return got


def _close_f32(got: pathlib.Path, want: pathlib.Path, what: str) -> None:
    """R32G32B32A32_FLOAT DDS files: headers equal, values within 4 ulp or
    1e-6; prints the count that differ."""
    a, b = got.read_bytes(), want.read_bytes()
    head = 148 if a[84:88] == b"DX10" else 128
    assert len(a) == len(b) and a[:head] == b[:head], what
    x = np.frombuffer(a[head:], np.float32)
    y = np.frombuffer(b[head:], np.float32)
    assert (np.abs(x - y) <= np.maximum(4 * np.spacing(np.abs(y)),
                                        1e-6)).all(), what
    n = int((x.view(np.uint32) != y.view(np.uint32)).sum())
    print(f"{what}: {n} of {x.size} values differ from the JAX tool's")


@pytest.mark.parametrize("cmd", ["cube", "array", "volume"])
def test_stacks_match_jax(cmd, src, tmp_path):
    _same_bytes(tmp_path, [cmd], src["faces"], f"{cmd}.dds")


def test_cubearray_dx10_mips_lowercase_match_jax(src, tmp_path):
    """cubearray of two cubes with -dx10, -m 0 (a box chain on the
    assembled output) and -l (the output name lower-cased)."""
    flist = tmp_path / "list.txt"
    flist.write_text("\n".join(src["faces"] * 2) + "\n")
    got, want = _both(tmp_path, lambda o: [
        "cubearray", "-dx10", "-m", "0", "-l", "-flist", str(flist),
        "-o", str(o.with_name(o.name.upper()))], "ca.dds")
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes()[84:88] == b"DX10"


LAYOUTS = list(zip(texassemble.LAYOUTS, texassemble.INVERSES))


@pytest.mark.parametrize("layout,inverse", LAYOUTS,
                         ids=[c[0] for c in LAYOUTS])
def test_layout_and_inverse_match_jax(layout, inverse, src, tmp_path):
    """A cube -> the layout -> a cube: each file's bytes equal the JAX
    tool's, and the faces come back bit for bit."""
    cube = _same_bytes(tmp_path, ["cube"], src["faces"], "cube.dds")
    lay = _same_bytes(tmp_path, [layout], [str(cube)], "lay.dds")
    back = _same_bytes(tmp_path, [inverse], [str(lay)], "back.dds")
    a = tio.load_texture(str(cube), device=CPU).levels[0]
    b = tio.load_texture(str(back), device=CPU)
    assert b.metadata.is_cubemap() and torch.equal(a, b.levels[0])


def test_layout_from_six_images_matches_jax(src, tmp_path):
    _same_bytes(tmp_path, ["h-tee"], src["faces"], "tee.dds")


def test_merge_swizzle_matches_jax(src, tmp_path):
    _same_bytes(tmp_path, ["--swizzle", "rGbA", "merge"],
                src["faces"][:2], "merge.dds")


def test_gif_bgcolor_matches_jax(src, tmp_path):
    """Every frame of an animated GIF, composited onto -bgcolor: alpha is
    blended too (a * a + 1 - a), as the JAX tool does."""
    got = _same_bytes(tmp_path, ["-bgcolor", "203040", "gif"],
                      [src["gif"]], "gif.dds")
    tex = tio.load_texture(str(got), device=CPU)
    assert tex.metadata.array_size == 3
    _same_bytes(tmp_path, ["gif"], [src["gif"]], "gif_plain.dds")


def test_array_strip_matches_jax(src, tmp_path):
    arr = _same_bytes(tmp_path, ["array"], src["faces"][:3], "arr.dds")
    _same_bytes(tmp_path, ["array-strip"], [str(arr)], "strip.dds")


def test_tonemap_format_matches_jax(src, tmp_path):
    """-tonemap (the max luminance stays on the device) and -f."""
    _same_bytes(tmp_path, ["-tonemap", "-f", "R16G16B16A16_FLOAT",
                           "array"], [src["hdr"]], "tm.dds")


def test_premultiplied_alpha_undone_matches_jax(src, tmp_path):
    _same_bytes(tmp_path, ["-alpha", "array"], [src["pm"]], "pm.dds")


def test_bc_inputs_decompressed_match_jax(src, tmp_path):
    """A BC7 cube (K1 on CUDA) through h-cross."""
    _same_bytes(tmp_path, ["h-cross"], [src["bc7cube"]], "bc7hc.dds")


def test_from_mips_matches_jax(src, tmp_path):
    got, want = _both(tmp_path, lambda o: [
        "-o", str(o), "from-mips", src["mipped"]], "fm.dds")
    _close_f32(got, want, "from-mips")


def test_cube_from_mips_matches_jax(src, tmp_path):
    """Six faces x 3 levels: the 12 x 6 inputs resized to each level's
    size (16 x 16 base from the first input)."""
    files = [src["mipped"]] + src["wide"] * 8 + [src["wide"][0]]
    files = files[:18]
    got, want = _both(tmp_path, lambda o: [
        "-o", str(o), "cube-from-mips", *files], "cfm.dds")
    _close_f32(got, want, "cube-from-mips")


def test_size_normalization_matches_jax(src, tmp_path):
    got, want = _both(tmp_path, lambda o: [
        "-w", "10", "-ht", "7", "-if", "cubic", "-o", str(o), "array",
        *src["wide"]], "norm.dds")
    _close_f32(got, want, "-w / -ht")


def test_refusals_match_jax(src, tmp_path, capsys):
    """Wrong input counts, no -o, an existing output without -y and
    -version: the JAX tool's return codes."""
    out = str(tmp_path / "x.dds")
    for args in (["-o", out, "cube", *src["faces"][:5]],
                 ["-o", out, "cubearray", *src["faces"][:5]],
                 ["-o", out, "merge", src["faces"][0]],
                 ["-o", out, "cube-from-mips", *src["faces"][:5]],
                 ["cube", *src["faces"]]):
        assert texassemble.main(["-nologo", *args], device=CPU) == \
            jtexassemble.main(["-nologo", *args]) == 1, args
    assert texassemble.main(["-nologo", "-o", out, "array",
                             src["faces"][0]], device=CPU) == 0
    assert texassemble.main(["-nologo", "-o", out, "array",
                             src["faces"][0]], device=CPU) == 1
    assert texassemble.main(["-version"], device=CPU) == 0
    assert "texassemble" in capsys.readouterr().out


def _view_both(tmp_path, args, name):
    got, want = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
    assert ddsview.main(["-nologo", "-o", str(got), *args],
                        device=CPU) == 0
    assert jddsview.main(["-nologo", "-o", str(want), *args]) == 0
    assert got.read_bytes() == want.read_bytes(), (args, name)


@pytest.fixture(scope="module")
def cube_dds(src, tmp_path_factory):
    out = tmp_path_factory.mktemp("cube") / "cube.dds"
    assert texassemble.main(["-nologo", "-o", str(out), "cube",
                             *src["faces"]], device=CPU) == 0
    return str(out)


VIEWS = {"cross": [], "item": ["-i", "2"], "tonemap": ["--tonemap"]}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_ddsview_cube_matches_jax(view, cube_dds, tmp_path):
    _view_both(tmp_path, [*VIEWS[view], cube_dds], f"{view}.png")


def test_ddsview_contact_sheet_mips_bc_hdr_match_jax(src, tmp_path):
    """A 5-item array's contact sheet, a mip strip, a BC7 cube's cross
    and an HDR image tonemapped."""
    arr = tmp_path / "arr5.dds"
    assert texassemble.main(["-nologo", "-o", str(arr), "array",
                             *src["faces"][:5]], device=CPU) == 0
    _view_both(tmp_path, [str(arr)], "sheet.png")
    _view_both(tmp_path, ["--mips", src["mipped"]], "mips.png")
    _view_both(tmp_path, ["-m", "2", src["mipped"]], "mip2.png")
    _view_both(tmp_path, [src["bc7cube"]], "bc7.png")
    _view_both(tmp_path, ["--tonemap", src["hdr"]], "hdr.png")


def test_ddsview_interactive_and_refusals(cube_dds, tmp_path, monkeypatch,
                                          capsys):
    """The key loop (n, p, digits, m, q) writes the JAX tool's PNG at each
    step; out-of-range -m / -i return 1 as the JAX tool does."""
    keys = iter(["n", "3", "m", "p", "q"])
    monkeypatch.setattr("builtins.input", lambda: next(keys))
    got = tmp_path / "live.png"
    assert ddsview.main(["-nologo", "--interactive", "-o", str(got),
                         cube_dds], device=CPU) == 0
    out = capsys.readouterr().out
    assert out.count("wrote") == 5 and "[item 3/6" in out
    want = tmp_path / "one.png"
    assert jddsview.main(["-nologo", "-i", "1", "-o", str(want),
                          cube_dds]) == 0
    assert got.read_bytes() == want.read_bytes()
    for args in (["-m", "3"], ["-i", "6"]):
        assert ddsview.main(["-nologo", *args, cube_dds], device=CPU) == \
            jddsview.main(["-nologo", *args, cube_dds]) == 1
