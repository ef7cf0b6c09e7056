"""The port's texconv (directxtex_tpu_torch.tools.texconv) against the JAX
package's tool, on the CPU: `main(argv, device="cpu")`.

Tolerances, per test:
- non-BC targets: the output file's bytes equal the JAX tool's, except
  where a resize or a filtered mip chain runs (products summed in another
  order): there every value is within 4 ulp of the JAX tool's or 1e-6;
- BC1 and BC7 targets: the output DDS bytes (header and BC words) equal
  the JAX tool's, frozen in tests/golden/texconv.npz
  (tests/golden/generate_texconv.py);
- the batched multi-file path gives the serial path's bytes.
"""

import importlib
import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.formats import FMT
from directxtex_tpu_torch.texture import Texture

texconv = importlib.import_module("directxtex_tpu_torch.tools.texconv")
tio = importlib.import_module("directxtex_tpu_torch.io")
jtexconv = importlib.import_module("directxtex_tpu.tools.texconv")

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """An RGBA8 TGA (24 x 40, a color key's pixels in it) and an HDR file
    (16 x 16) written by the port's savers."""
    d = tmp_path_factory.mktemp("src")
    rng = np.random.default_rng(4)
    img = rng.random((24, 40, 4)).astype(np.float32)
    img[..., 3] = np.linspace(0.1, 1, 40, dtype=np.float32)[None, :]
    img[5:9, 3:12, :3] = np.array([0x10, 0x20, 0x30], np.float32) / 255
    (d / "ldr.tga").write_bytes(tio.save_to_tga_memory(
        Texture.from_array(img, device=CPU)))
    hdr = (rng.random((16, 16, 4)) * 20).astype(np.float32)
    (d / "env.hdr").write_bytes(tio.save_to_hdr_memory(
        Texture.from_array(hdr, FMT.R32G32B32A32_FLOAT, device=CPU)))
    return d


def _run(mod, args, out, **kw):
    return mod.main(["-nologo", "-y", "-o", str(out), *args], **kw)


def _payload_f32(path: pathlib.Path) -> np.ndarray:
    """The f32 values of an R32G32B32A32_FLOAT DDS (header skipped)."""
    data = path.read_bytes()
    return np.frombuffer(data[148 if data[84:88] == b"DX10" else 128:],
                         np.float32)


NON_BC = [
    # (case, arguments, source, products: compared within 4 ulp / 1e-6)
    ("resize", ["-w", "20", "-ht", "13", "-if", "cubic", "-sepalpha",
                "-f", "R32G32B32A32_FLOAT"], "ldr.tga", True),
    ("flip_rotate", ["-hflip", "-rotate", "90",
                     "-f", "R16G16B16A16_FLOAT"], "ldr.tga", False),
    ("swizzle", ["-swizzle", "b0g1", "-f", "R16G16B16A16_FLOAT"],
     "ldr.tga", False),
    ("swizzle_short", ["-swizzle", "rg"], "ldr.tga", False),
    ("tonemap", ["-tonemap"], "env.hdr", False),
    ("colorkey", ["-c", "102030", "-f", "R16G16B16A16_FLOAT"], "ldr.tga",
     False),
    ("invert_reconstruct", ["-inverty", "-reconstructz",
                            "-f", "R16G16B16A16_FLOAT"], "ldr.tga", False),
    ("mips", ["-m", "0", "-if", "linear", "-keepcoverage", "0.5",
              "-f", "R32G32B32A32_FLOAT"], "ldr.tga", True),
    ("pmalpha", ["-pmalpha", "-f", "B8G8R8A8_UNORM", "-dx10"], "ldr.tga",
     False),
    ("exr_out", ["-ft", "exr", "-f", "R16G16B16A16_FLOAT"], "env.hdr",
     False),
    ("tga_png_out", ["-ft", "tga", "-vflip"], "ldr.tga", False),
    ("pfm_out", ["-ft", "pfm", "-rotatecolor", "709to2020"], "env.hdr",
     False),
]


@pytest.mark.parametrize("case,args,src,products", NON_BC,
                         ids=[c[0] for c in NON_BC])
def test_non_bc_matches_jax_tool(case, args, src, products, sources,
                                 tmp_path):
    """Resize, flip / rotate, swizzle (literals, a short mask), tonemap,
    colorkey, invert-y with reconstruct-z, mips with alpha coverage,
    premultiplied alpha, color rotation, and the TGA / EXR / PFM writers."""
    path = str(sources / src)
    assert _run(texconv, args + [path], tmp_path / "t", device=CPU) == 0
    assert _run(jtexconv, args + [path], tmp_path / "j") == 0
    (got,) = (tmp_path / "t").iterdir()
    want = tmp_path / "j" / got.name
    if not products:
        assert got.read_bytes() == want.read_bytes(), case
        return
    a, b = _payload_f32(got), _payload_f32(want)
    assert a.shape == b.shape and got.stat().st_size == want.stat().st_size
    ulp = np.spacing(np.abs(b))
    assert (np.abs(a - b) <= np.maximum(4 * ulp, 1e-6)).all(), case
    n = int((a.view(np.uint32) != b.view(np.uint32)).sum())
    print(f"{case}: {n} of {a.size} values differ from the JAX tool's")


@pytest.fixture(scope="module")
def frozen():
    return np.load(GOLDEN / "texconv.npz")


def _write_sources(frozen, d: pathlib.Path) -> list:
    d.mkdir(exist_ok=True)
    paths = []
    for name in ("opaque.tga", "alpha.tga"):
        paths.append(d / name)
        paths[-1].write_bytes(frozen[f"src_{name}"].tobytes())
    return [str(p) for p in paths]


CASES = {"bc1": ["-f", "BC1_UNORM", "-m", "0"],
         "bc7": ["-f", "BC7_UNORM", "-m", "0"],
         "bc7_srgb": ["-f", "BC7_UNORM_SRGB", "-srgb", "-m", "3",
                      "-if", "linear"]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bc_targets_match_frozen_jax(case, frozen, tmp_path, monkeypatch):
    """BC1 and BC7 (full mip chains, an image with alpha beside an opaque
    one, sRGB with linear mips) through the batched path: one
    compress_many call, the JAX tool's DDS bytes."""
    ops = importlib.import_module("directxtex_tpu_torch.ops")
    calls = []
    real = ops.compress_many
    monkeypatch.setattr(ops, "compress_many",
                        lambda *a, **k: calls.append(len(a[0])) or real(
                            *a, **k))
    paths = _write_sources(frozen, tmp_path / "src")
    assert _run(texconv, CASES[case] + paths, tmp_path / "out",
                device=CPU) == 0
    assert calls == [2]
    for name in ("opaque.tga", "alpha.tga"):
        got = (tmp_path / "out" / name.replace(".tga", ".dds")).read_bytes()
        assert got == frozen[f"out_{case}_{name}"].tobytes(), (case, name)


def test_batched_equals_serial(frozen, tmp_path, capsys):
    """Two files in one call (one compress_many) give the bytes of each
    file alone, and of the -timing run (serial, with its stage rows)."""
    paths = _write_sources(frozen, tmp_path / "src")
    args = ["-f", "BC7_UNORM", "-m", "0", "-bc", "q"]
    assert _run(texconv, args + paths, tmp_path / "batch", device=CPU) == 0
    for p in paths:
        assert _run(texconv, args + [p], tmp_path / "one", device=CPU) == 0
    assert _run(texconv, args + ["-timing"] + paths, tmp_path / "timed",
                device=CPU) == 0
    out = capsys.readouterr().out
    assert "compress" in out and "save" in out and "ms" in out
    for name in ("opaque.dds", "alpha.dds"):
        want = (tmp_path / "one" / name).read_bytes()
        assert (tmp_path / "batch" / name).read_bytes() == want
        assert (tmp_path / "timed" / name).read_bytes() == want


def test_file_list_lowercase_feature_level_and_missing(sources, tmp_path,
                                                       capsys):
    """-flist (comments and blank lines skipped), -l (lower-case names),
    -px / -sx, -fl (a known level passes, an unknown one fails the file:
    rc 1), a file that is not there (rc 1), -version and the ignored
    options."""
    flist = tmp_path / "list.txt"
    flist.write_text(f"# sources\n\n{sources / 'ldr.tga'}\n")
    args = ["-flist", str(flist), "-l", "-px", "Pre_", "-sx", "_X",
            "-fl", "10.0"]
    assert _run(texconv, args, tmp_path / "o", device=CPU) == 0
    assert [p.name for p in (tmp_path / "o").iterdir()] == ["pre_ldr_x.dds"]
    assert _run(texconv, ["-fl", "8.0", str(sources / "ldr.tga")],
                tmp_path / "o2", device=CPU) == 1
    assert "FAILED" in capsys.readouterr().err
    assert _run(texconv, [str(tmp_path / "missing.tga")], tmp_path / "o3",
                device=CPU) == 1
    assert "no input files" in capsys.readouterr().err
    assert texconv.main(["-version"], device=CPU) == 0
    assert _run(texconv, ["-nogpu", "-singleproc",
                          str(sources / "ldr.tga")], tmp_path / "o4",
                device=CPU) == 0
    assert "ignored" in capsys.readouterr().out
    # an existing output without -y fails the file
    assert texconv.main(["-nologo", "-o", str(tmp_path / "o4"),
                         str(sources / "ldr.tga")], device=CPU) == 1


def test_profile_writes_trace(sources, tmp_path):
    """-profile DIR leaves a non-empty Chrome trace of the run."""
    prof = tmp_path / "prof"
    assert _run(texconv, ["-profile", str(prof), "-f", "BC1_UNORM",
                          str(sources / "ldr.tga")], tmp_path / "o",
                device=CPU) == 0
    trace = prof / "trace.json"
    assert trace.stat().st_size > 0 and b"traceEvents" in trace.read_bytes()
