"""The port's copies of the JAX package's jax-free modules, pinned equal:
formats/dxgi.py (every FMT member and value, format_from_name),
formats/traits.py (every predicate and size function over all 127
formats), ops/flags.py (the flag enums), utils/errors.py (the error
classes), texture.py's metadata types, ops/convert.py's CONVF table, and
the compress driver's tables. The copies' code is the JAX package's
(their syntax trees are equal once the module docstrings are set aside).

Also: no module of directxtex_tpu_torch imports jax or directxtex_tpu.
"""

import ast
import dataclasses
import enum
import importlib
import pathlib
import subprocess
import sys

import pytest
import torch

from directxtex_tpu.formats import dxgi as jdxgi
from directxtex_tpu.formats import traits as jtraits
from directxtex_tpu.ops import flags as jflags
from directxtex_tpu.utils import errors as jerrors
from directxtex_tpu_torch.formats import dxgi, traits
from directxtex_tpu_torch.ops import flags
from directxtex_tpu_torch.utils import errors

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "directxtex_tpu_torch"
JAXPKG = ROOT / "directxtex_tpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _code(path: pathlib.Path) -> str:
    tree = ast.parse(path.read_text())
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(
            getattr(body[0], "value", None), ast.Constant):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("rel", ["formats/dxgi.py", "formats/traits.py",
                                 "formats/__init__.py", "ops/flags.py",
                                 "utils/errors.py"])
def test_verbatim_modules_have_the_jax_packages_code(rel):
    assert _code(PORT / rel) == _code(JAXPKG / rel)


def test_every_format_member_and_value():
    ours = {m.name: int(m) for m in dxgi.DXGIFormat}
    theirs = {m.name: int(m) for m in jdxgi.DXGIFormat}
    assert ours == theirs and len(ours) == 127
    assert dxgi.FMT is dxgi.DXGIFormat
    for name in ("BC7_UNORM", "bc7_unorm", "DXGI_FORMAT_R8G8B8A8_UNORM",
                 "r16g16b16a16_float"):
        assert int(dxgi.format_from_name(name)) == int(
            jdxgi.format_from_name(name))
    with pytest.raises((ValueError, KeyError)):
        jdxgi.format_from_name("NOT_A_FORMAT")
    with pytest.raises((ValueError, KeyError)):
        dxgi.format_from_name("NOT_A_FORMAT")


def _norm(v):
    """Enum results by value, so the two packages' enums compare."""
    if isinstance(v, enum.Enum):
        return (type(v).__name__, int(v.value))
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    return v


def _call(fn, *args):
    try:
        return ("ok", _norm(fn(*args)))
    except Exception as e:  # the same formats must raise the same error
        return ("raises", type(e).__name__)


PREDICATES = ["is_valid", "is_compressed", "is_packed", "is_video",
              "is_planar", "is_palettized", "is_depth_stencil", "is_srgb",
              "is_bgr", "is_typeless", "has_alpha", "bits_per_pixel",
              "bits_per_color", "bytes_per_block", "make_srgb",
              "make_linear", "make_typeless", "make_typeless_unorm",
              "make_typeless_float"]


@pytest.mark.parametrize("name", PREDICATES)
def test_trait_over_every_format(name):
    ours, theirs = getattr(traits, name), getattr(jtraits, name)
    for f in dxgi.FMT:
        jf = jdxgi.FMT(int(f))
        assert _call(ours, f) == _call(theirs, jf), (name, f.name)


def test_variant_traits_over_every_format():
    for f in dxgi.FMT:
        jf = jdxgi.FMT(int(f))
        assert _call(traits.is_planar, f, True) == _call(
            jtraits.is_planar, jf, True)
        assert _call(traits.is_typeless, f, False) == _call(
            jtraits.is_typeless, jf, False)
        for h in (1, 3, 4, 17):
            assert _call(traits.compute_scanlines, f, h) == _call(
                jtraits.compute_scanlines, jf, h), f.name
        for dim in (2, 3, 4):
            assert _call(traits.compute_tile_shape, f, dim) == _call(
                jtraits.compute_tile_shape, jf, dim), f.name


def test_compute_pitch_over_every_format_and_flag():
    sizes = [(1, 1), (2, 3), (5, 7), (16, 16), (33, 9)]
    for f in dxgi.FMT:
        jf = jdxgi.FMT(int(f))
        for cp in traits.CP_FLAGS:
            jcp = jtraits.CP_FLAGS(int(cp))
            for w, h in sizes:
                assert _call(traits.compute_pitch, f, w, h, cp) == _call(
                    jtraits.compute_pitch, jf, w, h, jcp), (f.name, cp)


def test_mip_level_counts():
    for w, h, d in [(1, 1, 1), (2048, 2048, 1), (7, 3, 5), (640, 480, 16)]:
        for m in (0, 1, 3, 20):
            assert _call(traits.calculate_mip_levels, w, h, m) == _call(
                jtraits.calculate_mip_levels, w, h, m)
            assert _call(traits.calculate_mip_levels_3d, w, h, d, m) == \
                _call(jtraits.calculate_mip_levels_3d, w, h, d, m)


def _members(cls):
    return {m.name: int(m) for m in cls}


@pytest.mark.parametrize("name", ["TEX_FR_FLAGS", "TEX_FILTER_FLAGS",
                                  "TEX_PMALPHA_FLAGS", "TEX_COMPRESS_FLAGS",
                                  "CNMAP_FLAGS", "CMSE_FLAGS"])
def test_flag_enums(name):
    assert _members(getattr(flags, name)) == _members(getattr(jflags, name))


def test_flag_constants_and_cp_flags():
    for name in ("TEX_FILTER_DITHER_MASK", "TEX_FILTER_MODE_MASK",
                 "TEX_FILTER_SRGB_MASK", "TEX_THRESHOLD_DEFAULT",
                 "TEX_ALPHA_WEIGHT_DEFAULT", "CNMAP_CHANNEL_MASK"):
        assert getattr(flags, name) == getattr(jflags, name)
    assert _members(traits.CP_FLAGS) == _members(jtraits.CP_FLAGS)
    assert traits.TILED_RESOURCE_TILE_SIZE_IN_BYTES == \
        jtraits.TILED_RESOURCE_TILE_SIZE_IN_BYTES


def test_error_classes():
    names = [n for n in dir(jerrors) if n.startswith("Tex")]
    assert sorted(names) == sorted(n for n in dir(errors)
                                   if n.startswith("Tex"))
    for n in names:
        ours, theirs = getattr(errors, n), getattr(jerrors, n)
        assert [b.__name__ for b in ours.__mro__] == \
            [b.__name__ for b in theirs.__mro__]
    assert issubclass(errors.TexAbortError, RuntimeError)


def test_metadata_types_and_driver_tables():
    # by module path: the ops packages export functions named like these
    (jtexture, jcompress, jconvert, jdither, texture, compress, convert,
     dither) = (importlib.import_module(p + m) for p in (
         "directxtex_tpu.", "directxtex_tpu_torch.") for m in (
         "texture", "ops.compress", "ops.convert", "ops.dither"))
    for n in ("TexDimension", "TexAlphaMode", "TexMiscFlag", "TexMiscFlag2"):
        assert _members(getattr(texture, n)) == _members(getattr(jtexture, n))
    assert [f.name for f in dataclasses.fields(texture.TexMetadata)] == \
        [f.name for f in dataclasses.fields(jtexture.TexMetadata)]
    assert _members(convert.CONVF) == _members(jconvert.CONVF)
    for f in dxgi.FMT:
        jf = jdxgi.FMT(int(f))
        assert int(convert.get_convert_flags(f)) == int(
            jconvert.get_convert_flags(jf))
        assert dither.dither_scales(f) == jdither.dither_scales(jf)
        assert _call(compress.default_decompress_format, f) == _call(
            jcompress.default_decompress_format, jf)
    as_int = lambda d: {int(k): v for k, v in d.items()}  # noqa: E731
    # the port's table is format -> kind; the JAX package's also carries
    # the bytes per block, which traits gives the same
    assert as_int(compress._ENCODERS) == {
        k: kind for k, (kind, _bpb) in as_int(jcompress._ENCODERS).items()}
    for k, (_kind, bpb) in jcompress._ENCODERS.items():
        assert traits.bytes_per_block(dxgi.FMT(int(k))) == bpb
    assert as_int(compress._DECODERS) == as_int(jcompress._DECODERS)
    assert {k: int(v) for k, v in compress._CHANNEL_CFLAGS.items()} == \
        {k: int(v) for k, v in jcompress._CHANNEL_CFLAGS.items()}
    for tc in (0, 0x10000, 0x30000, 0x80000, 0x100000, 0x200000, 0x1000000,
               0x2000000, 0x3000000, 0x7FFFFFFF):
        assert compress._bc_flags(compress.TC(tc)) == jcompress._bc_flags(
            jcompress.TC(tc))
        assert int(compress._srgb_flags(compress.TC(tc))) == int(
            jcompress._srgb_flags(jcompress.TC(tc)))


def test_port_imports_no_jax():
    """Every module of the port imports without jax or the JAX package
    (its source names neither), in a fresh interpreter."""
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(PORT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(("directxtex_tpu_torch",) + parts))
    for p in PORT.rglob("*.py"):
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "directxtex_tpu"), (p, n)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'directxtex_tpu')]\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules "
            "if m.startswith('directxtex_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         timeout=120, capture_output=True, text=True,
                         cwd=ROOT)
    assert int(out.stdout.strip()) >= len(mods)
