"""BC1-BC5 and OptimizeAlpha through the PyTorch port on the CPU.

- Decode: every bc1-bc5 entry of tests/golden/decode_vectors.npz bit for
  bit, BC4/BC5 signed and unsigned (tests/test_golden.py:45-78).
- Encode: encode_bc1 (flags 0, DITHER_RGB, UNIFORM and both), encode_bc2
  and encode_bc3 (with and without DITHER_A, and with DITHER_RGB too) and
  BC4/BC5 signed and unsigned give the JAX package's words on every block
  of tests/golden/bc12345.npz's 1,280 (config 1's content, colour-keyed,
  flat, two-colour, boundary and ramp blocks, corpus crops), and
  optimize_alpha_t its endpoints bit for bit at 6 and 8 steps. The JAX
  outputs are frozen under XLA_FLAGS=--xla_cpu_max_isa=AVX by
  tests/golden/generate_bc12345.py: XLA contracts `a*b + c` into an FMA
  inside a compiled loop body, torch's eager ops never do.
- Quality: the bc1-bc5 corpus floors of tests/test_golden.py and the
  frozen reference codec's PSNRs with its REF_PARITY_MARGINS.

Torch runs on one thread."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc45, bc123, common
from directxtex_tpu_torch.bc.common import image_to_blocks
from test_golden import PSNR_FLOORS, REF_PARITY_MARGINS

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
BC1_FLAGS = (0x0, 0x10000, 0x40000, 0x50000)
BC23_FLAGS = (0x0, 0x20000, 0x30000)
# codec -> (encode, decode, channels scored), as tests/test_golden.py
CODECS = {
    "bc1": (lambda b: bc123.encode_bc1(b, 0.5, 0), bc123.decode_bc1, 3),
    "bc2": (lambda b: bc123.encode_bc2(b, 0), bc123.decode_bc2, 4),
    "bc3": (lambda b: bc123.encode_bc3(b, 0), bc123.decode_bc3, 4),
    "bc4": (bc45.encode_bc4u, bc45.decode_bc4u, 1),
    "bc5": (bc45.encode_bc5u, bc45.decode_bc5u, 2),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frozen():
    return np.load(GOLDEN / "bc12345.npz")


@pytest.fixture(scope="module")
def vectors():
    return np.load(GOLDEN / "decode_vectors.npz")


@pytest.fixture(scope="module")
def corpus():
    return np.load(GOLDEN / "corpus.npz")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("codec", ["bc1", "bc2", "bc3"])
def test_decode_bc123_golden(vectors, codec):
    dec = getattr(bc123, f"decode_{codec}")(_t(vectors[f"{codec}_blocks"]))
    assert dec.dtype == torch.float32
    np.testing.assert_array_equal(dec.numpy(), vectors[f"{codec}_rgba"])


def test_decode_bc4_golden(vectors):
    blocks = _t(vectors["bc4_blocks"])
    u, s = bc45.decode_bc4u(blocks).numpy(), bc45.decode_bc4s(blocks).numpy()
    np.testing.assert_array_equal(u[..., 0], vectors["bc4u_r"])
    np.testing.assert_array_equal(s[..., 0], vectors["bc4s_r"])
    for d in (u, s):
        assert np.all(d[..., 1:3] == 0) and np.all(d[..., 3] == 1)


def test_decode_bc5_golden(vectors):
    blocks = _t(vectors["bc5_blocks"])
    u, s = bc45.decode_bc5u(blocks).numpy(), bc45.decode_bc5s(blocks).numpy()
    np.testing.assert_array_equal(u[..., 0], vectors["bc5u_r"])
    np.testing.assert_array_equal(u[..., 1], vectors["bc5u_g"])
    np.testing.assert_array_equal(s[..., 0], vectors["bc5s_r"])
    np.testing.assert_array_equal(s[..., 1], vectors["bc5s_g"])


def _assert_words(got: torch.Tensor, want: np.ndarray, what: str):
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    differ = np.nonzero(np.any(got.numpy() != want, axis=1))[0]
    assert differ.size == 0, f"{what}: blocks {differ[:20]} differ"


@pytest.mark.parametrize("flags", BC1_FLAGS)
def test_encode_bc1_words_match_jax(frozen, flags):
    got = bc123.encode_bc1(_t(frozen["blocks"]), 0.5, flags)
    _assert_words(got, frozen[f"bc1_{flags:#x}"], f"bc1 {flags:#x}")


@pytest.mark.parametrize("flags", BC23_FLAGS)
@pytest.mark.parametrize("codec", ["bc2", "bc3"])
def test_encode_bc23_words_match_jax(frozen, codec, flags):
    got = getattr(bc123, f"encode_{codec}")(_t(frozen["blocks"]), flags)
    _assert_words(got, frozen[f"{codec}_{flags:#x}"], f"{codec} {flags:#x}")


@pytest.mark.parametrize("name", ["bc4u", "bc4s", "bc5u", "bc5s"])
def test_encode_bc45_words_match_jax(frozen, name):
    blocks = frozen["blocks"]
    if name.endswith("s"):
        blocks = blocks * np.float32(2) - np.float32(1)
    got = getattr(bc45, f"encode_{name}")(_t(blocks))
    _assert_words(got, frozen[name], name)


def _planes(frozen, signed):
    blocks = frozen["blocks"]
    planes = np.concatenate([blocks[..., 0], blocks[..., 3]]).T
    return planes * np.float32(2) - np.float32(1) if signed else planes


@pytest.mark.parametrize("steps", [6, 8])
@pytest.mark.parametrize("signed", [False, True])
def test_optimize_alpha_endpoints_match_jax(frozen, signed, steps):
    x, y = common.optimize_alpha_t(_t(_planes(frozen, signed)), steps,
                                   signed)
    key = f"oa_{'s' if signed else 'u'}{steps}"
    np.testing.assert_array_equal(x.numpy().view(np.uint32),
                                  frozen[key + "_x"].view(np.uint32))
    np.testing.assert_array_equal(y.numpy().view(np.uint32),
                                  frozen[key + "_y"].view(np.uint32))


def test_optimize_alpha_takes_block_rows(frozen):
    planes = _planes(frozen, False)
    x, y = common.optimize_alpha(_t(planes.T), 8, False)
    want = common.optimize_alpha_t(_t(planes), 8, False)
    assert torch.equal(x, want[0]) and torch.equal(y, want[1])


def _psnr(a, b, ch):
    """tests/test_golden.py's PSNR over the first ch channels."""
    m = float(np.mean((np.asarray(a)[..., :ch] - np.asarray(b)[..., :ch])
                      ** 2))
    return 10 * np.log10(1.0 / max(m, 1e-30))


def _roundtrip(corpus, name):
    codec, content = name.split("_", 1)
    enc, dec, ch = CODECS[codec]
    blocks, _, _ = image_to_blocks(_t(corpus[content]))
    return _psnr(dec(enc(blocks)).numpy(), blocks.numpy(), ch)


@pytest.mark.parametrize("name", sorted(n for n in PSNR_FLOORS
                                        if n.split("_")[0] in CODECS))
def test_corpus_floor(corpus, name):
    got = _roundtrip(corpus, name)
    assert got >= PSNR_FLOORS[name], (name, got)
    assert got >= float(corpus[f"psnr_{name}"]) - 0.05, (name, got)


@pytest.mark.parametrize("name", sorted(n for n in REF_PARITY_MARGINS
                                        if n.split("_")[0] in CODECS))
def test_reference_parity(corpus, name):
    ref = np.load(GOLDEN / "ref_encodes.npz")
    got = _roundtrip(corpus, name)
    assert got >= float(ref[f"{name}_psnr"]) + REF_PARITY_MARGINS[name], \
        (name, got)
