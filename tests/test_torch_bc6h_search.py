"""The whole BC6H default search of the PyTorch port (encode_bc6h on the
CPU: the plain twin of kernel K5) held against the JAX package's
encode_bc6h, on the 200-block random / bimodal set of
benchmarks/verify_bc6h_tpu.py and 32x32 crops of the five HDR corpus
contents. Sums in another order can flip near-ties, so the words are
judged by the codec's own F16-int metric under that script's rule. The
JAX references (its words and F16-int pixels, one call per signed) are
frozen in tests/golden/bc6h_search.npz
(tests/golden/generate_bc6h_search.py). Torch runs on one thread."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc6h

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
N_BIMODAL = 40


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _int_err(words_nb4, px_int, signed):
    """Per-block F16-int SSE (INTColor Norm) of u32 words [NB, 4] against
    px_int [16, 3, NB]."""
    words = torch.from_numpy(np.ascontiguousarray(words_nb4, np.uint32)
                             .view(np.int32)).t().contiguous()
    half = bc6h._half_bits_to_f32(bc6h._bc6h_decode_plain(words, signed))
    dec = bc6h._f16_to_int(half, signed).numpy().reshape(16, 3, -1)
    return ((dec - px_int).astype(np.float64) ** 2).sum(axis=(0, 1))


def assert_int_rule(got, ref, px_int, signed, n_degenerate=0):
    """Words differ on at most max(2, nb/25) non-degenerate blocks; there
    the F16-int error is at most 1.02x + 64 of the reference's; in
    aggregate at most 1.005x (verify_bc6h_tpu.py:104-132)."""
    got = np.asarray(got, np.uint32).reshape(-1, 4)
    ref = np.asarray(ref, np.uint32).reshape(-1, 4)
    nb = ref.shape[0]
    differ = np.any(got != ref, axis=1)
    differ[:n_degenerate] = False
    assert differ.sum() <= max(2, nb // 25), f"{differ.sum()}/{nb}"
    eg, er = _int_err(got, px_int, signed), _int_err(ref, px_int, signed)
    assert np.all(eg[differ] <= er[differ] * 1.02 + 64.0)
    assert eg.sum() <= er.sum() * 1.005


def _random_set(signed):
    """benchmarks/verify_bc6h_tpu.py:41-52: 200 random blocks, the first
    40 signed ones sign-crossing bimodal (degenerate for the int metric)."""
    rng = np.random.default_rng(17)
    scale = 4.0 if signed else 8.0
    rgb = rng.random((200, 16, 3)).astype(np.float32) * scale
    if signed:
        rgb -= scale / 2
        rgb[:N_BIMODAL, 8:, :] += scale
        rgb[:N_BIMODAL, :8, :] -= scale
    return np.concatenate([rgb, np.ones((200, 16, 1), np.float32)], -1)


@pytest.fixture(scope="module")
def jax_encodes():
    """The JAX package's encode_bc6h of the batch per signed, frozen:
    (blocks, words [NB, 16] u8, F16-int pixels [16, 3, NB])."""
    g = np.load(GOLDEN / "bc6h_search.npz")
    out = {}
    for signed in (False, True):
        pre = "s_" if signed else "u_"
        blocks = g[pre + "blocks"]
        np.testing.assert_array_equal(blocks[:200], _random_set(signed))
        out[signed] = (blocks, g[pre + "ref"], g[pre + "px_int"])
    return out


@pytest.mark.parametrize("signed", [False, True])
def test_encode_matches_jax(jax_encodes, signed):
    blocks, ref, px_int = jax_encodes[signed]
    got = bc6h.encode_bc6h(torch.from_numpy(blocks), signed).numpy()
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert_int_rule(got.view(np.uint32), ref.view(np.uint32), px_int,
                    signed, N_BIMODAL if signed else 0)
