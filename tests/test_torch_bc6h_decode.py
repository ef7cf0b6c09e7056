"""BC6H decode of the PyTorch port (the plain twin of kernel K4) held
against the frozen golden vectors and the JAX package's decode_bc6h,
frozen in tests/golden/decode_refs.npz (generate_decode_refs.py):
integer math only, so both are exact."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc6h


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _mixed_blocks(signed):
    """Random words covering all 14 mode rows and, every 7th block, the
    reserved header value 0b10011."""
    rng = np.random.default_rng(41 + signed)
    blocks = rng.integers(0, 256, (512, 16), dtype=np.uint8)
    blocks[::7, 0] = 0x13
    return blocks


@pytest.mark.parametrize("signed,key", [(False, "bc6h_uf_bits"),
                                        (True, "bc6h_sf_bits")])
def test_decode_golden_vectors_bit_exact(signed, key):
    v = np.load(GOLDEN / "decode_vectors.npz")
    blocks = torch.from_numpy(v["bc6h_blocks"])
    # K4's twin: [48, NB] half bits, row = pixel * 3 + channel
    words = blocks.view(torch.int32).t().contiguous()
    bits = bc6h.bc6h_decode_words(words, signed).numpy()
    ref = v[key].astype(np.int32)                       # [NB, 16, 4]
    np.testing.assert_array_equal(
        bits.reshape(16, 3, -1).transpose(2, 0, 1), ref[..., :3])
    # decode_bc6h: the same halves as f32, alpha 1
    got = bc6h.decode_bc6h(blocks, signed).numpy()
    np.testing.assert_array_equal(
        got[..., :3].astype(np.float16).view(np.uint16), v[key][..., :3])
    assert np.all(got[..., 3] == 1.0)


@pytest.mark.parametrize("signed", [False, True])
def test_decode_random_mixed_equals_jax(signed):
    """Random words cover all 14 mode rows and the reserved headers
    (black)."""
    blocks = _mixed_blocks(signed)
    got = bc6h.decode_bc6h(torch.from_numpy(blocks), signed).numpy()
    ref = np.load(GOLDEN / "decode_refs.npz")[
        "bc6h_mixed_s" if signed else "bc6h_mixed_u"]
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert np.all(got[::7, :, :3] == 0.0)
    rows = bc6h._mode_rows(bc6h._words_i64(
        torch.from_numpy(blocks).view(torch.int32).t().contiguous()))
    assert set(rows.tolist()) == set(range(-1, 14))
