"""BC6H decode of the PyTorch port (the plain twin of kernel K4) held
against the frozen golden vectors and the JAX package's decode_bc6h:
integer math only, so both are exact."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu_torch.bc import bc6h

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


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
    """Random words cover all 14 mode rows and the reserved headers (black);
    one JAX call per signed."""
    rng = np.random.default_rng(41 + signed)
    blocks = rng.integers(0, 256, (512, 16), dtype=np.uint8)
    blocks[::7, 0] = 0x13                 # reserved header value 0b10011
    got = bc6h.decode_bc6h(torch.from_numpy(blocks), signed).numpy()
    ref = np.asarray(jbc67.decode_bc6h(blocks, signed))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert np.all(got[::7, :, :3] == 0.0)
    rows = bc6h._mode_rows(bc6h._words_i64(
        torch.from_numpy(blocks).view(torch.int32).t().contiguous()))
    assert set(rows.tolist()) == set(range(-1, 14))
