"""BC7 decode of the PyTorch port (the plain twin of kernel K1) held
against the frozen golden vectors and the JAX package's decode_bc7."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu_torch.bc import bc67

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def test_decode_golden_vectors_bit_exact():
    v = np.load(GOLDEN / "decode_vectors.npz")
    got = bc67.decode_bc7(torch.from_numpy(v["bc7_blocks"]))
    np.testing.assert_array_equal(got.numpy(), v["bc7_rgba"])


def _mode_blocks(mode, n, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    keep = np.uint8((~((1 << (mode + 1)) - 1)) & 0xFF)
    blocks[:, 0] = (blocks[:, 0] & keep) | np.uint8(1 << mode)
    return blocks


@pytest.mark.parametrize("mode", range(8))
def test_decode_mode_equals_jax(mode):
    blocks = _mode_blocks(mode, 64, 500 + mode)
    got = bc67.decode_bc7(torch.from_numpy(blocks)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbc67.decode_bc7(blocks)))


def test_decode_random_mixed_equals_jax():
    rng = np.random.default_rng(77)
    blocks = rng.integers(0, 256, (256, 16), dtype=np.uint8)
    blocks[::11, 0] = 0                 # reserved mode: transparent black
    got = bc67.decode_bc7(torch.from_numpy(blocks)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbc67.decode_bc7(blocks)))
    assert np.all(got[::11] == 0.0)


def test_decode_words_plain_twin_layout():
    """K1's twin returns [64, NB] texels, row = pixel * 4 + channel."""
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 256, (40, 16), dtype=np.uint8)
    words = torch.from_numpy(blocks).view(torch.int32).t().contiguous()
    texels = bc67.bc7_decode_words(words)
    assert texels.shape == (64, 40) and texels.dtype == torch.int32
    ref = np.asarray(jbc67.decode_bc7(blocks)) * 255.0
    np.testing.assert_array_equal(
        texels.numpy().reshape(16, 4, 40).transpose(2, 0, 1),
        np.rint(ref).astype(np.int32))
