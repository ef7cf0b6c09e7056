"""The whole BC7 default-tier slice of the PyTorch port on the CPU:
encode_bc7(opaque=True) -> decode_bc7 held against the JAX package's
encode on 32x32 crops of the opaque golden-corpus contents (near-tie
rule), the default call (opaque=False) against the JAX default call, and
the golden PSNR floors on the full contents. The JAX encodes are frozen
in tests/golden/jax_refs.npz (tests/golden/generate_jax_refs.py); torch
runs on one thread."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc67
from directxtex_tpu_torch.bc.common import image_to_blocks
from test_torch_bc7_encode import _pixels, assert_near_tie, corpus  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
OPAQUE = ("albedo", "tworegion", "normal", "photo_china", "photo_flower")
# tests/test_golden.py PSNR_FLOORS of the opaque contents (mode 7 is inf
# on opaque blocks, so the opaque=False floors hold for opaque=True)
PSNR_FLOORS = {"albedo": 38.86, "tworegion": 45.22, "normal": 43.21,
               "photo_china": 38.61, "photo_flower": 39.33}


@pytest.fixture(scope="module")
def jax_encodes():
    return np.load(GOLDEN / "jax_refs.npz")


@pytest.mark.parametrize("content", OPAQUE)
def test_encode_slice_matches_jax(corpus, jax_encodes, content):
    """encode_bc7(opaque=True) -> decode_bc7 on a 32x32 crop."""
    blocks, px = _pixels(corpus[content][:32, :32])
    ref = jax_encodes[f"slice_{content}"]
    got = bc67.encode_bc7(torch.from_numpy(blocks), opaque=True).numpy()
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert_near_tie(got.view(np.uint32), ref.view(np.uint32), px)


def test_default_encode_matches_jax_default(corpus, jax_encodes):
    """encode_bc7(blocks) with no opaque argument, both packages: on opaque
    content the JAX package's mode 7 scores inf on every block."""
    blocks, px = _pixels(corpus["albedo"][:32, :32])
    ref = jax_encodes["slice_default"]
    got = bc67.encode_bc7(torch.from_numpy(blocks)).numpy()
    assert_near_tie(got.view(np.uint32), ref.view(np.uint32), px)


@pytest.mark.parametrize("content", OPAQUE)
def test_encode_psnr_floor(corpus, content):
    """The golden corpus floors on the full content (ComputeMSE)."""
    blocks, _, _ = image_to_blocks(torch.from_numpy(corpus[content]))
    dec = bc67.decode_bc7(bc67.encode_bc7(blocks, opaque=True))
    mse = float(((dec - blocks) ** 2).mean())
    psnr = 10 * np.log10(1.0 / max(mse, 1e-30))
    assert psnr >= PSNR_FLOORS[content], (content, psnr)
