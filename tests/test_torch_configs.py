"""BASELINE configs 1, 2 and 5 through the PyTorch port on the CPU, held
against the JAX package's outputs frozen in tests/golden/bc12345.npz
(run without FMA contraction, tests/golden/generate_bc12345.py):

- config 1, mipped_compress_pipeline("bc1") at 32^2 with srgb off and on:
  the encoder input (every level's blocks) equals JAX's except where
  sRGB's pow differs by an ulp (blocks counted and printed), the words
  equal JAX's on every block whose input is bit-equal, and PSNR is
  within 0.01 dB; JAX's own encoder input gives JAX's words exactly;
- config 2, run_all.py's step (sRGB -> linear, premultiply, BC3, BC4U,
  BC5U) at 2 x 16^2: the same rule;
- config 5, asset_pipeline on a 2 x 10 x 18 library: the normal maps are
  bit-equal to JAX's and the words equal JAX's per image.

Torch runs on one thread."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc45, bc123
from directxtex_tpu_torch.bc.common import image_to_blocks
from directxtex_tpu_torch.models import pipelines
from directxtex_tpu_torch.ops.colorspace import apply_srgb_to_linear

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
# blocks whose encoder input may differ from JAX's (sRGB pow ulps): at
# most 1 in 8 here
MAX_MOVED_SHARE = 1 / 8
CONFIG2 = {"bc3": (lambda b: bc123.encode_bc3(b, 0), bc123.decode_bc3, 4),
           "bc4": (bc45.encode_bc4u, bc45.decode_bc4u, 1),
           "bc5": (bc45.encode_bc5u, bc45.decode_bc5u, 2)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frozen():
    return np.load(GOLDEN / "bc12345.npz")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _config1_image(size):
    """benchmarks/run_all.py:61-69's content at size^2."""
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, size, dtype=np.float32)
    gx, gy = np.meshgrid(x, x)
    return np.clip(np.stack([gx, gy, gx * gy, np.ones_like(gx)], -1)
                   + rng.normal(0, .02, (size, size, 4)), 0, 1
                   ).astype(np.float32)


def _psnr(dec, src, ch):
    m = float(np.mean((dec[..., :ch].astype(np.float64)
                       - src[..., :ch].astype(np.float64)) ** 2))
    return 10 * np.log10(1.0 / max(m, 1e-30))


def _hold(what, blocks, words, ref_blocks, ref_words, decode, ch):
    """Equal words wherever the encoder input is bit-equal; the other
    blocks counted; PSNR (each encode against its own input) within
    0.01 dB."""
    blocks, words = blocks.numpy(), words.numpy()
    assert words.shape == ref_words.shape and words.dtype == np.uint8
    same_in = np.all((blocks == ref_blocks).reshape(len(blocks), -1),
                     axis=1)
    moved = int((~same_in).sum())
    print(f"{what}: {moved} of {len(blocks)} blocks' encoder input "
          "differs from JAX's")
    assert moved <= MAX_MOVED_SHARE * len(blocks)
    differ = np.any(words != ref_words, axis=1) & same_in
    assert not differ.any(), f"{what}: blocks {np.nonzero(differ)[0]}"
    ours = _psnr(decode(_t(words)).numpy(), blocks, ch)
    theirs = _psnr(decode(_t(ref_words)).numpy(), ref_blocks, ch)
    assert abs(ours - theirs) <= 0.01, (what, ours, theirs)


@pytest.mark.parametrize("srgb", [False, True])
def test_config1_matches_jax(frozen, srgb):
    img = _config1_image(32)
    levels = pipelines.mipped_compress_pipeline(
        "bc1", srgb=srgb, device="cpu")(img)
    blocks, counts = pipelines._mip_chain_blocks(_t(img), 0, srgb)
    # 32^2 ... 1^2: 64 + 16 + 4 + 1 + 1 + 1 blocks
    assert [lv.shape[0] for lv in levels] == counts == [64, 16, 4, 1, 1, 1]
    words = torch.cat(levels)
    key = f"c1_srgb{int(srgb)}"
    _hold(f"config 1 srgb={srgb}", blocks, words, frozen[key + "_blocks"],
          frozen[key + "_words"], bc123.decode_bc1, 3)
    if not srgb:
        np.testing.assert_array_equal(blocks.numpy(),
                                      frozen[key + "_blocks"])
    got = bc123.encode_bc1(_t(frozen[key + "_blocks"]), 0.5, 0)
    np.testing.assert_array_equal(got.numpy(), frozen[key + "_words"])


def _config2_pm(batch):
    """run_all.py:86-112's step before the encoders."""
    lin = apply_srgb_to_linear(batch)
    return torch.cat([lin[..., :3] * lin[..., 3:4], lin[..., 3:4]], dim=-1)


@pytest.mark.parametrize("codec", sorted(CONFIG2))
def test_config2_matches_jax(frozen, codec):
    enc, dec, ch = CONFIG2[codec]
    pm = _config2_pm(_t(frozen["c2_img"]))
    blocks = torch.cat([image_to_blocks(img)[0] for img in pm])
    ref_pm = frozen["c2_pm"]
    ref_blocks = np.concatenate([image_to_blocks(_t(img))[0].numpy()
                                 for img in ref_pm])
    ref_words = frozen[f"c2_{codec}"].reshape(len(ref_blocks), -1)
    _hold(f"config 2 {codec}", blocks, enc(blocks), ref_blocks, ref_words,
          dec, ch)
    np.testing.assert_array_equal(enc(_t(ref_blocks)).numpy(), ref_words)


def test_config5_normal_map_matches_jax(frozen):
    got = pipelines._normal_map(_t(frozen["c5_heights"])).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  frozen["c5_normal"].view(np.uint32))


def test_config5_words_match_jax(frozen):
    words = pipelines.asset_pipeline(device="cpu")(frozen["c5_heights"])
    ref = frozen["c5_words"]
    assert words.dtype == torch.uint8 and tuple(words.shape) == ref.shape
    for i in range(ref.shape[0]):
        np.testing.assert_array_equal(words[i].numpy(), ref[i],
                                      err_msg=f"image {i}")
