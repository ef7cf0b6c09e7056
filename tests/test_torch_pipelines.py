"""BASELINE config 4 and the BC6H corpus gates through the PyTorch port on
the CPU: hdr_cubemap_pipeline against the JAX package's (the sampled
faces and the words; the JAX pipeline's blocks, words and F16-int pixels
are frozen in tests/golden/jax_refs.npz by
tests/golden/generate_jax_refs.py), the BC6H PSNR floors of
tests/test_golden.py and the frozen reference codec's bc6h_hdr_psnr, and
bc_encode_pipeline's kinds. Torch runs on one thread."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc6h, bc67
from directxtex_tpu_torch.bc.common import image_to_blocks
from directxtex_tpu_torch.models import pipelines
from test_torch_bc6h_search import assert_int_rule


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
# tests/test_golden.py PSNR_FLOORS: log-PSNR (unsigned), peak-linear
# (hdr_signed, encoded signed)
FLOORS = {"hdr": 45.24, "hdr_china": 32.68, "hdr_flower": 31.38,
          "hdr_sun": 51.02, "hdr_signed": 29.75}


@pytest.fixture(scope="module")
def corpus():
    return np.load(GOLDEN / "corpus.npz")


def test_cubemap_matches_jax():
    """Equirect 16x32 (run_all.py's input at a small face): the port's
    faces may differ from JAX's only where an f32 atan2 / asin ulp moves a
    truncated sample index, allowed on at most 1 in 32 texels (none differ
    here); the words follow the F16-int rule of the search tests."""
    eq = (np.random.default_rng(2).random((16, 32, 4)).astype(np.float32)
          * 4.0)
    refs = np.load(GOLDEN / "jax_refs.npz")
    seen = {"blocks": refs["cubemap_blocks"]}
    ref = refs["cubemap_ref"]
    got_faces = pipelines.hdr_cubemap_pipeline(device="cpu")(eq)
    assert len(got_faces) == 6 and all(f.device.type == "cpu"
                                       for f in got_faces)
    got = torch.cat(got_faces).numpy()
    faces = pipelines.cube_faces(torch.from_numpy(eq))
    blocks = torch.cat([image_to_blocks(faces[i])[0] for i in range(6)])
    texel_differ = np.any(blocks.numpy() != seen["blocks"], axis=-1)
    assert texel_differ.mean() <= 1 / 32, texel_differ.mean()
    assert got.shape == ref.shape == (6 * 4, 16)        # 8x8 faces
    px_int = refs["cubemap_px_int"]
    assert_int_rule(got.view(np.uint32), ref.view(np.uint32), px_int, False)


def _log_psnr(a, b):
    """tests/test_golden.py's log-PSNR."""
    a = np.maximum(a[..., :3], 0) + 1e-4
    b = np.maximum(b[..., :3], 0) + 1e-4
    m = float(np.mean((np.log2(a) - np.log2(b)) ** 2))
    return 10 * np.log10(36.0 / max(m, 1e-30))


@pytest.mark.parametrize("content", sorted(FLOORS))
def test_bc6h_corpus_floor(corpus, content):
    signed = content == "hdr_signed"
    blocks, _, _ = image_to_blocks(torch.from_numpy(corpus[content]))
    dec = bc6h.decode_bc6h(bc6h.encode_bc6h(blocks, signed), signed).numpy()
    src = blocks.numpy()
    if signed:
        peak = float(np.abs(src[..., :3]).max())
        m = float(np.mean((dec[..., :3] - src[..., :3]) ** 2))
        psnr = 10 * np.log10(peak * peak / max(m, 1e-30))
        frozen = float(corpus["psnr_bc6hs_hdr_signed"])
    else:
        psnr = _log_psnr(dec, src)
        frozen = float(corpus[f"psnr_bc6h_{content}"])
    assert psnr >= FLOORS[content] and psnr >= frozen - 0.05, psnr


def test_bc6h_reference_parity(corpus):
    """ref_encodes.npz bc6h_hdr_psnr (tests/test_golden.py:314-329)."""
    ref = np.load(GOLDEN / "ref_encodes.npz")
    blocks, _, _ = image_to_blocks(torch.from_numpy(corpus["hdr"]))
    enc = pipelines.bc_encode_pipeline("bc6h", device="cpu")(corpus["hdr"])
    dec = bc6h.decode_bc6h(enc, False)
    peak = float(ref["bc6h_hdr_peak"])
    mse = float(((dec[..., :3] - blocks[..., :3]).double() ** 2).mean())
    assert 10 * np.log10(peak * peak / max(mse, 1e-30)) >= \
        float(ref["bc6h_hdr_psnr"])


def test_bc7_pipeline_is_the_default_encode(corpus):
    img = corpus["albedo"][:16, :16]
    got = pipelines.bc_encode_pipeline("bc7", device="cpu")(img)
    blocks, _, _ = image_to_blocks(torch.from_numpy(img))
    assert torch.equal(got, bc67.encode_bc7(blocks, opaque=True))
