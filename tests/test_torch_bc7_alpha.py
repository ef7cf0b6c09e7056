"""The BC7 alpha path and QUICK tier of the PyTorch port (the plain twins
of kernels K2 and K3) held against the JAX package's jnp path on the same
pixels made with numpy: the mode-7 family, the whole search fold with
mode 7, the MOMENT refine over (1, 3, 5, 7, 4), alpha_weight 2.0 on both,
QUICK, and the default encode_bc7 on a crop with alpha; then the golden
gates on the full contents (the alphagrad floor and the frozen reference
parity of the four BC7 contents).

Searches are compared under the near-tie rule of test_torch_bc7_encode
(the port sums its shape estimates in index order, the JAX package with
an einsum); the refine and QUICK are exact and compared word for word.
Each JAX reference is computed once per module, one batched call per
setting, all on one batch: the JAX package runs eagerly on the CPU, and a
new batch size would trace its operations anew. The file keeps torch on
one thread: the tier-1 command runs six workers on the machine's cores
beside the JAX package's long files, and these small tensors gain
nothing from more."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu_torch.bc import bc67
from directxtex_tpu_torch.bc.common import image_to_blocks
from test_torch_bc7_encode import corpus  # noqa: F401
from test_torch_bc7_encode import _pixels, _words_u32, assert_near_tie

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
AWS = (1.0, 2.0)
# tests/test_golden.py: the alphagrad floor and the frozen reference
# parity margins of the BC7 contents
ALPHAGRAD_FLOOR = 37.17
REF_PARITY_MARGINS = {"albedo": 0.04, "tworegion": 0.28, "normal": 2.65,
                      "alphagrad": 0.32}


def _mixed_blocks(nb=200, seed=11):
    """Random RGBA blocks, the first half opaque (tests/test_pallas.py:310)."""
    rng = np.random.default_rng(seed)
    blocks = rng.random((nb, 16, 4)).astype(np.float32)
    blocks[:nb // 2, :, 3] = 1.0
    return blocks


def _px(blocks):
    return np.clip(np.transpose(blocks, (1, 2, 0)) * np.float32(255.0)
                   + np.float32(0.01), 0, 255).astype(np.int32)


def _encode_recording(blocks, aw):
    """The JAX package's default encode_bc7, recording the words its
    search and cross-mode fold hand to its winner-refine. Returns (search
    words [NB, 4] u32, the refine's modes, encoded [NB, 16] u8)."""
    seen = []
    orig = jbc67.refine_bc7_words

    def record(px_i, words, ladder, **kw):
        seen.append((np.asarray(words), kw.get("modes")))
        return orig(px_i, words, ladder, **kw)

    jbc67.refine_bc7_words = record
    try:
        out = np.asarray(jbc67.encode_bc7(jnp.asarray(blocks),
                                          alpha_weight=aw))
    finally:
        jbc67.refine_bc7_words = orig
    (search, modes), = seen
    return search, modes, out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def alpha_set(corpus):
    """The 200 mixed blocks and 32x32 crops of alphagrad and albedo (64
    blocks each): blocks [NB, 16, 4], px [16, 4, NB] i32 and the JAX
    references."""
    crops = [_pixels(corpus["alphagrad"][16:48, 16:48])[0],
             _pixels(corpus["albedo"][:32, :32])[0]]
    blocks = np.concatenate([_mixed_blocks()] + crops)
    px = _px(blocks)
    pj = jnp.asarray(px)
    pjf = pj.astype(jnp.float32)
    ests = jbc67._shape_estimates_table(pjf, 1, 4, off_axis=True)
    err7, words7 = jbc67._try_partition_mode(pj, pjf, 7, ests=ests)
    ref = {"blocks": blocks, "px": px,
           "mode7": (np.asarray(err7), np.asarray(words7)),
           "quick": np.asarray(jbc67.encode_bc7(jnp.asarray(blocks),
                                                flags=0x100000))}
    for aw in AWS:
        search, modes, out = _encode_recording(blocks, aw)
        assert modes == bc67.REFINE_MODES_ALPHA
        ref[aw] = {"search": search, "encoded": out,
                   "refine": out.view(np.uint32).reshape(-1, 4)}
    return ref


def _modes_of(words_nb4):
    return bc67._mode_of(bc67._words_i64(torch.from_numpy(
        np.ascontiguousarray(words_nb4.T).view(np.int32)))).numpy()


def test_mode7_family_matches_jax(alpha_set):
    px = alpha_set["px"]
    pt = torch.from_numpy(px)
    ptf = pt.to(torch.float32)
    err, words = bc67._try_partition_mode(pt, ptf, 7,
                                         bc67._shape_estimates_table(ptf))
    ref_err, ref_words = alpha_set["mode7"]
    assert_near_tie(_words_u32(words), ref_words, px)
    same = np.all(_words_u32(words) == ref_words, axis=1)
    np.testing.assert_array_equal(err.numpy()[same], ref_err[same])


@pytest.mark.parametrize("aw", AWS)
def test_alpha_search_matches_jax(alpha_set, aw):
    px = alpha_set["px"]
    nb = px.shape[2]
    err, words = bc67.bc7_search_words(
        torch.from_numpy(px).reshape(64, nb).contiguous(),
        bc67.SEARCH_MODES_ALPHA, aw)
    got = _words_u32(words)
    assert_near_tie(got, alpha_set[aw]["search"], px)
    # mode 7 wins somewhere, and never on an opaque block (inf there)
    opaque = np.all(px[:, 3, :] == 255, axis=0)
    modes = _modes_of(got)
    assert np.any(modes == 7) and not np.any(modes[opaque] == 7)
    assert bool(torch.isfinite(err).all())


@pytest.mark.parametrize("aw", AWS)
def test_alpha_refine_equals_jax(alpha_set, aw):
    """MOMENT over (1, 3, 5, 7, 4) from the JAX search's words, against
    the JAX refine inside its encode_bc7: exact."""
    px = alpha_set["px"]
    search = alpha_set[aw]["search"]
    words = torch.from_numpy(search.view(np.int32).copy())
    got = bc67.refine_bc7_words(torch.from_numpy(px), words,
                                bc67.LADDER_MOMENT, aw=aw,
                                modes=bc67.REFINE_MODES_ALPHA)
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, alpha_set[aw]["refine"])
    modes = _modes_of(search)
    moved = np.any(got != search, axis=1)
    assert np.any(moved & (modes == 7))
    if aw != 1.0:
        # the weight rides a rotated alpha channel: mode 4/5 winners with
        # a rotation, some of which the refine moves
        rot = np.where(modes == 4, (search[:, 0] >> 5) & 3,
                       (search[:, 0] >> 6) & 3)
        rotated = np.isin(modes, (4, 5)) & (rot != 0)
        assert np.any(rotated & moved)


def test_quick_equals_jax(alpha_set):
    """encode_bc7(flags=QUICK) on the batch, crops of albedo and
    alphagrad included: equal words, all mode 6."""
    got = bc67.encode_bc7(torch.from_numpy(alpha_set["blocks"]),
                          flags=0x100000).numpy()
    np.testing.assert_array_equal(got, alpha_set["quick"])
    assert np.all(_modes_of(got.view(np.uint32).reshape(-1, 4)) == 6)


def test_default_encode_matches_jax_default_with_alpha(alpha_set):
    """encode_bc7(blocks) with no opaque argument, both packages, on the
    batch (the alphagrad crop included): mode 7 searched, the refine over
    (1, 3, 5, 7, 4)."""
    got = bc67.encode_bc7(torch.from_numpy(alpha_set["blocks"])).numpy()
    ref = alpha_set[1.0]["encoded"]
    assert_near_tie(got.view(np.uint32), ref.view(np.uint32),
                    alpha_set["px"])
    crop = slice(200, 264)
    assert np.any(_modes_of(got[crop].view(np.uint32).reshape(-1, 4)) == 7)


def test_variants_agree_on_opaque_blocks(corpus):
    """On opaque blocks the alpha variant's words equal the opaque
    variant's at either weight (mode 7 is inf there)."""
    blocks, px = _pixels(corpus["albedo"][:32, :32])
    pt = torch.from_numpy(px).reshape(64, -1).contiguous()
    for aw in AWS:
        err_o, w_o = bc67._bc7_search_plain(pt, bc67.SEARCH_MODES, aw)
        err_a, w_a = bc67._bc7_search_plain(pt, bc67.SEARCH_MODES_ALPHA, aw)
        assert torch.equal(w_o, w_a) and torch.equal(err_o, err_a)


@pytest.mark.parametrize("name", ["_BC7_QUICK", "_BC7_USE_3SUBSETS",
                                  "_BC7_MAXQUALITY"])
def test_flags_equal(name):
    assert bc67.tables_as_numpy()[name] == getattr(jbc67, name)


@pytest.fixture(scope="module")
def golden_psnr(corpus):
    """encode_bc7 -> decode_bc7 PSNR (ComputeMSE over RGBA) of the full
    BC7 contents, default call (opaque=False)."""
    out = {}
    for content in REF_PARITY_MARGINS:
        blocks, _, _ = image_to_blocks(torch.from_numpy(corpus[content]))
        dec = bc67.decode_bc7(bc67.encode_bc7(blocks))
        mse = float(((dec - blocks) ** 2).mean())
        out[content] = 10 * np.log10(1.0 / max(mse, 1e-30))
    return out


def test_alphagrad_psnr_floor(golden_psnr):
    assert golden_psnr["alphagrad"] >= ALPHAGRAD_FLOOR, golden_psnr


@pytest.mark.parametrize("content", sorted(REF_PARITY_MARGINS))
def test_frozen_reference_parity(golden_psnr, content):
    ref = float(np.load(GOLDEN / "ref_encodes.npz")[f"bc7_{content}_psnr"])
    want = ref + REF_PARITY_MARGINS[content]
    assert golden_psnr[content] >= want, (content, golden_psnr[content],
                                          want)
