"""The BC7 MAXQUALITY tier of the PyTorch port (the plain twins of
kernels K2 and K3) held against the JAX package's jnp path on the same
pixels made with numpy: the maxq search (every mode fitted on its own,
mode 4 over both index modes), the modes-4/5 family, the MOMENT refine
with mode 6 in scope, the exact LADDER_FULL and LADDER_LIGHT ladders at
alpha weight 2.0, the whole maxq encode with and without alpha,
QUICK|MAXQUALITY, and the pipeline's maxq kind.

The search is compared under the near-tie rule of test_torch_bc7_encode
(the port sums its shape estimates in index order, the JAX package with
an einsum); the refines and the modes-4/5 family are exact and compared
word for word. The JAX references are computed once per module, on one
batch (200 random blocks, half opaque, and 32x32 crops of alphagrad and
albedo): one maxq encode_bc7 records what its search hands to each of
its two refines and what its modes-4/5 family gives, then the exact
ladders run once each. The JAX package runs eagerly on the CPU, and a new
batch size would trace its operations anew. Torch runs on one thread."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu_torch.bc import bc67, cuda_kernels
from directxtex_tpu_torch.models import pipelines
from test_torch_bc7_alpha import _mixed_blocks, _modes_of, _px
from test_torch_bc7_encode import corpus  # noqa: F401
from test_torch_bc7_encode import _pixels, _words_u32, assert_near_tie

MAXQ = 0x200000
QUICK = 0x100000
SCOPE = (1, 3, 5, 6, 7, 4)          # the maxq refine scope with alpha
ALBEDO = slice(264, 328)            # the opaque crop's blocks in the batch


def _encode_recording(blocks, flags):
    """The JAX package's encode_bc7, recording what its search hands to
    each refine (words [NB, 4] u32, ladder, modes) and its modes-4/5
    family's (err, words) by mode. Returns (refine inputs, family,
    encoded [NB, 16] u8)."""
    seen, family = [], {}
    orig_refine, orig_single = jbc67.refine_bc7_words, jbc67._try_single_mode

    def record(px_i, words, ladder, **kw):
        seen.append((np.asarray(words), ladder, kw.get("modes")))
        return orig_refine(px_i, words, ladder, **kw)

    def single(px_i, px_f, mode_id, **kw):
        out = orig_single(px_i, px_f, mode_id, **kw)
        family[mode_id] = tuple(np.asarray(o) for o in out)
        return out

    jbc67.refine_bc7_words, jbc67._try_single_mode = record, single
    try:
        out = np.asarray(jbc67.encode_bc7(jnp.asarray(blocks), flags=flags))
    finally:
        jbc67.refine_bc7_words = orig_refine
        jbc67._try_single_mode = orig_single
    return seen, family, out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def maxq_set(corpus):
    """The batch (blocks [NB, 16, 4], px [16, 4, NB] i32) and the JAX
    references."""
    crops = [_pixels(corpus["alphagrad"][16:48, 16:48])[0],
             _pixels(corpus["albedo"][:32, :32])[0]]
    blocks = np.concatenate([_mixed_blocks()] + crops)
    px = _px(blocks)
    seen, family, out = _encode_recording(blocks, MAXQ)
    (search, lad0, modes0), (moment, lad1, modes1) = seen
    assert (lad0, lad1) == (jbc67.LADDER_MOMENT, jbc67.LADDER_FULL)
    assert modes0 == modes1 == SCOPE
    ref = {"blocks": blocks, "px": px, "search": search, "moment": moment,
           "encoded": out, "family": family}
    words = jnp.asarray(search)
    for name, ladder in (("full", jbc67.LADDER_FULL),
                         ("light", jbc67.LADDER_LIGHT)):
        ref[name] = np.asarray(jbc67.refine_bc7_words(
            jnp.asarray(px), words, ladder, aw=2.0, modes=SCOPE))
    seen_q, _, ref["quick_maxq"] = _encode_recording(blocks, QUICK | MAXQ)
    assert [(s[1], s[2]) for s in seen_q] == [
        (jbc67.LADDER_MOMENT, (6,)), (jbc67.LADDER_FULL, (6,))]
    return ref


def _nb4(words_u32):
    return torch.from_numpy(np.array(words_u32, np.uint32).view(np.int32))


@pytest.mark.parametrize("name", ["LADDER_FULL", "LADDER_LIGHT"])
def test_ladders_equal(name):
    assert bc67.tables_as_numpy()[name] == getattr(jbc67, name)


def test_maxq_mode4_index_modes_equal():
    # encode_bc7's maxq m4_ims (bc67.py:1953)
    assert bc67._MODE4_IMS_MAXQ == (0, 1)


def test_maxq_search_matches_jax(maxq_set):
    px = maxq_set["px"]
    nb = px.shape[2]
    err, words = bc67.bc7_search_words(
        torch.from_numpy(px).reshape(64, nb).contiguous(),
        bc67.SEARCH_MODES_ALPHA, 1.0, bc67.TIER_MAXQ)
    got = _words_u32(words)
    assert_near_tie(got, maxq_set["search"], px)
    assert bool(torch.isfinite(err).all())
    # every searched mode wins somewhere in the batch
    assert set(_modes_of(got)) >= {1, 3, 4, 5, 7}


@pytest.mark.parametrize("mode", [4, 5])
def test_mode45_family_equals_jax(maxq_set, mode):
    """Mode 4 over rotations x index modes (0, 1) and mode 5 over
    rotations, each candidate fitted on its own: word for word, errors
    bit for bit."""
    pt = torch.from_numpy(maxq_set["px"])
    err, words = bc67._try_single_mode45(pt, pt.to(torch.float32), mode)
    ref_err, ref_words = maxq_set["family"][mode]
    np.testing.assert_array_equal(_words_u32(words), ref_words)
    np.testing.assert_array_equal(err.numpy(), ref_err)
    if mode == 4:
        im = (ref_words[:, 0] >> 7) & 1
        assert np.any(im == 0) and np.any(im == 1)


def test_tiers_differ_on_one_tuple(maxq_set):
    """The default tier's alpha tuple is the maxq tier's: the tier, an
    explicit argument, picks the search and K2's variant. With mode 7 each
    tier runs its own (1, 3, 5, 6, 4) variant, then mode 7's launches, so
    no variant of its own serves the alpha tuple."""
    px = torch.from_numpy(maxq_set["px"][..., :64]).reshape(64, 64)
    px = px.contiguous()
    _, w_d = bc67.bc7_search_words(px, bc67.SEARCH_MODES_ALPHA)
    _, w_m = bc67.bc7_search_words(px, bc67.SEARCH_MODES_ALPHA, 1.0,
                                   bc67.TIER_MAXQ)
    assert not torch.equal(w_d, w_m)
    variants = cuda_kernels._BC7_ENCODE_VARIANTS
    assert variants[bc67.TIER_DEFAULT, bc67.SEARCH_MODES] == "bc7_encode"
    assert variants[bc67.TIER_MAXQ, bc67.SEARCH_MODES] == "bc7_encode_maxq"
    for tier in (bc67.TIER_DEFAULT, bc67.TIER_MAXQ):
        assert (tier, bc67.SEARCH_MODES_ALPHA) not in variants


def test_moment_refine_with_mode6_equals_jax(maxq_set):
    """The maxq tier's first refine (MOMENT over 1, 3, 5, 6, 7, 4) from
    the JAX search's words, against the JAX refine inside its maxq
    encode: exact."""
    got = bc67.refine_bc7_words(torch.from_numpy(maxq_set["px"]),
                                _nb4(maxq_set["search"]),
                                bc67.LADDER_MOMENT, modes=SCOPE)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  maxq_set["moment"])


def test_full_refine_equals_jax(maxq_set):
    """The maxq tier's second refine (LADDER_FULL) from the JAX MOMENT
    refine's words: the JAX maxq encode's words, exact."""
    got = bc67.refine_bc7_words(torch.from_numpy(maxq_set["px"]),
                                _nb4(maxq_set["moment"]),
                                bc67.LADDER_FULL, modes=SCOPE)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        maxq_set["encoded"].view(np.uint32).reshape(-1, 4))


@pytest.mark.parametrize("name", ["full", "light"])
def test_exact_ladder_at_weight_two_equals_jax(maxq_set, name):
    ladder = {"full": bc67.LADDER_FULL, "light": bc67.LADDER_LIGHT}[name]
    search = maxq_set["search"]
    got = bc67.refine_bc7_words(torch.from_numpy(maxq_set["px"]),
                                _nb4(search), ladder, aw=2.0, modes=SCOPE)
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, maxq_set[name])
    moved = np.any(got != search, axis=1)
    modes = _modes_of(search)
    for mode in (1, 3, 4, 5, 7):
        assert np.any(moved & (modes == mode)), mode


def test_quick_maxq_equals_jax(maxq_set):
    """QUICK|MAXQUALITY: mode 6 alone, refined by MOMENT then FULL on
    mode 6, the refine of mode 6 on every block: exact."""
    got = bc67.encode_bc7(torch.from_numpy(maxq_set["blocks"]),
                          flags=QUICK | MAXQ).numpy()
    np.testing.assert_array_equal(got, maxq_set["quick_maxq"])
    words = got.view(np.uint32).reshape(-1, 4)
    assert np.all(_modes_of(words) == 6)
    _, quick = bc67.bc7_search_words(
        torch.from_numpy(maxq_set["px"]).reshape(64, -1).contiguous(),
        bc67.SEARCH_MODES_QUICK, 1.0, bc67.TIER_MAXQ)
    assert np.mean(np.any(words != _words_u32(quick), axis=1)) > 0.5


def test_maxq_encode_equals_jax(maxq_set):
    """encode_bc7(flags=MAXQUALITY) on the batch (blocks with alpha: mode 7
    searched and in the refine scope) and on the opaque albedo crop alone
    (mode 7 dropped by the host check): the JAX package's words."""
    got = bc67.encode_bc7(torch.from_numpy(maxq_set["blocks"]),
                          flags=MAXQ).numpy()
    np.testing.assert_array_equal(got, maxq_set["encoded"])
    opaque = bc67.encode_bc7(torch.from_numpy(maxq_set["blocks"][ALBEDO]),
                             flags=MAXQ).numpy()
    np.testing.assert_array_equal(opaque, maxq_set["encoded"][ALBEDO])


def test_maxq_pipeline_equals_encode(maxq_set, corpus):
    img = np.ascontiguousarray(corpus["alphagrad"][16:48, 16:48])
    got = pipelines.bc_encode_pipeline("bc7", MAXQ, device="cpu")(img)
    blocks = maxq_set["blocks"][200:264]
    assert torch.equal(got, bc67.encode_bc7(torch.from_numpy(blocks),
                                            flags=MAXQ))
    np.testing.assert_array_equal(got.numpy(), maxq_set["encoded"][200:264])


def test_maxq_psnr_not_below_default(maxq_set):
    """tests/test_bc7.py:200-214's rule on the batch: maxq loses no more
    than 0.001 dB to the default tier."""
    blocks = torch.from_numpy(maxq_set["blocks"])

    def psnr(enc):
        dec = bc67.decode_bc7(torch.from_numpy(np.array(enc)))
        mse = float(((dec.double() - blocks.double()) ** 2).mean())
        return 10 * np.log10(1.0 / mse)

    base = psnr(bc67.encode_bc7(blocks).numpy())
    assert psnr(maxq_set["encoded"]) >= base - 1e-3
