"""Mode 7 split out of K2's search, in plain form: the (1, 3, 5, 6, 4)
search of a tier (K2's default team kernel or maxq variant, which also
write the shapes they ranked), then mode 7 on those four shapes over the
blocks with alpha (bc7_alpha_list's and bc7_mode7's twins), folded in by
the take7 rule: mode 7 takes a block where its error is below the
search's, or equal to it where the search's winner is mode 4 (mode 4 comes
after 7 in the fold order (1, 3, 5, 6, 7, 4)).

The rule is held against a strict `<` fold over (1, 3, 5, 6, 7, 4) under
hypothesis-drawn errors from a small set, so that 7, 4 and the modes
before them tie often; the split form against the port's one-fold twin
_bc7_search_plain(SEARCH_MODES_ALPHA), word for word and error for error,
at both tiers and alpha weights 1.0 and 2.0, on the 328-block set of the
alpha tests (200 random RGBA blocks, half opaque, and 32x32 crops of
alphagrad and albedo), whose one-fold search test_torch_bc7_alpha.py and
test_torch_bc7_maxq.py hold to the JAX package. Torch runs on one
thread."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from directxtex_tpu_torch.bc import bc67
from directxtex_tpu_torch.bc.common import image_to_blocks

ORDER = (1, 3, 5, 6, 7, 4)
AWS = (1.0, 2.0)
TIERS = (bc67.TIER_DEFAULT, bc67.TIER_MAXQ)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mode_words(modes):
    """Words [4, N] int32 whose BC7 mode is modes[n] (the mode bit only)."""
    w = torch.zeros((4, len(modes)), dtype=torch.int32)
    w[0] = torch.tensor([1 << m for m in modes], dtype=torch.int32)
    return w


def _strict_fold(errs, order):
    """The search's fold: per case, the first mode of least error in
    `order` (a strict `<` from inf). errs: {mode: [N] f32}."""
    n = len(next(iter(errs.values())))
    best = torch.full((n,), float("inf"))
    win = torch.full((n,), -1)
    for m in order:
        better = errs[m] < best
        best = torch.where(better, errs[m], best)
        win = torch.where(better, m, win)
    return best, win


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(st.lists(st.lists(st.sampled_from([0.0, 1.0, 2.0, 3.0, 5.0]),
                         min_size=6, max_size=6), min_size=32, max_size=32))
def test_take7_equals_the_strict_fold(cases):
    """Drawn errors of modes (1, 3, 5, 6, 7, 4), five values so that ties
    between 7, 4 and the prefix are common: the search's fold without 7,
    then take7, gives the strict fold over the whole order."""
    errs = {m: torch.tensor([c[k] for c in cases], dtype=torch.float32)
            for k, m in enumerate(ORDER)}
    want_err, want = _strict_fold(errs, ORDER)
    err_f, win_f = _strict_fold(errs, (1, 3, 5, 6, 4))
    take = bc67._take7(err_f, _mode_words(win_f.tolist()), errs[7])
    got = torch.where(take, 7, win_f)
    assert torch.equal(got, want)
    assert torch.equal(torch.where(take, errs[7], err_f), want_err)


def test_take7_ties_in_both_directions():
    """A tie of 7 with the prefix's winner keeps the prefix; a tie of 7
    with mode 4's winning error takes 7; inf (an opaque block) never
    takes."""
    err_f = torch.tensor([2.0, 2.0, 2.0, 2.0, 3.0])
    words = _mode_words([1, 4, 6, 4, 5])
    err7 = torch.tensor([2.0, 2.0, 1.0, float("inf"), float("inf")])
    assert bc67._take7(err_f, words, err7).tolist() == [
        False, True, True, False, False]


def _blocks(img):
    return image_to_blocks(torch.from_numpy(np.ascontiguousarray(img)))[0]


@pytest.fixture(scope="module")
def alpha_set():
    """The 328 blocks: 200 random RGBA (the first half opaque), then 32x32
    crops of alphagrad and albedo; px [64, NB] int32."""
    import pathlib
    corpus = np.load(pathlib.Path(__file__).resolve().parent / "golden"
                     / "corpus.npz")
    rng = np.random.default_rng(11)
    mixed = rng.random((200, 16, 4)).astype(np.float32)
    mixed[:100, :, 3] = 1.0
    blocks = torch.cat([torch.from_numpy(mixed),
                        _blocks(corpus["alphagrad"][16:48, 16:48]),
                        _blocks(corpus["albedo"][:32, :32])])
    return bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()


def _split_search(px, aw, tier):
    """The split's plain form: the search without mode 7, its picks (the
    64 two-subset shapes' top 4, K9's twin at (1, 64)), mode 7 over the
    blocks with alpha on those picks, folded in."""
    err, words = bc67._bc7_search_plain(px, bc67.SEARCH_MODES, aw, tier)
    picks = bc67._partition_shapes_plain(px, 1, 64, 4)
    return bc67._mode7_fold_plain(px, picks, err, words, aw)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("aw", AWS)
def test_split_search_equals_the_one_fold(alpha_set, tier, aw):
    err, words = _split_search(alpha_set, aw, tier)
    ref_err, ref_words = bc67._bc7_search_plain(
        alpha_set, bc67.SEARCH_MODES_ALPHA, aw, tier)
    assert torch.equal(words, ref_words)
    assert torch.equal(err, ref_err)
    # mode 7 wins blocks, only blocks with alpha
    won7 = bc67._mode_of(bc67._words_i64(words)) == 7
    assert int(won7.sum()) > 0
    assert bool(bc67._has_alpha(alpha_set)[won7].all())


def test_alpha_list_plain(alpha_set):
    """The list twin: the blocks with some alpha below 255, ascending;
    the first 100 random blocks are opaque, the next 100 not."""
    listed = bc67._alpha_list_plain(alpha_set)
    assert listed.dtype == torch.int32
    assert torch.equal(listed, torch.sort(listed)[0])
    alpha = (alpha_set.reshape(16, 4, -1)[:, 3, :] != 255).any(dim=0)
    assert torch.equal(listed.long(), torch.nonzero(alpha).flatten())
    assert not bool(alpha[:100].any()) and bool(alpha[100:200].all())


def test_mode7_fold_without_alpha_blocks(alpha_set):
    """An opaque batch lists no block: the search's result stands."""
    px = alpha_set[:, :100]
    err, words = bc67._bc7_search_plain(px)
    picks = bc67._partition_shapes_plain(px, 1, 64, 4)
    assert len(bc67._alpha_list_plain(px)) == 0
    err7, words7 = bc67._mode7_fold_plain(px, picks, err, words)
    assert torch.equal(err7, err) and torch.equal(words7, words)


def test_mode7_fold_leaves_opaque_blocks(alpha_set):
    """Blocks without alpha keep the search's words and errors."""
    err, words = bc67._bc7_search_plain(alpha_set)
    picks = bc67._partition_shapes_plain(alpha_set, 1, 64, 4)
    err7, words7 = bc67._mode7_fold_plain(alpha_set, picks, err, words)
    opaque = ~bc67._has_alpha(alpha_set)
    assert torch.equal(words7[:, opaque], words[:, opaque])
    assert torch.equal(err7[opaque], err[opaque])
    assert bool((err7 <= err).all())
