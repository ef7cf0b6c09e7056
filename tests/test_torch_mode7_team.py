"""Mode 7's launch as a warp team, in plain form.

The kernel (bc7_mode7_team_kernel) gives a CTA of four warps 32
consecutive entries of the alpha list, stages those blocks' pixels through
the list, runs candidate rank k of the search's picks on warp k (both
subsets of a candidate fitted in one pass), folds the four candidates in
rank order with a strict `<` and folds the result into the search's
(err, words) in place by the take7 rule. Its plain form
(bc67._mode7_jobs_plain: _partition_jobs_plain + _partition_jobs_fold_plain
over the listed blocks, then _take7) is held against the launch's twin
_mode7_fold_plain, word for word and error for error, on the blocks the
two tiers' searches leave and their picks, at alpha weights 1.0 and 2.0:
on blocks with and without alpha (the 328-block set of the alpha tests:
200 random RGBA blocks, the first half opaque, and 32x32 crops of
alphagrad and albedo), and on an opaque batch, which lists no block.
Each candidate job also equals K7's twin on its candidate alone, and the
list's order does not matter (the kernel's list is in no fixed order).
Torch runs on one thread."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc67
from directxtex_tpu_torch.bc.common import image_to_blocks

AWS = (1.0, 2.0)
TIERS = (bc67.TIER_DEFAULT, bc67.TIER_MAXQ)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blocks(img):
    return image_to_blocks(torch.from_numpy(np.ascontiguousarray(img)))[0]


@pytest.fixture(scope="module")
def alpha_set():
    """The 328 blocks, px [64, NB] int32, and their two-subset picks (the
    64 shapes' top 4, K9's twin at (1, 64): what both tiers' searches
    write)."""
    corpus = np.load(pathlib.Path(__file__).resolve().parent / "golden"
                     / "corpus.npz")
    rng = np.random.default_rng(11)
    mixed = rng.random((200, 16, 4)).astype(np.float32)
    mixed[:100, :, 3] = 1.0
    blocks = torch.cat([torch.from_numpy(mixed),
                        _blocks(corpus["alphagrad"][16:48, 16:48]),
                        _blocks(corpus["albedo"][:32, :32])])
    px = bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()
    return px, bc67._partition_shapes_plain(px, 1, 64, 4)


@pytest.fixture(scope="module")
def searches(alpha_set):
    """{(tier, aw): the (1, 3, 5, 6, 4) search's (err, words)}."""
    px, _ = alpha_set
    return {(tier, aw): bc67._bc7_search_plain(px, bc67.SEARCH_MODES, aw,
                                               tier)
            for tier in TIERS for aw in AWS}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("aw", AWS)
def test_team_equals_the_launch_twin(alpha_set, searches, tier, aw):
    px, picks = alpha_set
    err, words = searches[tier, aw]
    got_err, got_words = bc67._mode7_jobs_plain(px, picks, err, words, aw)
    want_err, want_words = bc67._mode7_fold_plain(px, picks, err, words, aw)
    assert torch.equal(got_words, want_words)
    assert torch.equal(got_err.view(torch.int32), want_err.view(torch.int32))
    # mode 7 takes blocks, only blocks with alpha, and the rest stand
    taken = (got_words != words).any(dim=0)
    assert int(taken.sum()) > 0
    assert bool(bc67._has_alpha(px)[taken].all())
    opaque = ~bc67._has_alpha(px)
    assert torch.equal(got_words[:, opaque], words[:, opaque])
    assert torch.equal(got_err[opaque], err[opaque])


@pytest.mark.parametrize("aw", AWS)
def test_each_job_is_k7_on_its_candidate(alpha_set, aw):
    """Candidate job k of the listed blocks equals K7's twin on candidate k
    alone (one subset at a time, each over all 16 pixels with the other
    masked off)."""
    px, picks = alpha_set
    listed = bc67._alpha_list_plain(px).to(torch.int64)
    pxl, pkl = px[:, listed], picks[:, listed]
    jobs = bc67._partition_jobs_plain(pxl, pkl, 7, aw)
    assert len(jobs) == 4
    for k, (err, words) in enumerate(jobs):
        want_err, want_words = bc67._partition_mode_plain(
            pxl, pkl[k:k + 1], 7, aw)
        assert torch.equal(words, want_words)
        assert torch.equal(err, want_err)


@pytest.mark.parametrize("aw", AWS)
def test_list_order_does_not_matter(alpha_set, searches, aw):
    """The kernel's list is in no fixed order: the blocks gathered in
    reverse give each block the same result."""
    px, picks = alpha_set
    listed = bc67._alpha_list_plain(px).to(torch.int64)
    rev = listed.flip(0)
    fwd = bc67._partition_jobs_fold_plain(
        bc67._partition_jobs_plain(px[:, listed], picks[:, listed], 7, aw))
    bwd = bc67._partition_jobs_fold_plain(
        bc67._partition_jobs_plain(px[:, rev], picks[:, rev], 7, aw))
    assert torch.equal(fwd[1], bwd[1].flip(1))
    assert torch.equal(fwd[0], bwd[0].flip(0))


@pytest.mark.parametrize("tier", TIERS)
def test_opaque_batch_lists_no_block(alpha_set, searches, tier):
    """An opaque batch lists no block: the search's result stands."""
    px, picks = alpha_set
    px, picks = px[:, :100], picks[:, :100]
    err, words = searches[tier, 1.0]
    err, words = err[:100], words[:, :100]
    assert len(bc67._alpha_list_plain(px)) == 0
    got_err, got_words = bc67._mode7_jobs_plain(px, picks, err, words)
    assert torch.equal(got_err, err) and torch.equal(got_words, words)


def test_team_on_alpha_blocks_only(alpha_set, searches):
    """A batch of blocks that all have alpha: every block is listed, and
    the team's result is the twin's."""
    px, picks = alpha_set
    px, picks = px[:, 100:200], picks[:, 100:200]
    err, words = searches[bc67.TIER_DEFAULT, 1.0]
    err, words = err[100:200], words[:, 100:200]
    assert len(bc67._alpha_list_plain(px)) == 100
    got = bc67._mode7_jobs_plain(px, picks, err, words)
    want = bc67._mode7_fold_plain(px, picks, err, words)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
