"""The USE_3SUBSETS search's team kernels in plain form, and BC6H's other
flag bits, on the CPU.

K9 runs as a team of four warps per 32 blocks and gives both candidate
lists of the path in one launch; K7 runs one candidate a warp, each
candidate's subsets fitted in one pass. Their plain forms in the port:

- bc67._shape_lists_plain: both lists (the top 4 of the three-subset
  shapes 0..15 and of all 64) from one estimate table, held against K9's
  twin at 16 and 64 shapes and the JAX package's picks;
- bc67._shape_lists_of_table: the four warps' slices of the shapes
  and their merge by (estimate, shape), and the running top 4 of shapes
  0..15, held against _top_k_shapes under hypothesis-drawn ties;
- bc67._fit_ns_plain at three subsets: every subset in one pass, held
  bit for bit against three _fit_subset_plain calls (modes 0 and 2, alpha
  weights 1.0 and 2.0);
- bc67._partition_jobs_plain + _partition_jobs_fold_plain: one job per
  candidate, each warp's best, then the fold by (error, rank), held
  against K7's twin _partition_mode_plain and the JAX package's words for
  modes 0, 1, 2, 3 and 7, and against the strict rank-order fold under
  drawn ties;
- the USE_3SUBSETS search put together as the CUDA path does (one K9
  launch, K7 per mode, K2's twin, the fold), and encode_bc7 with flags
  0x80000 and 0x280000, against the JAX package's words.

encode_bc6h ignores every flag bit but MAXQUALITY and MID, as the JAX
package does (bc67.py:3364-3365): with QUICK (0x100000) or USE_3SUBSETS
(0x80000) its words are those of flags=0 and the JAX package's.

The JAX outputs are frozen: tests/golden/bc7_3subsets.npz
(generate_bc7_3subsets.py), tests/golden/jax_refs.npz
(generate_jax_refs.py: modes 1, 3 and 7, and modes 0 and 2 at alpha
weight 2.0, on the same batch) and tests/golden/bc6h_search.npz
(generate_bc6h_search.py). Torch runs on one thread."""

import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from directxtex_tpu_torch.bc import bc6h, bc67

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
USE3 = 0x80000
MAXQ = 0x200000
AWS = (1.0, 2.0)
# the one block of the BC6H search's frozen batch where the port's default
# words already differ from the JAX package's (a near-tie of two sums taken
# in another order; tests/test_torch_bc6h_search.py holds it to the
# F16-int rule): block 462 unsigned, none signed
BC6H_NEAR_TIES = {False: [462], True: []}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sub3():
    """The bc7_3subsets.npz batch (256 blocks: 64 synthetic three-subset
    gradients, crops of albedo, photo_china and alphagrad) as px [64, NB]
    int32, with the frozen JAX outputs of both golden files."""
    ref = dict(np.load(GOLDEN / "bc7_3subsets.npz"))
    ref.update({k: v for k, v in np.load(GOLDEN / "jax_refs.npz").items()
                if k.startswith("k7_")})
    blocks = torch.from_numpy(ref["blocks"])
    ref["px"] = bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()
    return ref


def _words_nb4(words_4nb):
    return words_4nb.t().contiguous().numpy().view(np.uint32)


def test_both_lists_from_one_table(sub3):
    px = sub3["px"]
    s16, s64 = bc67._shape_lists_plain(px)
    assert s16.dtype == s64.dtype == torch.int32
    assert torch.equal(s16, bc67._partition_shapes_plain(px, 2, 16, 4))
    assert torch.equal(s64, bc67._partition_shapes_plain(px, 2, 64, 4))
    np.testing.assert_array_equal(s16.numpy(), sub3["picks16"])
    np.testing.assert_array_equal(s64.numpy(), sub3["picks64"])


@pytest.mark.parametrize("n_shapes", [16, 64])
@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_two_list_merge_with_drawn_ties(n_shapes, data):
    """Estimates drawn from a few values, so that shapes tie inside a
    warp's slice and across slices: the merge of the slices' lists and
    the top 4 of shapes 0..15 equal _top_k_shapes's (the lower shape
    first on an equal estimate)."""
    nb = data.draw(st.integers(1, 6))
    values = data.draw(st.lists(st.sampled_from([0.0, 0.5, 1.0, 1.5, 2.0]),
                                min_size=n_shapes * nb,
                                max_size=n_shapes * nb))
    ests = torch.tensor(values, dtype=torch.float32).reshape(n_shapes, nb)
    got16, got_all = bc67._shape_lists_of_table(ests)
    for got, want in ((got16, bc67._top_k_shapes(ests[:16], 4)),
                      (got_all, bc67._top_k_shapes(ests, 4))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("aw", AWS)
@pytest.mark.parametrize("mode", [0, 2])
def test_three_subset_fit_in_one_pass(sub3, mode, aw):
    """_fit_ns_plain over the three subsets of each block's top shape
    gives each subset's _fit_subset_plain, bit for bit."""
    px = sub3["px"]
    px_i = px.reshape(16, 4, -1)
    px_f = px_i.to(torch.float32)
    picks = sub3["picks16" if mode == 0 else "picks64"][0]
    tabs = bc67._tables(torch.device("cpu"))
    sid = tabs["parts2"][torch.from_numpy(picks).to(torch.int64)].t() \
        .to(torch.int64)
    errs, q0s, q1s, p0s, p1s, idx = bc67._fit_ns_plain(px_i, px_f, sid, 3,
                                                       mode, aw)
    for s in range(3):
        err, q0, q1, p0, p1, idx_s = bc67._fit_subset_plain(
            px_i, px_f, sid == s, mode, aw)
        assert torch.equal(errs[s], err)
        for got, want in ((q0s[s], q0), (q1s[s], q1), (p0s[s], p0),
                          (p1s[s], p1)):
            assert torch.equal(got, want)
        assert torch.equal(idx[sid == s], idx_s[sid == s])


@pytest.mark.parametrize("aw", AWS)
@pytest.mark.parametrize("mode", [0, 1, 2, 3, 7])
def test_candidate_jobs_and_fold(sub3, mode, aw):
    """K7's jobs and fold on the JAX package's picks: equal to the twin's
    words and errors, and to the JAX package's jnp evaluation."""
    px = sub3["px"]
    picks = {0: "picks16", 2: "picks64"}.get(mode, "k7_picks2")
    s_blks = torch.from_numpy(np.ascontiguousarray(sub3[picks]))
    err, words = bc67._partition_jobs_fold_plain(
        bc67._partition_jobs_plain(px, s_blks, mode, aw))
    err_t, words_t = bc67._partition_mode_plain(px, s_blks, mode, aw)
    assert torch.equal(err, err_t) and torch.equal(words, words_t)
    key = f"k7_mode{mode}_aw{aw:g}"
    np.testing.assert_array_equal(_words_nb4(words), sub3[key + "_words"])
    np.testing.assert_array_equal(err.numpy(), sub3[key + "_err"])
    if aw == 1.0 and mode in (0, 2):
        np.testing.assert_array_equal(sub3[key + "_words"],
                                      sub3[f"mode{mode}_words"])


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_jobs_fold_with_drawn_ties(data):
    """Errors drawn from a few values over 1-9 candidates: the fold of the
    warps' bests by (error, rank) gives the strict-`<` fold in rank order
    (the first candidate of least error)."""
    n_cand = data.draw(st.integers(1, 9))
    nb = data.draw(st.integers(1, 5))
    errs = torch.tensor(data.draw(st.lists(
        st.sampled_from([0.0, 1.0, 2.0, float("inf")]),
        min_size=n_cand * nb, max_size=n_cand * nb)),
        dtype=torch.float32).reshape(n_cand, nb)
    jobs = [(errs[k], torch.full((4, nb), k + 1, dtype=torch.int32))
            for k in range(n_cand)]
    err, words = bc67._partition_jobs_fold_plain(jobs)
    want_err = torch.full((nb,), float("inf"))
    want_words = torch.zeros((4, nb), dtype=torch.int32)
    for e, w in jobs:
        better = e < want_err
        want_err = torch.where(better, e, want_err)
        want_words = torch.where(better[None, :], w, want_words)
    assert torch.equal(err, want_err) and torch.equal(words, want_words)


@pytest.mark.parametrize("aw", AWS)
@pytest.mark.parametrize("flags", [USE3, USE3 | MAXQ])
def test_use3_path_in_team_form(sub3, flags, aw):
    """The USE_3SUBSETS search as bc7_search_words runs it on the card
    (both lists from one ranking, K7 per mode, K2's twin over the other
    modes, the fold) equals the plain search and the JAX package's search
    words, and encode_bc7 gives the JAX package's words."""
    px = sub3["px"]
    tier = bc67.TIER_MAXQ if flags & MAXQ else bc67.TIER_DEFAULT
    search = bc67.SEARCH_MODES_3_ALPHA
    s16, s64 = bc67._shape_lists_plain(px)
    err0, words0 = bc67._partition_jobs_fold_plain(
        bc67._partition_jobs_plain(px, s16, 0, aw))
    err2, words2 = bc67._partition_jobs_fold_plain(
        bc67._partition_jobs_plain(px, s64, 2, aw))
    err_r, words_r = bc67._bc7_search_plain(px, search[2:], aw, tier)
    take2 = err2 < err0
    err02 = torch.where(take2, err2, err0)
    words02 = torch.where(take2[None, :], words2, words0)
    take_r = err_r < err02
    err = torch.where(take_r, err_r, err02)
    words = torch.where(take_r[None, :], words_r, words02)
    err_p, words_p = bc67._bc7_search_plain(px, search, aw, tier)
    assert torch.equal(err, err_p) and torch.equal(words, words_p)
    key = f"{'maxq' if flags & MAXQ else 'default'}_aw{aw:g}"
    np.testing.assert_array_equal(_words_nb4(words), sub3[key + "_search"])
    got = bc67.encode_bc7(torch.from_numpy(sub3["blocks"]), flags,
                          alpha_weight=aw)
    np.testing.assert_array_equal(got.numpy(), sub3[key + "_encoded"])


@pytest.fixture(scope="module")
def bc6h_batch():
    """Per signed: the frozen batch of bc6h_search.npz, the JAX package's
    default words and the port's flags=0 words."""
    g = np.load(GOLDEN / "bc6h_search.npz")
    out = {}
    for signed in (False, True):
        pre = "s_" if signed else "u_"
        blocks = torch.from_numpy(g[pre + "blocks"])
        out[signed] = (blocks, g[pre + "ref"],
                       bc6h.encode_bc6h(blocks, signed).numpy())
    return out


@pytest.mark.parametrize("flags", [0x100000, USE3])
@pytest.mark.parametrize("signed", [False, True])
def test_bc6h_ignores_other_flags(bc6h_batch, signed, flags):
    """QUICK and USE_3SUBSETS change nothing in BC6H: the words of
    flags=0, and the JAX package's on every block but its recorded
    near-ties. rows_sel still raises (tests/test_torch_import.py)."""
    blocks, ref, default = bc6h_batch[signed]
    got = bc6h.encode_bc6h(blocks, signed, flags).numpy()
    np.testing.assert_array_equal(got, default)
    differ = np.nonzero(np.any(got != ref, axis=1))[0]
    assert differ.tolist() == BC6H_NEAR_TIES[signed]
