"""K2's maxq search as a warp team and K5 as lane jobs, in plain form.

The kernels split a block's search into jobs and fold the jobs' results;
their plain twins here are held against the one-fold twins, word for
word and error for error, and against the JAX package's words frozen in
tests/golden/search_jobs.npz (tests/golden/generate_search_jobs.py):

- the paired two-subset fit (bc67._fit_ns_plain at two subsets: both in one
  pass over the pixels, each pixel on its own subset's state and in its
  own subset's sums) against two one-subset fits (_fit_subset_plain), bit
  for bit, modes 1, 3 and 7 at alpha weights 1.0 and 2.0;
- the maxq team's 21 evaluations of a block (_maxq_jobs_plain) and their
  fold (_maxq_fold_plain) against _bc7_search_plain(SEARCH_MODES, tier
  maxq), each mode's results against that mode's own twin, and the JAX
  package's maxq search words under the near-tie rule of
  test_torch_bc7_encode;
- K5's one-region and candidate jobs (_bc6h_search_jobs_plain) folded by
  (error, position) in every order against _bc6h_search_plain, and the
  JAX package's words under the F16-int rule of test_torch_bc6h_search;
- both folds under drawn ties (hypothesis) and on the batches' own ties:
  flat blocks, on which several BC7 modes reach the same error, and HDR
  blocks with most pixels 0, on which BC6H shape candidates do.

The BC7 batch: 96 random RGBA blocks, 16 flat, 16 two-tone and 32 of
tworegion; the BC6H batches: 64 random, 16 flat, 16 two-tone and 32
sparse blocks, unsigned and signed. Torch runs on one thread."""

import itertools
import pathlib
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from directxtex_tpu_torch.bc import bc6h, bc67
from test_torch_bc6h_search import assert_int_rule
from test_torch_bc7_encode import _words_u32, assert_near_tie

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
AWS = (1.0, 2.0)
FLAT = slice(96, 112)               # the BC7 batch's flat blocks
SPARSE = slice(96, 128)             # the BC6H batches' sparse blocks
MAXQ_ORDER = (1, 3, 5, 6, 4)        # the maxq search's cross-mode fold


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN / "search_jobs.npz")


@pytest.fixture(scope="module")
def bc7_px(golden):
    """The BC7 batch's texels, px [64, NB] int32."""
    blocks = torch.from_numpy(golden["bc7_blocks"])
    return bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()


@pytest.fixture(scope="module")
def maxq(bc7_px):
    """Per alpha weight: the jobs' twin, its fold and the one-fold twin."""
    out = {}
    for aw in AWS:
        picks, jobs = bc67._maxq_jobs_plain(bc7_px, aw)
        out[aw] = {"picks": picks, "jobs": jobs,
                   "fold": bc67._maxq_fold_plain(jobs),
                   "search": bc67._bc7_search_plain(
                       bc7_px, bc67.SEARCH_MODES, aw, bc67.TIER_MAXQ)}
    return out


@pytest.fixture(scope="module")
def k5(golden):
    """Per signed: px [48, NB], the jobs' twin and the one-fold twin."""
    out = {}
    for signed in (False, True):
        pre = "s_" if signed else "u_"
        px = bc6h.px_of_blocks(torch.from_numpy(golden[pre + "blocks"]),
                               signed)
        out[signed] = {"px": px,
                       "jobs": bc6h._bc6h_search_jobs_plain(px, signed),
                       "search": bc6h._bc6h_search_plain(px, signed)}
    return out


def _same_err(a, b):
    """Errors equal bit for bit, infinities included."""
    return bool(((a == b) | (torch.isinf(a) & torch.isinf(b))).all())


# ---------------------------------------------------------------------------
# the paired two-subset fit
# ---------------------------------------------------------------------------

def _fits_equal(px, s_blks, mode, aw):
    """The paired fit of every shape in s_blks against the two one-subset
    fits of its subsets: errors, codes, p bits and each subset's indices."""
    px_i = px.reshape(16, 4, -1)
    px_f = px_i.to(torch.float32)
    tabs = bc67._tables(px.device)
    for s_blk in s_blks:
        s1 = tabs["parts1"][s_blk.to(torch.int64)].t() == 1
        errs, q0s, q1s, p0s, p1s, idx = bc67._fit_ns_plain(
            px_i, px_f, s1.to(torch.int64), 2, mode, aw)
        for sub, mask in enumerate((~s1, s1)):
            err, q0, q1, p0, p1, ix = bc67._fit_subset_plain(px_i, px_f, mask,
                                                            mode, aw)
            assert torch.equal(errs[sub], err)
            assert torch.equal(q0s[sub], q0) and torch.equal(q1s[sub], q1)
            assert torch.equal(p0s[sub], p0) and torch.equal(p1s[sub], p1)
            assert torch.equal(idx[mask], ix[mask])


@pytest.mark.parametrize("aw", AWS)
@pytest.mark.parametrize("mode", [1, 3, 7])
def test_pair_fit_equals_two_fits(bc7_px, maxq, mode, aw):
    """On each block's four candidate shapes."""
    _fits_equal(bc7_px, list(maxq[aw]["picks"]), mode, aw)


def test_pair_fit_equals_two_fits_on_every_shape(bc7_px):
    nb = bc7_px.shape[1]
    _fits_equal(bc7_px, [torch.full((nb,), s, dtype=torch.int32)
                         for s in range(64)], 1, 1.0)


# ---------------------------------------------------------------------------
# the maxq team's jobs and fold
# ---------------------------------------------------------------------------

def test_maxq_job_slots_are_the_kernels():
    """MAXQ_JOBS in the kernel's slot order (bc7_encode.cuh's MaxqSlot)."""
    src = (ROOT / "directxtex_tpu_torch" / "csrc" / "bc7_encode.cuh") \
        .read_text()
    slots = dict(re.findall(r"(kQ\w+) = (\d+)",
                            re.search(r"enum MaxqSlot \{([^}]*)\}",
                                      src).group(1)))
    jobs = bc67.MAXQ_JOBS
    assert len(jobs) == int(slots["kQSlots"]) == 21
    for mode, key in ((1, "kQ1"), (3, "kQ3"), (5, "kQ5"), (4, "kQ4"),
                      (6, "kQ6")):
        assert [j for j, job in enumerate(jobs) if job[0] == mode][0] \
            == int(slots[key])
    assert jobs[12:20] == tuple((4, r, im) for r in range(4)
                                for im in (0, 1))


@pytest.mark.parametrize("aw", AWS)
def test_maxq_jobs_fold_equals_the_search(bc7_px, maxq, aw):
    err, words = maxq[aw]["fold"]
    ref_err, ref_words = maxq[aw]["search"]
    assert torch.equal(words, ref_words) and torch.equal(err, ref_err)
    assert torch.equal(maxq[aw]["picks"],
                       bc67._partition_shapes_plain(bc7_px, 1, 64, 4))


@pytest.mark.parametrize("aw", AWS)
def test_maxq_jobs_fold_matches_jax(golden, bc7_px, maxq, aw):
    ref = golden["bc7_search_aw1" if aw == 1.0 else "bc7_search_aw2"]
    px = bc7_px.reshape(16, 4, -1).numpy()
    assert_near_tie(_words_u32(maxq[aw]["fold"][1]), ref, px)


@pytest.mark.parametrize("mode", [1, 3, 5, 6, 4])
def test_maxq_jobs_of_a_mode_fold_to_its_twin(bc7_px, maxq, mode):
    """At alpha weight 2.0: a mode's jobs folded in slot order give the
    one-fold twin of that mode (modes 1 and 3 over the candidates, 4 and
    5 over rotations and index modes, 6 alone)."""
    jobs = [maxq[2.0]["jobs"][j] for j, job in enumerate(bc67.MAXQ_JOBS)
            if job[0] == mode]
    best_err = torch.full_like(jobs[0][0], float("inf"))
    best_words = torch.zeros_like(jobs[0][1])
    for err, words in jobs:
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_words = torch.where(better[None, :], words, best_words)
    px_i = bc7_px.reshape(16, 4, -1)
    px_f = px_i.to(torch.float32)
    if mode in (1, 3):
        ref = bc67._try_partition_mode(px_i, px_f, mode,
                                       bc67._shape_estimates_table(px_f), 2.0)
    elif mode in (4, 5):
        ref = bc67._try_single_mode45(px_i, px_f, mode, 2.0)
    else:
        ref = bc67._try_mode6(px_i, px_f, 2.0)
    assert torch.equal(best_err, ref[0])
    assert torch.equal(best_words, bc67._words_i32(ref[1]))


def _flat_order():
    """The maxq jobs in the order of the search's fold: each mode's jobs in
    slot order, the modes in MAXQ_ORDER."""
    return [j for m in MAXQ_ORDER
            for j, job in enumerate(bc67.MAXQ_JOBS) if job[0] == m]


def _marked(values):
    """Words whose first u32 is the job's slot, one column per case."""
    w = torch.zeros((4, len(values)), dtype=torch.int32)
    w[0] = torch.tensor(values, dtype=torch.int32)
    return w


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.lists(st.lists(st.sampled_from([0.0, 1.0, 2.0, 4.0]),
                         min_size=21, max_size=21), min_size=24,
                max_size=24))
def test_maxq_fold_under_drawn_ties(cases):
    """Jobs' errors drawn from four values, so that candidates, rotations
    and modes tie often: the fold takes the first job of least error in
    the search's order."""
    n = len(cases)
    jobs = [(torch.tensor([c[j] for c in cases], dtype=torch.float32),
             _marked([j] * n)) for j in range(21)]
    err, words = bc67._maxq_fold_plain(jobs)
    order = _flat_order()
    for b, c in enumerate(cases):
        want = min(order, key=lambda j: (c[j], order.index(j)))
        assert int(words[0, b]) == want and float(err[b]) == c[want]


def test_maxq_fold_on_tied_flat_blocks(maxq):
    """Flat blocks reach the same least error in several modes; the fold
    keeps the first of them in the search's order."""
    jobs = maxq[1.0]["jobs"]
    err, words = maxq[1.0]["fold"]
    order = _flat_order()
    errs = torch.stack([jobs[j][0] for j in order])[:, FLAT]
    least = errs.min(dim=0).values
    n_tied = (errs == least[None, :]).sum(dim=0)
    assert int((n_tied > 1).sum()) >= 8
    first = torch.argmax((errs == least[None, :]).to(torch.int32), dim=0)
    for b, k in zip(range(FLAT.start, FLAT.stop), first.tolist()):
        assert torch.equal(words[:, b], jobs[order[k]][1][:, b])
        assert float(err[b]) == float(least[b - FLAT.start])


# ---------------------------------------------------------------------------
# K5's jobs and fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("signed", [False, True])
def test_k5_jobs_fold_equals_the_search(k5, signed):
    err, words = bc6h._bc6h_jobs_fold_plain(k5[signed]["jobs"])
    ref_err, ref_words = k5[signed]["search"]
    assert torch.equal(words, ref_words) and _same_err(err, ref_err)


@pytest.mark.parametrize("signed", [False, True])
def test_k5_fold_in_any_order(k5, signed):
    """`beats` folds by (error, position), whatever the visiting order."""
    jobs = k5[signed]["jobs"]
    ref_err, ref_words = k5[signed]["search"]
    for perm in itertools.permutations(jobs):
        err, words = bc6h._bc6h_jobs_fold_plain(list(perm))
        assert torch.equal(words, ref_words) and _same_err(err, ref_err)


@pytest.mark.parametrize("signed", [False, True])
def test_k5_jobs_match_jax(golden, k5, signed):
    pre = "s_" if signed else "u_"
    _, words = bc6h._bc6h_jobs_fold_plain(k5[signed]["jobs"])
    assert_int_rule(_words_u32(words), golden[pre + "words"],
                    golden[pre + "px_int"], signed)


@pytest.mark.parametrize("signed", [False, True])
def test_k5_jobs_keep_their_positions(k5, signed):
    """The one-region job's best is a row 10-13 (position 0-3), candidate
    job k's a row 0-9 at 4 + 4 row + k; -1 where no row fits."""
    jobs = k5[signed]["jobs"]
    one = jobs[0][1]
    assert bool(((one >= -1) & (one <= 3)).all())
    for k, (err, order, _) in enumerate(jobs[1:]):
        fits = order >= 0
        assert bool(((order[fits] - 4 - k) % 4 == 0).all())
        assert bool((order[fits] <= 4 + 4 * 9 + k).all())
        assert bool(torch.isinf(err[~fits]).all())


@pytest.mark.parametrize("signed", [False, True])
def test_k5_fold_on_tied_candidates(k5, signed):
    """On blocks with most pixels 0, shape candidates reach the same error;
    the fold keeps the least position, the lowest rank on one row."""
    jobs = k5[signed]["jobs"]
    err, words = bc6h._bc6h_jobs_fold_plain(jobs)
    errs = torch.stack([j[0] for j in jobs[1:]])[:, SPARSE]
    orders = torch.stack([j[1] for j in jobs[1:]])[:, SPARSE]
    least = errs.min(dim=0).values
    tied = (errs == least[None, :]) & torch.isfinite(least)[None, :]
    assert int((tied.sum(dim=0) > 1).sum()) >= 4
    for b in range(SPARSE.stop - SPARSE.start):
        ks = torch.nonzero(tied[:, b]).flatten().tolist()
        if len(ks) < 2 or float(jobs[0][0][SPARSE.start + b]) <= float(
                least[b]):
            continue
        k = min(ks, key=lambda k: int(orders[k, b]))
        assert torch.equal(words[:, SPARSE.start + b],
                           jobs[1 + k][2][:, SPARSE.start + b])


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.lists(st.lists(st.sampled_from([0.0, 1.0, 2.0, float("inf")]),
                         min_size=44, max_size=44), min_size=16,
                max_size=16))
def test_k5_fold_under_drawn_ties(cases):
    """Drawn errors of rows 10-13 and of rows 0-9 on four candidates, ties
    and unfit rows (inf) common: each job keeps its best by `beats`, the
    jobs fold in reverse; that is the twin's strict-`<` fold over rows
    10-13, then rows 0-9 with candidates in rank order."""
    n = len(cases)

    def none():
        return (torch.full((n,), float("inf")),
                torch.full((n,), -1, dtype=torch.int64),
                torch.zeros((4, n), dtype=torch.int32))

    def col(k):
        return torch.tensor([c[k] for c in cases], dtype=torch.float32)

    one = none()
    for r in range(4):
        one = bc6h._keep_beating(one, col(r), torch.full((n,), r),
                                 _marked([r] * n))
    jobs = [one]
    for k in range(4):
        best = none()
        for row in range(10):
            pos = 4 + 4 * row + k
            best = bc6h._keep_beating(best, col(pos), torch.full((n,), pos),
                                      _marked([pos] * n))
        jobs.append(best)
    err, words = bc6h._bc6h_jobs_fold_plain(jobs[::-1])
    for b, c in enumerate(cases):
        best_e, best_p = float("inf"), 0
        for pos in range(44):           # the twin's order: positions
            if c[pos] < best_e:
                best_e, best_p = c[pos], pos
        assert float(err[b]) == best_e
        assert int(words[0, b]) == (best_p if best_e < float("inf") else 0)
