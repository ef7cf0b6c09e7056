"""K11 as one launch of lane jobs, in plain form.

The kernel covers the precision groups of a mask in one launch: job
j = k + C * i is candidate rank k on the i-th group of the mask, on warp
j % 4; each job keeps its best row by (error, position row * C + k) from
(inf, past the last position), and warp 0 folds the warps by the same
order. Its plain form (bc6h._bc6h_2region_jobs_plain +
_bc6h_2region_jobs_fold_plain) is held, word for word and error for error
(infinities included), against:

- the per-group twin _bc6h_2region_plain, one group at a time, and the
  JAX package's words and errors frozen in tests/golden/bc6h_unshared.npz
  (where the error is finite: where no candidate fits, the twin and the
  kernel keep the first candidate's words, the jnp fold zero words);
- the groups' per-group twins folded in group order
  (_bc6h_2region_groups_plain, the wrapper's CPU path) for every mask
  tried;
- the unshared search: K10 and the one launch folded by _fold_launches
  give the fold over K10 and the six per-group launches, and the JAX
  package's search words at the JAX picks; on masks where every row of a
  block reads inf, the words of an infinite K10 stay zero;
- the fold under drawn ties of (error, position) (hypothesis).

The batches: tests/golden/bc6h_unshared.npz's 520 blocks (the 200-block
random / bimodal set and 32x32 crops of the five HDR corpus contents),
unsigned and signed, with the JAX package's picks. Torch runs on one
thread."""

import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from directxtex_tpu_torch.bc import bc6h

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
SIGNED = (False, True)
GROUPS = ((0,), (1,), (2, 3, 4), (5,), (6, 7, 8), (9,))
ALL = tuple(range(6))
MASKS = ((0, 2), (1, 4), (0, 2, 3))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pre(signed):
    return "s_" if signed else "u_"


def _key(rows):
    return "rows_" + "".join(str(r) for r in rows)


def _u32(words_4nb):
    """[4, NB] int32 -> [NB, 4] u32."""
    return words_4nb.t().contiguous().numpy().view(np.uint32)


def _bits_equal(a, b):
    """Errors bit for bit (an inf equals an inf)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.fixture(scope="module")
def batch():
    """Per signed: the frozen JAX outputs, the port's pixels, the JAX
    picks, the jobs of all six groups and each group's own twin."""
    ref = np.load(GOLDEN / "bc6h_unshared.npz")
    out = {}
    for signed in SIGNED:
        pre = _pre(signed)
        px = bc6h.px_of_blocks(torch.from_numpy(ref[pre + "blocks"]), signed)
        picks = torch.from_numpy(ref[pre + "picks"])
        out[signed] = {
            "ref": ref, "px": px, "picks": picks,
            "jobs": bc6h._bc6h_2region_jobs_plain(px, picks, ALL, signed),
            "groups": [bc6h._bc6h_2region_plain(px, picks, rows, signed)
                       for rows in GROUPS]}
    return out


def _group_jobs(jobs, groups, n_cand=4):
    """The jobs a launch over `groups` runs, taken from the jobs of all six
    groups (group g's C jobs in candidate order)."""
    return [jobs[g * n_cand + k] for g in groups for k in range(n_cand)]


@pytest.mark.parametrize("group", range(6))
@pytest.mark.parametrize("signed", SIGNED)
def test_one_group_jobs_equal_group_twin(batch, signed, group):
    b = batch[signed]
    err, words = bc6h._bc6h_2region_jobs_fold_plain(
        _group_jobs(b["jobs"], (group,)))
    want_err, want_words = b["groups"][group]
    assert _bits_equal(err, want_err)
    assert torch.equal(words, want_words)
    pre = _pre(signed) + _key(GROUPS[group])
    r_err = b["ref"][pre + "_err"]
    assert torch.equal(err, torch.from_numpy(r_err))
    fin = np.isfinite(r_err)
    np.testing.assert_array_equal(_u32(words)[fin],
                                  b["ref"][pre + "_words"][fin])


@pytest.mark.parametrize("signed", SIGNED)
def test_jobs_plain_runs_one_group_as_its_launch(batch, signed):
    """The jobs of a one-group mask are that group's jobs of the six-group
    mask: a job's result does not depend on the other groups."""
    b = batch[signed]
    jobs = bc6h._bc6h_2region_jobs_plain(b["px"], b["picks"], (4,), signed)
    for got, want in zip(jobs, _group_jobs(b["jobs"], (4,))):
        assert _bits_equal(got[0], want[0])
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("groups", (ALL,) + MASKS)
@pytest.mark.parametrize("signed", SIGNED)
def test_mask_jobs_equal_groups_twin(batch, signed, groups):
    """A mask's one launch equals its groups' twins folded in group order,
    the first taken as it is: where every row of the mask reads inf, the
    first group's first row's first candidate's words."""
    b = batch[signed]
    err, words = bc6h._bc6h_2region_jobs_fold_plain(
        _group_jobs(b["jobs"], groups))
    want_err, want_words = bc6h._bc6h_2region_groups_plain(
        b["px"], b["picks"], groups, signed)
    assert _bits_equal(err, want_err)
    assert torch.equal(words, want_words)
    no_fit = ~torch.isfinite(err)
    if groups == ALL:
        assert not bool(no_fit.any())
    if bool(no_fit.any()):
        first = b["groups"][groups[0]][1]
        assert torch.equal(words[:, no_fit], first[:, no_fit])
        assert bool((words[:, no_fit] != 0).any())


@pytest.mark.parametrize("signed", SIGNED)
def test_search_folds_k10_and_one_launch(batch, signed):
    """The unshared search's fold over (K10, the one launch) equals the
    fold over (K10, group 0, ..., group 5) and the JAX package's search
    words at the JAX picks (K10's frozen JAX result)."""
    b = batch[signed]
    pre = _pre(signed)
    k10 = (torch.from_numpy(b["ref"][pre + "k10_err"]),
           torch.from_numpy(b["ref"][pre + "k10_words"].view(np.int32).T
                            .copy()))
    one = bc6h._fold_launches(
        [k10, bc6h._bc6h_2region_jobs_fold_plain(b["jobs"])])
    seven = bc6h._fold_launches([k10] + b["groups"])
    assert _bits_equal(one[0], seven[0])
    assert torch.equal(one[1], seven[1])
    np.testing.assert_array_equal(
        _u32(one[1]), b["ref"][pre + "search"].view(np.uint32)
        .reshape(-1, 4))


@pytest.mark.parametrize("groups", MASKS)
@pytest.mark.parametrize("signed", SIGNED)
def test_search_fold_where_every_row_reads_inf(batch, signed, groups):
    """With an infinite K10, the blocks on which every row of the mask
    reads inf keep zero words and an infinite error, as the fold over the
    per-group launches gives, though the launch hands the fold its first
    candidate's words."""
    b = batch[signed]
    nb = b["px"].shape[1]
    k10 = (torch.full((nb,), float("inf")),
           torch.full((4, nb), 7, dtype=torch.int32))
    launch = bc6h._bc6h_2region_jobs_fold_plain(
        _group_jobs(b["jobs"], groups))
    one = bc6h._fold_launches([k10, launch])
    per_group = bc6h._fold_launches([k10] + [b["groups"][g]
                                             for g in groups])
    assert _bits_equal(one[0], per_group[0])
    assert torch.equal(one[1], per_group[1])
    no_fit = ~torch.isfinite(launch[0])
    assert bool(no_fit.any())
    assert bool((one[1][:, no_fit] == 0).all())
    assert bool((launch[1][:, no_fit] != 0).any())


@pytest.mark.parametrize("signed", SIGNED)
def test_search_unshared_launches_k11_once(batch, signed, monkeypatch):
    """_search_unshared hands K11 all six groups in one call, and its words
    are the fold of K10 and that call."""
    b = batch[signed]
    px = b["px"][:, :48].contiguous()
    picks = b["picks"][:, :48].contiguous()
    calls = []
    k11 = bc6h.bc6h_2region_groups_words

    def recording(px_, s_blks, groups, signed_):
        calls.append(tuple(groups))
        return k11(px_, s_blks, groups, signed_)

    monkeypatch.setattr(bc6h, "bc6h_shape_picks", lambda p: picks)
    monkeypatch.setattr(bc6h, "bc6h_2region_groups_words", recording)
    err, words = bc6h._search_unshared(px, signed)
    assert calls == [ALL]
    want = bc6h._fold_launches(
        [bc6h._bc6h_1region_plain(px, signed)]
        + [bc6h._bc6h_2region_plain(px, picks, rows, signed)
           for rows in GROUPS])
    assert _bits_equal(err, want[0]) and torch.equal(words, want[1])


def test_wrapper_takes_groups(batch):
    """bc6h_2region_groups_words on a CPU tensor is the groups' twin; the
    one-group wrapper is its one-group case."""
    b = batch[False]
    px = b["px"][:, :24].contiguous()
    picks = b["picks"][:, :24].contiguous()
    got = bc6h.bc6h_2region_groups_words(px, picks, (1, 4), False)
    want = bc6h._bc6h_2region_groups_plain(px, picks, (1, 4), False)
    assert _bits_equal(got[0], want[0]) and torch.equal(got[1], want[1])
    one = bc6h.bc6h_2region_words(px, picks, 2, False)
    want = bc6h._bc6h_2region_plain(px, picks, GROUPS[2], False)
    assert _bits_equal(one[0], want[0]) and torch.equal(one[1], want[1])


@pytest.mark.parametrize("groups", [(), (2, 1), (6,), (1, 1), (-1, 0)])
def test_wrapper_refuses_groups(groups):
    px = torch.zeros((48, 4), dtype=torch.int32)
    s_blks = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        bc6h.bc6h_2region_groups_words(px, s_blks, groups, False)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.lists(st.tuples(st.sampled_from([1.0, 2.0, 3.0, float("inf")]),
                          st.integers(0, 39)),
                min_size=8, max_size=8, unique_by=lambda t: t[1]),
       st.integers(1, 4))
def test_fold_is_the_least_error_and_position(jobs, n_warps):
    """Drawn (error, position) results of 8 jobs on one block, few error
    values so that ties are common: the fold over warps takes the least
    error, and on a tie the least position, for any number of warps."""
    js = [(torch.tensor([e]), torch.tensor([o]),
           torch.full((4, 1), o, dtype=torch.int32)) for e, o in jobs]
    err, words = bc6h._bc6h_2region_jobs_fold_plain(js, n_warps)
    e, o = min(jobs)
    assert float(err[0]) == e and int(words[0, 0]) == o
