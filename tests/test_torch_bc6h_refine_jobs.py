"""Kernel K6's lane-job decomposition in plain form, held word for word
against the port's plain twin (bc6h._bc6h_refine_plain) and the JAX
package's refine_bc6h_words.

K6 runs as a unit bucket pass (one-region winners, two-region winners,
reserved modes), then one launch per unit over its blocks' jobs: a
one-region block's job j ladders the region at row 10 + j's precision; a
two-region block's job (g, s) ladders subset s at precision group g's
precision (with cross2; without it, the block's own precision; the
kernel runs a group's two jobs in lockstep in one lane). Each job ends
with its subset's anchor swap; then one lane per block folds in the
twin's order. `_refine_jobs` below is that structure with torch ops: the
bucket twin's lists, every job of a unit as a lane of one batched ladder,
the fold. The tests hold it, and the twin, to the JAX
package's refine (frozen by tests/golden/generate_bc6h_refine_jobs.py;
an eager JAX maxq refine takes about half a minute) at the mid and maxq
tiers, signed and unsigned, on tests/test_torch_bc6h_refine.py's blocks
and the 520-block batch of bc6h_unshared.npz; and cover the fixed-index
ladder, the smallest subset BC6H has (3 pixels: its 32 shapes have none
of 2), reserved modes, ties between precision groups in the fold, and the
bucket twin. Torch runs on one thread."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc6h, bc67
from directxtex_tpu_torch.bc.bc67_tables import BC6H_MODE_INFO

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
TIERS = {"mid": (bc6h.BC6H_LADDER_MID, False),
         "maxq": (bc6h.BC6H_LADDER_MAXQ, True)}
SMALLEST_SUBSET_SHAPE = 8      # subset 1 has 3 pixels


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the plain job form ---------------------------------------------------------
def _stored(words, signed):
    """Each block's stored state: mode rows [NB], shapes [NB], endpoints
    qm[(region, end)] [3, NB] and precision [NB] (the twin's unpack)."""
    nb = words.shape[1]
    rows = bc6h._mode_rows(words)
    qm = {k: torch.zeros((3, nb), dtype=torch.int32)
          for k in ((0, 0), (0, 1), (1, 0), (1, 1))}
    shape = torch.zeros(nb, dtype=torch.int64)
    precw = torch.full((nb,), 10, dtype=torch.int32)
    for row in range(14):
        hit = rows == row
        s_r, e = bc6h._bc6h_unpack_endpoints(words, row, signed)
        info = BC6H_MODE_INFO[row]
        precw = torch.where(hit, info[4][0], precw)
        if info[1]:
            shape = torch.where(hit, s_r, shape)
        for key in qm:
            if info[1] or key[0] == 0:
                vals = torch.stack([e[(key[0], key[1], c)]
                                    for c in range(3)]).to(torch.int32)
                qm[key] = torch.where(hit[None, :], vals, qm[key])
    return rows, shape, qm, precw


def _start(qm, sub, precw, prec, signed):
    """Region sub's start endpoints at precision prec [L]: the stored ones
    at the stored precision, else the finished ones requantized."""
    same = precw == prec
    out = []
    for e in (0, 1):
        fin = bc6h._bc6h_finish_unquantize(
            bc6h._bc6h_unquantize_dyn(qm[(sub, e)], precw, signed), signed)
        out.append(torch.where(same[None, :], qm[(sub, e)],
                               bc6h._bc6h_quantize_dyn(fin, prec, signed)))
    return out


def _jobs(px3, mask, q0, q1, prec, anchor, idx0, iprec, signed, remap,
          ladder):
    """Every lane's job at once: the ladder on the lane's mask at its
    precision, then its subset's anchor swap. Returns (err, q0, q1, idx)
    with only the lane's masked entries of idx0 changed."""
    if remap:
        q0n, q1n, idx_t, err, _ = bc6h._bc6h_perturb_remap_dyn(
            px3, mask, q0, q1, prec, iprec, signed, *ladder)
        idx = torch.where(mask, idx_t, idx0)
    else:
        q0n, q1n, err_l, _ = bc6h._bc6h_perturb_dyn(
            px3, mask, q0, q1, bc67._pal_weight(idx0, 1 << iprec), prec,
            signed, *ladder)
        idx_t, err_t = bc6h._bc6h_palette_err_dyn(px3, mask, q0n, q1n, prec,
                                                  iprec, signed)
        idx = torch.where((err_t < err_l)[None, :] & mask, idx_t, idx0)
        err = torch.minimum(err_t, err_l)
    swap = (bc6h._anchor_index(idx, anchor) & (1 << (iprec - 1))) != 0
    q0a = torch.where(swap[None, :], q1n, q0n)
    q1a = torch.where(swap[None, :], q0n, q1n)
    idx = torch.where(swap[None, :] & mask, (1 << iprec) - 1 - idx, idx)
    return err, q0a, q1a, idx


def _cherr_sum(px3, mask, qm, precw, idx, iprec, signed, subs, best=None):
    """The stored state's error, summed over subs and channels in order."""
    wk = bc67._pal_weight(idx, 1 << iprec)
    best = torch.zeros(px3[0].shape[1]) if best is None else best
    for sub in subs:
        for c in range(3):
            best = best + bc6h._bc6h_cherr_dyn(
                px3[c], mask[sub],
                bc6h._bc6h_unquantize_dyn(qm[(sub, 0)][c], precw, signed),
                bc6h._bc6h_unquantize_dyn(qm[(sub, 1)][c], precw, signed),
                wk, signed)
    return best


def _unit_a(px3, words, signed, remap, ladder):
    """Unit A's launch on its blocks: 4 lanes a block (row 10 + j's
    precision), job-major, then the fold over rows 10..13."""
    nb = words.shape[1]
    rows, _, qm, precw = _stored(words, signed)
    idx1 = torch.stack(bc67._read_indices(words, 65, 4, None, None)[0]) \
        .to(torch.int32)
    lanes = [t.repeat(1, 4) for t in px3]
    prec = torch.cat([torch.full((nb,), BC6H_MODE_INFO[10 + j][4][0],
                                 dtype=torch.int32) for j in range(4)])
    qm4 = {k: v.repeat(1, 4) for k, v in qm.items()}
    q0, q1 = _start(qm4, 0, precw.repeat(4), prec, signed)
    ones = torch.ones((16, 4 * nb), dtype=torch.bool)
    err, q0a, q1a, idx = _jobs(lanes, ones, q0, q1, prec, 0,
                               idx1.repeat(1, 4), 4, signed, remap, ladder)
    best = _cherr_sum(px3, [ones[:, :nb]], qm, precw, idx1, 4, signed, (0,))
    out = words
    for j in range(4):
        sl = slice(j * nb, (j + 1) * nb)
        errf, pairs = bc6h._bc6h_transform_fit_t(
            [(q0a[:, sl], q1a[:, sl])], err[sl], 10 + j, signed)
        wn = bc6h._bc6h_emit(10 + j, 0, pairs, idx[:, sl], nb, words.device)
        better = errf < best
        best = torch.where(better, errf, best)
        out = torch.where(better[None, :], wn, out)
    return out


def _unit_b(px3, words, signed, remap, cross2, ladder, groups=None):
    """Unit B's launch on its blocks: lane (g, s) per block, job-major
    (lane group 2g + s), then the fold: the bar, then the groups and their
    rows in order. `groups` may override the jobs' results (the fold's
    tie test)."""
    nb = words.shape[1]
    rows, shape, qm, precw = _stored(words, signed)
    tabs = bc67._tables(words.device)
    pp = tabs["pp", 1][shape]
    a2 = tabs["pa", 1][shape] & 0xF
    pm = torch.stack([(pp >> (2 * i)) & 1 for i in range(16)])
    masks = [pm == 0, pm == 1]
    idx2 = torch.stack(bc67._read_indices(words, 82, 3, a2, None)[0]) \
        .to(torch.int32)
    row_groups = bc6h._bc6h_row_groups() if cross2 else [None]
    n = 2 * len(row_groups)
    prec = torch.cat([
        precw if g is None else torch.full(
            (nb,), BC6H_MODE_INFO[g[0]][4][0], dtype=torch.int32)
        for g in row_groups for _ in (0, 1)])
    sub_of = [j % 2 for j in range(n)]
    qmn = {k: v.repeat(1, n) for k, v in qm.items()}
    starts = [_start(qmn, s, precw.repeat(n), prec, signed) for s in (0, 1)]
    lane_sub = torch.cat([torch.full((nb,), s) for s in sub_of])
    q0 = torch.where(lane_sub[None, :] == 1, starts[1][0], starts[0][0])
    q1 = torch.where(lane_sub[None, :] == 1, starts[1][1], starts[0][1])
    mask = torch.cat([masks[s] for s in sub_of], dim=1)
    anchor = torch.cat([a2 if s else torch.zeros_like(a2) for s in sub_of])
    res = groups or _jobs([t.repeat(1, n) for t in px3], mask, q0, q1, prec,
                          anchor, idx2.repeat(1, n), 3, signed, remap,
                          ladder)
    err, q0a, q1a, idx = res

    def lane(t, j):
        return t[..., j * nb:(j + 1) * nb]

    if remap:
        best = _cherr_sum(px3, masks, qm, precw, idx2, 3, signed, (0, 1))
    else:
        best = _cherr_sum(px3, masks, qm, precw, idx2, 3, signed, (0,)) \
            + _cherr_sum(px3, masks, qm, precw, idx2, 3, signed, (1,))
    out = words
    for gi, g in enumerate(row_groups):
        j0, j1 = 2 * gi, 2 * gi + 1
        err_new = torch.zeros(nb) + lane(err, j0) + lane(err, j1)
        pairs_q = [(lane(q0a, j0), lane(q1a, j0)),
                   (lane(q0a, j1), lane(q1a, j1))]
        idx_g = torch.where(masks[1], lane(idx, j1), lane(idx, j0))
        for row in (range(10) if g is None else g):
            errf, pairs = bc6h._bc6h_transform_fit_t(pairs_q, err_new, row,
                                                     signed)
            wn = bc6h._bc6h_emit(row, shape, pairs, idx_g, nb, words.device)
            better = errf < best
            if g is None:
                better = better & (rows == row)
            best = torch.where(better, errf, best)
            out = torch.where(better[None, :], wn, out)
    return out


def _refine_jobs(px, words_i32, ladder, signed, remap, cross2, perm=None):
    """The lane-job form of K6: px [48, NB], words [4, NB] int32 -> words.
    The bucket twin lists each unit's blocks (perm reorders each list, as
    the bucket pass's atomics may); unit A and unit B run on their own
    blocks; reserved blocks pass through."""
    words = bc67._words_i64(words_i32)
    _, buckets = bc6h._unit_buckets_plain(words_i32)
    out = words.clone()
    for unit, blocks in enumerate(buckets[:2]):
        blocks = blocks.to(torch.int64)
        if perm is not None:
            blocks = blocks[torch.from_numpy(perm(len(blocks)))]
        if not len(blocks):
            continue
        px3 = tuple(px[:, blocks].reshape(3, 16, -1))
        w = words[:, blocks]
        out[:, blocks] = (_unit_a(px3, w, signed, remap, ladder) if unit == 0
                          else _unit_b(px3, w, signed, remap, cross2,
                                       ladder))
    return bc67._words_i32(out)


# -- inputs and references ----------------------------------------------------
def _px(blocks, signed):
    return bc6h.px_of_blocks(torch.from_numpy(np.ascontiguousarray(blocks)),
                             signed)


def _i32(words_u32):
    """[NB, 4] u32 (or [NB, 16] u8) -> [4, NB] int32."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(words_u32).view(np.int32).reshape(-1, 4).T))


@pytest.fixture(scope="module")
def batches():
    """Per signed: the refine test's 64 blocks and the 520 unshared ones,
    their words, the JAX refines, the twin's and the job form's."""
    frozen = np.load(GOLDEN / "bc6h_refine_jobs.npz")
    unshared = np.load(GOLDEN / "bc6h_unshared.npz")
    out = {}
    for signed in (False, True):
        p = "s_" if signed else "u_"
        px = torch.cat([_px(frozen[p + "rt_blocks"], signed),
                        _px(unshared[p + "blocks"], signed)], dim=1)
        words = torch.cat([_i32(frozen[p + "rt_words"]),
                           _i32(unshared[p + "search"])], dim=1)
        jax = {"mid": torch.cat([_i32(frozen[p + "rt_mid"]),
                                 _i32(unshared[p + "mid"])], dim=1),
               "maxq": torch.cat([_i32(frozen[p + "rt_maxq"]),
                                  _i32(frozen[p + "maxq"])], dim=1)}
        res = {}
        for tier, (ladder, cross2) in TIERS.items():
            res[tier] = {
                "twin": bc6h._bc6h_refine_plain(px, words, ladder, signed,
                                                True, cross2),
                "jobs": _refine_jobs(px, words, ladder, signed, True,
                                     cross2),
                "jax": jax[tier]}
        out[signed] = (px, words, res)
    return out


# -- the tests -------------------------------------------------------------------
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("tier", list(TIERS))
def test_jobs_equal_twin(batches, signed, tier):
    _, words, res = batches[signed]
    assert torch.equal(res[tier]["jobs"], res[tier]["twin"])
    # both units refined blocks
    moved = (res[tier]["jobs"] != words).any(dim=0)
    rows = bc6h._mode_rows(bc67._words_i64(words))
    assert moved[rows >= 10].any() and moved[rows < 10].any()


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("tier", list(TIERS))
def test_jobs_and_twin_equal_jax(batches, signed, tier):
    _, _, res = batches[signed]
    assert torch.equal(res[tier]["jobs"], res[tier]["jax"])
    assert torch.equal(res[tier]["twin"], res[tier]["jax"])


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("cross2", [False, True])
def test_fixed_index_ladder_jobs_equal_twin(batches, signed, cross2):
    """remap=False: the fixed-index ladder, then one re-assignment kept
    where it scores lower; the bar is sub + sub."""
    px, words, _ = batches[signed]
    px, words = px[:, :128], words[:, :128]
    lad = bc6h.BC6H_LADDER_FULL
    assert torch.equal(
        _refine_jobs(px, words, lad, signed, False, cross2),
        bc6h._bc6h_refine_plain(px, words, lad, signed, False, cross2))


def _with_shape(words, shape):
    """Two-region words with their 5-bit shape field (bits 77-81 in every
    two-region row) set to `shape`."""
    assert all(r[0] != 2 or r[2:] == (77, 5)
               for row in range(10) for r in bc6h._header_runs(row))
    w = bc67._words_i64(words)
    two = bc6h._mode_rows(w).lt(10) & bc6h._mode_rows(w).ge(0)
    lo = (w[2] & ~(0x1F << 13)) | (shape << 13)         # bits 77-81
    w[2] = torch.where(two, lo, w[2])
    return bc67._words_i32(w), two


@pytest.mark.parametrize("tier", list(TIERS))
def test_smallest_subset(batches, tier):
    """Every two-region block recast on shape 8, whose subset 1 has 3
    pixels: a lane whose mask holds 3 of the 16."""
    pm = bc67._tables(torch.device("cpu"))["pp", 1][SMALLEST_SUBSET_SHAPE]
    assert sum((int(pm) >> (2 * i)) & 1 for i in range(16)) == 3
    px, words, _ = batches[False]
    px, words = px[:, :96], words[:, :96]
    words, two = _with_shape(words, SMALLEST_SUBSET_SHAPE)
    assert int(two.sum()) > 20
    ladder, cross2 = TIERS[tier]
    if tier == "maxq":
        ladder = bc6h.BC6H_LADDER_LIGHT       # cross2 at LIGHT depth
    got = _refine_jobs(px, words, ladder, False, True, cross2)
    assert torch.equal(got, bc6h._bc6h_refine_plain(px, words, ladder,
                                                    False, True, cross2))
    assert (got != words)[:, two].any()


def test_reserved_modes_pass_through():
    """Random words: reserved header values pass through both forms."""
    rng = np.random.default_rng(41)
    raw = rng.integers(0, 256, (96, 16), dtype=np.uint8)
    raw[::5, 0] = 0x13                                  # reserved 5-bit 0x13
    words = torch.from_numpy(raw).view(torch.int32).t().contiguous()
    px = _px(rng.random((96, 16, 4)).astype(np.float32) * 4, False)
    rows = bc6h._mode_rows(bc67._words_i64(words))
    reserved = rows < 0
    assert int(reserved.sum()) >= 96 // 5
    lad = bc6h.BC6H_LADDER_MID
    got = _refine_jobs(px, words, lad, False, True, True)
    assert torch.equal(got, bc6h._bc6h_refine_plain(px, words, lad, False,
                                                    True, True))
    assert torch.equal(got[:, reserved], words[:, reserved])


def test_fold_tie_between_groups_keeps_the_earlier():
    """Jobs' results forced equal in every precision group: the fold's
    strict `<` in group order keeps the first group whose row fits, as
    the twin's order does (a later equal error never replaces it)."""
    rng = np.random.default_rng(43)
    blocks = rng.random((32, 16, 4)).astype(np.float32) * 2.0
    px = _px(blocks, False)
    _, words = bc6h._bc6h_search_plain(px, False)
    rows = bc6h._mode_rows(bc67._words_i64(words))
    two = (rows >= 0) & (rows < 10)
    w = bc67._words_i64(words)[:, two]
    px3 = tuple(px[:, two].reshape(3, 16, -1))
    nb = w.shape[1]
    # every group's jobs: zero error, endpoints 0 and 1 in both subsets
    # (fit in every row), the stored indices
    n = 12
    q0 = torch.zeros((3, n * nb), dtype=torch.int32)
    q1 = torch.ones((3, n * nb), dtype=torch.int32)
    _, shape, _, _ = _stored(w, False)
    a2 = bc67._tables(w.device)["pa", 1][shape] & 0xF
    idx = torch.stack(bc67._read_indices(w, 82, 3, a2, None)[0]) \
        .to(torch.int32).repeat(1, n)
    forced = (torch.zeros(n * nb), q0, q1, idx)
    got = _unit_b(px3, w, False, True, True, bc6h.BC6H_LADDER_LIGHT,
                  groups=forced)
    # group 0 (row 0) fits and is first: every block takes row 0
    got_rows = bc6h._mode_rows(got)
    assert bool((got_rows == 0).all())


def test_unit_buckets_plain():
    """The bucket twin: unit 0 rows 10-13, unit 1 rows 0-9, unit 2
    reserved, each list ascending, together every block once."""
    rng = np.random.default_rng(47)
    raw = rng.integers(0, 256, (300, 16), dtype=np.uint8)
    words = torch.from_numpy(raw).view(torch.int32).t().contiguous()
    counts, buckets = bc6h._unit_buckets_plain(words)
    rows = bc6h._mode_rows(bc67._words_i64(words))
    assert counts.tolist() == [len(b) for b in buckets]
    assert sorted(torch.cat(buckets).tolist()) == list(range(300))
    assert bool((rows[buckets[0].long()] >= 10).all())
    assert bool(((rows[buckets[1].long()] >= 0)
                 & (rows[buckets[1].long()] < 10)).all())
    assert bool((rows[buckets[2].long()] < 0).all())
    assert all(torch.equal(b, torch.sort(b)[0]) for b in buckets)
    assert min(counts.tolist()) > 0


def test_bucket_order_changes_nothing(batches):
    """The bucket pass lists blocks in the atomics' order: the job form on
    reversed lists gives the same words."""
    px, words, res = batches[True]
    lad = bc6h.BC6H_LADDER_MID
    got = _refine_jobs(px, words, lad, True, True, False,
                       perm=lambda n: np.arange(n)[::-1].copy())
    assert torch.equal(got, res["mid"]["twin"])
