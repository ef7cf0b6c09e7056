"""K8 as a warp team of rotation jobs and the BC6H shape ranking as four
ranking warps per 32 blocks, in plain form.

The kernels split a block's work and fold or merge the pieces; their
plain forms here are held against the one-fold twins bit for bit and
against the JAX package's outputs:

- K8's five jobs (bc67._single_modes_jobs_plain: mode 4 at index mode 0
  and mode 5 per rotation, mode 6) folded as warp 0 folds them
  (_single_modes_fold_plain) against _single_modes_plain, at alpha
  weights 1.0 and 2.0 on opaque blocks and blocks with alpha, and against
  the JAX package's _try_single_mode words and errors for modes 4, 5 and
  6, frozen in tests/golden/k8_single_modes.npz
  (tests/golden/generate_k8_single_modes.py); the per-mode rotation fold
  under drawn ties (hypothesis) and on the flat blocks' own ties: on an
  equal error the earlier rotation is kept;
- the ranking's four-slice merge (bc6h._bc6h_shapes_slices_plain:
  bc67._top4_merge_plain over the 32-shape table) against
  _bc6h_shapes_plain on random HDR blocks and on the 520 blocks of
  tests/golden/bc6h_unshared.npz, signed and unsigned; the JAX package's
  frozen picks there are met on every block but the two recorded
  summation-order near-ties (462 unsigned, 18 signed); the merge of drawn
  tied estimates puts the lower shape first, at three slices (K5) and
  four (the ranking).

Torch runs on one thread."""

import pathlib
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from directxtex_tpu_torch.bc import bc6h, bc67, cuda_kernels

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
AWS = (1.0, 2.0)
MODES = (4, 5, 6)
# the golden batch: random opaque, random with alpha, flat, albedo (opaque)
# and alphagrad (alpha) crops
CONTENT = {"opaque": np.r_[0:32, 80:96], "alpha": np.r_[32:64, 96:112]}
FLAT = slice(64, 80)
# the recorded blocks of bc6h_unshared.npz whose port picks differ from
# the JAX einsum's (summation-order near-ties; their words are equal)
JAX_MOVED = {False: [462], True: [18]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN / "k8_single_modes.npz")


@pytest.fixture(scope="module")
def k8(golden):
    """Per alpha weight: the jobs' plain form, its fold and the one-fold
    twin, on the golden batch's texels px [64, NB]."""
    px = torch.from_numpy(golden["px"]).reshape(64, -1).contiguous()
    out = {}
    for aw in AWS:
        jobs = bc67._single_modes_jobs_plain(px, aw)
        out[aw] = {"jobs": jobs, "fold": bc67._single_modes_fold_plain(jobs),
                   "twin": bc67._single_modes_plain(px, aw)}
    return out


@pytest.fixture(scope="module")
def unshared():
    return np.load(GOLDEN / "bc6h_unshared.npz")


def _u32(words_4nb):
    """[4, NB] int32 -> [NB, 4] u32."""
    return words_4nb.t().contiguous().numpy().view(np.uint32)


def _marked(values):
    """Words whose first u32 is the job's slot, one column per case."""
    w = torch.zeros((4, len(values)), dtype=torch.int32)
    w[0] = torch.tensor(values, dtype=torch.int32)
    return w


# ---------------------------------------------------------------------------
# K8: the jobs and the fold
# ---------------------------------------------------------------------------

def test_jobs_are_the_kernels_slots():
    """SINGLE_MODES_JOBS in the kernel's slot order (bc7_single_modes.cu's
    SingleSlot), one job a warp."""
    src = (ROOT / "directxtex_tpu_torch" / "csrc" / "bc7_single_modes.cu") \
        .read_text()
    slots = dict(re.findall(r"(kS\w+) = (\d+)",
                            re.search(r"enum SingleSlot \{([^}]*)\}",
                                      src).group(1)))
    jobs = bc67.SINGLE_MODES_JOBS
    assert len(jobs) == int(slots["kSSlots"]) == 9
    for mode, key in ((4, "kS4"), (5, "kS5"), (6, "kS6")):
        assert [j for j, job in enumerate(jobs) if job[0] == mode][0] \
            == int(slots[key])
    assert jobs[:8] == tuple((m, r) for m in (4, 5) for r in range(4))


def test_batch_has_both_contents(golden):
    blocks = golden["blocks"]
    assert (blocks[CONTENT["opaque"], :, 3] == 1.0).all()
    assert (blocks[CONTENT["alpha"], :, 3] < 1.0).any(axis=1).all()


@pytest.mark.parametrize("content", sorted(CONTENT))
@pytest.mark.parametrize("aw", AWS)
def test_jobs_fold_equals_the_twin(k8, aw, content):
    sl = torch.from_numpy(CONTENT[content])
    for m in MODES:
        err, words = k8[aw]["fold"][m]
        ref_err, ref_words = k8[aw]["twin"][m]
        assert err.dtype == torch.float32 and words.dtype == torch.int32
        assert torch.equal(err[sl], ref_err[sl])
        assert torch.equal(words[:, sl], ref_words[:, sl])


@pytest.mark.parametrize("aw", AWS)
@pytest.mark.parametrize("mode", MODES)
def test_jobs_fold_matches_jax(golden, k8, mode, aw):
    err, words = k8[aw]["fold"][mode]
    np.testing.assert_array_equal(err.numpy(),
                                  golden[f"err_m{mode}_aw{aw:g}"])
    np.testing.assert_array_equal(_u32(words),
                                  golden[f"words_m{mode}_aw{aw:g}"])


def test_weight_moves_the_alpha_blocks(golden):
    """Not a vacuous comparison: alpha weight 2.0 changes some mode-4/5
    winners on the blocks with alpha."""
    sl = CONTENT["alpha"]
    assert any((golden[f"words_m{m}_aw1"][sl]
                != golden[f"words_m{m}_aw2"][sl]).any() for m in (4, 5))


@pytest.mark.parametrize("aw", AWS)
def test_rotation_fold_on_tied_flat_blocks(k8, aw):
    """Flat blocks reach the same least error at several rotations, with
    other words; the fold keeps the first of them."""
    jobs, fold = k8[aw]["jobs"], k8[aw]["fold"]
    n_tied = 0
    for m, first in ((4, 0), (5, 4)):
        errs = torch.stack([jobs[first + r][0] for r in range(4)])[:, FLAT]
        least = errs.min(dim=0).values
        for b in range(FLAT.stop - FLAT.start):
            rots = [r for r in range(4) if errs[r, b] == least[b]]
            blk = FLAT.start + b
            assert torch.equal(fold[m][1][:, blk],
                               jobs[first + rots[0]][1][:, blk])
            if len(rots) > 1 and any(
                    not torch.equal(jobs[first + r][1][:, blk],
                                    jobs[first + rots[0]][1][:, blk])
                    for r in rots[1:]):
                n_tied += 1
    assert n_tied >= 3


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.lists(st.lists(st.sampled_from([0.0, 1.0, 2.0, 4.0]),
                         min_size=9, max_size=9), min_size=24, max_size=24))
def test_rotation_fold_under_drawn_ties(cases):
    """Jobs' errors drawn from four values, so that rotations tie often:
    modes 4 and 5 each take the first rotation of least error, mode 6 its
    one job as it is."""
    n = len(cases)
    jobs = [(torch.tensor([c[j] for c in cases], dtype=torch.float32),
             _marked([j] * n)) for j in range(9)]
    out = bc67._single_modes_fold_plain(jobs)
    for b, c in enumerate(cases):
        for m, first in ((4, 0), (5, 4)):
            want = min(range(4), key=lambda r: (c[first + r], r)) + first
            assert int(out[m][1][0, b]) == want
            assert float(out[m][0][b]) == c[want]
        assert int(out[6][1][0, b]) == 8 and float(out[6][0][b]) == c[8]


# ---------------------------------------------------------------------------
# the ranking: four slices merged
# ---------------------------------------------------------------------------

def _random_px(signed: bool) -> torch.Tensor:
    """64 random HDR blocks, 16 with a dominant two-region split: px [48,
    NB] F16-ints."""
    rng = np.random.default_rng(7 + signed)
    scale, off = (4.0, -2.0) if signed else (8.0, 0.0)
    rgb = rng.random((80, 16, 3)).astype(np.float32) * scale + off
    rgb[64:, 8:] *= 0.05
    blocks = np.concatenate([rgb, np.ones((80, 16, 1), np.float32)], -1)
    return bc6h.px_of_blocks(torch.from_numpy(blocks), signed)


@pytest.mark.parametrize("signed", [False, True])
def test_slices_merge_equals_the_ranking_on_random_blocks(signed):
    px = _random_px(signed)
    got = bc6h._bc6h_shapes_slices_plain(px)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, 80)
    assert torch.equal(got, bc6h._bc6h_shapes_plain(px))


@pytest.mark.parametrize("signed", [False, True])
def test_slices_merge_equals_the_ranking_on_unshared_blocks(unshared,
                                                            signed):
    pre = "s_" if signed else "u_"
    px = bc6h.px_of_blocks(torch.from_numpy(unshared[pre + "blocks"]),
                           signed)
    got = bc6h._bc6h_shapes_slices_plain(px)
    assert torch.equal(got, bc6h._bc6h_shapes_plain(px))
    # the JAX package's frozen picks, met on every block but the recorded
    # near-tie
    moved = np.nonzero((got.numpy() != unshared[pre + "picks"])
                       .any(axis=0))[0].tolist()
    assert moved == JAX_MOVED[signed]


@pytest.mark.parametrize("n_slices", [3, 4])
@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(st.lists(st.lists(st.sampled_from([0.0, 0.5, 1.0, 3.0]),
                         min_size=32, max_size=32), min_size=16,
                max_size=16))
def test_merge_of_drawn_tied_estimates(n_slices, cases):
    """Estimates of the 32 shapes drawn from four values, so that shapes
    tie across and within slices: the merge of n_slices slices gives the
    top 4 by (estimate, shape), the lower shape first on an equal
    estimate, which is _top_k_shapes's argmin order."""
    ests = torch.tensor(cases, dtype=torch.float32).t().contiguous()
    got = torch.stack(bc67._top4_merge_plain(ests, n_slices))
    assert torch.equal(got, torch.stack(bc67._top_k_shapes(ests, 4)))
    for b, c in enumerate(cases):
        want = sorted(range(32), key=lambda s: (c[s], s))[:4]
        assert got[:, b].tolist() == want


def test_cpu_wrappers_take_the_plain_forms(golden):
    """On CPU tensors the wrappers run the plain twins, which the team
    forms equal, and launch nothing."""
    px8 = torch.from_numpy(golden["px"][..., :8].copy()).reshape(64, -1) \
        .contiguous()
    pxh = _random_px(False)[:, :8].contiguous()
    cuda_kernels.reset_launch_counts()
    out = bc67.bc7_single_modes(px8, 2.0)
    picks = bc6h.bc6h_shape_picks(pxh)
    assert set(cuda_kernels.launch_counts().values()) == {0}
    fold = bc67._single_modes_fold_plain(
        bc67._single_modes_jobs_plain(px8, 2.0))
    for m in MODES:
        assert torch.equal(out[m][0], fold[m][0])
        assert torch.equal(out[m][1], fold[m][1])
    assert torch.equal(picks, bc6h._bc6h_shapes_slices_plain(pxh))
