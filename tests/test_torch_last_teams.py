"""K10 (BC6H rows 10-13) and K2 quick (BC7 mode 6 alone), the last two
kernels of one thread a block, in plain form, and the instruction counter
their measurements rest on.

The JAX package's outputs are frozen in tests/golden/last_teams.npz
(tests/golden/generate_last_teams.py), so this file runs no JAX:

- K10: the twin (bc6h._bc6h_1region_plain: the rows' results,
  bc6h._bc6h_1region_rows_plain, folded as the kernel folds them, row 10
  taken as it is and rows 11-13 by the strict `<`) and its wrapper on a
  CPU tensor, word for word and error for error against the JAX
  package's _k_bc6h_1region, unsigned and signed, on random HDR
  (sign-crossing where signed), flat blocks (all four rows tie on the
  zero blocks), values at 0x7BFF and blocks on which no row fits (row
  10's words survive);
- K2 quick: the twin (bc67._bc7_search_plain(px, SEARCH_MODES_QUICK)),
  the maxq team's mode-6 job in plain form (bc67._mode6_job_plain: the
  fit in one pass at one subset) and encode_bc7(flags=QUICK) against the
  JAX package's encode_bc7(0x100000) at alpha weights 1.0 and 2.0, on
  flat blocks (the box with no extent), two-colour blocks, full-range
  alpha and blocks whose first index has bit 3 set before the anchor
  swap;
- chip_ab.py's count of issued instructions from SASS (loops times their
  trip counts, the longest or shortest path over forward branches) on a
  small listing.

Torch runs on one thread."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc6h, bc67, cuda_kernels

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
SIGNED = (False, True)
AWS = (1.0, 2.0)
QUICK = 0x100000
# the golden batches (generate_last_teams.py)
K10_ZERO = slice(200, 204)            # flat zero blocks
K10_F16MAX = slice(204, 208)          # flat 0x7BFF
K10_TWO_LEVEL = slice(216, 232)       # 0x7BFF and the far end
K10_TOP = slice(232, 264)             # near the int16 top: no row fits
Q_FLAT = slice(64, 80)
Q_TWO = slice(80, 96)
Q_FULL_ALPHA = slice(96, 112)
Q_GRAD = slice(112, 128)
Q_ALPHA = np.r_[32:64, 96:112, 144:176]   # blocks with alpha


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN / "last_teams.npz")


@pytest.fixture(scope="module")
def k10(golden):
    """Per signed: px, the rows' results and the twin."""
    out = {}
    for signed in SIGNED:
        px = torch.from_numpy(golden[_pre(signed) + "px"])
        out[signed] = {"px": px,
                       "rows": bc6h._bc6h_1region_rows_plain(px, signed),
                       "twin": bc6h._bc6h_1region_plain(px, signed)}
    return out


@pytest.fixture(scope="module")
def quick(golden):
    """The golden blocks' texels px [64, NB] and, per alpha weight, the
    twin and the mode-6 job in plain form."""
    blocks = torch.from_numpy(golden["blocks"])
    px = bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()
    out = {"blocks": blocks, "px": px}
    for aw in AWS:
        out[aw] = {"twin": bc67._bc7_search_plain(
            px, bc67.SEARCH_MODES_QUICK, aw),
            "job": bc67._mode6_job_plain(px, aw)}
    return out


def _pre(signed):
    return "s_" if signed else "u_"


def _u32(words_4nb):
    """[4, NB] int32 -> [4, NB] u32."""
    return words_4nb.numpy().view(np.uint32)


def _bytes(words_4nb):
    """[4, NB] int32 -> [NB, 16] u8, encode_bc7's layout."""
    return words_4nb.t().contiguous().numpy().view(np.uint8)


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

def test_k10_rows_are_rows_10_to_13():
    assert bc6h.ONE_REGION_ROWS == (10, 11, 12, 13)
    assert all(bc6h.BC6H_MODE_INFO[r][1] == 0
               for r in bc6h.ONE_REGION_ROWS)


@pytest.mark.parametrize("signed", SIGNED)
def test_k10_twin_equals_jax(k10, golden, signed):
    err, words = k10[signed]["twin"]
    np.testing.assert_array_equal(_u32(words),
                                  golden[_pre(signed) + "k10_words"])
    np.testing.assert_array_equal(err.numpy(),
                                  golden[_pre(signed) + "k10_err"])


@pytest.mark.parametrize("signed", SIGNED)
def test_k10_wrapper_on_cpu_equals_jax(k10, golden, signed):
    err, words = bc6h.bc6h_1region_words(k10[signed]["px"], signed)
    np.testing.assert_array_equal(_u32(words),
                                  golden[_pre(signed) + "k10_words"])
    np.testing.assert_array_equal(err.numpy(),
                                  golden[_pre(signed) + "k10_err"])


@pytest.mark.parametrize("signed", SIGNED)
def test_k10_no_row_fits_keeps_row_10(k10, signed):
    """Blocks near the top of the int16 range: where every row reads inf,
    the fold keeps row 10's words (the JAX package's too)."""
    rows = k10[signed]["rows"]
    err, words = k10[signed]["twin"]
    none_fit = torch.stack([e for e, _ in rows]).isinf().all(dim=0)
    assert int(none_fit[K10_TOP].sum()) >= 16
    assert not bool(none_fit[:K10_TOP.start].any())
    assert bool(err[none_fit].isinf().all())
    assert torch.equal(words[:, none_fit], rows[0][1][:, none_fit])


@pytest.mark.parametrize("signed", SIGNED)
def test_k10_tie_keeps_the_earlier_row(k10, signed):
    """On a tie in error the earlier row's words stay: the zero blocks
    score 0 in every row, and each row writes its own mode."""
    rows = k10[signed]["rows"]
    err, words = k10[signed]["twin"]
    for e, _ in rows:
        assert bool((e[K10_ZERO] == 0).all())
    assert not torch.equal(rows[0][1][:, K10_ZERO], rows[3][1][:, K10_ZERO])
    assert torch.equal(words[:, K10_ZERO], rows[0][1][:, K10_ZERO])
    errs = torch.stack([e for e, _ in rows])
    first = torch.argmax((errs == errs.min(dim=0).values).to(torch.int8),
                         dim=0)
    fin = torch.isfinite(err)
    picked = torch.stack([w for _, w in rows])[first, :,
                                               torch.arange(err.shape[0])].t()
    assert torch.equal(words[:, fin], picked[:, fin])


@pytest.mark.parametrize("signed", SIGNED)
def test_k10_content(k10, signed):
    """0x7BFF blocks in the batch, and (signed) sign-crossing blocks."""
    px = k10[signed]["px"]
    assert bool((px[:, K10_F16MAX] == 0x7BFF).all())
    assert bool((px[:, K10_TWO_LEVEL] == 0x7BFF).any(dim=0).all())
    if signed:
        crossing = (px[:, :200] < 0).any(dim=0) & (px[:, :200] > 0).any(dim=0)
        assert int(crossing.sum()) >= 40
    else:
        assert bool((px[:, :232] >= 0).all())


def test_k10_launcher_takes_cuda_tensors_only(k10):
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.bc6h_1region(k10[False]["px"], False)


# ---------------------------------------------------------------------------
# K2 quick
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aw", AWS)
def test_quick_twin_equals_jax(quick, golden, aw):
    _, words = quick[aw]["twin"]
    np.testing.assert_array_equal(_bytes(words), golden[f"quick_aw{aw:g}"])


@pytest.mark.parametrize("aw", AWS)
def test_quick_mode6_job_equals_twin(quick, aw):
    err, words = quick[aw]["job"]
    e_t, w_t = quick[aw]["twin"]
    assert torch.equal(words, w_t)
    assert torch.equal(err, e_t)


@pytest.mark.parametrize("aw", AWS)
def test_encode_bc7_quick_equals_jax(quick, golden, aw):
    got = bc67.encode_bc7(quick["blocks"], QUICK, alpha_weight=aw)
    np.testing.assert_array_equal(got.numpy(), golden[f"quick_aw{aw:g}"])


def test_quick_wrapper_on_cpu_is_the_twin(quick):
    err, words = bc67.bc7_search_words(quick["px"], bc67.SEARCH_MODES_QUICK)
    e_t, w_t = quick[1.0]["twin"]
    assert torch.equal(words, w_t) and torch.equal(err, e_t)


def test_quick_launcher_takes_cuda_tensors_only(quick):
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.bc7_encode(quick["px"], bc67.SEARCH_MODES_QUICK)


def test_quick_flat_and_two_colour_content(quick):
    px = quick["px"].reshape(16, 4, -1)
    flat = px[:, :, Q_FLAT]
    assert bool((flat == flat[:1]).all())            # no extent: fab = 0
    two = px[:, :, Q_TWO]
    for b in range(two.shape[2]):
        assert len({tuple(p) for p in two[:, :, b].tolist()}) == 2


def test_quick_full_range_alpha(quick):
    alpha = quick["px"].reshape(16, 4, -1)[:, 3, Q_FULL_ALPHA]
    assert bool((alpha.min(dim=0).values == 0).all())
    assert bool((alpha.max(dim=0).values == 255).all())


@pytest.mark.parametrize("aw", AWS)
def test_quick_gradients_take_the_anchor_swap(quick, aw):
    """Pixel 0's index has bit 3 set before the anchor swap on every
    descending gradient; the words store it inverted."""
    px_i = quick["px"].reshape(16, 4, -1)
    nb = px_i.shape[2]
    sid = torch.zeros((16, nb), dtype=torch.int64)
    *_, idx = bc67._fit_ns_plain(px_i, px_i.to(torch.float32), sid, 1, 6,
                                 aw)
    assert bool((idx[0, Q_GRAD] & 8 != 0).all())
    # the stored index of pixel 0 (bits 65-67) is the inverted one
    _, words = quick[aw]["twin"]
    first = (bc67._words_i64(words)[2, Q_GRAD] >> 1) & 7
    assert torch.equal(first, 15 - idx[0, Q_GRAD])


def test_quick_alpha_weight_moves_words(quick):
    w1, w2 = quick[1.0]["twin"][1], quick[2.0]["twin"][1]
    moved = (w1 != w2).any(dim=0)
    assert bool(moved[Q_ALPHA].any())
    opaque = np.setdiff1d(np.arange(w1.shape[1]), Q_ALPHA)
    opaque = opaque[(quick["px"].reshape(16, 4, -1)[:, 3, opaque] == 255)
                    .all(dim=0).numpy()]
    assert not bool(moved[opaque].any())


# ---------------------------------------------------------------------------
# chip_ab.py's issued-instruction count
# ---------------------------------------------------------------------------

LISTING = """\t\tFunction : _Z4testv
        /*0000*/                   MOV R1, R2 ;   /* 0x0 */
                                                  /* 0x0 */
        /*0010*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0020*/               @P0 BRA 0x40 ;
        /*0030*/                   FADD R1, R1, R1 ;
        /*0040*/               @P1 BRA 0x10 ;
        /*0050*/                   EXIT ;
        /*0060*/                   BRA 0x60 ;
"""


@pytest.fixture(scope="module")
def chip_ab():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_ab
    finally:
        sys.path.remove(str(ROOT))
    return chip_ab


def test_sass_loops(chip_ab):
    funcs = chip_ab.sass_functions(LISTING)
    ins = chip_ab.sass_instructions(funcs["_Z4testv"])
    assert [pc for pc, _ in ins] == [0, 16, 32, 48, 64, 80, 96]
    assert chip_ab.sass_loops(ins) == [(1, 4)]


@pytest.mark.parametrize("longest, want", [(True, 1 + 3 * 4 + 1),
                                           (False, 1 + 3 * 3 + 1)])
def test_sass_path_count(chip_ab, longest, want):
    ins = chip_ab.sass_instructions(
        chip_ab.sass_functions(LISTING)["_Z4testv"])
    assert chip_ab.sass_path_count(ins, (3,), longest) == want
    with pytest.raises(ValueError):
        chip_ab.sass_path_count(ins, (), longest)
