"""USE_3SUBSETS (BC7 modes 0 and 2) of the PyTorch port — the plain twins
of kernels K9 (shape ranking), K7 (partition-mode evaluation) and K3's
three-subset instances — held against the JAX package's jnp path on the
same pixels: the three-subset estimate table and its top-4 picks over 16
and 64 shapes, modes 0 and 2 on given candidates, the search with modes 0
and 2 folded first, the MOMENT and LADDER_FULL refines with modes 0 and 2
in scope, and the whole encode_bc7 with flags 0x80000 and 0x280000, with
and without alpha, at alpha weights 1.0 and 2.0.

K9's picks and K7's evaluation are tested apart (K7 takes the JAX picks),
so that a moved pick cannot hide an evaluation fault. Everything else is
compared word for word, and K7's errors bit for bit. The JAX outputs are
frozen in tests/golden/bc7_3subsets.npz by
tests/golden/generate_bc7_3subsets.py (its eager JAX calls take about
45 s on a CPU): one batch of 256 blocks, 64 synthetic blocks (each a
three-subset shape whose subsets are gradients along their own
directions, where modes 0 and 2 win), 32x32 crops of albedo and
photo_china, and a 32x32 crop of alphagrad. Torch runs on one thread."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu.bc.bc67_tables import PARTITIONS
from directxtex_tpu_torch.bc import bc67, cuda_kernels
from test_bc7 import img_blocks, rgba_psnr
from test_torch_bc7_alpha import _modes_of, _px
from test_torch_bc7_encode import _words_u32

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
USE3 = 0x80000
MAXQ = 0x200000
QUICK = 0x100000
AWS = (1.0, 2.0)
FLAGS = (USE3, USE3 | MAXQ)
SYNTH = slice(0, 64)          # the synthetic blocks in the batch
OPAQUE = slice(64, 192)       # the albedo and photo_china crops
# the port sums the estimate table in pixel order, the JAX package with an
# einsum: the two differ in the last bits of each masked sum (ROADMAP.md
# queue 3 records 0.031 on the two-subset table), never in a pick here
TABLE_ATOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sub3():
    """The batch (blocks [256, 16, 4], px [16, 4, 256] i32) and the frozen
    JAX outputs."""
    ref = dict(np.load(GOLDEN / "bc7_3subsets.npz"))
    ref["px"] = _px(ref["blocks"])
    return ref


def _key(flags, aw):
    return f"{'maxq' if flags & MAXQ else 'default'}_aw{aw:g}"


def _px64(px):
    return torch.from_numpy(px).reshape(64, px.shape[2]).contiguous()


def _nb4(words_u32):
    return torch.from_numpy(np.array(words_u32, np.uint32).view(np.int32))


def test_search_tuples_equal_jax():
    """encode_bc7's mode lists with USE_3SUBSETS (bc67.py:1958-1970)."""
    assert bc67.SEARCH_MODES_3 == (0, 2, 1, 3, 5, 6, 4)
    assert bc67.SEARCH_MODES_3_ALPHA == (0, 2, 1, 3, 5, 6, 7, 4)
    assert bc67.REFINE_MODES_3 == (0, 2, 1, 3, 5, 4)
    assert bc67.REFINE_MODES_3_ALPHA == (0, 2, 1, 3, 5, 7, 4)
    assert jbc67._BC7_USE_3SUBSETS == USE3


def test_three_subset_tables():
    """The partition ids, anchors and per-shape index layouts of the
    three-subset shapes on the device: modes 0 (3-bit) and 2 (2-bit)."""
    tabs = bc67._tables(torch.device("cpu"))
    np.testing.assert_array_equal(tabs["parts2"].numpy(), PARTITIONS[2])
    np.testing.assert_array_equal(tabs["fix2"].numpy(), jbc67.FIXUPS[2])
    last_is_anchor = np.any(jbc67.FIXUPS[2][:, 1:] == 15, axis=1)
    for prec in (3, 2):
        offs = tabs["offs", 2, prec].numpy()
        # three anchors are written one bit short
        assert np.all(offs[:, 15] + prec - last_is_anchor == 16 * prec - 3)


def test_shape_table_matches_jax(sub3):
    pxf = torch.from_numpy(sub3["px"]).to(torch.float32)
    got = bc67._shape_estimates_table(pxf, partitions=2).numpy()
    ref = sub3["table"]
    assert got.shape == ref.shape == (64, 256)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TABLE_ATOL)
    # the first 16 shapes' estimates do not depend on the table's size
    np.testing.assert_array_equal(
        bc67._shape_estimates_table(pxf, 16, partitions=2).numpy(), got[:16])


@pytest.mark.parametrize("n_shapes", [16, 64])
def test_partition_shapes_twin_picks_equal_jax(sub3, n_shapes):
    """K9's twin: the top 4 of the first n_shapes three-subset shapes
    (mode 0 ranks 16, its 4-bit partition field's; mode 2 all 64)."""
    got = bc67.bc7_partition_shapes(_px64(sub3["px"]), 2, n_shapes, 4)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, 256)
    np.testing.assert_array_equal(got.numpy(), sub3[f"picks{n_shapes}"])
    # the frozen picks are the JAX top-k of the frozen table
    ref = jbc67._top_k_shapes(jnp.asarray(sub3["table"][:n_shapes]), 4)
    np.testing.assert_array_equal(np.stack([np.asarray(r) for r in ref]),
                                  sub3[f"picks{n_shapes}"])


@pytest.mark.parametrize("mode", [0, 2])
def test_partition_mode_twin_equals_jax(sub3, mode):
    """K7's twin on the JAX package's own picks: mode 0 or 2's error bit
    for bit and words word for word."""
    s_blks = torch.from_numpy(sub3["picks16" if mode == 0 else "picks64"])
    err, words = bc67.bc7_partition_mode(_px64(sub3["px"]), s_blks, mode)
    np.testing.assert_array_equal(_words_u32(words),
                                  sub3[f"mode{mode}_words"])
    np.testing.assert_array_equal(err.numpy(), sub3[f"mode{mode}_err"])


@pytest.mark.parametrize("mode", [0, 2, 1, 7])
def test_try_partition_mode_is_k9_then_k7(sub3, mode):
    """_try_partition_mode = K9's twin, then K7's twin (modes 1 and 7 on
    the two-subset ranking, unchanged by the split)."""
    px = sub3["px"][..., :64]
    pt = torch.from_numpy(px)
    ptf = pt.to(torch.float32)
    parts = 2 if mode in (0, 2) else 1
    n = 16 if mode == 0 else 64
    ests = bc67._shape_estimates_table(ptf, partitions=parts)
    err, words = bc67._try_partition_mode(pt, ptf, mode, ests)
    p64 = _px64(px)
    s_blks = bc67.bc7_partition_shapes(p64, parts, n)
    err_k, words_k = bc67.bc7_partition_mode(p64, s_blks, mode)
    assert torch.equal(err, err_k)
    assert torch.equal(bc67._words_i32(words), words_k)


@pytest.mark.parametrize("flags", FLAGS, ids=["use3", "use3_maxq"])
def test_search_equals_jax(sub3, flags):
    """The search with modes 0 and 2 folded first, both tiers: the words
    the JAX search hands to its first refine."""
    tier = bc67.TIER_MAXQ if flags & MAXQ else bc67.TIER_DEFAULT
    err, words = bc67.bc7_search_words(_px64(sub3["px"]),
                                       bc67.SEARCH_MODES_3_ALPHA, 1.0, tier)
    np.testing.assert_array_equal(_words_u32(words),
                                  sub3[_key(flags, 1.0) + "_search"])
    assert bool(torch.isfinite(err).all())


@pytest.mark.parametrize("flags", FLAGS, ids=["use3", "use3_maxq"])
def test_modes_0_and_2_win_blocks(sub3, flags):
    """The batch exercises the modes: each of 0 and 2 wins blocks of the
    search, most of them on the synthetic content."""
    modes = _modes_of(sub3[_key(flags, 1.0) + "_search"])
    for m in (0, 2):
        assert np.sum(modes == m) > 0, m
    assert np.sum(np.isin(modes[SYNTH], (0, 2))) > 32


@pytest.mark.parametrize("stage", ["default_moment", "maxq_moment",
                                   "maxq_full"])
def test_refine_with_modes_0_and_2_equals_jax(sub3, stage):
    """K3's twin with modes 0 and 2 in scope, from the words the JAX
    encode handed to that refine: the words it got back, and blocks of
    modes 0 and 2 among those that moved (each mode under MOMENT)."""
    key = _key(USE3 if stage == "default_moment" else USE3 | MAXQ, 1.0)
    maxq = stage != "default_moment"
    words_in = sub3[key + ("_moment" if stage == "maxq_full" else "_search")]
    want = (sub3[key + "_moment"] if stage == "maxq_moment" else
            sub3[key + "_encoded"].view(np.uint32).reshape(-1, 4))
    ladder = bc67.LADDER_FULL if stage == "maxq_full" else bc67.LADDER_MOMENT
    modes = bc67.SEARCH_MODES_3_ALPHA if maxq else bc67.REFINE_MODES_3_ALPHA
    got = bc67.refine_bc7_words(torch.from_numpy(sub3["px"]),
                                _nb4(words_in), ladder, modes=modes)
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    moved = np.any(got != words_in, axis=1)
    win = _modes_of(words_in)
    assert np.any(moved & np.isin(win, (0, 2)))
    if ladder == bc67.LADDER_MOMENT:
        for m in (0, 2):
            assert np.any(moved & (win == m)), m


def test_refine_modes_0_and_2_alone_at_weight_two(sub3):
    """_refine_mode_subsets for modes 0 and 2 alone (K3's three-subset
    instance's scope) at alpha weight 2.0, MOMENT then LADDER_LIGHT, from
    the weight-2.0 search's words: the JAX refine's words."""
    words = sub3["default_aw2_search"]
    for name, ladder in (("moment", bc67.LADDER_MOMENT),
                         ("light", bc67.LADDER_LIGHT)):
        got = bc67.refine_bc7_words(torch.from_numpy(sub3["px"]),
                                    _nb4(words), ladder, 2.0, (0, 2))
        want = sub3[f"alone_aw2_{name}"]
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        assert np.any(want != words)
        words = want


@pytest.mark.parametrize("aw", AWS)
@pytest.mark.parametrize("flags", FLAGS, ids=["use3", "use3_maxq"])
def test_encode_equals_jax(sub3, flags, aw):
    """encode_bc7 on the batch (blocks with alpha: mode 7 searched and in
    scope) and on its opaque crops alone (mode 7 dropped by the host
    check): the JAX package's words."""
    blocks = torch.from_numpy(sub3["blocks"])
    want = sub3[_key(flags, aw) + "_encoded"]
    got = bc67.encode_bc7(blocks, flags=flags, alpha_weight=aw).numpy()
    np.testing.assert_array_equal(got, want)
    opaque = bc67.encode_bc7(blocks[OPAQUE], flags=flags,
                             alpha_weight=aw).numpy()
    np.testing.assert_array_equal(opaque, want[OPAQUE])


def test_quick_with_3subsets_is_quick(sub3):
    """QUICK|USE_3SUBSETS searches mode 6 alone (bc67.py:1955)."""
    blocks = torch.from_numpy(sub3["blocks"][::4])
    assert torch.equal(bc67.encode_bc7(blocks, flags=QUICK | USE3),
                       bc67.encode_bc7(blocks, flags=QUICK))


def test_img_blocks_psnr_floor():
    """tests/test_bc7.py:240-244's floor for the flag: > 36 dB."""
    blocks = img_blocks()
    enc = bc67.encode_bc7(torch.from_numpy(blocks), flags=USE3)
    dec = bc67.decode_bc7(enc).numpy()
    assert rgba_psnr(dec, blocks) > 36


def test_cpu_search_launches_nothing(sub3):
    cuda_kernels.reset_launch_counts()
    p64 = _px64(sub3["px"][..., :32])
    bc67.bc7_search_words(p64, bc67.SEARCH_MODES_3)
    s = bc67.bc7_partition_shapes(p64, 2, 64)
    bc67.bc7_partition_mode(p64, s, 2)
    assert set(cuda_kernels.launch_counts().values()) == {0}
