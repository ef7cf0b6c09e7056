"""The plain versions behind the redesigned K2 opaque and K3 kernels.

K3's launcher sorts the in-scope blocks into one bucket per winner mode
(`bc67._mode_buckets_plain` is the bucket pass's plain twin) and refines
each bucket in a launch of its own; that gives the words of one refine
over the whole scope because a scope's refine is the single-mode refines
applied one after another, in any order. K2's opaque search ranks the 64
shapes in four warps' slices and merges their local top 4s
(`bc67._top4_merge_plain`), which must give `_top_k_shapes`'s picks.
Small sets, torch on one thread; the JAX package's `_top_k_shapes` takes
the same estimates as a numpy array (the refines are held against the
JAX package in test_torch_bc7_encode.py, _alpha.py, _maxq.py and
_3subsets.py)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu_torch.bc import bc67

torch.set_num_threads(1)

SCOPES = {"default": bc67.REFINE_MODES, "alpha": bc67.REFINE_MODES_ALPHA,
          "maxq": bc67.SEARCH_MODES_ALPHA,
          "sub3": (0, 2) + bc67.REFINE_MODES}


def _random_words(nb, seed):
    """Random u32 words; byte 0 takes every mode's lowest bit, and 0 (the
    reserved mode) on every ninth block."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-2**31, 2**31, (4, nb), dtype=np.int64)
    w[0, ::9] &= ~0xFF
    return torch.from_numpy(w.astype(np.int32))


@pytest.mark.parametrize("mask", [0b00111010, 0b10111010, 0b11111010,
                                  0xFF])
def test_mode_buckets_plain_against_numpy(mask):
    words = _random_words(300, mask)
    counts, buckets = bc67._mode_buckets_plain(words, mask)
    b0 = words[0].numpy().astype(np.int64) & 0xFF
    mode = np.where(b0 == 0, 8,
                    np.array([(int(x) & -int(x)).bit_length() - 1
                              for x in b0]))
    assert counts.dtype == torch.int32 and tuple(counts.shape) == (8,)
    for m in range(8):
        want = np.nonzero(mode == m)[0] if (mask >> m) & 1 else []
        assert counts[m] == len(want)
        assert buckets[m].dtype == torch.int32
        assert np.array_equal(buckets[m].numpy(), np.asarray(want))
    assert int(counts.sum()) <= 300 - len(range(0, 300, 9))


def test_mode_buckets_plain_reserved_and_empty():
    words = _random_words(40, 7)
    words[0] &= ~0xFF                              # every block reserved
    counts, buckets = bc67._mode_buckets_plain(words, 0xFF)
    assert counts.tolist() == [0] * 8
    assert all(len(b) == 0 for b in buckets)
    counts, buckets = bc67._mode_buckets_plain(
        torch.zeros((4, 0), dtype=torch.int32), 0xFF)
    assert counts.tolist() == [0] * 8
    assert all(len(b) == 0 for b in buckets)


@pytest.fixture(scope="module")
def every_mode():
    """64 noisy blocks, half with alpha, block i encoded in mode i % 8 by
    the plain twins of K7 (modes 0-3, 7) and K8 (modes 4-6): every mode
    has 8 winners to refine."""
    rng = np.random.default_rng(23)
    blocks = rng.random((64, 16, 4)).astype(np.float32)
    blocks[::2, :, 3] = 1.0
    x = np.linspace(0, 1, 16, dtype=np.float32)
    blocks[1::4, :, :3] = (0.2 + 0.6 * x[:, None]
                           + 0.05 * blocks[1::4, :, :3])
    px = bc67._quantize_ldr(torch.from_numpy(blocks)).reshape(64, -1) \
        .contiguous()
    picks = {key: bc67._partition_shapes_plain(px, *key, 4)
             for key in ((2, 16), (2, 64), (1, 64))}
    enc = {m: bc67._partition_mode_plain(
        px, picks[(2, 16) if m == 0 else (2, 64) if m == 2 else (1, 64)],
        m)[1] for m in (0, 1, 2, 3, 7)}
    enc.update({m: r[1] for m, r in bc67._single_modes_plain(px).items()})
    sel = torch.arange(64) % 8
    words = torch.zeros((4, 64), dtype=torch.int32)
    for m, w in enc.items():
        words = torch.where(sel[None, :] == m, w, words)
    counts, _ = bc67._mode_buckets_plain(words, 0xFF)
    assert counts.tolist() == [8] * 8
    return px, words


@pytest.mark.parametrize("ladder", [bc67.LADDER_MOMENT, bc67.LADDER_LIGHT],
                         ids=["moment", "light"])
@pytest.mark.parametrize("scope", list(SCOPES), ids=list(SCOPES))
def test_scope_refine_is_single_mode_refines_in_any_order(every_mode, scope,
                                                          ladder):
    """What the bucketed K3 relies on: the refine over a scope equals the
    single-mode refines applied one after another, forwards, backwards
    and interleaved, and each block is moved by its own mode's refine
    alone."""
    px, words = every_mode
    modes = SCOPES[scope]
    whole = bc67._bc7_refine_plain(px, words, modes, 1.0, ladder)
    assert (whole != words).any(dim=0).sum() > 0
    singles = {m: bc67._bc7_refine_plain(px, words, (m,), 1.0, ladder)
               for m in modes}
    sel = torch.arange(64) % 8
    for m, w in singles.items():
        assert torch.equal(w[:, sel != m], words[:, sel != m])
        assert torch.equal(w[:, sel == m], whole[:, sel == m])
    for order in (modes, modes[::-1], modes[1::2] + modes[::2]):
        seq = words
        for m in order:
            seq = bc67._bc7_refine_plain(px, seq, (m,), 1.0, ladder)
        assert torch.equal(seq, whole), order


def _estimates(seed):
    rng = np.random.default_rng(seed)
    blocks = rng.random((48, 16, 4)).astype(np.float32)
    blocks[:16, :, :3] = blocks[:16, :1, :3] * 0.5 + blocks[:16, :, :3] * 0.1
    blocks[..., 3] = 1.0
    px = bc67._quantize_ldr(torch.from_numpy(blocks))
    return bc67._shape_estimates_table(px.to(torch.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_top4_merge_plain_on_the_estimates_table(seed):
    """The slice-and-merge picks are _top_k_shapes's on the twin's table,
    and the JAX package's _top_k_shapes agrees on the same numbers."""
    ests = _estimates(seed)
    merged = bc67._top4_merge_plain(ests, n_slices=4)
    ref = bc67._top_k_shapes(ests, 4)
    jref = jbc67._top_k_shapes(jnp.asarray(ests.numpy()), 4)
    for a, b, c in zip(merged, ref, jref):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.lists(st.integers(0, 3), min_size=64 * 3, max_size=64 * 3),
       st.sampled_from([1, 2, 4, 8]))
def test_top4_merge_plain_with_equal_estimates(values, n_slices):
    """Estimates drawn from four values tie within and across slices: the
    merge keeps the lower shape first, as _top_k_shapes does."""
    ests = torch.tensor(values, dtype=torch.float32).reshape(64, 3)
    merged = bc67._top4_merge_plain(ests, n_slices=n_slices)
    ref = bc67._top_k_shapes(ests, 4)
    for a, b in zip(merged, ref):
        assert torch.equal(a, b)
    picks = torch.stack(merged)
    for j in range(3):
        assert len(set(picks[:, j].tolist())) == 4
    pairs = itertools.pairwise(range(4))
    for k, k1 in pairs:
        e, e1 = ests[picks[k], torch.arange(3)], ests[picks[k1],
                                                       torch.arange(3)]
        assert bool(((e < e1) | ((e == e1) & (picks[k] < picks[k1]))).all())
