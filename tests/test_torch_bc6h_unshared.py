"""The BC6H_SHARED_FIT=False search of the PyTorch port — the plain twins
of kernels K10 (rows 10-13, each evaluated in full), the shape ranking
launch and K11 (a precision group's rows over given shape candidates),
their fold, and encode_bc6h with the flag off in the default and mid
tiers — held against the JAX package's jnp path on the same pixels,
unsigned and signed.

K10's and K11's twins are compared word for word and error for error
(K11 takes the JAX picks, so that a moved pick cannot hide an evaluation
fault; where no candidate of a launch fits, the twin, like the TPU
kernel, keeps its first candidate's words and the jnp fold zero words,
so words are compared where the error is finite). The whole encode
follows the F16-int rule of tests/test_torch_bc6h_search.py, since
ranking sums in another order can flip near-ties; so does the flag-off
encode of each whole HDR corpus content. The JAX outputs are
frozen in tests/golden/bc6h_unshared.npz by
tests/golden/generate_bc6h_unshared.py (its eager JAX calls take minutes
on a CPU): per signed, the 200-block random / bimodal set of
benchmarks/verify_bc6h_tpu.py and 32x32 crops of the five HDR corpus
contents. Torch runs on one thread."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu_torch.bc import bc6h, cuda_kernels
from directxtex_tpu_torch.bc.common import image_to_blocks
from test_torch_bc6h_search import N_BIMODAL, assert_int_rule

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
SIGNED = (False, True)
GROUPS = ((0,), (1,), (2, 3, 4), (5,), (6, 7, 8), (9,))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """The frozen JAX outputs, with the port's pixels [48, NB] of each
    signed batch."""
    out = dict(np.load(GOLDEN / "bc6h_unshared.npz"))
    for signed in SIGNED:
        pre = _pre(signed)
        out[pre + "px"] = bc6h.px_of_blocks(
            torch.from_numpy(out[pre + "blocks"]), signed)
    return out


@pytest.fixture(scope="module")
def unshared(ref):
    """The port's flag-off encode_bc6h, default tier, per signed."""
    saved = bc6h.BC6H_SHARED_FIT
    bc6h.BC6H_SHARED_FIT = False
    try:
        return {signed: bc6h.encode_bc6h(torch.from_numpy(
            ref[_pre(signed) + "blocks"]), signed).numpy()
            for signed in SIGNED}
    finally:
        bc6h.BC6H_SHARED_FIT = saved


def _pre(signed):
    return "s_" if signed else "u_"


def _u32(words_4nb):
    """[4, NB] int32 -> [NB, 4] u32."""
    return words_4nb.t().contiguous().numpy().view(np.uint32)


def _px_int(blocks, signed):
    return np.asarray(jbc67._f16_to_int(
        jnp.asarray(np.transpose(blocks[..., :3], (1, 2, 0))), signed))


def _key(rows):
    return "rows_" + "".join(str(r) for r in rows)


def test_settings_equal_jax():
    assert bc6h.BC6H_SHARED_FIT is True
    assert bc6h.BC6H_REFIT_ROUNDS == jbc67.BC6H_REFIT_ROUNDS == 2
    assert bc6h._bc6h_row_groups() == list(GROUPS)


@pytest.mark.parametrize("signed", SIGNED)
def test_k10_twin_matches_jnp(ref, signed):
    pre = _pre(signed)
    err, words = bc6h._bc6h_1region_plain(ref[pre + "px"], signed)
    assert torch.equal(err, torch.from_numpy(ref[pre + "k10_err"]))
    # row 10 always fits, so every block's words are the jnp fold's
    assert np.isfinite(ref[pre + "k10_err"]).all()
    np.testing.assert_array_equal(_u32(words), ref[pre + "k10_words"])


@pytest.mark.parametrize("signed", SIGNED)
def test_ranking_twin_picks_match_jax(ref, signed):
    """The top 4 of the 32-shape table equal JAX's except on near-ties:
    the port sums the table in pixel order, the JAX package with an
    einsum, and an entry is a difference of sums as large as the block's
    squared deviation from its mean (up to ~1e10 here), so the two tables
    differ by up to ~1e-6 of that (ROADMAP.md queue 3). Where a pick
    moved, JAX's own estimates of the port's picks are JAX's top 4 within
    2e-6 of that scale."""
    pre = _pre(signed)
    got = bc6h._bc6h_shapes_plain(ref[pre + "px"]).numpy()
    picks = ref[pre + "picks"]
    assert got.dtype == np.int32 and got.shape == picks.shape
    moved = np.nonzero((got != picks).any(axis=0))[0]
    assert len(moved) <= max(2, got.shape[1] // 100), moved
    px_f = _px_int(ref[pre + "blocks"], signed).astype(np.float32)
    px4 = np.concatenate([px_f, np.zeros_like(px_f[:, :1])], axis=1)
    table = np.asarray(jbc67._shape_estimates_table(
        jnp.asarray(px4), 1, 3, n_shapes=32, off_axis=True, axis_w=0.0))
    scale = ((px_f - px_f.mean(axis=0)) ** 2).sum(axis=(0, 1))
    for b in moved:
        np.testing.assert_allclose(np.sort(table[got[:, b], b]),
                                   np.sort(table[picks[:, b], b]), rtol=0,
                                   atol=2e-6 * scale[b] + 0.5)


@pytest.mark.parametrize("rows", [(2,)] + list(GROUPS))
@pytest.mark.parametrize("signed", SIGNED)
def test_k11_twin_matches_jnp(ref, signed, rows):
    pre = _pre(signed)
    err, words = bc6h._bc6h_2region_plain(
        ref[pre + "px"], torch.from_numpy(ref[pre + "picks"]), rows, signed)
    r_err, r_words = ref[pre + _key(rows) + "_err"], \
        ref[pre + _key(rows) + "_words"]
    assert torch.equal(err, torch.from_numpy(r_err))
    fin = np.isfinite(r_err)
    np.testing.assert_array_equal(_u32(words)[fin], r_words[fin])


@pytest.mark.parametrize("signed", SIGNED)
def test_fold_equals_jnp_search_at_jax_picks(ref, signed, monkeypatch):
    """The search's fold over (K10, group 0, ..., group 5) equals the jnp
    path's flat fold word for word at the JAX picks, on a batch with
    blocks where every candidate of a K11 launch reads inf (the launch
    then hands its first candidate's words to the fold, which must not
    take them)."""
    pre = _pre(signed)
    px = ref[pre + "px"]
    picks = torch.from_numpy(ref[pre + "picks"])
    monkeypatch.setattr(bc6h, "bc6h_shape_picks", lambda p: picks)
    err, words = bc6h._search_unshared(px, signed)
    np.testing.assert_array_equal(
        _u32(words), ref[pre + "search"].view(np.uint32).reshape(-1, 4))
    assert torch.isfinite(err).all()
    launch_inf = [~np.isfinite(ref[pre + _key(g) + "_err"]) for g in GROUPS]
    assert any(m.any() for m in launch_inf)
    g_err, g_words = bc6h._bc6h_2region_plain(px, picks, GROUPS[0], signed)
    inf0 = ~torch.isfinite(g_err)
    assert bool(inf0.any()) and bool((g_words[:, inf0] != 0).any())
    assert not bool((words[:, inf0] == g_words[:, inf0]).all())


@pytest.mark.parametrize("signed", SIGNED)
def test_encode_unshared_matches_jax(ref, unshared, signed):
    pre = _pre(signed)
    blocks = ref[pre + "blocks"]
    got = unshared[signed]
    assert got.shape == ref[pre + "search"].shape and got.dtype == np.uint8
    assert_int_rule(got.view(np.uint32), ref[pre + "search"].view(np.uint32),
                    _px_int(blocks, signed), signed,
                    N_BIMODAL if signed else 0)


@pytest.mark.parametrize("signed", SIGNED)
def test_encode_unshared_mid_matches_jax(ref, signed, monkeypatch):
    pre = _pre(signed)
    blocks = ref[pre + "blocks"]
    monkeypatch.setattr(bc6h, "BC6H_SHARED_FIT", False)
    got = bc6h.encode_bc6h(torch.from_numpy(blocks), signed,
                           bc6h._BC6H_MID).numpy()
    assert_int_rule(got.view(np.uint32), ref[pre + "mid"].view(np.uint32),
                    _px_int(blocks, signed), signed,
                    N_BIMODAL if signed else 0)


def test_corpus_encodes_match_jax(ref, monkeypatch):
    """The flag-off encode of each whole HDR corpus content (the contents
    chip_smoke.py's flag-off gates encode) against the JAX package's."""
    corpus = np.load(GOLDEN / "corpus.npz")
    monkeypatch.setattr(bc6h, "BC6H_SHARED_FIT", False)
    for c in ("hdr", "hdr_china", "hdr_flower", "hdr_sun", "hdr_signed"):
        signed = c == "hdr_signed"
        blocks = image_to_blocks(torch.from_numpy(corpus[c]))[0]
        got = bc6h.encode_bc6h(blocks, signed).numpy()
        want = ref["corpus_" + c]
        assert got.shape == want.shape
        assert_int_rule(got.view(np.uint32), want.view(np.uint32),
                        _px_int(blocks.numpy(), signed), signed)


@pytest.mark.parametrize("signed", SIGNED)
def test_flag_changes_the_words(ref, unshared, signed):
    """Not a vacuous comparison: the JAX package's flag-off words differ
    from its flag-on words, and the port's do too, on many blocks."""
    pre = _pre(signed)
    nb = ref[pre + "blocks"].shape[0]
    jax_differ = (ref[pre + "search"] != ref[pre + "shared"]).any(axis=1)
    assert jax_differ.sum() > nb // 4
    shared = bc6h.encode_bc6h(torch.from_numpy(ref[pre + "blocks"]),
                              signed).numpy()
    assert (unshared[signed] != shared).any(axis=1).sum() > nb // 4


@pytest.mark.parametrize("signed", SIGNED)
def test_flag_is_read_at_call_time(ref, unshared, signed, monkeypatch):
    """encode_bc6h reads BC6H_SHARED_FIT at each call: the flag-off encode
    is the unshared search's words, on a CPU tensor through the plain
    twins only."""
    pre = _pre(signed)
    px = ref[pre + "px"]
    _, words = bc6h._search_unshared(px, signed)
    np.testing.assert_array_equal(
        unshared[signed].view(np.uint32).reshape(-1, 4), _u32(words))
    cuda_kernels.reset_launch_counts()
    monkeypatch.setattr(bc6h, "BC6H_SHARED_FIT", False)
    blocks = torch.from_numpy(ref[pre + "blocks"][:8])
    out = bc6h.encode_bc6h(blocks, signed)
    np.testing.assert_array_equal(out.numpy(), unshared[signed][:8])
    assert set(cuda_kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("signed", SIGNED)
def test_maxq_refines_the_unshared_words(ref, unshared, signed,
                                         monkeypatch):
    """The maxq tier with the flag off hands the unshared search's words
    to its refine (BC6H_LADDER_MAXQ with cross2, bc67.py:3380-3420) and
    returns what the refine gives."""
    pre = _pre(signed)
    sl = slice(200, 204)            # 4 blocks of the first corpus crop
    seen = []
    refine = bc6h.bc6h_refine_words

    def recording(px, words, ladder, signed_, **kw):
        out = refine(px, words, ladder, signed_, **kw)
        seen.append((words, ladder, kw, out))
        return out

    monkeypatch.setattr(bc6h, "BC6H_SHARED_FIT", False)
    monkeypatch.setattr(bc6h, "bc6h_refine_words", recording)
    got = bc6h.encode_bc6h(torch.from_numpy(ref[pre + "blocks"][sl]), signed,
                           bc6h._BC7_MAXQUALITY)
    assert len(seen) == 1
    words, ladder, kw, out = seen[0]
    assert ladder == bc6h.BC6H_LADDER_MAXQ and kw == {"remap": True,
                                                      "cross2": True}
    np.testing.assert_array_equal(
        _u32(words), unshared[signed][sl].view(np.uint32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), _u32(out))


@pytest.mark.parametrize("group", range(6))
def test_k11_wrapper_takes_group_rows(ref, group):
    """bc6h_2region_words(group) on a CPU tensor is the twin over that
    precision group's rows."""
    px = ref["u_px"][:, :24].contiguous()
    picks = torch.from_numpy(ref["u_picks"][:, :24].copy())
    got = bc6h.bc6h_2region_words(px, picks, group, False)
    want = bc6h._bc6h_2region_plain(px, picks, GROUPS[group], False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("rows", [(), (2, 5), (10,), (3, 9)])
def test_k11_twin_refuses_rows_of_two_groups(rows):
    px = torch.zeros((48, 4), dtype=torch.int32)
    s_blks = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        bc6h._bc6h_2region_plain(px, s_blks, rows, False)
