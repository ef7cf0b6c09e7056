"""BC7 default-tier encode of the PyTorch port (the plain twins of kernels
K2 search and K3 refine) held against the JAX package's jnp path, on the
same pixels made with numpy. Near-tie picks may differ where a float sum
is taken in another order (the JAX estimate table is an einsum), so
search results are compared under the near-tie rule; the MOMENT refine
is exact and compared word for word. Contents are 32x32 crops (64
blocks). The JAX outputs (the estimate tables and picks, each search
family's words, and the MOMENT refine of the port's search words) are
frozen in tests/golden/jax_refs.npz by tests/golden/generate_jax_refs.py;
torch runs on one thread."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.bc.common import image_to_blocks as j_image_to_blocks
from directxtex_tpu_torch.bc import bc67


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module")
def corpus():
    return np.load(GOLDEN / "corpus.npz")


@pytest.fixture(scope="module")
def frozen(corpus):
    """{content: (px, {key: frozen JAX output})}, the frozen texels
    checked equal to the ones made here."""
    refs = np.load(GOLDEN / "jax_refs.npz")
    out = {}
    for name, (_, px) in _contents(corpus).items():
        pre = f"enc_{name}_"
        np.testing.assert_array_equal(refs[pre + "px"], px, err_msg=name)
        out[name] = (px, {k[len(pre):]: refs[k] for k in refs.files
                          if k.startswith(pre)})
    return out


def _pixels(img):
    """(blocks [NB, 16, 4] f32, px_i [16, 4, NB] i32) in numpy."""
    blocks = np.array(j_image_to_blocks(jnp.asarray(img))[0])
    px = np.clip(np.transpose(blocks, (1, 2, 0)) * np.float32(255.0)
                 + np.float32(0.01), 0, 255).astype(np.int32)
    return blocks, px


def _mixed_alpha_pixels(nb=64, seed=19):
    """Noisy blocks, half with alpha: modes 4/5 win often."""
    rng = np.random.default_rng(seed)
    blocks = rng.random((nb, 16, 4)).astype(np.float32)
    blocks[:nb // 2, :, 3] = 1.0
    blocks[::3, :, :3] = np.repeat(rng.random((len(blocks[::3]), 1, 3)),
                                   16, axis=1)
    px = np.clip(np.transpose(blocks, (1, 2, 0)) * np.float32(255.0)
                 + np.float32(0.01), 0, 255).astype(np.int32)
    return blocks, px


def _contents(corpus):
    out = {c: _pixels(corpus[c][:32, :32]) for c in ("albedo", "photo_china")}
    out["mixed_alpha"] = _mixed_alpha_pixels()
    return out


def _block_sse(words_nb4, px):
    """Decoded per-block SSE of u32 words [NB, 4] against px [16, 4, NB]."""
    raw = np.array(words_nb4, np.uint32, order="C").view(np.uint8)
    dec = bc67.decode_bc7(torch.from_numpy(raw.reshape(-1, 16))).numpy()
    src = np.transpose(px, (2, 0, 1)).astype(np.float64)
    return ((np.rint(dec * 255.0) - src) ** 2).sum(axis=(1, 2))


def assert_near_tie(got, ref, px):
    """The near-tie rule: words differ on at most max(2, nb//25) blocks;
    there the decoded SSE agrees within rtol 2e-2, atol 4; and the total
    decoded SSE is at most 1.001x the reference's + 1e-3."""
    got = np.asarray(got, np.uint32).reshape(-1, 4)
    ref = np.asarray(ref, np.uint32).reshape(-1, 4)
    nb = ref.shape[0]
    differ = np.any(got != ref, axis=1)
    assert differ.sum() <= max(2, nb // 25), f"{differ.sum()}/{nb}"
    sse_g, sse_r = _block_sse(got, px), _block_sse(ref, px)
    np.testing.assert_allclose(sse_g[differ], sse_r[differ], rtol=2e-2,
                               atol=4.0)
    assert sse_g.sum() <= sse_r.sum() * 1.001 + 1e-3


def _words_u32(words_4nb):
    """Port words [4, NB] (int32 or int64 u32 values) -> [NB, 4] u32."""
    return (words_4nb.to(torch.int64) & 0xFFFFFFFF).numpy().T.astype(
        np.uint32)


def test_shape_estimates_match(frozen):
    for name, (px, ref_of) in frozen.items():
        pxf = px.astype(np.float32)
        ref = ref_of["table"]
        got = bc67._shape_estimates_table(torch.from_numpy(pxf)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3,
                                   err_msg=name)
        # top-4 picks equal except at near-ties of the estimates
        picks_r = ref_of["picks"]
        picks_g = np.stack([s.numpy() for s in bc67._top_k_shapes(
            torch.from_numpy(got), 4)])
        for b in np.nonzero(np.any(picks_g != picks_r, axis=0))[0]:
            e_g = np.sort(ref[picks_g[:, b], b])
            e_r = np.sort(ref[picks_r[:, b], b])
            np.testing.assert_allclose(e_g, e_r, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("family", ["modes13", "mode6", "modes45"])
def test_search_family_matches_jax(frozen, family):
    for name, (px, ref_of) in frozen.items():
        pt = torch.from_numpy(px)
        ptf = pt.to(torch.float32)
        if family == "modes13":
            got = bc67._try_2sub_modes_shared(
                pt, ptf, bc67._shape_estimates_table(ptf))
        elif family == "mode6":
            got = {6: bc67._try_mode6(pt, ptf)}
        else:
            got = bc67._try_modes45_shared(pt, ptf)
        assert sorted(got) == {"modes13": [1, 3], "mode6": [6],
                               "modes45": [4, 5]}[family]
        for mode in got:
            assert_near_tie(_words_u32(got[mode][1]), ref_of[f"mode{mode}"],
                            px)


def test_refine_moment_equals_jax(frozen):
    for name, (px, ref_of) in frozen.items():
        nb = px.shape[2]
        pt = torch.from_numpy(px)
        _, words = bc67.bc7_search_words(pt.reshape(64, nb).contiguous())
        w_nb4 = words.t().contiguous()                  # int32 bit patterns
        # the frozen refine took these search words
        np.testing.assert_array_equal(w_nb4.numpy().view(np.uint32),
                                      ref_of["refine_in"], err_msg=name)
        ref = ref_of["refine"]
        got = bc67.refine_bc7_words(pt, w_nb4, bc67.LADDER_MOMENT,
                                    modes=(1, 3, 5, 4))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), ref,
                                      err_msg=name)
