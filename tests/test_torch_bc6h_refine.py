"""BC6H winner-refine of the PyTorch port (the plain twin of kernel K6)
held against the JAX package's refine_bc6h_words on the same pixels and
the same encoded words: both units, unsigned and signed, the mid tier
(re-mapping ladder at the winner's own precision) and the re-mapping
ladder with cross2 at LIGHT depth. The ladder's scores are f32 sums of
squared F16-int differences, taken in index order in both packages, so
the words are compared exactly.

The input words come from the port's encode_bc6h, which
test_torch_bc6h_search.py holds to the JAX encode's words; a JAX encode
here would cost 16 s of the file's time budget for the same input. The
JAX references (the F16-int pixels and each refine of the port's words,
which are checked equal to the ones refined there) are frozen in
tests/golden/jax_refs.npz by tests/golden/generate_jax_refs.py; the maxq
ladder (26 s per JAX call) runs live, only with DXT_HEAVY_TESTS set, as
tests/test_pallas.py gates it. Torch runs on one thread."""

import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu_torch.bc import bc6h


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
CASES = [("mid", jbc67.BC6H_LADDER_MID, False),
         ("light_cross2", jbc67.BC6H_LADDER_LIGHT, True)]
if os.environ.get("DXT_HEAVY_TESTS"):
    CASES.append(("maxq", jbc67.BC6H_LADDER_MAXQ, True))


def _blocks(signed, nb=64, seed=29):
    """Random HDR blocks, a quarter of them flat and a quarter two-tone,
    so the encode picks both one- and two-region rows."""
    rng = np.random.default_rng(seed + signed)
    rgb = rng.random((nb, 16, 3)).astype(np.float32) * 6.0
    if signed:
        rgb -= 3.0
    rgb[::4] = rgb[::4, :1] * (1.0 + 0.01 * rng.random((16, 1), np.float32))
    rgb[1::4, 8:] = rgb[1::4, :1] * 0.25
    return np.concatenate([rgb, np.ones((nb, 16, 1), np.float32)], -1)


@pytest.fixture(scope="module")
def jax_refs():
    """Per signed: F16-int pixels, encoded words and the JAX refine of
    them for each case (frozen; the maxq case live), with the fixed-index
    ladder's under "fixed"."""
    frozen = np.load(GOLDEN / "jax_refs.npz")
    out = {}
    for signed in (False, True):
        pre = f"refine6_{'s' if signed else 'u'}_"
        blocks = _blocks(signed)
        nb = blocks.shape[0]
        words = bc6h.encode_bc6h(torch.from_numpy(blocks), signed).numpy() \
            .view(np.uint32).reshape(nb, 4)
        np.testing.assert_array_equal(words, frozen[pre + "words"])
        px_int = frozen[pre + "px_int"]
        refs = {name: frozen[pre + name] for name in ("mid", "light_cross2",
                                                      "fixed")}
        for name, ladder, cross2 in CASES:
            if name not in refs:
                refs[name] = np.asarray(jbc67.refine_bc6h_words(
                    jnp.asarray(px_int), jnp.asarray(words), ladder, signed,
                    remap=True, cross2=cross2))
        out[signed] = (px_int, words, refs)
    return out


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("name,ladder,cross2", CASES,
                         ids=[c[0] for c in CASES])
def test_refine_equals_jax(jax_refs, signed, name, ladder, cross2):
    px_int, words, refs = jax_refs[signed]
    got = bc6h.refine_bc6h_words(
        torch.from_numpy(px_int), torch.from_numpy(words.view(np.int32)),
        ladder, signed, remap=True, cross2=cross2).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, refs[name])
    # the ladder moved blocks of both units
    changed = np.any(got != words, axis=1)
    rows = bc6h._mode_rows(bc6h._words_i64(
        torch.from_numpy(words.view(np.int32)).t().contiguous())).numpy()
    assert changed[rows >= 10].any() and changed[rows < 10].any()


@pytest.mark.parametrize("signed", [False, True])
def test_fixed_index_ladder_equals_jax(jax_refs, signed):
    """remap=False: the fixed-index ladder and one re-assignment, own
    precision only."""
    px_int, words, refs = jax_refs[signed]
    ref = refs["fixed"]
    got = bc6h.refine_bc6h_words(
        torch.from_numpy(px_int), torch.from_numpy(words.view(np.int32)),
        jbc67.BC6H_LADDER_FULL, signed).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref)
