"""BC7 modes 4, 5 and 6 in one pass, each mode's winner emitted — the
plain twin of kernel K8 (bc67.bc7_single_modes on a CPU tensor) — held
against the JAX package's jnp _try_single_mode (the twin of
single_modes_pallas) word for word and error for error, at alpha weights
1.0 and 2.0, on opaque and alpha blocks: random blocks and 16x16 crops of
the albedo (opaque) and alphagrad (alpha) corpus contents. The JAX
references are computed once per module on one batch; torch runs on one
thread."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu.bc.common import image_to_blocks as j_image_to_blocks
from directxtex_tpu_torch.bc import bc67, cuda_kernels

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
MODES = (4, 5, 6)
AWS = (1.0, 2.0)
# the batch: opaque blocks first, then blocks with alpha
CONTENT = {"opaque": slice(0, 48), "alpha": slice(48, 96)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    """32 random opaque blocks and an albedo crop, then 32 random blocks
    with random alpha and an alphagrad crop: [96, 16, 4] f32."""
    rng = np.random.default_rng(31)
    rand = rng.random((64, 16, 4)).astype(np.float32)
    rand[:32, :, 3] = 1.0
    corpus = np.load(GOLDEN / "corpus.npz")
    crops = [np.asarray(j_image_to_blocks(jnp.asarray(corpus[c][:16, :16]))[0])
             for c in ("albedo", "alphagrad")]
    return np.concatenate([rand[:32], crops[0], rand[32:], crops[1]])


@pytest.fixture(scope="module")
def single():
    """The batch's texels [16, 4, NB] and JAX's (err, words) per (mode,
    aw), one _try_single_mode call each."""
    blocks = _batch()
    px_i = np.clip(np.transpose(blocks, (1, 2, 0)) * np.float32(255.0)
                   + np.float32(0.01), 0, 255).astype(np.int32)
    pj = jnp.asarray(px_i)
    refs = {}
    for aw in AWS:
        for m in MODES:
            err, words = jbc67._try_single_mode(pj, pj.astype(jnp.float32),
                                                m, aw=aw)
            refs[m, aw] = (np.asarray(err), np.asarray(words))
    return blocks, px_i, refs


@pytest.fixture(scope="module")
def port(single):
    _, px_i, _ = single
    px = torch.from_numpy(px_i).reshape(64, -1).contiguous()
    return {aw: bc67.bc7_single_modes(px, aw) for aw in AWS}


def test_batch_has_both_contents(single):
    blocks = single[0]
    assert (blocks[CONTENT["opaque"], :, 3] == 1.0).all()
    assert (blocks[CONTENT["alpha"], :, 3] < 1.0).any(axis=1).all()


@pytest.mark.parametrize("content", sorted(CONTENT))
@pytest.mark.parametrize("aw", AWS)
@pytest.mark.parametrize("mode", MODES)
def test_single_modes_match_jax(single, port, mode, aw, content):
    sl = CONTENT[content]
    r_err, r_words = single[2][mode, aw]
    err, words = port[aw][mode]
    assert err.dtype == torch.float32 and words.dtype == torch.int32
    np.testing.assert_array_equal(err.numpy()[sl], r_err[sl])
    np.testing.assert_array_equal(
        words.t().contiguous().numpy().view(np.uint32)[sl], r_words[sl])
    # the mode field of every winner is the mode's
    assert ((r_words[sl, 0] & ((1 << (mode + 1)) - 1)) == 1 << mode).all()


def test_weight_moves_the_alpha_blocks(single):
    """Not a vacuous comparison: alpha weight 2.0 changes some mode-4/5
    winners on the blocks with alpha."""
    refs = single[2]
    sl = CONTENT["alpha"]
    assert any((refs[m, 1.0][1][sl] != refs[m, 2.0][1][sl]).any()
               for m in (4, 5))


def test_cpu_tensor_takes_the_plain_twin(single):
    _, px_i, _ = single
    px = torch.from_numpy(px_i[..., :8].copy()).reshape(64, -1).contiguous()
    cuda_kernels.reset_launch_counts()
    out = bc67.bc7_single_modes(px)
    assert set(out) == set(MODES)
    assert all(tuple(w.shape) == (4, 8) for _, w in out.values())
    assert set(cuda_kernels.launch_counts().values()) == {0}
    with pytest.raises(ValueError):
        bc67.bc7_single_modes(px.reshape(16, 4, 8))
