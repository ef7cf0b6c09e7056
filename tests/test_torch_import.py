"""The port stands alone and its kernel gate: directxtex_tpu_torch imports
no jax and nothing of directxtex_tpu, its CUDA launchers import without
nvcc, a CPU tensor takes the plain twin, a launcher refuses a CPU tensor,
and unsupported settings raise."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc6h, bc67, cuda_kernels
from directxtex_tpu_torch.models import pipelines


def test_package_imports_no_jax():
    code = (
        "import sys\n"
        "import directxtex_tpu_torch, directxtex_tpu_torch._build\n"
        "from directxtex_tpu_torch.bc import bc6h, bc67, common, "
        "cuda_kernels\n"
        "from directxtex_tpu_torch.models import pipelines\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'directxtex_tpu']\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_launchers_import_without_building():
    # importing and resetting touches no compiler and no device
    cuda_kernels.reset_launch_counts()
    assert cuda_kernels.launch_counts() == {
        "bc7_decode": 0, "bc7_encode": 0, "bc7_encode_alpha": 0,
        "bc7_encode_quick": 0, "bc7_encode_maxq": 0,
        "bc7_encode_maxq_alpha": 0, "bc7_refine": 0, "bc7_refine_alpha": 0,
        "bc7_refine_maxq": 0, "bc7_refine_ladder": 0,
        "bc6h_decode": 0, "bc6h_encode": 0, "bc6h_refine": 0}


def _blocks(nb=32, seed=3, alpha=1.0):
    rng = np.random.default_rng(seed)
    blocks = rng.random((nb, 16, 4)).astype(np.float32)
    blocks[..., 3] = alpha
    return torch.from_numpy(blocks)


def test_cpu_tensors_take_the_plain_twins():
    cuda_kernels.reset_launch_counts()
    blocks = _blocks()
    px = bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()
    err, words = bc67.bc7_search_words(px)
    ref_err, ref_words = bc67._bc7_search_plain(px)
    assert torch.equal(words, ref_words) and torch.equal(err, ref_err)
    refined = bc67.bc7_refine_words(px, words)
    assert torch.equal(refined, bc67._bc7_refine_plain(px, words))
    texels = bc67.bc7_decode_words(refined)
    assert torch.equal(texels, bc67._bc7_decode_plain(refined))
    assert set(cuda_kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("signed", [False, True])
def test_cpu_tensors_take_the_bc6h_plain_twins(signed):
    cuda_kernels.reset_launch_counts()
    blocks = _blocks(16, seed=5) * 6.0 - (3.0 if signed else 0.0)
    px = bc6h.px_of_blocks(blocks, signed)
    err, words = bc6h.bc6h_search_words(px, signed)
    ref_err, ref_words = bc6h._bc6h_search_plain(px, signed)
    assert torch.equal(words, ref_words) and torch.equal(err, ref_err)
    refined = bc6h.bc6h_refine_words(px, words, bc6h.BC6H_LADDER_MID,
                                     signed, remap=True)
    assert torch.equal(refined, bc6h._bc6h_refine_plain(
        px, words, bc6h.BC6H_LADDER_MID, signed, remap=True))
    bits = bc6h.bc6h_decode_words(refined, signed)
    assert torch.equal(bits, bc6h._bc6h_decode_plain(refined, signed))
    assert set(cuda_kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("launcher,args", [
    ("bc7_decode", lambda: (torch.zeros((4, 8), dtype=torch.int32),)),
    ("bc7_encode", lambda: (torch.zeros((64, 8), dtype=torch.int32),)),
    ("bc7_refine", lambda: (torch.zeros((64, 8), dtype=torch.int32),
                            torch.zeros((4, 8), dtype=torch.int32),
                            (1, 3, 5, 4))),
    ("bc6h_decode", lambda: (torch.zeros((4, 8), dtype=torch.int32), False)),
    ("bc6h_encode", lambda: (torch.zeros((48, 8), dtype=torch.int32), True)),
    ("bc6h_refine", lambda: (torch.zeros((48, 8), dtype=torch.int32),
                             torch.zeros((4, 8), dtype=torch.int32),
                             (1, (4, 1)), (1, (4, 1)), False, True, False)),
])
def test_launchers_refuse_cpu_tensors(launcher, args):
    with pytest.raises(ValueError, match="CUDA"):
        getattr(cuda_kernels, launcher)(*args())


def test_wrappers_check_shapes_and_types():
    with pytest.raises(ValueError):
        bc67.bc7_decode_words(torch.zeros((4, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        bc67.bc7_search_words(torch.zeros((16, 4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        bc67.decode_bc7(torch.zeros((8, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        bc6h.bc6h_search_words(torch.zeros((64, 8), dtype=torch.int32), False)
    with pytest.raises(ValueError):
        bc6h.decode_bc6h(torch.zeros((8, 8), dtype=torch.uint8), False)
    with pytest.raises(ValueError):
        bc6h.bc6h_refine_words(torch.zeros((48, 8), dtype=torch.int32),
                               torch.zeros((4, 8), dtype=torch.int32),
                               (1, (4, 0)), False)


# the JAX package's LADDER_FULL (bc67.py:724): the maxq tier's exact ladder
LADDER_FULL = (2, (2, 1))


@pytest.mark.parametrize("kwargs", [
    {"flags": 0x80000}, {"flags": 0x80000 | 0x200000}, {"modes": (0, 1, 3)}])
def test_unsupported_encode_settings_raise(kwargs):
    # USE_3SUBSETS, alone or with MAXQUALITY (encode_bc7), and a refine
    # scope with the 3-subset modes (refine_bc7_words) are the next slice
    blocks = _blocks(4, alpha=0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if "modes" in kwargs:
            px_i = bc67._quantize_ldr(blocks)
            words = torch.zeros((4, 4), dtype=torch.int32)
            bc67.refine_bc7_words(px_i, words, **kwargs)
        else:
            bc67.encode_bc7(blocks, **kwargs)


@pytest.mark.parametrize("kwargs", [
    {"flags": 0x100000}, {"opaque": False}, {"alpha_weight": 2.0},
    {"flags": 0x200000}, {"ladder": LADDER_FULL}])
def test_accepted_encode_settings_run_the_plain_twins(kwargs):
    """QUICK, the default call on blocks with alpha (mode 7), an alpha
    weight, MAXQUALITY (encode_bc7) and the exact ladder
    (refine_bc7_words over the maxq scope): a CPU tensor takes the plain
    twins and gives [NB, 16] u8 blocks ([NB, 4] words)."""
    cuda_kernels.reset_launch_counts()
    blocks = _blocks(4, alpha=0.5)
    if "ladder" in kwargs:
        px_i = bc67._quantize_ldr(blocks)
        words = bc67.encode_bc7(blocks).view(torch.int32)
        out = bc67.refine_bc7_words(px_i, words, modes=(1, 3, 5, 6, 7, 4),
                                    **kwargs)
        assert out.dtype == torch.int32 and tuple(out.shape) == (4, 4)
    else:
        out = bc67.encode_bc7(blocks, **kwargs)
        assert out.dtype == torch.uint8 and tuple(out.shape) == (4, 16)
    assert set(cuda_kernels.launch_counts().values()) == {0}


def test_default_encode_bc7_takes_opaque_blocks():
    blocks = _blocks(8)
    assert torch.equal(bc67.encode_bc7(blocks),
                       bc67.encode_bc7(blocks, opaque=True))


@pytest.mark.parametrize("kwargs", [
    {"rows_sel": ("r1",)}, {"flags": 0x100000}, {"flags": 0x80000}])
def test_unsupported_bc6h_settings_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bc6h.encode_bc6h(_blocks(4), False, **kwargs)


@pytest.mark.parametrize("kind", ["bc1", "bc3", "bc4", "bc5"])
def test_unported_pipeline_kinds_raise(kind):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipelines.bc_encode_pipeline(kind)


def test_unsupported_refine_settings_raise():
    # the 3-subset modes 0 and 2 are not ported; a ladder that is not
    # (rounds, deltas) is refused
    px_i = torch.zeros((16, 4, 4), dtype=torch.int32)
    words = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        bc67.refine_bc7_words(px_i, words, modes=(2,))
    with pytest.raises(NotImplementedError):
        bc67.refine_bc7_words(px_i, words, modes=(0, 1, 3, 5, 6, 4))
    with pytest.raises(ValueError):
        bc67.refine_bc7_words(px_i, words, ladder="fast")


@pytest.mark.parametrize("ladder", [(2, (4, 3, 2, 1, 1)), (1, (200,))])
def test_ladder_past_k3_launch_limits(ladder):
    """The plain twin takes any (rounds, deltas), as the JAX package does;
    K3's launcher refuses what its launch arguments cannot carry (more
    than 4 deltas, a delta past 127) before it builds anything."""
    blocks = _blocks(4, alpha=0.5)
    px_i = bc67._quantize_ldr(blocks)
    words = bc67.encode_bc7(blocks).view(torch.int32)
    out = bc67.refine_bc7_words(px_i, words, ladder=ladder,
                                modes=(1, 3, 5, 6, 7, 4))
    assert out.dtype == torch.int32 and tuple(out.shape) == (4, 4)
    with pytest.raises(ValueError):
        cuda_kernels.bc7_ladder_ints(ladder)
