"""The settings of the JAX package's BC7 / BC6H module switches that the
PyTorch port refuses: the default tier with its shared fits off
(bc67.BC7_SHARED2SUB / BC7_SHARED45 False, set only by the JAX package's
research scripts and kernel tests) and the two float keep-better guards
(BC7_SHARED_KEEPBETTER / BC6H_SHARED_KEEPBETTER True, measured by the
JAX package to change no word). Each raises NotImplementedError, on
every device, since the check comes before the device branch; QUICK and
the maxq tier ignore the shared-fit switches, as in the JAX package, and
so still encode. Torch runs on one thread."""

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc6h, bc67

SETTINGS = ((False, True), (True, False), (False, False))
QUICK = 0x100000
MAXQ = 0x200000
USE_3SUBSETS = 0x80000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blocks(nb: int, alpha: bool) -> torch.Tensor:
    rng = np.random.default_rng(21)
    b = rng.random((nb, 16, 4)).astype(np.float32)
    if not alpha:
        b[..., 3] = 1.0
    return torch.from_numpy(b)


@pytest.mark.parametrize("s2,s45", SETTINGS,
                         ids=[f"s2sub{int(a)}_s45{int(b)}"
                              for a, b in SETTINGS])
def test_unshared_default_tier_is_refused(monkeypatch, s2, s45):
    """The default tier with either shared fit off raises, opaque, with
    alpha and with USE_3SUBSETS, through encode_bc7 and through
    bc7_search_words; the shipped setting encodes."""
    blocks = _blocks(8, alpha=True)
    assert bc67.BC7_SHARED2SUB is True and bc67.BC7_SHARED45 is True
    assert bc67.encode_bc7(blocks).shape == (8, 16)
    monkeypatch.setattr(bc67, "BC7_SHARED2SUB", s2)
    monkeypatch.setattr(bc67, "BC7_SHARED45", s45)
    for b, flags in ((_blocks(8, alpha=False), 0), (blocks, 0),
                     (blocks, USE_3SUBSETS)):
        with pytest.raises(NotImplementedError, match="BC7_SHARED2SUB"):
            bc67.encode_bc7(b, flags=flags)
    px = bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()
    for modes in (bc67.SEARCH_MODES, bc67.SEARCH_MODES_3_ALPHA):
        with pytest.raises(NotImplementedError, match="BC7_SHARED45"):
            bc67.bc7_search_words(px, modes)


def test_quick_and_maxq_ignore_the_switches(monkeypatch):
    """QUICK and the maxq tier give the same bytes with both switches
    off, as in the JAX package (share2sub=(BC7_SHARED2SUB and not maxq))."""
    blocks = _blocks(32, alpha=True)
    shipped = {f: bc67.encode_bc7(blocks, flags=f) for f in (QUICK, MAXQ)}
    monkeypatch.setattr(bc67, "BC7_SHARED2SUB", False)
    monkeypatch.setattr(bc67, "BC7_SHARED45", False)
    for f, want in shipped.items():
        assert torch.equal(bc67.encode_bc7(blocks, flags=f), want), hex(f)


@pytest.mark.parametrize("codec", ["bc7", "bc6h"])
def test_keepbetter_guards_are_refused(monkeypatch, codec):
    """BC7_SHARED_KEEPBETTER / BC6H_SHARED_KEEPBETTER on: encode raises
    NotImplementedError before any work (before it looks at its input);
    off (the JAX package's setting), the encode runs."""
    blocks = torch.rand((4, 16, 4))
    mod, name, encode = {
        "bc7": (bc67, "BC7_SHARED_KEEPBETTER", bc67.encode_bc7),
        "bc6h": (bc6h, "BC6H_SHARED_KEEPBETTER",
                 lambda b: bc6h.encode_bc6h(b, False))}[codec]
    assert getattr(mod, name) is False
    assert encode(blocks).shape == (4, 16)
    monkeypatch.setattr(mod, name, True)
    for arg in (blocks, torch.zeros(3)):
        with pytest.raises(NotImplementedError, match=name):
            encode(arg)
