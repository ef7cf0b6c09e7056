"""Launchers of the hand-written CUDA kernels (the counterpart of
directxtex_tpu/bc/pallas_kernels.py).

Each launcher checks its tensors (CUDA, dtype, shape, contiguity),
allocates outputs with torch.empty, launches on the current stream of the
tensors' device, raises if the launch reports an error, and adds one to
its kernel's launch count. There is no fallback: the plain PyTorch twins
live in bc67.py, and bc67's wrappers call these only for CUDA tensors.

    K1 bc7_decode  csrc/bc7_decode.cu  replaces pallas_kernels.py:2735
    K2 bc7_encode  csrc/bc7_encode.cuh replaces pallas_kernels.py:2020
       (variants: bc7_encode.cu opaque, bc7_encode_alpha.cu with mode 7,
       bc7_encode_quick.cu mode 6 alone, bc7_encode_maxq.cu and
       bc7_encode_maxq_alpha.cu the maxq tier without and with mode 7)
    K3 bc7_refine  csrc/bc7_refine.cuh replaces pallas_kernels.py:2667
       (bc7_refine.cu LADDER_MOMENT, bc7_refine_ladder.cu the exact
       ladders; launch counts kept apart for the default scope,
       bc7_refine, the scope with mode 7, bc7_refine_alpha, the maxq
       scope with mode 6, bc7_refine_maxq, and the exact ladders,
       bc7_refine_ladder)
    K4 bc6h_decode csrc/bc6h_decode.cu replaces pallas_kernels.py:2784
    K5 bc6h_encode csrc/bc6h_encode.cu replaces pallas_kernels.py:3744
    K6 bc6h_refine csrc/bc6h_refine.cu replaces pallas_kernels.py:3704

Words cross the C interface as int32 tensors read as uint32_t*; `signed`
crosses as an int, alpha_weight as the int holding its f32 bit pattern,
a BC7 exact ladder as its rounds and its deltas packed one byte each.
"""

from __future__ import annotations

import struct

import torch

from .. import _build


class CudaKernel:
    """One C entry point of the kernel library and its launch count."""

    def __init__(self, symbol: str, n_ptrs: int, n_ints: int):
        self.symbol = symbol
        self.n_ptrs = n_ptrs
        self.n_ints = n_ints
        self.launches = 0

    def launch(self, tensors, ints, device: torch.device) -> None:
        lib = _build.library({k.symbol: (k.n_ptrs, k.n_ints)
                              for k in KERNELS.values()})
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = getattr(lib, self.symbol)(
                *(t.data_ptr() for t in tensors), *ints, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} at launch")
        self.launches += 1


KERNELS = {
    "bc7_decode": CudaKernel("bc7_decode_launch", 2, 1),
    "bc7_encode": CudaKernel("bc7_encode_launch", 3, 2),
    "bc7_encode_alpha": CudaKernel("bc7_encode_alpha_launch", 3, 2),
    "bc7_encode_quick": CudaKernel("bc7_encode_quick_launch", 3, 2),
    "bc7_encode_maxq": CudaKernel("bc7_encode_maxq_launch", 3, 2),
    "bc7_encode_maxq_alpha": CudaKernel("bc7_encode_maxq_alpha_launch", 3,
                                        2),
    "bc7_refine": CudaKernel("bc7_refine_launch", 3, 3),
    "bc7_refine_alpha": CudaKernel("bc7_refine_launch", 3, 3),
    "bc7_refine_maxq": CudaKernel("bc7_refine_launch", 3, 3),
    "bc7_refine_ladder": CudaKernel("bc7_refine_ladder_launch", 3, 5),
    "bc6h_decode": CudaKernel("bc6h_decode_launch", 2, 2),
    "bc6h_encode": CudaKernel("bc6h_encode_launch", 3, 2),
    "bc6h_refine": CudaKernel("bc6h_refine_launch", 3, 8),
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def _check(t: torch.Tensor, name: str, rows: int, nb: int | None = None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != rows \
            or (nb is not None and t.shape[1] != nb):
        raise ValueError(f"{name} must be [{rows}, NB] int32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bc7_decode(words: torch.Tensor) -> torch.Tensor:
    """K1: words [4, NB] int32 -> texels [64, NB] int32 (0..255; the
    reserved mode gives 0)."""
    _check(words, "words", 4)
    nb = words.shape[1]
    out = torch.empty((64, nb), dtype=torch.int32, device=words.device)
    if nb:
        KERNELS["bc7_decode"].launch((words, out), (nb,), words.device)
    return out


def _f32_bits(x: float) -> int:
    """A float's f32 bit pattern as the C int that carries it."""
    return struct.unpack("<i", struct.pack("<f", x))[0]


# the BC7 search's tier: shared fits and mode-4 index mode 0 (default),
# or every mode fitted on its own and both mode-4 index modes (maxq)
TIER_DEFAULT = "default"
TIER_MAXQ = "maxq"

# K2's variants by tier and search modes (fold order); mode 6 alone is
# the same search in both tiers
_BC7_ENCODE_VARIANTS = {
    (TIER_DEFAULT, (1, 3, 5, 6, 4)): "bc7_encode",
    (TIER_DEFAULT, (1, 3, 5, 6, 7, 4)): "bc7_encode_alpha",
    (TIER_DEFAULT, (6,)): "bc7_encode_quick",
    (TIER_MAXQ, (1, 3, 5, 6, 4)): "bc7_encode_maxq",
    (TIER_MAXQ, (1, 3, 5, 6, 7, 4)): "bc7_encode_maxq_alpha",
    (TIER_MAXQ, (6,)): "bc7_encode_quick"}


def bc7_encode(px: torch.Tensor, modes: tuple = (1, 3, 5, 6, 4),
               aw: float = 1.0, tier: str = TIER_DEFAULT):
    """K2: px [64, NB] int32 (0..255) -> (err [NB] f32, words [4, NB]
    int32), the search over `modes`: (1, 3, 5, 6, 4) (opaque),
    (1, 3, 5, 6, 7, 4) (with mode 7) or (6,) (QUICK), of TIER_DEFAULT
    (shared fits) or TIER_MAXQ (every mode fitted on its own), with the
    alpha channel's squared error weighted by aw."""
    _check(px, "px", 64)
    variant = _BC7_ENCODE_VARIANTS.get((tier, tuple(modes)))
    if variant is None:
        raise ValueError(f"K2 searches {tuple(_BC7_ENCODE_VARIANTS)}; got "
                         f"{(tier, tuple(modes))}")
    nb = px.shape[1]
    err = torch.empty(nb, dtype=torch.float32, device=px.device)
    words = torch.empty((4, nb), dtype=torch.int32, device=px.device)
    if nb:
        KERNELS[variant].launch((px, err, words), (nb, _f32_bits(aw)),
                                px.device)
    return err, words


def bc7_ladder_ints(ladder) -> tuple:
    """An exact ladder (rounds, deltas) -> K3's (rounds, deltas one byte
    each, low byte first); raises ValueError on a ladder K3 does not take
    (0-15 rounds, 1-4 deltas in 1..127: the launch arguments' packing;
    the plain twin takes any ladder)."""
    try:
        rounds, deltas = ladder
        rounds, deltas = int(rounds), [int(d) for d in deltas]
    except (TypeError, ValueError):
        raise ValueError(f"ladder {ladder!r}: \"moment\" or (rounds, "
                         "deltas)") from None
    if not 0 <= rounds <= 15 or not 1 <= len(deltas) <= 4 \
            or not all(1 <= d <= 127 for d in deltas):
        raise ValueError(f"K3 takes 0-15 rounds and 1-4 deltas in 1..127, "
                         f"got {ladder!r}")
    return rounds, sum(d << (8 * j) for j, d in enumerate(deltas))


def bc7_refine(px: torch.Tensor, words: torch.Tensor, modes: tuple,
               aw: float = 1.0, ladder="moment") -> torch.Tensor:
    """K3: winner-refine of the blocks whose mode is in `modes` (a subset
    of (1, 3, 4, 5, 6, 7)) with one ladder: "moment" (LADDER_MOMENT) or an
    exact (rounds, deltas) ladder (0-15 rounds, 1-4 deltas in 1..127),
    the alpha channel's squared error weighted by aw. px [64, NB], words
    [4, NB] int32 -> words [4, NB] int32."""
    _check(words, "words", 4)
    nb = words.shape[1]
    _check(px, "px", 64, nb)
    if px.device != words.device:
        raise ValueError(f"px on {px.device}, words on {words.device}")
    mode_mask = 0
    for m in modes:
        if m not in (1, 3, 4, 5, 6, 7):
            raise ValueError(f"K3 refines modes 1, 3, 4, 5, 6, 7; got {m}")
        mode_mask |= 1 << m
    ints = (nb, mode_mask, _f32_bits(aw))
    if ladder == "moment":
        name = ("bc7_refine_maxq" if 6 in modes else
                "bc7_refine_alpha" if 7 in modes else "bc7_refine")
    else:
        name = "bc7_refine_ladder"
        ints += bc7_ladder_ints(ladder)
    out = torch.empty_like(words)
    if nb:
        KERNELS[name].launch((px, words, out), ints, px.device)
    return out


def bc6h_decode(words: torch.Tensor, signed: bool) -> torch.Tensor:
    """K4: words [4, NB] int32 -> half bits [48, NB] int32 (row = pixel *
    3 + channel; reserved modes give 0)."""
    _check(words, "words", 4)
    nb = words.shape[1]
    out = torch.empty((48, nb), dtype=torch.int32, device=words.device)
    if nb:
        KERNELS["bc6h_decode"].launch((words, out), (nb, int(bool(signed))),
                                      words.device)
    return out


def bc6h_encode(px: torch.Tensor, signed: bool):
    """K5: px [48, NB] int32 F16-ints (row = channel * 16 + pixel) ->
    (err [NB] f32, words [4, NB] int32), the shared-fit default search."""
    _check(px, "px", 48)
    nb = px.shape[1]
    err = torch.empty(nb, dtype=torch.float32, device=px.device)
    words = torch.empty((4, nb), dtype=torch.int32, device=px.device)
    if nb:
        KERNELS["bc6h_encode"].launch((px, err, words),
                                      (nb, int(bool(signed))), px.device)
    return err, words


def _i32(v: int) -> int:
    """A u32 bit pattern as the C int that carries it."""
    return v - (1 << 32) if v >= 1 << 31 else v


def _ladder_ints(ladder) -> tuple:
    """(rounds, deltas) -> (rounds, deltas 0-3, deltas 4-7), one byte per
    delta, low byte first; a zero byte ends the list."""
    rounds, deltas = ladder
    if not 1 <= len(deltas) <= 8 or not all(1 <= d <= 255 for d in deltas):
        raise ValueError(f"K6 takes 1-8 deltas in 1..255, got {deltas}")
    packed = sum(int(d) << (8 * j) for j, d in enumerate(deltas))
    return (int(rounds), _i32(packed & 0xFFFFFFFF), _i32(packed >> 32))


def bc6h_refine(px: torch.Tensor, words: torch.Tensor, ladder, ladder2,
                signed: bool, remap: bool, cross2: bool) -> torch.Tensor:
    """K6: the winner-refine ladder. px [48, NB], words [4, NB] int32 ->
    words [4, NB] int32. ladder / ladder2: (rounds, deltas) of the
    one-region and two-region units."""
    _check(words, "words", 4)
    nb = words.shape[1]
    _check(px, "px", 48, nb)
    if px.device != words.device:
        raise ValueError(f"px on {px.device}, words on {words.device}")
    flags = int(bool(signed)) | int(bool(remap)) << 1 | int(bool(cross2)) << 2
    out = torch.empty_like(words)
    if nb:
        KERNELS["bc6h_refine"].launch(
            (px, words, out),
            (nb, *_ladder_ints(ladder), *_ladder_ints(ladder2), flags),
            px.device)
    return out
