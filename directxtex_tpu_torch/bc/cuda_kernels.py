"""Launchers of the hand-written CUDA kernels (the counterpart of
directxtex_tpu/bc/pallas_kernels.py).

Each launcher checks its tensors (CUDA, dtype, shape, contiguity),
allocates outputs with torch.empty, launches on the current stream of the
tensors' device, raises if the launch reports an error, and adds one to
its kernel's launch count. There is no fallback: the plain PyTorch twins
live in bc67.py, and bc67's wrappers call these only for CUDA tensors.

    K1 bc7_decode  csrc/bc7_decode.cu  replaces pallas_kernels.py:2735
    K2 bc7_encode  csrc/bc7_encode.cuh replaces pallas_kernels.py:2020
       (variants: bc7_encode.cu the default tier, bc7_encode_quick.cu
       mode 6 alone, bc7_encode_maxq.cu the maxq tier; with mode 7 the
       search of the tier, then bc7_alpha_list and bc7_mode7, both in
       csrc/bc7_mode7.cu)
    K3 bc7_refine  csrc/bc7_refine.cuh replaces pallas_kernels.py:2667
       (a bucket pass, bc7_mode_buckets in bc7_refine.cu, then one launch
       per mode in scope of bc7_refine_mode_kernel, mode M's instances
       built by bc7_refine_<M>.cu; the per-mode launches are counted by
       scope: the default scope, bc7_refine, the scope with mode 7,
       bc7_refine_alpha, the maxq scope with mode 6, bc7_refine_maxq, the
       exact ladders, bc7_refine_ladder, and modes 0 and 2 in any scope,
       bc7_refine_3sub and bc7_refine_3sub_ladder)
    K4 bc6h_decode csrc/bc6h_decode.cu replaces pallas_kernels.py:2784
    K5 bc6h_encode csrc/bc6h_encode.cu replaces pallas_kernels.py:3744
    K6 bc6h_refine csrc/bc6h_refine.cu replaces pallas_kernels.py:3704
       (a unit bucket pass, bc6h_unit_buckets, then one launch of lane
       jobs per unit; counted as bc6h_refine, or bc6h_refine_cross2 with
       cross2)
    K7 bc7_partition_mode csrc/bc7_partition.cuh replaces
       pallas_kernels.py:1414 (modes 1, 3, 7 built in bc7_partition.cu,
       modes 0 and 2 in bc7_partition_0.cu and bc7_partition_2.cu)
    K9 bc7_partition_shapes csrc/bc7_shapes.cu replaces
       pallas_kernels.py:1850
    K8 bc7_single_modes csrc/bc7_single_modes.cu replaces
       pallas_kernels.py:1714
    K10 bc6h_1region csrc/bc6h_1region.cu replaces pallas_kernels.py:3789
    K11 bc6h_2region csrc/bc6h_2region.cu replaces pallas_kernels.py:3811
    bc6h_shapes csrc/bc6h_shapes.cu, the BC6H shape ranking as a launch
       of its own (partition_shapes_pallas at 32 shapes, axis_w 0,
       pallas_kernels.py:1850), for K11's candidates

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
        _call(self.symbol, tensors, ints, device)
        self.launches += 1


def _call(symbol: str, tensors, ints, device: torch.device) -> None:
    """Call a C entry point of the kernel library on the device's current
    stream (a tensor given as None passes a null pointer); raise if it
    reports a CUDA error."""
    lib = _build.library({k.symbol: (k.n_ptrs, k.n_ints)
                          for k in KERNELS.values()})
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(lib, symbol)(
            *(None if t is None else t.data_ptr() for t in tensors), *ints,
            stream)
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc} at launch")


KERNELS = {
    "bc7_decode": CudaKernel("bc7_decode_launch", 2, 1),
    "bc7_encode": CudaKernel("bc7_encode_launch", 4, 2),
    "bc7_encode_quick": CudaKernel("bc7_encode_quick_launch", 4, 2),
    "bc7_encode_maxq": CudaKernel("bc7_encode_maxq_launch", 4, 2),
    "bc7_alpha_list": CudaKernel("bc7_alpha_list_launch", 3, 1),
    "bc7_mode7": CudaKernel("bc7_mode7_launch", 6, 2),
    "bc7_mode_buckets": CudaKernel("bc7_mode_buckets_launch", 4, 2),
    "bc7_refine": CudaKernel("bc7_refine_launch", 5, 6),
    "bc7_refine_alpha": CudaKernel("bc7_refine_launch", 5, 6),
    "bc7_refine_maxq": CudaKernel("bc7_refine_launch", 5, 6),
    "bc7_refine_ladder": CudaKernel("bc7_refine_launch", 5, 6),
    "bc6h_decode": CudaKernel("bc6h_decode_launch", 2, 2),
    "bc6h_encode": CudaKernel("bc6h_encode_launch", 3, 2),
    "bc6h_unit_buckets": CudaKernel("bc6h_unit_buckets_launch", 4, 1),
    "bc6h_refine": CudaKernel("bc6h_refine_launch", 5, 8),
    "bc6h_refine_cross2": CudaKernel("bc6h_refine_launch", 5, 8),
    "bc7_partition_shapes": CudaKernel("bc7_partition_shapes_launch", 2, 3),
    "bc7_partition_mode": CudaKernel("bc7_partition_mode_launch", 4, 4),
    "bc7_refine_3sub": CudaKernel("bc7_refine_launch", 5, 6),
    "bc7_refine_3sub_ladder": CudaKernel("bc7_refine_launch", 5, 6),
    "bc7_single_modes": CudaKernel("bc7_single_modes_launch", 3, 2),
    "bc6h_1region": CudaKernel("bc6h_1region_launch", 3, 2),
    "bc6h_shapes": CudaKernel("bc6h_shapes_launch", 2, 1),
    "bc6h_2region": CudaKernel("bc6h_2region_launch", 4, 4),
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
    (TIER_DEFAULT, (6,)): "bc7_encode_quick",
    (TIER_MAXQ, (1, 3, 5, 6, 4)): "bc7_encode_maxq",
    (TIER_MAXQ, (6,)): "bc7_encode_quick"}
# the searches with mode 7: the tier's search without it, then mode 7's
# launches (bc7_alpha_list, bc7_mode7)
_BC7_MODES = (1, 3, 5, 6, 4)
_BC7_MODES_ALPHA = (1, 3, 5, 6, 7, 4)


def bc7_encode(px: torch.Tensor, modes: tuple = _BC7_MODES,
               aw: float = 1.0, tier: str = TIER_DEFAULT):
    """K2: px [64, NB] int32 (0..255) -> (err [NB] f32, words [4, NB]
    int32), the search over `modes`: (1, 3, 5, 6, 4), (1, 3, 5, 6, 7, 4)
    or (6,) (QUICK), of TIER_DEFAULT (shared fits) or TIER_MAXQ (every
    mode fitted on its own), with the alpha channel's squared error
    weighted by aw. With mode 7: the search without it (bc7_search_picks),
    then bc7_alpha_list and bc7_mode7, which folds mode 7 into its result
    in the order (1, 3, 5, 6, 7, 4)."""
    _check(px, "px", 64)
    modes = tuple(modes)
    if modes == _BC7_MODES_ALPHA:
        err, words, picks = bc7_search_picks(px, aw, tier)
        blocks, count = bc7_alpha_list(px)
        bc7_mode7(px, picks, blocks, count, err, words, aw)
        return err, words
    variant = _BC7_ENCODE_VARIANTS.get((tier, modes))
    if variant is None:
        raise ValueError(f"K2 searches {tuple(_BC7_ENCODE_VARIANTS)} and "
                         f"{_BC7_MODES_ALPHA} in either tier; got "
                         f"{(tier, modes)}")
    return _encode(px, variant, aw, None)


def _encode(px, variant: str, aw: float, picks):
    nb = px.shape[1]
    err = torch.empty(nb, dtype=torch.float32, device=px.device)
    words = torch.empty((4, nb), dtype=torch.int32, device=px.device)
    if nb:
        KERNELS[variant].launch((px, err, words, picks),
                                (nb, _f32_bits(aw)), px.device)
    return err, words


def bc7_search_picks(px: torch.Tensor, aw: float = 1.0,
                     tier: str = TIER_DEFAULT):
    """K2's (1, 3, 5, 6, 4) search of `tier` that also writes the shapes it
    ranked: px [64, NB] int32 -> (err [NB] f32, words [4, NB] int32,
    picks [4, NB] int32, the top 4 of the 64 two-subset shapes in rank
    order, K9's (1, 64) picks)."""
    _check(px, "px", 64)
    variant = _BC7_ENCODE_VARIANTS.get((tier, _BC7_MODES))
    if variant is None:
        raise ValueError(f"tier {tier!r}: {TIER_DEFAULT!r} or {TIER_MAXQ!r}")
    picks = torch.empty((4, px.shape[1]), dtype=torch.int32,
                        device=px.device)
    err, words = _encode(px, variant, aw, picks)
    return err, words, picks


def bc7_alpha_list(px: torch.Tensor):
    """Mode 7's list pass: px [64, NB] int32 -> (blocks [NB] int32, count
    [1] int32): the count[0] blocks with some alpha below 255 in
    blocks[:count[0]], in no fixed order (each warp's in lane order); the
    rest unset. The count stays on the card."""
    _check(px, "px", 64)
    nb = px.shape[1]
    blocks = torch.empty(nb, dtype=torch.int32, device=px.device)
    if not nb:
        return blocks, torch.zeros(1, dtype=torch.int32, device=px.device)
    count = torch.empty(1, dtype=torch.int32, device=px.device)
    # the launcher zeroes the count before the pass
    KERNELS["bc7_alpha_list"].launch((px, blocks, count), (nb,), px.device)
    return blocks, count


def bc7_mode7(px: torch.Tensor, picks: torch.Tensor, blocks: torch.Tensor,
              count: torch.Tensor, err: torch.Tensor, words: torch.Tensor,
              aw: float = 1.0) -> None:
    """Mode 7 of the listed blocks (bc7_alpha_list's blocks and count) on
    their four shapes (picks [4, NB] int32), each fitted on its own, folded
    in place into a (1, 3, 5, 6, 4) search's err [NB] f32 and words
    [4, NB] int32 as the fold over (1, 3, 5, 6, 7, 4) would: mode 7 takes
    a block where its error is below the search's, or equal to it where
    the search's words are mode 4's."""
    _check(px, "px", 64)
    nb = px.shape[1]
    _check(picks, "picks", 4, nb)
    _check(words, "words", 4, nb)
    for t, name, shape, dtype in ((blocks, "blocks", (nb,), torch.int32),
                                  (count, "count", (1,), torch.int32),
                                  (err, "err", (nb,), torch.float32)):
        if t.device != px.device or tuple(t.shape) != shape \
                or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"tensor on {px.device}")
    if picks.device != px.device or words.device != px.device:
        raise ValueError("px, picks and words must be on one device")
    if nb:
        KERNELS["bc7_mode7"].launch((px, picks, blocks, count, err, words),
                                    (nb, _f32_bits(aw)), px.device)


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


def bc7_mode_buckets(words: torch.Tensor, mode_mask: int):
    """K3's bucket pass: words [4, NB] int32 -> (a copy of the words,
    lists [8, NB] int32, counts [8] int32): for each mode m in mode_mask,
    counts[m] blocks of mode m, their indices in lists[m, :counts[m]] in
    no fixed order (each warp's in lane order); the rest of lists is
    unset."""
    _check(words, "words", 4)
    nb = words.shape[1]
    if not 0 <= mode_mask < 256:
        raise ValueError(f"mode_mask {mode_mask}: bits 0-7 are the modes")
    out = torch.empty_like(words)
    lists = torch.empty((8, nb), dtype=torch.int32, device=words.device)
    if not nb:
        return out, lists, torch.zeros(8, dtype=torch.int32,
                                       device=words.device)
    counts = torch.empty(8, dtype=torch.int32, device=words.device)
    # the launcher zeroes the counts before the pass
    KERNELS["bc7_mode_buckets"].launch((words, out, lists, counts),
                                       (nb, mode_mask), words.device)
    return out, lists, counts


def _refine_count_names(modes: tuple, exact: bool) -> dict:
    """The launch count of each mode's launch: modes 0 and 2 apart, the
    others by their scope."""
    rest = tuple(m for m in modes if m not in (0, 2))
    name = ("bc7_refine_ladder" if exact else
            "bc7_refine_maxq" if 6 in rest else
            "bc7_refine_alpha" if 7 in rest else "bc7_refine")
    sub3 = "bc7_refine_3sub_ladder" if exact else "bc7_refine_3sub"
    return {m: sub3 if m in (0, 2) else name for m in modes}


def bc7_refine(px: torch.Tensor, words: torch.Tensor, modes: tuple,
               aw: float = 1.0, ladder="moment") -> torch.Tensor:
    """K3: winner-refine of the blocks whose mode is in `modes` (a subset
    of 0..7) with one ladder: "moment" (LADDER_MOMENT) or an exact
    (rounds, deltas) ladder (0-15 rounds, 1-4 deltas in 1..127), the alpha
    channel's squared error weighted by aw. px [64, NB], words [4, NB]
    int32 -> words [4, NB] int32. The bucket pass copies the words and
    sorts the in-scope blocks into one list per mode; then one launch per
    mode refines its list into the copy, all from one call into the
    kernel library. Each block is read and written by its own mode's
    launch only, so the words are those of one pass over the whole
    scope. No host sync: the bucket sizes stay on the card."""
    _check(words, "words", 4)
    nb = words.shape[1]
    _check(px, "px", 64, nb)
    if px.device != words.device:
        raise ValueError(f"px on {px.device}, words on {words.device}")
    for m in modes:
        if m not in range(8):
            raise ValueError(f"K3 refines modes 0-7; got {m}")
    scope = tuple(sorted(set(modes)))
    lad = (0, 0, 0) if ladder == "moment" else (1, *bc7_ladder_ints(ladder))
    out = torch.empty_like(words)
    if not nb:
        return out
    lists = torch.empty((8, nb), dtype=torch.int32, device=words.device)
    counts = torch.empty(8, dtype=torch.int32, device=words.device)
    _call("bc7_refine_launch", (px, words, out, lists, counts),
          (nb, sum(1 << m for m in scope), _f32_bits(aw)) + lad, px.device)
    # that call launched the bucket pass and one kernel per mode in scope
    KERNELS["bc7_mode_buckets"].launches += 1
    for name in _refine_count_names(scope, bool(lad[0])).values():
        KERNELS[name].launches += 1
    return out


def bc7_partition_shapes(px: torch.Tensor, partitions: int, n_shapes: int,
                         n_cand: int = 4) -> torch.Tensor:
    """K9: px [64, NB] int32 -> s_blks [n_cand, NB] int32, the top n_cand
    of the first n_shapes shapes with partitions + 1 subsets by the
    off-axis estimate at _ON_AXIS_W. Takes what the BC7 callers use:
    (partitions, n_shapes) (2, 16) for mode 0, (2, 64) for mode 2 and
    (1, 64) for modes 1, 3 and 7; n_cand 4."""
    if (partitions, n_shapes) not in ((2, 16), (2, 64), (1, 64)) \
            or n_cand != 4:
        raise ValueError(f"K9 ranks (partitions, n_shapes) (2, 16), (2, 64) "
                         f"or (1, 64) into 4 candidates; got partitions="
                         f"{partitions}, n_shapes={n_shapes}, "
                         f"n_cand={n_cand}")
    _check(px, "px", 64)
    nb = px.shape[1]
    s_blks = torch.empty((n_cand, nb), dtype=torch.int32, device=px.device)
    if nb:
        KERNELS["bc7_partition_shapes"].launch(
            (px, s_blks), (nb, partitions, n_shapes), px.device)
    return s_blks


def bc7_partition_mode(px: torch.Tensor, s_blks: torch.Tensor, mode_id: int,
                       aw: float = 1.0):
    """K7: px [64, NB] int32, s_blks [C, NB] int32 shape candidates (mode
    0: shapes 0..15) -> (err [NB] f32, words [4, NB] int32) of partition
    mode mode_id (0, 1, 2, 3 or 7), the alpha channel's squared error
    weighted by aw."""
    _check(px, "px", 64)
    nb = px.shape[1]
    if s_blks.dim() != 2 or s_blks.shape[0] < 1:
        raise ValueError(f"s_blks must be [C, NB] int32, got "
                         f"{tuple(s_blks.shape)}")
    _check(s_blks, "s_blks", s_blks.shape[0], nb)
    if px.device != s_blks.device:
        raise ValueError(f"px on {px.device}, s_blks on {s_blks.device}")
    if mode_id not in (0, 1, 2, 3, 7):
        raise ValueError(f"K7 evaluates modes 0, 1, 2, 3, 7; got {mode_id}")
    err = torch.empty(nb, dtype=torch.float32, device=px.device)
    words = torch.empty((4, nb), dtype=torch.int32, device=px.device)
    if nb:
        KERNELS["bc7_partition_mode"].launch(
            (px, s_blks, err, words),
            (nb, s_blks.shape[0], mode_id, _f32_bits(aw)), px.device)
    return err, words


def bc7_single_modes(px: torch.Tensor, aw: float = 1.0):
    """K8: px [64, NB] int32 (0..255) -> (err [3, NB] f32, words [3, 4, NB]
    int32), the best of modes 4, 5 and 6 (in that order) over rotations
    0-3 and mode-4 index mode 0, each candidate fitted on its own, the
    alpha channel's squared error weighted by aw."""
    _check(px, "px", 64)
    nb = px.shape[1]
    err = torch.empty((3, nb), dtype=torch.float32, device=px.device)
    words = torch.empty((3, 4, nb), dtype=torch.int32, device=px.device)
    if nb:
        KERNELS["bc7_single_modes"].launch((px, err, words),
                                           (nb, _f32_bits(aw)), px.device)
    return err, words


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


def bc6h_1region(px: torch.Tensor, signed: bool):
    """K10: px [48, NB] int32 F16-ints -> (err [NB] f32, words [4, NB]
    int32), rows 10-13 each evaluated in full and folded in row order."""
    _check(px, "px", 48)
    nb = px.shape[1]
    err = torch.empty(nb, dtype=torch.float32, device=px.device)
    words = torch.empty((4, nb), dtype=torch.int32, device=px.device)
    if nb:
        KERNELS["bc6h_1region"].launch((px, err, words),
                                       (nb, int(bool(signed))), px.device)
    return err, words


def bc6h_shapes(px: torch.Tensor) -> torch.Tensor:
    """The BC6H shape ranking: px [48, NB] int32 F16-ints -> s_blks
    [4, NB] int32, the top 4 of the 32 two-region shapes by the off-axis
    estimate at axis_w 0, in rank order."""
    _check(px, "px", 48)
    nb = px.shape[1]
    s_blks = torch.empty((4, nb), dtype=torch.int32, device=px.device)
    if nb:
        KERNELS["bc6h_shapes"].launch((px, s_blks), (nb,), px.device)
    return s_blks


def bc6h_2region(px: torch.Tensor, s_blks: torch.Tensor, group: int,
                 signed: bool):
    """K11: px [48, NB] int32 F16-ints, s_blks [C, NB] int32 shapes 0..31
    -> (err [NB] f32, words [4, NB] int32), the rows of precision group
    `group` (0-5: rows (0,) (1,) (2, 3, 4) (5,) (6, 7, 8) (9,)) over the
    candidates, each evaluated in full once for the group."""
    _check(px, "px", 48)
    nb = px.shape[1]
    if s_blks.dim() != 2 or s_blks.shape[0] < 1:
        raise ValueError(f"s_blks must be [C, NB] int32, got "
                         f"{tuple(s_blks.shape)}")
    _check(s_blks, "s_blks", s_blks.shape[0], nb)
    if px.device != s_blks.device:
        raise ValueError(f"px on {px.device}, s_blks on {s_blks.device}")
    if group not in range(6):
        raise ValueError(f"K11 launches precision groups 0-5; got {group}")
    err = torch.empty(nb, dtype=torch.float32, device=px.device)
    words = torch.empty((4, nb), dtype=torch.int32, device=px.device)
    if nb:
        KERNELS["bc6h_2region"].launch(
            (px, s_blks, err, words),
            (nb, s_blks.shape[0], group, int(bool(signed))), px.device)
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


def bc6h_unit_buckets(words: torch.Tensor):
    """K6's bucket pass: words [4, NB] int32 -> (a copy of the words,
    lists [3, NB] int32, counts [3] int32): counts[u] blocks of unit u (0:
    one-region winners, rows 10-13; 1: two-region winners, rows 0-9; 2:
    reserved modes), their indices in lists[u, :counts[u]] in no fixed
    order (each warp's in lane order); the rest of lists is unset."""
    _check(words, "words", 4)
    nb = words.shape[1]
    out = torch.empty_like(words)
    lists = torch.empty((3, nb), dtype=torch.int32, device=words.device)
    if not nb:
        return out, lists, torch.zeros(3, dtype=torch.int32,
                                       device=words.device)
    counts = torch.empty(3, dtype=torch.int32, device=words.device)
    # the launcher zeroes the counts before the pass
    KERNELS["bc6h_unit_buckets"].launch((words, out, lists, counts), (nb,),
                                        words.device)
    return out, lists, counts


def bc6h_refine(px: torch.Tensor, words: torch.Tensor, ladder, ladder2,
                signed: bool, remap: bool, cross2: bool) -> torch.Tensor:
    """K6: the winner-refine ladder. px [48, NB], words [4, NB] int32 ->
    words [4, NB] int32. ladder / ladder2: (rounds, deltas) of the
    one-region and two-region units. The bucket pass copies the words and
    lists each unit's blocks; then one launch per unit runs its blocks'
    ladders as lane jobs (one-region: one per precision; two-region: one
    per subset, and with cross2 per precision group and subset) and folds
    each block, all from one call into the kernel library. No host sync:
    the bucket sizes stay on the card. Counted as the bucket pass and two
    launches of bc6h_refine_cross2 (cross2) or bc6h_refine."""
    _check(words, "words", 4)
    nb = words.shape[1]
    _check(px, "px", 48, nb)
    if px.device != words.device:
        raise ValueError(f"px on {px.device}, words on {words.device}")
    flags = int(bool(signed)) | int(bool(remap)) << 1 | int(bool(cross2)) << 2
    out = torch.empty_like(words)
    if not nb:
        return out
    lists = torch.empty((3, nb), dtype=torch.int32, device=words.device)
    counts = torch.empty(3, dtype=torch.int32, device=words.device)
    _call("bc6h_refine_launch", (px, words, out, lists, counts),
          (nb, *_ladder_ints(ladder), *_ladder_ints(ladder2), flags),
          px.device)
    # that call launched the bucket pass and one kernel per unit
    KERNELS["bc6h_unit_buckets"].launches += 1
    KERNELS["bc6h_refine_cross2" if cross2 else "bc6h_refine"].launches += 2
    return out
