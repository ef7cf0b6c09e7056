#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one GPU.

Drives the port's paths through their hand-written CUDA kernels and holds
every kernel against its plain PyTorch twin on the card:

- the BC7 default tier (image_to_blocks -> encode_bc7 -> decode_bc7): K1
  decode, K2 search, K3 MOMENT refine (its bucket pass, then one launch
  per mode in scope); on opaque images (K2's search, a team of four
  warps per 32 blocks), on images with alpha (the same search, which
  also writes the shapes it ranked, then mode 7's list pass and launch
  on those shapes, a team of four warps per 32 listed blocks, one
  candidate a warp, folded in; K3 with mode 7 in scope), at alpha weights
  1.0 and 2.0, and the QUICK tier (K2's quick variant, mode 6 alone);
- the BC7 MAXQUALITY tier (encode_bc7(flags=0x200000)): K2's maxq
  search (every mode fitted on its own; a team of four warps per 32
  blocks running a block's 21 evaluations as jobs, both subsets of a
  two-subset fit in one pass; with alpha followed by mode 7's list pass
  and launch), K3 twice, MOMENT with mode 6 in scope, then the exact
  LADDER_FULL;
- BC6H (BASELINE config 4, hdr_cubemap_pipeline -> decode_bc6h, and the
  mid / maxq tiers of encode_bc6h): K4 decode, K5 search (lane jobs: a
  CTA of four warps per 32 blocks, the one-region job and one job per
  shape candidate a block), K6 refine (a unit bucket pass, then a launch
  of lane jobs per unit);
- USE_3SUBSETS (encode_bc7(flags=0x80000), with MAXQUALITY 0x280000):
  one K9 launch (a team of four warps per 32 blocks) ranks the
  three-subset shapes for both modes, 0..15 for mode 0 and all 64 for
  mode 2, K7 (a team, one candidate a warp, every subset of a candidate
  fitted in one pass) evaluates each mode's top 4, K2 searches the other
  modes, and K3 refines modes 0 and 2 as two more of its per-mode
  launches;
- BC6H with bc6h.BC6H_SHARED_FIT = False (encode_bc6h in every tier, and
  so config 4): K10 (rows 10-13, each evaluated in full), the BC6H shape
  ranking (a team of four warps per 32 blocks, one slice of the 32
  shapes a warp, the slices' lists merged), one K11 launch of lane jobs
  for the six precision groups, a
  strict-`<` fold of the two results in torch, then K6 for the mid and
  maxq tiers;
- K8, bc67.bc7_single_modes: modes 4, 5 and 6 in one pass (a team of
  five warps per 32 blocks, one job a warp: a rotation's modes 4 and 5,
  or mode 6);
- BC1-BC5 and BASELINE configs 1, 2 and 5 (models.pipelines): the
  codecs, sRGB conversion, the box mips and the normal map are plain
  torch ops on the card, held against the port on the CPU; config 5's
  BC7 runs K2's default team and K3's MOMENT launches.

Phases:

  0. device: the card's name and power limit, torch, CUDA and nvcc;
  1. build: nvcc builds the kernels from directxtex_tpu_torch/csrc; ptxas
     registers, stack and spills per kernel instance, and those of the
     kernels that keep their recorded build (PTXAS_RECORDED) held to it;
  2. K1 (a lane a block parses the headers, then sixteen lanes a block
     write the pixels; two epilogues, the words API's int32 planes and
     decode_bc7's f32): bit for
     bit equal to their plain versions on tests/golden/decode_vectors.npz,
     on 262,144 random mixed-mode words (every 97th reserved: transparent
     black) and on 32,768 random words of each mode;
  3. K2: kernel search vs plain search on bench512.npz and the opaque
     corpus.npz contents: words and errors equal (bench512 also at alpha
     weight 2.0);
  4. K3: kernel refine vs plain refine on the same input words: equal;
     K3's bucket pass vs its plain twin: equal counts, each bucket the
     same set;
  5. 512^2 gate: encode_bc7 -> decode_bc7 PSNR >= the frozen reference's;
  6. the 2048^2 bench image through the BC7 path, with launch counts,
     CUDA-event times of the path and of each kernel (K3 as its
     launcher's whole call, the bucket pass and a plain copy of the words
     also alone), the bucket counts, and one run of the plain path on the
     same inputs, held against the kernels' output (K2 at both weights,
     words and errors equal; K1's epilogues on the path's words); then
     decode: decode_bc7 as a path (one CUDA kernel in a torch.profiler
     record), K1's f32 and words epilogues, and K1
     on the random mixed words, CUDA-event times beside their bounds;
  7. K4 (as K1, two epilogues): bit-exact on the
     golden BC6H vectors and equal to the plain versions on them, on
     262,144 random words and on 32,768 random words of each mode row,
     unsigned and signed;
  8. K5 and K6 (mid, maxq): kernel vs plain on the five HDR corpus
     contents and the 200-block random / bimodal set, unsigned and
     signed: words equal, and K5's search errors equal (on the random
     sets also K5's lane jobs in plain form, folded); K6's unit bucket
     pass vs its twin on each content's words;
  9. BC6H gates: the corpus PSNR floors and the frozen reference's
     bc6h_hdr_psnr through encode_bc6h -> decode_bc6h on the card;
 10. config 4 at face 512: the path with launch counts and CUDA-event
     times, each kernel's time at the path's shapes, decode_bc6h as a path
     (one CUDA kernel in a profiler record) and K4's epilogues and header
     modes on the path's words (held against their plain versions, signed
     and unsigned), one run of each plain
     twin held against its kernel (K6 mid on every block, K6 maxq on the
     first MAXQ_PLAIN_BLOCKS, the bucket pass), the unit counts, and the
     mid / maxq tiers on the same faces with their launch counts (K5, the
     bucket pass, two K6 unit launches);
 11. the search with mode 7 and K3 (mode 7 in scope) against their twins
     on bench512, alphagrad, the 200-block mixed set (half opaque) and
     the 2048^2 image with alpha, at alpha weights 1.0 and 2.0: words and
     search errors equal, and each step alone (K2's search and its picks,
     mode 7's list pass and its launch) equal to its twin (mode 7's
     launch also to its team in plain form, bc67._mode7_jobs_plain);
 12. K2 quick against its twin on bench512.npz and both 2048^2 images,
     at alpha weights 1.0 and 2.0;
 13. BC7 gates on the card: the alphagrad corpus floor and the frozen
     reference parity of albedo, tworegion, normal and alphagrad;
 14. the 2048^2 image with alpha through the default path and the QUICK
     path (on both 2048^2 images), each with its launch counts (with
     alpha: K2, the list pass, mode 7, K3), and CUDA-event times of the
     paths and kernels beside the opaque path's, with mode 7's device
     time from a torch.profiler record;
 15. K2 maxq (both variants) and K3 (MOMENT with mode 6 in scope, FULL,
     LIGHT, and mode 6 alone on QUICK's words) against their twins on
     bench512, the opaque corpus, alphagrad and the 200-block mixed set,
     at alpha weights 1.0 and 2.0: words and search errors equal (on
     alphagrad and the mixed set also the search with picks against the
     maxq team's jobs in plain form, folded);
 16. maxq gates on the card: PSNR no worse than the default tier's less
     0.001 dB on bench512 and every BC7 corpus content
     (tests/test_bc7.py:200-214), bench512 at least the frozen
     reference's, and a sample of the maxq words decoded by K1 equal to
     the plain decode;
 17. the maxq path at 2048^2 on the bench image and on the image with
     alpha, each with its launch counts (one K2, with alpha the list pass
     and mode 7; per K3 ladder a bucket pass and a launch per mode),
     CUDA-event times of the paths and kernels beside the default tier's
     (mode 7's launch on the maxq search's picks also by device time),
     and one run of each plain twin at the path's shapes held against its
     kernel (the search on both images at alpha weights 1.0 and 2.0,
     with mode 7 on the image with alpha, with its picks on the bench
     image; mode 7's launch alone on the maxq picks at both weights);
 18. K9 (the path's one launch that gives both three-subset lists, and
     the wrapper's three subsets at 16 and 64 shapes and two subsets at
     64), K7 (modes 0 and 2 on the three-subset picks, 1, 3 and 7 on the
     two-subset picks; on the synthetic batch and the mixed set also
     against its candidate jobs in plain form, folded), the search with
     modes 0 and 2 (K9, K7, K2 and the fold) and
     K3 over modes 0 and 2 (MOMENT, FULL, LIGHT; and over a whole scope)
     against their twins on bench512, the
     opaque corpus, alphagrad, the 200-block mixed set and the synthetic
     three-gradient batch of tests/golden/bc7_3subsets.npz, at alpha
     weights 1.0 and 2.0: picks, words and errors equal;
 19. USE_3SUBSETS gates: bench512 at least the frozen reference's PSNR,
     beside the default tier's; tests/test_bc7.py's img_blocks content
     above 36 dB; every BC7 corpus content's PSNR at 0x80000 and
     0x280000;
 20. the USE_3SUBSETS paths at 2048^2 (default and maxq tiers, opaque and
     with alpha), each with its launch counts (one K9, two K7, one K2,
     and per K3 ladder a bucket pass and a launch per mode), winner
     histograms, CUDA-event times of the paths
     and kernels beside the default and maxq paths' (K9 as the path's one
     launch, K7 per mode), and one run of each new kernel's plain twin at
     the path's shapes held against it, on the opaque image's inputs and
     on the image with alpha's (its own picks, search words and MOMENT
     words, both tiers);
 21. K10, the BC6H ranking and K11 (one launch over the six precision
     groups, and each group alone) against their twins on the HDR corpus
     contents, the 200-block random / bimodal set and the 520 blocks of
     tests/golden/bc6h_unshared.npz (there also at the JAX package's
     picks, and against K11's lane jobs in plain form), and on config 4's
     98,304 face-512 blocks (the twins on the first 16,384), unsigned and
     signed: picks, words and errors equal (K10's twin folds its rows'
     results, bc6h._bc6h_1region_rows_plain, row 10 first; the ranking's
     picks also equal
     its team in plain form, bc6h._bc6h_shapes_slices_plain, and on
     config 4 on every block; on bc6h_unshared.npz they meet the JAX
     package's frozen picks on every block but the two recorded
     summation-order near-ties, 462 unsigned and 18 signed);
 22. the BC6H_SHARED_FIT=False paths: config 4 at face 512 with its launch
     counts (one K10, one ranking, one K11, one K4) and its words held
     against the plain twins' fold, CUDA-event times of the path, of the
     default, mid and maxq encodes of the same faces and of each kernel
     (K11 also by device time, and each group's launch alone), beside the
     shared-fit path's in the same phase;
 23. BC6H gates with the flag off: the frozen reference's bc6h_hdr_psnr,
     and each corpus content within 0.05 dB of the JAX package's own
     flag-off encode (tests/golden/bc6h_unshared.npz, decoded by K4) and
     at its floor, or at that PSNR where it is below the floor (the
     floors are the shipped search's);
 24. K8 on the 2048^2 bench image and on that image with alpha, at alpha
     weights 1.0 and 2.0, through bc67.bc7_single_modes with its launch
     count: each mode's words and errors equal the twins' and the team's
     plain form's (bc67._single_modes_jobs_plain, folded), and the errors
     equal the decoded (K1) squared error at weight 1.0;
 25. BC1-BC5 gates on the card: the bc1-bc5 golden decode vectors bit
     for bit (BC4/BC5 signed and unsigned), the corpus PSNR floors and
     the frozen reference parity of tests/test_golden.py, the card's
     words equal to the CPU port's on those contents;
 26. config 1 (benchmarks/run_all.py:61-84): the 1024^2 image (rng 0),
     srgb off, through mipped_compress_pipeline("bc1"), 11 levels and
     87,383 blocks, no hand kernel launched, the words equal to the CPU
     port's; CUDA-event times of the path, the mip glue and the BC1
     encode with their spread, device time and kernel count from a
     profiler record; srgb on once, its words equal to the CPU port's
     wherever the encoder input is;
 27. config 2 (run_all.py:86-112): 64 x 256^2 (rng 1), sRGB -> linear
     and premultiply, then BC3, BC4U and BC5U over 262,144 blocks each;
     the count of linearised values that differ from the CPU port's,
     the words equal to the CPU port's on images 0, 9, ..., 63; times of
     the step and of each piece, device times of the encoders;
 28. config 5 (run_all.py:156-170): 16 x 512^2 height maps (rng 3)
     through asset_pipeline, its launches (one K2, K3's bucket pass and
     four launches), the normal maps equal to the CPU port's, the words
     equal to the plain path's on the card (K2's and K3's twins); times
     of the path, the normal map, image_to_blocks, encode_bc7 and K2 and
     K3 at its shapes beside the main path's encode, PSNR through
     decode_bc7 (K1), the winners' modes;
 29. the kernels line: every kernel's launches, error against its twin,
     time, plain time and bound (bytes or operations, whichever is
     larger, at the H100's published peaks, for the work each block of
     the run needs), and for mode 7's launch, K11, K8, the ranking, K10
     and K2 quick the device time of a call in a torch.profiler record of
     its own (phase kernel_profile, after phase 6, which also checks the
     CUDA kernel each of them runs by name).

Each phase prints one JSON line; any failure raises, so the script exits
nonzero without the final ok line. Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SOURCES = {
    "bc7_decode": ("directxtex_tpu_torch/csrc/bc7_decode.cu",
                   "directxtex_tpu/bc/pallas_kernels.py:2735"),
    "bc7_encode": ("directxtex_tpu_torch/csrc/bc7_encode.cuh",
                   "directxtex_tpu/bc/pallas_kernels.py:2020"),
    "bc7_mode_buckets": ("directxtex_tpu_torch/csrc/bc7_refine.cu",
                         "directxtex_tpu/bc/pallas_kernels.py:2667"),
    "bc7_refine": ("directxtex_tpu_torch/csrc/bc7_refine.cuh",
                   "directxtex_tpu/bc/pallas_kernels.py:2667"),
    "bc7_alpha_list": ("directxtex_tpu_torch/csrc/bc7_mode7.cu",
                       "directxtex_tpu/bc/pallas_kernels.py:2020"),
    "bc7_mode7": ("directxtex_tpu_torch/csrc/bc7_mode7.cu",
                  "directxtex_tpu/bc/pallas_kernels.py:2020"),
    "bc7_encode_quick": ("directxtex_tpu_torch/csrc/bc7_encode.cuh",
                         "directxtex_tpu/bc/pallas_kernels.py:2020"),
    "bc7_refine_alpha": ("directxtex_tpu_torch/csrc/bc7_refine.cuh",
                         "directxtex_tpu/bc/pallas_kernels.py:2667"),
    "bc7_encode_maxq": ("directxtex_tpu_torch/csrc/bc7_encode.cuh",
                        "directxtex_tpu/bc/pallas_kernels.py:2020"),
    "bc7_refine_maxq": ("directxtex_tpu_torch/csrc/bc7_refine.cuh",
                        "directxtex_tpu/bc/pallas_kernels.py:2667"),
    "bc7_refine_ladder": ("directxtex_tpu_torch/csrc/bc7_refine.cuh",
                          "directxtex_tpu/bc/pallas_kernels.py:2667"),
    "bc6h_decode": ("directxtex_tpu_torch/csrc/bc6h_decode.cu",
                    "directxtex_tpu/bc/pallas_kernels.py:2784"),
    "bc6h_encode": ("directxtex_tpu_torch/csrc/bc6h_encode.cu",
                    "directxtex_tpu/bc/pallas_kernels.py:3744"),
    "bc6h_unit_buckets": ("directxtex_tpu_torch/csrc/bc6h_refine.cu",
                          "directxtex_tpu/bc/pallas_kernels.py:3704"),
    "bc6h_refine": ("directxtex_tpu_torch/csrc/bc6h_refine.cu",
                    "directxtex_tpu/bc/pallas_kernels.py:3704"),
    "bc6h_refine_cross2": ("directxtex_tpu_torch/csrc/bc6h_refine.cu",
                           "directxtex_tpu/bc/pallas_kernels.py:3704"),
    "bc7_partition_shapes": ("directxtex_tpu_torch/csrc/bc7_shapes.cu",
                             "directxtex_tpu/bc/pallas_kernels.py:1850"),
    "bc7_partition_mode": ("directxtex_tpu_torch/csrc/bc7_partition.cuh",
                           "directxtex_tpu/bc/pallas_kernels.py:1414"),
    "bc7_refine_3sub": ("directxtex_tpu_torch/csrc/bc7_refine.cuh",
                        "directxtex_tpu/bc/pallas_kernels.py:2667"),
    "bc7_refine_3sub_ladder": ("directxtex_tpu_torch/csrc/bc7_refine.cuh",
                               "directxtex_tpu/bc/pallas_kernels.py:2667"),
    "bc6h_1region": ("directxtex_tpu_torch/csrc/bc6h_1region.cu",
                     "directxtex_tpu/bc/pallas_kernels.py:3789"),
    "bc6h_shapes": ("directxtex_tpu_torch/csrc/bc6h_shapes.cu",
                    "directxtex_tpu/bc/pallas_kernels.py:1850"),
    "bc6h_2region": ("directxtex_tpu_torch/csrc/bc6h_2region.cu",
                     "directxtex_tpu/bc/pallas_kernels.py:3811"),
    "bc7_single_modes": ("directxtex_tpu_torch/csrc/bc7_single_modes.cu",
                         "directxtex_tpu/bc/pallas_kernels.py:1714"),
}
# Operations each kernel's function needs per 4x4 block, as printed by
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_op_counts.py`:
# the JAX twins' elementwise operations without their lane masking, a
# two-region candidate's per-pixel work over its subsets' own 16 pixels.
# The searches do the same work for every block; the decoders and the
# refines do one mode's (one winner class's) work, weighed here by the
# blocks of the run that have it.
BC7_SEARCH_OPS = 89073
# K2's quick variant (mode 7's launch, on a block with alpha, costs
# BC7_PARTITION_OPS[7])
BC7_SEARCH_QUICK_OPS = 4641
BC6H_SEARCH_OPS = 173630
BC7_DECODE_OPS = (1461, 1337, 1557, 1295, 859, 816, 518, 1373)  # per mode
BC7_REFINE_OPS = {1: 5612, 3: 5432, 5: 4869, 7: 6336,
                  4: 6908, 6: 3402, 0: 6264, 2: 6336}
# K2's maxq variant
BC7_SEARCH_MAXQ_OPS = 144081
# K3 under LADDER_FULL and LADDER_LIGHT, per winner mode
BC7_REFINE_FULL_OPS = {1: 12256, 3: 11692, 5: 13521, 6: 12134, 7: 15064,
                       4: 15624, 0: 13038, 2: 12822}
BC7_REFINE_LIGHT_OPS = {1: 6136, 3: 5908, 5: 6153, 6: 4822, 7: 6904,
                        4: 8200, 0: 6450, 2: 6486}
BC6H_DECODE_OPS = (1436, 1442, 1432, 1440, 1436, 1436, 1432, 1444, 1444,
                   1410, 598, 668, 680, 644)      # per mode row, unsigned
# K6's maxq refine (cross2) and mid refine of a one-region (rows 10-13)
# and a two-region winner
BC6H_REFINE_OPS = {"one_region": 815084, "two_region": 1294096}
BC6H_REFINE_MID_OPS = {"one_region": 143564, "two_region": 39517}
# bytes each block must move, inputs read once and outputs written once at
# the data's own width: u8 texels, f16 pixels and halves, 16-byte words
# (the decoders: 16 bytes of packed block in, decode's f32 [16, 4] out,
# 256 bytes; the words API's int32 planes, DECODE_WORDS_BYTES)
BYTES_PER_BLOCK = {"bc7_decode": 16 + 256, "bc7_encode": 64 + 16,
                   # K3's bucket pass: the words read, their copy and one
                   # list entry written
                   "bc7_mode_buckets": 16 + 16 + 4,
                   "bc7_refine": 64 + 16 + 16, "bc6h_decode": 16 + 256,
                   "bc6h_encode": 96 + 16, "bc6h_refine": 96 + 16 + 16,
                   "bc6h_refine_cross2": 96 + 16 + 16,
                   # K6's bucket pass: the words read, their copy and one
                   # list entry written
                   "bc6h_unit_buckets": 16 + 16 + 4,
                   # mode 7's list pass reads a block's 16 alpha texels
                   # and writes a list entry per block with alpha
                   # (counted from the run); mode 7's launch, per block
                   # with alpha, the texels, four picks, the list entry
                   # and the search's err and words, and writes err and
                   # words
                   "bc7_alpha_list": 16,
                   "bc7_mode7": 64 + 16 + 4 + 20 + 20,
                   "bc7_encode_quick": 64 + 16,
                   "bc7_refine_alpha": 64 + 16 + 16,
                   "bc7_encode_maxq": 64 + 16,
                   "bc7_refine_maxq": 64 + 16 + 16,
                   "bc7_refine_ladder": 64 + 16 + 16,
                   # USE_3SUBSETS: K9 launches once a path and writes
                   # both modes' 4 picks; K7 launches twice (modes 0 and
                   # 2), reads 4 candidates, writes err and words
                   "bc7_partition_shapes": 64 + 2 * 16,
                   "bc7_partition_mode": 2 * (64 + 16 + 4 + 16),
                   # K3 over modes 0 and 2 reads and writes every block's
                   # words, and pixels only for a mode-0/2 block
                   # (BC7_PIXEL_BYTES each, counted from the run's winners)
                   "bc7_refine_3sub": 16 + 16,
                   "bc7_refine_3sub_ladder": 16 + 16,
                   # BC6H_SHARED_FIT=False: K10 writes err and words; the
                   # ranking 4 picks; K11's one launch for the six
                   # precision groups reads the pixels and 4 candidates
                   # once and writes err and words
                   "bc6h_1region": 96 + 4 + 16, "bc6h_shapes": 96 + 16,
                   "bc6h_2region": 96 + 16 + 4 + 16,
                   # K8: each of modes 4, 5 and 6's err and words
                   "bc7_single_modes": 64 + 3 * (4 + 16)}
BC7_PIXEL_BYTES = 64
DECODE_WORDS_BYTES = {"bc7_decode": 16 + 256, "bc6h_decode": 16 + 192}
# random words a mode (BC7) or mode row (BC6H) for the decode checks
DECODE_MODE_BLOCKS = 32768
# K3's bucket pass does a few integer operations a block: bytes bound it
BC7_BUCKET_OPS = 0
# H100 SXM published peaks: HBM bytes/s, and
# f32 elementwise operations/s = 132 SMs x 128 lanes x 1.98 GHz (the
# 67 TFLOP/s figure counts an FMA as two; the kernels build with
# --fmad=false, so every operation issues on its own)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 132 * 128 * 1.98e9
OPAQUE_CORPUS = ("albedo", "tworegion", "normal", "photo_china",
                 "photo_flower")
SLICE_SIZE = 2048          # the bench image's side (bench.py:89)
RANDOM_BLOCKS = 262144     # random words for the K1 check
HDR_CORPUS = ("hdr", "hdr_china", "hdr_flower", "hdr_sun", "hdr_signed")
# tests/test_golden.py PSNR_FLOORS of the BC6H contents: log-PSNR for
# the unsigned ones, peak-linear for hdr_signed (encoded signed)
BC6H_FLOORS = {"hdr": 45.24, "hdr_china": 32.68, "hdr_flower": 31.38,
               "hdr_sun": 51.02, "hdr_signed": 29.75}
FACE = 512                 # config 4's face (benchmarks/run_all.py:146)
MAXQ_PLAIN_BLOCKS = 16384  # blocks of the maxq plain twin run at face 512
N_BIMODAL = 40             # degenerate blocks of the signed random set
ALPHA_WEIGHTS = (1.0, 2.0)
# tests/test_golden.py: the alphagrad BC7 floor and the frozen reference
# parity margins of the BC7 contents (ref_encodes.npz)
ALPHAGRAD_FLOOR = 37.17
REF_PARITY_MARGINS = {"albedo": 0.04, "tworegion": 0.28, "normal": 2.65,
                      "alphagrad": 0.32}
# the opaque BC7 path's times with the one-thread K2 opaque and the
# single-kernel K3 (PERF.md sections 5 and 6; NVIDIA H100 80GB HBM3,
# 700 W), printed beside this run's
EARLIER_OPAQUE_MS = {"path": 3.497, "bc7_encode": 1.923,
                     "bc7_refine": 0.840, "bc7_refine_ladder": 5.721}
MAXQ = 0x200000            # encode_bc7's MAXQUALITY flag
# BC1-BC5 (tests/test_golden.py): the corpus PSNR floors, scored over
# the codec's channels, and the frozen reference parity margins
BC12345_FLOORS = {"bc1_albedo": 31.05, "bc1_tworegion": 38.77,
                  "bc2_alphagrad": 31.76, "bc3_alphagrad": 32.29,
                  "bc4_normal": 44.97, "bc5_normal": 45.01,
                  "bc1_photo_china": 29.29, "bc1_photo_flower": 30.18}
BC12345_REF_MARGINS = {"bc1_albedo": -0.03, "bc1_tworegion": -0.02,
                       "bc2_alphagrad": -0.03, "bc3_alphagrad": -0.03,
                       "bc4_normal": -0.02, "bc5_normal": -0.02}
CONFIG1_SIZE = 1024        # benchmarks/run_all.py:61-84 (rng 0)
CONFIG2_SHAPE = (64, 256)  # run_all.py:86-112: 64 images of 256^2 (rng 1)
CONFIG2_CPU_IMAGES = tuple(range(0, 64, 9))  # held against the CPU port
CONFIG5_SHAPE = (16, 512)  # run_all.py:156-170: 16 height maps (rng 3)
# the main path's encode at 2048^2 (PERF.md section 5; NVIDIA H100 80GB
# HBM3, 700 W), printed beside config 5's
MAIN_PATH_ENCODE_MS = 2.626
MAXQ_GATE_SLACK = 0.001    # dB below the default tier (test_bc7.py:211)
USE3 = 0x80000             # encode_bc7's USE_3SUBSETS flag
USE3_FLOOR = 36.0          # img_blocks with USE_3SUBSETS (test_bc7.py:240)
# USE_3SUBSETS: K9 per block over 16 and 64 three-subset shapes (the
# path's one launch ranks the 64, which include mode 0's 16); K7 per block
# over 4 candidates, per mode
BC7_SHAPES_OPS = {16: 9092, 64: 35300}
BC7_PARTITION_OPS = {0: 22063, 1: 20459, 2: 21295, 3: 19811, 7: 23147}
# BC6H_SHARED_FIT=False: K10 per block (rows 10-13 each evaluated in
# full), the BC6H shape ranking per block, and K11 per block for each
# precision group, rows (0,), (1,), (2, 3, 4), (5,), (6, 7, 8), (9,)
BC6H_1REGION_OPS = 23383
BC6H_SHAPES_OPS = 13892
BC6H_2REGION_OPS = (28530, 28530, 38074, 28482, 38074, 28446)
# K8 per block: modes 4, 5 and 6 over their candidates
BC7_SINGLE_MODES_OPS = 51970
UNSHARED_PLAIN_BLOCKS = 16384  # face-512 blocks of the K10 / K11 twins
# (registers, spill stores, spill loads in bytes) of kernel instances, by a
# piece of each instance's mangled name (NVIDIA H100 80GB HBM3 build;
# PERF.md section 6): the K9 and K7 teams, mode 7's team, K11's lane
# jobs, the K8 and ranking teams as first built, K10 and K2 quick (one
# thread a block), and the instances whose code a redesign moved or
# templated but did not change (K2's teams and K5 since the K8 / ranking
# redesign).
PTXAS_RECORDED = {
    "bc7_encode_opaque_kernelILb0": (128, 424, 812),
    "bc7_encode_opaque_kernelILb1": (128, 440, 840),
    "bc7_encode_maxq_kernelILb0": (128, 32, 36),
    "bc7_encode_maxq_kernelILb1": (128, 20, 28),
    "bc6h_encode_kernel": (123, 0, 0),
    "bc7_partition_team_kernelILi0ELb0": (128, 116, 96),
    "bc7_partition_team_kernelILi1ELb0": (128, 36, 28),
    "bc7_partition_team_kernelILi2ELb0": (128, 88, 64),
    "bc7_partition_team_kernelILi3ELb0": (128, 36, 28),
    "bc7_partition_team_kernelILi7ELb0": (128, 176, 176),
    "bc7_shapes_team_kernelILi2E": (56, 0, 0),
    "bc7_shapes_team_kernelILi3E": (64, 0, 0),
    "bc7_single_modes_team_kernelILb0": (96, 36, 28),
    "bc7_single_modes_team_kernelILb1": (96, 32, 24),
    "bc7_mode7_team_kernelILb0": (128, 92, 112),
    "bc7_mode7_team_kernelILb1": (128, 92, 112),
    "bc6h_refine_unit_kernelILi0ELb0": (72, 0, 0),
    "bc6h_refine_unit_kernelILi1ELb0": (80, 224, 248),
    "bc6h_refine_unit_kernelILi1ELb1": (80, 304, 320),
    "bc6h_1region_kernel": (62, 0, 0),
    "bc7_encode_kernelILi1ELb0": (168, 0, 0),
    "bc7_encode_kernelILi1ELb1": (168, 0, 0),
    "bc6h_2region_jobs_kernel": (117, 0, 0),
    "bc6h_shapes_team_kernel": (56, 0, 0),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def ptxas_summary(log: str) -> dict:
    """{kernel entry: "registers, stack, spill stores, spill loads"} from
    nvcc's -Xptxas=-v output (one entry per template instance)."""
    parts, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            parts[entry] = []
        elif entry and ("registers" in ln or "spill" in ln):
            parts[entry].append(ln.split(":")[-1].strip())
    return {k: "; ".join(v) for k, v in parts.items()}


def ptxas_numbers(summary: str) -> tuple:
    """(registers, spill stores, spill loads) of one ptxas_summary entry."""
    import re

    def num(pattern):
        m = re.search(pattern, summary)
        return int(m.group(1)) if m else 0

    return (num(r"Used (\d+) registers"), num(r"(\d+) bytes spill stores"),
            num(r"(\d+) bytes spill loads"))


def bench_image(size: int = SLICE_SIZE, alpha: bool = False) -> np.ndarray:
    """The bench image of bench.py:89-99. With alpha, its alpha is drawn
    after the RGB noise from the same generator: 1.0 left of column 512
    (opaque blocks inside an image with alpha), a smooth blend of rows
    above 1024, and a 0/1 cut-out with hard edges below (foliage)."""
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, size, dtype=np.float32)
    gx, gy = np.meshgrid(x, x)
    img = np.stack([gx, (gx * gy), np.abs(np.sin(gx * 37) * 0.5 + 0.3),
                    np.ones_like(gx)], axis=-1).astype(np.float32)
    img += (rng.random(img.shape).astype(np.float32) - 0.5) * 0.05
    img = np.clip(img, 0, 1)
    img[..., 3] = 1.0
    if alpha:
        noise = rng.random((size, size)).astype(np.float32) - 0.5
        rows = np.arange(size)[:, None]
        cols = np.arange(size)[None, :]
        blend = np.clip(0.1 + 0.8 * gy + noise * 0.05, 0, 1)
        cut = (np.sin(61 * gx) * np.sin(47 * gy) > 0).astype(np.float32)
        img[..., 3] = np.where(cols < 512, 1.0,
                               np.where(rows < 1024, blend, cut))
    return img


def hdr_random_set(signed: bool) -> np.ndarray:
    """benchmarks/verify_bc6h_tpu.py:41-52: 200 random blocks; the first
    40 signed ones sign-crossing bimodal."""
    r = np.random.default_rng(17)
    scale = 4.0 if signed else 8.0
    rgb = r.random((200, 16, 3)).astype(np.float32) * scale
    if signed:
        rgb -= scale / 2
        rgb[:N_BIMODAL, 8:, :] += scale
        rgb[:N_BIMODAL, :8, :] -= scale
    return np.concatenate([rgb, np.ones((200, 16, 1), np.float32)], -1)


def per_mode_ops(torch, modes, table: dict) -> float:
    """Operations of a run whose blocks have `modes` (a [NB] tensor) at
    table[mode] each, 0 for a mode not in the table (reserved modes)."""
    counts = torch.bincount(modes[modes >= 0].to(torch.int64)).tolist()
    return float(sum(n * table.get(m, 0) for m, n in enumerate(counts)))


def lists_equal(torch, words, got, want, what: str) -> list:
    """A bucket pass's (copy of the words, lists, counts) held against its
    plain twin's (counts, one ascending index list each): the copy equal
    to the words, equal counts, and each list the same set of blocks, in
    whatever order the warps' atomics gave. Returns the counts."""
    copy, lists, counts = got
    counts_p, lists_p = want
    check(torch.equal(copy, words), f"bucket pass copy {what}")
    check(torch.equal(counts.cpu(), counts_p.cpu()),
          f"bucket counts {what}: {counts.tolist()} vs {counts_p.tolist()}")
    for u, want_u in enumerate(lists_p):
        got_u = torch.sort(lists[u, :len(want_u)])[0]
        check(torch.equal(got_u, want_u), f"bucket {u} {what}")
    return counts.tolist()


def buckets_equal(torch, words, modes, what: str) -> list:
    """K3's bucket pass on BC7 words [4, NB] over `modes` against its
    twin; returns the counts per mode 0-7."""
    from directxtex_tpu_torch.bc import bc67, cuda_kernels

    mask = sum(1 << m for m in modes)
    return lists_equal(torch, words,
                       cuda_kernels.bc7_mode_buckets(words, mask),
                       bc67._mode_buckets_plain(words, mask), what)


def units_equal(torch, words, what: str) -> list:
    """K6's bucket pass on BC6H words [4, NB] against its twin; returns
    the counts (one-region, two-region, reserved)."""
    from directxtex_tpu_torch.bc import bc6h, cuda_kernels

    return lists_equal(torch, words, cuda_kernels.bc6h_unit_buckets(words),
                       bc6h._unit_buckets_plain(words), what)


def mode_blocks(rng, n: int, low_bits: int, value: int) -> np.ndarray:
    """n random packed blocks [n, 16] u8 whose byte 0 has its low_bits
    low bits set to value (a BC7 mode's or a BC6H mode row's header)."""
    raw = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    keep = np.uint8(~((1 << low_bits) - 1) & 0xFF)
    raw[:, 0] = (raw[:, 0] & keep) | np.uint8(value)
    return raw


def decode_equal(torch, blocks, what: str, signed=None) -> None:
    """K1 (signed None) or K4 on packed blocks [NB, 16] u8 on the card,
    both epilogues (the words API's int32 planes and decode's f32), held
    bit for bit against their plain versions."""
    from directxtex_tpu_torch.bc import bc67, bc6h, cuda_kernels

    words = blocks.view(torch.int32).t().contiguous()
    if signed is None:
        want_w = bc67._bc7_decode_plain(words)
        want_f = bc67._bc7_decode_f32_plain(blocks)
        got_w = cuda_kernels.bc7_decode(words)
        got_f = cuda_kernels.bc7_decode_blocks(blocks)
    else:
        want_w = bc6h._bc6h_decode_plain(words, signed)
        want_f = bc6h._bc6h_decode_f32_plain(blocks, signed)
        got_w = cuda_kernels.bc6h_decode(words, signed)
        got_f = cuda_kernels.bc6h_decode_blocks(blocks, signed)
    check(torch.equal(got_w, want_w), f"{what}: words API vs plain")
    check(got_f.shape == want_f.shape and torch.equal(
        got_f.view(torch.int32), want_f.view(torch.int32)),
        f"{what}: f32 vs plain")


def profile_calls(torch, calls: dict, tries: int = 3) -> dict:
    """{label: [(kernel name, device µs)]}: the CUDA kernels each call of
    `calls` ({label: fn}) runs, each call in a torch.profiler record of its
    own (CUPTI sees the kernels launched through ctypes too), so that an
    offset between the host's and the device's clocks cannot put a kernel
    under a neighbouring call. A record that holds no device activity
    (CUPTI delivered none) is taken again, up to `tries` records."""
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    out = {}
    for label, fn in calls.items():
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            device = [(e.name, e.time_range.elapsed_us())
                      for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset"))]
            if device:
                out[label] = device
                break
        else:
            raise RuntimeError(f"no device activity for {label} in {tries} "
                               f"profiler records")
    return out


def host_us(torch, fn, reps: int = 100) -> float:
    """Host time a call of fn() takes to return (µs, mean of reps calls
    after a warm-up; the device may still be running)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    sys.path.insert(0, ROOT)
    from directxtex_tpu_torch import _build
    from directxtex_tpu_torch.bc import bc67, bc6h, cuda_kernels
    from directxtex_tpu_torch.bc.common import image_to_blocks
    from directxtex_tpu_torch.models import pipelines

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc[-1]})

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(_build.build_info["log"])
    # a library built earlier from the same sources (directxtex_tpu_torch/
    # _build/) loads without nvcc's log; a checkout builds its own
    recorded = {}
    for piece, want in PTXAS_RECORDED.items() if ptxas else ():
        got = [ptxas_numbers(v) for k, v in ptxas.items() if piece in k]
        check(got == [want], f"ptxas {piece}: {got} vs recorded {want}")
        recorded[piece] = list(want)
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "ptxas_as_recorded": recorded or "not checked: cached build"})

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def px_of(blocks):
        """[NB, 16, 4] f32 on the card -> [64, NB] int32 texels."""
        return bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()

    def same(a, b, what):
        """Kernel and twin agree word for word, and the errors bit for
        bit."""
        check(a.shape == b.shape and torch.equal(a, b),
              f"{what} differs from plain")

    def event_ms(fn, reps: int = 1) -> list[float]:
        times = []
        for _ in range(reps):
            t_a = torch.cuda.Event(enable_timing=True)
            t_b = torch.cuda.Event(enable_timing=True)
            t_a.record()
            fn()
            t_b.record()
            torch.cuda.synchronize()
            times.append(t_a.elapsed_time(t_b))
        return times

    # 2. K1 ---------------------------------------------------------------
    vec = np.load(os.path.join(GOLDEN, "decode_vectors.npz"))
    got = bc67.decode_bc7(to_dev(vec["bc7_blocks"])).cpu().numpy()
    check(np.array_equal(got, vec["bc7_rgba"]), "K1 golden vectors")
    decode_equal(torch, to_dev(vec["bc7_blocks"]), "K1 golden vectors")
    rng = np.random.default_rng(2026)
    raw = rng.integers(0, 256, (RANDOM_BLOCKS, 16), dtype=np.uint8)
    raw[::97, 0] = 0                              # reserved mode
    blocks_r = to_dev(raw)
    decode_equal(torch, blocks_r, "K1 random mixed words")
    check(bool((bc67.decode_bc7(blocks_r)[::97] == 0).all()),
          "K1 reserved mode: transparent black")
    for m in range(8):
        decode_equal(torch, to_dev(mode_blocks(
            rng, DECODE_MODE_BLOCKS, m + 1, 1 << m)), f"K1 mode {m} words")
    emit({"phase": "K1", "golden_bit_exact": True,
          "random_blocks": RANDOM_BLOCKS, "random_equal": True,
          "mode_blocks": DECODE_MODE_BLOCKS, "modes_equal": list(range(8)),
          "epilogues": ["words", "f32"]})

    # 3-4. K2 and K3 on bench512 and the opaque corpus --------------------
    b512 = np.load(os.path.join(GOLDEN, "bench512.npz"))
    corpus = np.load(os.path.join(GOLDEN, "corpus.npz"))
    contents = [("bench512", b512["img"])] + [
        (c, corpus[c]) for c in OPAQUE_CORPUS]
    for label, img in contents:
        px = px_of(image_to_blocks(to_dev(img))[0])
        for aw in ALPHA_WEIGHTS if label == "bench512" else (1.0,):
            err_k, w_k = cuda_kernels.bc7_encode(px, bc67.SEARCH_MODES, aw)
            err_p, w_p = bc67._bc7_search_plain(px, bc67.SEARCH_MODES, aw)
            n = int((w_k != w_p).any(dim=0).sum())
            err_diff = float((err_k - err_p).abs().max())
            check(n == 0 and err_diff == 0.0,
                  f"K2 {label} aw={aw}: {n} blocks differ, error "
                  f"difference {err_diff}")
            emit({"phase": "K2", "content": label, "aw": aw,
                  "blocks": px.shape[1], "words_differ": n,
                  "max_abs_err_diff": err_diff})
            if aw == 1.0:
                w_1 = w_k
        w_k = w_1
        r_k = cuda_kernels.bc7_refine(px, w_k, bc67.REFINE_MODES)
        r_p = bc67._bc7_refine_plain(px, w_k, bc67.REFINE_MODES)
        n3 = int((r_k != r_p).any(dim=0).sum())
        check(n3 == 0, f"K3 {label}: {n3} blocks differ from plain refine")
        emit({"phase": "K3", "content": label, "blocks": px.shape[1],
              "words_equal": True,
              "refined_blocks": int((r_k != w_k).any(dim=0).sum()),
              "buckets": buckets_equal(torch, w_k, bc67.REFINE_MODES,
                                       f"{label} default scope")})

    # 5. 512^2 quality gate (benchmarks/verify_bc7_tpu.py:177-199) ---------
    blocks512 = image_to_blocks(to_dev(b512["img"]))[0]
    dec = bc67.decode_bc7(bc67.encode_bc7(blocks512)).to(torch.float64)
    mse = float(((dec - blocks512.to(torch.float64)) ** 2).mean())
    psnr512 = 10 * np.log10(1.0 / max(mse, 1e-12))
    ref_psnr = float(b512["ref_psnr"])
    check(psnr512 >= ref_psnr, f"512^2 PSNR {psnr512} < {ref_psnr}")
    emit({"phase": "gate512", "psnr": psnr512, "ref_psnr": ref_psnr})

    # 6. the slice at 2048^2 (bench.py:89-99) -----------------------------
    size = SLICE_SIZE
    img_d = to_dev(bench_image(size))

    def encode_path():
        return bc67.encode_bc7(image_to_blocks(img_d)[0], opaque=True)

    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    blocks2k = image_to_blocks(img_d)[0]
    enc = bc67.encode_bc7(blocks2k, opaque=True)
    dec = bc67.decode_bc7(enc)
    torch.cuda.synchronize()
    counts = {k: v for k, v in cuda_kernels.launch_counts().items() if v}
    # K3: the bucket pass, then one launch per mode of (1, 3, 5, 4)
    check(counts == {"bc7_encode": 1, "bc7_mode_buckets": 1,
                     "bc7_refine": 4, "bc7_decode": 1},
          f"launch counts {counts}")
    check(tuple(dec.shape) == (size * size // 16, 16, 4)
          and bool(torch.isfinite(dec).all()), "2K output shape / finite")
    mse = float(((dec.to(torch.float64) - blocks2k.to(torch.float64)) ** 2)
                .mean())
    psnr2k = 10 * np.log10(1.0 / max(mse, 1e-12))
    emit({"phase": "slice2k", "blocks": size * size // 16, "psnr": psnr2k,
          "launches": counts})

    # kernel times at the main path's shapes (warm-up, then median of 7)
    px2k = px_of(blocks2k)
    err_k, w_search = cuda_kernels.bc7_encode(px2k)
    w_final = cuda_kernels.bc7_refine(px2k, w_search, bc67.REFINE_MODES)
    enc_ms = float(np.median(event_ms(encode_path, 7)))
    refine_mask = sum(1 << m for m in bc67.REFINE_MODES)
    k_ms = {
        "bc7_encode": float(np.median(event_ms(
            lambda: cuda_kernels.bc7_encode(px2k), 7))),
        # the launcher's whole call: copy + bucket pass + per-mode launches
        "bc7_refine": float(np.median(event_ms(
            lambda: cuda_kernels.bc7_refine(px2k, w_search,
                                            bc67.REFINE_MODES), 7))),
        # K1 as decode_bc7 launches it: packed blocks -> f32
        "bc7_decode": float(np.median(event_ms(
            lambda: cuda_kernels.bc7_decode_blocks(enc), 7))),
        "bc7_mode_buckets": float(np.median(event_ms(
            lambda: cuda_kernels.bc7_mode_buckets(w_search, refine_mask),
            7))),
    }
    copy_ms = float(np.median(event_ms(lambda: w_search.clone(), 7)))
    enc_aw2_ms = float(np.median(event_ms(
        lambda: cuda_kernels.bc7_encode(px2k, bc67.SEARCH_MODES, 2.0), 7)))
    # one run of each plain twin on the same inputs, held against the kernel
    out = {}
    plain_ms = {}
    plain_ms["bc7_encode"] = event_ms(
        lambda: out.update(search=bc67._bc7_search_plain(px2k)))[0]
    plain_ms["bc7_refine"] = event_ms(
        lambda: out.update(refine=bc67._bc7_refine_plain(
            px2k, w_search, bc67.REFINE_MODES)))[0]
    plain_ms["bc7_decode"] = event_ms(
        lambda: out.update(decode=bc67._bc7_decode_f32_plain(enc)))[0]
    plain_ms["bc7_mode_buckets"] = event_ms(lambda: out.update(
        buckets=bc67._mode_buckets_plain(w_search, refine_mask)))[0]
    same(w_search, out["search"][1], "K2 words 2048^2")
    same(err_k, out["search"][0], "K2 errors 2048^2")
    err_k2, w_k2 = cuda_kernels.bc7_encode(px2k, bc67.SEARCH_MODES, 2.0)
    err_p2, w_p2 = bc67._bc7_search_plain(px2k, bc67.SEARCH_MODES, 2.0)
    same(w_k2, w_p2, "K2 words 2048^2 aw=2.0")
    same(err_k2, err_p2, "K2 errors 2048^2 aw=2.0")
    bucket_counts = buckets_equal(torch, w_search, bc67.REFINE_MODES,
                                  "2048^2 default scope")
    check(torch.equal(out["refine"], w_final), "K3 2048^2 vs plain")
    k1_out = cuda_kernels.bc7_decode_blocks(enc)
    check(torch.equal(out["decode"].view(torch.int32),
                      k1_out.view(torch.int32)), "K1 2048^2 vs plain")
    decode_equal(torch, enc, "K1 2048^2 words")
    max_err = {
        "bc7_encode": float((err_k - out["search"][0]).abs().max()),
        "bc7_refine": float((out["refine"].to(torch.int64)
                             - w_final.to(torch.int64)).abs().max()),
        "bc7_decode": float((out["decode"] - k1_out).abs().max()),
        # counts and bucket sets held equal above
        "bc7_mode_buckets": 0.0,
    }
    # decode: the path, K1's other epilogue, and K1 on the random mixed
    # words (their CUDA kernels and device times: phase decode_profile)
    decode_ms = {
        "decode_bc7_path": float(np.median(event_ms(
            lambda: bc67.decode_bc7(enc), 7))),
        "k1_f32": k_ms["bc7_decode"],
        "k1_words": float(np.median(event_ms(
            lambda: cuda_kernels.bc7_decode(w_final), 7))),
        "k1_f32_random_mixed": float(np.median(event_ms(
            lambda: cuda_kernels.bc7_decode_blocks(blocks_r), 7))),
    }
    nb2k = size * size // 16
    emit({"phase": "decode2k", "card": smi, "blocks": nb2k,
          "ms": decode_ms,
          "decode_bc7_host_us": host_us(torch, lambda: bc67.decode_bc7(enc)),
          "bound_ms": {"f32": BYTES_PER_BLOCK["bc7_decode"] * nb2k
                       / HBM_BYTES_PER_S * 1e3,
                       "words": DECODE_WORDS_BYTES["bc7_decode"] * nb2k
                       / HBM_BYTES_PER_S * 1e3}})

    mtexels = size * size / (enc_ms * 1e-3) / 1e6
    emit({"phase": "timing2k", "card": smi, "encode_ms": enc_ms,
          "encode_mtexels_per_s": mtexels, "kernel_ms": k_ms,
          "bc7_encode_aw2_ms": enc_aw2_ms, "words_copy_ms": copy_ms,
          "bucket_counts": bucket_counts, "plain_ms": plain_ms,
          "search_words_differ_vs_plain": 0,
          "earlier_ms": EARLIER_OPAQUE_MS})

    # both decode paths and their kernels, each call in a profiler record
    # of its own: each decode is one CUDA kernel, and the kernels' device
    # times. Config 4's words as phase 10 makes them (its input, the
    # shipped pipeline).
    eq4 = to_dev(np.random.default_rng(2).random(
        (FACE * 2, FACE * 4, 4)).astype(np.float32) * 4.0)
    packed4 = torch.cat(pipelines.hdr_cubemap_pipeline()(eq4))
    words4 = packed4.view(torch.int32).t().contiguous()
    # mode 7's launch (on both tiers' picks, in place: a second fold over
    # a folded result keeps it), K11's one launch, the ranking and K10 at
    # the paths' shapes, K8 at phase 24's, K2 quick at phase 14's
    px_a = px_of(image_to_blocks(to_dev(bench_image(size, alpha=True)))[0])
    list_a, count_a = cuda_kernels.bc7_alpha_list(px_a)
    fold_a = {t: cuda_kernels.bc7_search_picks(px_a, 1.0, t)
              for t in (bc67.TIER_DEFAULT, bc67.TIER_MAXQ)}
    faces4 = pipelines.cube_faces(eq4)
    px4 = bc6h.px_of_blocks(torch.cat([image_to_blocks(faces4[i])[0]
                                       for i in range(6)]), False)
    sb4 = cuda_kernels.bc6h_shapes(px4)
    teams = {
        "bc7_mode7": lambda: cuda_kernels.bc7_mode7(
            px_a, fold_a[bc67.TIER_DEFAULT][2], list_a, count_a,
            *fold_a[bc67.TIER_DEFAULT][:2]),
        "bc7_mode7_maxq": lambda: cuda_kernels.bc7_mode7(
            px_a, fold_a[bc67.TIER_MAXQ][2], list_a, count_a,
            *fold_a[bc67.TIER_MAXQ][:2]),
        "bc6h_2region": lambda: cuda_kernels.bc6h_2region(
            px4, sb4, range(6), False),
        "bc6h_shapes": lambda: cuda_kernels.bc6h_shapes(px4),
        "bc7_single_modes": lambda: cuda_kernels.bc7_single_modes(px2k,
                                                                  1.0),
        "bc6h_1region": lambda: cuda_kernels.bc6h_1region(px4, False),
        "bc7_encode_quick": lambda: cuda_kernels.bc7_encode(
            px_a, bc67.SEARCH_MODES_QUICK)}
    # the CUDA kernel K10's and K2 quick's launchers run, by name
    kernel_names = {"bc6h_1region": "bc6h_1region_kernel",
                    "bc7_encode_quick": "bc7_encode_kernel<1,"}
    prof = profile_calls(torch, {**teams,
        "decode_bc7": lambda: bc67.decode_bc7(enc),
        "k1_f32": lambda: cuda_kernels.bc7_decode_blocks(enc),
        "k1_words": lambda: cuda_kernels.bc7_decode(w_final),
        "k1_f32_random_mixed": lambda: cuda_kernels.bc7_decode_blocks(
            blocks_r),
        "decode_bc6h": lambda: bc6h.decode_bc6h(packed4, False),
        "k4_f32": lambda: cuda_kernels.bc6h_decode_blocks(packed4, False),
        "k4_words": lambda: cuda_kernels.bc6h_decode(words4, False),
        "k4_f32_signed": lambda: cuda_kernels.bc6h_decode_blocks(packed4,
                                                                 True)})
    for path in ("decode_bc7", "decode_bc6h", *teams):
        check(len(prof[path]) == 1, f"{path} runs {prof[path]}")
    for k, piece in kernel_names.items():
        check(piece in prof[k][0][0], f"{k} ran {prof[k][0][0]}")
    emit({"phase": "kernel_profile", "card": smi,
          "alpha_blocks": int(count_a),
          "kernels": {k: prof[k][0][0] for k in teams},
          "device_ms": {k: prof[k][0][1] * 1e-3 for k in teams}})
    emit({"phase": "decode_profile", "card": smi,
          "cuda_kernels_a_decode": {p: len(prof[p]) for p in
                                    ("decode_bc7", "decode_bc6h")},
          "kernels": {p: prof[p][0][0] for p in ("decode_bc7",
                                                 "decode_bc6h")},
          "device_us": {k: [t for _, t in v] for k, v in prof.items()
                        if k not in teams}})

    nb_of = {"bc7_decode": px2k.shape[1], "bc7_encode": px2k.shape[1],
             "bc7_refine": px2k.shape[1],
             "bc7_mode_buckets": px2k.shape[1]}
    ops_of = {
        "bc7_decode": per_mode_ops(torch, bc67._mode_of(
            bc67._words_i64(w_final)), dict(enumerate(BC7_DECODE_OPS))),
        "bc7_encode": BC7_SEARCH_OPS * float(px2k.shape[1]),
        "bc7_refine": per_mode_ops(torch, bc67._mode_of(
            bc67._words_i64(w_search)), BC7_REFINE_OPS),
        "bc7_mode_buckets": BC7_BUCKET_OPS * float(px2k.shape[1]),
    }
    launches = dict(counts)

    plain_nb = dict(nb_of)
    r = bc6h_phases(torch, dev, to_dev, event_ms, smi)
    launches.update(r["launches"])
    k_ms.update(r["k_ms"])
    plain_ms.update(r["plain_ms"])
    max_err.update(r["max_err"])
    nb_of.update(r["nb"])
    plain_nb.update(r["plain_nb"])
    ops_of.update(r["ops"])

    r = bc7_alpha_phases(torch, to_dev, event_ms, smi, b512, corpus, img_d,
                         enc_ms)
    for d, key in ((launches, "launches"), (k_ms, "k_ms"),
                   (plain_ms, "plain_ms"), (max_err, "max_err"),
                   (nb_of, "nb"), (plain_nb, "nb"), (ops_of, "ops")):
        d.update(r[key])
    extra_bytes = dict(r["extra_bytes"])

    img_alpha = r["img_alpha"]
    r = bc7_maxq_phases(torch, to_dev, event_ms, smi, b512, corpus, img_d,
                        img_alpha)
    for d, key in ((launches, "launches"), (k_ms, "k_ms"),
                   (plain_ms, "plain_ms"), (max_err, "max_err"),
                   (nb_of, "nb"), (plain_nb, "nb"), (ops_of, "ops")):
        d.update(r[key])

    r = bc7_3sub_phases(torch, to_dev, event_ms, smi, b512, corpus, img_d,
                        img_alpha)
    for d, key in ((launches, "launches"), (k_ms, "k_ms"),
                   (plain_ms, "plain_ms"), (max_err, "max_err"),
                   (nb_of, "nb"), (plain_nb, "nb"), (ops_of, "ops")):
        d.update(r[key])
    extra_bytes.update(r["extra_bytes"])

    r = bc6h_unshared_phases(torch, to_dev, event_ms, smi)
    for d, key in ((launches, "launches"), (k_ms, "k_ms"),
                   (plain_ms, "plain_ms"), (max_err, "max_err"),
                   (nb_of, "nb"), (plain_nb, "plain_nb"), (ops_of, "ops")):
        d.update(r[key])

    r = bc7_single_modes_phase(torch, to_dev, event_ms, smi, img_d,
                               img_alpha)
    for d, key in ((launches, "launches"), (k_ms, "k_ms"),
                   (plain_ms, "plain_ms"), (max_err, "max_err"),
                   (nb_of, "nb"), (plain_nb, "nb"), (ops_of, "ops")):
        d.update(r[key])

    bc12345_phases(torch, to_dev, event_ms, smi, enc_ms)

    lines = []
    device_ms = {k: prof[k][0][1] * 1e-3 for k in teams if k in SOURCES}
    for k in SOURCES:
        n_bytes = BYTES_PER_BLOCK[k] * nb_of[k] + extra_bytes.get(k, 0.0)
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops_of[k] / OPS_PER_S * 1e3
        lines.append({
            "name": k, "route": "cuda", "source": SOURCES[k][0],
            "replaces": SOURCES[k][1], "launches": launches[k],
            "max_abs_err": max_err[k], "ms": k_ms[k],
            "plain_ms": plain_ms[k], "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms > o_ms else "operations",
            "library_ms": None, "blocks": nb_of[k],
            "plain_blocks": plain_nb[k], "ops": ops_of[k],
            "bytes": n_bytes,
            **({"device_ms": device_ms[k]} if k in device_ms else {})})
    print(smi)
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


def log_psnr(a, b):
    """Log-domain PSNR of HDR RGB (tests/test_golden.py)."""
    a = np.maximum(a[..., :3], 0) + 1e-4
    b = np.maximum(b[..., :3], 0) + 1e-4
    m = float(np.mean((np.log2(a) - np.log2(b)) ** 2))
    return 10 * np.log10(36.0 / max(m, 1e-30))


def content_psnr(dec, src, signed: bool) -> float:
    """A BC6H corpus content's gate metric (tests/test_golden.py): log-PSNR
    unsigned, peak-linear PSNR signed. dec, src: [NB, 16, 4] numpy."""
    if signed:
        peak = float(np.abs(src[..., :3]).max())
        m = float(np.mean((dec[..., :3] - src[..., :3]) ** 2))
        return 10 * np.log10(peak * peak / max(m, 1e-30))
    return log_psnr(dec, src)


def bc6h_gates(torch, to_dev, corpus, what: str, frozen=None):
    """The BC6H gates through encode_bc6h -> decode_bc6h on the card at
    the search setting in force: every HDR corpus content at its floor
    and within 0.05 dB of its frozen PSNR (tests/test_golden.py:118-177),
    and the frozen reference's bc6h_hdr_psnr (:314-329). `frozen` (by
    content) replaces the corpus's frozen PSNRs, which are the shipped
    search's; a content whose given frozen PSNR is below its floor is then
    held to that PSNR instead of the floor. Returns (PSNR by content,
    bc6h_hdr_psnr, the reference's)."""
    from directxtex_tpu_torch.bc import bc6h
    from directxtex_tpu_torch.bc.common import image_to_blocks

    gates = {}
    for c in HDR_CORPUS:
        signed = c == "hdr_signed"
        blocks = image_to_blocks(to_dev(corpus[c]))[0]
        dec = bc6h.decode_bc6h(bc6h.encode_bc6h(blocks, signed), signed)
        psnr = content_psnr(dec.cpu().numpy(), blocks.cpu().numpy(), signed)
        floor = BC6H_FLOORS[c]
        if frozen is None:
            fz = float(corpus["psnr_bc6hs_hdr_signed" if signed
                              else f"psnr_bc6h_{c}"])
        else:
            fz = frozen[c]
            floor = min(floor, fz)
        check(psnr >= floor and psnr >= fz - 0.05,
              f"BC6H{what} {c}: {psnr} dB < floor {floor} / frozen {fz}")
        gates[c] = psnr
    ref = np.load(os.path.join(GOLDEN, "ref_encodes.npz"))
    blocks = image_to_blocks(to_dev(corpus["hdr"]))[0]
    dec = bc6h.decode_bc6h(bc6h.encode_bc6h(blocks, False), False)
    peak = float(ref["bc6h_hdr_peak"])
    mse = float(((dec[..., :3] - blocks[..., :3]).to(torch.float64) ** 2)
                .mean())
    ref_gate = 10 * np.log10(peak * peak / max(mse, 1e-30))
    check(ref_gate >= float(ref["bc6h_hdr_psnr"]),
          f"bc6h_hdr_psnr{what} {ref_gate} < {float(ref['bc6h_hdr_psnr'])}")
    return gates, ref_gate, float(ref["bc6h_hdr_psnr"])


def bc6h_phases(torch, dev, to_dev, event_ms, smi) -> dict:
    """Phases 7-10. Returns the BC6H kernels' launches (from the paths'
    runs), times, plain times, errors against the twins and block counts."""
    from directxtex_tpu_torch.bc import bc6h, cuda_kernels
    from directxtex_tpu_torch.bc.bc67_tables import BC6H_MODE_INFO
    from directxtex_tpu_torch.bc.common import image_to_blocks
    from directxtex_tpu_torch.models import pipelines

    def same(a, b, what):
        """Kernel and twin agree word for word, and the search errors bit
        for bit (infinities included): the twins sum in the kernels' order
        with the kernels' rounding."""
        check(a.shape == b.shape and torch.equal(a, b),
              f"{what} differs from plain")

    def word_diff(a, b):
        return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    # 7. K4 -------------------------------------------------------------
    vec = np.load(os.path.join(GOLDEN, "decode_vectors.npz"))
    blocks_g = to_dev(vec["bc6h_blocks"])
    words_g = blocks_g.view(torch.int32).t().contiguous()
    rng = np.random.default_rng(2027)
    raw = rng.integers(0, 256, (RANDOM_BLOCKS, 16), dtype=np.uint8)
    blocks_r = to_dev(raw)
    words_r = blocks_r.view(torch.int32).t().contiguous()
    n_reserved = int((bc6h._mode_rows(bc6h._words_i64(words_r)) < 0).sum())
    for signed, key in ((False, "bc6h_uf_bits"), (True, "bc6h_sf_bits")):
        got = cuda_kernels.bc6h_decode(words_g, signed)
        ref = vec[key][..., :3].astype(np.int32).transpose(1, 2, 0)
        check(np.array_equal(got.cpu().numpy(), ref.reshape(48, -1)),
              f"K4 golden vectors signed={signed}")
        decode_equal(torch, blocks_g, f"K4 golden signed={signed}", signed)
        decode_equal(torch, blocks_r, f"K4 random words signed={signed}",
                     signed)
        for row, info in enumerate(BC6H_MODE_INFO):
            decode_equal(torch, to_dev(mode_blocks(
                rng, DECODE_MODE_BLOCKS, 2 if info[0] < 2 else 5, info[0])),
                f"K4 row {row} signed={signed}", signed)
    emit({"phase": "K4", "golden_bit_exact": True,
          "random_blocks": RANDOM_BLOCKS, "reserved_blocks": n_reserved,
          "random_equal": True, "signed": [False, True],
          "row_blocks": DECODE_MODE_BLOCKS, "rows_equal": list(range(14)),
          "epilogues": ["words", "f32"]})

    # 8. K5 and K6 against their twins ----------------------------------
    corpus = np.load(os.path.join(GOLDEN, "corpus.npz"))

    tiers = (("mid", bc6h.BC6H_LADDER_MID, False),
             ("maxq", bc6h.BC6H_LADDER_MAXQ, True))
    for signed in (False, True):
        contents = [(c, image_to_blocks(to_dev(corpus[c]))[0])
                    for c in HDR_CORPUS]
        contents.append(("random", to_dev(hdr_random_set(signed))))
        for label, blocks in contents:
            px = bc6h.px_of_blocks(blocks, signed)
            e_k, w_k = cuda_kernels.bc6h_encode(px, signed)
            e_p, w_p = bc6h._bc6h_search_plain(px, signed)
            what = f"{label} signed={signed}"
            same(w_k, w_p, f"K5 words {what}")
            same(e_k, e_p, f"K5 errors {what}")
            out = {"phase": "K5", "content": label, "signed": signed,
                   "blocks": px.shape[1], "words_equal": True,
                   "errors_equal": True,
                   "no_row_fits": int((~torch.isfinite(e_k)).sum())}
            if label == "random":
                # K5's lane jobs in plain form, folded by (error, position)
                e_j, w_j = bc6h._bc6h_jobs_fold_plain(
                    bc6h._bc6h_search_jobs_plain(px, signed))
                same(w_k, w_j, f"K5 words vs its jobs' twin {what}")
                same(e_k, e_j, f"K5 errors vs its jobs' twin {what}")
                out["jobs_twin_equal"] = True
            for tier, lad, cross2 in tiers:
                r_k = cuda_kernels.bc6h_refine(px, w_k, lad, lad, signed,
                                               True, cross2)
                r_p = bc6h._bc6h_refine_plain(px, w_k, lad, signed, True,
                                              cross2)
                same(r_k, r_p, f"K6 {tier} {what}")
                out[f"K6_{tier}_words_equal"] = True
                out[f"K6_{tier}_refined_blocks"] = int(
                    (r_k != w_k).any(dim=0).sum())
            out["K6_units"] = units_equal(torch, w_k, what)
            emit(out)

    # 9. BC6H quality gates (tests/test_golden.py:118-177, :314-329) ----
    gates, ref_gate, ref_psnr = bc6h_gates(torch, to_dev, corpus, "")
    emit({"phase": "bc6h_gates", "psnr": gates, "floors": BC6H_FLOORS,
          "ref_parity_psnr": ref_gate, "ref_psnr": ref_psnr})

    # 10. config 4 at face 512 (benchmarks/run_all.py:141-153) ---------
    rng = np.random.default_rng(2)
    eq = to_dev(rng.random((FACE * 2, FACE * 4, 4)).astype(np.float32)
                * 4.0)
    pipe = pipelines.hdr_cubemap_pipeline()
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    packed = torch.cat(pipe(eq))
    dec = bc6h.decode_bc6h(packed, False)
    torch.cuda.synchronize()
    counts = cuda_kernels.launch_counts()
    check(counts["bc6h_encode"] == 1 and counts["bc6h_decode"] == 1,
          f"config 4 launch counts {counts}")
    faces = pipelines.cube_faces(eq)
    blocks4 = torch.cat([image_to_blocks(faces[i])[0] for i in range(6)])
    nb4 = blocks4.shape[0]
    check(tuple(dec.shape) == (nb4, 16, 4)
          and bool(torch.isfinite(dec).all()), "config 4 output")
    psnr4 = log_psnr(dec.cpu().numpy(), blocks4.cpu().numpy())
    launches = {"bc6h_encode": counts["bc6h_encode"],
                "bc6h_decode": counts["bc6h_decode"]}

    # the mid and maxq tiers on the same faces: K5, then K6 (its bucket
    # pass and one launch per unit) per encode
    encs = {}
    for t, flag, k6 in (("mid", bc6h._BC6H_MID, "bc6h_refine"),
                        ("maxq", bc6h._BC7_MAXQUALITY, "bc6h_refine_cross2")):
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        encs[t] = bc6h.encode_bc6h(blocks4, False, flag)
        torch.cuda.synchronize()
        counts_t = {k: v for k, v in cuda_kernels.launch_counts().items()
                    if v}
        check(counts_t == {"bc6h_encode": 1, "bc6h_unit_buckets": 1,
                           k6: 2}, f"{t} launch counts {counts_t}")
        launches[k6] = counts_t[k6]
    launches["bc6h_unit_buckets"] = counts_t["bc6h_unit_buckets"]
    psnr_t = {t: log_psnr(bc6h.decode_bc6h(e, False).cpu().numpy(),
                          blocks4.cpu().numpy()) for t, e in encs.items()}

    px4 = bc6h.px_of_blocks(blocks4, False)
    e5, w5 = cuda_kernels.bc6h_encode(px4, False)
    check(torch.equal(w5.t().contiguous().view(torch.uint8).reshape(-1, 16),
                      packed), "config 4 words = K5's")
    mid_args = (bc6h.BC6H_LADDER_MID, bc6h.BC6H_LADDER_MID, False, True,
                False)
    maxq_args = (bc6h.BC6H_LADDER_MAXQ, bc6h.BC6H_LADDER_MAXQ, False, True,
                 True)
    w_mid = cuda_kernels.bc6h_refine(px4, w5, *mid_args)
    w_maxq = cuda_kernels.bc6h_refine(px4, w5, *maxq_args)
    path_ms = float(np.median(event_ms(lambda: pipe(eq), 7)))
    # the path's pieces: face sampling, block layout + F16-int pixels
    faces_ms = float(np.median(event_ms(
        lambda: pipelines.cube_faces(eq), 7)))
    prep_ms = float(np.median(event_ms(lambda: bc6h.px_of_blocks(torch.cat(
        [image_to_blocks(faces[i])[0] for i in range(6)]), False), 7)))
    # K6 as its launcher's whole call: copy + bucket pass + unit launches
    k_ms = {
        "bc6h_encode": float(np.median(event_ms(
            lambda: cuda_kernels.bc6h_encode(px4, False), 7))),
        # K4 as decode_bc6h launches it: packed blocks -> f32
        "bc6h_decode": float(np.median(event_ms(
            lambda: cuda_kernels.bc6h_decode_blocks(packed, False), 7))),
        "bc6h_refine_cross2": float(np.median(event_ms(
            lambda: cuda_kernels.bc6h_refine(px4, w5, *maxq_args), 7))),
        "bc6h_refine": float(np.median(event_ms(
            lambda: cuda_kernels.bc6h_refine(px4, w5, *mid_args), 7))),
        "bc6h_unit_buckets": float(np.median(event_ms(
            lambda: cuda_kernels.bc6h_unit_buckets(w5), 7))),
    }
    tier_ms = {t: float(np.median(event_ms(
        lambda: bc6h.encode_bc6h(blocks4, False, f), 7)))
        for t, f in (("mid", bc6h._BC6H_MID),
                     ("maxq", bc6h._BC7_MAXQUALITY))}

    # one run of each plain twin on the same inputs, held against the kernel
    out = {}
    plain_ms = {}
    plain_ms["bc6h_encode"] = event_ms(
        lambda: out.update(search=bc6h._bc6h_search_plain(px4, False)))[0]
    plain_ms["bc6h_decode"] = event_ms(
        lambda: out.update(decode=bc6h._bc6h_decode_f32_plain(packed,
                                                              False)))[0]
    px_q, w5_q = px4[:, :MAXQ_PLAIN_BLOCKS], w5[:, :MAXQ_PLAIN_BLOCKS]
    plain_ms["bc6h_refine_cross2"] = event_ms(
        lambda: out.update(maxq=bc6h._bc6h_refine_plain(
            px_q, w5_q, bc6h.BC6H_LADDER_MAXQ, False, True, True)))[0]
    plain_ms["bc6h_refine"] = event_ms(
        lambda: out.update(mid=bc6h._bc6h_refine_plain(
            px4, w5, bc6h.BC6H_LADDER_MID, False, True, False)))[0]
    plain_ms["bc6h_unit_buckets"] = event_ms(
        lambda: out.update(units=bc6h._unit_buckets_plain(w5)))[0]
    same(w5, out["search"][1], "K5 words face 512")
    same(e5, out["search"][0], "K5 errors face 512")
    same(out["decode"].view(torch.int32),
         cuda_kernels.bc6h_decode_blocks(packed, False).view(torch.int32),
         "K4 face 512")
    for signed in (False, True):
        decode_equal(torch, packed, f"K4 config 4 signed={signed}", signed)
    same(w_mid, out["mid"], "K6 mid face 512")
    same(w_maxq[:, :MAXQ_PLAIN_BLOCKS], out["maxq"], "K6 maxq face 512")
    units = units_equal(torch, w5, f"face {FACE}")
    fin = torch.isfinite(e5)
    max_err = {
        "bc6h_encode": float((e5 - out["search"][0])[fin].abs().max())
        if bool(fin.any()) else 0.0,
        "bc6h_decode": float((out["decode"] - cuda_kernels.bc6h_decode_blocks(
            packed, False)).abs().max()),
        "bc6h_refine_cross2": word_diff(out["maxq"],
                                        w_maxq[:, :MAXQ_PLAIN_BLOCKS]),
        "bc6h_refine": word_diff(out["mid"], w_mid),
        # counts and unit sets held equal above
        "bc6h_unit_buckets": 0.0,
    }
    # decode: the path, K4's other epilogue (their CUDA kernels and device
    # times: phase decode_profile)
    decode_ms = {
        "decode_bc6h_path": float(np.median(event_ms(
            lambda: bc6h.decode_bc6h(packed, False), 7))),
        "k4_f32": k_ms["bc6h_decode"],
        "k4_words": float(np.median(event_ms(
            lambda: cuda_kernels.bc6h_decode(w5, False), 7))),
        "k4_f32_signed": float(np.median(event_ms(
            lambda: cuda_kernels.bc6h_decode_blocks(packed, True), 7))),
    }
    emit({"phase": "decode_config4", "card": smi, "blocks": nb4,
          "ms": decode_ms,
          "decode_bc6h_host_us": host_us(
              torch, lambda: bc6h.decode_bc6h(packed, False)),
          "bound_ms": {"f32": BYTES_PER_BLOCK["bc6h_decode"] * nb4
                       / HBM_BYTES_PER_S * 1e3,
                       "words": DECODE_WORDS_BYTES["bc6h_decode"] * nb4
                       / HBM_BYTES_PER_S * 1e3}})

    texels = 6 * FACE * FACE
    emit({"phase": "config4", "card": smi, "face": FACE, "blocks": nb4,
          "launches": launches, "log_psnr": psnr4,
          "log_psnr_mid": psnr_t["mid"], "log_psnr_maxq": psnr_t["maxq"],
          "path_ms": path_ms,
          "path_mtexels_per_s": texels / (path_ms * 1e-3) / 1e6,
          "cube_faces_ms": faces_ms, "blocks_to_px_ms": prep_ms,
          "encode_mid_ms": tier_ms["mid"], "encode_maxq_ms": tier_ms["maxq"],
          "kernel_ms": k_ms, "plain_ms": plain_ms,
          "units": dict(zip(("one_region", "two_region", "reserved"),
                            units)),
          "maxq_plain_blocks": MAXQ_PLAIN_BLOCKS,
          "words_equal_plain": ["bc6h_encode", "bc6h_decode", "mid",
                                "maxq"]})
    nb = {k: nb4 for k in ("bc6h_encode", "bc6h_decode", "bc6h_refine",
                           "bc6h_refine_cross2", "bc6h_unit_buckets")}
    plain_nb = dict(nb, bc6h_refine_cross2=px_q.shape[1])
    rows = bc6h._mode_rows(bc6h._words_i64(w5))
    # reserved blocks pass through the refine
    ops = {"bc6h_decode": per_mode_ops(torch, rows, dict(enumerate(
               BC6H_DECODE_OPS))),
           "bc6h_encode": BC6H_SEARCH_OPS * float(nb4),
           "bc6h_refine_cross2": per_mode_ops(torch, rows, {
               r: BC6H_REFINE_OPS["one_region" if r >= 10 else "two_region"]
               for r in range(14)}),
           "bc6h_refine": per_mode_ops(torch, rows, {
               r: BC6H_REFINE_MID_OPS["one_region" if r >= 10
                                      else "two_region"]
               for r in range(14)}),
           # the bucket pass does a few integer operations a block
           "bc6h_unit_buckets": 0.0}
    return {"launches": launches, "k_ms": k_ms, "plain_ms": plain_ms,
            "max_err": max_err, "nb": nb, "plain_nb": plain_nb, "ops": ops}



def bc7_alpha_phases(torch, to_dev, event_ms, smi, b512, corpus, img_opaque,
                     opaque_ms) -> dict:
    """Phases 11-14. Returns the launches (from the paths' runs), times,
    plain times, errors against the twins, block counts and operations of
    mode 7's list pass and launch, K2's quick variant and K3 with mode 7
    in scope."""
    from directxtex_tpu_torch.bc import bc67, cuda_kernels
    from directxtex_tpu_torch.bc.common import image_to_blocks

    def px_of(blocks):
        return bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()

    def same(a, b, what):
        """Kernel and twin agree word for word, and the search errors bit
        for bit (the twins sum in the kernels' order)."""
        check(a.shape == b.shape and torch.equal(a, b),
              f"{what} differs from plain")

    alpha, quick = bc67.SEARCH_MODES_ALPHA, bc67.SEARCH_MODES_QUICK
    ralpha = bc67.REFINE_MODES_ALPHA
    size = SLICE_SIZE
    img_a = to_dev(bench_image(size, alpha=True))
    px_a = px_of(image_to_blocks(img_a)[0])
    px_o = px_of(image_to_blocks(img_opaque)[0])

    # 11. the search with mode 7 (K2's search, which also writes its
    # picks, mode 7's list pass and launch) and K3 with mode 7 against
    # their twins, each step on its own too ---------------------------------
    rng = np.random.default_rng(11)
    mixed = rng.random((200, 16, 4)).astype(np.float32)
    mixed[:100, :, 3] = 1.0
    contents = [("bench512", px_of(image_to_blocks(to_dev(b512["img"]))[0])),
                ("alphagrad", px_of(image_to_blocks(
                    to_dev(corpus["alphagrad"]))[0])),
                ("mixed200", px_of(to_dev(mixed))), (f"alpha{size}", px_a)]
    plain = {}
    for label, px in contents:
        blocks_k, count_k = cuda_kernels.bc7_alpha_list(px)
        t_l = event_ms(lambda: plain.update(
            listed=bc67._alpha_list_plain(px)))[0]
        n_alpha = int(count_k)
        same(torch.sort(blocks_k[:n_alpha])[0], plain["listed"],
             f"alpha list {label}")
        for aw in ALPHA_WEIGHTS:
            what = f"{label} aw={aw}"
            # the split's steps on their own
            e_f, w_f, picks = cuda_kernels.bc7_search_picks(px, aw)
            e_o, w_o = bc67._bc7_search_plain(px, bc67.SEARCH_MODES, aw)
            same(w_f, w_o, f"K2 (1, 3, 5, 6, 4) words {what}")
            same(e_f, e_o, f"K2 (1, 3, 5, 6, 4) errors {what}")
            same(picks, bc67._partition_shapes_plain(px, 1, 64, 4),
                 f"K2 picks {what}")
            e_7, w_7 = e_f.clone(), w_f.clone()
            cuda_kernels.bc7_mode7(px, picks, blocks_k, count_k, e_7, w_7,
                                   aw)
            t_7 = event_ms(lambda: plain.update(mode7=bc67._mode7_fold_plain(
                px, picks, e_f, w_f, aw)))[0]
            same(w_7, plain["mode7"][1], f"mode 7 words {what}")
            same(e_7, plain["mode7"][0], f"mode 7 errors {what}")
            if label != f"alpha{size}" or aw == 1.0:
                e_j, w_j = bc67._mode7_jobs_plain(px, picks, e_f, w_f, aw)
                same(w_7, w_j, f"mode 7 team (plain form) words {what}")
                same(e_7, e_j, f"mode 7 team (plain form) errors {what}")
            # the whole search with mode 7, and K3 after it
            e_k, w_k = cuda_kernels.bc7_encode(px, alpha, aw)
            r_k = cuda_kernels.bc7_refine(px, w_k, ralpha, aw)
            t_s = event_ms(lambda: plain.update(
                search=bc67._bc7_search_plain(px, alpha, aw)))[0]
            t_r = event_ms(lambda: plain.update(
                refine=bc67._bc7_refine_plain(px, w_k, ralpha, aw)))[0]
            e_p, w_p = plain["search"]
            same(w_k, w_p, f"K2 alpha words {what}")
            same(e_k, e_p, f"K2 alpha errors {what}")
            same(r_k, plain["refine"], f"K3 alpha {what}")
            modes = torch.bincount(bc67._mode_of(bc67._words_i64(w_k)),
                                   minlength=9).tolist()
            emit({"phase": "K2_alpha", "content": label, "aw": aw,
                  "blocks": px.shape[1], "alpha_blocks": n_alpha,
                  "words_equal": True, "errors_equal": True,
                  "steps_equal": ["search (1, 3, 5, 6, 4)", "picks",
                                  "alpha list", "mode 7",
                                  "mode 7 team (plain form)"],
                  "K3_words_equal": True,
                  "refined_blocks": int((r_k != w_k).any(dim=0).sum()),
                  "search_modes": modes})
            # mode 7 wins blocks of alphagrad and of the mixed set
            # (tests/test_torch_bc7_alpha.py), none of opaque bench512;
            # the 2048^2 image reports
            check(modes[7] > 0 or label in ("bench512", f"alpha{size}"),
                  f"no mode-7 winner on {what}")
            check(modes[7] == 0 or label != "bench512",
                  f"mode 7 on opaque {what}")
            if label == f"alpha{size}" and aw == 1.0:
                # the twins' one run at the main path's size
                w_search_a = w_k
                plain_ms = {"bc7_alpha_list": t_l, "bc7_mode7": t_7,
                            "bc7_refine_alpha": t_r, "search_alpha": t_s}
                max_err = {
                    "bc7_alpha_list": 0.0,   # the listed set held equal
                    "bc7_mode7": float((e_7 - plain["mode7"][0]).abs()
                                       .max()),
                    "bc7_refine_alpha": float(
                        (r_k.to(torch.int64)
                         - plain["refine"].to(torch.int64)).abs().max())}

    # 12. K2 quick against its twin, at both alpha weights ----------------
    quick_contents = (("bench512", px_of(image_to_blocks(
        to_dev(b512["img"]))[0])), (f"opaque{size}", px_o),
        (f"alpha{size}", px_a))
    for (label, px), aw in ((c, aw) for c in quick_contents
                            for aw in ALPHA_WEIGHTS):
        e_k, w_k = cuda_kernels.bc7_encode(px, quick, aw)
        t_q = event_ms(lambda: plain.update(
            quick=bc67._bc7_search_plain(px, quick, aw)))[0]
        same(w_k, plain["quick"][1], f"K2 quick words {label} aw={aw}")
        same(e_k, plain["quick"][0], f"K2 quick errors {label} aw={aw}")
        emit({"phase": "K2_quick", "content": label, "aw": aw,
              "blocks": px.shape[1], "words_equal": True,
              "errors_equal": True})
        if label == f"alpha{size}" and aw == 1.0:
            plain_ms["bc7_encode_quick"] = t_q
            max_err["bc7_encode_quick"] = float(
                (e_k - plain["quick"][0]).abs().max())

    # 13. BC7 gates on the card (tests/test_golden.py:114, :278-311) -------
    ref = np.load(os.path.join(GOLDEN, "ref_encodes.npz"))
    gates = {}
    for content, margin in REF_PARITY_MARGINS.items():
        blocks = image_to_blocks(to_dev(corpus[content]))[0]
        dec = bc67.decode_bc7(bc67.encode_bc7(blocks))
        mse = float(((dec.to(torch.float64) - blocks.to(torch.float64))
                     ** 2).mean())
        psnr = 10 * np.log10(1.0 / max(mse, 1e-30))
        want = float(ref[f"bc7_{content}_psnr"]) + margin
        check(psnr >= want, f"BC7 {content} parity: {psnr} < {want}")
        gates[content] = {"psnr": psnr, "parity_min": want}
    check(gates["alphagrad"]["psnr"] >= ALPHAGRAD_FLOOR,
          f"alphagrad floor: {gates['alphagrad']['psnr']}")
    emit({"phase": "bc7_gates", "gates": gates,
          "alphagrad_floor": ALPHAGRAD_FLOOR})

    # 14. the paths at 2048^2 --------------------------------------------
    def path(img, flags=0):
        return bc67.encode_bc7(image_to_blocks(img)[0], flags)

    nb = px_a.shape[1]
    runs = {}
    for name, img, flags, kernels in (
            ("alpha", img_a, 0, ("bc7_encode", "bc7_alpha_list", "bc7_mode7",
                                 "bc7_mode_buckets", "bc7_refine_alpha",
                                 "bc7_decode")),
            ("quick_alpha", img_a, bc67._BC7_QUICK,
             ("bc7_encode_quick", "bc7_decode")),
            ("quick_opaque", img_opaque, bc67._BC7_QUICK,
             ("bc7_encode_quick", "bc7_decode"))):
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        blocks = image_to_blocks(img)[0]
        dec = bc67.decode_bc7(bc67.encode_bc7(blocks, flags))
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda_kernels.launch_counts().items()
                  if v}
        check(sorted(counts) == sorted(kernels), f"{name} launches {counts}")
        # K3: one launch per mode of (1, 3, 5, 7, 4)
        check(name != "alpha" or counts["bc7_refine_alpha"] == 5,
              f"{name} K3 launches {counts}")
        check(tuple(dec.shape) == (nb, 16, 4)
              and bool(torch.isfinite(dec).all()), f"{name} output")
        mse = float(((dec.to(torch.float64) - blocks.to(torch.float64))
                     ** 2).mean())
        runs[name] = {"launches": counts,
                      "psnr": 10 * np.log10(1.0 / max(mse, 1e-30))}
    launches = {k: runs["alpha"]["launches"][k] for k in (
        "bc7_alpha_list", "bc7_mode7", "bc7_refine_alpha")}
    launches["bc7_encode_quick"] = runs["quick_alpha"]["launches"][
        "bc7_encode_quick"]

    med = {}
    e_f, w_f, picks = cuda_kernels.bc7_search_picks(px_a)
    blocks_k, count_k = cuda_kernels.bc7_alpha_list(px_a)
    for name, fn in (
            ("alpha_path", lambda: path(img_a)),
            # the search with mode 7, and its three launches alone
            ("search_alpha", lambda: cuda_kernels.bc7_encode(px_a, alpha)),
            ("bc7_search_picks", lambda: cuda_kernels.bc7_search_picks(
                px_a)),
            ("bc7_alpha_list", lambda: cuda_kernels.bc7_alpha_list(px_a)),
            # in place: a second fold over the folded result keeps it
            ("bc7_mode7", lambda: cuda_kernels.bc7_mode7(
                px_a, picks, blocks_k, count_k, e_f, w_f)),
            # K7's mode 7 over every block on the same picks (no path
            # launches it)
            ("bc7_partition_mode_7", lambda: cuda_kernels.bc7_partition_mode(
                px_a, picks, 7)),
            ("bc7_refine_alpha", lambda: cuda_kernels.bc7_refine(
                px_a, w_search_a, ralpha)),
            ("quick_path_alpha", lambda: path(img_a, bc67._BC7_QUICK)),
            ("quick_path_opaque", lambda: path(img_opaque,
                                               bc67._BC7_QUICK)),
            ("bc7_encode_quick", lambda: cuda_kernels.bc7_encode(
                px_a, quick)),
            ("search_alpha_aw2", lambda: cuda_kernels.bc7_encode(
                px_a, alpha, 2.0)),
            ("opaque_path", lambda: bc67.encode_bc7(
                image_to_blocks(img_opaque)[0], opaque=True)),
            ("bc7_encode", lambda: cuda_kernels.bc7_encode(px_o))):
        fn()
        med[name] = float(np.median(event_ms(fn, 7)))
    texels = size * size
    bucket_counts = buckets_equal(torch, w_search_a, ralpha,
                                  f"alpha{size} alpha scope")
    # one of K7's two launches a USE_3SUBSETS path
    k7_bytes = float(nb) * BYTES_PER_BLOCK["bc7_partition_mode"] / 2
    k7_bound_ms = max(k7_bytes / HBM_BYTES_PER_S,
                      float(nb) * BC7_PARTITION_OPS[7] / OPS_PER_S) * 1e3
    emit({"phase": "alpha2k", "card": smi, "blocks": nb,
          "bucket_counts": bucket_counts,
          "k7_mode7_bound_ms": k7_bound_ms,
          "opaque_blocks": int((px_a.reshape(16, 4, -1)[:, 3, :] == 255)
                               .all(dim=0).sum()),
          "runs": runs, "ms": med,
          "alpha_path_mtexels_per_s": texels / (med["alpha_path"] * 1e-3)
          / 1e6,
          "quick_path_mtexels_per_s": texels / (
              med["quick_path_alpha"] * 1e-3) / 1e6,
          "opaque_path_ms_earlier_run": opaque_ms,
          "earlier_opaque_ms": EARLIER_OPAQUE_MS})

    n_alpha = int(count_k)
    ops = {"bc7_alpha_list": 0.0,    # a compare a texel: bytes bound it
           "bc7_mode7": n_alpha * float(BC7_PARTITION_OPS[7]),
           "bc7_encode_quick": float(nb) * BC7_SEARCH_QUICK_OPS,
           "bc7_refine_alpha": per_mode_ops(torch, bc67._mode_of(
               bc67._words_i64(w_search_a)), BC7_REFINE_OPS)}
    k_ms = {k: med[k] for k in ops}
    # mode 7's launch moves the bytes of the blocks with alpha only
    nbs = dict({k: nb for k in ops}, bc7_mode7=n_alpha)
    return {"launches": launches, "k_ms": k_ms, "plain_ms": plain_ms,
            "max_err": max_err, "nb": nbs, "ops": ops, "img_alpha": img_a,
            "extra_bytes": {"bc7_alpha_list": 4.0 * n_alpha}}


def bc7_maxq_phases(torch, to_dev, event_ms, smi, b512, corpus, img_opaque,
                    img_alpha) -> dict:
    """Phases 15-17. Returns the launches (from the maxq paths' runs),
    times, plain times, errors against the twins, block counts and
    operations of K2's maxq variants and of K3's maxq-scope moment and
    exact-ladder instances."""
    from directxtex_tpu_torch.bc import bc67, cuda_kernels
    from directxtex_tpu_torch.bc.common import image_to_blocks

    def px_of(blocks):
        return bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()

    def same(a, b, what):
        """Kernel and twin agree word for word, and the search errors bit
        for bit (the twins sum in the kernels' order)."""
        check(a.shape == b.shape and torch.equal(a, b),
              f"{what} differs from plain")

    def word_diff(a, b):
        return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    opaque, alpha = bc67.SEARCH_MODES, bc67.SEARCH_MODES_ALPHA
    tier = bc67.TIER_MAXQ
    full, light = bc67.LADDER_FULL, bc67.LADDER_LIGHT
    size = SLICE_SIZE

    # 15. K2 maxq and K3 (moment with mode 6, exact ladders) vs twins -----
    rng = np.random.default_rng(11)
    mixed = rng.random((200, 16, 4)).astype(np.float32)
    mixed[:100, :, 3] = 1.0
    px512 = px_of(image_to_blocks(to_dev(b512["img"]))[0])
    contents = [("bench512", px512, opaque), ("bench512", px512, alpha)]
    contents += [(c, px_of(image_to_blocks(to_dev(corpus[c]))[0]), opaque)
                 for c in OPAQUE_CORPUS]
    contents += [("alphagrad", px_of(image_to_blocks(
        to_dev(corpus["alphagrad"]))[0]), alpha),
        ("mixed200", px_of(to_dev(mixed)), alpha)]
    for label, px, modes in contents:
        for aw in ALPHA_WEIGHTS:
            what = f"{label} modes={modes} aw={aw}"
            e_k, w_k = cuda_kernels.bc7_encode(px, modes, aw, tier)
            e_p, w_p = bc67._bc7_search_plain(px, modes, aw, tier)
            same(w_k, w_p, f"K2 maxq words {what}")
            same(e_k, e_p, f"K2 maxq errors {what}")
            out = {"phase": "K2_maxq", "content": label, "modes": modes,
                   "aw": aw, "blocks": px.shape[1], "words_equal": True,
                   "errors_equal": True, "search_modes": torch.bincount(
                       bc67._mode_of(bc67._words_i64(w_k)),
                       minlength=9).tolist()}
            if label in ("alphagrad", "mixed200"):
                # the search with picks against the maxq team's 21
                # evaluations a block in plain form, folded
                e_s, w_s, p_s = cuda_kernels.bc7_search_picks(px, aw, tier)
                picks_j, jobs = bc67._maxq_jobs_plain(px, aw)
                e_j, w_j = bc67._maxq_fold_plain(jobs)
                same(w_s, w_j, f"K2 maxq words vs its jobs' twin {what}")
                same(e_s, e_j, f"K2 maxq errors vs its jobs' twin {what}")
                same(p_s, picks_j, f"K2 maxq picks vs its jobs' twin {what}")
                out["jobs_twin_equal"] = True
            r_m = cuda_kernels.bc7_refine(px, w_k, modes, aw)
            same(r_m, bc67._bc7_refine_plain(px, w_k, modes, aw),
                 f"K3 moment {what}")
            for name, lad in (("full", full), ("light", light)):
                r_k = cuda_kernels.bc7_refine(px, r_m, modes, aw, lad)
                same(r_k, bc67._bc7_refine_plain(px, r_m, modes, aw, lad),
                     f"K3 {name} {what}")
                out[f"K3_{name}_refined_blocks"] = int(
                    (r_k != r_m).any(dim=0).sum())
            out["K3_moment_refined_blocks"] = int(
                (r_m != w_k).any(dim=0).sum())
            if modes == alpha and label in ("bench512", "alphagrad"):
                # mode 6 wins few blocks: refine every block's mode-6
                # encode (QUICK's words), as QUICK|MAXQUALITY does
                _, w_q = cuda_kernels.bc7_encode(px, (6,), aw, tier)
                for name, lad in (("moment", bc67.LADDER_MOMENT),
                                  ("full", full)):
                    r_k = cuda_kernels.bc7_refine(px, w_q, (6,), aw, lad)
                    same(r_k, bc67._bc7_refine_plain(px, w_q, (6,), aw, lad),
                         f"K3 mode 6 {name} {what}")
                    out[f"K3_mode6_{name}_refined_blocks"] = int(
                        (r_k != w_q).any(dim=0).sum())
            emit(out)

    # 16. maxq gates (tests/test_bc7.py:200-214, verify_bc7_tpu.py) -------
    def psnr_of(blocks, flags):
        enc = bc67.encode_bc7(blocks, flags)
        dec = bc67.decode_bc7(enc).to(torch.float64)
        mse = float(((dec - blocks.to(torch.float64)) ** 2).mean())
        return 10 * np.log10(1.0 / max(mse, 1e-30)), enc

    gates = {}
    for label, img in [("bench512", b512["img"])] + [
            (c, corpus[c]) for c in OPAQUE_CORPUS + ("alphagrad",)]:
        blocks = image_to_blocks(to_dev(img))[0]
        base, _ = psnr_of(blocks, 0)
        hq, enc = psnr_of(blocks, MAXQ)
        check(hq >= base - MAXQ_GATE_SLACK,
              f"maxq {label}: {hq} dB < default {base} - {MAXQ_GATE_SLACK}")
        words = enc.view(torch.int32).t()[:, ::29].contiguous()
        check(torch.equal(cuda_kernels.bc7_decode(words),
                          bc67._bc7_decode_plain(words)),
              f"K1 on maxq words {label}")
        gates[label] = {"maxq": hq, "default": base}
    ref_psnr = float(b512["ref_psnr"])
    check(gates["bench512"]["maxq"] >= ref_psnr,
          f"maxq bench512 {gates['bench512']['maxq']} < {ref_psnr}")
    emit({"phase": "maxq_gates", "psnr": gates, "ref_psnr": ref_psnr,
          "slack_db": MAXQ_GATE_SLACK, "K1_sample_equal": True})

    # 17. the maxq paths at 2048^2 ----------------------------------------
    def path(img, flags):
        return bc67.encode_bc7(image_to_blocks(img)[0], flags)

    px_o = px_of(image_to_blocks(img_opaque)[0])
    px_a = px_of(image_to_blocks(img_alpha)[0])
    nb = px_o.shape[1]
    runs = {}
    for name, img in (("opaque", img_opaque), ("alpha", img_alpha)):
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        blocks = image_to_blocks(img)[0]
        dec = bc67.decode_bc7(bc67.encode_bc7(blocks, MAXQ))
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda_kernels.launch_counts().items()
                  if v}
        # K2 maxq (with alpha also mode 7's list pass and launch), then K3
        # twice: a bucket pass and one launch per mode of the search's
        # modes (five, six with mode 7) for each ladder
        n_modes = 6 if name == "alpha" else 5
        want = {"bc7_encode_maxq": 1, "bc7_mode_buckets": 2,
                "bc7_refine_maxq": n_modes, "bc7_refine_ladder": n_modes,
                "bc7_decode": 1}
        if name == "alpha":
            want.update(bc7_alpha_list=1, bc7_mode7=1)
        check(counts == want, f"maxq {name} launches {counts}")
        check(tuple(dec.shape) == (nb, 16, 4)
              and bool(torch.isfinite(dec).all()), f"maxq {name} output")
        mse = float(((dec.to(torch.float64) - blocks.to(torch.float64))
                     ** 2).mean())
        runs[name] = {"launches": counts,
                      "psnr": 10 * np.log10(1.0 / max(mse, 1e-30))}
    launches = {k: runs["opaque"]["launches"][k] for k in (
        "bc7_encode_maxq", "bc7_refine_maxq", "bc7_refine_ladder")}

    # the kernels' inputs at the paths' shapes, held against the twins once
    plain, plain_ms, max_err, states = {}, {}, {}, {}
    for name, px, modes, k2 in (("opaque", px_o, opaque, "bc7_encode_maxq"),
                                ("alpha", px_a, alpha, "search_maxq_alpha")):
        e_k, w_s = cuda_kernels.bc7_encode(px, modes, 1.0, tier)
        w_m = cuda_kernels.bc7_refine(px, w_s, modes)
        w_f = cuda_kernels.bc7_refine(px, w_m, modes, 1.0, full)
        states[name] = (px, modes, w_s, w_m)
        plain_ms[k2] = event_ms(lambda: plain.update(
            search=bc67._bc7_search_plain(px, modes, 1.0, tier)))[0]
        same(w_s, plain["search"][1], f"K2 maxq words {name} {size}^2")
        same(e_k, plain["search"][0], f"K2 maxq errors {name} {size}^2")
        max_err[k2] = float((e_k - plain["search"][0]).abs().max())
        e_2, w_2 = cuda_kernels.bc7_encode(px, modes, 2.0, tier)
        e_p2, w_p2 = bc67._bc7_search_plain(px, modes, 2.0, tier)
        same(w_2, w_p2, f"K2 maxq words {name} {size}^2 aw=2.0")
        same(e_2, e_p2, f"K2 maxq errors {name} {size}^2 aw=2.0")
        if name == "opaque":
            # with picks: the same words, and the twin's ranking
            e_pk, w_pk, p_pk = cuda_kernels.bc7_search_picks(px, 1.0, tier)
            same(w_pk, plain["search"][1], f"K2 maxq words {name} picks")
            same(e_pk, plain["search"][0], f"K2 maxq errors {name} picks")
            same(p_pk, bc67._partition_shapes_plain(px, 1, 64, 4),
                 f"K2 maxq picks {name} {size}^2")
        # both K3 calls of each path, held at that path's own shapes
        for k3, key, fn in (
                ("bc7_refine_maxq", "moment",
                 lambda: bc67._bc7_refine_plain(px, w_s, modes)),
                ("bc7_refine_ladder", "full",
                 lambda: bc67._bc7_refine_plain(px, w_m, modes, 1.0, full))):
            t = event_ms(lambda: plain.update({key: fn()}))[0]
            plain_ms[k3 if name == "opaque" else f"{k3}_alpha_image"] = t
            got = w_m if key == "moment" else w_f
            same(got, plain[key], f"K3 {key} {name} {size}^2")
            max_err[k3] = max(max_err.get(k3, 0.0),
                              word_diff(got, plain[key]))

    # mode 7's launch alone on the maxq search's picks, at both weights
    px_a = states["alpha"][0]
    for aw in ALPHA_WEIGHTS:
        e_q, w_q, p_q = cuda_kernels.bc7_search_picks(px_a, aw, tier)
        blocks_q, count_q = cuda_kernels.bc7_alpha_list(px_a)
        e_7, w_7 = e_q.clone(), w_q.clone()
        cuda_kernels.bc7_mode7(px_a, p_q, blocks_q, count_q, e_7, w_7, aw)
        t_7 = event_ms(lambda: plain.update(mode7=bc67._mode7_fold_plain(
            px_a, p_q, e_q, w_q, aw)))[0]
        same(w_7, plain["mode7"][1], f"mode 7 words, maxq picks, aw={aw}")
        same(e_7, plain["mode7"][0], f"mode 7 errors, maxq picks, aw={aw}")
        if aw == 1.0:
            plain_ms["bc7_mode7_maxq"] = t_7
    emit({"phase": "mode7_maxq_picks", "blocks": px_a.shape[1],
          "alpha_blocks": int(count_q), "aws": list(ALPHA_WEIGHTS),
          "words_errors_equal": True})

    med = {}
    (px_o, _, ws_o, wm_o), (px_a, _, ws_a, wm_a) = (states["opaque"],
                                                    states["alpha"])
    e_m, w_m, picks_m = cuda_kernels.bc7_search_picks(px_a, 1.0, tier)
    blocks_m, count_m = cuda_kernels.bc7_alpha_list(px_a)
    w_default = cuda_kernels.bc7_encode(px_o)[1]
    for name, fn in (
            ("maxq_path_opaque", lambda: path(img_opaque, MAXQ)),
            ("maxq_path_alpha", lambda: path(img_alpha, MAXQ)),
            ("bc7_encode_maxq", lambda: cuda_kernels.bc7_encode(
                px_o, opaque, 1.0, tier)),
            ("search_maxq_alpha", lambda: cuda_kernels.bc7_encode(
                px_a, alpha, 1.0, tier)),
            ("bc7_search_picks_maxq", lambda: cuda_kernels.bc7_search_picks(
                px_a, 1.0, tier)),
            ("bc7_mode7_maxq", lambda: cuda_kernels.bc7_mode7(
                px_a, picks_m, blocks_m, count_m, e_m, w_m)),
            ("bc7_refine_maxq", lambda: cuda_kernels.bc7_refine(
                px_o, ws_o, opaque)),
            ("bc7_refine_ladder", lambda: cuda_kernels.bc7_refine(
                px_o, wm_o, opaque, 1.0, full)),
            ("bc7_refine_maxq_alpha_image", lambda: cuda_kernels.bc7_refine(
                px_a, ws_a, alpha)),
            ("bc7_refine_ladder_alpha_image", lambda: cuda_kernels.bc7_refine(
                px_a, wm_a, alpha, 1.0, full)),
            ("bc7_refine_light", lambda: cuda_kernels.bc7_refine(
                px_o, wm_o, opaque, 1.0, light)),
            ("default_path_opaque", lambda: bc67.encode_bc7(
                image_to_blocks(img_opaque)[0], opaque=True)),
            ("default_path_alpha", lambda: path(img_alpha, 0)),
            ("bc7_encode", lambda: cuda_kernels.bc7_encode(px_o)),
            ("bc7_refine", lambda: cuda_kernels.bc7_refine(
                px_o, w_default, bc67.REFINE_MODES)),
            # the default scope (mode 6 not refined) on the maxq search's
            # words, beside bc7_refine_maxq on the same words
            ("bc7_refine_on_maxq_words", lambda: cuda_kernels.bc7_refine(
                px_o, ws_o, bc67.REFINE_MODES))):
        fn()
        med[name] = float(np.median(event_ms(fn, 7)))
    texels = size * size
    modes_m = bc67._mode_of(bc67._words_i64(wm_o))
    light_bound_ms = per_mode_ops(torch, modes_m, BC7_REFINE_LIGHT_OPS) \
        / OPS_PER_S * 1e3
    emit({"phase": "maxq2k", "card": smi, "blocks": nb, "runs": runs,
          "light_bound_ms": light_bound_ms,
          "ms": med, "maxq_path_mtexels_per_s": {
              k: texels / (med[f"maxq_path_{k}"] * 1e-3) / 1e6
              for k in ("opaque", "alpha")},
          "search_modes": {k: torch.bincount(bc67._mode_of(bc67._words_i64(
              states[k][2])), minlength=9).tolist() for k in states},
          "plain_ms": plain_ms, "words_equal_plain": True,
          "earlier_opaque_ms": EARLIER_OPAQUE_MS})

    ops = {"bc7_encode_maxq": float(nb) * BC7_SEARCH_MAXQ_OPS,
           "bc7_refine_maxq": per_mode_ops(torch, bc67._mode_of(
               bc67._words_i64(ws_o)), BC7_REFINE_OPS),
           "bc7_refine_ladder": per_mode_ops(torch, modes_m,
                                             BC7_REFINE_FULL_OPS)}
    k_ms = {k: med[k] for k in ops}
    return {"launches": launches, "k_ms": k_ms, "plain_ms": plain_ms,
            "max_err": max_err, "nb": {k: nb for k in ops}, "ops": ops}


def img_blocks_content(torch, to_dev):
    """tests/test_bc7.py:159's img_blocks() (seed 1, opaque) as [NB, 16,
    4] blocks on the card."""
    from directxtex_tpu_torch.bc.common import image_to_blocks

    rng = np.random.default_rng(1)
    x = np.linspace(0, 1, 32, dtype=np.float32)
    gx, gy = np.meshgrid(x, x)
    img = np.stack([np.sin(gx * 9) * 0.4 + 0.5, gy * 0.8, gx * gy,
                    np.ones_like(gx)], -1)
    img += (rng.random(img.shape).astype(np.float32) - 0.5) * 0.04
    img = (np.round(np.clip(img, 0, 1) * 255) / 255).astype(np.float32)
    img[..., 3] = 1.0
    return image_to_blocks(to_dev(img))[0]


def bc7_3sub_phases(torch, to_dev, event_ms, smi, b512, corpus, img_opaque,
                    img_alpha) -> dict:
    """Phases 18-20, USE_3SUBSETS. Returns the launches (from the
    USE_3SUBSETS paths' runs), times, plain times, errors against the
    twins, block counts and operations of K9, K7 and K3's three-subset
    instances."""
    from directxtex_tpu_torch.bc import bc67, cuda_kernels
    from directxtex_tpu_torch.bc.common import image_to_blocks

    def px_of(blocks):
        return bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()

    def same(a, b, what):
        """Kernel and twin agree: picks and words exactly, errors bit for
        bit (the twins sum in the kernels' order)."""
        check(a.shape == b.shape and torch.equal(a, b),
              f"{what} differs from plain")

    def word_diff(a, b):
        return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    def hist(words):
        return torch.bincount(bc67._mode_of(bc67._words_i64(words)),
                              minlength=9).tolist()

    full, light = bc67.LADDER_FULL, bc67.LADDER_LIGHT
    size = SLICE_SIZE

    # 18. K9, K7, the search with modes 0/2 and K3's 3-subset instances ---
    rng = np.random.default_rng(11)
    mixed = rng.random((200, 16, 4)).astype(np.float32)
    mixed[:100, :, 3] = 1.0
    batch = np.load(os.path.join(GOLDEN, "bc7_3subsets.npz"))["blocks"]
    contents = [("bench512", px_of(image_to_blocks(to_dev(b512["img"]))[0]))]
    contents += [(c, px_of(image_to_blocks(to_dev(corpus[c]))[0]))
                 for c in OPAQUE_CORPUS + ("alphagrad",)]
    contents += [("mixed200", px_of(to_dev(mixed))),
                 ("sub3batch", px_of(to_dev(batch)))]
    for label, px in contents:
        alpha = bool((px.reshape(16, 4, -1)[:, 3, :] != 255).any())
        search = bc67.SEARCH_MODES_3_ALPHA if alpha else bc67.SEARCH_MODES_3
        scope = bc67.REFINE_MODES_3_ALPHA if alpha else bc67.REFINE_MODES_3
        picks = {}
        for parts, n in ((2, 16), (2, 64), (1, 64)):
            picks[parts, n] = cuda_kernels.bc7_partition_shapes(px, parts, n)
            same(picks[parts, n], bc67._partition_shapes_plain(px, parts, n, 4),
                 f"K9 {label} partitions={parts} shapes={n}")
        # the path's one launch: both three-subset lists
        s16, s64 = cuda_kernels.bc7_partition_shapes_3sub(px)
        same(s16, picks[2, 16], f"K9 path launch 16 shapes {label}")
        same(s64, picks[2, 64], f"K9 path launch 64 shapes {label}")
        for aw in ALPHA_WEIGHTS:
            what = f"{label} aw={aw}"
            for mode, key in ((0, (2, 16)), (2, (2, 64)), (1, (1, 64)),
                              (3, (1, 64)), (7, (1, 64))):
                e_k, w_k = cuda_kernels.bc7_partition_mode(px, picks[key],
                                                           mode, aw)
                e_p, w_p = bc67._partition_mode_plain(px, picks[key], mode,
                                                      aw)
                same(w_k, w_p, f"K7 mode {mode} words {what}")
                same(e_k, e_p, f"K7 mode {mode} errors {what}")
                if label in ("mixed200", "sub3batch"):
                    e_j, w_j = bc67._partition_jobs_fold_plain(
                        bc67._partition_jobs_plain(px, picks[key], mode, aw))
                    same(w_k, w_j, f"K7 mode {mode} words vs jobs {what}")
                    same(e_k, e_j, f"K7 mode {mode} errors vs jobs {what}")
            e_k, w_k = bc67.bc7_search_words(px, search, aw)
            e_p, w_p = bc67._bc7_search_plain(px, search, aw)
            same(w_k, w_p, f"search with modes 0/2 words {what}")
            same(e_k, e_p, f"search with modes 0/2 errors {what}")
            out = {"phase": "K9_K7_K3_3sub", "content": label, "aw": aw,
                   "blocks": px.shape[1], "picks_equal": True,
                   "words_equal": True, "errors_equal": True,
                   "search_modes": hist(w_k)}
            r_m = cuda_kernels.bc7_refine(px, w_k, (0, 2), aw)
            same(r_m, bc67._bc7_refine_plain(px, w_k, (0, 2), aw),
                 f"K3 3sub moment {what}")
            for name, lad in (("full", full), ("light", light)):
                r_k = cuda_kernels.bc7_refine(px, r_m, (0, 2), aw, lad)
                same(r_k, bc67._bc7_refine_plain(px, r_m, (0, 2), aw, lad),
                     f"K3 3sub {name} {what}")
                out[f"K3_3sub_{name}_refined_blocks"] = int(
                    (r_k != r_m).any(dim=0).sum())
            out["K3_3sub_moment_refined_blocks"] = int(
                (r_m != w_k).any(dim=0).sum())
            # the per-mode launches over the whole default scope = one
            # plain refine
            same(cuda_kernels.bc7_refine(px, w_k, scope, aw),
                 bc67._bc7_refine_plain(px, w_k, scope, aw),
                 f"K3 whole scope {what}")
            emit(out)
            if label == "sub3batch":
                check(out["search_modes"][0] > 0
                      and out["search_modes"][2] > 0,
                      f"modes 0 and 2 win no block of {what}")
    # the maxq tier's search with modes 0/2 (K2's maxq variants)
    for label, px in (contents[0], contents[-1]):
        alpha = bool((px.reshape(16, 4, -1)[:, 3, :] != 255).any())
        search = bc67.SEARCH_MODES_3_ALPHA if alpha else bc67.SEARCH_MODES_3
        e_k, w_k = bc67.bc7_search_words(px, search, 1.0, bc67.TIER_MAXQ)
        e_p, w_p = bc67._bc7_search_plain(px, search, 1.0, bc67.TIER_MAXQ)
        same(w_k, w_p, f"maxq search with modes 0/2 words {label}")
        same(e_k, e_p, f"maxq search with modes 0/2 errors {label}")
        emit({"phase": "maxq_search_3sub", "content": label,
              "blocks": px.shape[1], "words_equal": True,
              "errors_equal": True, "search_modes": hist(w_k)})

    # 19. USE_3SUBSETS gates --------------------------------------------
    def psnr_of(blocks, flags):
        dec = bc67.decode_bc7(bc67.encode_bc7(blocks, flags))
        mse = float(((dec.to(torch.float64) - blocks.to(torch.float64))
                     ** 2).mean())
        return 10 * np.log10(1.0 / max(mse, 1e-30))

    blocks512 = image_to_blocks(to_dev(b512["img"]))[0]
    gates = {"bench512": {"use3": psnr_of(blocks512, USE3),
                          "default": psnr_of(blocks512, 0)}}
    ref_psnr = float(b512["ref_psnr"])
    check(gates["bench512"]["use3"] >= ref_psnr,
          f"USE_3SUBSETS bench512 {gates['bench512']['use3']} < {ref_psnr}")
    img_b = img_blocks_content(torch, to_dev)
    gates["img_blocks"] = {"use3": psnr_of(img_b, USE3)}
    check(gates["img_blocks"]["use3"] > USE3_FLOOR,
          f"img_blocks {gates['img_blocks']['use3']} <= {USE3_FLOOR}")
    for c in OPAQUE_CORPUS + ("alphagrad",):
        blocks = image_to_blocks(to_dev(corpus[c]))[0]
        gates[c] = {"use3": psnr_of(blocks, USE3),
                    "use3_maxq": psnr_of(blocks, USE3 | MAXQ)}
    emit({"phase": "use3_gates", "psnr": gates, "ref_psnr": ref_psnr,
          "img_blocks_floor": USE3_FLOOR})

    # 20. the USE_3SUBSETS paths at 2048^2 --------------------------------
    def path(img, flags):
        return bc67.encode_bc7(image_to_blocks(img)[0], flags)

    px_o = px_of(image_to_blocks(img_opaque)[0])
    nb = px_o.shape[1]
    runs = {}
    # K2's launches: its search, and with alpha mode 7's list pass and
    # launch
    mode7 = {"bc7_alpha_list": 1, "bc7_mode7": 1}
    for name, img, flags, k2, k3 in (
            ("use3_opaque", img_opaque, USE3, {"bc7_encode": 1},
             {"bc7_refine": 4}),
            ("use3_alpha", img_alpha, USE3, dict(mode7, bc7_encode=1),
             {"bc7_refine_alpha": 5}),
            ("use3_maxq_opaque", img_opaque, USE3 | MAXQ,
             {"bc7_encode_maxq": 1},
             {"bc7_refine_maxq": 5, "bc7_refine_ladder": 5,
              "bc7_refine_3sub_ladder": 2}),
            ("use3_maxq_alpha", img_alpha, USE3 | MAXQ,
             dict(mode7, bc7_encode_maxq=1),
             {"bc7_refine_maxq": 6, "bc7_refine_ladder": 6,
              "bc7_refine_3sub_ladder": 2})):
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        blocks = image_to_blocks(img)[0]
        enc = bc67.encode_bc7(blocks, flags)
        dec = bc67.decode_bc7(enc)
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda_kernels.launch_counts().items()
                  if v}
        # per K3 ladder a bucket pass, modes 0 and 2, and one launch per
        # other mode of the scope
        want = {"bc7_partition_shapes": 1, "bc7_partition_mode": 2, **k2,
                "bc7_mode_buckets": 2 if flags & MAXQ else 1,
                "bc7_refine_3sub": 2,
                "bc7_decode": 1}
        want.update(k3)
        check(counts == want, f"{name} launches {counts}")
        check(tuple(dec.shape) == (nb, 16, 4)
              and bool(torch.isfinite(dec).all()), f"{name} output")
        mse = float(((dec.to(torch.float64) - blocks.to(torch.float64))
                     ** 2).mean())
        runs[name] = {"launches": counts,
                      "psnr": 10 * np.log10(1.0 / max(mse, 1e-30)),
                      "winners": hist(enc.view(torch.int32).t())}
    launches = {k: runs["use3_opaque"]["launches"][k] for k in (
        "bc7_partition_shapes", "bc7_partition_mode", "bc7_refine_3sub")}
    launches["bc7_refine_3sub_ladder"] = runs["use3_maxq_opaque"][
        "launches"]["bc7_refine_3sub_ladder"]

    # the new kernels at the opaque paths' shapes, held against the twins:
    # K9 as the path launches it (both lists at once) and as the wrapper's
    # two rankings
    s16, s64 = cuda_kernels.bc7_partition_shapes_3sub(px_o)
    same(cuda_kernels.bc7_partition_shapes(px_o, 2, 16), s16,
         f"K9 wrapper 16 shapes {size}^2")
    same(cuda_kernels.bc7_partition_shapes(px_o, 2, 64), s64,
         f"K9 wrapper 64 shapes {size}^2")
    e0, w0 = cuda_kernels.bc7_partition_mode(px_o, s16, 0)
    e2, w2 = cuda_kernels.bc7_partition_mode(px_o, s64, 2)
    e_s, w_s = bc67.bc7_search_words(px_o, bc67.SEARCH_MODES_3)
    w_m = cuda_kernels.bc7_refine(px_o, w_s, bc67.REFINE_MODES_3)
    _, w_sq = bc67.bc7_search_words(px_o, bc67.SEARCH_MODES_3, 1.0,
                                    bc67.TIER_MAXQ)
    w_mq = cuda_kernels.bc7_refine(px_o, w_sq, bc67.SEARCH_MODES_3)
    w_fq = cuda_kernels.bc7_refine(px_o, w_mq, (0, 2), 1.0, full)
    plain, plain_ms = {}, {}
    plain_ms["bc7_partition_shapes"] = event_ms(lambda: plain.update(
        lists=bc67._shape_lists_plain(px_o)))[0]
    plain["s16"] = bc67._partition_shapes_plain(px_o, 2, 16, 4)
    plain["s64"] = bc67._partition_shapes_plain(px_o, 2, 64, 4)
    for got, want, n in ((s16, plain["s16"], 16), (s64, plain["s64"], 64),
                         (s16, plain["lists"][0], 16),
                         (s64, plain["lists"][1], 64)):
        same(got, want, f"K9 {n} shapes {size}^2")
    t0 = event_ms(lambda: plain.update(
        m0=bc67._partition_mode_plain(px_o, s16, 0)))[0]
    t2 = event_ms(lambda: plain.update(
        m2=bc67._partition_mode_plain(px_o, s64, 2)))[0]
    plain_ms["bc7_partition_mode"] = t0 + t2
    for (e_k, w_k), key in (((e0, w0), "m0"), ((e2, w2), "m2")):
        same(w_k, plain[key][1], f"K7 {key} words {size}^2")
        same(e_k, plain[key][0], f"K7 {key} errors {size}^2")
    t_s = event_ms(lambda: plain.update(
        search=bc67._bc7_search_plain(px_o, bc67.SEARCH_MODES_3)))[0]
    same(w_s, plain["search"][1], f"search with modes 0/2 {size}^2")
    same(e_s, plain["search"][0], f"search errors with modes 0/2 {size}^2")
    plain_ms["bc7_refine_3sub"] = event_ms(lambda: plain.update(
        r3=bc67._bc7_refine_plain(px_o, w_s, (0, 2))))[0]
    w_m3 = cuda_kernels.bc7_refine(px_o, w_s, (0, 2))
    same(w_m3, plain["r3"], f"K3 3sub moment {size}^2")
    plain_ms["bc7_refine_3sub_ladder"] = event_ms(lambda: plain.update(
        f3=bc67._bc7_refine_plain(px_o, w_mq, (0, 2), 1.0, full)))[0]
    same(w_fq, plain["f3"], f"K3 3sub full {size}^2")
    same(w_m, bc67._bc7_refine_plain(px_o, w_s, bc67.REFINE_MODES_3),
         f"K3 whole scope {size}^2")
    e_p, w_p = bc67._bc7_search_plain(px_o, bc67.SEARCH_MODES_3, 1.0,
                                      bc67.TIER_MAXQ)
    same(w_sq, w_p, f"maxq search with modes 0/2 {size}^2")
    max_err = {
        "bc7_partition_shapes": max(word_diff(s16, plain["s16"]),
                                    word_diff(s64, plain["s64"])),
        "bc7_partition_mode": max(
            float((e0 - plain["m0"][0]).abs().max()),
            float((e2 - plain["m2"][0]).abs().max())),
        "bc7_refine_3sub": word_diff(w_m3, plain["r3"]),
        "bc7_refine_3sub_ladder": word_diff(w_fq, plain["f3"])}

    # the same on the alpha paths' own inputs: K7 scores modes 0/2 with the
    # alpha error counted, and K3 refines the alpha image's mode-0/2 winners
    px_a = px_of(image_to_blocks(img_alpha)[0])
    search_a = bc67.SEARCH_MODES_3_ALPHA
    alpha_cmp = {}
    lists_a = dict(zip((16, 64),
                       cuda_kernels.bc7_partition_shapes_3sub(px_a)))
    for n in (16, 64):
        s_k = lists_a[n]
        s_p = bc67._partition_shapes_plain(px_a, 2, n, 4)
        same(s_k, s_p, f"K9 {n} shapes alpha {size}^2")
        max_err["bc7_partition_shapes"] = max(
            max_err["bc7_partition_shapes"], word_diff(s_k, s_p))
        mode = 0 if n == 16 else 2
        e_k, w_k = cuda_kernels.bc7_partition_mode(px_a, s_k, mode)
        e_p, w_p = bc67._partition_mode_plain(px_a, s_k, mode)
        same(w_k, w_p, f"K7 mode {mode} words alpha {size}^2")
        same(e_k, e_p, f"K7 mode {mode} errors alpha {size}^2")
        max_err["bc7_partition_mode"] = max(
            max_err["bc7_partition_mode"], float((e_k - e_p).abs().max()))
    for tier, key in ((bc67.TIER_DEFAULT, "default"),
                      (bc67.TIER_MAXQ, "maxq")):
        e_k, w_k = bc67.bc7_search_words(px_a, search_a, 1.0, tier)
        e_p, w_p = bc67._bc7_search_plain(px_a, search_a, 1.0, tier)
        same(w_k, w_p, f"{key} search with modes 0/2 alpha {size}^2")
        same(e_k, e_p, f"{key} search errors with modes 0/2 alpha {size}^2")
        # K3 MOMENT over (0, 2) alone, then the path's whole MOMENT scope
        # and, at maxq, FULL over (0, 2) on its output
        r_k = cuda_kernels.bc7_refine(px_a, w_k, (0, 2))
        r_p = bc67._bc7_refine_plain(px_a, w_k, (0, 2))
        same(r_k, r_p, f"K3 3sub moment {key} alpha {size}^2")
        max_err["bc7_refine_3sub"] = max(max_err["bc7_refine_3sub"],
                                         word_diff(r_k, r_p))
        scope = (bc67.REFINE_MODES_3_ALPHA if tier == bc67.TIER_DEFAULT
                 else search_a)
        m_k = cuda_kernels.bc7_refine(px_a, w_k, scope)
        same(m_k, bc67._bc7_refine_plain(px_a, w_k, scope),
             f"K3 whole scope {key} alpha {size}^2")
        modes_a = bc67._mode_of(bc67._words_i64(w_k))
        alpha_cmp[key] = {"search_modes": hist(w_k),
                          "mode02_blocks": int(((modes_a == 0)
                                                | (modes_a == 2)).sum()),
                          "moment_refined_blocks": int(
                              (r_k != w_k).any(dim=0).sum())}
        if tier == bc67.TIER_MAXQ:
            f_k = cuda_kernels.bc7_refine(px_a, m_k, (0, 2), 1.0, full)
            f_p = bc67._bc7_refine_plain(px_a, m_k, (0, 2), 1.0, full)
            same(f_k, f_p, f"K3 3sub full alpha {size}^2")
            max_err["bc7_refine_3sub_ladder"] = max(
                max_err["bc7_refine_3sub_ladder"], word_diff(f_k, f_p))
            alpha_cmp[key]["full_refined_blocks"] = int(
                (f_k != m_k).any(dim=0).sum())

    med = {}
    for name, fn in (
            ("use3_path_opaque", lambda: path(img_opaque, USE3)),
            ("use3_path_alpha", lambda: path(img_alpha, USE3)),
            ("use3_maxq_path_opaque", lambda: path(img_opaque, USE3 | MAXQ)),
            ("use3_maxq_path_alpha", lambda: path(img_alpha, USE3 | MAXQ)),
            ("default_path_opaque", lambda: path(img_opaque, 0)),
            ("default_path_alpha", lambda: path(img_alpha, 0)),
            ("maxq_path_opaque", lambda: path(img_opaque, MAXQ)),
            ("maxq_path_alpha", lambda: path(img_alpha, MAXQ)),
            ("bc7_partition_shapes_path", lambda: cuda_kernels
             .bc7_partition_shapes_3sub(px_o)),
            ("bc7_partition_shapes_16", lambda: cuda_kernels
             .bc7_partition_shapes(px_o, 2, 16)),
            ("bc7_partition_shapes_64", lambda: cuda_kernels
             .bc7_partition_shapes(px_o, 2, 64)),
            ("bc7_partition_mode_0", lambda: cuda_kernels.bc7_partition_mode(
                px_o, s16, 0)),
            ("bc7_partition_mode_2", lambda: cuda_kernels.bc7_partition_mode(
                px_o, s64, 2)),
            ("bc7_encode", lambda: cuda_kernels.bc7_encode(px_o)),
            ("bc7_refine_3sub", lambda: cuda_kernels.bc7_refine(
                px_o, w_s, (0, 2))),
            ("bc7_refine_default_scope", lambda: cuda_kernels.bc7_refine(
                px_o, w_s, bc67.REFINE_MODES)),
            ("bc7_refine_3sub_ladder", lambda: cuda_kernels.bc7_refine(
                px_o, w_mq, (0, 2), 1.0, full)),
            ("bc7_refine_ladder", lambda: cuda_kernels.bc7_refine(
                px_o, w_mq, bc67.SEARCH_MODES, 1.0, full)),
            ("search_use3", lambda: bc67.bc7_search_words(
                px_o, bc67.SEARCH_MODES_3))):
        fn()
        med[name] = float(np.median(event_ms(fn, 7)))
    texels = size * size
    emit({"phase": "use3_2k", "card": smi, "blocks": nb, "runs": runs,
          "ms": med, "mtexels_per_s": {
              k: texels / (med[k] * 1e-3) / 1e6 for k in med
              if "path" in k},
          "search_modes_default_tier": hist(w_s),
          "search_modes_maxq_tier": hist(w_sq),
          "plain_ms": plain_ms, "plain_search_ms": t_s,
          "words_equal_plain": True, "alpha_equal_plain": alpha_cmp})

    k_ms = {"bc7_partition_shapes": med["bc7_partition_shapes_path"],
            "bc7_partition_mode": med["bc7_partition_mode_0"]
            + med["bc7_partition_mode_2"],
            "bc7_refine_3sub": med["bc7_refine_3sub"],
            "bc7_refine_3sub_ladder": med["bc7_refine_3sub_ladder"]}
    modes_s = bc67._mode_of(bc67._words_i64(w_s))
    modes_m = bc67._mode_of(bc67._words_i64(w_mq))
    ops = {"bc7_partition_shapes": float(nb) * BC7_SHAPES_OPS[64],
           "bc7_partition_mode": float(nb) * (BC7_PARTITION_OPS[0]
                                              + BC7_PARTITION_OPS[2]),
           "bc7_refine_3sub": per_mode_ops(torch, modes_s, {
               m: BC7_REFINE_OPS[m] for m in (0, 2)}),
           "bc7_refine_3sub_ladder": per_mode_ops(torch, modes_m, {
               m: BC7_REFINE_FULL_OPS[m] for m in (0, 2)})}
    n02 = {"bc7_refine_3sub": int(((modes_s == 0) | (modes_s == 2)).sum()),
           "bc7_refine_3sub_ladder": int(
               ((modes_m == 0) | (modes_m == 2)).sum())}
    return {"launches": launches, "k_ms": k_ms, "plain_ms": plain_ms,
            "max_err": max_err, "nb": {k: nb for k in ops}, "ops": ops,
            "extra_bytes": {k: float(n) * BC7_PIXEL_BYTES
                            for k, n in n02.items()}}


def bc6h_unshared_phases(torch, to_dev, event_ms, smi) -> dict:
    """Phases 21-23, BC6H with bc6h.BC6H_SHARED_FIT = False. Returns the
    launches (from config 4's run), times, plain times, errors against the
    twins, block counts and operations of K10, the BC6H shape ranking and
    K11."""
    from directxtex_tpu_torch.bc import bc6h, cuda_kernels
    from directxtex_tpu_torch.bc.common import image_to_blocks
    from directxtex_tpu_torch.models import pipelines

    def same(a, b, what):
        """Kernel and twin agree: picks and words exactly, errors bit for
        bit (infinities included)."""
        check(a.shape == b.shape and torch.equal(a, b),
              f"{what} differs from plain")

    groups = bc6h._bc6h_row_groups()
    fold = bc6h._fold_launches

    def finite_diff(a, b):
        fin = torch.isfinite(a) & torch.isfinite(b)
        return float((a - b)[fin].abs().max()) if bool(fin.any()) else 0.0

    max_err = {"bc6h_1region": 0.0, "bc6h_shapes": 0.0, "bc6h_2region": 0.0}

    all_groups = range(len(groups))

    def hold(px, signed, what, n_plain=None):
        """K10, the ranking and K11 (its one launch over the six groups,
        and each group alone) on px, held against their twins on the first
        n_plain blocks (all by default); the largest differences go into
        max_err. Returns the twins' times, the kernels' outputs (K11's
        one launch) and the twins' fold over (K10, group 0, ..., group
        5)."""
        e1, w1 = cuda_kernels.bc6h_1region(px, signed)
        sb = cuda_kernels.bc6h_shapes(px)
        k11 = cuda_kernels.bc6h_2region(px, sb, all_groups, signed)
        res2 = [cuda_kernels.bc6h_2region(px, sb, (g,), signed)
                for g in all_groups]
        n = px.shape[1] if n_plain is None else n_plain
        pp = px[:, :n].contiguous()
        out, t = {}, {}
        t["bc6h_1region"] = event_ms(lambda: out.update(
            k10=bc6h._bc6h_1region_plain(pp, signed)))[0]
        t["bc6h_shapes"] = event_ms(lambda: out.update(
            sh=bc6h._bc6h_shapes_plain(pp)))[0]
        same(sb[:, :n], out["sh"], f"ranking picks {what}")
        same(sb[:, :n], bc6h._bc6h_shapes_slices_plain(pp),
             f"ranking picks against its team's plain form {what}")
        same(w1[:, :n], out["k10"][1], f"K10 words {what}")
        same(e1[:n], out["k10"][0], f"K10 errors {what}")
        max_err["bc6h_1region"] = max(max_err["bc6h_1region"],
                                      finite_diff(e1[:n], out["k10"][0]))
        max_err["bc6h_shapes"] = max(max_err["bc6h_shapes"], float(
            (sb[:, :n] - out["sh"]).abs().max()))
        sbp = sb[:, :n].contiguous()
        plain2 = []
        t["bc6h_2region"] = 0.0
        for g, rows in enumerate(groups):
            t["bc6h_2region"] += event_ms(lambda: out.update(
                g=bc6h._bc6h_2region_plain(pp, sbp, rows, signed)))[0]
            same(res2[g][1][:, :n], out["g"][1], f"K11 {rows} words {what}")
            same(res2[g][0][:n], out["g"][0], f"K11 {rows} errors {what}")
            max_err["bc6h_2region"] = max(max_err["bc6h_2region"],
                                          finite_diff(res2[g][0][:n],
                                                      out["g"][0]))
            plain2.append(out["g"])
        # the one launch: the groups' twins folded in group order, the
        # first taken as it is (_bc6h_2region_groups_plain)
        k11_plain = None
        for r in plain2:
            k11_plain = bc6h._fold_first(k11_plain, *r)
        same(k11[1][:, :n], k11_plain[1], f"K11 one launch words {what}")
        same(k11[0][:n], k11_plain[0], f"K11 one launch errors {what}")
        max_err["bc6h_2region"] = max(max_err["bc6h_2region"],
                                      finite_diff(k11[0][:n], k11_plain[0]))
        inf = {f"group{g}_no_fit": int((~torch.isfinite(r[0])).sum())
               for g, r in enumerate(res2)}
        inf["one_launch_no_fit"] = int((~torch.isfinite(k11[0])).sum())
        return (t, (e1, w1), sb, k11, fold([out["k10"]] + plain2), inf)

    # 21. K10, the ranking and K11 against their twins -------------------
    corpus = np.load(os.path.join(GOLDEN, "corpus.npz"))

    frozen_words = np.load(os.path.join(GOLDEN, "bc6h_unshared.npz"))
    for signed in (False, True):
        pre = "s_" if signed else "u_"
        contents = [(c, image_to_blocks(to_dev(corpus[c]))[0])
                    for c in HDR_CORPUS]
        contents.append(("random", to_dev(hdr_random_set(signed))))
        contents.append(("bc6h_unshared.npz",
                         to_dev(frozen_words[pre + "blocks"])))
        for label, blocks in contents:
            px = bc6h.px_of_blocks(blocks, signed)
            what = f"{label} signed={signed}"
            _, k10, _, k11, (fe, fw), inf = hold(px, signed, what)
            e_s, w_s = bc6h._search_unshared(px, signed)
            same(w_s, fw, f"unshared search words {what}")
            same(e_s, fe, f"unshared search errors {what}")
            # the search's fold of K10 and the one launch
            e_1, w_1 = fold([k10, k11])
            same(w_1, fw, f"K10 + K11 one launch fold words {what}")
            same(e_1, fe, f"K10 + K11 one launch fold errors {what}")
            extra = {}
            if label == "bc6h_unshared.npz":
                # at the JAX package's picks: the one launch against the
                # groups' twin and K11's lane jobs in plain form
                picks = to_dev(frozen_words[pre + "picks"])
                e_k, w_k = cuda_kernels.bc6h_2region(px, picks, all_groups,
                                                     signed)
                e_g, w_g = bc6h._bc6h_2region_groups_plain(
                    px, picks, all_groups, signed)
                e_j, w_j = bc6h._bc6h_2region_jobs_fold_plain(
                    bc6h._bc6h_2region_jobs_plain(px, picks, all_groups,
                                                  signed))
                same(w_k, w_g, f"K11 words at the JAX picks {what}")
                same(e_k, e_g, f"K11 errors at the JAX picks {what}")
                same(w_j, w_g, f"K11 jobs (plain form) words {what}")
                same(e_j, e_g, f"K11 jobs (plain form) errors {what}")
                # the ranking against the JAX package's frozen picks: all
                # but the recorded summation-order near-tie of each sign
                moved = torch.nonzero((cuda_kernels.bc6h_shapes(px) != picks)
                                      .any(dim=0)).flatten().tolist()
                check(moved == [18 if signed else 462],
                      f"ranking picks moved against JAX {what}: {moved}")
                extra = {"jax_picks_equal": True, "jobs_plain_equal": True,
                         "ranking_picks_moved_against_jax": moved}
            emit({"phase": "K10_K11", "content": label, "signed": signed,
                  "blocks": px.shape[1], "picks_words_errors_equal": True,
                  "search_words_equal": True, **extra, **inf})

    rng = np.random.default_rng(2)
    eq = to_dev(rng.random((FACE * 2, FACE * 4, 4)).astype(np.float32)
                * 4.0)
    faces = pipelines.cube_faces(eq)
    blocks4 = torch.cat([image_to_blocks(faces[i])[0] for i in range(6)])
    nb4 = blocks4.shape[0]
    n_plain = UNSHARED_PLAIN_BLOCKS
    held = {}
    for signed in (False, True):
        px = bc6h.px_of_blocks(blocks4, signed)
        what = f"face {FACE} signed={signed}"
        t, k10, sb, k11, (fe, fw), inf = hold(px, signed, what, n_plain)
        # the ranking's picks on every block
        same(sb, bc6h._bc6h_shapes_plain(px), f"ranking picks all {what}")
        e_s, w_s = bc6h._search_unshared(px, signed)
        same(w_s[:, :n_plain], fw, f"unshared search words {what}")
        same(e_s[:n_plain], fe, f"unshared search errors {what}")
        held[signed] = (px, t, k10, sb, k11, e_s, w_s)
        emit({"phase": "K10_K11", "content": f"face{FACE}", "signed": signed,
              "blocks": nb4, "plain_blocks": n_plain,
              "ranking_plain_blocks": nb4,
              "picks_words_errors_equal": True, "search_words_equal": True,
              **inf})

    # 22. the BC6H_SHARED_FIT=False paths at face 512 -----------------------
    pipe = pipelines.hdr_cubemap_pipeline()
    px4, plain_ms, k10, sb4, k11, e_s, w_s = held[False]
    tiers = (("default", 0), ("mid", bc6h._BC6H_MID),
             ("maxq", bc6h._BC7_MAXQUALITY))
    saved = bc6h.BC6H_SHARED_FIT
    bc6h.BC6H_SHARED_FIT = False
    try:
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        packed = torch.cat(pipe(eq))
        dec = bc6h.decode_bc6h(packed, False)
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda_kernels.launch_counts().items()
                  if v}
        want = {"bc6h_1region": 1, "bc6h_shapes": 1, "bc6h_2region": 1,
                "bc6h_decode": 1}
        check(counts == want, f"config 4 unshared launch counts {counts}")
        check(tuple(dec.shape) == (nb4, 16, 4)
              and bool(torch.isfinite(dec).all()), "config 4 unshared output")
        check(torch.equal(packed, w_s.t().contiguous().view(torch.uint8)
                          .reshape(-1, 16)), "config 4 unshared words")
        psnr = {"default": log_psnr(dec.cpu().numpy(),
                                    blocks4.cpu().numpy())}
        cuda_kernels.reset_launch_counts()
        encs = {t: bc6h.encode_bc6h(blocks4, False, f) for t, f in tiers[1:]}
        torch.cuda.synchronize()
        counts_t = {k: v for k, v in cuda_kernels.launch_counts().items()
                    if v}
        check(counts_t == {"bc6h_1region": 2, "bc6h_shapes": 2,
                           "bc6h_2region": 2,
                           "bc6h_unit_buckets": 2, "bc6h_refine": 2,
                           "bc6h_refine_cross2": 2},
              f"unshared mid / maxq launch counts {counts_t}")
        for t, e in encs.items():
            psnr[t] = log_psnr(bc6h.decode_bc6h(e, False).cpu().numpy(),
                               blocks4.cpu().numpy())
        runs = {"path": lambda: pipe(eq)}
        for t, f in tiers:
            runs[f"encode_{t}"] = (
                lambda f=f: bc6h.encode_bc6h(blocks4, False, f))
        runs["bc6h_1region"] = lambda: cuda_kernels.bc6h_1region(px4, False)
        runs["bc6h_shapes"] = lambda: cuda_kernels.bc6h_shapes(px4)
        runs["bc6h_2region"] = lambda: cuda_kernels.bc6h_2region(
            px4, sb4, all_groups, False)
        # each group's launch alone, for the record
        for g in all_groups:
            runs[f"bc6h_2region_group{g}"] = (
                lambda g=g: cuda_kernels.bc6h_2region(px4, sb4, (g,), False))
        runs["fold"] = lambda: fold([k10, k11])
        ms = {}
        for name, fn in runs.items():
            fn()
            ms[name] = float(np.median(event_ms(fn, 7)))
    finally:
        bc6h.BC6H_SHARED_FIT = saved
    # the shared-fit path and encodes in the same phase
    shared_ms = {"path": float(np.median(event_ms(lambda: pipe(eq), 7)))}
    for t, f in tiers:
        shared_ms[f"encode_{t}"] = float(np.median(event_ms(
            lambda f=f: bc6h.encode_bc6h(blocks4, False, f), 7)))
    shared_ms["bc6h_encode"] = float(np.median(event_ms(
        lambda: cuda_kernels.bc6h_encode(px4, False), 7)))
    psnr_shared = log_psnr(bc6h.decode_bc6h(bc6h.encode_bc6h(
        blocks4, False), False).cpu().numpy(), blocks4.cpu().numpy())
    texels = 6 * FACE * FACE
    k_ms = {"bc6h_1region": ms["bc6h_1region"],
            "bc6h_shapes": ms["bc6h_shapes"],
            "bc6h_2region": ms["bc6h_2region"]}
    emit({"phase": "config4_unshared", "card": smi, "face": FACE,
          "blocks": nb4, "launches": counts, "tier_launches": counts_t,
          "log_psnr": psnr, "log_psnr_shared": psnr_shared, "ms": ms,
          "kernel_ms": k_ms,
          "bc6h_2region_groups_alone_ms": sum(
              ms[f"bc6h_2region_group{g}"] for g in all_groups),
          "path_mtexels_per_s": texels / (ms["path"] * 1e-3) / 1e6,
          "shared_ms": shared_ms,
          "shared_path_mtexels_per_s":
              texels / (shared_ms["path"] * 1e-3) / 1e6,
          "plain_ms": plain_ms, "plain_blocks": n_plain,
          "search_modes": torch.bincount(bc6h._mode_rows(bc6h._words_i64(
              w_s)) + 1, minlength=15).tolist(),
          "words_equal_plain": True})

    # 23. BC6H gates with the flag off --------------------------------------
    # The frozen PSNRs are the JAX package's own flag-off encodes
    # (tests/golden/bc6h_unshared.npz), decoded here by K4: the corpus
    # floors were set for the shipped (shared-fit) search, and the JAX
    # package's flag-off words fall below two of them (hdr, hdr_sun).
    frozen, n_differ = {}, {}
    bc6h.BC6H_SHARED_FIT = False
    try:
        for c in HDR_CORPUS:
            signed = c == "hdr_signed"
            blocks = image_to_blocks(to_dev(corpus[c]))[0]
            words = to_dev(frozen_words["corpus_" + c])
            frozen[c] = content_psnr(bc6h.decode_bc6h(words, signed).cpu()
                                     .numpy(), blocks.cpu().numpy(), signed)
            n_differ[c] = int((bc6h.encode_bc6h(blocks, signed) != words)
                              .any(dim=1).sum())
        gates, ref_gate, ref_psnr = bc6h_gates(torch, to_dev, corpus,
                                               " (unshared)", frozen)
    finally:
        bc6h.BC6H_SHARED_FIT = saved
    emit({"phase": "bc6h_gates_unshared", "psnr": gates,
          "floors": BC6H_FLOORS, "jax_unshared_psnr": frozen,
          "blocks_differing_from_jax": n_differ,
          "ref_parity_psnr": ref_gate, "ref_psnr": ref_psnr})

    launches = {k: counts[k] for k in k_ms}
    ops = {"bc6h_1region": BC6H_1REGION_OPS * float(nb4),
           "bc6h_shapes": BC6H_SHAPES_OPS * float(nb4),
           "bc6h_2region": sum(BC6H_2REGION_OPS) * float(nb4)}
    return {"launches": launches, "k_ms": k_ms, "plain_ms": plain_ms,
            "max_err": max_err, "nb": {k: nb4 for k in ops},
            "plain_nb": {k: n_plain for k in ops}, "ops": ops}


def bc7_single_modes_phase(torch, to_dev, event_ms, smi, img_opaque,
                           img_alpha) -> dict:
    """Phase 24, K8 at 2048^2. Returns its launches (the opaque image's
    run at weight 1.0), time, plain time, error against the twin, block
    count and operations."""
    from directxtex_tpu_torch.bc import bc67, cuda_kernels
    from directxtex_tpu_torch.bc.common import image_to_blocks

    def same(a, b, what):
        check(a.shape == b.shape and torch.equal(a, b),
              f"{what} differs from plain")

    runs, plain_ms, ms = {}, {}, {}
    launches = None
    max_err = 0.0
    for name, img in (("opaque", img_opaque), ("alpha", img_alpha)):
        px = bc67._quantize_ldr(image_to_blocks(img)[0]).reshape(64, -1) \
            .contiguous()
        for aw in ALPHA_WEIGHTS:
            torch.cuda.synchronize()
            cuda_kernels.reset_launch_counts()
            out = bc67.bc7_single_modes(px, aw)
            torch.cuda.synchronize()
            counts = {k: v for k, v in cuda_kernels.launch_counts().items()
                      if v}
            check(counts == {"bc7_single_modes": 1},
                  f"K8 {name} aw={aw} launches {counts}")
            if launches is None:
                launches = counts["bc7_single_modes"]
            plain = {}
            t = event_ms(lambda: plain.update(
                r=bc67._single_modes_plain(px, aw)))[0]
            key = f"{name}_aw{aw:g}"
            plain_ms[key] = t
            # the team's jobs in plain form, folded
            team = bc67._single_modes_fold_plain(
                bc67._single_modes_jobs_plain(px, aw))
            sse = {}
            for m in (4, 5, 6):
                err, words = out[m]
                same(words, plain["r"][m][1], f"K8 mode {m} words {key}")
                same(err, plain["r"][m][0], f"K8 mode {m} errors {key}")
                same(words, team[m][1], f"K8 mode {m} words {key} (jobs)")
                same(err, team[m][0], f"K8 mode {m} errors {key} (jobs)")
                check(bool(torch.isfinite(err).all()), f"K8 {m} {key} inf")
                max_err = max(max_err, float(
                    (err - plain["r"][m][0]).abs().max()))
                d = (cuda_kernels.bc7_decode(words) - px).to(torch.float64)
                blk = (d * d).sum(dim=0)
                if aw == 1.0:
                    check(torch.equal(blk, err.to(torch.float64)),
                          f"K8 mode {m} {key}: error != decoded SSE")
                sse[m] = float(blk.sum())
            fn = (lambda px=px, aw=aw: cuda_kernels.bc7_single_modes(px, aw))
            fn()
            ms[key] = float(np.median(event_ms(fn, 7)))
            best = torch.stack([out[m][0] for m in (4, 5, 6)]).argmin(dim=0)
            runs[key] = {"decoded_sse": sse, "best_mode_blocks": {
                m: int((best == k).sum()) for k, m in enumerate((4, 5, 6))}}
    nb = px.shape[1]
    emit({"phase": "K8_2k", "card": smi, "blocks": nb, "ms": ms,
          "plain_ms": plain_ms, "runs": runs, "words_errors_equal": True,
          "jobs_plain_equal": True})
    return {"launches": {"bc7_single_modes": launches},
            "k_ms": {"bc7_single_modes": ms["opaque_aw1"]},
            "plain_ms": {"bc7_single_modes": plain_ms["opaque_aw1"]},
            "max_err": {"bc7_single_modes": max_err},
            "nb": {"bc7_single_modes": nb},
            "ops": {"bc7_single_modes": BC7_SINGLE_MODES_OPS * float(nb)}}


def config1_image(size: int) -> np.ndarray:
    """benchmarks/run_all.py:61-69's config 1 content."""
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, size, dtype=np.float32)
    gx, gy = np.meshgrid(x, x)
    return np.clip(np.stack([gx, gy, gx * gy, np.ones_like(gx)], -1)
                   + rng.normal(0, .02, (size, size, 4)), 0, 1
                   ).astype(np.float32)


def psnr_of(dec, src, ch: int = 4) -> float:
    """PSNR over the first ch channels, in f64."""
    d = dec[..., :ch].double() - src[..., :ch].double()
    return float(10 * np.log10(1.0 / max(float((d * d).mean()), 1e-30)))


def bc12345_phases(torch, to_dev, event_ms, smi, main_encode_ms) -> None:
    """Phases 25-28: the BC1-BC5 golden checks on the card, and BASELINE
    configs 1, 2 and 5 at benchmarks/run_all.py's sizes, each driven with
    the launch counts set to 0 just before it and read just after, its
    words held against the CPU port's, and timed (CUDA events, median of
    7 after a warm-up, with the spread)."""
    from directxtex_tpu_torch.bc import bc45, bc67, bc123, cuda_kernels
    from directxtex_tpu_torch.bc.common import image_to_blocks
    from directxtex_tpu_torch.models import pipelines
    from directxtex_tpu_torch.ops.colorspace import apply_srgb_to_linear

    def timed(fn) -> dict:
        fn()
        t = event_ms(fn, 7)
        return {"median": float(np.median(t)), "min": float(min(t)),
                "max": float(max(t))}

    def counts_of(fn):
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in cuda_kernels.launch_counts().items()
                     if v}

    def cpu(t):
        return t.detach().to("cpu")

    def device_of(calls: dict) -> dict:
        """Each call's CUDA kernels and their summed device time (one
        torch.profiler record a call): the device's busy share of the
        call's event time."""
        prof = profile_calls(torch, calls)
        return {k: {"cuda_kernels": len(v),
                    "device_ms": sum(t for _, t in v) * 1e-3}
                for k, v in prof.items()}

    # 25. golden checks: decode vectors, corpus floors, reference parity --
    vec = np.load(os.path.join(GOLDEN, "decode_vectors.npz"))
    for codec in ("bc1", "bc2", "bc3"):
        got = getattr(bc123, f"decode_{codec}")(to_dev(vec[codec + "_blocks"]))
        check(np.array_equal(got.cpu().numpy(), vec[codec + "_rgba"]),
              f"{codec} golden decode")
    b4, b5 = to_dev(vec["bc4_blocks"]), to_dev(vec["bc5_blocks"])
    for got, key in ((bc45.decode_bc4u(b4)[..., 0], "bc4u_r"),
                     (bc45.decode_bc4s(b4)[..., 0], "bc4s_r"),
                     (bc45.decode_bc5u(b5)[..., 0], "bc5u_r"),
                     (bc45.decode_bc5u(b5)[..., 1], "bc5u_g"),
                     (bc45.decode_bc5s(b5)[..., 0], "bc5s_r"),
                     (bc45.decode_bc5s(b5)[..., 1], "bc5s_g")):
        check(np.array_equal(got.cpu().numpy(), vec[key]),
              f"{key} golden decode")
    corpus = np.load(os.path.join(GOLDEN, "corpus.npz"))
    ref = np.load(os.path.join(GOLDEN, "ref_encodes.npz"))
    codecs = {"bc1": (lambda b: bc123.encode_bc1(b, 0.5, 0),
                      bc123.decode_bc1, 3),
              "bc2": (lambda b: bc123.encode_bc2(b, 0), bc123.decode_bc2, 4),
              "bc3": (lambda b: bc123.encode_bc3(b, 0), bc123.decode_bc3, 4),
              "bc4": (bc45.encode_bc4u, bc45.decode_bc4u, 1),
              "bc5": (bc45.encode_bc5u, bc45.decode_bc5u, 2)}
    gates = {}
    for name, floor in BC12345_FLOORS.items():
        codec, content = name.split("_", 1)
        enc, dec, ch = codecs[codec]
        blocks = image_to_blocks(to_dev(corpus[content]))[0]
        words = enc(blocks)
        same_cpu = torch.equal(cpu(words), enc(cpu(blocks)))
        check(same_cpu, f"{name}: the card's words differ from the CPU's")
        # tests/test_golden.py's PSNR: a float32 mean in numpy
        d = dec(words).cpu().numpy()[..., :ch] - blocks.cpu().numpy()[..., :ch]
        p = float(10 * np.log10(1.0 / max(float(np.mean(d ** 2)), 1e-30)))
        check(p >= floor and p >= float(corpus[f"psnr_{name}"]) - 0.05,
              f"{name}: {p} dB below its floor")
        want = None
        if name in BC12345_REF_MARGINS:
            want = float(ref[f"{name}_psnr"]) + BC12345_REF_MARGINS[name]
            check(p >= want, f"{name}: {p} dB below the reference's")
        gates[name] = {"psnr": p, "floor": floor, "reference_floor": want}
    emit({"phase": "bc12345_gates", "golden_decode_bit_exact": True,
          "corpus_words_equal_cpu": True, "gates": gates})

    # 26. config 1: 1024^2 -> full box mip chain -> BC1 ------------------
    img1 = config1_image(CONFIG1_SIZE)
    img1_d = to_dev(img1)
    run1 = pipelines.mipped_compress_pipeline("bc1", srgb=False)
    levels, counts = counts_of(lambda: run1(img1_d))
    check(counts == {}, f"config 1 launched hand kernels {counts}")
    words1 = torch.cat(levels)
    n_levels = CONFIG1_SIZE.bit_length()      # 1024^2 ... 1^2: 11
    want_nb = sum(((max(1, CONFIG1_SIZE >> k) + 3) // 4) ** 2
                  for k in range(n_levels))   # 87,383 at 1024^2
    check(words1.shape[0] == want_nb and len(levels) == n_levels,
          f"config 1: {words1.shape[0]} blocks in {len(levels)} levels")
    cpu1 = pipelines.mipped_compress_pipeline("bc1", srgb=False,
                                              device="cpu")(img1)
    n1 = int((cpu(words1) != torch.cat(cpu1)).any(dim=1).sum())
    check(n1 == 0, f"config 1: {n1} blocks differ from the CPU port")
    blocks1, _ = pipelines._mip_chain_blocks(img1_d, 0, False)
    ms1 = {"path": timed(lambda: run1(img1_d)),
           "mip_glue": timed(lambda: pipelines._mip_chain_blocks(
               img1_d, 0, False)),
           "bc1_encode": timed(lambda: bc123.encode_bc1(blocks1, 0.5, 0))}
    dev1 = device_of({"path": lambda: run1(img1_d),
                      "bc1_encode": lambda: bc123.encode_bc1(blocks1, 0.5,
                                                             0)})
    top = image_to_blocks(img1_d)[0]
    psnr1 = psnr_of(bc123.decode_bc1(bc123.encode_bc1(top, 0.5, 0)), top)
    # srgb=True once: sRGB -> linear, the chain in linear light
    levels_s = pipelines.mipped_compress_pipeline("bc1", srgb=True)(img1_d)
    blocks_s, _ = pipelines._mip_chain_blocks(img1_d, 0, True)
    cpu_blocks_s, _ = pipelines._mip_chain_blocks(torch.from_numpy(img1),
                                                  0, True)
    same_in = (cpu(blocks_s) == cpu_blocks_s).reshape(
        blocks_s.shape[0], -1).all(dim=1)
    cpu_s = torch.cat(pipelines.mipped_compress_pipeline(
        "bc1", srgb=True, device="cpu")(img1))
    n_s = int(((cpu(torch.cat(levels_s)) != cpu_s).any(dim=1)
               & same_in).sum())
    check(n_s == 0, f"config 1 srgb: {n_s} blocks differ from the CPU port")
    texels1 = CONFIG1_SIZE * CONFIG1_SIZE * 4 // 3
    emit({"phase": "config1", "card": smi, "size": CONFIG1_SIZE,
          "levels": len(levels), "blocks": int(words1.shape[0]),
          "launches": counts, "words_equal_cpu": True, "ms": ms1,
          "device": dev1,
          "mtexels_per_s": texels1 / (ms1["path"]["median"] * 1e-3) / 1e6,
          "top_level_psnr": psnr1,
          "srgb": {"inputs_differ_from_cpu": int((~same_in).sum()),
                   "words_differ_from_cpu_on_equal_inputs": n_s}})

    # 27. config 2: sRGB -> linear, premultiply, BC3 / BC4U / BC5U -------
    n_img, size = CONFIG2_SHAPE
    batch = np.random.default_rng(1).random(
        (n_img, size, size, 4)).astype(np.float32)
    batch_d = to_dev(batch)

    def glue(b):
        lin = apply_srgb_to_linear(b)
        return torch.cat([lin[..., :3] * lin[..., 3:4], lin[..., 3:4]], -1)

    def blocks_of(pm):
        return torch.cat([image_to_blocks(im)[0] for im in pm])

    def step2(b):
        blocks = blocks_of(glue(b))
        return (bc123.encode_bc3(blocks, 0), bc45.encode_bc4u(blocks),
                bc45.encode_bc5u(blocks))

    out2, counts2 = counts_of(lambda: step2(batch_d))
    check(counts2 == {}, f"config 2 launched hand kernels {counts2}")
    lin_cpu = apply_srgb_to_linear(torch.from_numpy(batch))
    lin_differ = int((cpu(apply_srgb_to_linear(batch_d)) != lin_cpu).sum())
    nb_img = (size // 4) ** 2
    sel = list(CONFIG2_CPU_IMAGES)
    out_cpu = step2(torch.from_numpy(batch[sel]))
    for name, got, want in zip(("bc3", "bc4", "bc5"), out2, out_cpu):
        got = cpu(got).reshape(n_img, nb_img, -1)[sel].reshape(want.shape)
        n = int((got != want).any(dim=1).sum())
        check(n == 0, f"config 2 {name}: {n} blocks differ from the CPU port")
    pm_d = glue(batch_d)
    blocks2 = blocks_of(pm_d)
    ms2 = {"path": timed(lambda: step2(batch_d)),
           "srgb_premultiply": timed(lambda: glue(batch_d)),
           "image_to_blocks": timed(lambda: blocks_of(pm_d)),
           "bc3": timed(lambda: bc123.encode_bc3(blocks2, 0)),
           "bc4u": timed(lambda: bc45.encode_bc4u(blocks2)),
           "bc5u": timed(lambda: bc45.encode_bc5u(blocks2))}
    dev2 = device_of({"bc3": lambda: bc123.encode_bc3(blocks2, 0),
                      "bc4u": lambda: bc45.encode_bc4u(blocks2),
                      "bc5u": lambda: bc45.encode_bc5u(blocks2)})
    texels2 = n_img * size * size * 3
    emit({"phase": "config2", "card": smi, "images": n_img, "size": size,
          "blocks_per_codec": int(blocks2.shape[0]), "launches": counts2,
          "cpu_images": sel, "words_equal_cpu": True,
          "linearised_values_differ_from_cpu": lin_differ, "ms": ms2,
          "device": dev2,
          "mtexels_per_s": texels2 / (ms2["path"]["median"] * 1e-3) / 1e6})

    # 28. config 5: height maps -> normal maps -> BC7 (K2, K3) ------------
    n_img, size = CONFIG5_SHAPE
    lib = np.random.default_rng(3).random(
        (n_img, size, size, 4)).astype(np.float32)
    lib_d = to_dev(lib)
    run5 = pipelines.asset_pipeline()
    words5, counts5 = counts_of(lambda: run5(lib_d))
    check(counts5 == {"bc7_encode": 1, "bc7_mode_buckets": 1,
                      "bc7_refine": 4}, f"config 5 launches {counts5}")
    nm_d = pipelines._normal_map(lib_d)
    nm_cpu = pipelines._normal_map(torch.from_numpy(lib))
    check(torch.equal(cpu(nm_d), nm_cpu),
          "config 5: the card's normal maps differ from the CPU port's")
    blocks5 = torch.cat([image_to_blocks(im)[0] for im in nm_d])
    px5 = bc67._quantize_ldr(blocks5).reshape(64, -1).contiguous()
    plain = {}
    plain_ms = event_ms(lambda: plain.update(words=bc67._bc7_refine_plain(
        px5, bc67._bc7_search_plain(px5)[1], bc67.REFINE_MODES)))[0]
    plain_words = plain["words"].t().contiguous().view(torch.uint8)
    check(torch.equal(words5.reshape(-1, 16), plain_words.reshape(-1, 16)),
          "config 5: the kernels' words differ from the plain path's")
    _, w_search = cuda_kernels.bc7_encode(px5)
    ms5 = {"path": timed(lambda: run5(lib_d)),
           "normal_map": timed(lambda: pipelines._normal_map(lib_d)),
           "image_to_blocks": timed(lambda: torch.cat(
               [image_to_blocks(im)[0] for im in nm_d])),
           "encode_bc7": timed(lambda: bc67.encode_bc7(blocks5)),
           "bc7_encode": timed(lambda: cuda_kernels.bc7_encode(px5)),
           "bc7_refine": timed(lambda: cuda_kernels.bc7_refine(
               px5, w_search, bc67.REFINE_MODES))}
    dev5 = device_of({"path": lambda: run5(lib_d),
                      "normal_map": lambda: pipelines._normal_map(lib_d)})
    dec5 = bc67.decode_bc7(words5.reshape(-1, 16))
    modes = bc67._mode_of(bc67._words_i64(
        words5.reshape(-1, 16).view(torch.int32).t().contiguous()))
    emit({"phase": "config5", "card": smi, "images": n_img, "size": size,
          "blocks": int(blocks5.shape[0]), "launches": counts5,
          "words_equal_plain_path": True, "normal_map_equal_cpu": True,
          "plain_path_ms": plain_ms, "ms": ms5, "device": dev5,
          "main_path_encode_ms": main_encode_ms,
          "recorded_main_path_encode_ms": MAIN_PATH_ENCODE_MS,
          "mtexels_per_s": n_img * size * size
          / (ms5["path"]["median"] * 1e-3) / 1e6,
          "psnr": psnr_of(dec5, blocks5),
          "winner_modes": {m: int((modes == m).sum()) for m in range(8)
                           if int((modes == m).sum())}})


if __name__ == "__main__":
    main()
