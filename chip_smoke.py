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
  BC7 runs K2's default team and K3's MOMENT launches;
- the format core and the compress driver (formats, texture, ops.convert,
  ops.compress, io.dds): a DDS file -> load -> compress -> DDS -> reload
  -> decompress on the card, BC7 over a 2048^2 mip chain (K2, K3, with
  alpha mode 7's launches, K1) and BC6H over a 512^2 HDR image (K5, K6,
  K4), and convert / pack / unpack as plain torch ops on the card, held
  against the CPU port;
- the image ops (ops.fliprotate, resize, mipmaps, pmalpha, misc,
  normalmaps, rotatecolor, and the diffusion dither of ops.dither, which
  runs on the host in directxtex_tpu_torch/native's C++): torch ops on
  the card (resize and the filtered mips as cuBLAS products in f32),
  held against the CPU port, and driven through texconv's chain into the
  BC7 and BC6H kernels (K2 with mode 7, K3, K1; K5, K4);
- the container loaders and texconv (io.tga, hdr, ppm, exr with
  exr_piz / exr_b44, tools.texconv): a folder of TGA, HDR, EXR and PFM
  files parsed on the host (the RLE, scanline and Huffman codecs in
  directxtex_tpu_torch/native's C++), each file's pixels copied to the
  card once and decoded there, then texconv over the folder, one
  compress_many per target format into K2 with mode 7 and K3, and K5;
  the outputs decoded by K1 and K4;
- the other tools and parallel/ (tools.texassemble, ddsview, texdiag;
  parallel.sharding, spatial, library): a cube assembled from the
  folder's TGAs, its layouts and their inverses, texconv of it into K2 /
  K3 and ddsview of that through K1; texdiag over texconv's outputs (K1,
  K4); the texture library through one encoder call (K2, K3; K5) and a
  mesh that repeats the one card four times (halos, the box mip, the
  MSE's partial sums, a sharded BC7 encode).

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
 24b. the module switches the port refuses, on the card: the BC7
     default tier with BC7_SHARED2SUB and / or BC7_SHARED45 off (opaque,
     with alpha, with USE_3SUBSETS) and BC7_SHARED_KEEPBETTER /
     BC6H_SHARED_KEEPBETTER on each raise NotImplementedError on bench512
     and launch no kernel;
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
 29. the format core and the compress driver (phase ldr_dds): the 2048^2
     bench image's full 12-level chain (numpy 2 x 2 box averages) saved
     as an R8G8B8A8_UNORM DDS on the card (its bytes equal the CPU
     port's), loaded onto the card, compress(BC7_UNORM) (one encode_bc7
     over the chain's 349,527 blocks: K2's default team, K3 MOMENT),
     saved and reloaded (byte-exact), decompress (K1); level 0's words
     equal encode_bc7 of the same image, every level's equal its own
     encode_bc7, decompress equals decode_bc7 bit for bit; again with
     alpha (mode 7's list pass and launch); launch counts, the host
     syncs of each step, CUDA-event times of the DDS load, compress, save,
     reload and decompress, and the kernels' device time from a profiler
     record;
 30. the 512^2 HDR gate (phase hdr_dds; tests/golden/
     generate_compress_dds.py builds it from corpus.npz's hdr_china and
     hdr_flower): saved as R16G16B16A16_FLOAT, loaded, compress
     (BC6H_UF16: K5; BC6H_MID: K5 + K6), DDS round trip, decompress (K4,
     bit-equal to decode_bc6h), held to the JAX package's frozen
     aggregate F16-int error (at most 1.005x), log-PSNR beside it;
 31. convert on the card (phase convert_pack): the 2048^2 chain as
     R8G8B8A8_UNORM_SRGB -> R16G16B16A16_FLOAT -> R10G10B10A2_UNORM ->
     B5G6R5_UNORM with the ordered dither, each step against the CPU
     port on the same input (bit for bit; the sRGB step lists its
     differences), and pack / unpack of all 75 packable formats on a
     64^2 patch with NaN, +-inf and out-of-range values, bit-equal to the
     CPU port;
 32. the image ops on the card (phase image_ops): flip_rotate (every
     rotation and flip), premultiply_alpha (IGNORE_SRGB, REVERSE, SRGB),
     resize (every filter with SEPARATE_ALPHA, WRAP with SRGB_IN, MIRROR;
     down and up), generate_mipmaps (every filter, WRAP, MIRROR; box and
     point on power-of-two sides), the alpha coverage and its scaling,
     compute_normal_map (every channel, flag and target of
     tests/golden/generate_image_ops.py), rotate_color (all eight, two
     paper whites), the diffusion dither and convert with it,
     compute_mse / compute_psnr, copy_rectangle, evaluate_image and
     transform_image, on RGBA8 and sRGB textures of 2 x 24 x 40,
     2 x 16 x 32, 1x1, 1x2, 3x5 and 6x10, and generate_mipmaps_3d on
     that file's volumes, each against the CPU port on the same input:
     bit for bit, or within 4 ulp / 1e-6 for the products (resize,
     filtered mips, rotate_color) and sRGB's f64 pow, the values that
     differ counted; TF32 asserted off;
 33. texconv's chain (phase texconv_chain) on the 2048^2 bench image with
     alpha as R8G8B8A8_UNORM_SRGB: flip_rotate(ROTATE90 |
     FLIP_HORIZONTAL) -> resize to 1536^2 (CUBIC | SEPARATE_ALPHA) ->
     generate_mipmaps(LINEAR), 11 levels -> the alpha coverage at 0.5 ->
     premultiply_alpha -> compress(BC7_UNORM_SRGB) (K2, mode 7's list
     pass and launch, K3) -> decompress (K1) -> compute_psnr per level;
     its launch counts, each step's CUDA-event time, CUDA kernels, device
     time, busy share and host syncs; a 16,384-block sample of level 0's
     words against the plain twins on the card; the same chain at 256^2,
     each step against the CPU port on the same input, the words equal;
 34. a normal map (phase normal_map_2k): the bench image's luminance
     through compute_normal_map(LUMINANCE | MIRROR_U | MIRROR_V |
     COMPUTE_OCCLUSION, 2.0) -> compress(BC7_UNORM), 262,144 blocks (K2
     with mode 7, K3), timed as phase 33, the map equal to the CPU port's
     at 256^2;
 35. HDR and the diffusion dither (phase hdr_and_dither): phase 30's
     512^2 image through rotate_color(709to2020) -> generate_mipmaps(
     TRIANGLE) -> compress(BC6H_UF16) (K5) -> decompress (K4); through
     rotate_color(709toHDR10) -> convert(R10G10B10A2_UNORM,
     DITHER_DIFFUSION); phase 33's level 0 through convert(B5G6R5_UNORM)
     with the diffusion and the ordered dither; the host pass and its two
     copies timed apart; equal to the CPU port and, on a 64^2 crop, to
     the numpy twin;
 36. 3D mips (phase mips_3d): a 128^3 R16G16B16A16_FLOAT volume through
     generate_mipmaps_3d, LINEAR and BOX, timed, no hand kernel launched,
     a 16^3 crop against the CPU port;
 37. the container loaders (phase containers): a folder written by the
     port's savers, four 2048^2 sRGB RGBA8 TGAs of the bench image with
     and without alpha (two RLE, one raw 32 bpp, one 24 bpp), a
     2048 x 1024 RLE .hdr environment map of corpus.npz's HDR contents
     (exponent bytes about 100-150), one 1024^2 RGBA half EXR in each of
     ZIP, PIZ, B44 and RLE, and a 1024^2 PFM; each file loaded on the
     card, its load timed as host parse, H2D copy and device decode
     (CUDA events, medians of 7; an EXR's parse and load of 3) with its
     host syncs, the texture bit for
     bit the port's CPU load of the same bytes, each native codec (TGA
     RLE, HDR scanlines and RLE, PIZ Huffman; EXR RLE's encoder) against
     its numpy twin on a crop, the texture saved again with bytes equal
     to the CPU port's save;
 38. texconv on the card (phase texconv_batch): tools.texconv.main over
     that folder, -f BC7_UNORM_SRGB -m 0 over the four TGAs (one
     compress_many of 4 x 349,527 blocks: K2 with mode 7's list pass and
     launch, K3) and -f BC6H_UF16 -m 0 over the HDR, EXR and PFM files
     (one compress_many: K5), each run rc 0 with no FAILED line and one
     compress_many per (format, flags) group; every output DDS reloaded
     and decompressed on the card (K1, K4) with its PSNR per level
     (log-PSNR for HDR), level 0 of one TGA equal to compress() of its
     loaded texture, the batches' seconds and host syncs; a -timing run
     (its stage rows, each stage's synchronize counted), a -profile run
     (a non-empty Chrome trace with kernels), and -f R16G16B16A16_FLOAT
     -ft exr over the HDR and PFM files (the reloaded EXR is the source
     rounded to half); both phases' wall time;
 39. texassemble and ddsview (phase assemble_view): six 2048^2 faces from
     phase 37's TGAs -> cube (a DDS) -> h-cross -> cube-from-hc and
     v-cross-fnz -> cube-from-vc-fnz (the faces back bit for bit),
     cube-from-mips over the faces' 12-level chains (72 files), merge
     with a swizzle, texconv of the cube to BC7_UNORM with mips (K2, mode
     7, K3; level 0 equal to compress()), ddsview -m 1 of that cube (K1,
     a 4096 x 3072 PNG); every file equal to the CPU port's;
 40. texdiag (phase texdiag) over phase 38's BC7_UNORM_SRGB and BC6H_UF16
     files: info, analyzebc, dumpbc -targetx/-targety (lines equal to the
     CPU port's on every file), analyze, compare (source against the
     DDS), diff -c and dumpdds (lines and files equal, the reductions
     within a stated bound, on one BC7 and one BC6H file; the CPU port
     decodes every block on the host); each command's time, host syncs
     and K1 / K4 launches;
 41. parallel/ (phase parallel): compress_library over the four TGAs into
     BC7_UNORM without and with mips (one encoder call; words equal to
     encode_bc7 of each image) and over the PFM and the HDR into
     BC6H_UF16 (K5); on a mesh of ("cuda:0",) * 4, sharded_normal_map of
     an 8192^2 height field bit-equal to one shard and to the CPU port on
     a crop, halo_exchange_rows at halo 1 and 3 equal to the padded
     image, sharded_box_mip bit-equal to one shard, sharded_mse against
     compute_mse, sharded_compress_fn(encode_bc7) equal to the unsharded
     encode;
 42. the kernels line: every kernel's launches, error against its twin,
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
FILE_REPS = 3  # timed runs of a tool command that moves 100-200 MB of files
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


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line on stdout; the seconds since start and the phase's
    name on stderr, where each phase's share of the run can be read."""
    print(json.dumps(obj), flush=True)
    print(f"[{time.perf_counter() - _T0:.1f} s] "
          f"{obj.get('phase', next(iter(obj), ''))}", file=sys.stderr,
          flush=True)


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


def profile_calls(torch, calls: dict, tries: int = 6,
                  required: bool = True) -> dict:
    """{label: [(kernel name, device µs)]}: the CUDA kernels each call of
    `calls` ({label: fn}) runs, each call in a torch.profiler record of its
    own (CUPTI sees the kernels launched through ctypes too), so that an
    offset between the host's and the device's clocks cannot put a kernel
    under a neighbouring call. A record that holds no device activity
    (CUPTI delivered none; six records in a row have come back empty on
    a call that ran kernels) is taken again after a pause, up to `tries`
    records; then the label maps to None ("not measured") where the
    record is not `required`, else this raises."""
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
            time.sleep(0.5)
        else:
            if required:
                raise RuntimeError(f"no device activity for {label} in "
                                   f"{tries} profiler records")
            out[label] = None
    return out


def kernels_and_ms(events) -> tuple:
    """(CUDA kernels, summed device ms) of a profile_calls record, or
    (None, None) where CUPTI delivered none (not measured)."""
    if events is None:
        return None, None
    return len(events), sum(t for _, t in events) * 1e-3


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

    refused_settings_phase(torch, to_dev, b512)
    bc12345_phases(torch, to_dev, event_ms, smi, enc_ms)
    format_core_phases(torch, dev, to_dev, event_ms, smi)
    image_ops_phases(torch, dev, to_dev, event_ms, smi)
    folder = container_phases(torch, dev, event_ms, smi)
    tool_phases(torch, dev, event_ms, smi, folder)
    parallel_phase(torch, dev, event_ms, smi, folder)

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


def refused_settings_phase(torch, to_dev, b512) -> None:
    """Phase 24b: each module switch setting the port refuses raises
    NotImplementedError on a CUDA tensor and launches no kernel."""
    from directxtex_tpu_torch.bc import bc6h, bc67, cuda_kernels
    from directxtex_tpu_torch.bc.common import image_to_blocks

    blocks = image_to_blocks(to_dev(b512["img"]))[0]
    with_alpha = blocks.clone()
    with_alpha[::2, :, 3] = 0.5
    settings = [(bc67, {"BC7_SHARED2SUB": s2, "BC7_SHARED45": s45}, flags,
                 label, b)
                for s2, s45 in ((False, True), (True, False), (False, False))
                for flags, label, b in ((0, "opaque", blocks),
                                        (0, "alpha", with_alpha),
                                        (0x80000, "alpha", with_alpha))]
    settings += [(bc67, {"BC7_SHARED_KEEPBETTER": True}, 0, "opaque",
                  blocks),
                 (bc6h, {"BC6H_SHARED_KEEPBETTER": True}, 0, "opaque",
                  blocks)]
    refused = []
    for mod, values, flags, label, b in settings:
        saved = {k: getattr(mod, k) for k in values}
        before = cuda_kernels.launch_counts()
        for k, v in values.items():
            setattr(mod, k, v)
        try:
            if mod is bc6h:
                bc6h.encode_bc6h(b, False)
            else:
                bc67.encode_bc7(b, flags)
            raised = False
        except NotImplementedError:
            raised = True
        finally:
            for k, v in saved.items():
                setattr(mod, k, v)
        torch.cuda.synchronize()
        what = f"{values} {label} flags={flags:#x}"
        check(raised, f"{what}: no NotImplementedError on the card")
        check(cuda_kernels.launch_counts() == before,
              f"{what}: launched a kernel before refusing")
        refused.append(what)
    emit({"phase": "refused_settings", "refused": refused})


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
        prof = profile_calls(torch, calls, required=False)
        return {k: dict(zip(("cuda_kernels", "device_ms"),
                            kernels_and_ms(v))) for k, v in prof.items()}

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


def box_chain(img: np.ndarray) -> list:
    """A full mip chain of a square power-of-two image by 2 x 2 box
    averages in numpy ([1, s, s, 4] f32 levels, s down to 1)."""
    levels = [img[None].astype(np.float32)]
    while levels[-1].shape[1] > 1:
        p = levels[-1][0]
        s = p.shape[0] // 2
        levels.append((p.reshape(s, 2, s, 2, 4).mean(axis=(1, 3))
                       .astype(np.float32))[None])
    return levels


def golden_module(name: str):
    """tests/golden/<name>.py, a generator whose module level imports numpy
    only: generate_compress_dds for the 512^2 HDR gate image,
    generate_image_ops for the image-op phases' seeded inputs and cases."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(GOLDEN, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Probe:
    """What the format-core and image-op phases read around a call: CUDA-
    event times (median, min, max of 7 after a warm-up), host-clock times,
    the hand kernels' launch counts, the host syncs (torch's sync debug
    mode), and the device time and busy share of a profiler record."""

    def __init__(self, torch, event_ms):
        self.torch = torch
        self.event_ms = event_ms

    @staticmethod
    def spread(t) -> dict:
        return {"median": float(np.median(t)), "min": float(min(t)),
                "max": float(max(t))}

    def timed(self, fn, reps: int = 7) -> dict:
        fn()
        return self.spread(self.event_ms(fn, reps))

    def host_timed(self, fn, reps: int = 7) -> dict:
        """Host-clock ms of fn(), which touches no device (`reps` runs)."""
        fn()
        t = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            t.append((time.perf_counter() - t0) * 1e3)
        return self.spread(t)

    def counts_of(self, fn):
        """fn()'s result and the hand kernels it launched (counts set to 0
        just before it, read just after)."""
        from directxtex_tpu_torch.bc import cuda_kernels

        self.torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        out = fn()
        self.torch.cuda.synchronize()
        return out, {k: v for k, v in cuda_kernels.launch_counts().items()
                     if v}

    def host_syncs(self, fn) -> int:
        """The synchronizing calls fn() makes (torch's sync debug mode)."""
        import warnings

        self.torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            self.torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                self.torch.cuda.set_sync_debug_mode(0)
        # the mode's own one-time notice ("... does not yet detect all
        # synchronizing operations") is not a sync
        return sum("synchroniz" in str(w.message)
                   and "prototype" not in str(w.message) for w in caught)

    @staticmethod
    def cpu_tex(tex):
        return type(tex)(tex.metadata, [lvl.cpu() for lvl in tex.levels])

    @staticmethod
    def need(counts: dict, names, what: str) -> None:
        missing = [k for k in names if not counts.get(k)]
        check(not missing, f"{what}: {missing} never launched ({counts})")

    @staticmethod
    def share(prof_events, names, total_ms) -> dict:
        if prof_events is None:
            return {"device_ms": None, "device_all_ms": None,
                    "share_of_call": None}
        dev_ms = {n: sum(t for k, t in prof_events if n in k) * 1e-3
                  for n in names}
        all_ms = sum(t for _, t in prof_events) * 1e-3
        return {"device_ms": dev_ms, "device_all_ms": all_ms,
                "share_of_call": {n: v / total_ms for n, v in dev_ms.items()}}


def format_core_phases(torch, dev, to_dev, event_ms, smi,
                       size: int = SLICE_SIZE, hdr_size: int = 512) -> None:
    """Phases 29-31: the format core and the compress driver on the card,
    through the entry points a user calls. 29: the 2048^2 bench image's
    full 12-level chain as an R8G8B8A8_UNORM DDS -> load_from_dds_memory
    -> compress(BC7_UNORM) (one encode_bc7 over all 349,527 blocks: K2's
    default team and K3 MOMENT; with alpha also mode 7's list pass and
    launch) -> save_to_dds_memory -> reload -> decompress (K1); 30: the
    512^2 HDR gate image as an R16G16B16A16_FLOAT DDS -> compress
    (BC6H_UF16, K5; BC6H_MID, K5 + K6) -> decompress (K4), held to the
    JAX package's frozen aggregate F16-int error; 31: convert over the
    2048^2 chain (sRGB -> f16 -> R10G10B10A2 -> B5G6R5 with the ordered
    dither) and pack / unpack of every packable format on a 64^2 patch
    with NaN, +-inf and out-of-range values, each against the CPU port.
    Each path is driven with the launch counts set to 0 just before it
    and read just after; times are CUDA-event medians of 7 after a
    warm-up, with min and max."""
    from directxtex_tpu_torch.bc import bc6h, bc67
    from directxtex_tpu_torch.bc.common import blocks_to_image, image_to_blocks
    from directxtex_tpu_torch.formats import FMT, packing
    from directxtex_tpu_torch.io import dds
    from directxtex_tpu_torch.ops.compress import compress, decompress
    from directxtex_tpu_torch.ops.convert import convert
    from directxtex_tpu_torch.ops.flags import TEX_FILTER_FLAGS as TF
    from directxtex_tpu_torch.texture import (CompressedTexture, TexMetadata,
                                              Texture)

    pr = Probe(torch, event_ms)
    spread, timed, host_timed, counts_of, host_syncs, cpu_tex, need, share = (
        pr.spread, pr.timed, pr.host_timed, pr.counts_of, pr.host_syncs,
        pr.cpu_tex, pr.need, pr.share)

    # 29. LDR through DDS ---------------------------------------------------
    for alpha in (False, True):
        chain = box_chain(bench_image(size, alpha=alpha))
        n_levels = len(chain)
        meta = TexMetadata(width=size, height=size,
                           mip_levels=n_levels, format=FMT.R8G8B8A8_UNORM)
        src = Texture.from_levels(meta, chain, dev)
        raw = dds.save_to_dds_memory(src)
        check(raw == dds.save_to_dds_memory(cpu_tex(src)),
              "RGBA8 DDS bytes written on the card differ from the CPU's")
        tex = dds.load_from_dds_memory(raw, device=dev)
        check(tex.device == dev and tex.mip_levels == n_levels, "DDS load")
        ct, counts_c = counts_of(lambda: compress(tex, FMT.BC7_UNORM))
        want = ["bc7_encode", "bc7_mode_buckets"] + (
            ["bc7_alpha_list", "bc7_mode7", "bc7_refine_alpha"] if alpha
            else ["bc7_refine"])
        need(counts_c, want, f"compress alpha={alpha}")
        check(counts_c.get("bc7_encode") == 1,
              f"compress: {counts_c} (one encode_bc7 over every level)")
        nb = sum(int(lvl.numel()) // 16 for lvl in ct.levels)
        check(nb == sum(((max(1, size >> m) + 3) // 4) ** 2
                        for m in range(n_levels)), f"{nb} blocks")
        # level 0 equals the main path's own call on the same unpacked
        # image; every level equals a separate encode_bc7 of its blocks
        main = bc67.encode_bc7(image_to_blocks(tex.image(0))[0])
        check(torch.equal(ct.levels[0].reshape(-1, 16), main),
              "compress level 0 differs from encode_bc7 (main path)")
        for m in range(n_levels):
            one = bc67.encode_bc7(image_to_blocks(tex.image(m))[0])
            check(torch.equal(ct.levels[m].reshape(-1, 16), one),
                  f"compress level {m} differs from its own encode_bc7")
        bc_raw = dds.save_to_dds_memory(ct)
        back = dds.load_from_dds_memory(bc_raw, device=dev)
        check(isinstance(back, CompressedTexture) and all(
            torch.equal(a, b) for a, b in zip(back.levels, ct.levels))
            and dds.save_to_dds_memory(back) == bc_raw,
            "BC7 DDS round trip not byte-exact")
        dec, counts_d = counts_of(lambda: decompress(back))
        need(counts_d, ["bc7_decode"], "decompress")
        words = torch.cat([lvl.reshape(-1, 16) for lvl in back.levels])
        texels = bc67.decode_bc7(words)
        off = 0
        for m in range(n_levels):
            h = w = max(1, size >> m)
            k = ((h + 3) // 4) * ((w + 3) // 4)
            check(torch.equal(dec.levels[m][0],
                              blocks_to_image(texels[off:off + k], h, w)),
                  f"decompress level {m} differs from decode_bc7")
            off += k
        syncs = {"load": host_syncs(lambda: dds.load_from_dds_memory(
                     raw, device=dev)),
                 "compress": host_syncs(lambda: compress(tex,
                                                         FMT.BC7_UNORM)),
                 "save_bc7": host_syncs(lambda: dds.save_to_dds_memory(ct)),
                 "decompress": host_syncs(lambda: decompress(back)),
                 "save_rgba8": host_syncs(
                     lambda: dds.save_to_dds_memory(src))}
        ms = {"dds_load_chain": timed(
                  lambda: dds.load_from_dds_memory(raw, device=dev)),
              "compress": timed(lambda: compress(tex, FMT.BC7_UNORM)),
              "dds_save_bc7": timed(lambda: dds.save_to_dds_memory(ct)),
              "dds_reload_bc7": timed(
                  lambda: dds.load_from_dds_memory(bc_raw, device=dev)),
              "decompress": timed(lambda: decompress(back)),
              "dds_save_rgba8": timed(lambda: dds.save_to_dds_memory(src))}

        # the RGBA8 save in its parts, as save_to_dds_memory runs them: the
        # pack of every level on the card, the payload's one D2H copy, and
        # the host's bytes (the header and the payload joined in one copy)
        def pack_levels():
            return torch.cat([packing.pack(src.metadata.format,
                                           lvl[0].reshape(-1, 4))
                              for lvl in src.levels])
        payload = pack_levels()
        host_payload = payload.cpu()
        check(b"".join((dds.encode_dds_header(src.metadata),
                        host_payload.numpy())) == raw,
              "the RGBA8 save's parts do not make its bytes")
        save_parts = {
            "pack": timed(pack_levels), "d2h": timed(lambda: payload.cpu()),
            "host_bytes": host_timed(lambda: b"".join((
                dds.encode_dds_header(src.metadata),
                host_payload.numpy())))}
        prof = profile_calls(torch, {
            "compress": lambda: compress(tex, FMT.BC7_UNORM),
            "decompress": lambda: decompress(back),
            "dds_save_rgba8": lambda: dds.save_to_dds_memory(src)},
            required=False)
        save_kernels, save_ms = kernels_and_ms(prof["dds_save_rgba8"])
        emit({"phase": "ldr_dds", "card": smi, "size": size, "alpha": alpha,
              "levels": n_levels, "blocks": nb, "dds_bytes": len(raw),
              "bc7_dds_bytes": len(bc_raw),
              "launches": {"compress": counts_c, "decompress": counts_d},
              "rgba8_bytes_equal_cpu": True,
              "level0_equals_main_path": True,
              "levels_equal_per_level_encode": True,
              "dds_round_trip_byte_exact": True,
              "decompress_equals_decode_bc7": True, "ms": ms,
              "compress_kernels": share(prof["compress"],
                                        ("bc7_encode", "bc7_refine",
                                         "bc7_mode7", "bc7_mode_buckets",
                                         "bc7_alpha_list"),
                                        ms["compress"]["median"]),
              "decompress_kernels": share(prof["decompress"],
                                          ("bc7_decode",),
                                          ms["decompress"]["median"]),
              "dds_save_rgba8_parts": {
                  **save_parts,
                  "kernels": save_kernels, "device_ms": save_ms},
              "host_syncs": syncs})
        if not alpha:
            tex_ldr = tex

    # 30. HDR through DDS: the 512^2 BC6H gate ------------------------------
    gen = golden_module("generate_compress_dds")
    frozen = np.load(os.path.join(GOLDEN, "compress_dds.npz"))
    corpus = np.load(os.path.join(GOLDEN, "corpus.npz"))
    img = np.ascontiguousarray(gen.hdr512_image(corpus)[:hdr_size,
                                                        :hdr_size])
    src = Texture.from_array(img, FMT.R16G16B16A16_FLOAT, device=dev)
    raw = dds.save_to_dds_memory(src)
    check(raw == dds.save_to_dds_memory(cpu_tex(src)),
          "RGBA16F DDS bytes written on the card differ from the CPU's")
    tex = dds.load_from_dds_memory(raw, device=dev)
    check(torch.equal(tex.levels[0][0].cpu(), torch.from_numpy(img)),
          "the f16 DDS does not hold the gate image")
    blocks = image_to_blocks(tex.image(0))[0]
    px = bc6h._f16_to_int(blocks[..., :3].permute(1, 2, 0), False)

    def int_err(words_u8):
        dec = bc6h.decode_bc6h(words_u8, False)
        di = bc6h._f16_to_int(dec[..., :3].permute(1, 2, 0), False)
        return float(((di - px).to(torch.float64) ** 2).sum())

    hdr = {}
    for key, flags, want in (
            ("hdr512", 0, ["bc6h_encode"]),
            ("hdr512_mid", bc6h._BC6H_MID,
             ["bc6h_encode", "bc6h_unit_buckets", "bc6h_refine"])):
        ct, counts_c = counts_of(lambda: compress(tex, FMT.BC6H_UF16,
                                                  flags))
        need(counts_c, want, key)
        back = dds.load_from_dds_memory(dds.save_to_dds_memory(ct),
                                        device=dev)
        check(torch.equal(back.levels[0], ct.levels[0]),
              f"{key}: BC6H DDS round trip")
        dec, counts_d = counts_of(lambda: decompress(back))
        need(counts_d, ["bc6h_decode"], f"{key} decompress")
        words = ct.levels[0].reshape(-1, 16)
        check(torch.equal(dec.levels[0][0], blocks_to_image(
            bc6h.decode_bc6h(words, False), hdr_size, hdr_size)),
            f"{key}: decompress differs from decode_bc6h")
        nbs = hdr_size // 4
        ref = torch.from_numpy(np.ascontiguousarray(
            frozen[key + "_words"].reshape(128, 128, 16)[:nbs, :nbs]
            .reshape(-1, 16))).to(dev)
        err, err_jax = int_err(words), int_err(ref)
        psnr = log_psnr(dec.levels[0][0].cpu().numpy(), img)
        psnr_jax = log_psnr(blocks_to_image(bc6h.decode_bc6h(
            ref, False), hdr_size, hdr_size).cpu().numpy(), img)
        if hdr_size == 512:
            check(abs(err_jax / float(frozen[key + "_int_err"]) - 1) < 1e-9
                  and abs(psnr_jax - float(frozen[key + "_log_psnr"]))
                  < 1e-6, f"{key}: the frozen JAX words' metrics")
        check(err <= err_jax * 1.005,
              f"{key}: aggregate F16-int error {err} > 1.005 x JAX's "
              f"{err_jax}")
        hdr[key] = {"launches": {"compress": counts_c,
                                 "decompress": counts_d},
                    "int_err": err, "jax_int_err": err_jax,
                    "int_err_ratio": err / err_jax, "log_psnr": psnr,
                    "jax_log_psnr": psnr_jax,
                    "words_differ_from_jax": int(
                        (words != ref).any(dim=1).sum()),
                    "ms": {"compress": timed(lambda: compress(
                        tex, FMT.BC6H_UF16, flags)),
                           "decompress": timed(lambda: decompress(back))}}
    emit({"phase": "hdr_dds", "card": smi, "size": hdr_size,
          "blocks": int(blocks.shape[0]), "gate": "aggregate F16-int error "
          "<= 1.005 x the JAX package's (frozen)", **hdr,
          "ms_dds_load": timed(lambda: dds.load_from_dds_memory(
              raw, device=dev))})

    # 31. convert and pack on the card --------------------------------------
    steps = [(FMT.R16G16B16A16_FLOAT, TF.DEFAULT),
             (FMT.R10G10B10A2_UNORM, TF.DEFAULT),
             (FMT.B5G6R5_UNORM, TF.DITHER)]
    cur = Texture(tex_ldr.metadata.with_format(FMT.R8G8B8A8_UNORM_SRGB),
                  tex_ldr.levels)
    conv = {}
    for fmt, flags in steps:
        out, counts_v = counts_of(lambda: convert(cur, fmt, flags))
        check(counts_v == {}, f"convert launched hand kernels {counts_v}")
        want = convert(cpu_tex(cur), fmt, flags)
        got = [lvl.cpu() for lvl in out.levels]
        n_diff = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                     for a, b in zip(got, want.levels))
        max_diff = max(float((a - b).abs().max()) for a, b in
                       zip(got, want.levels))
        # the sRGB step: f64 pow on the card and on the host may round
        # apart on a value; any other step is held bit for bit
        srgb = fmt == steps[0][0]
        check(n_diff == 0 or (srgb and max_diff <= 1e-3),
              f"convert -> {fmt.name}: {n_diff} values differ from the "
              f"CPU port's (max {max_diff})")
        n_kernels, dev_ms = kernels_and_ms(profile_calls(
            torch, {"convert": lambda: convert(cur, fmt, flags)},
            required=False)["convert"])
        conv[fmt.name] = {"values_differ_from_cpu": n_diff,
                          "max_abs_diff": max_diff,
                          "ms": timed(lambda: convert(cur, fmt, flags)),
                          "cuda_kernels": n_kernels, "device_ms": dev_ms}
        cur = out
    rng = np.random.default_rng(31)
    patch = rng.uniform(-1.5, 2.5, (64 * 64, 4)).astype(np.float32)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 1e-40,
                        3e-8, 65520.0, 7e4, -3e9, 5e9, 300.4, -200.7,
                        1.2529412, 0.49999997], np.float32)
    patch.reshape(-1)[rng.choice(patch.size, 4 * special.size,
                                 replace=False)] = np.tile(special, 4)
    patch_d, patch_c = to_dev(patch), torch.from_numpy(patch)
    fmts = [f for f in FMT if packing.is_packable(f)]
    check(len(fmts) == 75, f"{len(fmts)} packable formats")
    packed_differ, unpacked_differ = [], []
    for f in fmts:
        if f in packing._SPECIAL_UNPACK and f not in packing._SPECIAL_PACK:
            raw_c = torch.from_numpy(rng.integers(
                0, 256, 64 * 64 * 8, dtype=np.uint8))
        else:
            raw_c = packing.pack(f, patch_c)
            if not torch.equal(packing.pack(f, patch_d).cpu(), raw_c):
                packed_differ.append(f.name)
        got = packing.unpack(f, raw_c.to(dev), 64 * 64).cpu()
        want = packing.unpack(f, raw_c, 64 * 64)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            unpacked_differ.append(f.name)
    check(not packed_differ and not unpacked_differ,
          f"pack differs from the CPU port on {packed_differ}, unpack on "
          f"{unpacked_differ}")
    emit({"phase": "convert_pack", "card": smi, "convert": conv,
          "packable_formats": len(fmts), "pack_bit_equal_cpu": True,
          "unpack_bit_equal_cpu": True})


def close_count(torch, got, want, what: str, exact: bool) -> int:
    """The card's `got` against the CPU port's `want` (f32 tensors): bit
    for bit where `exact`, else each value within 4 ulp of the CPU's or
    1e-6 absolute. Returns the count of values whose bits differ."""
    got = got.detach().cpu()
    check(tuple(got.shape) == tuple(want.shape),
          f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    diff = got.view(torch.int32) != want.view(torch.int32)
    diff &= ~(torch.isnan(got) & torch.isnan(want))
    n = int(diff.sum())
    if exact:
        check(n == 0, f"{what}: {n} values differ from the CPU port's")
        return 0
    g, w = got.to(torch.float64), want.to(torch.float64)
    ulp = torch.from_numpy(np.spacing(np.abs(want.numpy()))).to(
        torch.float64)
    bad = ~((g - w).abs() <= torch.maximum(4 * ulp, torch.full_like(
        ulp, 1e-6))) & diff
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} values beyond "
          f"4 ulp / 1e-6 of the CPU port's (max "
          f"{float((g - w).abs()[bad].max()) if bad.any() else 0.0})")
    return n


def image_ops_phases(torch, dev, to_dev, event_ms, smi,
                     size: int = SLICE_SIZE, small: int = 256,
                     hdr_size: int = 512, vol: int = 128) -> None:
    """Phases 32-36: the image ops on the card (ops.fliprotate, resize,
    mipmaps, pmalpha, misc, normalmaps, rotatecolor and the diffusion
    dither of ops.dither), through the entry points a user calls. 32:
    every op on the card against the CPU port, at small and corner sizes,
    every flag the tests cover; 33: texconv's chain on the bench image
    with alpha (flip / rotate -> resize -> mips -> alpha coverage ->
    premultiply -> compress BC7_UNORM_SRGB (K2, mode 7, K3) ->
    decompress (K1) -> PSNR per level); 34: a normal map of the bench
    image's luminance -> compress BC7_UNORM (K2, K3); 35: an HDR image
    through rotate_color, TRIANGLE mips, BC6H (K5, K4), PQ and the
    diffusion dither on the host; 36: a 128^3 volume's 3D mips. Each path
    is driven with the launch counts set to 0 just before it and read just
    after; times are CUDA-event medians of 7 after a warm-up, with min and
    max, each step's CUDA kernels and device time from a profiler record
    of one call and its host syncs."""
    from directxtex_tpu_torch import native
    from directxtex_tpu_torch.bc import bc6h, bc67
    from directxtex_tpu_torch.bc.common import image_to_blocks
    from directxtex_tpu_torch.formats import FMT
    from directxtex_tpu_torch.ops import dither
    from directxtex_tpu_torch.ops.compress import compress, decompress
    from directxtex_tpu_torch.ops.convert import convert, convert_values
    from directxtex_tpu_torch.ops.fliprotate import flip_rotate
    from directxtex_tpu_torch.ops.flags import CMSE_FLAGS, CNMAP_FLAGS
    from directxtex_tpu_torch.ops.flags import TEX_FILTER_FLAGS as TF
    from directxtex_tpu_torch.ops.flags import TEX_FR_FLAGS as FR
    from directxtex_tpu_torch.ops.flags import TEX_PMALPHA_FLAGS as PM
    from directxtex_tpu_torch.ops.mipmaps import (
        calculate_alpha_coverage, generate_mipmaps, generate_mipmaps_3d,
        scale_mipmaps_alpha_for_coverage)
    from directxtex_tpu_torch.ops.misc import (compute_mse, compute_psnr,
                                               copy_rectangle, evaluate_image,
                                               transform_image)
    from directxtex_tpu_torch.ops.normalmaps import compute_normal_map
    from directxtex_tpu_torch.ops.pmalpha import premultiply_alpha
    from directxtex_tpu_torch.ops.resize import resize, resize_array
    from directxtex_tpu_torch.ops.rotatecolor import (pq_decode, pq_encode,
                                                      rotate_color)
    from directxtex_tpu_torch.texture import TexDimension, Texture

    pr = Probe(torch, event_ms)
    cpu_tex = pr.cpu_tex
    gen = golden_module("generate_image_ops")

    def tex_of(data, fmt, device, dim=None):
        return Texture.from_array(data, getattr(FMT, fmt), dimension=dim,
                                  device=device)

    differ = {}

    def hold(key, got, want, exact):
        """Card against CPU port, per level for textures; counts kept by
        key."""
        if isinstance(got, Texture):
            check(got.mip_levels == want.mip_levels and
                  got.metadata == want.metadata, f"{key}: metadata")
            n = sum(close_count(torch, a, b, f"{key} level {m}", exact)
                    for m, (a, b) in enumerate(zip(got.levels, want.levels)))
        else:
            n = close_count(torch, got, want, key, exact)
        differ[key] = differ.get(key, 0) + n

    # 32. every op on the card against the CPU port ------------------------
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "resize would run in TF32")
    shapes = [(2, 24, 40), (2, 16, 32), (1, 1, 1), (1, 1, 2), (1, 3, 5),
              (1, 6, 10)]
    t0 = time.perf_counter()
    for k, shape in enumerate(shapes):
        data = gen.image(3200 + k, shape)
        for fmt in ("R8G8B8A8_UNORM", "R8G8B8A8_UNORM_SRGB"):
            td, tc = tex_of(data, fmt, dev), tex_of(data, fmt, "cpu")
            srgb = "SRGB" in fmt
            for rot in range(4):
                for flip in (0, 0x08, 0x10, 0x18):
                    hold("flip_rotate", flip_rotate(td, FR(rot | flip)),
                         flip_rotate(tc, FR(rot | flip)), True)
            for flags in (0, 0x1, 0x2, 0x3, 0x3000000):
                hold("premultiply_alpha", premultiply_alpha(td, PM(flags)),
                     premultiply_alpha(tc, PM(flags)),
                     not srgb and not flags & 0x3000000)
            h, w = shape[1:]
            for name, mode in gen.FILTERS.items():
                for extra in (0, TF.SEPARATE_ALPHA, TF.WRAP | TF.SRGB_IN,
                              TF.MIRROR | TF.SEPARATE_ALPHA):
                    for ow, oh in ((max(1, w * 3 // 4), max(1, h * 3 // 4)),
                                   (w * 2 + 1, h + 2)):
                        f = TF(mode) | extra
                        hold("resize", resize(td, ow, oh, f),
                             resize(tc, ow, oh, f), False)
                # box and point halve only power-of-two sides (mipmaps.py)
                pow2 = all(s & (s - 1) == 0 for s in (h, w))
                if pow2 or mode in (TF.LINEAR, TF.CUBIC, TF.TRIANGLE):
                    for extra in (0, TF.WRAP, TF.MIRROR):
                        f = TF(mode) | extra
                        hold("generate_mipmaps", generate_mipmaps(td, f),
                             generate_mipmaps(tc, f),
                             mode in (TF.POINT, TF.BOX, 0) and not srgb)
            # the coverage of one chain (its filtered levels may round
            # apart between the devices)
            chain_d = generate_mipmaps(td, TF.LINEAR)
            chain_c = cpu_tex(chain_d)
            for ref in (0.25, 0.5, 0.9):
                hold("calculate_alpha_coverage",
                     calculate_alpha_coverage(td.levels[0][..., 3], ref),
                     calculate_alpha_coverage(tc.levels[0][..., 3], ref),
                     True)
                hold("scale_mipmaps_alpha_for_coverage",
                     scale_mipmaps_alpha_for_coverage(chain_d, ref),
                     scale_mipmaps_alpha_for_coverage(chain_c, ref),
                     not srgb)
        td = tex_of(data, "R8G8B8A8_UNORM", dev)
        tc = tex_of(data, "R8G8B8A8_UNORM", "cpu")
        for _, _, flags, amp, fmt in gen.normal_cases():
            hold("compute_normal_map", compute_normal_map(
                td, CNMAP_FLAGS(flags), amp, getattr(FMT, fmt)),
                compute_normal_map(tc, CNMAP_FLAGS(flags), amp,
                                   getattr(FMT, fmt)), True)
        hdr = gen.image(3300 + k, shape, -0.25, 6.0)
        for _, rot, nits in gen.rotate_cases():
            hold("rotate_color", rotate_color(to_dev(hdr), rot, nits),
                 rotate_color(torch.from_numpy(hdr), rot, nits), False)
        for name in ("B5G6R5_UNORM", "R8G8B8A8_SNORM", "R10G10B10A2_UNORM"):
            vals = gen.image(3400 + k, shape, -1.2, 1.3)
            hold("diffusion_dither", dither.diffusion_dither(
                to_dev(vals), getattr(FMT, name)), dither.diffusion_dither(
                torch.from_numpy(vals), getattr(FMT, name)), True)
            hold("convert_diffusion", convert(td, getattr(FMT, name),
                                              TF.DITHER_DIFFUSION),
                 convert(tc, getattr(FMT, name), TF.DITHER_DIFFUSION), True)
        for case in gen.mse_cases():
            _, ch, flags, f1, f2 = case
            a, b = gen.mse_inputs(ch)
            fa = getattr(FMT, f1) if f1 else None
            fb = getattr(FMT, f2) if f2 else None
            s_d, v_d = compute_mse(to_dev(a), to_dev(b), CMSE_FLAGS(flags),
                                   fa, fb)
            s_c, v_c = compute_mse(torch.from_numpy(a), torch.from_numpy(b),
                                   CMSE_FLAGS(flags), fa, fb)
            p_d = compute_psnr(to_dev(a), to_dev(b), CMSE_FLAGS(flags))
            p_c = compute_psnr(torch.from_numpy(a), torch.from_numpy(b),
                               CMSE_FLAGS(flags))
            check(torch.allclose(v_d.cpu(), v_c, rtol=1e-6, atol=0)
                  and torch.allclose(s_d.cpu(), s_c, rtol=1e-6, atol=0)
                  and torch.allclose(p_d.cpu(), p_c, rtol=1e-6, atol=0),
                  f"compute_mse {case[0]}: card {v_d.tolist()} vs CPU "
                  f"{v_c.tolist()}")
        img_d, img_c = to_dev(data[0]), torch.from_numpy(data[0])
        h, w = shape[1:]
        rect = (0, 0, max(1, w // 2), max(1, h // 2))
        hold("copy_rectangle", copy_rectangle(img_d, rect, img_d.flip(0),
                                              w - rect[2], h - rect[3]),
             copy_rectangle(img_c, rect, img_c.flip(0), w - rect[2],
                            h - rect[3]), True)
        seen = []
        evaluate_image(td, seen.append)
        check(all(p.device == dev for p in seen), "evaluate_image device")
        hold("transform_image", transform_image(
            td, lambda p: p * 0.5 + p[..., 3:4]), transform_image(
            tc, lambda p: p * 0.5 + p[..., 3:4]), True)
    for k, (_, fmt, shp, flags, levels) in enumerate(gen.mip3d_cases()):
        vol_np = gen.image(3500 + k, shp)
        hold("generate_mipmaps_3d", generate_mipmaps_3d(
            tex_of(vol_np, fmt, dev, TexDimension.TEXTURE3D), TF(flags),
            levels), generate_mipmaps_3d(
            tex_of(vol_np, fmt, "cpu", TexDimension.TEXTURE3D), TF(flags),
            levels), False)
    emit({"phase": "image_ops", "card": smi, "shapes": shapes,
          "tf32": False, "values_differ_from_cpu": differ,
          "seconds": time.perf_counter() - t0})

    # 33. texconv's chain: the bench image with alpha ----------------------
    out_side = size * 3 // 4

    def chain_steps(side):
        return [
            ("flip_rotate", lambda t: flip_rotate(
                t, FR.ROTATE90 | FR.FLIP_HORIZONTAL)),
            ("resize", lambda t: resize(t, side, side,
                                        TF.CUBIC | TF.SEPARATE_ALPHA)),
            ("generate_mipmaps", lambda t: generate_mipmaps(t, TF.LINEAR)),
            ("alpha_coverage", lambda t: scale_mipmaps_alpha_for_coverage(
                t, 0.5)),
            ("premultiply_alpha", premultiply_alpha),
            ("compress", lambda t: compress(t, FMT.BC7_UNORM_SRGB)),
            ("decompress", decompress)]

    def psnr_levels(dec, ref):
        return torch.stack([compute_psnr(a, b) for a, b in
                            zip(dec.levels, ref.levels)])

    def measure(steps, first):
        """Each step on the output of the one before: its launches, time,
        kernels, device time, busy share and host syncs."""
        outs, rec = [first], {}
        for name, fn in steps:
            inp = outs[-1]
            out, counts = pr.counts_of(lambda: fn(inp))
            outs.append(out)
            ms = pr.timed(lambda: fn(inp))
            n_kernels, dev_ms = kernels_and_ms(profile_calls(
                torch, {name: lambda: fn(inp)}, required=False)[name])
            rec[name] = {"ms": ms, "launches": counts,
                         "cuda_kernels": n_kernels, "device_ms": dev_ms,
                         "busy": None if dev_ms is None
                         else dev_ms / ms["median"],
                         "host_syncs": pr.host_syncs(lambda: fn(inp))}
        return outs, rec

    img = bench_image(size, alpha=True)
    src = tex_of(img, "R8G8B8A8_UNORM_SRGB", dev)
    steps = chain_steps(out_side)
    path = {}

    def whole_chain():
        t = src
        for name, fn in steps:
            t = fn(t)
            path[name] = t
        return psnr_levels(t, path["premultiply_alpha"])

    torch.cuda.synchronize()
    psnr, counts = pr.counts_of(whole_chain)
    pr.need(counts, ["bc7_encode", "bc7_alpha_list", "bc7_mode7",
                     "bc7_mode_buckets", "bc7_refine_alpha", "bc7_decode"],
            "texconv chain")
    mips = path["generate_mipmaps"]
    check(mips.mip_levels == out_side.bit_length() and tuple(
        mips.levels[-1].shape) == (1, 1, 1, 4), f"{mips.mip_levels} levels")
    check(bool(torch.isfinite(psnr).all()) and float(psnr[0]) > 30.0,
          f"chain PSNR per level {psnr.tolist()}")
    outs, rec = measure(steps, src)
    pm_tex, ct = outs[5], outs[6]
    rec["compute_psnr"] = {"ms": pr.timed(lambda: psnr_levels(outs[7],
                                                              pm_tex)),
                           "host_syncs": pr.host_syncs(
                               lambda: psnr_levels(outs[7], pm_tex))}
    rec["chain"] = {"ms": pr.timed(whole_chain),
                    "host_syncs": pr.host_syncs(whole_chain)}
    # a sample of level 0's blocks against the plain twins on the card
    blocks0 = image_to_blocks(pm_tex.image(0))[0]
    pick = torch.arange(0, blocks0.shape[0], 9, device=dev)
    px = bc67._quantize_ldr(blocks0[pick]).reshape(64, -1).contiguous()
    _, w_p = bc67._bc7_search_plain(px, bc67.SEARCH_MODES_ALPHA)
    w_p = bc67._bc7_refine_plain(px, w_p, bc67.REFINE_MODES_ALPHA)
    words0 = ct.levels[0].reshape(-1, 16)[pick]
    n_bad = int((w_p.t().contiguous().view(torch.uint8).reshape(-1, 16)
                 != words0).any(dim=1).sum())
    check(n_bad == 0, f"chain: {n_bad} sampled BC7 blocks differ from the "
          f"plain twins")
    # the same chain at 256^2, each step on the card and on the CPU port
    # from the same input (the card's previous output)
    small_src = tex_of(bench_image(small, alpha=True), "R8G8B8A8_UNORM_SRGB",
                       dev)
    cur = small_src
    small_differ = {}
    for name, fn in chain_steps(small * 3 // 4):
        got, want = fn(cur), fn(cpu_tex(cur))
        if name == "compress":
            check(all(torch.equal(a.cpu(), b) for a, b in
                      zip(got.levels, want.levels)),
                  "256^2 chain: compress words differ from the CPU port's")
        else:
            n0 = sum(differ.values())
            hold("chain_" + name, got, want,
                 name in ("flip_rotate", "alpha_coverage", "decompress"))
            small_differ[name] = sum(differ.values()) - n0
        cur = got
    emit({"phase": "texconv_chain", "card": smi, "size": size,
          "resized": out_side, "levels": mips.mip_levels,
          "blocks": sum(int(lvl.numel()) // 16 for lvl in ct.levels),
          "launches": counts, "psnr_per_level": psnr.tolist(),
          "steps": rec, "plain_sample_blocks": int(pick.numel()),
          "plain_sample_equal": True, "small": small,
          "small_values_differ_from_cpu": small_differ,
          "small_words_equal_cpu": True})

    # 34. a normal map of the bench image's luminance -> BC7 --------------
    nm_flags = (CNMAP_FLAGS.CHANNEL_LUMINANCE | CNMAP_FLAGS.MIRROR_U
                | CNMAP_FLAGS.MIRROR_V | CNMAP_FLAGS.COMPUTE_OCCLUSION)
    height = tex_of(bench_image(size), "R8G8B8A8_UNORM", dev)
    nm_steps = [("compute_normal_map", lambda t: compute_normal_map(
                    t, nm_flags, 2.0, FMT.R8G8B8A8_UNORM)),
                ("compress", lambda t: compress(t, FMT.BC7_UNORM))]
    nm_out = {}

    def nm_path():
        nm_out["map"] = nm_steps[0][1](height)
        nm_out["bc7"] = nm_steps[1][1](nm_out["map"])
        return nm_out["bc7"]

    nct, counts = pr.counts_of(nm_path)
    # the occlusion term puts alpha below 1: the search with mode 7
    refine = "bc7_refine_alpha" if counts.get("bc7_mode7") else "bc7_refine"
    pr.need(counts, ["bc7_encode", "bc7_mode_buckets", refine],
            "normal map path")
    nb = int(nct.levels[0].numel()) // 16
    check(nb == (size // 4) ** 2, f"normal map: {nb} blocks")
    outs, nm_rec = measure(nm_steps, height)
    nm_rec["path"] = {"ms": pr.timed(nm_path),
                      "host_syncs": pr.host_syncs(nm_path)}
    hs = tex_of(bench_image(small), "R8G8B8A8_UNORM", dev)
    hold("normal_map_256", compute_normal_map(hs, nm_flags, 2.0),
         compute_normal_map(cpu_tex(hs), nm_flags, 2.0), True)
    emit({"phase": "normal_map_2k", "card": smi, "size": size,
          "blocks": nb, "launches": counts, "steps": nm_rec,
          "small_map_equal_cpu": True})

    # 35. HDR: color rotation, mips, BC6H; PQ and the diffusion dither ----
    hdr_img = np.ascontiguousarray(golden_module(
        "generate_compress_dds").hdr512_image(np.load(os.path.join(
            GOLDEN, "corpus.npz")))[:hdr_size, :hdr_size])
    htex = tex_of(hdr_img, "R16G16B16A16_FLOAT", dev)
    hdr_steps = [
        ("rotate_color", lambda t: transform_image(
            t, lambda p: rotate_color(p, "709to2020"))),
        ("generate_mipmaps", lambda t: generate_mipmaps(t, TF.TRIANGLE)),
        ("compress", lambda t: compress(t, FMT.BC6H_UF16)),
        ("decompress", decompress)]
    hdr_path = {}

    def hdr_chain():
        t = htex
        for name, fn in hdr_steps:
            t = fn(t)
            hdr_path[name] = t
        return t

    _, counts = pr.counts_of(hdr_chain)
    pr.need(counts, ["bc6h_encode", "bc6h_decode"], "HDR chain")
    outs, hdr_rec = measure(hdr_steps, htex)
    hold("hdr_rotate_color", outs[1], transform_image(
        cpu_tex(htex), lambda p: rotate_color(p, "709to2020")), False)
    hold("hdr_triangle_mips", outs[2], generate_mipmaps(cpu_tex(outs[1]),
                                                        TF.TRIANGLE), False)
    pq_steps = [("rotate_color_hdr10", lambda t: transform_image(
                    t, lambda p: rotate_color(p, "709toHDR10", 200.0))),
                ("convert_r10g10b10a2_diffusion", lambda t: convert(
                    t, FMT.R10G10B10A2_UNORM, TF.DITHER_DIFFUSION))]
    pq_outs, pq_rec = measure(pq_steps, htex)
    hold("hdr10_rotate", pq_outs[1], transform_image(
        cpu_tex(htex), lambda p: rotate_color(p, "709toHDR10", 200.0)),
        False)
    hold("hdr10_diffusion", pq_outs[2], convert(
        cpu_tex(pq_outs[1]), FMT.R10G10B10A2_UNORM, TF.DITHER_DIFFUSION),
        True)
    lvl0 = pm_tex.replace_levels([pm_tex.levels[0]])
    d_steps = [("convert_b5g6r5_diffusion", lambda t: convert(
                   t, FMT.B5G6R5_UNORM, TF.DITHER_DIFFUSION)),
               ("convert_b5g6r5_ordered", lambda t: convert(
                   t, FMT.B5G6R5_UNORM, TF.DITHER))]
    _, d_rec = measure(d_steps[:1], lvl0)
    _, o_rec = measure(d_steps[1:], lvl0)
    d_rec.update(o_rec)
    got = convert(lvl0, FMT.B5G6R5_UNORM, TF.DITHER_DIFFUSION)
    hold("b5g6r5_diffusion", got, convert(cpu_tex(lvl0), FMT.B5G6R5_UNORM,
                                          TF.DITHER_DIFFUSION), True)
    # the host pass and its two copies apart, on the values convert dithers
    vals = convert_values(lvl0.levels[0], FMT.R8G8B8A8_UNORM_SRGB,
                          FMT.B5G6R5_UNORM, TF.DITHER_DIFFUSION)
    scales, clampzero = dither.dither_scales(FMT.B5G6R5_UNORM)
    sc = np.asarray(scales, np.float32)
    host_vals = vals.cpu().numpy()
    host_ms = []
    for _ in range(8):          # a warm-up, then 7, each on a fresh copy
        buf = host_vals.copy()
        t_0 = time.perf_counter()
        for im in buf:
            native.fs_dither(im, sc, clampzero)
        host_ms.append((time.perf_counter() - t_0) * 1e3)
    host_out = torch.from_numpy(buf)
    parts = {"d2h": pr.timed(lambda: vals.cpu()),
             "host_pass": pr.spread(host_ms[1:]),
             "h2d": pr.timed(lambda: host_out.to(dev)),
             "diffusion_dither": pr.timed(lambda: dither.diffusion_dither(
                 vals, FMT.B5G6R5_UNORM)),
             "host_syncs": pr.host_syncs(lambda: dither.diffusion_dither(
                 vals, FMT.B5G6R5_UNORM)),
             "copies": 2}
    crop = vals[0, :64, :64].contiguous()
    hold("diffusion_twin_64", dither.diffusion_dither(crop, FMT.B5G6R5_UNORM),
         torch.from_numpy(dither._fs_dither_py(crop.cpu().numpy(), sc,
                                               clampzero)), True)
    emit({"phase": "hdr_and_dither", "card": smi, "size": hdr_size,
          "launches": counts, "steps": {**hdr_rec, **pq_rec, **d_rec},
          "dither_parts": parts, "dither_size": list(vals.shape),
          "bc6h_blocks": sum(int(l.numel()) // 16 for l in
                             hdr_path["compress"].levels),
          "values_differ_from_cpu": {k: differ[k] for k in (
              "hdr_rotate_color", "hdr_triangle_mips", "hdr10_rotate")}})

    # 36. 3D mips of a 128^3 RGBA16F volume --------------------------------
    rng = np.random.default_rng(36)
    v_np = rng.random((vol, vol, vol, 4), np.float32).astype(
        np.float16).astype(np.float32)
    vtex = tex_of(v_np, "R16G16B16A16_FLOAT", dev, TexDimension.TEXTURE3D)
    v_rec = {}
    for name, f in (("linear", TF.LINEAR), ("box", TF.BOX)):
        out, counts = pr.counts_of(lambda: generate_mipmaps_3d(vtex, f))
        check(counts == {} and out.mip_levels == vol.bit_length(),
              f"3D mips {name}: {out.mip_levels} levels, {counts}")
        _, rec = measure([(name, lambda t: generate_mipmaps_3d(t, f))], vtex)
        v_rec.update(rec)
        small_v = tex_of(v_np[:16, :16, :16], "R16G16B16A16_FLOAT", dev,
                         TexDimension.TEXTURE3D)
        hold(f"mips_3d_{name}_16", generate_mipmaps_3d(small_v, f),
             generate_mipmaps_3d(cpu_tex(small_v), f), name == "box")
    emit({"phase": "mips_3d", "card": smi, "size": vol, "steps": v_rec,
          "small_values_differ_from_cpu": {
              k: differ[k] for k in ("mips_3d_linear_16", "mips_3d_box_16")}})



def tga_rle(px: np.ndarray) -> bytes:
    """TGA RLE packets of [N, bpp] u8 pixels: each run of equal pixels
    longer than one as run packets of up to 128, the pixels between runs
    as raw packets of up to 128 (numpy finds the runs; the loop is over
    runs, not pixels)."""
    n, bpp = px.shape
    words = np.zeros(n, np.uint64)
    for i in range(bpp):
        words |= px[:, i].astype(np.uint64) << np.uint64(8 * i)
    starts = np.concatenate([[0], np.flatnonzero(words[1:] != words[:-1])
                             + 1, [n]])
    lens = np.diff(starts)
    out = []
    raw_from = 0

    def flush_raw(a, b):
        for c in range(a, b, 128):
            e = min(b, c + 128)
            out.append(bytes([e - c - 1]) + px[c:e].tobytes())

    for k in np.flatnonzero(lens > 1):
        a, ln = int(starts[k]), int(lens[k])
        flush_raw(raw_from, a)
        for c in range(0, ln, 128):
            out.append(bytes([0x80 | (min(128, ln - c) - 1)])
                       + px[a].tobytes())
        raw_from = a + ln
    flush_raw(raw_from, n)
    return b"".join(out)


def tga_bytes(px: np.ndarray, rle: bool, bottom_up: bool) -> bytes:
    """A TGA 2.0 file of [H, W, 4] RGBA8 pixels (BGRA on disk), RLE or
    raw, top-down or bottom-up, its footer giving gamma 2.2 (sRGB) and
    straight alpha."""
    import struct

    h, w, _ = px.shape
    rows = px[::-1] if bottom_up else px
    bgra = np.ascontiguousarray(rows[..., [2, 1, 0, 3]]).reshape(-1, 4)
    body = tga_rle(bgra) if rle else bgra.tobytes()
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 10 if rle else 2, 0, 0, 0, 0,
                       0, w, h, 32, 8 | (0 if bottom_up else 0x20))
    ext = bytearray(495)
    struct.pack_into("<H", ext, 0, 495)
    struct.pack_into("<HH", ext, 478, 22, 10)
    ext[494] = 3
    footer = struct.pack("<II", len(head) + len(body), 0) + \
        b"TRUEVISION-XFILE.\x00"
    return head + body + bytes(ext) + footer


def hdr_env_map(corpus, height: int = 1024, width: int = 2048) -> np.ndarray:
    """[H, W, 4] f32: 128^2 tiles of corpus.npz's hdr_china, hdr_flower and
    hdr_sun (64^2, each texel repeated 2 x 2) in turn, tile k exposed by
    2 ** ((7 * k) % 37 - 22), so that the RGBE exponent bytes run from
    about 100 to 150 (where XLA's exp2 misses most of them). Alpha 1."""
    tiles = [corpus["hdr_china"][..., :3], corpus["hdr_flower"][..., :3],
             np.repeat(np.repeat(corpus["hdr_sun"][..., :3], 2, 0), 2, 1)]
    rows = []
    for i in range(height // 128):
        row = []
        for j in range(width // 128):
            k = i * (width // 128) + j
            row.append(tiles[k % 3] * np.float32(2.0 ** ((7 * k) % 37 - 22)))
        rows.append(np.concatenate(row, axis=1))
    rgb = np.concatenate(rows, axis=0).astype(np.float32)
    return np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)


def container_files(torch, dev, corpus, tga_size: int = SLICE_SIZE,
                    exr_size: int = 1024) -> dict:
    """{file name: bytes} of phase 37's folder, written by the port's own
    savers (and tga_bytes for the RLE TGAs): four tga_size^2 sRGB RGBA8
    TGAs of the bench image with and without alpha (two RLE, one raw 32
    bpp, one 24 bpp), a 2 tga_size x tga_size RLE .hdr environment map, one
    exr_size^2 RGBA half EXR in each of ZIP, PIZ, B44 and RLE and one
    exr_size^2 PFM."""
    from directxtex_tpu_torch.formats import FMT
    from directxtex_tpu_torch.io import exr, hdr, ppm, tga
    from directxtex_tpu_torch.texture import Texture

    def rgba8(img):
        return np.round(img * 255).astype(np.uint8)

    opaque, alpha = (rgba8(bench_image(tga_size, alpha=a))
                     for a in (False, True))
    files = {
        "rgba_rle.tga": tga_bytes(alpha, rle=True, bottom_up=True),
        "opaque_rle.tga": tga_bytes(opaque, rle=True, bottom_up=False),
        "rgba_raw.tga": tga.save_to_tga_memory(Texture.from_array(
            alpha.astype(np.float32) / 255, FMT.R8G8B8A8_UNORM_SRGB,
            device=dev)),
        "opaque_24.tga": tga.save_to_tga_memory(Texture.from_array(
            opaque.astype(np.float32) / 255, FMT.B8G8R8X8_UNORM_SRGB,
            device=dev)),
    }
    env = hdr_env_map(corpus, tga_size // 2, tga_size)
    files["env.hdr"] = hdr.save_to_hdr_memory(Texture.from_array(
        env, FMT.R32G32B32A32_FLOAT, device=dev))
    # halves hold up to 65504: the brightest tiles are clipped there
    crop = np.minimum(env[:exr_size, :exr_size], np.float32(60000.0))
    crop[..., 3] = bench_image(exr_size, alpha=True)[..., 3]
    half = Texture.from_array(crop, FMT.R16G16B16A16_FLOAT, device=dev)
    for name, comp in (("zip", exr._ZIP), ("piz", exr._PIZ),
                       ("b44", exr._B44), ("rle", exr._RLE)):
        files[f"{name}.exr"] = exr.save_to_exr_memory(half,
                                                      compression=comp)
    files["map.pfm"] = ppm.save_to_pfm_memory(Texture.from_array(
        env[-exr_size:, -exr_size:], FMT.R32G32B32A32_FLOAT, device=dev))
    return files


def container_phases(torch, dev, event_ms, smi, tga_size: int = SLICE_SIZE,
                     exr_size: int = 1024) -> dict:
    """Phases 37-38: the container loaders and texconv on the card, over a
    folder of source files the port's savers write (container_files). 37:
    each file loaded on the card, the load timed as host parse, H2D copy
    and device decode (CUDA events, medians of 7; of FILE_REPS for an
    EXR's parse and load, which take 0.1-0.9 s), its host syncs, the
    texture bit-equal to the port's CPU load of the same bytes, each
    native codec against its numpy twin on a crop, and the texture saved
    again, its bytes equal to the CPU port's save; 38: the port's
    tools.texconv.main over the folder, BC7_UNORM_SRGB with full mips over
    the four TGAs (one compress_many: K2 with mode 7, K3) and BC6H_UF16
    over the HDR, EXR and PFM files (one compress_many: K5), each run rc 0
    with no FAILED line and one compress_many per (format, flags) group,
    the outputs reloaded and decoded on the card (K1, K4) with their PSNR
    per level, level 0 of one TGA against compress() called on its loaded
    texture, a -timing run (its synchronizes counted), a -profile run (a
    non-empty trace with kernels) and a non-BC run (-f R16G16B16A16_FLOAT
    -ft exr). Each path is driven with the launch counts set to 0 just
    before it and read just after. Returns {"files": the folder's {name:
    bytes}, "dds": texconv's BC outputs, {source name: DDS bytes}} for
    phases 39-41."""
    import contextlib
    import io as _io
    import tempfile

    from directxtex_tpu_torch import native, ops
    from directxtex_tpu_torch.formats import FMT, packing
    from directxtex_tpu_torch.io import (dds, exr, exr_piz, hdr, load_texture,
                                         ppm, tga)
    from directxtex_tpu_torch.ops import compute_psnr, decompress
    from directxtex_tpu_torch.texture import CompressedTexture
    from directxtex_tpu_torch.tools import texconv

    pr = Probe(torch, event_ms)
    t_start = time.perf_counter()
    corpus = np.load(os.path.join(GOLDEN, "corpus.npz"))
    files = container_files(torch, dev, corpus, tga_size, exr_size)
    stages = {".tga": (tga._host_parse, tga._device_decode),
              ".hdr": (hdr._host_parse, hdr._device_decode),
              ".exr": (exr._host_parse, exr._device_decode),
              ".pfm": (ppm._host_parse_pfm, ppm._device_decode)}
    exr_comp = {"zip.exr": exr._ZIP, "piz.exr": exr._PIZ,
                "b44.exr": exr._B44, "rle.exr": exr._RLE}

    def saved(tex, name):
        ext = os.path.splitext(name)[1]
        if ext == ".tga":
            return tga.save_to_tga_memory(tex)
        if ext == ".hdr":
            return hdr.save_to_hdr_memory(tex)
        if ext == ".exr":
            return exr.save_to_exr_memory(tex, compression=exr_comp[name])
        return ppm.save_to_pfm_memory(tex)

    def twins(name, data):
        """The file's native codec against its numpy twin on a crop:
        {codec: values compared}."""
        if name.endswith("_rle.tga"):
            n = 65536
            got = native.tga_rle_decode(data[18:], n, 4)
            want = tga._decode_rle_py(np.frombuffer(data, np.uint8)[18:], 4,
                                      n)
            check(np.array_equal(got, want), f"{name}: native RLE decode")
            return {"tga_rle_decode": int(got.size)}
        if name.endswith(".hdr"):
            w, h, _, off = hdr._parse_header(data)
            got = native.hdr_decode_scanlines(data, off, w, 8)
            check(np.array_equal(got, hdr._decode_scanlines_py(data, off, w,
                                                               8)),
                  f"{name}: native scanline decode")
            chans = got[:4].transpose(0, 2, 1).reshape(-1, w)
            check(all(native.hdr_encode_rle_channel(c)
                      == hdr._encode_rle_channel_py(c) for c in chans),
                  f"{name}: native RLE encode")
            return {"hdr_decode_scanlines": int(got.size),
                    "hdr_encode_rle_channel": int(chans.size)}
        if name == "piz.exr":
            raw = np.ascontiguousarray(packing._f32_to_half(
                torch.from_numpy(np.asarray(corpus["hdr_china"][:32, :64],
                                            np.float32))).numpy()
                .astype(np.uint16)).reshape(-1)
            stream = exr_piz.huf_compress(raw)
            check(stream == exr_piz._huf_compress_py(raw)
                  and np.array_equal(exr_piz.huf_uncompress(stream, raw.size),
                                     exr_piz._huf_uncompress_py(stream,
                                                                raw.size)),
                  f"{name}: native PIZ Huffman")
            return {"piz_huffman": int(raw.size)}
        if name == "rle.exr":
            line = np.frombuffer(data, np.uint8)[-8 * exr_size:]
            check(exr._rle_encode(line) == exr._rle_encode_py(line),
                  f"{name}: RLE encode")
            return {"exr_rle_encode": int(line.size)}
        return {}

    loads, loaded = {}, {}
    for name, data in files.items():
        parse, decode = stages[os.path.splitext(name)[1]]
        payload, plan = parse(data)
        payload_d = torch.from_numpy(payload).to(dev)
        tex, counts = pr.counts_of(lambda: load_texture_bytes(
            name, data, dev))
        check(counts == {}, f"{name}: the load launched {counts}")
        cpu = load_texture_bytes(name, data, "cpu")
        check(tex.device == dev and all(
            torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
            for a, b in zip(tex.levels, cpu.levels))
            and tex.metadata == cpu.metadata,
            f"{name}: the card's load differs from the CPU's")
        check(bool(torch.isfinite(tex.levels[0]).all()), f"{name}: finite")
        t0 = time.perf_counter()
        again = saved(tex, name)
        save_s = time.perf_counter() - t0
        check(again == saved(Probe.cpu_tex(tex), name),
              f"{name}: the card's save differs from the CPU port's")
        # an EXR load takes 0.1-0.9 s, nearly all of it the host parse:
        # FILE_REPS runs of its parse and its load, 7 of the rest
        reps = FILE_REPS if name.endswith(".exr") else 7
        ms = {"host_parse": pr.host_timed(lambda: parse(data), reps),
              "h2d": pr.timed(lambda: torch.from_numpy(payload).to(dev)),
              "device_decode": pr.timed(lambda: decode(payload_d, plan)),
              "load": pr.timed(lambda: load_texture_bytes(name, data, dev),
                               reps)}
        parts = {k: ms[k]["median"] for k in ("host_parse", "h2d",
                                              "device_decode")}
        total = ms["load"]["median"]
        loads[name] = {
            "bytes": len(data), "payload_bytes": int(payload.nbytes),
            "shape": list(tex.levels[0].shape), "ms": ms,
            "share_of_load": {k: v / total for k, v in parts.items()},
            "host_syncs": pr.host_syncs(lambda: load_texture_bytes(
                name, data, dev)),
            "save_s": save_s, "save_bytes_equal_cpu": True,
            "twins": twins(name, data)}
        loaded[name] = tex
        del payload_d
    env = loaded["env.hdr"].levels[0][0]
    e = torch.frexp(env[..., :3].amax(-1).double())[1] + 128
    emit({"phase": "containers", "card": smi, "files": loads,
          "load_bit_equal_cpu": True, "hdr_exponent_bytes": [
              int(e[env[..., :3].amax(-1) > 0].min()), int(e.max())],
          "seconds": time.perf_counter() - t_start})

    # 38. texconv over the folder -------------------------------------------
    t_batch = time.perf_counter()
    calls = []
    real_many = ops.compress_many

    def counting_many(texs, *a, **k):
        calls.append(len(texs))
        return real_many(texs, *a, **k)

    def run(args, paths, out):
        """texconv.main on the card: (rc, stdout, stderr, launches, s)."""
        o, e = _io.StringIO(), _io.StringIO()
        calls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            rc, counts = pr.counts_of(lambda: texconv.main(
                ["-nologo", "-y", *args, "-o", out, *paths], device=dev))
        secs = time.perf_counter() - t0
        check(rc == 0 and "FAILED" not in o.getvalue() + e.getvalue(),
              f"texconv {args}: rc {rc}\n{o.getvalue()}\n{e.getvalue()}")
        return o.getvalue(), counts, secs

    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, data in files.items():
            paths[name] = os.path.join(tmp, name)
            with open(paths[name], "wb") as f:
                f.write(data)
        tgas = [paths[n] for n in files if n.endswith(".tga")]
        hdrs = [paths[n] for n in files if not n.endswith(".tga")]
        ops.compress_many = counting_many
        dds_out = {}
        try:
            groups = {}
            for key, fmt, srcs, want in (
                    ("bc7", "BC7_UNORM_SRGB", tgas,
                     ["bc7_encode", "bc7_alpha_list", "bc7_mode7",
                      "bc7_mode_buckets", "bc7_refine_alpha"]),
                    ("bc6h", "BC6H_UF16", hdrs, ["bc6h_encode"])):
                out_dir = os.path.join(tmp, key)
                args = ["-f", fmt, "-m", "0"]
                _, counts, secs = run(args, srcs, out_dir)
                pr.need(counts, want, f"texconv {key}")
                check(calls == [len(srcs)], f"texconv {key}: compress_many "
                      f"calls {calls} (one per format and flags)")
                enc = "bc7_encode" if key == "bc7" else "bc6h_encode"
                check(counts.get(enc) == 1, f"texconv {key}: {counts}")
                syncs = pr.host_syncs(lambda: texconv.main(
                    ["-nologo", "-y", *args, "-o", out_dir, *srcs],
                    device=dev))
                outputs = {}
                for src in srcs:
                    name = os.path.basename(src)
                    ddsp = os.path.join(out_dir,
                                        os.path.splitext(name)[0] + ".dds")
                    with open(ddsp, "rb") as f:
                        raw = f.read()
                    dds_out[name] = raw
                    ct = dds.load_from_dds_memory(raw, device=dev)
                    check(isinstance(ct, CompressedTexture)
                          and ct.metadata.format == getattr(FMT, fmt),
                          f"{name}: output format")
                    dec, dcounts = pr.counts_of(lambda: decompress(ct))
                    pr.need(dcounts, ["bc7_decode" if key == "bc7"
                                      else "bc6h_decode"], f"{name} decode")
                    chain = ops.generate_mipmaps(loaded[name])
                    if key == "bc7":
                        psnr = [float(compute_psnr(a, b)) for a, b in
                                zip(dec.levels, chain.levels)]
                    else:
                        psnr = [log_psnr(a[0].cpu().numpy(),
                                         b[0].cpu().numpy())
                                for a, b in zip(dec.levels, chain.levels)]
                    check(all(np.isfinite(psnr)) and psnr[0] > (
                        30.0 if key == "bc7" else 25.0),
                          f"{name}: PSNR per level {psnr}")
                    outputs[name] = {
                        "dds_bytes": len(raw), "levels": ct.mip_levels,
                        "blocks": sum(int(lvl.numel()) // 16
                                      for lvl in ct.levels),
                        "psnr_per_level": psnr}
                    if name == "rgba_rle.tga":
                        direct = ops.compress(ops.generate_mipmaps(
                            loaded[name]), FMT.BC7_UNORM_SRGB)
                        check(torch.equal(ct.levels[0], direct.levels[0]),
                              "texconv's level 0 differs from compress() "
                              "of the loaded texture")
                        outputs[name]["level0_equals_compress"] = True
                groups[key] = {"files": len(srcs), "launches": counts,
                               "compress_many_calls": 1,
                               "blocks": sum(o["blocks"]
                                             for o in outputs.values()),
                               "batch_s": secs, "host_syncs": syncs,
                               "outputs": outputs}

            # -timing: the serial path, each stage's synchronize counted
            syncs_seen = []
            real_sync = torch.cuda.synchronize

            def counting_sync(device=None):
                syncs_seen.append(device)
                real_sync(device)

            torch.cuda.synchronize = counting_sync
            try:
                text, _, secs = run(["-f", "BC7_UNORM_SRGB", "-m", "0",
                                     "-timing"], tgas,
                                    os.path.join(tmp, "timing"))
            finally:
                torch.cuda.synchronize = real_sync
            rows = [ln.strip() for ln in text.splitlines() if "[" in ln]
            check(len(rows) == len(tgas) and all(
                "compress" in r and "mipmaps" in r for r in rows),
                f"-timing rows {rows}")
            # the stage marks with a texture (load, mipmaps, compress)
            # each synchronize on its device
            marks = sum(d is not None for d in syncs_seen)
            check(marks == 3 * len(tgas),
                  f"-timing synchronized {marks} times on a device")
            timing_rec = {"rows": rows, "synchronizes": marks,
                          "s": secs, "compress_many_calls": len(calls)}

            prof_dir = os.path.join(tmp, "prof")
            _, counts, secs = run(["-f", "BC6H_UF16", "-m", "0", "-profile",
                                   prof_dir], [paths["env.hdr"]],
                                  os.path.join(tmp, "p"))
            with open(os.path.join(prof_dir, "trace.json"), "rb") as f:
                trace = f.read()
            check(len(trace) > 0 and b'"kernel"' in trace,
                  "-profile: no kernels in the trace")
            profile_rec = {"trace_bytes": len(trace), "s": secs,
                           "launches": counts}

            _, counts, secs = run(["-f", "R16G16B16A16_FLOAT", "-ft", "exr"],
                                  [paths["env.hdr"], paths["map.pfm"]],
                                  os.path.join(tmp, "exr"))
            check(counts == {} and calls == [],
                  f"-ft exr launched {counts}, compress_many {calls}")
            for name in ("env.hdr", "map.pfm"):
                back = load_texture(os.path.join(
                    tmp, "exr", os.path.splitext(name)[0] + ".exr"),
                    device=dev)
                src = loaded[name].levels[0]
                want = packing._half_to_f32(packing._f32_to_half(src))
                check(torch.equal(back.levels[0].view(torch.int32),
                                  want.view(torch.int32)),
                      f"{name} -> EXR: not the source rounded to half")
            exr_rec = {"s": secs, "files": 2}
        finally:
            ops.compress_many = real_many
    emit({"phase": "texconv_batch", "card": smi, "groups": groups,
          "timing_run": timing_rec, "profile_run": profile_rec,
          "exr_run": exr_rec, "no_failed_lines": True,
          "seconds": time.perf_counter() - t_batch,
          "phases_37_38_seconds": time.perf_counter() - t_start})
    return {"files": files, "dds": dds_out}


def run_tool(mod, argv, device) -> tuple:
    """A tool's main(argv, device) with its output captured: (rc, stdout,
    stderr). Options go before the command: an older argparse refuses the
    input files after an option that follows it."""
    import contextlib
    import io as _io

    o, e = _io.StringIO(), _io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        try:
            rc = mod.main(["-nologo", *argv], device=device)
        except SystemExit as exit_:     # argparse refused the arguments
            rc = exit_.code
    return rc, o.getvalue(), e.getvalue()


def dir_bytes(path: str) -> dict:
    """{file name: bytes} of a directory's files."""
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def numbers_close(card: str, cpu: str, what: str) -> int:
    """Printed lines of the card and the CPU port: the same text around the
    numbers, each number within 1e-5 relative + 1e-9 of the CPU's (0.01
    for a PSNR, its last printed digit). Returns the lines whose text
    differs."""
    import re

    num = re.compile(r"-?\d+\.\d+")
    a, b = card.splitlines(), cpu.splitlines()
    check(len(a) == len(b), f"{what}: {len(a)} lines vs {len(b)}")
    differ = 0
    for x, y in zip(a, b):
        check(num.sub("#", x) == num.sub("#", y), f"{what}: {x!r} vs {y!r}")
        for u, v in zip(map(float, num.findall(x)),
                        map(float, num.findall(y))):
            lim = 0.01 if "PSNR" in x else 1e-5 * abs(v) + 1e-9
            check(abs(u - v) <= lim, f"{what}: {x!r} vs {y!r}")
        differ += x != y
    return differ


def tool_phases(torch, dev, event_ms, smi, folder: dict,
                view_mip: int = 1, target: tuple = (517, 301)) -> None:
    """Phases 39-40: texassemble, ddsview and texdiag on the card, each
    command through its main(argv, device) as a user calls it, its output
    files and printed lines held against the CPU port's on the same input.
    39: six faces from phase 37's TGAs -> cube (a DDS) -> h-cross ->
    cube-from-hc and v-cross-fnz -> cube-from-vc-fnz (the faces back bit
    for bit), cube-from-mips over each face's full chain saved as one file
    a level, merge of two faces with a swizzle, texconv of the cube to
    BC7_UNORM with its mips (K2, mode 7, K3), and ddsview -m view_mip of
    that BC7 cube (K1); 40: texdiag's info, analyze, analyzebc, compare
    (the source against the DDS), diff -c, dumpbc -targetx/-targety and
    dumpdds over phase 38's BC7_UNORM_SRGB and BC6H_UF16 files (K1, K4),
    every file's lines and files held against the CPU port's (which reads
    the card's decode of a file where the command decodes all of it, but
    for one BC7 and one BC6H file).
    Each command's CUDA-event time after a warm-up (median [min-max] of 7;
    of 3 (FILE_REPS) for the commands that read or write 100-200 MB of
    files, compare, diff and dumpdds; one run of ddsview, whose PNG encode
    takes seconds, and of compare and diff with an EXR source), its host
    syncs and its hand-kernel launches (counts
    set to 0 just before it, read just after)."""
    import dataclasses
    import shutil
    import tempfile

    from directxtex_tpu_torch.io import dds, tga
    from directxtex_tpu_torch.ops import (compress, decompress,
                                          generate_mipmaps)
    from directxtex_tpu_torch.formats import FMT
    from directxtex_tpu_torch.texture import Texture
    from directxtex_tpu_torch.tools import (ddsview, texassemble, texconv,
                                            texdiag)

    pr = Probe(torch, event_ms)
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp()
    try:
        def step(mod, argv_of, out: str, reps: int = 7, cpu: bool = True,
                 cpu_argv_of=None):
            """mod on the card (output under card/out) and, where `cpu`,
            on the CPU (under cpu/out, with cpu_argv_of's arguments where
            given): the record, the output paths and both runs' (rc,
            stdout, stderr). Equal files and lines are checked by the
            caller. -y where the tool has it (not ddsview)."""
            paths = {}
            for side in ("card", "cpu"):
                d = os.path.join(tmp, side)
                os.makedirs(d, exist_ok=True)
                paths[side] = os.path.join(d, out)
            yes = [] if mod is ddsview else ["-y"]
            argv = [*yes, *argv_of(paths["card"])]
            res, counts = pr.counts_of(lambda: run_tool(mod, argv, dev))
            check(res[0] == 0 and "FAILED" not in res[1] + res[2],
                  f"{mod.__name__} {argv}: {res}")
            syncs = pr.host_syncs(lambda: run_tool(mod, argv, dev))
            ms = pr.spread(event_ms(lambda: run_tool(mod, argv, dev), reps))
            rec = {"ms": ms, "runs": reps, "host_syncs": syncs,
                   "launches": counts}
            cpu_res = None
            if cpu:
                cpu_res = run_tool(mod, [*yes, *(cpu_argv_of or argv_of)(
                    paths["cpu"])], "cpu")
                check(cpu_res[0] == 0, f"{mod.__name__} on the CPU: "
                      f"{cpu_res}")
            return rec, paths, res, cpu_res

        def same_file(paths, what):
            with open(paths["card"], "rb") as f:
                a = f.read()
            with open(paths["cpu"], "rb") as f:
                b = f.read()
            check(a == b, f"{what}: the card's file differs from the CPU "
                  f"port's")
            return len(a)

        # 39. texassemble and ddsview -------------------------------------
        files = folder["files"]
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        faces = []
        for k, name in enumerate(("rgba_rle.tga", "opaque_rle.tga",
                                  "rgba_raw.tga", "opaque_24.tga",
                                  "rgba_raw.tga", "opaque_24.tga")):
            data = files[name]
            if k >= 4:      # two more faces: the raw files flipped
                t = tga.load_from_tga_memory(data, device="cpu")
                data = tga.save_to_tga_memory(t.replace_levels(
                    [torch.flip(t.levels[0], (1, 2))], t.metadata))
            faces.append(os.path.join(src, f"face{k}.tga"))
            with open(faces[-1], "wb") as f:
                f.write(data)
        rec39 = {}
        rec, cube, _, _ = step(texassemble, lambda o: ["-o", o, "cube",
                                                       *faces], "cube.dds",
                               FILE_REPS)
        rec["bytes"] = same_file(cube, "cube")
        rec39["cube"] = rec
        ref = dds.load_from_dds_file(cube["card"], device=dev).levels[0]
        for layout, inverse in (("h-cross", "cube-from-hc"),
                                ("v-cross-fnz", "cube-from-vc-fnz")):
            rec, lay, _, _ = step(texassemble, lambda o: [
                "-o", o, layout, cube["card"]], f"{layout}.dds", FILE_REPS)
            rec["bytes"] = same_file(lay, layout)
            rec39[layout] = rec
            rec, back, _, _ = step(texassemble, lambda o: [
                "-o", o, inverse, lay["card"]], f"{inverse}.dds", FILE_REPS)
            rec["bytes"] = same_file(back, inverse)
            got = dds.load_from_dds_file(back["card"], device=dev)
            check(got.metadata.is_cubemap() and torch.equal(
                got.levels[0], ref), f"{layout} -> {inverse}: the faces "
                "differ from the cube's")
            rec["faces_bit_equal"] = True
            rec39[inverse] = rec
        # cube-from-mips: each face's chain, one TGA a level, face-major
        levels = []
        for k, face in enumerate(faces):
            chain = generate_mipmaps(tga.load_from_tga_memory(
                open(face, "rb").read(), device=dev))
            for m, lvl in enumerate(chain.levels):
                p = os.path.join(src, f"face{k}_mip{m:02d}.tga")
                with open(p, "wb") as f:
                    f.write(tga.save_to_tga_memory(Texture.from_array(
                        lvl[0], chain.metadata.format, device=dev)))
                levels.append(p)
        rec, cfm, _, _ = step(texassemble, lambda o: [
            "-o", o, "cube-from-mips", *levels], "cube_mips.dds", FILE_REPS)
        rec["bytes"] = same_file(cfm, "cube-from-mips")
        rec["inputs"] = len(levels)
        rec39["cube-from-mips"] = rec
        rec, mrg, _, _ = step(texassemble, lambda o: [
            "--swizzle", "rGbA", "-o", o, "merge", faces[0], faces[1]],
            "merge.dds", FILE_REPS)
        rec["bytes"] = same_file(mrg, "merge")
        rec39["merge"] = rec
        # texconv -> BC7 with mips (K2, mode 7, K3), then ddsview of it (K1)
        bcdir = os.path.join(tmp, "bc7")
        rec, _, _, _ = step(texconv, lambda o: [
            "-f", "BC7_UNORM", "-m", "0", "-o", bcdir, cube["card"]],
            "unused", FILE_REPS, cpu=False)
        pr.need(rec["launches"], ["bc7_encode", "bc7_alpha_list",
                                  "bc7_mode7", "bc7_refine_alpha"],
                "texconv cube -> BC7")
        bc7 = os.path.join(bcdir, "cube.dds")
        ct = dds.load_from_dds_file(bc7, device=dev)
        direct = compress(generate_mipmaps(dds.load_from_dds_file(
            cube["card"], device=dev)), FMT.BC7_UNORM)
        check(torch.equal(ct.levels[0], direct.levels[0]),
              "texconv's cube level 0 differs from compress()")
        rec["blocks"] = sum(int(lvl.numel()) // 16 for lvl in ct.levels)
        rec39["texconv_bc7"] = rec
        rec, view, _, _ = step(ddsview, lambda o: [
            "-m", str(view_mip), "-o", o, bc7], "view.png", 1, cpu=False)
        pr.need(rec["launches"], ["bc7_decode"], "ddsview BC7 cube")
        # the CPU port renders the same level from a DDS of that level
        # alone (its other levels would only be decoded and dropped)
        one = type(ct)(dataclasses.replace(
            ct.metadata, width=ct.metadata.width >> view_mip,
            height=ct.metadata.height >> view_mip, mip_levels=1),
            [ct.levels[view_mip].cpu()])
        lvl_path = os.path.join(tmp, "bc7_level.dds")
        dds.save_to_dds_file(one, lvl_path)
        check(run_tool(ddsview, ["-o", view["cpu"], lvl_path], "cpu")[0]
              == 0, "ddsview on the CPU")
        rec["bytes"] = same_file(view, "ddsview")
        from PIL import Image
        rec["png_size"] = list(Image.open(view["card"]).size)
        rec39["ddsview"] = rec
        emit({"phase": "assemble_view", "card": smi, "steps": rec39,
              "outputs_equal_cpu": True,
              "seconds": time.perf_counter() - t_start})

        # 40. texdiag over phase 38's files -------------------------------
        t40 = time.perf_counter()
        outs = os.path.join(tmp, "dds")
        os.makedirs(outs)
        sources = {}
        for name, data in folder["dds"].items():
            p = os.path.join(outs, os.path.splitext(name)[0] + ".dds")
            with open(p, "wb") as f:
                f.write(data)
            sources[p] = os.path.join(src, name)
            with open(sources[p], "wb") as f:
                f.write(files[name])
        # the CPU port decodes every block on the host, slowly: the
        # commands that decode the whole file run there on one BC7 and one
        # BC6H file as given, and on the others from the card's decode of
        # the file (one D2H copy), written as an f32 DDS (bit-exact) and,
        # for compare's sRGB flags, in the decompressed format (an 8-bit
        # sRGB level reloads within 1 ulp, inside numbers_close's bound)
        decode_cpu = {os.path.join(outs, "rgba_rle.dds"),
                      os.path.join(outs, "map.dds")}
        dec_dir = os.path.join(tmp, "decoded")
        os.makedirs(dec_dir)

        def decoded_inputs(p, base):
            d = decompress(dds.load_from_dds_file(p, device=dev))
            d = type(d)(d.metadata, [lvl.cpu() for lvl in d.levels])
            exact = os.path.join(dec_dir, f"{base}.dds")
            native = os.path.join(dec_dir, f"{base}_native.dds")
            dds.save_to_dds_file(type(d)(d.metadata.with_format(
                FMT.R32G32B32A32_FLOAT), d.levels), exact)
            dds.save_to_dds_file(d, native)
            back = dds.load_from_dds_file(exact, device="cpu")
            check(all(torch.equal(a, b) for a, b in zip(back.levels,
                                                        d.levels)),
                  f"{base}: the decoded f32 DDS does not reload exactly")
            return exact, native

        rec40 = {}
        text_differ = 0
        for p, srcp in sources.items():
            base = os.path.splitext(os.path.basename(p))[0]
            fmt_rec = {}
            bc6 = "BC6H" in dds.get_metadata_from_dds_memory(
                open(p, "rb").read()).format.name
            kern = "bc6h_decode" if bc6 else "bc7_decode"
            exact, native = ((p, p) if p in decode_cpu
                             else decoded_inputs(p, base))
            # compare and diff load the source too: an EXR's host parse
            # takes 0.1-0.9 s, so one timed run
            src_reps = 1 if srcp.endswith(".exr") else FILE_REPS
            for cmd, argv_of, cpu_in, reps, decodes in (
                    ("info", lambda o, f: ["info", f], p, 7, False),
                    ("analyzebc", lambda o, f: ["analyzebc", f], p, 7,
                     False),
                    ("dumpbc", lambda o, f: ["-targetx", str(target[0]),
                                             "-targety", str(target[1]),
                                             "dumpbc", f], p, 7, True),
                    ("analyze", lambda o, f: ["analyze", f], exact, 7,
                     True),
                    ("compare", lambda o, f: ["compare", srcp, f], native,
                     src_reps, True),
                    ("diff", lambda o, f: ["-c", "FF00FF", "-t", "0.05",
                                           "-o", o, "diff", srcp, f],
                     exact, src_reps, True),
                    ("dumpdds", lambda o, f: ["-ft", "dds", "-o", o,
                                              "dumpdds", f], exact,
                     FILE_REPS, True)):
                out = (f"{base}_diff.dds" if cmd == "diff"
                       else os.path.join(f"{base}_dump", base)
                       if cmd == "dumpdds" else "unused")
                for side in ("card", "cpu"):
                    os.makedirs(os.path.join(tmp, side, f"{base}_dump"),
                                exist_ok=True)
                rec, paths, res, cres = step(
                    texdiag, lambda o: argv_of(o, p), out, reps=reps,
                    cpu_argv_of=lambda o: argv_of(o, cpu_in))
                if decodes:
                    pr.need(rec["launches"], [kern], f"texdiag {cmd} {base}")
                a = res[1].replace(os.path.join(tmp, "card"), "#")
                b = cres[1].replace(os.path.join(tmp, "cpu"), "#")
                if cmd in ("analyze", "compare"):
                    rec["lines_text_differ"] = numbers_close(
                        a, b, f"texdiag {cmd} {base}")
                    text_differ += rec["lines_text_differ"]
                else:
                    check(a == b, f"texdiag {cmd} {base}: lines differ "
                          f"from the CPU port's\n{a}\n{b}")
                if cmd == "diff":
                    rec["bytes"] = same_file(paths, f"diff {base}")
                if cmd == "dumpdds":
                    got = dir_bytes(os.path.dirname(paths["card"]))
                    want = dir_bytes(os.path.dirname(paths["cpu"]))
                    check(got == want and len(got) > 1,
                          f"dumpdds {base}: files differ")
                    rec["surfaces"] = len(got)
                rec["cpu_input"] = ("as given" if cpu_in == p
                                    else "the card's decode")
                fmt_rec[cmd] = rec
            rec40[base] = fmt_rec
        emit({"phase": "texdiag", "card": smi, "files": rec40,
              "lines_with_text_differences": text_differ,
              "seconds": time.perf_counter() - t40,
              "phases_39_40_seconds": time.perf_counter() - t_start})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parallel_phase(torch, dev, event_ms, smi, folder: dict,
                   size: int = SLICE_SIZE, field: int = 8192,
                   crop: int = 512, hdr_side: int = 1024) -> None:
    """Phase 41: parallel/ on the card. The library: compress_library over
    phase 37's four TGAs into BC7_UNORM without and with mips on a mesh of
    one entry (one encoder call: K2, mode 7, K3), its words equal to
    encode_bc7 of each image's blocks (every level's, concatenated), and
    over the PFM and the HDR resized to hdr_side^2 into BC6H_UF16 (K5).
    Sharding on one card, a mesh of ("cuda:0",) * 4: sharded_normal_map of
    a field^2 height field (wrap and mirror_v) bit-equal to a one-entry
    mesh and, on a crop^2 crop, to the CPU port; halo_exchange_rows at
    halo 1 and 3 (wrap and clamp) equal to the padded whole image;
    sharded_box_mip of the field^2 RGBA map bit-equal to one shard;
    sharded_mse of two maps (one flipped) within 1e-6 relative of
    compute_mse's channel mean; and
    sharded_compress_fn(encode_bc7) over 4 shards of the bench image's
    blocks, its words equal to the unsharded encode. CUDA-event times
    (median [min-max] of 7 after a warm-up), hand-kernel launches, host
    syncs, CUDA kernels and device ms (a profiler record a call)."""
    import tempfile

    from directxtex_tpu_torch import parallel
    from directxtex_tpu_torch.bc import bc6h, bc67
    from directxtex_tpu_torch.bc.common import image_to_blocks
    from directxtex_tpu_torch.formats import FMT
    from directxtex_tpu_torch.ops import compute_mse
    from directxtex_tpu_torch.parallel.library import _box_chain
    from directxtex_tpu_torch.parallel.sharding import gather

    pr = Probe(torch, event_ms)
    t_start = time.perf_counter()
    mesh1 = parallel.make_mesh([dev])
    mesh4 = parallel.make_mesh([dev] * 4)
    cpu4 = parallel.make_mesh(["cpu"] * 4)

    def timed_step(fn, profiled: bool = False):
        """fn()'s result and its record: CUDA-event ms, host syncs,
        hand-kernel launches, and where `profiled` its CUDA kernels and
        device ms from a profiler record of one call."""
        out, counts = pr.counts_of(fn)
        rec = {"ms": pr.timed(fn), "host_syncs": pr.host_syncs(fn),
               "launches": counts}
        if profiled:
            rec["cuda_kernels"], rec["device_ms"] = kernels_and_ms(
                profile_calls(torch, {"step": fn}, required=False)["step"])
        return out, rec

    # the library ----------------------------------------------------------
    lib = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, data in folder["files"].items():
            paths[name] = os.path.join(tmp, name)
            with open(paths[name], "wb") as f:
                f.write(data)
        tgas = [paths[n] for n in paths if n.endswith(".tga")]
        for mips in (False, True):
            outs, rec = timed_step(lambda: parallel.compress_library(
                tgas, FMT.BC7_UNORM, mesh1, size, size, mips=mips))
            check(rec["launches"].get("bc7_encode") == 1,
                  f"compress_library BC7 mips={mips}: {rec['launches']}")
            batch = parallel.load_library(tgas, size, size, device=dev)
            levels = _box_chain(batch) if mips else [batch]
            check(len(outs) == len(levels), "compress_library levels")
            for i in range(len(tgas)):
                blocks = [image_to_blocks(lvl[i])[0] for lvl in levels]
                want = bc67.encode_bc7(torch.cat(blocks)).cpu().numpy()
                got = np.concatenate([o[i] for o in outs])
                check(np.array_equal(got, want), f"compress_library image "
                      f"{i} mips={mips}: words differ from encode_bc7")
            rec["blocks"] = int(sum(o.shape[0] * o.shape[1] for o in outs))
            lib[f"bc7_mips_{mips}"] = rec
        hdrs = [paths["map.pfm"], paths["env.hdr"]]
        outs, rec = timed_step(lambda: parallel.compress_library(
            hdrs, FMT.BC6H_UF16, mesh1, hdr_side, hdr_side))
        pr.need(rec["launches"], ["bc6h_encode"], "compress_library BC6H")
        batch = parallel.load_library(hdrs, hdr_side, hdr_side, device=dev)
        for i in range(len(hdrs)):
            want = bc6h.encode_bc6h(image_to_blocks(batch[i])[0],
                                    signed=False).cpu().numpy()
            check(np.array_equal(outs[0][i], want),
                  f"compress_library BC6H image {i}: words differ")
        rec["blocks"] = int(outs[0].shape[0] * outs[0].shape[1])
        lib["bc6h"] = rec
        del batch

    # sharding on one card -------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(41)
    height = torch.rand((field, field), generator=gen, device=dev)
    shard = {}
    maps = {}
    for mirror_v in (False, True):
        fn4 = parallel.sharded_normal_map(mesh4, 2.0, mirror_v=mirror_v)
        fn1 = parallel.sharded_normal_map(mesh1, 2.0, mirror_v=mirror_v)
        out4, rec4 = timed_step(lambda: fn4(height), True)
        out1, rec1 = timed_step(lambda: fn1(height), True)
        check(len(out4) == 4 and torch.equal(
            torch.cat(out4).view(torch.int32), out1[0].view(torch.int32)),
            f"normal map mirror_v={mirror_v}: 4 shards differ from 1")
        hc = height[:crop, :crop].contiguous()
        card = torch.cat(parallel.sharded_normal_map(
            mesh4, 2.0, mirror_v=mirror_v)(hc)).cpu()
        cpu = torch.cat(parallel.sharded_normal_map(
            cpu4, 2.0, mirror_v=mirror_v)(hc.cpu()))
        check(torch.equal(card.view(torch.int32), cpu.view(torch.int32)),
              f"normal map mirror_v={mirror_v}: the card differs from the "
              f"CPU port on the {crop}^2 crop")
        maps[mirror_v] = out1[0]
        del out4, out1
        shard[f"normal_map_mirror_v_{mirror_v}"] = {
            "4_shards": rec4, "1_shard": rec1,
            "halo_cost_ms": rec4["ms"]["median"] - rec1["ms"]["median"]}
    for halo in (1, 3):
        for wrap in (True, False):
            parts = parallel.rows_sharding(mesh4).place(height)
            slabs, rec = timed_step(lambda: parallel.halo_exchange_rows(
                parts, halo, wrap=wrap), True)
            if wrap:
                padded = torch.cat([height[-halo:], height, height[:halo]])
            else:
                padded = torch.cat([height[:1].expand(halo, field), height,
                                    height[-1:].expand(halo, field)])
            rows = field // 4
            check(all(torch.equal(s, padded[i * rows:(i + 1) * rows
                                             + 2 * halo])
                      for i, s in enumerate(slabs)),
                  f"halo {halo} wrap={wrap}: not the padded image")
            del slabs, padded
            shard[f"halo_{halo}_wrap_{wrap}"] = rec
    rgba = maps[False]
    mip4, rec4 = timed_step(lambda: parallel.sharded_box_mip(mesh4)(rgba),
                            True)
    mip1, rec1 = timed_step(lambda: parallel.sharded_box_mip(mesh1)(rgba),
                            True)
    check(torch.equal(torch.cat(mip4).view(torch.int32),
                      mip1[0].view(torch.int32)),
          "box mip: 4 shards differ from 1")
    shard["box_mip"] = {"4_shards": rec4, "1_shard": rec1}
    del mip4, mip1
    other = torch.flip(maps[True], (0,))
    mse4, rec = timed_step(lambda: parallel.sharded_mse(mesh4)(
        maps[False], other), True)
    _, mse_v = compute_mse(maps[False], other)
    want = float(mse_v.mean())
    check(abs(float(mse4) - want) <= 1e-6 * want,
          f"sharded_mse {float(mse4)} vs compute_mse {want}")
    rec["mse"] = [float(mse4), want]
    shard["mse"] = rec
    del maps, rgba, height, other
    blocks2k = image_to_blocks(torch.from_numpy(bench_image(size)).to(dev))[0]
    enc4, rec4 = timed_step(lambda: parallel.sharded_compress_fn(
        bc67.encode_bc7, mesh4)(blocks2k))
    enc1, rec1 = timed_step(lambda: bc67.encode_bc7(blocks2k))
    check(torch.equal(gather(enc4), enc1), "sharded encode_bc7: words "
          "differ from the unsharded encode")
    check(rec4["launches"].get("bc7_encode") == 4,
          f"sharded encode: {rec4['launches']}")
    shard["encode_bc7"] = {"4_shards": rec4, "unsharded": rec1,
                           "blocks": int(blocks2k.shape[0])}
    emit({"phase": "parallel", "card": smi, "library": lib,
          "sharding": shard,
          "field": field, "mesh": [str(d) for d in mesh4.devices],
          "seconds": time.perf_counter() - t_start})


def load_texture_bytes(name: str, data: bytes, device):
    """The port's loader for a file name's extension, on bytes."""
    from directxtex_tpu_torch.io import exr, hdr, ppm, tga

    ext = os.path.splitext(name)[1]
    if ext == ".tga":
        return tga.load_from_tga_memory(data, device=device)
    if ext == ".hdr":
        return hdr.load_from_hdr_memory(data, device=device)
    if ext == ".exr":
        return exr.load_from_exr_memory(data, device=device)
    return ppm.load_from_pfm_memory(data, device=device)


if __name__ == "__main__":
    main()
