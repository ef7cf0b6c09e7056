#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one GPU.

Drives the port's paths through their hand-written CUDA kernels and holds
every kernel against its plain PyTorch twin on the card:

- the BC7 default tier (image_to_blocks -> encode_bc7 -> decode_bc7): K1
  decode, K2 search, K3 MOMENT refine; on opaque images (K2's opaque
  variant), on images with alpha (K2's alpha variant with mode 7, K3 with
  mode 7 in scope), at alpha weights 1.0 and 2.0, and the QUICK tier (K2's
  quick variant, mode 6 alone);
- the BC7 MAXQUALITY tier (encode_bc7(flags=0x200000)): K2's maxq
  variants (every mode fitted on its own, with and without mode 7), K3
  twice, MOMENT with mode 6 in scope, then the exact LADDER_FULL;
- BC6H (BASELINE config 4, hdr_cubemap_pipeline -> decode_bc6h, and the
  mid / maxq tiers of encode_bc6h): K4 decode, K5 search, K6 refine.

Phases:

  0. device: the card's name and power limit, torch, CUDA and nvcc;
  1. build: nvcc builds the kernels from directxtex_tpu_torch/csrc; ptxas
     registers, stack and spills per kernel instance;
  2. K1: bit-exact on tests/golden/decode_vectors.npz and equal to the
     plain decode on 262,144 random mixed-mode words;
  3. K2: kernel search vs plain search on bench512.npz and the opaque
     corpus.npz contents, under the near-tie rule;
  4. K3: kernel refine vs plain refine on the same input words: equal;
  5. 512^2 gate: encode_bc7 -> decode_bc7 PSNR >= the frozen reference's;
  6. the 2048^2 bench image through the BC7 path, with launch counts,
     CUDA-event times of the path and of each kernel, and one run of the
     plain path on the same inputs, held against the kernels' output;
  7. K4: bit-exact on the golden BC6H vectors (unsigned and signed) and
     equal to the plain decode on 262,144 random words per mode;
  8. K5 and K6 (mid, maxq): kernel vs plain on the five HDR corpus
     contents and the 200-block random / bimodal set, unsigned and
     signed: words equal, and K5's search errors equal;
  9. BC6H gates: the corpus PSNR floors and the frozen reference's
     bc6h_hdr_psnr through encode_bc6h -> decode_bc6h on the card;
 10. config 4 at face 512: the path with launch counts and CUDA-event
     times, each kernel's time at the path's shapes, one run of each plain
     twin held against its kernel, and the mid / maxq tiers on the same
     faces;
 11. K2 alpha and K3 (mode 7 in scope) against their twins on alphagrad,
     the 200-block mixed set (half opaque) and the 2048^2 image with
     alpha, at alpha weights 1.0 and 2.0: words and search errors equal;
 12. K2 quick against its twin on bench512.npz and both 2048^2 images;
 13. BC7 gates on the card: the alphagrad corpus floor and the frozen
     reference parity of albedo, tworegion, normal and alphagrad;
 14. the 2048^2 image with alpha through the default path and the QUICK
     path (on both 2048^2 images), each with its launch counts, and
     CUDA-event times of the paths and kernels beside the opaque path's;
 15. K2 maxq (both variants) and K3 (MOMENT with mode 6 in scope, FULL,
     LIGHT, and mode 6 alone on QUICK's words) against their twins on
     bench512, the opaque corpus, alphagrad and the 200-block mixed set,
     at alpha weights 1.0 and 2.0: words and search errors equal;
 16. maxq gates on the card: PSNR no worse than the default tier's less
     0.001 dB on bench512 and every BC7 corpus content
     (tests/test_bc7.py:200-214), bench512 at least the frozen
     reference's, and a sample of the maxq words decoded by K1 equal to
     the plain decode;
 17. the maxq path at 2048^2 on the bench image and on the image with
     alpha, each with its launch counts (one K2, two K3), CUDA-event times
     of the paths and kernels beside the default tier's, and one run of
     each plain twin at the path's shapes held against its kernel;
 18. the kernels line: every kernel's launches, error against its twin,
     time, plain time and bound (bytes or operations, whichever is
     larger, at the H100's published peaks, for the work each block of
     the run needs).

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
    "bc7_encode": ("directxtex_tpu_torch/csrc/bc7_encode.cu",
                   "directxtex_tpu/bc/pallas_kernels.py:2020"),
    "bc7_refine": ("directxtex_tpu_torch/csrc/bc7_refine.cuh",
                   "directxtex_tpu/bc/pallas_kernels.py:2667"),
    "bc7_encode_alpha": ("directxtex_tpu_torch/csrc/bc7_encode.cuh",
                         "directxtex_tpu/bc/pallas_kernels.py:2020"),
    "bc7_encode_quick": ("directxtex_tpu_torch/csrc/bc7_encode.cuh",
                         "directxtex_tpu/bc/pallas_kernels.py:2020"),
    "bc7_refine_alpha": ("directxtex_tpu_torch/csrc/bc7_refine.cuh",
                         "directxtex_tpu/bc/pallas_kernels.py:2667"),
    "bc7_encode_maxq": ("directxtex_tpu_torch/csrc/bc7_encode.cuh",
                        "directxtex_tpu/bc/pallas_kernels.py:2020"),
    "bc7_encode_maxq_alpha": ("directxtex_tpu_torch/csrc/bc7_encode.cuh",
                              "directxtex_tpu/bc/pallas_kernels.py:2020"),
    "bc7_refine_maxq": ("directxtex_tpu_torch/csrc/bc7_refine.cuh",
                        "directxtex_tpu/bc/pallas_kernels.py:2667"),
    "bc7_refine_ladder": ("directxtex_tpu_torch/csrc/bc7_refine_ladder.cu",
                          "directxtex_tpu/bc/pallas_kernels.py:2667"),
    "bc6h_decode": ("directxtex_tpu_torch/csrc/bc6h_decode.cu",
                    "directxtex_tpu/bc/pallas_kernels.py:2784"),
    "bc6h_encode": ("directxtex_tpu_torch/csrc/bc6h_encode.cu",
                    "directxtex_tpu/bc/pallas_kernels.py:3744"),
    "bc6h_refine": ("directxtex_tpu_torch/csrc/bc6h_refine.cu",
                    "directxtex_tpu/bc/pallas_kernels.py:3704"),
}
# Operations each kernel's function needs per 4x4 block, as printed by
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_op_counts.py`:
# the JAX twins' elementwise operations without their lane masking, a
# two-region candidate's per-pixel work over its subsets' own 16 pixels.
# The searches do the same work for every block; the decoders and the
# refines do one mode's (one winner class's) work, weighed here by the
# blocks of the run that have it.
BC7_SEARCH_OPS = 89073
# K2's alpha variant on a block with alpha (an opaque block skips mode 7
# and costs BC7_SEARCH_OPS), and its quick variant
BC7_SEARCH_ALPHA_OPS = 112739
BC7_SEARCH_QUICK_OPS = 4641
BC6H_SEARCH_OPS = 173630
BC7_DECODE_OPS = (1461, 1337, 1557, 1295, 859, 816, 518, 1373)  # per mode
BC7_REFINE_OPS = {1: 5612, 3: 5432, 5: 4869, 7: 6336,
                  4: 6908, 6: 3402}            # others pass through
# K2's maxq variants: opaque blocks, and a block with alpha under the
# alpha variant (an opaque block skips mode 7 and costs the first)
BC7_SEARCH_MAXQ_OPS = 144081
BC7_SEARCH_MAXQ_ALPHA_OPS = 167747
# K3 under LADDER_FULL and LADDER_LIGHT, per winner mode
BC7_REFINE_FULL_OPS = {1: 12256, 3: 11692, 5: 13521, 6: 12134, 7: 15064,
                       4: 15624}
BC7_REFINE_LIGHT_OPS = {1: 6136, 3: 5908, 5: 6153, 6: 4822, 7: 6904,
                        4: 8200}
BC6H_DECODE_OPS = (1436, 1442, 1432, 1440, 1436, 1436, 1432, 1444, 1444,
                   1410, 598, 668, 680, 644)      # per mode row, unsigned
# the maxq refine of a one-region (rows 10-13) and a two-region winner
BC6H_REFINE_OPS = {"one_region": 815084, "two_region": 1294096}
# bytes each block must move, inputs read once and outputs written once at
# the data's own width: u8 texels, f16 pixels and halves, 16-byte words
BYTES_PER_BLOCK = {"bc7_decode": 16 + 64, "bc7_encode": 64 + 16,
                   "bc7_refine": 64 + 16 + 16, "bc6h_decode": 16 + 96,
                   "bc6h_encode": 96 + 16, "bc6h_refine": 96 + 16 + 16,
                   "bc7_encode_alpha": 64 + 16, "bc7_encode_quick": 64 + 16,
                   "bc7_refine_alpha": 64 + 16 + 16,
                   "bc7_encode_maxq": 64 + 16,
                   "bc7_encode_maxq_alpha": 64 + 16,
                   "bc7_refine_maxq": 64 + 16 + 16,
                   "bc7_refine_ladder": 64 + 16 + 16}
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
# the opaque BC7 path's times in PERF.md section 5 before the maxq tier
# was added (NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
EARLIER_OPAQUE_MS = {"path": 3.384, "bc7_encode": 1.961,
                     "bc7_refine": 0.833}
MAXQ = 0x200000            # encode_bc7's MAXQUALITY flag
MAXQ_GATE_SLACK = 0.001    # dB below the default tier (test_bc7.py:211)


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


def per_mode_ops(torch, modes, table: dict) -> float:
    """Operations of a run whose blocks have `modes` (a [NB] tensor) at
    table[mode] each, 0 for a mode not in the table (reserved modes)."""
    counts = torch.bincount(modes[modes >= 0].to(torch.int64)).tolist()
    return float(sum(n * table.get(m, 0) for m, n in enumerate(counts)))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    sys.path.insert(0, ROOT)
    from directxtex_tpu_torch import _build
    from directxtex_tpu_torch.bc import bc67, cuda_kernels
    from directxtex_tpu_torch.bc.common import image_to_blocks

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
    emit({"phase": "build", "seconds": build_s,
          "ptxas": ptxas_summary(_build.build_info["log"])})

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def px_of(blocks):
        """[NB, 16, 4] f32 on the card -> [64, NB] int32 texels."""
        return bc67._quantize_ldr(blocks).reshape(64, -1).contiguous()

    def block_sse(words, px):
        """Per-block decoded SSE of words [4, NB] against px [64, NB]."""
        d = (bc67._bc7_decode_plain(words) - px).to(torch.float64)
        return (d * d).sum(dim=0)

    def near_tie(w_a, w_b, px, what):
        """The near-tie rule: few blocks differ, those that do decode to
        nearly the same SSE, and the total SSE is no worse."""
        nb = px.shape[1]
        differ = (w_a != w_b).any(dim=0)
        n = int(differ.sum())
        check(n <= max(2, nb // 25), f"{what}: {n}/{nb} blocks differ")
        sa, sb = block_sse(w_a, px), block_sse(w_b, px)
        if n:
            da, db = sa[differ], sb[differ]
            check(bool(((da - db).abs() <= 4.0 + 2e-2 * db.abs()).all()),
                  f"{what}: per-block SSE of differing blocks")
        tot_a, tot_b = float(sa.sum()), float(sb.sum())
        check(tot_a <= tot_b * 1.001 + 1e-3, f"{what}: total SSE")
        return n, tot_a, tot_b

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
    rng = np.random.default_rng(2026)
    raw = rng.integers(0, 256, (RANDOM_BLOCKS, 16), dtype=np.uint8)
    raw[::97, 0] = 0                              # reserved mode
    words_r = to_dev(raw).view(torch.int32).t().contiguous()
    k1 = cuda_kernels.bc7_decode(words_r)
    p1 = bc67._bc7_decode_plain(words_r)
    check(torch.equal(k1, p1), "K1 vs plain on random words")
    emit({"phase": "K1", "golden_bit_exact": True, "random_blocks": RANDOM_BLOCKS,
          "random_equal": True})

    # 3-4. K2 and K3 on bench512 and the opaque corpus --------------------
    b512 = np.load(os.path.join(GOLDEN, "bench512.npz"))
    corpus = np.load(os.path.join(GOLDEN, "corpus.npz"))
    contents = [("bench512", b512["img"])] + [
        (c, corpus[c]) for c in OPAQUE_CORPUS]
    for label, img in contents:
        px = px_of(image_to_blocks(to_dev(img))[0])
        err_k, w_k = cuda_kernels.bc7_encode(px)
        err_p, w_p = bc67._bc7_search_plain(px)
        n, tot_k, tot_p = near_tie(w_k, w_p, px, f"K2 {label}")
        emit({"phase": "K2", "content": label, "blocks": px.shape[1],
              "words_differ": n, "sse_kernel": tot_k, "sse_plain": tot_p,
              "max_abs_err_diff": float((err_k - err_p).abs().max())})
        r_k = cuda_kernels.bc7_refine(px, w_k, bc67.REFINE_MODES)
        r_p = bc67._bc7_refine_plain(px, w_k, bc67.REFINE_MODES)
        n3 = int((r_k != r_p).any(dim=0).sum())
        check(n3 == 0, f"K3 {label}: {n3} blocks differ from plain refine")
        emit({"phase": "K3", "content": label, "blocks": px.shape[1],
              "words_equal": True,
              "refined_blocks": int((r_k != w_k).any(dim=0).sum())})

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
    counts = {k: v for k, v in cuda_kernels.launch_counts().items()
              if k in ("bc7_decode", "bc7_encode", "bc7_refine")}
    check(all(v > 0 for v in counts.values()), f"launch counts {counts}")
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
    k_ms = {
        "bc7_encode": float(np.median(event_ms(
            lambda: cuda_kernels.bc7_encode(px2k), 7))),
        "bc7_refine": float(np.median(event_ms(
            lambda: cuda_kernels.bc7_refine(px2k, w_search,
                                            bc67.REFINE_MODES), 7))),
        "bc7_decode": float(np.median(event_ms(
            lambda: cuda_kernels.bc7_decode(w_final), 7))),
    }
    # one run of each plain twin on the same inputs, held against the kernel
    out = {}
    plain_ms = {}
    plain_ms["bc7_encode"] = event_ms(
        lambda: out.update(search=bc67._bc7_search_plain(px2k)))[0]
    plain_ms["bc7_refine"] = event_ms(
        lambda: out.update(refine=bc67._bc7_refine_plain(
            px2k, w_search, bc67.REFINE_MODES)))[0]
    plain_ms["bc7_decode"] = event_ms(
        lambda: out.update(decode=bc67._bc7_decode_plain(w_final)))[0]
    n2k, _, _ = near_tie(w_search, out["search"][1], px2k, "K2 2048^2")
    check(torch.equal(out["refine"], w_final), "K3 2048^2 vs plain")
    k1_out = cuda_kernels.bc7_decode(w_final)
    check(torch.equal(out["decode"], k1_out), "K1 2048^2 vs plain")
    max_err = {
        "bc7_encode": float((err_k - out["search"][0]).abs().max()),
        "bc7_refine": float((out["refine"].to(torch.int64)
                             - w_final.to(torch.int64)).abs().max()),
        "bc7_decode": float((out["decode"] - k1_out).abs().max()),
    }
    mtexels = size * size / (enc_ms * 1e-3) / 1e6
    emit({"phase": "timing2k", "card": smi, "encode_ms": enc_ms,
          "encode_mtexels_per_s": mtexels, "kernel_ms": k_ms,
          "plain_ms": plain_ms, "search_words_differ_vs_plain": n2k,
          "earlier_ms": EARLIER_OPAQUE_MS})

    nb_of = {"bc7_decode": px2k.shape[1], "bc7_encode": px2k.shape[1],
             "bc7_refine": px2k.shape[1]}
    ops_of = {
        "bc7_decode": per_mode_ops(torch, bc67._mode_of(
            bc67._words_i64(w_final)), dict(enumerate(BC7_DECODE_OPS))),
        "bc7_encode": BC7_SEARCH_OPS * float(px2k.shape[1]),
        "bc7_refine": per_mode_ops(torch, bc67._mode_of(
            bc67._words_i64(w_search)), BC7_REFINE_OPS),
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

    r = bc7_maxq_phases(torch, to_dev, event_ms, smi, b512, corpus, img_d,
                        r["img_alpha"])
    for d, key in ((launches, "launches"), (k_ms, "k_ms"),
                   (plain_ms, "plain_ms"), (max_err, "max_err"),
                   (nb_of, "nb"), (plain_nb, "nb"), (ops_of, "ops")):
        d.update(r[key])

    lines = []
    for k in SOURCES:
        b_ms = BYTES_PER_BLOCK[k] * nb_of[k] / HBM_BYTES_PER_S * 1e3
        o_ms = ops_of[k] / OPS_PER_S * 1e3
        lines.append({
            "name": k, "route": "cuda", "source": SOURCES[k][0],
            "replaces": SOURCES[k][1], "launches": launches[k],
            "max_abs_err": max_err[k], "ms": k_ms[k],
            "plain_ms": plain_ms[k], "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms > o_ms else "operations",
            "library_ms": None, "blocks": nb_of[k],
            "plain_blocks": plain_nb[k], "ops": ops_of[k]})
    print(smi)
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


def bc6h_phases(torch, dev, to_dev, event_ms, smi) -> dict:
    """Phases 7-10. Returns the BC6H kernels' launches (from the paths'
    runs), times, plain times, errors against the twins and block counts."""
    from directxtex_tpu_torch.bc import bc6h, cuda_kernels
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
    words_g = to_dev(vec["bc6h_blocks"]).view(torch.int32).t().contiguous()
    rng = np.random.default_rng(2027)
    raw = rng.integers(0, 256, (RANDOM_BLOCKS, 16), dtype=np.uint8)
    words_r = to_dev(raw).view(torch.int32).t().contiguous()
    n_reserved = int((bc6h._mode_rows(bc6h._words_i64(words_r)) < 0).sum())
    for signed, key in ((False, "bc6h_uf_bits"), (True, "bc6h_sf_bits")):
        got = cuda_kernels.bc6h_decode(words_g, signed)
        ref = vec[key][..., :3].astype(np.int32).transpose(1, 2, 0)
        check(np.array_equal(got.cpu().numpy(), ref.reshape(48, -1)),
              f"K4 golden vectors signed={signed}")
        check(torch.equal(cuda_kernels.bc6h_decode(words_r, signed),
                          bc6h._bc6h_decode_plain(words_r, signed)),
              f"K4 vs plain on random words signed={signed}")
    emit({"phase": "K4", "golden_bit_exact": True,
          "random_blocks": RANDOM_BLOCKS, "reserved_blocks": n_reserved,
          "random_equal": True, "signed": [False, True]})

    # 8. K5 and K6 against their twins ----------------------------------
    corpus = np.load(os.path.join(GOLDEN, "corpus.npz"))

    def random_set(signed):
        """benchmarks/verify_bc6h_tpu.py:41-52: 200 random blocks; the
        first 40 signed ones sign-crossing bimodal."""
        r = np.random.default_rng(17)
        scale = 4.0 if signed else 8.0
        rgb = r.random((200, 16, 3)).astype(np.float32) * scale
        if signed:
            rgb -= scale / 2
            rgb[:N_BIMODAL, 8:, :] += scale
            rgb[:N_BIMODAL, :8, :] -= scale
        return np.concatenate([rgb, np.ones((200, 16, 1), np.float32)], -1)

    tiers = (("mid", bc6h.BC6H_LADDER_MID, False),
             ("maxq", bc6h.BC6H_LADDER_MAXQ, True))
    for signed in (False, True):
        contents = [(c, image_to_blocks(to_dev(corpus[c]))[0])
                    for c in HDR_CORPUS]
        contents.append(("random", to_dev(random_set(signed))))
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
            for tier, lad, cross2 in tiers:
                r_k = cuda_kernels.bc6h_refine(px, w_k, lad, lad, signed,
                                               True, cross2)
                r_p = bc6h._bc6h_refine_plain(px, w_k, lad, signed, True,
                                              cross2)
                same(r_k, r_p, f"K6 {tier} {what}")
                out[f"K6_{tier}_words_equal"] = True
                out[f"K6_{tier}_refined_blocks"] = int(
                    (r_k != w_k).any(dim=0).sum())
            emit(out)

    # 9. BC6H quality gates (tests/test_golden.py:118-177, :314-329) ----
    def log_psnr(a, b):
        a = np.maximum(a[..., :3], 0) + 1e-4
        b = np.maximum(b[..., :3], 0) + 1e-4
        m = float(np.mean((np.log2(a) - np.log2(b)) ** 2))
        return 10 * np.log10(36.0 / max(m, 1e-30))

    gates = {}
    for c in HDR_CORPUS:
        signed = c == "hdr_signed"
        blocks = image_to_blocks(to_dev(corpus[c]))[0]
        dec = bc6h.decode_bc6h(bc6h.encode_bc6h(blocks, signed), signed)
        dec, src = dec.cpu().numpy(), blocks.cpu().numpy()
        if signed:
            peak = float(np.abs(src[..., :3]).max())
            m = float(np.mean((dec[..., :3] - src[..., :3]) ** 2))
            psnr = 10 * np.log10(peak * peak / max(m, 1e-30))
            frozen = float(corpus["psnr_bc6hs_hdr_signed"])
        else:
            psnr = log_psnr(dec, src)
            frozen = float(corpus[f"psnr_bc6h_{c}"])
        check(psnr >= BC6H_FLOORS[c] and psnr >= frozen - 0.05,
              f"BC6H {c}: {psnr} dB < floor {BC6H_FLOORS[c]} / frozen "
              f"{frozen}")
        gates[c] = psnr
    ref = np.load(os.path.join(GOLDEN, "ref_encodes.npz"))
    blocks = image_to_blocks(to_dev(corpus["hdr"]))[0]
    dec = bc6h.decode_bc6h(bc6h.encode_bc6h(blocks, False), False)
    peak = float(ref["bc6h_hdr_peak"])
    mse = float(((dec[..., :3] - blocks[..., :3]).to(torch.float64) ** 2)
                .mean())
    ref_gate = 10 * np.log10(peak * peak / max(mse, 1e-30))
    check(ref_gate >= float(ref["bc6h_hdr_psnr"]),
          f"bc6h_hdr_psnr {ref_gate} < {float(ref['bc6h_hdr_psnr'])}")
    emit({"phase": "bc6h_gates", "psnr": gates, "floors": BC6H_FLOORS,
          "ref_parity_psnr": ref_gate,
          "ref_psnr": float(ref["bc6h_hdr_psnr"])})

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

    # the mid and maxq tiers on the same faces: K5 then K6 per encode
    cuda_kernels.reset_launch_counts()
    enc_mid = bc6h.encode_bc6h(blocks4, False, bc6h._BC6H_MID)
    enc_maxq = bc6h.encode_bc6h(blocks4, False, bc6h._BC7_MAXQUALITY)
    torch.cuda.synchronize()
    counts_t = cuda_kernels.launch_counts()
    check(counts_t["bc6h_encode"] == 2 and counts_t["bc6h_refine"] == 2,
          f"mid / maxq launch counts {counts_t}")
    launches["bc6h_refine"] = counts_t["bc6h_refine"]
    psnr_t = {t: log_psnr(bc6h.decode_bc6h(e, False).cpu().numpy(),
                          blocks4.cpu().numpy())
              for t, e in (("mid", enc_mid), ("maxq", enc_maxq))}

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
    k_ms = {
        "bc6h_encode": float(np.median(event_ms(
            lambda: cuda_kernels.bc6h_encode(px4, False), 7))),
        "bc6h_decode": float(np.median(event_ms(
            lambda: cuda_kernels.bc6h_decode(w5, False), 7))),
        "bc6h_refine": float(np.median(event_ms(
            lambda: cuda_kernels.bc6h_refine(px4, w5, *maxq_args), 7))),
    }
    mid_ms = float(np.median(event_ms(
        lambda: cuda_kernels.bc6h_refine(px4, w5, *mid_args), 7)))
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
        lambda: out.update(decode=bc6h._bc6h_decode_plain(w5, False)))[0]
    px_q, w5_q = px4[:, :MAXQ_PLAIN_BLOCKS], w5[:, :MAXQ_PLAIN_BLOCKS]
    plain_ms["bc6h_refine"] = event_ms(
        lambda: out.update(maxq=bc6h._bc6h_refine_plain(
            px_q, w5_q, bc6h.BC6H_LADDER_MAXQ, False, True, True)))[0]
    mid_plain_ms = event_ms(lambda: out.update(mid=bc6h._bc6h_refine_plain(
        px4, w5, bc6h.BC6H_LADDER_MID, False, True, False)))[0]
    same(w5, out["search"][1], "K5 words face 512")
    same(e5, out["search"][0], "K5 errors face 512")
    same(out["decode"], cuda_kernels.bc6h_decode(w5, False), "K4 face 512")
    same(w_mid, out["mid"], "K6 mid face 512")
    same(w_maxq[:, :MAXQ_PLAIN_BLOCKS], out["maxq"], "K6 maxq face 512")
    fin = torch.isfinite(e5)
    max_err = {
        "bc6h_encode": float((e5 - out["search"][0])[fin].abs().max())
        if bool(fin.any()) else 0.0,
        "bc6h_decode": word_diff(out["decode"],
                                 cuda_kernels.bc6h_decode(w5, False)),
        "bc6h_refine": word_diff(out["maxq"],
                                 w_maxq[:, :MAXQ_PLAIN_BLOCKS]),
    }
    texels = 6 * FACE * FACE
    emit({"phase": "config4", "card": smi, "face": FACE, "blocks": nb4,
          "launches": launches, "log_psnr": psnr4,
          "log_psnr_mid": psnr_t["mid"], "log_psnr_maxq": psnr_t["maxq"],
          "path_ms": path_ms,
          "path_mtexels_per_s": texels / (path_ms * 1e-3) / 1e6,
          "cube_faces_ms": faces_ms, "blocks_to_px_ms": prep_ms,
          "encode_mid_ms": tier_ms["mid"], "encode_maxq_ms": tier_ms["maxq"],
          "kernel_ms": k_ms, "kernel_mid_refine_ms": mid_ms,
          "plain_ms": plain_ms, "plain_mid_refine_ms": mid_plain_ms,
          "maxq_plain_blocks": MAXQ_PLAIN_BLOCKS,
          "words_equal_plain": ["bc6h_encode", "bc6h_decode", "mid",
                                "maxq"]})
    nb = {"bc6h_encode": nb4, "bc6h_decode": nb4, "bc6h_refine": nb4}
    plain_nb = dict(nb, bc6h_refine=px_q.shape[1])
    rows = bc6h._mode_rows(bc6h._words_i64(w5))
    # reserved blocks pass through the refine
    ops = {"bc6h_decode": per_mode_ops(torch, rows, dict(enumerate(
               BC6H_DECODE_OPS))),
           "bc6h_encode": BC6H_SEARCH_OPS * float(nb4),
           "bc6h_refine": per_mode_ops(torch, rows, {
               r: BC6H_REFINE_OPS["one_region" if r >= 10 else "two_region"]
               for r in range(14)})}
    return {"launches": launches, "k_ms": k_ms, "plain_ms": plain_ms,
            "max_err": max_err, "nb": nb, "plain_nb": plain_nb, "ops": ops}



def bc7_alpha_phases(torch, to_dev, event_ms, smi, b512, corpus, img_opaque,
                     opaque_ms) -> dict:
    """Phases 11-14. Returns the launches (from the paths' runs), times,
    plain times, errors against the twins, block counts and operations of
    K2's alpha and quick variants and of K3 with mode 7 in scope."""
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

    # 11. K2 alpha and K3 with mode 7 against their twins ------------------
    rng = np.random.default_rng(11)
    mixed = rng.random((200, 16, 4)).astype(np.float32)
    mixed[:100, :, 3] = 1.0
    contents = [("alphagrad", px_of(image_to_blocks(
        to_dev(corpus["alphagrad"]))[0])), ("mixed200", px_of(to_dev(mixed))),
        (f"alpha{size}", px_a)]
    plain = {}
    for label, px in contents:
        for aw in ALPHA_WEIGHTS:
            e_k, w_k = cuda_kernels.bc7_encode(px, alpha, aw)
            r_k = cuda_kernels.bc7_refine(px, w_k, ralpha, aw)
            t_s = event_ms(lambda: plain.update(
                search=bc67._bc7_search_plain(px, alpha, aw)))[0]
            t_r = event_ms(lambda: plain.update(
                refine=bc67._bc7_refine_plain(px, w_k, ralpha, aw)))[0]
            e_p, w_p = plain["search"]
            what = f"{label} aw={aw}"
            same(w_k, w_p, f"K2 alpha words {what}")
            same(e_k, e_p, f"K2 alpha errors {what}")
            same(r_k, plain["refine"], f"K3 alpha {what}")
            modes = torch.bincount(bc67._mode_of(bc67._words_i64(w_k)),
                                   minlength=9).tolist()
            emit({"phase": "K2_alpha", "content": label, "aw": aw,
                  "blocks": px.shape[1], "words_equal": True,
                  "errors_equal": True, "K3_words_equal": True,
                  "refined_blocks": int((r_k != w_k).any(dim=0).sum()),
                  "search_modes": modes})
            # mode 7 wins blocks of alphagrad and of the mixed set
            # (tests/test_torch_bc7_alpha.py); the 2048^2 image reports
            check(modes[7] > 0 or label == f"alpha{size}",
                  f"no mode-7 winner on {what}")
            if label == f"alpha{size}" and aw == 1.0:
                # the twins' one run at the main path's size
                w_search_a, plain_ms = w_k, {"bc7_encode_alpha": t_s,
                                             "bc7_refine_alpha": t_r}
                max_err = {"bc7_encode_alpha": float(
                    (e_k - e_p).abs().max()), "bc7_refine_alpha": float(
                    (r_k.to(torch.int64) - plain["refine"].to(torch.int64))
                    .abs().max())}

    # 12. K2 quick against its twin ----------------------------------------
    for label, px in (("bench512", px_of(image_to_blocks(
            to_dev(b512["img"]))[0])), (f"opaque{size}", px_o),
            (f"alpha{size}", px_a)):
        e_k, w_k = cuda_kernels.bc7_encode(px, quick)
        t_q = event_ms(lambda: plain.update(
            quick=bc67._bc7_search_plain(px, quick)))[0]
        same(w_k, plain["quick"][1], f"K2 quick words {label}")
        same(e_k, plain["quick"][0], f"K2 quick errors {label}")
        emit({"phase": "K2_quick", "content": label, "blocks": px.shape[1],
              "words_equal": True, "errors_equal": True})
        if label == f"alpha{size}":
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
            ("alpha", img_a, 0, ("bc7_encode_alpha", "bc7_refine_alpha",
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
        check(tuple(dec.shape) == (nb, 16, 4)
              and bool(torch.isfinite(dec).all()), f"{name} output")
        mse = float(((dec.to(torch.float64) - blocks.to(torch.float64))
                     ** 2).mean())
        runs[name] = {"launches": counts,
                      "psnr": 10 * np.log10(1.0 / max(mse, 1e-30))}
    launches = {"bc7_encode_alpha": runs["alpha"]["launches"][
        "bc7_encode_alpha"], "bc7_refine_alpha": runs["alpha"]["launches"][
        "bc7_refine_alpha"], "bc7_encode_quick": runs["quick_alpha"][
        "launches"]["bc7_encode_quick"]}

    med = {}
    for name, fn in (
            ("alpha_path", lambda: path(img_a)),
            ("bc7_encode_alpha", lambda: cuda_kernels.bc7_encode(
                px_a, alpha)),
            ("bc7_refine_alpha", lambda: cuda_kernels.bc7_refine(
                px_a, w_search_a, ralpha)),
            ("quick_path_alpha", lambda: path(img_a, bc67._BC7_QUICK)),
            ("quick_path_opaque", lambda: path(img_opaque,
                                               bc67._BC7_QUICK)),
            ("bc7_encode_quick", lambda: cuda_kernels.bc7_encode(
                px_a, quick)),
            ("bc7_encode_alpha_aw2", lambda: cuda_kernels.bc7_encode(
                px_a, alpha, 2.0)),
            ("opaque_path", lambda: bc67.encode_bc7(
                image_to_blocks(img_opaque)[0], opaque=True)),
            ("bc7_encode", lambda: cuda_kernels.bc7_encode(px_o))):
        fn()
        med[name] = float(np.median(event_ms(fn, 7)))
    texels = size * size
    emit({"phase": "alpha2k", "card": smi, "blocks": nb,
          "opaque_blocks": int((px_a.reshape(16, 4, -1)[:, 3, :] == 255)
                               .all(dim=0).sum()),
          "runs": runs, "ms": med,
          "alpha_path_mtexels_per_s": texels / (med["alpha_path"] * 1e-3)
          / 1e6,
          "quick_path_mtexels_per_s": texels / (
              med["quick_path_alpha"] * 1e-3) / 1e6,
          "opaque_path_ms_earlier_run": opaque_ms,
          "earlier_opaque_ms": EARLIER_OPAQUE_MS})

    has_alpha = (px_a.reshape(16, 4, -1)[:, 3, :] != 255).any(dim=0)
    n_alpha = float(has_alpha.sum())
    ops = {"bc7_encode_alpha": n_alpha * BC7_SEARCH_ALPHA_OPS
           + (nb - n_alpha) * BC7_SEARCH_OPS,
           "bc7_encode_quick": float(nb) * BC7_SEARCH_QUICK_OPS,
           "bc7_refine_alpha": per_mode_ops(torch, bc67._mode_of(
               bc67._words_i64(w_search_a)), BC7_REFINE_OPS)}
    k_ms = {k: med[k] for k in ops}
    return {"launches": launches, "k_ms": k_ms, "plain_ms": plain_ms,
            "max_err": max_err, "nb": {k: nb for k in ops}, "ops": ops,
            "img_alpha": img_a}


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
    for name, img, k2 in (("opaque", img_opaque, "bc7_encode_maxq"),
                          ("alpha", img_alpha, "bc7_encode_maxq_alpha")):
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        blocks = image_to_blocks(img)[0]
        dec = bc67.decode_bc7(bc67.encode_bc7(blocks, MAXQ))
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda_kernels.launch_counts().items()
                  if v}
        want = {k2: 1, "bc7_refine_maxq": 1, "bc7_refine_ladder": 1,
                "bc7_decode": 1}
        check(counts == want, f"maxq {name} launches {counts}")
        check(tuple(dec.shape) == (nb, 16, 4)
              and bool(torch.isfinite(dec).all()), f"maxq {name} output")
        mse = float(((dec.to(torch.float64) - blocks.to(torch.float64))
                     ** 2).mean())
        runs[name] = {"launches": counts,
                      "psnr": 10 * np.log10(1.0 / max(mse, 1e-30))}
    launches = {k: runs["opaque"]["launches"][k] for k in (
        "bc7_encode_maxq", "bc7_refine_maxq", "bc7_refine_ladder")}
    launches["bc7_encode_maxq_alpha"] = runs["alpha"]["launches"][
        "bc7_encode_maxq_alpha"]

    # the kernels' inputs at the paths' shapes, held against the twins once
    plain, plain_ms, max_err, states = {}, {}, {}, {}
    for name, px, modes, k2 in (("opaque", px_o, opaque, "bc7_encode_maxq"),
                                ("alpha", px_a, alpha,
                                 "bc7_encode_maxq_alpha")):
        e_k, w_s = cuda_kernels.bc7_encode(px, modes, 1.0, tier)
        w_m = cuda_kernels.bc7_refine(px, w_s, modes)
        w_f = cuda_kernels.bc7_refine(px, w_m, modes, 1.0, full)
        states[name] = (px, modes, w_s, w_m)
        plain_ms[k2] = event_ms(lambda: plain.update(
            search=bc67._bc7_search_plain(px, modes, 1.0, tier)))[0]
        same(w_s, plain["search"][1], f"K2 maxq words {name} {size}^2")
        same(e_k, plain["search"][0], f"K2 maxq errors {name} {size}^2")
        max_err[k2] = float((e_k - plain["search"][0]).abs().max())
        # both K3 launches of each path, held at that path's own shapes
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

    med = {}
    (px_o, _, ws_o, wm_o), (px_a, _, ws_a, wm_a) = (states["opaque"],
                                                    states["alpha"])
    w_default = cuda_kernels.bc7_encode(px_o)[1]
    for name, fn in (
            ("maxq_path_opaque", lambda: path(img_opaque, MAXQ)),
            ("maxq_path_alpha", lambda: path(img_alpha, MAXQ)),
            ("bc7_encode_maxq", lambda: cuda_kernels.bc7_encode(
                px_o, opaque, 1.0, tier)),
            ("bc7_encode_maxq_alpha", lambda: cuda_kernels.bc7_encode(
                px_a, alpha, 1.0, tier)),
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
            # the default tier's moment instance (no mode-6 code) on the
            # maxq search's words, beside bc7_refine_maxq on the same words
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

    has_alpha = (px_a.reshape(16, 4, -1)[:, 3, :] != 255).any(dim=0)
    n_alpha = float(has_alpha.sum())
    ops = {"bc7_encode_maxq": float(nb) * BC7_SEARCH_MAXQ_OPS,
           "bc7_encode_maxq_alpha": n_alpha * BC7_SEARCH_MAXQ_ALPHA_OPS
           + (nb - n_alpha) * BC7_SEARCH_MAXQ_OPS,
           "bc7_refine_maxq": per_mode_ops(torch, bc67._mode_of(
               bc67._words_i64(ws_o)), BC7_REFINE_OPS),
           "bc7_refine_ladder": per_mode_ops(torch, modes_m,
                                             BC7_REFINE_FULL_OPS)}
    k_ms = {k: med[k] for k in ops}
    return {"launches": launches, "k_ms": k_ms, "plain_ms": plain_ms,
            "max_err": max_err, "nb": {k: nb for k in ops}, "ops": ops}


if __name__ == "__main__":
    main()
