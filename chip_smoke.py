#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one GPU.

Drives the port's BC7 default tier (image_to_blocks -> encode_bc7 ->
decode_bc7) through its three hand-written CUDA kernels, K1 decode, K2
search and K3 MOMENT refine, and holds every kernel against its plain
PyTorch twin on the card:

  0. device: the card's name and power limit, torch, CUDA and nvcc;
  1. build: nvcc builds the kernels from directxtex_tpu_torch/csrc;
  2. K1: bit-exact on tests/golden/decode_vectors.npz and equal to the
     plain decode on 262,144 random mixed-mode words;
  3. K2: kernel search vs plain search on bench512.npz and the opaque
     corpus.npz contents, under the near-tie rule;
  4. K3: kernel refine vs plain refine on the same input words: equal;
  5. 512^2 gate: encode_bc7 -> decode_bc7 PSNR >= the frozen reference's;
  6. the 2048^2 bench image through the whole slice, with launch counts,
     CUDA-event times of the path and of each kernel, and one run of the
     plain path on the same inputs, held against the kernels' output.

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
    "bc7_refine": ("directxtex_tpu_torch/csrc/bc7_refine.cu",
                   "directxtex_tpu/bc/pallas_kernels.py:2667"),
}
OPAQUE_CORPUS = ("albedo", "tworegion", "normal", "photo_china",
                 "photo_flower")
SLICE_SIZE = 2048          # the bench image's side (bench.py:89)
RANDOM_BLOCKS = 262144     # random words for the K1 check


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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
    ptxas = [ln.strip() for ln in _build.build_info["log"].splitlines()
             if "entry function" in ln or "registers" in ln
             or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

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
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, size, dtype=np.float32)
    gx, gy = np.meshgrid(x, x)
    img = np.stack([gx, (gx * gy), np.abs(np.sin(gx * 37) * 0.5 + 0.3),
                    np.ones_like(gx)], axis=-1).astype(np.float32)
    img += (rng.random(img.shape).astype(np.float32) - 0.5) * 0.05
    img = np.clip(img, 0, 1)
    img[..., 3] = 1.0
    img_d = to_dev(img)

    def encode_path():
        return bc67.encode_bc7(image_to_blocks(img_d)[0], opaque=True)

    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    blocks2k = image_to_blocks(img_d)[0]
    enc = bc67.encode_bc7(blocks2k, opaque=True)
    dec = bc67.decode_bc7(enc)
    torch.cuda.synchronize()
    counts = cuda_kernels.launch_counts()
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
          "plain_ms": plain_ms, "search_words_differ_vs_plain": n2k})

    print(smi)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0],
         "replaces": SOURCES[k][1], "launches": counts[k],
         "max_abs_err": max_err[k], "ms": k_ms[k],
         "plain_ms": plain_ms[k]} for k in SOURCES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
