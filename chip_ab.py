#!/usr/bin/env python3
"""Time the BC7 and BC6H search and refine launches of one checkout on one
GPU.

Runs, at the shapes of chip_smoke.py's bench images: K2's opaque search
and its maxq search (alpha weights 1.0 and 2.0); its searches with mode 7
(both tiers) on
the image with alpha, and their pieces there (each tier's (1, 3, 5, 6,
4) search, K9's two-subset ranking, K7's mode 7 over every block and
over the blocks with alpha); each K3 call of the BC7 paths as its
launcher's whole call (the default, alpha and maxq MOMENT scopes,
LADDER_FULL and LADDER_LIGHT, modes 0 and 2 under MOMENT and FULL); the
USE_3SUBSETS search's pieces (K9 as the path runs it: one launch for
both modes' candidates where the checkout has it, else its two launches;
K7 for each of modes 0, 1, 2, 3 and 7, on the opaque image and on the
image with alpha) and the whole search; the 2048^2 paths (default and
maxq, opaque and with alpha, and USE_3SUBSETS in both tiers, opaque and
with alpha);
and on BASELINE config 4's faces (face 512) K5 (unsigned and signed),
K6's mid and maxq calls, the mid and maxq encodes and the whole config-4
path (hdr_cubemap_pipeline). Decode: K1's words API on the 2048^2 bench
image's final words and on 262,144 random mixed words, decode_bc7 as a
path on the same blocks, K4's words API and decode_bc6h on config 4's
words; where the checkout has them, K1's and K4's f32 epilogue alone.
Mode 7's launch (on the default and maxq searches' picks of the image
with alpha, at alpha weights 1.0 and 2.0) and K11 over the six precision
groups (one launch where the checkout has it, else its six launches) on
config 4's faces, unsigned and signed, with the BC6H_SHARED_FIT=False
search (both signs) and config-4 path; K8 (alpha weights 1.0 and 2.0, on
both 2048^2 images) and the BC6H shape ranking (config 4's faces, both
signs); nvcc's registers and spills of those four kernels.
It prints one JSON line of median CUDA-event times in ms of the checkout
at ROOT, with the card's name and power limit and sums of
the words, so that two checkouts can be seen to agree. To compare two
checkouts on one card, run it from both on that card, in turns (A, B, B,
A):

    python3 chip_ab.py PARENT_ROOT parent
    python3 chip_ab.py . change
    python3 chip_ab.py . change
    python3 chip_ab.py PARENT_ROOT parent

With a third argument, `focus`, it times only mode 7's launch, K11, K8,
the ranking and the paths and searches that run them (`focus` in the
output, with sums of their words and picks in `focus_sums` and the
kernels' device times, each call in a torch.profiler record of its own,
in `focus_device_ms`).

The checkout at ROOT provides directxtex_tpu_torch and chip_smoke.py's
bench_image; both must have the same entry points as this one's.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

REPS = 11
HERE = os.path.dirname(os.path.abspath(__file__))


# The issued-instruction count of a kernel (sass_path_count): one entry a
# warp of a CTA's 32 blocks, each its loops' trip counts in sass_loops
# order and whether its conditional EXIT is taken. K10's emit loop visits
# a row's header runs and the zero entry that ends them (rows 10-12: 7,
# 10 and 13 runs; row 13's 25 fill the table).
EMIT_TRIPS = {10: 8, 11: 11, 12: 14, 13: 25}
SASS_SPECS = {
    # one thread a block: staging (48 pixels, 4 a pass), rows 10-13, per
    # row mag_cap (16 pixels, 4 a pass), palette_err, the two refit
    # rounds (ls_refit's A/B/C loop, its channel loop and pixel loop,
    # palette_err), emit's runs (the rows' mean) and indices
    "bc6h_1region_kernel": [((12, 4, 4, 4, 2, 4, 3, 4, 4,
                              sum(EMIT_TRIPS.values()) / 4, 4), False)],
    # K2 quick, one thread a block: no loop
    "bc7_encode_kernelILi1E": [((), False)],
    # Designs tried and not shipped (PERF.md): K10 as four row warps per
    # 32 blocks (staging's remainder and main loops, then one row as
    # above, the first palette_err in two copies, by sign; warps 1-3 leave
    # before the fold), K10 as two warps of two rows each, and K2 quick as
    # the maxq team's mode-6 job from staged pixels (no loop)
    "bc6h_1region_rows_kernel": [
        ((0, 3, 4, 4, 4, 2, 4, 3, 4, 4, EMIT_TRIPS[10 + r], 4), r != 0)
        for r in range(4)],
    "bc6h_1region_rows2_kernel": [
        ((0, 3, 2, 4, 4, 2, 4, 3, 4, 4,
          (EMIT_TRIPS[10 + 2 * h] + EMIT_TRIPS[11 + 2 * h]) / 2, 4), h != 0)
        for h in range(2)],
    "bc7_encode_quick_kernel": [((), False)],
}


def sass_functions(text: str) -> dict:
    """{mangled kernel name: [SASS lines]} of `cuobjdump -sass` output."""
    funcs, name = {}, None
    for ln in text.splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ")[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(ln)
    return funcs


def sass_instructions(lines) -> list:
    """[(offset, instruction text)] of one kernel's SASS lines, in order."""
    import re

    out = []
    for ln in lines:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m:
            out.append((int(m.group(1), 16), m.group(2)))
    return out


def _sass_flow(ins):
    """Per instruction: ("op" | "fwd" | "back" | "exit", target index or
    None, conditional?)."""
    import re

    index = {pc: i for i, (pc, _) in enumerate(ins)}
    flow = []
    for k, (_, t) in enumerate(ins):
        m = re.match(r"(@!?U?P\w+\s+)?([A-Z0-9_]+)", t)
        op = m.group(2)
        cond = m.group(1) is not None
        if op == "BRA":
            tgt = index[int(re.search(r"0x([0-9a-f]+)\s*$", t).group(1), 16)]
            cond = cond or re.search(r"BRA\s+!?P\w+,", t) is not None
            flow.append(("back" if tgt <= k else "fwd", tgt, cond))
        elif op == "EXIT":
            flow.append(("exit", None, cond))
        else:
            flow.append(("op", None, False))
    return flow


def sass_loops(ins) -> list:
    """[(first, last)] instruction indices of each loop (a backward branch
    and its target) before the kernel's unconditional EXIT, by first."""
    flow = _sass_flow(ins)
    end = min(k for k, (kind, _, cond) in enumerate(flow)
              if kind == "exit" and not cond)
    return sorted((tgt, k) for k, (kind, tgt, _) in enumerate(flow)
                  if kind == "back" and tgt < end)


def sass_path_count(ins, trips, longest: bool = True,
                    take_cond_exit: bool = False) -> float:
    """Instructions one thread issues from the kernel's entry to its
    unconditional EXIT: each loop of sass_loops (in that order) runs its
    `trips` entry times, the path through each loop body and through the
    straight code is the longest (or the shortest) over its forward
    branches, a branch out of a loop body is not taken, a subroutine
    call (the IEEE slow paths) counts as its one instruction, and a
    conditional EXIT is taken where take_cond_exit. Trips may be
    fractional: a loop whose trip count differs from one pass of an
    enclosing loop to the next takes its mean, which gives the sum (the
    path is linear in the trips)."""
    flow = _sass_flow(ins)
    loops = sass_loops(ins)
    if len(loops) != len(trips):
        raise ValueError(f"{len(loops)} loops, {len(trips)} trip counts")
    by_first = {}
    for (first, last), t in zip(loops, trips):
        by_first.setdefault(first, []).append((last, t))
    pick = max if longest else min
    end = min(k for k, (kind, _, cond) in enumerate(flow)
              if kind == "exit" and not cond)

    def region(lo, hi, own):
        """cost[k]: instructions from k to leaving [lo, hi]."""
        cost = {hi + 1: 0.0}
        for k in range(hi, lo - 1, -1):
            inner = [(last, t) for last, t in by_first.get(k, ())
                     if last <= hi and (k, last) != own]
            if inner:
                last, t = max(inner)
                body = region(k, last, (k, last))[k]
                cost[k] = t * body + cost[last + 1]
                continue
            kind, tgt, cond = flow[k]
            nxt = cost[k + 1]
            if kind == "fwd":
                out = tgt > hi + 1
                if cond:
                    cost[k] = 1 + (nxt if out else pick(nxt, cost[tgt]))
                else:
                    cost[k] = 1 + (0.0 if out else cost[tgt])
            elif kind == "exit":
                cost[k] = 1 + (0.0 if not cond or take_cond_exit else nxt)
            else:
                cost[k] = 1 + nxt
        return cost

    return region(0, end, None)[0]


def dump_sass(build, pieces) -> dict:
    """Write the SASS of the built library's kernels whose names hold one
    of `pieces` to chiprun_out/sass_<library>.txt beside this script;
    return the file's path and its sass_report."""
    import pathlib

    lib = build.build_info["path"]
    tool = pathlib.Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    keep = {k: v for k, v in sass_functions(text).items()
            if any(p in k for p in pieces)}
    out = os.path.join(HERE, "chiprun_out",
                       f"sass_{pathlib.Path(lib).stem}.txt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        for k, v in keep.items():
            f.write(f"\t\tFunction : {k}\n" + "\n".join(v) + "\n")
    with open(out) as f:
        return {"file": out, "report": sass_report(f.read())}


def sass_report(text: str) -> dict:
    """{kernel: its loops and, for a kernel of SASS_SPECS, the issued
    instructions a thread (longest and shortest path) and a CTA's warp
    instructions per 32 blocks} of `cuobjdump -sass` text."""
    out = {}
    for name, lines in sass_functions(text).items():
        ins = sass_instructions(lines)
        rep = {"instructions": len(ins), "loops": sass_loops(ins)}
        for piece, warps in SASS_SPECS.items():
            if piece not in name:
                continue
            try:
                per_warp = [{"longest": sass_path_count(ins, t, True, x),
                             "shortest": sass_path_count(ins, t, False, x)}
                            for t, x in warps]
            except ValueError as e:   # a build whose loops differ
                rep["error"] = str(e)
                continue
            rep.update(per_warp=per_warp, per_32_blocks={
                k: sum(w[k] for w in per_warp) for k in per_warp[0]})
        out[name] = rep
    return out


def main() -> None:
    if sys.argv[1] == "--sass":
        with open(sys.argv[2]) as f:
            print(json.dumps(sass_report(f.read()), indent=1))
        return
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    only_focus = sys.argv[3:4] == ["focus"]
    # focus KEY...: only the focus calls whose names start with a KEY
    keep = tuple(sys.argv[4:])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_ab.py runs on a GPU")
    import chip_smoke
    from directxtex_tpu_torch import _build
    from directxtex_tpu_torch.bc import bc6h, bc67, cuda_kernels as ck
    from directxtex_tpu_torch.bc.common import image_to_blocks
    from directxtex_tpu_torch.models import pipelines

    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    # nvcc's log of this build (a later call finds the library built)
    ptxas = {k: v for k, v in chip_smoke.ptxas_summary(
        _build.build_info["log"]).items()
        if any(p in k for p in ("mode7", "2region", "single_modes",
                                "bc6h_shapes", "1region", "quick"))}
    # the SASS of K10 and K2 quick, for their issued-instruction counts
    # (sass_report)
    sass = dump_sass(_build, ("1region", "quick", "bc7_encode_kernel"))
    dev = torch.device("cuda", 0)

    def med(fn) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    img_o = torch.from_numpy(chip_smoke.bench_image()).to(dev)
    img_a = torch.from_numpy(chip_smoke.bench_image(alpha=True)).to(dev)
    px_o = bc67._quantize_ldr(image_to_blocks(img_o)[0]).reshape(64, -1) \
        .contiguous()
    px_a = bc67._quantize_ldr(image_to_blocks(img_a)[0]).reshape(64, -1) \
        .contiguous()
    opaque, alpha = bc67.SEARCH_MODES, bc67.SEARCH_MODES_ALPHA
    quick = bc67.SEARCH_MODES_QUICK
    maxq, full = bc67.TIER_MAXQ, bc67.LADDER_FULL
    w_d = ck.bc7_encode(px_o)[1]
    w_a = ck.bc7_encode(px_a, alpha)[1]
    w_s = ck.bc7_encode(px_o, opaque, 1.0, maxq)[1]
    w_m = ck.bc7_refine(px_o, w_s, opaque)
    w_3 = bc67.bc7_search_words(px_o, bc67.SEARCH_MODES_3)[1]
    w_3q = bc67.bc7_search_words(px_o, bc67.SEARCH_MODES_3, 1.0, maxq)[1]
    w_3m = ck.bc7_refine(px_o, w_3q, bc67.SEARCH_MODES_3)
    # K9 as the USE_3SUBSETS path runs it
    def k9_path(px):
        if hasattr(ck, "bc7_partition_shapes_3sub"):
            return ck.bc7_partition_shapes_3sub(px)
        return (ck.bc7_partition_shapes(px, 2, 16),
                ck.bc7_partition_shapes(px, 2, 64))

    cands = {}
    for key, px in (("opaque", px_o), ("alpha", px_a)):
        s16, s64 = k9_path(px)
        s2 = ck.bc7_partition_shapes(px, 1, 64)
        cands[key] = {0: s16, 2: s64, 1: s2, 3: s2, 7: s2}
    # the blocks with alpha, gathered, and their two-subset picks
    s2 = ck.bc7_partition_shapes(px_a, 1, 64)
    with_alpha = torch.nonzero(
        (px_a.reshape(16, 4, -1)[:, 3, :] != 255).any(dim=0)).flatten()
    px_alpha = px_a[:, with_alpha].contiguous()
    s2_alpha = s2[:, with_alpha].contiguous()

    def path(img, flags=0, **kw):
        return lambda: bc67.encode_bc7(image_to_blocks(img)[0], flags, **kw)

    # config 4's faces (benchmarks/run_all.py:141-153)
    rng = np.random.default_rng(2)
    eq = torch.from_numpy(rng.random((1024, 2048, 4)).astype(np.float32)
                          * 4.0).to(dev)
    faces = pipelines.cube_faces(eq)
    blocks4 = torch.cat([image_to_blocks(faces[i])[0] for i in range(6)])
    px4 = bc6h.px_of_blocks(blocks4, False)
    px4s = bc6h.px_of_blocks(blocks4, True)
    w5 = ck.bc6h_encode(px4, False)[1]
    pipe = pipelines.hdr_cubemap_pipeline()
    mid = (bc6h.BC6H_LADDER_MID, bc6h.BC6H_LADDER_MID, False, True, False)
    mxq = (bc6h.BC6H_LADDER_MAXQ, bc6h.BC6H_LADDER_MAXQ, False, True, True)

    # mode 7's launch on each tier's picks, folded in place (a second fold
    # over a folded result keeps it), and K11 over the six groups
    list_a, count_a = ck.bc7_alpha_list(px_a)
    fold7 = {(t, aw): ck.bc7_search_picks(px_a, aw, t)
             for t in (bc67.TIER_DEFAULT, maxq) for aw in (1.0, 2.0)}

    def mode7(t, aw):
        e, w, picks = fold7[t, aw]
        return lambda: ck.bc7_mode7(px_a, picks, list_a, count_a, e, w, aw)

    sb4 = ck.bc6h_shapes(px4)
    sb4s = ck.bc6h_shapes(px4s)
    one_launch = "groups" in inspect.signature(ck.bc6h_2region).parameters

    def k11(px, sb, signed):
        if one_launch:
            return lambda: ck.bc6h_2region(px, sb, range(6), signed)
        # a checkout whose K11 takes one group a launch: its six launches,
        # folded as the one launch folds
        def six():
            best = None
            for g in range(6):
                best = bc6h._fold_first(best,
                                        *ck.bc6h_2region(px, sb, g, signed))
            return best
        return six

    def unshared(fn):
        def run():
            saved = bc6h.BC6H_SHARED_FIT
            bc6h.BC6H_SHARED_FIT = False
            try:
                return fn()
            finally:
                bc6h.BC6H_SHARED_FIT = saved
        return run

    focus_calls = {
        "mode7": mode7(bc67.TIER_DEFAULT, 1.0),
        "mode7_aw2": mode7(bc67.TIER_DEFAULT, 2.0),
        "mode7_maxq_picks": mode7(maxq, 1.0),
        "k11": k11(px4, sb4, False),
        "k11_signed": k11(px4s, sb4s, True),
        "search_unshared": lambda: bc6h._search_unshared(px4, False),
        "search_unshared_signed": lambda: bc6h._search_unshared(px4s, True),
        "ranking": lambda: ck.bc6h_shapes(px4),
        "ranking_signed": lambda: ck.bc6h_shapes(px4s),
        "k10": lambda: ck.bc6h_1region(px4, False),
        "k10_signed": lambda: ck.bc6h_1region(px4s, True),
        **{f"k2_quick{sfx}{'_aw2' if aw == 2.0 else ''}": (
            lambda px=px, aw=aw: ck.bc7_encode(px, quick, aw))
           for px, sfx in ((px_o, ""), (px_a, "_alpha_image"))
           for aw in (1.0, 2.0)},
        "path_quick_opaque": path(img_o, 0x100000),
        "path_quick_alpha": path(img_a, 0x100000),
        **{f"k8{sfx}{'_aw2' if aw == 2.0 else ''}": (
            lambda px=px, aw=aw: ck.bc7_single_modes(px, aw))
           for px, sfx in ((px_o, ""), (px_a, "_alpha_image"))
           for aw in (1.0, 2.0)},
        "path_config4_unshared": unshared(lambda: pipe(eq)),
        "path_default_alpha": path(img_a),
        "path_maxq_alpha": path(img_a, 0x200000),
        "k2_alpha_search": lambda: ck.bc7_encode(px_a, alpha),
        "k2_maxq_alpha_search": lambda: ck.bc7_encode(px_a, alpha, 1.0,
                                                      maxq),
    }
    if keep:
        focus_calls = {k: v for k, v in focus_calls.items()
                       if k.startswith(keep)}
    if not one_launch and not keep:
        # each of the six launches is its own kernel call
        focus_calls["k11_six_launches_unfolded"] = lambda: [
            ck.bc6h_2region(px4, sb4, g, False) for g in range(6)]
    focus = {k: med(fn) for k, fn in focus_calls.items()}
    # the kernels' device time: each call in a torch.profiler record of
    # its own, the CUDA kernels it ran summed (a parent's six K11 launches)
    prof = chip_smoke.profile_calls(torch, {
        k: fn for k, fn in focus_calls.items()
        if k.startswith(("mode7", "k11", "k8", "ranking", "k10",
                         "k2_quick"))
        and k != "k11_six_launches_unfolded"})
    focus_device_ms = {k: sum(t for _, t in v) * 1e-3
                       for k, v in prof.items()}
    for fn in (mode7(t, aw) for t, aw in fold7):
        fn()
    focus_sums = {
        **{f"mode7_{t}_aw{aw:g}": int(fold7[t, aw][1].to(torch.int64).sum())
           for t, aw in fold7},
        "k11": int(k11(px4, sb4, False)()[1].to(torch.int64).sum()),
        "k11_signed": int(k11(px4s, sb4s, True)()[1].to(torch.int64).sum()),
        "search_unshared": int(bc6h._search_unshared(px4, False)[1]
                               .to(torch.int64).sum()),
        "search_unshared_signed": int(bc6h._search_unshared(px4s, True)[1]
                                      .to(torch.int64).sum()),
        "ranking": int(sb4.to(torch.int64).sum()),
        "ranking_signed": int(sb4s.to(torch.int64).sum()),
    }
    for signed, px in ((False, px4), (True, px4s)):
        err, words = ck.bc6h_1region(px, signed)
        key = "k10_signed" if signed else "k10"
        focus_sums[key] = int(words.to(torch.int64).sum())
        focus_sums[key + "_err"] = float(
            err[torch.isfinite(err)].to(torch.float64).sum())
    for px, sfx in ((px_o, ""), (px_a, "_alpha_image")):
        for aw in (1.0, 2.0):
            err, words = ck.bc7_encode(px, quick, aw)
            key = f"k2_quick{sfx}_aw{aw:g}"
            focus_sums[key] = int(words.to(torch.int64).sum())
            focus_sums[key + "_err"] = float(err.to(torch.float64).sum())
    for px, sfx in ((px_o, ""), (px_a, "_alpha_image")):
        for aw in (1.0, 2.0):
            err, words = ck.bc7_single_modes(px, aw)
            key = f"k8{sfx}_aw{aw:g}"
            focus_sums[key] = int(words.to(torch.int64).sum())
            focus_sums[key + "_err"] = float(err.to(torch.float64).sum())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if only_focus:
        print(json.dumps({"tag": tag, "card": smi, "build_s": build_s,
                          "focus": focus, "focus_device_ms": focus_device_ms,
                          "focus_sums": focus_sums, "ptxas": ptxas,
                          "sass": sass}),
              flush=True)
        return

    # decode: the bench image's final words and random mixed words (every
    # 97th reserved), config 4's words
    w_fin = ck.bc7_refine(px_o, w_d, bc67.REFINE_MODES)
    blk_fin = w_fin.t().contiguous().view(torch.uint8).reshape(-1, 16)
    raw = np.random.default_rng(2026).integers(
        0, 256, (chip_smoke.RANDOM_BLOCKS, 16), dtype=np.uint8)
    raw[::97, 0] = 0
    blk_r = torch.from_numpy(raw).to(dev)
    w_r = blk_r.view(torch.int32).t().contiguous()
    blk5 = w5.t().contiguous().view(torch.uint8).reshape(-1, 16)
    decode_ms = {
        "k1_words": med(lambda: ck.bc7_decode(w_fin)),
        "k1_words_random_mixed": med(lambda: ck.bc7_decode(w_r)),
        "decode_bc7_path": med(lambda: bc67.decode_bc7(blk_fin)),
        "decode_bc7_path_random_mixed": med(lambda: bc67.decode_bc7(blk_r)),
        "k4_words": med(lambda: ck.bc6h_decode(w5, False)),
        "decode_bc6h_path": med(lambda: bc6h.decode_bc6h(blk5, False)),
    }
    if hasattr(ck, "bc7_decode_blocks"):
        decode_ms["k1_f32"] = med(lambda: ck.bc7_decode_blocks(blk_fin))
        decode_ms["k1_f32_random_mixed"] = med(
            lambda: ck.bc7_decode_blocks(blk_r))
        decode_ms["k4_f32"] = med(lambda: ck.bc6h_decode_blocks(blk5, False))
    decode_sums = {
        "decode_bc7": float(bc67.decode_bc7(blk_fin).to(torch.float64)
                            .sum()),
        "decode_bc7_random_mixed": float(bc67.decode_bc7(blk_r)
                                         .to(torch.float64).sum()),
        "decode_bc6h": float(bc6h.decode_bc6h(blk5, False)
                             .to(torch.float64).sum()),
        "decode_bc6h_signed": float(bc6h.decode_bc6h(blk5, True)
                                    .to(torch.float64).sum()),
    }

    ms = {
        "k2_opaque": med(lambda: ck.bc7_encode(px_o)),
        "k2_opaque_aw2": med(lambda: ck.bc7_encode(px_o, opaque, 2.0)),
        "k2_maxq_search": med(lambda: ck.bc7_encode(px_o, opaque, 1.0,
                                                    maxq)),
        "k2_maxq_search_aw2": med(lambda: ck.bc7_encode(px_o, opaque, 2.0,
                                                        maxq)),
        "k3_default": med(lambda: ck.bc7_refine(px_o, w_d,
                                                bc67.REFINE_MODES)),
        "k3_alpha": med(lambda: ck.bc7_refine(px_a, w_a,
                                              bc67.REFINE_MODES_ALPHA)),
        "k3_maxq_moment": med(lambda: ck.bc7_refine(px_o, w_s, opaque)),
        "k3_full": med(lambda: ck.bc7_refine(px_o, w_m, opaque, 1.0, full)),
        "k3_light": med(lambda: ck.bc7_refine(px_o, w_m, opaque, 1.0,
                                              bc67.LADDER_LIGHT)),
        "k3_modes02_moment": med(lambda: ck.bc7_refine(px_o, w_3, (0, 2))),
        "k3_modes02_full": med(lambda: ck.bc7_refine(px_o, w_3m, (0, 2),
                                                     1.0, full)),
        "path_default_opaque": med(path(img_o, opaque=True)),
        "path_default_alpha": med(path(img_a)),
        "path_maxq_opaque": med(path(img_o, 0x200000)),
        "path_use3_opaque": med(path(img_o, 0x80000)),
        "path_use3_alpha": med(path(img_a, 0x80000)),
        "path_use3_maxq_opaque": med(path(img_o, 0x280000)),
        "path_use3_maxq_alpha": med(path(img_a, 0x280000)),
        "search_use3": med(lambda: bc67.bc7_search_words(
            px_o, bc67.SEARCH_MODES_3)),
        "k9_path": med(lambda: k9_path(px_o)),
        "k9_path_alpha_image": med(lambda: k9_path(px_a)),
        "k2_alpha_search": med(lambda: ck.bc7_encode(px_a, alpha)),
        "k2_alpha_search_aw2": med(lambda: ck.bc7_encode(px_a, alpha, 2.0)),
        "k2_maxq_alpha_search": med(lambda: ck.bc7_encode(px_a, alpha, 1.0,
                                                          maxq)),
        "k2_on_alpha_image": med(lambda: ck.bc7_encode(px_a)),
        "k2_maxq_on_alpha_image": med(lambda: ck.bc7_encode(px_a, opaque,
                                                            1.0, maxq)),
        "k9_2sub_alpha_image": med(lambda: ck.bc7_partition_shapes(px_a, 1,
                                                                   64)),
        "k7_mode7_every_block": med(lambda: ck.bc7_partition_mode(px_a, s2,
                                                                  7)),
        "k7_mode7_alpha_blocks": med(lambda: ck.bc7_partition_mode(
            px_alpha, s2_alpha, 7)),
        "path_maxq_alpha": med(path(img_a, 0x200000)),
        **{f"k7_mode{m}{sfx}": med(lambda m=m, px=px, key=key: (
            ck.bc7_partition_mode(px, cands[key][m], m)))
           for key, px, sfx in (("opaque", px_o, ""),
                                ("alpha", px_a, "_alpha_image"))
           for m in (0, 1, 2, 3, 7)},
        "k5_search": med(lambda: ck.bc6h_encode(px4, False)),
        "k5_search_signed": med(lambda: ck.bc6h_encode(px4s, True)),
        "path_config4": med(lambda: pipe(eq)),
        "k6_mid": med(lambda: ck.bc6h_refine(px4, w5, *mid)),
        "k6_maxq": med(lambda: ck.bc6h_refine(px4, w5, *mxq)),
        "encode_bc6h_mid": med(lambda: bc6h.encode_bc6h(
            blocks4, False, bc6h._BC6H_MID)),
        "encode_bc6h_maxq": med(lambda: bc6h.encode_bc6h(
            blocks4, False, bc6h._BC7_MAXQUALITY)),
    }
    # the refined words, to show both checkouts compute the same
    digest = int(ck.bc7_refine(px_o, w_m, opaque, 1.0, full)
                 .to(torch.int64).sum())
    digests = {
        "alpha_search": int(ck.bc7_encode(px_a, alpha)[1].to(torch.int64)
                            .sum()),
        "maxq_alpha_search": int(ck.bc7_encode(px_a, alpha, 1.0, maxq)[1]
                                 .to(torch.int64).sum()),
        "maxq_search_aw2": int(ck.bc7_encode(px_o, opaque, 2.0, maxq)[1]
                               .to(torch.int64).sum()),
        "k5_search": int(w5.to(torch.int64).sum()),
        "k5_search_signed": int(ck.bc6h_encode(px4s, True)[1]
                                .to(torch.int64).sum()),
        "k6_mid": int(ck.bc6h_refine(px4, w5, *mid).to(torch.int64).sum()),
        "k6_maxq": int(ck.bc6h_refine(px4, w5, *mxq).to(torch.int64).sum()),
        "k9_path": int(sum(s.to(torch.int64).sum() for key in cands
                           for s in (cands[key][0], cands[key][2]))),
        **{f"k7_mode{m}_{key}_aw{aw:g}": int(ck.bc7_partition_mode(
            px, cands[key][m], m, aw)[1].to(torch.int64).sum())
           for key, px in (("opaque", px_o), ("alpha", px_a))
           for m in (0, 1, 2, 3, 7) for aw in (1.0, 2.0)},
        **{f"use3_{name}": int(bc67.encode_bc7(
            image_to_blocks(img)[0], flags).view(torch.int32)
            .to(torch.int64).sum())
           for name, img, flags in (("opaque", img_o, 0x80000),
                                    ("alpha", img_a, 0x80000),
                                    ("maxq_opaque", img_o, 0x280000),
                                    ("maxq_alpha", img_a, 0x280000))}}
    print(json.dumps({"tag": tag, "card": smi, "build_s": build_s,
                      "focus": focus, "focus_device_ms": focus_device_ms,
                      "focus_sums": focus_sums,
                      "ptxas": ptxas, "sass": sass, "ms": ms,
                      "decode_ms": decode_ms,
                      "decode_sums": decode_sums, "full_words_sum": digest,
                      "words_sums": digests}), flush=True)


if __name__ == "__main__":
    main()
