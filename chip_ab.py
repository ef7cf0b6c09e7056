#!/usr/bin/env python3
"""Time the BC7 and BC6H search and refine launches of one checkout on one
GPU.

Runs, at the shapes of chip_smoke.py's bench images: K2's opaque search
(alpha weights 1.0 and 2.0); its searches with mode 7 (both tiers) on
the image with alpha, and their pieces there (each tier's (1, 3, 5, 6,
4) search, K9's two-subset ranking, K7's mode 7 over every block and
over the blocks with alpha); each K3 call of the BC7 paths as its
launcher's whole call (the default, alpha and maxq MOMENT scopes,
LADDER_FULL and LADDER_LIGHT, modes 0 and 2 under MOMENT and FULL); the
2048^2 paths (default and maxq, opaque and with alpha, USE_3SUBSETS);
and K6's mid and maxq calls and encodes on BASELINE config 4's faces
(face 512). It prints one JSON line of median CUDA-event times in ms of
the checkout at ROOT, with the card's name and power limit and sums of
the words, so that two checkouts can be seen to agree. To compare two
checkouts on one card, run it from both on that card, in turns (A, B, B,
A):

    python3 chip_ab.py PARENT_ROOT parent
    python3 chip_ab.py . change
    python3 chip_ab.py . change
    python3 chip_ab.py PARENT_ROOT parent

The checkout at ROOT provides directxtex_tpu_torch and chip_smoke.py's
bench_image; both must have the same entry points as this one's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPS = 11


def main() -> None:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
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
    maxq, full = bc67.TIER_MAXQ, bc67.LADDER_FULL
    w_d = ck.bc7_encode(px_o)[1]
    w_a = ck.bc7_encode(px_a, alpha)[1]
    w_s = ck.bc7_encode(px_o, opaque, 1.0, maxq)[1]
    w_m = ck.bc7_refine(px_o, w_s, opaque)
    w_3 = bc67.bc7_search_words(px_o, bc67.SEARCH_MODES_3)[1]
    w_3q = bc67.bc7_search_words(px_o, bc67.SEARCH_MODES_3, 1.0, maxq)[1]
    w_3m = ck.bc7_refine(px_o, w_3q, bc67.SEARCH_MODES_3)
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
    w5 = ck.bc6h_encode(px4, False)[1]
    mid = (bc6h.BC6H_LADDER_MID, bc6h.BC6H_LADDER_MID, False, True, False)
    mxq = (bc6h.BC6H_LADDER_MAXQ, bc6h.BC6H_LADDER_MAXQ, False, True, True)

    ms = {
        "k2_opaque": med(lambda: ck.bc7_encode(px_o)),
        "k2_opaque_aw2": med(lambda: ck.bc7_encode(px_o, opaque, 2.0)),
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
        "k6_mid": int(ck.bc6h_refine(px4, w5, *mid).to(torch.int64).sum()),
        "k6_maxq": int(ck.bc6h_refine(px4, w5, *mxq).to(torch.int64).sum())}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tag": tag, "card": smi, "build_s": build_s,
                      "ms": ms, "full_words_sum": digest,
                      "words_sums": digests}), flush=True)


if __name__ == "__main__":
    main()
