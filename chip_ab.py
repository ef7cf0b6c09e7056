#!/usr/bin/env python3
"""Time the BC7 search and refine launches of one checkout on one GPU.

Runs K2's opaque search (alpha weights 1.0 and 2.0), each K3 call of the
BC7 paths as its launcher's whole call (the default, alpha and maxq
MOMENT scopes, LADDER_FULL and LADDER_LIGHT, modes 0 and 2 under MOMENT
and FULL) and the 2048^2 paths (default opaque and with alpha, maxq,
USE_3SUBSETS) of the checkout at ROOT, at the shapes of chip_smoke.py's
bench images, and prints one JSON line of median CUDA-event times in ms
with the card's name and power limit. To compare two checkouts on one
card, run it from both on that card, in turns (A, B, B, A):

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
    from directxtex_tpu_torch.bc import bc67, cuda_kernels as ck
    from directxtex_tpu_torch.bc.common import image_to_blocks

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

    def path(img, flags=0, **kw):
        return lambda: bc67.encode_bc7(image_to_blocks(img)[0], flags, **kw)

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
    }
    # the refined words, to show both checkouts compute the same
    digest = int(ck.bc7_refine(px_o, w_m, opaque, 1.0, full)
                 .to(torch.int64).sum())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tag": tag, "card": smi, "build_s": build_s,
                      "ms": ms, "full_words_sum": digest}), flush=True)


if __name__ == "__main__":
    main()
