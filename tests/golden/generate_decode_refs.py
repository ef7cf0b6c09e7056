"""Generator of decode_refs.npz: the JAX package's decode_bc7 and
decode_bc6h on the inputs that tests/test_torch_bc7_decode.py and
tests/test_torch_bc6h_decode.py draw, frozen so that those tests run no
JAX call (they took 22 s and 13 s of the tier-1 run).

Keys, each the JAX decode's [NB, 16, 4] f32 output:

- bc7_mode{m}, m = 0..7: 64 random blocks of mode m
  (test_torch_bc7_decode._mode_blocks(m, 64, 500 + m));
- bc7_mixed: 256 random blocks (numpy seed 77), every 11th reserved;
- bc7_layout: 40 random blocks (numpy seed 5);
- bc6h_mixed_u, bc6h_mixed_s: 512 random blocks (numpy seed 41, 42),
  every 7th with the reserved header 0b10011, decoded unsigned / signed.

Run from the repository root (about half a minute):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_decode_refs.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> None:
    from directxtex_tpu.bc import bc67 as jbc67
    from test_torch_bc6h_decode import _mixed_blocks as bc6h_mixed
    from test_torch_bc7_decode import _layout_blocks, _mixed_blocks, \
        _mode_blocks

    out = {}
    for mode in range(8):
        out[f"bc7_mode{mode}"] = np.asarray(jbc67.decode_bc7(
            _mode_blocks(mode, 64, 500 + mode)))
    out["bc7_mixed"] = np.asarray(jbc67.decode_bc7(_mixed_blocks()))
    out["bc7_layout"] = np.asarray(jbc67.decode_bc7(_layout_blocks()))
    for signed, key in ((False, "bc6h_mixed_u"), (True, "bc6h_mixed_s")):
        out[key] = np.asarray(jbc67.decode_bc6h(bc6h_mixed(signed), signed))
    np.savez_compressed(os.path.join(HERE, "decode_refs.npz"), **out)
    print("decode_refs.npz written:", sorted(out))


if __name__ == "__main__":
    main()
