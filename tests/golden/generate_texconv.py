"""Generator of texconv.npz: the JAX package's texconv outputs for BC
targets, frozen so that tests/test_torch_texconv.py holds the PyTorch
port's texconv to them without running the JAX BC encoders.

The outputs are taken with XLA's CPU code limited to AVX
(XLA_FLAGS=--xla_cpu_max_isa=AVX, set here before JAX is imported), as
generate_bc12345.py does: with FMA, XLA contracts `a*b + c` inside a
compiled loop body (BC1-BC3's OptimizeRGB), which the port's eager torch
ops never do.

Keys:
  src_<name> u8: the source files' bytes, made by `sources()` below from
      numpy seed 21: "opaque.tga", a 32 x 16 24-bpp TGA (a gradient with
      noise), and "alpha.tga", a 16 x 16 32-bpp TGA with a smooth alpha
      ramp and a cut-out.
  out_<case>_<name> u8: the output DDS's bytes of the JAX package's
      `texconv -nologo -y <args> -o OUT opaque.tga alpha.tga` (both files
      in one call: every same-(format, flags) file in one compress_many),
      for each case of CASES.

Run from the repository root (about two minutes):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_texconv.py
"""

from __future__ import annotations

import os
import struct
import sys
import tempfile

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_max_isa=AVX").strip()

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
NAMES = ("opaque.tga", "alpha.tga")
# (case, texconv arguments): BC1 and BC7 with full mip chains
CASES = (("bc1", ["-f", "BC1_UNORM", "-m", "0"]),
         ("bc7", ["-f", "BC7_UNORM", "-m", "0"]),
         ("bc7_srgb", ["-f", "BC7_UNORM_SRGB", "-srgb", "-m", "3",
                       "-if", "linear"]))


def _tga(px: np.ndarray) -> bytes:
    """An uncompressed top-down TGA of [H, W, 3 or 4] u8 (RGB(A) order)."""
    h, w, c = px.shape
    bgr = px[..., [2, 1, 0, 3][:c]]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h,
                       8 * c, 0x20 | (8 if c == 4 else 0))
    return head + np.ascontiguousarray(bgr).tobytes()


def sources() -> dict:
    """{name: file bytes} of the two source TGAs (numpy seed 21)."""
    rng = np.random.default_rng(21)
    y, x = np.mgrid[0:16, 0:32].astype(np.float32)
    rgb = np.stack([x / 31, y / 15, (x + y) / 46], -1)
    rgb = np.clip(rgb + rng.normal(0, 0.04, rgb.shape), 0, 1)
    opaque = np.round(rgb * 255).astype(np.uint8)
    y, x = np.mgrid[0:16, 0:16].astype(np.float32)
    rgba = np.stack([np.abs(np.sin(x / 3)), y / 15, x / 15,
                     np.where((x - 8) ** 2 + (y - 8) ** 2 < 20, 0.0,
                              np.clip(y / 15 + 0.2, 0, 1))], -1)
    rgba[..., :3] = np.clip(rgba[..., :3] + rng.normal(0, 0.03, (16, 16, 3)),
                            0, 1)
    alpha = np.round(rgba * 255).astype(np.uint8)
    return {"opaque.tga": _tga(opaque), "alpha.tga": _tga(alpha)}


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from directxtex_tpu.tools import texconv

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for name, data in sources().items():
            out[f"src_{name}"] = np.frombuffer(data, np.uint8)
            paths.append(os.path.join(tmp, name))
            with open(paths[-1], "wb") as f:
                f.write(data)
        for case, args in CASES:
            odir = os.path.join(tmp, case)
            rc = texconv.main(["-nologo", "-y", *args, "-o", odir, *paths])
            if rc != 0:
                raise SystemExit(f"texconv {case} returned {rc}")
            for name in NAMES:
                dds = os.path.join(odir, name.replace(".tga", ".dds"))
                with open(dds, "rb") as f:
                    out[f"out_{case}_{name}"] = np.frombuffer(f.read(),
                                                              np.uint8)
                print(case, name, out[f"out_{case}_{name}"].size)
    np.savez_compressed(os.path.join(HERE, "texconv.npz"), **out)


if __name__ == "__main__":
    main()
