"""ddsview — render any DDS to a viewable PNG, on torch tensors.

The counterpart of directxtex_tpu/tools/ddsview.py (DDSView/ddsview.cpp).
The reference is a minimal D3D11 window that shows one item at a time and
navigates arrays/volume slices with the arrow/digit keys
(ddsview.cpp:364-386) and renders cubemaps as a horizontal cross
(ddsview.cpp:578). This tool renders the same layouts to PNG files:

- 2D images directly; cubemaps as the same horizontal cross
- texture arrays / volume slices: one item via -i, or a tiled contact
  sheet (default)
- mip selection via -m, or a full mip strip via --mips
- --interactive: a terminal loop with the reference's navigation keys
  (n/p = next/prev item like VK_RIGHT/VK_LEFT, 1-9/0 = jump to index,
  m = cycle mip, q = quit), re-rendering the PNG on every step

The texture is loaded and decoded on the device (K1 / K4 for BC on
CUDA), the preview is put together there, and a write makes one copy to
the host for the PNG encoder. `main(argv, device=None)` runs on CUDA
unless the caller names a device.

Usage: python -m directxtex_tpu_torch.tools.ddsview file.dds [-o out.png]
       [-m MIP] [-i ITEM] [--mips] [--interactive] [--tonemap]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import torch

from ..utils.device import resolve


def render_preview(tex, mip: int = 0, item: int | None = None
                   ) -> torch.Tensor:
    """[H', W', 4] f32 preview of a (decompressed) texture level, on its
    device.

    item=None composes the whole level (cube cross / contact sheet);
    an integer renders that array item / volume slice alone, matching the
    reference's one-item-at-a-time view (ddsview.cpp:770 cb.Index)."""
    from .texassemble import cube_layout

    lvl = tex.levels[mip]
    n = lvl.shape[0]
    if item is not None:
        return lvl[min(max(item, 0), n - 1)]
    if tex.metadata.is_cubemap() and n >= 6:
        return cube_layout(list(lvl[:6]), "h-cross")
    if n == 1:
        return lvl[0]
    # array / volume: tile into a roughly square contact sheet
    cols = int(math.ceil(math.sqrt(n)))
    rows_n = (n + cols - 1) // cols
    h, w = lvl.shape[1:3]
    canvas = lvl.new_zeros((rows_n * h, cols * w, 4))
    for i in range(n):
        r, c = divmod(i, cols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = lvl[i]
    return canvas


def render_mip_strip(tex, item: int | None = None) -> torch.Tensor:
    """All mip levels side by side (top-aligned), one strip."""
    imgs = [render_preview(tex, m, item) for m in range(tex.mip_levels)]
    h = imgs[0].shape[0]
    w = sum(i.shape[1] for i in imgs)
    canvas = imgs[0].new_zeros((h, w, 4))
    x = 0
    for i in imgs:
        canvas[:i.shape[0], x:x + i.shape[1]] = i
        x += i.shape[1]
    return canvas


def _write(img: torch.Tensor, out: str, tonemap: bool) -> None:
    from ..io import save_texture
    from ..texture import Texture
    if tonemap:
        img = torch.div(img, 1.0 + img)
        img = torch.cat([img[..., :3], torch.ones_like(img[..., 3:])], -1)
    save_texture(Texture.from_array(img.clamp(0, 1), device=img.device),
                 out)
    print(f"  wrote {out} ({img.shape[1]}x{img.shape[0]})")


def _interactive(tex, out: str, tonemap: bool) -> int:
    """Terminal navigation loop (the reference's WndProc key handling,
    ddsview.cpp:364-386, without a window system)."""
    n_items = tex.levels[0].shape[0]
    item = 0
    mip = 0
    while True:
        img = render_preview(tex, mip, item if n_items > 1 else None)
        _write(img, out, tonemap)
        print(f"[item {item + 1}/{n_items}  mip {mip + 1}/{tex.mip_levels}]"
              " n=next p=prev 1-9/0=index m=mip q=quit > ", end="",
              flush=True)
        try:
            key = input().strip().lower() or "q"
        except EOFError:
            return 0
        if key == "q":
            return 0
        if key == "n" and item < n_items - 1:      # VK_RIGHT
            item += 1
        elif key == "p" and item > 0:              # VK_LEFT
            item -= 1
        elif key == "m":
            mip = (mip + 1) % tex.mip_levels
        elif key.isdigit():                        # '1'-'9', '0' = 10
            idx = 9 if key == "0" else int(key) - 1
            if idx < n_items:
                item = idx


def main(argv=None, device=None) -> int:
    """The CLI on `device` (CUDA unless named); returns the exit code."""
    p = argparse.ArgumentParser(prog="ddsview",
                                description=__doc__.split("\n")[0])
    p.add_argument("file")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-m", "--mip", type=int, default=0)
    p.add_argument("-i", "--item", type=int, default=None,
                   help="render one array item / volume slice")
    p.add_argument("--mips", action="store_true",
                   help="render every mip level as one strip")
    p.add_argument("--interactive", action="store_true",
                   help="terminal navigation loop (n/p/digits/m/q)")
    p.add_argument("--tonemap", action="store_true",
                   help="Reinhard-tonemap HDR content for preview")
    p.add_argument("-nologo", action="store_true")
    args = p.parse_args(argv)
    if not args.nologo:
        print("ddsview (directxtex_tpu_torch)")

    from ..io import load_texture
    from ..ops import decompress
    from ..texture import CompressedTexture

    tex = load_texture(args.file, device=resolve(device))
    if isinstance(tex, CompressedTexture):
        tex = decompress(tex)
    if args.mip >= tex.mip_levels:
        print(f"error: mip {args.mip} out of range", file=sys.stderr)
        return 1
    n_items = tex.levels[0].shape[0]
    if args.item is not None and args.item >= n_items:
        print(f"error: item {args.item} out of range ({n_items})",
              file=sys.stderr)
        return 1
    out = args.output or os.path.splitext(args.file)[0] + "_view.png"
    if args.interactive:
        return _interactive(tex, out, args.tonemap)
    if args.mips:
        img = render_mip_strip(tex, args.item)
    else:
        img = render_preview(tex, args.mip, args.item)
    _write(img, out, args.tonemap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
