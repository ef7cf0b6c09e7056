"""texdiag — texture diagnostics CLI, on torch tensors.

The counterpart of directxtex_tpu/tools/texdiag.py (Texdiag/texdiag.cpp).
Commands: info, analyze (per-channel min/max/mean/stddev, AnalyzeData
:668), analyzebc (BC mode/partition/rotation histograms, AnalyzeBC :790),
compare (MSE vs a second file), diff (write |a-b| image with optional
threshold highlight), dumpbc (print block encodings — every block, or the
one containing -targetx/-targety), dumpdds (extract raw surfaces).

Each command works on the device the texture is loaded to: BC inputs
decode there (K1 / K4 on CUDA), the statistics and histograms reduce
there (a bincount as a scatter-add, with no host sync), and the numbers a
command prints come back in one copy. `analyze` reduces in f64 where the JAX tool reduces in numpy
f32, so its means and deviations may differ in the last printed digit.
`main(argv, device=None)` runs on CUDA unless the caller names a device.

Usage: python -m directxtex_tpu_torch.tools.texdiag <command> [options] <file> [file2]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..utils.device import resolve


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="texdiag",
                                description=__doc__.split("\n")[0])
    p.add_argument("command", choices=["info", "analyze", "analyzebc",
                                       "compare", "diff", "dumpbc", "dumpdds"])
    p.add_argument("files", nargs="*",
                   help="input files (compare/diff take exactly two; other "
                        "commands accept several, wildcards with -r)")
    p.add_argument("-r", action="store_true", dest="recursive",
                   help="treat arguments as glob patterns, search recursively")
    p.add_argument("-flist", "--file-list", dest="flist", default=None,
                   metavar="FILE",
                   help="read input file paths from a text file")
    p.add_argument("-o", "--output", default=None,
                   help="output file (diff) / base name (dumpdds)")
    p.add_argument("-ft", "--file-type", default="png",
                   choices=["png", "dds", "tga", "hdr", "bmp", "jpg"],
                   help="dumpdds output container")
    p.add_argument("-y", "--overwrite", dest="overwrite",
                   action="store_true", help="overwrite existing files")
    p.add_argument("-l", "--to-lowercase", dest="tolower",
                   action="store_true",
                   help="force output filenames to lowercase")
    p.add_argument("-targetx", "--target-x", dest="targetx", type=int,
                   default=-1, metavar="PX",
                   help="dumpbc: pixel x — dump the block containing it "
                        "(default: dump every block)")
    p.add_argument("-targety", "--target-y", dest="targety", type=int,
                   default=-1, metavar="PX", help="dumpbc: pixel y")
    p.add_argument("-t", "--threshold", type=float, default=0.25,
                   help="diff: highlight threshold")
    p.add_argument("-c", "--diff-color", dest="diffcolor", default=None,
                   metavar="RRGGBB",
                   help="diff: hex highlight color for pixels whose rgb "
                        "difference all exceed the threshold")
    p.add_argument("-m", "--mip", type=int, default=0, help="mip level")
    p.add_argument("-item", type=int, default=0, help="array item")
    p.add_argument("-badtails", "--bad-tails", dest="badtails",
                   action="store_true",
                   help="accept DDS files with truncated DXTn mip tails")
    p.add_argument("-permissive", action="store_true",
                   help="relaxed DDS header validation")
    p.add_argument("-ignoremips", "--ignore-mips", dest="ignoremips",
                   action="store_true",
                   help="ignore the DDS mip chain, load level 0 only")
    p.add_argument("-xlum", "--expand-luminance", action="store_true",
                   dest="expand_luminance",
                   help="expand legacy L8/L16/A8L8 luminance to RGB on load")
    p.add_argument("-tu", "--typeless-unorm", action="store_true",
                   dest="typeless_unorm",
                   help="treat TYPELESS input as UNORM")
    p.add_argument("-tf", "--typeless-float", action="store_true",
                   dest="typeless_float",
                   help="treat TYPELESS input as FLOAT")
    p.add_argument("-nologo", action="store_true")
    p.add_argument("-version", action="store_true",
                   help="print version and exit")
    return p


def _load(path, args=None):
    from ..formats import traits
    from ..io import DDS_FLAGS, load_texture
    kwargs = {}
    if args is not None and str(path).lower().endswith(".dds"):
        dflags = DDS_FLAGS.NONE
        if args.badtails:
            dflags |= DDS_FLAGS.BAD_DXTN_TAILS
        if args.permissive:
            dflags |= DDS_FLAGS.PERMISSIVE
        if args.ignoremips:
            dflags |= DDS_FLAGS.IGNORE_MIPS
        if args.expand_luminance:
            dflags |= DDS_FLAGS.EXPAND_LUMINANCE
        if dflags:
            kwargs["flags"] = dflags
    device = getattr(args, "device", None)
    tex = load_texture(path, device=resolve(device), **kwargs)
    # TYPELESS promotion (-tu / -tf, texdiag.cpp loader options)
    # (the JAX tool's promotion of a BC file fails: ROADMAP queue 3)
    if args is not None and traits.is_typeless(tex.metadata.format):
        promote = (traits.make_typeless_unorm if args.typeless_unorm
                   else traits.make_typeless_float if args.typeless_float
                   else None)
        if promote is not None:
            tex = type(tex)(tex.metadata.with_format(
                promote(tex.metadata.format)), tex.levels)
    return tex


def _decoded(tex):
    from ..ops import decompress
    from ..texture import CompressedTexture
    return decompress(tex) if isinstance(tex, CompressedTexture) else tex


def cmd_info(args, log=print) -> int:
    from ..formats import traits
    from ..texture import CompressedTexture

    tex = _load(args.file, args)
    m = tex.metadata
    log(f"        file: {args.file}")
    log(f"       width: {m.width}")
    log(f"      height: {m.height}")
    log(f"       depth: {m.depth}")
    log(f"   mipLevels: {m.mip_levels if isinstance(tex, CompressedTexture) else tex.mip_levels}")
    log(f"   arraySize: {m.array_size}")
    log(f"      format: {m.format.name}")
    log(f"   dimension: {m.dimension.name}")
    log(f"     cubemap: {m.is_cubemap()}")
    log(f"  alpha mode: {m.alpha_mode().name}")
    log(f"  compressed: {traits.is_compressed(m.format)}")
    bpp = traits.bits_per_pixel(m.format)
    log(f"         bpp: {bpp}")
    return 0


def _level_stats(lvl: torch.Tensor) -> torch.Tensor:
    """[5, 4] f64 on the level's device: min, max, mean and standard
    deviation of r, g, b, a and the luminance (its weights applied in f32,
    as the JAX tool does) over every item of an [N, H, W, 4] level."""
    lum = (lvl[..., 0] * 0.2125 + lvl[..., 1] * 0.7154
           + lvl[..., 2] * 0.0721)
    planes = torch.cat([lvl.reshape(-1, 4).t(), lum.reshape(1, -1)])
    wide = planes.to(torch.float64)
    return torch.stack([planes.amin(1).to(torch.float64),
                        planes.amax(1).to(torch.float64), wide.mean(1),
                        wide.std(1, correction=0)], dim=1)


def cmd_analyze(args, log=print) -> int:
    tex = _decoded(_load(args.file, args))
    for mip, lvl in enumerate(tex.levels):
        stats = _level_stats(lvl).cpu().tolist()
        log(f"  mip {mip} [{lvl.shape[2]}x{lvl.shape[1]}]")
        for name, (mn, mx, mean, std) in zip("rgba", stats):
            log(f"    {name}: min {mn:.6f} max {mx:.6f} "
                f"mean {mean:.6f} stddev {std:.6f}")
        mn, mx, mean, std = stats[4]
        log(f"    luminance: min {mn:.6f} max {mx:.6f} "
            f"mean {mean:.6f} stddev {std:.6f}")
    return 0


def _bc7_mode_table() -> np.ndarray:
    """Byte 0 of a BC7 block -> its mode: the lowest set bit, 8 for 0."""
    b = np.arange(256)
    low = b & -b
    return np.where(b == 0, 8, np.log2(np.maximum(low, 1)).astype(np.int64))


def _hist(x: torch.Tensor, where: torch.Tensor | None, n: int
          ) -> torch.Tensor:
    """Counts of x's values 0..n-1 over the blocks where `where` holds (all
    blocks for None; the others go to an extra bin). torch.bincount's
    values, counted with a scatter-add into n + 1 bins: on CUDA bincount
    reads its input's max and min on the host to size its output."""
    if where is not None:
        x = torch.where(where, x, torch.full_like(x, n))
    counts = torch.zeros(n + 1, dtype=torch.int64, device=x.device)
    return counts.scatter_add_(0, x, torch.ones_like(x))[:n]


def _family(fmt) -> str | None:
    """The BC family whose statistics analyzebc prints (BC7, BC6H, BC1 to
    BC5), or None."""
    for fam in ("BC7", "BC6H", "BC1", "BC2", "BC3", "BC4", "BC5"):
        if fmt.name.startswith(fam + "_"):
            return fam
    return None


def _bc_histograms(fmt, raw: torch.Tensor) -> dict:
    """analyzebc's counts of an [NB, bytes] u8 level on its device, as
    {name: int64 tensor}; the bit positions are the JAX tool's."""
    from ..utils.device import constant

    fam = _family(fmt)
    r = raw.to(torch.int64)

    def u32(off):
        return (r[:, off] | r[:, off + 1] << 8 | r[:, off + 2] << 16
                | r[:, off + 3] << 24)

    out = {}
    if fam == "BC7":
        modes = constant("bc7_mode_of_byte0", _bc7_mode_table,
                         raw.device)[r[:, 0]]
        out["modes"] = _hist(modes, None, 9)
        w0 = u32(0)
        # the partition field sits right after the mode bits (ms_aInfo
        # uPartitionBits, BC6HBC7.cpp:1106-1125)
        for mode, pbits in ((0, 4), (1, 6), (2, 6), (3, 6), (7, 6)):
            out[f"part{mode}"] = _hist((w0 >> (mode + 1)) & ((1 << pbits) - 1),
                                       modes == mode, 1 << pbits)
        for mode in (4, 5):
            out[f"rot{mode}"] = _hist((w0 >> (mode + 1)) & 0x3,
                                      modes == mode, 4)
        out["im4"] = _hist((w0 >> 7) & 0x1, modes == 4, 2)
    elif fam == "BC6H":
        b0 = r[:, 0]
        m2 = b0 & 0x3
        mode = torch.where(m2 < 2, m2, b0 & 0x1F)
        out["modes"] = _hist(mode, None, 32)
        # 2-region modes carry a 5-bit shape at bits 77..81
        # (ms_aDesc D_ entries, BC6HBC7.cpp:879+)
        is2 = ~((mode == 0x03) | (mode == 0x07) | (mode == 0x0B)
                | (mode == 0x0F))
        out["shapes"] = _hist((u32(8) >> 13) & 0x1F, is2, 32)
    elif fam == "BC1":
        c0 = r[:, 0] | r[:, 1] << 8
        c1 = r[:, 2] | r[:, 3] << 8
        out["three"] = (c0 <= c1).sum()[None]
    elif fam == "BC3":
        out["eight"] = (r[:, 0] > r[:, 1]).sum()[None]
    elif fam in ("BC4", "BC5"):
        # BC4S / BC5S endpoints compare as int8
        e = raw.view(torch.int8).to(torch.int64) \
            if fmt.name.endswith("_SNORM") else r
        for c in range(2 if fam == "BC5" else 1):
            out[f"eight{c}"] = (e[:, c * 8] > e[:, c * 8 + 1]).sum()[None]
    return out


def cmd_analyzebc(args, log=print) -> int:
    from ..formats import traits
    from ..texture import CompressedTexture

    tex = _load(args.file, args)
    if not isinstance(tex, CompressedTexture):
        log("analyzebc requires a BC-compressed input", file=sys.stderr)
        return 1
    fmt = tex.metadata.format
    fam = _family(fmt)
    bpb = traits.bytes_per_block(fmt)
    raw = tex.levels[args.mip][args.item].reshape(-1, bpb)
    n = raw.shape[0]
    log(f"  {n} blocks of {fmt.name}")

    hists = _bc_histograms(fmt, raw)
    # the counts come back in one copy
    flat = torch.cat(list(hists.values())).cpu().tolist() if hists else []
    h, off = {}, 0
    for k, v in hists.items():
        h[k] = flat[off:off + v.numel()]
        off += v.numel()

    def pretty(counts):
        return " ".join(f"{v}:{c}" for v, c in enumerate(counts) if c)

    if fam == "BC7":
        for m, count in enumerate(h["modes"]):
            if count:
                log(f"    mode {m}: {count} ({100 * count / n:.1f}%)")
        # partition histograms per partitioned mode (AnalyzeBC,
        # Texdiag/texdiag.cpp:906+)
        for mode in (0, 1, 2, 3, 7):
            if h["modes"][mode]:
                log(f"    mode {mode} partitions: {pretty(h[f'part{mode}'])}")
        # rotation histogram for modes 4/5, index-mode split for mode 4
        for mode in (4, 5):
            if h["modes"][mode]:
                log(f"    mode {mode} rotations: {h[f'rot{mode}']}")
                if mode == 4:
                    log(f"    mode 4 index modes: {h['im4']}")
    elif fam == "BC6H":
        for v, count in enumerate(h["modes"]):
            if count:
                log(f"    mode {v:#04x}: {count} ({100 * count / n:.1f}%)")
        if sum(h["shapes"]):
            log(f"    2-region shapes: {pretty(h['shapes'])}")
    elif fam == "BC1":
        three = h["three"][0]
        log(f"    4-color blocks: {n - three}")
        log(f"    3-color blocks (incl. transparent): {three}")
    elif fam == "BC3":
        # color half at bytes 8..15 is always 4-color; BC3 alpha adds a
        # 6- vs 8-step codec choice (AnalyzeBC, Texdiag/texdiag.cpp:790+)
        eight = h["eight"][0]
        log(f"    8-step alpha blocks: {eight}")
        log(f"    6-step alpha blocks: {n - eight}")
    elif fam == "BC2":
        log(f"    explicit 4-bit alpha blocks: {n}")
    elif fam in ("BC4", "BC5"):
        for c, name in enumerate(("red", "green")[:2 if fam == "BC5"
                                                   else 1]):
            eight = h[f"eight{c}"][0]
            log(f"    {name}: 8-step blocks {eight}, "
                f"6-step blocks {n - eight}")
    else:
        log("    (no per-mode statistics for this format)")
    return 0


def cmd_compare(args, log=print) -> int:
    from ..ops import compute_mse, compute_psnr

    a = _decoded(_load(args.file, args))
    b = _decoded(_load(args.file2, args))
    ia, ib = a.image(), b.image()
    if ia.shape != ib.shape:
        log(f"ERROR: image sizes differ {tuple(ia.shape)} vs "
            f"{tuple(ib.shape)}")
        return 1
    mse, mse_v = compute_mse(ia, ib, fmt1=a.metadata.format,
                             fmt2=b.metadata.format)
    psnr = compute_psnr(ia, ib)
    mse, r, g, b_, a_, psnr = torch.cat(
        [mse[None], mse_v, psnr[None]]).cpu().tolist()
    log(f"  MSE: {mse:.9f}")
    log(f"  per-channel: r {r:.9f} g {g:.9f} b {b_:.9f} a {a_:.9f}")
    log(f"  PSNR: {psnr:.2f} dB")
    return 0


def diff_image(ia: torch.Tensor, ib: torch.Tensor, diffcolor=None,
               threshold: float = 0.25) -> torch.Tensor:
    """|a - b| with alpha 1; with `diffcolor` (RRGGBB hex), pixels whose r,
    g and b differences all reach `threshold` take that color. On the
    images' device."""
    d = (ia - ib).abs()
    d = torch.cat([d[..., :3], torch.ones_like(d[..., 3:])], dim=-1)
    if diffcolor:
        cv = int(diffcolor, 16)
        color = torch.tensor([(cv >> 16 & 0xFF) / 255.0,
                              (cv >> 8 & 0xFF) / 255.0,
                              (cv & 0xFF) / 255.0, 1.0], dtype=torch.float32,
                             device=d.device)
        thr = torch.tensor(threshold, dtype=torch.float32, device=d.device)
        hit = (d[..., :3] >= thr).all(dim=-1)
        d = torch.where(hit[..., None], color, d)
    return d.clamp(0, 1)


def cmd_diff(args, log=print) -> int:
    """|a-b| difference image; with -c, pixels whose r, g and b
    differences all reach the -t threshold are painted the highlight
    color instead (Texdiag/texdiag.cpp:1281-1305)."""
    from ..io import save_texture
    from ..texture import Texture

    a = _decoded(_load(args.file, args))
    b = _decoded(_load(args.file2, args))
    d = diff_image(a.image(), b.image(), args.diffcolor, args.threshold)
    out = _out_path(args, args.output or "diff.png")
    if out is None:
        return 1
    save_texture(Texture.from_array(d, device=d.device), out)
    log(f"  wrote {out}")
    return 0


def cmd_dumpbc(args, log=print) -> int:
    from ..formats import traits
    from ..ops.compress import _DECODERS, _decode_blocks
    from ..texture import CompressedTexture

    tex = _load(args.file, args)
    if not isinstance(tex, CompressedTexture):
        log("dumpbc requires a BC-compressed input")
        return 1
    fmt = tex.metadata.format
    bpb = traits.bytes_per_block(fmt)
    w, h, _ = tex.metadata.mip_dims(args.mip)
    nbw, nbh = (w + 3) // 4, (h + 3) // 4
    raw = tex.levels[args.mip][args.item].reshape(-1, bpb)
    if args.targetx >= 0 or args.targety >= 0:
        # -targetx/-targety are pixel coordinates; dump the containing
        # block (DumpBCImage, Texdiag/texdiag.cpp:1504-1552)
        px = max(args.targetx, 0)
        py = max(args.targety, 0)
        if px >= w or py >= h:
            log(f"WARNING: pixel ({px},{py}) out of range for {w}x{h}")
            return 1
        picks = [(px // 4, py // 4)]
        blocks = raw[_block_index(picks, nbw, raw.device)]
    else:
        picks = [(bx, by) for by in range(nbh) for bx in range(nbw)]
        blocks = raw
    # every picked block decodes in one call (K1 / K4 on CUDA); bytes and
    # texels come back in one copy
    texels = _decode_blocks(_DECODERS[fmt], blocks)
    host = torch.cat([blocks, texels.reshape(len(picks), -1)
                      .view(torch.uint8)], dim=1).cpu().numpy()
    values = np.ascontiguousarray(host[:, bpb:]).view(np.float32) \
        .reshape(-1, 16, 4)
    for k, (bx, by) in enumerate(picks):
        log(f"  block ({bx},{by}) of {fmt.name}: "
            + " ".join(f"{v:02x}" for v in host[k, :bpb]))
        for row in range(4):
            log("   " + "  ".join(
                "(" + ",".join(f"{values[k, row * 4 + c_, ch]:.3f}"
                               for ch in range(4)) + ")"
                for c_ in range(4)))
    return 0


def _block_index(picks, nbw: int, device) -> torch.Tensor:
    """The block indices of (bx, by) picks in a level nbw blocks wide."""
    return torch.tensor([by * nbw + bx for bx, by in picks],
                        dtype=torch.int64, device=device)


def cmd_dumpdds(args, log=print) -> int:
    """Extract every surface of a complex DDS as its own file
    (CMD_DUMPDDS, Texdiag/texdiag.cpp:3753+). The reference rejects
    BC-compressed inputs; here they are decompressed first (superset).
    Naming follows the reference: _itemNNN/_sliceNNN + _mipNNN."""
    from ..io import save_texture
    from ..texture import Texture

    tex = _decoded(_load(args.file, args))
    base = args.output or os.path.splitext(os.path.basename(args.file))[0]
    ext = args.file_type
    is_volume = tex.metadata.depth > 1
    count = 0
    for mip in range(tex.mip_levels):
        for item in range(tex.levels[mip].shape[0]):
            tag = "slice" if is_volume else "item"
            name = f"{base}_{tag}{item:03d}"
            if tex.mip_levels > 1:
                name += f"_mip{mip:03d}"
            img = tex.image(mip, item)
            if ext in ("png", "bmp", "jpg", "tga"):
                img = img.clamp(0, 1)
            out = _out_path(args, f"{name}.{ext}")
            if out is None:
                return 1
            save_texture(Texture.from_array(img, device=img.device), out)
            count += 1
    log(f"  wrote {count} surfaces")
    return 0


def _out_path(args, name):
    """Apply -l lowercase and the -y overwrite guard to an output path."""
    if args.tolower:
        name = name.lower()
    if os.path.exists(name) and not args.overwrite:
        print(f"error: {name} exists (use -y to overwrite)",
              file=sys.stderr)
        return None
    return name


def main(argv=None, device=None) -> int:
    """The CLI on `device` (CUDA unless named); returns the exit code."""
    if "-version" in (argv if argv is not None else sys.argv[1:]):
        from .. import __version__
        print(f"texdiag (directxtex_tpu_torch) {__version__}")
        return 0
    args = build_parser().parse_args(argv)
    args.device = resolve(device)
    if not args.nologo:
        print("texdiag (directxtex_tpu_torch)")
    cmds = {"info": cmd_info, "analyze": cmd_analyze,
            "analyzebc": cmd_analyzebc, "compare": cmd_compare,
            "diff": cmd_diff, "dumpbc": cmd_dumpbc, "dumpdds": cmd_dumpdds}

    from .texconv import expand_files, read_file_list
    patterns = list(args.files)
    if args.flist:
        patterns.extend(read_file_list(args.flist))
    if args.command in ("compare", "diff"):
        if len(patterns) != 2:
            print("error: command requires two files", file=sys.stderr)
            return 1
        args.file, args.file2 = patterns
        return cmds[args.command](args)
    files = expand_files(patterns, args.recursive)
    if not files:
        print("error: no input files matched", file=sys.stderr)
        return 1
    failed = 0
    for path in files:
        if len(files) > 1:
            print(f"  --- {path}")
        args.file = path
        try:
            if cmds[args.command](args) != 0:
                failed += 1
        except Exception as e:  # keep going like the reference tool
            print(f"  FAILED {path}: {e}", file=sys.stderr)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
