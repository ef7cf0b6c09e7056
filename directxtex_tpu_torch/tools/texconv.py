"""texconv — batch texture converter CLI, on torch tensors.

The counterpart of directxtex_tpu/tools/texconv.py. Mirrors the reference
tool's per-file stage pipeline (Texconv/texconv.cpp: load :2034 ->
planar->single :2276 -> decompress :2316 -> undo premul :2482 ->
flip/rotate :2533 -> resize :2576 -> swizzle :2645 -> tonemap :2966 ->
convert :3046 -> colorkey :3134 -> invert-y :3193 -> reconstruct-z :3242
-> mips :3309 -> alpha coverage :3457 -> premultiply :3504 -> compress
:3550 -> save :3768) with the whole middle on the device: one upload per
input, one readback at save (SURVEY.md §3.4). With several files, every
file headed for the same (BC format, flags) encodes in one
ops.compress_many call.

`main(argv, device=None)` runs on CUDA unless the caller names a device
(the command line has no option for it, as the JAX tool has none).

Usage: python -m directxtex_tpu_torch.tools.texconv [options] <files...>
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch

from .. import numerics
from ..utils.device import resolve
from ..utils.timing import synchronize


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="texconv", description=__doc__.split("\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("files", nargs="*", help="input image files (may be "
                   "empty when -flist is given)")
    p.add_argument("-r", action="store_true", dest="recursive",
                   help="treat arguments as glob patterns, search recursively")
    p.add_argument("-f", "--format", default=None,
                   help="target DXGI format name (e.g. BC7_UNORM)")
    p.add_argument("-ft", "--file-type", default="dds",
                   choices=["dds", "tga", "hdr", "exr", "png", "jpg", "bmp",
                            "tiff", "ppm", "pfm", "phm", "heic", "avif"],
                   help="output container")
    p.add_argument("-o", "--outdir", default=".", help="output directory")
    p.add_argument("-px", "--prefix", default="", help="output name prefix")
    p.add_argument("-sx", "--suffix", default="", help="output name suffix")
    p.add_argument("-y", action="store_true", dest="overwrite",
                   help="overwrite existing files")
    p.add_argument("-w", "--width", type=int, default=0, help="target width")
    p.add_argument("-ht", "--height", type=int, default=0, help="target height")
    p.add_argument("-m", "--mips", "--mip-levels", dest="mips", type=int, default=None,
                   help="mip count (0 = full chain, 1 = none)")
    p.add_argument("-if", "--image-filter", default="fant",
                   choices=["point", "linear", "cubic", "fant", "box", "triangle"],
                   help="resize/mip filter")
    p.add_argument("-srgb", action="store_true", help="sRGB in and out")
    p.add_argument("-srgbi", "--srgb-in", dest="srgbi", action="store_true", help="sRGB input")
    p.add_argument("-srgbo", "--srgb-out", dest="srgbo", action="store_true", help="sRGB output")
    p.add_argument("-wrap", action="store_true", help="wrap filtering")
    p.add_argument("-mirror", action="store_true", help="mirror filtering")
    p.add_argument("-dither", choices=["none", "ordered", "diffusion"],
                   default="none",
                   help="dither when converting to a lower-bit-depth format")
    p.add_argument("-sepalpha", "--separate-alpha", dest="sepalpha", action="store_true",
                   help="resize alpha separately")
    p.add_argument("-keepcoverage", "--keep-coverage", dest="keepcoverage", type=float, default=None, metavar="REF",
                   help="preserve alpha coverage for mips at reference")
    p.add_argument("-pmalpha", "--premultiplied-alpha", dest="pmalpha", action="store_true",
                   help="convert to premultiplied alpha")
    p.add_argument("-alpha", action="store_true",
                   help="convert from premultiplied to straight alpha")
    p.add_argument("-hflip", "--horizontal-flip", dest="hflip", action="store_true", help="horizontal flip")
    p.add_argument("-vflip", "--vertical-flip", dest="vflip", action="store_true", help="vertical flip")
    p.add_argument("-rotate", type=int, default=0, choices=[0, 90, 180, 270],
                   help="rotation angle")
    p.add_argument("-nmap", "--normal-map", dest="nmap", default=None, metavar="CHANNELS",
                   help="compute normal map (l=luminance, r/g/b/a channel, "
                        "m=mirror, i=invert, o=occlusion), e.g. 'lo'")
    p.add_argument("-nmapamp", "--normal-map-amplitude", dest="nmapamp", type=float, default=1.0,
                   help="normal map amplitude")
    p.add_argument("-bc", "--block-compress", dest="bc", default="", metavar="FLAGS",
                   help="BC flags: d=dither, u=uniform, q=quick, "
                        "x=3subsets, m=max quality (endpoint ladder), "
                        "b=BC6H mid quality tier")
    p.add_argument("-at", "--alpha-threshold", type=float, default=0.5,
                   help="BC1 alpha threshold")
    p.add_argument("-aw", "--alpha-weight", type=float, default=1.0,
                   help="BC7 alpha error weight (CompressOptions."
                        "alphaWeight)")
    p.add_argument("-tonemap", action="store_true",
                   help="Reinhard tonemap HDR to LDR")
    p.add_argument("-rotatecolor", "--rotate-color", dest="rotatecolor", default=None,
                   choices=["709to2020", "2020to709", "709toHDR10",
                            "HDR10to709", "P3D65toHDR10", "P3D65to2020",
                            "709toP3D65", "P3D65to709"],
                   help="rotate color primaries / HDR10 PQ transfer")
    p.add_argument("-nits", "--paper-white-nits", dest="nits", type=float, default=200.0,
                   help="paper-white nits for HDR10 rotations")
    p.add_argument("-pow2", "--fit-power-of-2", action="store_true", dest="fit_pow2",
                   help="fit dimensions to powers of 2 (rounding down)")
    p.add_argument("-x2bias", "--x2-bias", dest="x2bias", action="store_true",
                   help="x2 bias for UNORM<->FLOAT conversions")
    p.add_argument("-tu", "--typeless-unorm", action="store_true", dest="typeless_unorm",
                   help="treat TYPELESS input as UNORM")
    p.add_argument("-tf", "--typeless-float", action="store_true", dest="typeless_float",
                   help="treat TYPELESS input as FLOAT")
    p.add_argument("-badtails", "--bad-tails", dest="badtails", action="store_true",
                   help="accept DDS files with truncated DXTn mip tails")
    p.add_argument("-permissive", action="store_true",
                   help="relaxed DDS header validation")
    p.add_argument("-ignoremips", "--ignore-mips", dest="ignoremips", action="store_true",
                   help="ignore the DDS mip chain, load level 0 only")
    p.add_argument("-swizzle", default=None, metavar="RGBA",
                   help="channel swizzle mask, e.g. 'bgra' or 'rrra'")
    p.add_argument("-c", "--colorkey", "--color-key", dest="colorkey", default=None, metavar="RRGGBB",
                   help="hex colorkey to convert to transparent")
    p.add_argument("-inverty", "--invert-y", dest="inverty", action="store_true",
                   help="invert the green channel (normal map Y flip)")
    p.add_argument("-reconstructz", "--reconstruct-z", dest="reconstructz", action="store_true",
                   help="rebuild Z (blue) channel from X/Y for BC5 normals")
    p.add_argument("-fixbc4x4", "--fix-bc-4x4", dest="fixbc4x4", action="store_true",
                   help="round size down to multiple of 4 for BC")
    p.add_argument("-wicq", "--wic-quality", dest="wicq", type=float, default=None, metavar="Q",
                   help="WIC codec quality 0.0-1.0 (JPEG quality / PNG "
                        "compression effort)")
    p.add_argument("-wicmulti", "--wic-multiframe", dest="wicmulti", action="store_true",
                   help="save texture arrays as multiframe GIF/TIFF")
    p.add_argument("-timing", action="store_true", help="print per-stage times")
    p.add_argument("-profile", dest="profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the whole "
                        "run to DIR/trace.json (SURVEY §5 tracing analog "
                        "of ENABLE_CODE_PROFILING)")
    p.add_argument("-nologo", action="store_true", help="suppress banner")
    p.add_argument("-version", action="store_true",
                   help="print version and exit")
    p.add_argument("-dx9", action="store_true", help="force DX9 legacy DDS")
    p.add_argument("-dx10", action="store_true", help="force DX10 ext DDS")
    p.add_argument("-l", "--to-lowercase", action="store_true", dest="tolower",
                   help="force output filename to lowercase")
    p.add_argument("-flist", "--file-list", dest="flist", default=None, metavar="FILE",
                   help="read input file paths from a text file (one per "
                        "line, # comments)")
    p.add_argument("-tga20", action="store_true",
                   help="write TGA 2.0 extension area (always written by "
                        "this implementation; accepted for compatibility)")
    p.add_argument("-tgazeroalpha", "--tga-zero-alpha", dest="tgazeroalpha", action="store_true",
                   help="allow all-zero-alpha TGA channel instead of "
                        "treating it as opaque")
    p.add_argument("-xlum", "--expand-luminance", action="store_true", dest="expand_luminance",
                   help="expand legacy L8/L16/A8L8 luminance to RGB on load")
    p.add_argument("-dword", "--dword-alignment", action="store_true", dest="dword_align",
                   help="use legacy DWORD-aligned pitch for DDS save")
    p.add_argument("-fl", "--feature-level", default=None, metavar="LEVEL",
                   help="Direct3D feature level size limit to validate "
                        "against (9.1-12.2)")
    p.add_argument("-wiclossless", "--wic-lossless", dest="wiclossless", action="store_true",
                   help="use lossless encoding when the WIC-style codec "
                        "supports it")
    p.add_argument("-ignoresrgb", "--ignore-srgb", dest="ignoresrgb", action="store_true",
                   help="ignore sRGB metadata in the input image")
    # accepted for command-line compatibility; the port encodes on the
    # device main() is given (it has no WIC and no CPU/GPU split)
    p.add_argument("-nowic", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("-singleproc", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("-gpu", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("-nogpu", action="store_true", help=argparse.SUPPRESS)
    return p


# Direct3D feature level -> max 2D texture extent
# (texconv.cpp OPT_FEATURE_LEVEL handling)
FEATURE_LEVEL_MAX_SIZE = {
    "9.1": 2048, "9.2": 2048, "9.3": 4096,
    "10.0": 8192, "10.1": 8192,
    "11.0": 16384, "11.1": 16384,
    "12.0": 16384, "12.1": 16384, "12.2": 16384,
}


def _filter_flags(args):
    from ..ops.flags import TEX_FILTER_FLAGS as TF
    mode = {
        "point": TF.POINT, "linear": TF.LINEAR, "cubic": TF.CUBIC,
        "fant": TF.FANT, "box": TF.BOX, "triangle": TF.TRIANGLE,
    }[args.image_filter]
    flags = TF(mode)
    if args.wrap:
        flags |= TF.WRAP
    if args.mirror:
        flags |= TF.MIRROR
    if args.sepalpha:
        flags |= TF.SEPARATE_ALPHA
    if args.srgb or args.srgbi:
        flags |= TF.SRGB_IN
    if args.srgb or args.srgbo:
        flags |= TF.SRGB_OUT
    if getattr(args, "x2bias", False):
        flags |= TF.FLOAT_X2BIAS
    if getattr(args, "dither", "none") == "ordered":
        flags |= TF.DITHER
    elif getattr(args, "dither", "none") == "diffusion":
        flags |= TF.DITHER_DIFFUSION
    return flags


def _swizzle(img, sw, chan):
    outs = []
    for c in sw:
        if c == "0":
            outs.append(torch.zeros_like(img[..., 0]))
        elif c == "1":
            outs.append(torch.ones_like(img[..., 0]))
        else:
            outs.append(img[..., chan[c]])
    return torch.stack(outs, dim=-1)


def _tonemap(img):
    """Reinhard with the max-luminance white point; the max stays on the
    device."""
    lum = (img[..., 0] * 0.2126 + img[..., 1] * 0.7152
           + img[..., 2] * 0.0722)
    max_lum = torch.clamp_min(lum.max(), 1e-6)
    scale = (1.0 + lum / (max_lum * max_lum)) / (1.0 + lum)
    return torch.cat([img[..., :3] * scale[..., None], img[..., 3:]], -1)


def _colorkey(img, kr, kg, kb):
    d = ((img[..., 0] - kr).abs() + (img[..., 1] - kg).abs()
         + (img[..., 2] - kb).abs())
    a = torch.where(d < (3.0 / 255.0), torch.zeros_like(d), img[..., 3])
    return torch.cat([img[..., :3], a[..., None]], -1)


def _invert_y(img):
    return torch.cat([img[..., :1], 1.0 - img[..., 1:2], img[..., 2:]], -1)


def _reconstruct_z(img):
    x = img[..., 0] * 2.0 - 1.0
    y = img[..., 1] * 2.0 - 1.0
    z = numerics.sqrt(numerics.clip(1.0 - x * x - y * y, 0.0, 1.0))
    return torch.cat([img[..., :2], (z * 0.5 + 0.5)[..., None],
                      img[..., 3:]], -1)


class _StageTimer:
    """-timing per-stage breakdown; each mark waits for the texture's
    device (the reference prints one wall-clock per file, texconv.cpp
    OPT_TIMING; the device-resident pipeline warrants per-stage
    visibility). A failing synchronize raises."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.t = time.perf_counter()
        self.rows = []

    def mark(self, name, tex_=None):
        if not self.enabled:
            return
        if tex_ is not None:
            synchronize(tex_.device)
        now = time.perf_counter()
        self.rows.append((name, now - self.t))
        self.t = now


def process_file(path: str, args, log=print, defer_compress=None,
                 device=None):
    """Run the full stage pipeline on one file on `device` (CUDA unless
    named); returns the output path.

    With `defer_compress` (a list), a file headed for BC compression stops
    before the encode: (tex, fmt, cflags, path) is appended and None is
    returned so the caller can batch many files into one device dispatch
    (ops.compress_many; SURVEY §2.4's batch design)."""
    from ..formats import FMT, format_from_name, traits
    from ..io import DDS_FLAGS, load_texture, save_texture
    from ..ops import (
        TEX_COMPRESS_FLAGS as TC, TEX_FR_FLAGS as FR,
        compress, convert, decompress, flip_rotate, generate_mipmaps,
        premultiply_alpha, resize, scale_mipmaps_alpha_for_coverage,
        transform_image,
    )
    from ..ops.flags import CNMAP_FLAGS, TEX_PMALPHA_FLAGS as PM
    from ..ops.normalmaps import compute_normal_map
    from ..texture import CompressedTexture

    t0 = time.perf_counter()
    st = _StageTimer(args.timing)
    load_kwargs = {}
    lower = path.lower()
    if lower.endswith(".dds"):
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
            load_kwargs["flags"] = dflags
    elif lower.endswith(".tga") and args.tgazeroalpha:
        from ..io.tga import TGA_FLAGS
        load_kwargs["flags"] = TGA_FLAGS.ALLOW_ALL_ZERO_ALPHA
    tex = load_texture(path, device=resolve(device), **load_kwargs)

    # -ignoresrgb: drop the input's sRGB colorspace metadata
    # (OPT_IGNORE_SRGB_METADATA, texconv.cpp)
    if args.ignoresrgb and traits.is_srgb(tex.metadata.format):
        tex = tex.replace_levels(tex.levels, tex.metadata.with_format(
            traits.make_linear(tex.metadata.format)))

    if args.feature_level:
        max_size = FEATURE_LEVEL_MAX_SIZE.get(args.feature_level)
        if max_size is None:
            raise ValueError(f"unknown feature level {args.feature_level}")
        if max(tex.metadata.width, tex.metadata.height) > max_size:
            raise ValueError(
                f"{tex.metadata.width}x{tex.metadata.height} exceeds feature "
                f"level {args.feature_level} limit ({max_size})")

    # TYPELESS promotion (-tu / -tf, texconv.cpp:2245-2263)
    if traits.is_typeless(tex.metadata.format):
        if args.typeless_unorm:
            tex = tex.replace_levels(tex.levels, tex.metadata.with_format(
                traits.make_typeless_unorm(tex.metadata.format)))
        elif args.typeless_float:
            tex = tex.replace_levels(tex.levels, tex.metadata.with_format(
                traits.make_typeless_float(tex.metadata.format)))

    st.mark("load", tex)

    # decompress BC input (texconv.cpp:2316)
    if isinstance(tex, CompressedTexture):
        tex = decompress(tex)
        st.mark("decompress", tex)

    target_fmt = (format_from_name(args.format) if args.format
                  else tex.metadata.format)

    # undo premultiplied alpha when asked (:2482)
    if args.alpha and tex.metadata.is_pm_alpha():
        tex = premultiply_alpha(tex, PM.REVERSE)

    # flip / rotate (:2533)
    fr = FR(0)
    if args.rotate:
        fr |= {90: FR.ROTATE90, 180: FR.ROTATE180, 270: FR.ROTATE270}[args.rotate]
    if args.hflip:
        fr |= FR.FLIP_HORIZONTAL
    if args.vflip:
        fr |= FR.FLIP_VERTICAL
    if fr:
        tex = flip_rotate(tex, fr)

    filt = _filter_flags(args)

    # resize (:2576); -pow2 fits each axis to the next power of 2 down
    # (FitPowerOf2, texconv.cpp:500-540)
    tw = args.width or tex.metadata.width
    th = args.height or tex.metadata.height
    if args.fit_pow2:
        def _pow2_down(v):
            return 1 << max(0, v.bit_length() - 1)
        tw, th = _pow2_down(tw), _pow2_down(th)
    if args.fixbc4x4 and traits.is_compressed(target_fmt):
        tw, th = max(4, tw & ~3), max(4, th & ~3)
    if (tw, th) != (tex.metadata.width, tex.metadata.height):
        tex = resize(tex, tw, th, filt)
        st.mark("resize", tex)

    # swizzle (:2645): HLSL-style mask incl. '0'/'1' literals
    # (ParseSwizzleMask, texconv.cpp:1157-1240)
    if args.swizzle:
        chan = {"r": 0, "g": 1, "b": 2, "a": 3,
                "x": 0, "y": 1, "z": 2, "w": 3}
        sw = list(args.swizzle.lower())
        if not 1 <= len(sw) <= 4 or any(
                c not in chan and c not in "01" for c in sw):
            raise ValueError(f"invalid swizzle mask {args.swizzle!r}")
        while len(sw) < 4:
            sw.append(sw[-1])
        tex = transform_image(tex, lambda img: _swizzle(img, sw, chan))

    # color rotation (:2696)
    if args.rotatecolor:
        from ..ops.rotatecolor import ROTATE_COLOR, rotate_color
        rot = ROTATE_COLOR(args.rotatecolor)
        tex = transform_image(
            tex, lambda img: rotate_color(img, rot, args.nits))

    # tonemap (:2966): Reinhard with max-luminance white point
    if args.tonemap:
        tex = transform_image(tex, _tonemap)
        if tex.metadata.format in (FMT.R32G32B32A32_FLOAT,
                                   FMT.R16G16B16A16_FLOAT):
            tex = tex.replace_levels(
                tex.levels, tex.metadata.with_format(FMT.R8G8B8A8_UNORM))

    # colorkey (:3134)
    if args.colorkey:
        key = int(args.colorkey, 16)
        kr, kg, kb = ((key >> 16) & 0xFF) / 255.0, ((key >> 8) & 0xFF) / 255.0, \
            (key & 0xFF) / 255.0
        tex = transform_image(tex, lambda img: _colorkey(img, kr, kg, kb))

    # invert-y / reconstruct-z (:3193, :3242)
    if args.inverty:
        tex = transform_image(tex, _invert_y)
    if args.reconstructz:
        tex = transform_image(tex, _reconstruct_z)

    # normal map (replaces color data, texconv -nmap)
    if args.nmap is not None:
        nflags = CNMAP_FLAGS.DEFAULT
        for c in args.nmap.lower():
            nflags |= {
                "r": CNMAP_FLAGS.CHANNEL_RED, "g": CNMAP_FLAGS.CHANNEL_GREEN,
                "b": CNMAP_FLAGS.CHANNEL_BLUE, "a": CNMAP_FLAGS.CHANNEL_ALPHA,
                "l": CNMAP_FLAGS.CHANNEL_LUMINANCE,
                "m": CNMAP_FLAGS.MIRROR, "i": CNMAP_FLAGS.INVERT_SIGN,
                "o": CNMAP_FLAGS.COMPUTE_OCCLUSION,
            }[c]
        nm_fmt = target_fmt if not traits.is_compressed(target_fmt) \
            else FMT.R8G8B8A8_UNORM
        tex = compute_normal_map(tex, nflags, args.nmapamp, nm_fmt)

    # convert to non-BC working format (:3046)
    if not traits.is_compressed(target_fmt) and \
            tex.metadata.format != target_fmt:
        tex = convert(tex, target_fmt, filt, args.alpha_threshold)
        st.mark("convert", tex)

    # mips (:3309)
    if args.mips is not None and args.mips != 1:
        tex = generate_mipmaps(tex, filt, args.mips)
        if args.keepcoverage is not None:
            tex = scale_mipmaps_alpha_for_coverage(tex, args.keepcoverage)
        st.mark("mipmaps", tex)

    # premultiply (:3504)
    if args.pmalpha:
        tex = premultiply_alpha(tex)

    # compress (:3550)
    if traits.is_compressed(target_fmt):
        cflags = TC.DEFAULT
        if "d" in args.bc:
            cflags |= TC.DITHER
        if "u" in args.bc:
            cflags |= TC.UNIFORM
        if "q" in args.bc:
            cflags |= TC.BC7_QUICK
        if "x" in args.bc:
            cflags |= TC.BC7_USE_3SUBSETS
        if "m" in args.bc:
            cflags |= TC.BC7_MAXQUALITY
        if "b" in args.bc:
            cflags |= TC.BC6H_MID
        if defer_compress is not None:
            # multi-file batching (SURVEY §2.4): the encode is deferred so
            # main() can put every same-(format, flags) file into one
            # device dispatch via ops.compress_many
            defer_compress.append((tex, target_fmt, cflags, path))
            return None
        tex = compress(tex, target_fmt, cflags, args.alpha_threshold,
                       alpha_weight=args.alpha_weight)
        st.mark("compress", tex)

    out_path = _save_output(tex, path, args)
    st.mark("save")

    if args.timing:
        stages = "  ".join(f"{n} {dt * 1e3:.1f}ms" for n, dt in st.rows)
        log(f"  {path}: {time.perf_counter() - t0:.3f}s  [{stages}]")
    return out_path


def _save_output(tex, path, args):
    """Save stage (:3768), shared by the serial and batched paths."""
    from ..io import DDS_FLAGS, save_texture

    base = os.path.splitext(os.path.basename(path))[0]
    ext = args.file_type
    name = f"{args.prefix}{base}{args.suffix}.{ext}"
    if args.tolower:
        name = name.lower()
    out_path = os.path.join(args.outdir, name)
    if os.path.exists(out_path) and not args.overwrite:
        raise FileExistsError(f"{out_path} exists (use -y to overwrite)")
    os.makedirs(args.outdir, exist_ok=True)
    kwargs = {}
    if ext == "dds":
        flags = DDS_FLAGS.NONE
        if args.dx10:
            flags |= DDS_FLAGS.FORCE_DX10_EXT
        if args.dx9:
            flags |= DDS_FLAGS.FORCE_DX9_LEGACY
        if args.dword_align:
            flags |= DDS_FLAGS.LEGACY_DWORD
        kwargs["flags"] = flags
    elif ext in ("png", "jpg", "bmp", "tiff", "heic", "avif"):
        from ..io.wic import WIC_FLAGS
        if args.wicq is not None:
            kwargs["quality"] = args.wicq
        if args.wiclossless and ext in ("png", "tiff"):
            kwargs["quality"] = 1.0
        if args.wicmulti:
            kwargs["flags"] = WIC_FLAGS.ALL_FRAMES
    save_texture(tex, out_path, **kwargs)
    return out_path


def expand_files(patterns, recursive: bool):
    """SearchForFiles equivalent (Common/CmdLineHelpers.h:189): with -r a
    plain wildcard like `*.png` searches subdirectories too."""
    import glob
    out = []
    for pat in patterns:
        if os.path.isfile(pat):
            out.append(pat)
            continue
        if recursive and "**" not in pat:
            head, tail = os.path.split(pat)
            rec_pat = os.path.join(head, "**", tail)
            out.extend(sorted(glob.glob(rec_pat, recursive=True)))
        else:
            out.extend(sorted(glob.glob(pat, recursive=recursive)))
    return out


def read_file_list(path: str) -> list[str]:
    """ProcessFileList equivalent (-flist, Common/CmdLineHelpers.h:251)."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line)
    return out


def main(argv=None, device=None) -> int:
    """The CLI on `device` (CUDA unless named); returns the exit code."""
    args = build_parser().parse_args(argv)
    dev = resolve(device)
    if args.version:
        from .. import __version__
        print(f"texconv (directxtex_tpu_torch) {__version__}")
        return 0
    if not args.nologo:
        print("texconv (directxtex_tpu_torch) — PyTorch / CUDA texture "
              "converter")
    # accepted-but-inapplicable options are reported, not swallowed: the
    # port has no WIC and no CPU/GPU split (it runs on the device main()
    # is given)
    ignored = [name for name, on in (
        ("-nowic", args.nowic), ("-singleproc", args.singleproc),
        ("-gpu", args.gpu is not None), ("-nogpu", args.nogpu)) if on]
    if ignored:
        print(f"  ignored (no WIC, no CPU/GPU split): {' '.join(ignored)}")
    patterns = list(args.files)
    if args.flist:
        patterns.extend(read_file_list(args.flist))
    files = expand_files(patterns, args.recursive)
    if not files:
        print("error: no input files matched", file=sys.stderr)
        return 1
    failed = 0
    # multi-file batching (SURVEY §2.4: "many files -> one batched device
    # call"): each file runs its pre-compress pipeline, then every file
    # headed for the same (BC format, flags) encodes in ONE device
    # dispatch. -timing keeps the serial path so per-stage rows stay real.
    deferred = [] if len(files) > 1 and not args.timing else None
    with contextlib.ExitStack() as stack:
        if args.profile:
            from ..utils.timing import profile_trace
            trace = stack.enter_context(profile_trace(args.profile, dev))
        for path in files:
            try:
                out = process_file(path, args, defer_compress=deferred,
                                   device=dev)
                if out is not None:
                    print(f"  {path} -> {out}")
            except Exception as e:  # keep going like the reference tool
                print(f"  FAILED {path}: {e}", file=sys.stderr)
                failed += 1
        if deferred:
            failed += _flush_compress_batches(deferred, args)
    if args.profile:
        print(f"  profiler trace written to {trace['path']}")
    return 1 if failed else 0


def _flush_compress_batches(deferred, args) -> int:
    """Encode every deferred file, one compress_many dispatch per
    (format, flags) group; returns the number of failures."""
    from ..ops import compress_many

    failed = 0
    groups = {}
    for tex, fmt, cflags, path in deferred:
        groups.setdefault((fmt, int(cflags)), []).append((tex, path))
    for (fmt, cflags), items in groups.items():
        texs = [t for t, _ in items]
        try:
            ctexs = compress_many(texs, fmt, cflags, args.alpha_threshold,
                                  alpha_weight=args.alpha_weight)
        except Exception as e:
            print(f"  batch compress FAILED ({len(items)} files): {e}; "
                  "retrying serially", file=sys.stderr)
            ctexs = []
            for tex, path in items:
                try:
                    ctexs.append(compress_many(
                        [tex], fmt, cflags, args.alpha_threshold,
                        alpha_weight=args.alpha_weight)[0])
                except Exception as e2:
                    print(f"  FAILED {path}: {e2}", file=sys.stderr)
                    ctexs.append(None)
                    failed += 1
        for ctex, (_, path) in zip(ctexs, items):
            if ctex is None:
                continue
            try:
                out = _save_output(ctex, path, args)
                print(f"  {path} -> {out}")
            except Exception as e:
                print(f"  FAILED {path}: {e}", file=sys.stderr)
                failed += 1
    return failed


if __name__ == "__main__":
    sys.exit(main())
