"""texassemble — multi-image container assembler, on torch tensors.

The counterpart of directxtex_tpu/tools/texassemble.py
(Texassemble/texassemble.cpp). Commands (CMD_* enum, texassemble.cpp:95-120):
cube, volume, array, cubearray, h-cross, v-cross, h-strip, v-strip (+ their
cube-from variants), merge (channel merge of two images), array-strip,
from-mips decomposition.

Every input is loaded to the device once, normalized there (decompress,
strip mips, undo premultiplication, resize, tonemap, convert), and each
command is concatenation and slicing on that device; the save makes the
one copy back. `main(argv, device=None)` runs on CUDA unless the caller
names a device.

Usage: python -m directxtex_tpu_torch.tools.texassemble <command> -o out.dds <files...>
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..utils.device import resolve


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="texassemble",
                                description=__doc__.split("\n")[0])
    p.add_argument("command", choices=[
        "cube", "volume", "array", "cubearray",
        "h-cross", "v-cross", "v-cross-fnz", "h-tee", "h-strip", "v-strip",
        "cube-from-hc", "cube-from-vc", "cube-from-vc-fnz", "cube-from-ht",
        "cube-from-hs", "cube-from-vs", "cube-from-mips",
        "merge", "gif", "array-strip", "from-mips",
    ])
    p.add_argument("files", nargs="*", help="input images (may be empty "
                   "with -flist)")
    p.add_argument("-o", "--output", default=None, help="output file")
    p.add_argument("-y", "--overwrite", action="store_true", dest="overwrite")
    p.add_argument("-w", "--width", type=int, default=0)
    p.add_argument("-ht", "--height", type=int, default=0)
    p.add_argument("-f", "--format", default=None, help="output DXGI format")
    p.add_argument("--swizzle", default="rgba",
                   help="merge: channel source map (merge only)")
    p.add_argument("-if", "--image-filter", default="fant",
                   choices=["point", "linear", "cubic", "fant", "box",
                            "triangle"],
                   help="resize filter (OPT_FILTER)")
    p.add_argument("-srgb", action="store_true", help="sRGB in and out")
    p.add_argument("-srgbi", "--srgb-in", dest="srgbi", action="store_true", help="sRGB input")
    p.add_argument("-srgbo", "--srgb-out", dest="srgbo", action="store_true", help="sRGB output")
    p.add_argument("-wrap", action="store_true", help="wrap filtering")
    p.add_argument("-mirror", action="store_true", help="mirror filtering")
    p.add_argument("-sepalpha", "--separate-alpha", dest="sepalpha", action="store_true",
                   help="resize alpha separately")
    p.add_argument("-alpha", action="store_true",
                   help="convert premultiplied input to straight alpha")
    p.add_argument("-tonemap", action="store_true",
                   help="Reinhard tonemap HDR inputs to LDR")
    p.add_argument("-stripmips", "--strip-mips", dest="stripmips", action="store_true",
                   help="accept mipped inputs, using level 0 only "
                        "(always-on here; accepted for compatibility)")
    p.add_argument("-l", "--to-lowercase", action="store_true", dest="tolower",
                   help="force output filename to lowercase")
    p.add_argument("-flist", "--file-list", dest="flist", default=None, metavar="FILE",
                   help="read input paths from a text file")
    p.add_argument("-dx10", action="store_true",
                   help="force DX10 extended DDS header")
    p.add_argument("-bgcolor", "--gif-bg-color", dest="bgcolor", default=None, metavar="RRGGBB",
                   help="gif: background color for transparent frames")
    p.add_argument("-fl", "--feature-level", default=None,
                   help="feature level size limit to validate against")
    p.add_argument("-m", "--mip-levels", dest="mips", type=int, default=None,
                   help="generate a mip chain on the assembled output "
                        "(0 = full chain)")
    p.add_argument("-r", action="store_true", dest="recursive",
                   help="treat arguments as glob patterns, search "
                        "recursively")
    p.add_argument("-nologo", action="store_true")
    p.add_argument("-version", action="store_true",
                   help="print version and exit")
    p.add_argument("-nowic", action="store_true", help=argparse.SUPPRESS)
    return p


def _filter_flags(args):
    from ..ops.flags import TEX_FILTER_FLAGS as TF
    flags = TF({
        "point": TF.POINT, "linear": TF.LINEAR, "cubic": TF.CUBIC,
        "fant": TF.FANT, "box": TF.BOX, "triangle": TF.TRIANGLE,
    }[getattr(args, "image_filter", "fant")])
    if getattr(args, "wrap", False):
        flags |= TF.WRAP
    if getattr(args, "mirror", False):
        flags |= TF.MIRROR
    if getattr(args, "sepalpha", False):
        flags |= TF.SEPARATE_ALPHA
    if getattr(args, "srgb", False) or getattr(args, "srgbi", False):
        flags |= TF.SRGB_IN
    if getattr(args, "srgb", False) or getattr(args, "srgbo", False):
        flags |= TF.SRGB_OUT
    return flags


def _load_normalized(paths, args, device=None):
    """Per-input normalization (texassemble.cpp:1586-2035) on `device`:
    decompress, strip mips, undo premultiplied alpha, resize to a common
    size, tonemap, convert to a common format."""
    from ..formats import format_from_name
    from ..io import load_texture
    from ..ops import decompress, premultiply_alpha, resize
    from ..ops.flags import TEX_PMALPHA_FLAGS as PM
    from ..texture import CompressedTexture

    dev = resolve(device)
    filt = _filter_flags(args)
    texs = []
    for p in paths:
        t = load_texture(p, device=dev)
        if isinstance(t, CompressedTexture):
            t = decompress(t)
        if t.mip_levels > 1:
            t = t.replace_levels([t.levels[0]])
        if getattr(args, "alpha", False) and t.metadata.is_pm_alpha():
            t = premultiply_alpha(t, PM.REVERSE)
        texs.append(t)
    if getattr(args, "feature_level", None):
        from .texconv import FEATURE_LEVEL_MAX_SIZE
        max_size = FEATURE_LEVEL_MAX_SIZE.get(args.feature_level)
        if max_size is None:
            raise ValueError(f"unknown feature level {args.feature_level}")
        for t in texs:
            if max(t.metadata.width, t.metadata.height) > max_size:
                raise ValueError(
                    f"input exceeds feature level {args.feature_level} "
                    f"limit ({max_size})")
    w = args.width or texs[0].metadata.width
    h = args.height or texs[0].metadata.height
    texs = [resize(t, w, h, filt)
            if (t.metadata.width, t.metadata.height) != (w, h)
            else t for t in texs]
    if getattr(args, "tonemap", False):
        from ..ops import transform_image
        from .texconv import _tonemap
        texs = [transform_image(t, _tonemap) for t in texs]
    if args.format:
        from ..ops import convert
        fmt = format_from_name(args.format)
        texs = [convert(t, fmt, filt) if t.metadata.format != fmt else t
                for t in texs]
    return texs


LAYOUTS = ("h-cross", "v-cross", "v-cross-fnz", "h-tee", "h-strip",
           "v-strip")
INVERSES = ("cube-from-hc", "cube-from-vc", "cube-from-vc-fnz",
            "cube-from-ht", "cube-from-hs", "cube-from-vs")


def cube_layout(faces, cmd: str) -> torch.Tensor:
    """Six [H, W, 4] faces (+X -X +Y -Y +Z -Z) as one layout image
    (CMD_H_CROSS..CMD_V_STRIP, face placements texassemble.cpp:2103-2183;
    v-cross-fnz rotates the -Z face 180 degrees), empty cells zero."""
    z = torch.zeros_like(faces[0])
    px, nx, py, ny, pz, nz = faces
    if cmd == "h-cross":
        grid = [[z, py, z, z], [nx, pz, px, nz], [z, ny, z, z]]
    elif cmd == "v-cross":
        grid = [[z, py, z], [nx, pz, px], [z, ny, z], [z, nz, z]]
    elif cmd == "v-cross-fnz":
        grid = [[z, py, z], [nx, pz, px], [z, ny, z],
                [z, torch.flip(nz, (0, 1)), z]]
    elif cmd == "h-tee":
        grid = [[py, z, z, z], [pz, px, nz, nx], [ny, z, z, z]]
    elif cmd == "h-strip":
        grid = [[px, nx, py, ny, pz, nz]]
    else:
        grid = [[px], [nx], [py], [ny], [pz], [nz]]
    return torch.cat([torch.cat(r, dim=1) for r in grid], dim=0)


def cube_faces_of(img: torch.Tensor, cmd: str) -> torch.Tensor:
    """A layout image -> its [6, fh, fw, 4] faces (CMD_CUBE_FROM_*,
    texassemble.cpp:2373+), the inverse of cube_layout."""
    H, W = img.shape[:2]
    if cmd in ("cube-from-hc", "cube-from-ht"):
        fh, fw = H // 3, W // 4
    elif cmd in ("cube-from-vc", "cube-from-vc-fnz"):
        fh, fw = H // 4, W // 3
    elif cmd == "cube-from-hs":
        fh, fw = H, W // 6
    else:
        fh, fw = H // 6, W

    def at(r, c):
        return img[r * fh:(r + 1) * fh, c * fw:(c + 1) * fw]

    if cmd == "cube-from-hc":
        faces = [at(1, 2), at(1, 0), at(0, 1), at(2, 1), at(1, 1), at(1, 3)]
    elif cmd == "cube-from-vc":
        faces = [at(1, 2), at(1, 0), at(0, 1), at(2, 1), at(1, 1), at(3, 1)]
    elif cmd == "cube-from-vc-fnz":
        faces = [at(1, 2), at(1, 0), at(0, 1), at(2, 1), at(1, 1),
                 torch.flip(at(3, 1), (0, 1))]
    elif cmd == "cube-from-ht":
        faces = [at(1, 1), at(1, 3), at(0, 0), at(2, 0), at(1, 0), at(1, 2)]
    elif cmd == "cube-from-hs":
        faces = [at(0, i) for i in range(6)]
    else:
        faces = [at(i, 0) for i in range(6)]
    return torch.stack(faces)


def main(argv=None, device=None) -> int:
    """The CLI on `device` (CUDA unless named); returns the exit code."""
    from ..io import save_texture as _raw_save
    from ..texture import TexDimension, TexMetadata, TexMiscFlag, Texture

    if "-version" in (argv if argv is not None else sys.argv[1:]):
        from .. import __version__
        print(f"texassemble (directxtex_tpu_torch) {__version__}")
        return 0
    args = build_parser().parse_args(argv)
    dev = resolve(device)
    if not args.nologo:
        print("texassemble (directxtex_tpu_torch)")
    if args.nowic:
        print("  ignored (no WIC): -nowic")
    if not args.output:
        print("error: -o <output> is required", file=sys.stderr)
        return 1
    cmd = args.command

    if args.flist:
        from .texconv import read_file_list
        args.files = list(args.files) + read_file_list(args.flist)
    if args.recursive:
        from .texconv import expand_files
        args.files = expand_files(list(args.files), True)
    if not args.files:
        print("error: no input files", file=sys.stderr)
        return 1
    if args.tolower:
        args.output = args.output.lower()
    if os.path.exists(args.output) and not args.overwrite:
        print(f"error: {args.output} exists (use -y to overwrite)",
              file=sys.stderr)
        return 1

    def save_texture(tex, path, **kw):
        # -m: mip chain on the assembled output (OPT_MIPLEVELS)
        if args.mips is not None and args.mips != 1 \
                and getattr(tex, "mip_levels", 1) == 1:
            from ..ops import generate_mipmaps
            tex = generate_mipmaps(tex, _filter_flags(args), args.mips)
        if args.dx10 and str(path).lower().endswith(".dds"):
            from ..io import DDS_FLAGS
            kw.setdefault("flags", DDS_FLAGS.FORCE_DX10_EXT)
        _raw_save(tex, path, **kw)

    def normalized():
        return _load_normalized(args.files, args, dev)

    def loaded(path):
        from ..io import load_texture
        from ..ops import decompress
        from ..texture import CompressedTexture
        t = load_texture(path, device=dev)
        return decompress(t) if isinstance(t, CompressedTexture) else t

    if cmd == "merge":
        if len(args.files) != 2:
            print("error: merge requires exactly 2 images", file=sys.stderr)
            return 1
        a, b = normalized()
        # channel map: letters rgba pull from image 1 (upper = image 2)
        src = {}
        for dst_i, c in enumerate(args.swizzle[:4]):
            img = b if c.isupper() else a
            ch = {"r": 0, "g": 1, "b": 2, "a": 3}[c.lower()]
            src[dst_i] = img.levels[0][..., ch]
        out = torch.stack([src.get(i, a.levels[0][..., i])
                           for i in range(4)], dim=-1)
        save_texture(Texture(a.metadata, [out]), args.output)
        print(f"  wrote {args.output}")
        return 0

    if cmd == "gif":
        # animated GIF -> texture array (AnimatedGif.cpp); -bgcolor
        # composites transparent pixels onto the given color (alpha too:
        # a * a + (1 - a), as the JAX tool does)
        from ..io.wic import WIC_FLAGS, load_from_wic_file
        tex = load_from_wic_file(args.files[0], WIC_FLAGS.ALL_FRAMES,
                                 device=dev)
        if args.bgcolor:
            key = int(args.bgcolor, 16)
            bg = torch.tensor([((key >> 16) & 0xFF) / 255.0,
                               ((key >> 8) & 0xFF) / 255.0,
                               (key & 0xFF) / 255.0, 1.0],
                              dtype=torch.float32, device=dev)
            lvl = tex.levels[0]
            a = lvl[..., 3:4]
            tex = tex.replace_levels([lvl * a + bg * (1.0 - a)])
        save_texture(tex, args.output)
        print(f"  wrote {args.output} ({tex.array_size} frames)")
        return 0

    if cmd == "array-strip":
        # texture array -> one vertical strip image (CMD_ARRAY_STRIP)
        texs = normalized()
        items = list(texs[0].levels[0]) if len(texs) == 1 \
            else [t.levels[0][0] for t in texs]
        out = torch.cat(items, dim=0)
        save_texture(Texture.from_array(out, device=dev), args.output)
        print(f"  wrote {args.output}")
        return 0

    if cmd == "from-mips":
        # mip chain -> texture array, one item per level upscaled back to
        # the base size (CMD_FROM_MIPS)
        from ..ops.resize import resize_array
        t = loaded(args.files[0])
        w, h = t.metadata.width, t.metadata.height
        items = [t.levels[lvl][0] for lvl in range(t.mip_levels)]
        stacked = torch.stack([resize_array(i, w, h)
                               if tuple(i.shape[:2]) != (h, w) else i
                               for i in items])
        meta = TexMetadata(width=w, height=h, array_size=len(items),
                           mip_levels=1, format=t.metadata.format,
                           dimension=TexDimension.TEXTURE2D)
        save_texture(Texture(meta, [stacked]), args.output)
        print(f"  wrote {args.output} ({len(items)} mips as array)")
        return 0

    if cmd in LAYOUTS:
        # cubemap -> cross/tee/strip layout image
        texs = normalized()
        if len(texs) == 1 and texs[0].array_size == 6:
            faces = list(texs[0].levels[0])
        elif len(texs) == 6:
            faces = [t.levels[0][0] for t in texs]
        else:
            print("error: need a cubemap or 6 images", file=sys.stderr)
            return 1
        save_texture(Texture.from_array(cube_layout(faces, cmd),
                                        device=dev), args.output)
        print(f"  wrote {args.output}")
        return 0

    if cmd in INVERSES:
        # layout image -> cubemap
        img = normalized()[0].levels[0][0]
        tex = Texture.from_array(cube_faces_of(img, cmd), is_cube=True,
                                 device=dev)
        save_texture(tex, args.output)
        print(f"  wrote {args.output} (cubemap)")
        return 0

    if cmd == "cube-from-mips":
        # 6*m input images (face-major: all mips of +X, then -X, ...) ->
        # cubemap with a full mip chain (CMD_CUBE_FROM_MIPS,
        # texassemble.cpp:1802-1833)
        # no common-size normalization: each input keeps its own mip size
        # (the reference resizes input i to base >> (i % mips),
        # texassemble.cpp:1811-1833)
        from ..ops.resize import resize_array
        texs = []
        for pth in args.files:
            t = loaded(pth)
            if t.mip_levels > 1:
                t = t.replace_levels([t.levels[0]])
            texs.append(t)
        n = len(texs)
        if n == 0 or n % 6 != 0:
            print("error: cube-from-mips requires a multiple of 6 images",
                  file=sys.stderr)
            return 1
        mips = n // 6
        base = texs[0].metadata
        levels = []
        for m in range(mips):
            w = max(base.width >> m, 1)
            h = max(base.height >> m, 1)
            lvl = []
            for f in range(6):
                im = texs[f * mips + m].levels[0][0]
                if tuple(im.shape[:2]) != (h, w):
                    im = resize_array(im, w, h)
                lvl.append(im)
            levels.append(torch.stack(lvl))
        meta = TexMetadata(width=base.width, height=base.height, depth=1,
                           array_size=6, mip_levels=mips,
                           misc_flags=int(TexMiscFlag.TEXTURECUBE),
                           format=base.format,
                           dimension=TexDimension.TEXTURE2D)
        save_texture(Texture(meta, levels), args.output)
        print(f"  wrote {args.output} (cubemap, {mips} mips)")
        return 0

    # cube / volume / array / cubearray
    texs = normalized()
    n = len(texs)
    if cmd == "cube" and n != 6:
        print("error: cube requires 6 images", file=sys.stderr)
        return 1
    if cmd == "cubearray" and (n == 0 or n % 6 != 0):
        print("error: cubearray requires a multiple of 6 images",
              file=sys.stderr)
        return 1
    stacked = torch.cat([t.levels[0] for t in texs])
    base = texs[0].metadata
    if cmd == "volume":
        meta = TexMetadata(width=base.width, height=base.height, depth=n,
                           array_size=1, mip_levels=1, format=base.format,
                           dimension=TexDimension.TEXTURE3D)
    else:
        misc = int(TexMiscFlag.TEXTURECUBE) if cmd in ("cube", "cubearray") \
            else 0
        meta = TexMetadata(width=base.width, height=base.height, depth=1,
                           array_size=n, mip_levels=1, misc_flags=misc,
                           format=base.format,
                           dimension=TexDimension.TEXTURE2D)
    save_texture(Texture(meta, [stacked]), args.output)
    print(f"  wrote {args.output} ({cmd}, {n} images)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
