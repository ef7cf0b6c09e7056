"""Generator of texdiag.npz: the JAX package's texdiag `dumpbc` lines over
every block of three small BC files, frozen for tests/test_torch_texdiag.py
(the JAX tool decodes one block a call, 12-25 s a file here; the test
holds the port's lines to these text for text).

The BC files are the port's own encodes on the CPU of one seeded image
(`source_files`, which the test calls too); their bytes are frozen beside
the lines, and the test checks that it rebuilds the same bytes.

Keys: src_<fmt> u8: the DDS file's bytes; dumpbc_<fmt> str: the JAX
tool's printed lines, for fmt in DUMPBC_FORMATS.

Run from the repository root (about a minute):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_texdiag.py
"""

from __future__ import annotations

import contextlib
import io
import os
import pathlib
import tempfile

import numpy as np

DUMPBC_FORMATS = ("BC7_UNORM", "BC6H_UF16", "BC6H_SF16")


def source_image() -> np.ndarray:
    """[16, 24, 4] f32 in [0, 1), seed 1."""
    return np.random.default_rng(1).random((16, 24, 4)).astype(np.float32)


def source_bytes(fmt_name: str) -> bytes:
    """The port's DDS of source_image() compressed to `fmt_name` on the
    CPU (signed formats from the image * 2 - 1)."""
    from directxtex_tpu_torch.formats import FMT
    from directxtex_tpu_torch.io import save_to_dds_memory
    from directxtex_tpu_torch.ops import compress
    from directxtex_tpu_torch.texture import Texture

    img = source_image()
    if fmt_name.endswith(("SNORM", "SF16")):
        img = img * 2 - 1
    tex = Texture.from_array(img, FMT.R32G32B32A32_FLOAT, device="cpu")
    return save_to_dds_memory(compress(tex, getattr(FMT, fmt_name)))


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from directxtex_tpu.tools import texdiag

    out = {}
    with tempfile.TemporaryDirectory() as d:
        for fmt in DUMPBC_FORMATS:
            data = source_bytes(fmt)
            path = os.path.join(d, f"{fmt}.dds")
            with open(path, "wb") as f:
                f.write(data)
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                assert texdiag.main(["-nologo", "dumpbc", path]) == 0
            out[f"src_{fmt}"] = np.frombuffer(data, np.uint8)
            out[f"dumpbc_{fmt}"] = np.array(text.getvalue())
    target = pathlib.Path(__file__).resolve().parent / "texdiag.npz"
    np.savez_compressed(target, **out)
    print(f"wrote {target}: {sorted(out)}")


if __name__ == "__main__":
    main()
