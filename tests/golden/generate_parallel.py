"""Generator of parallel.npz: the JAX package's parallel/ functions on its
8-device virtual CPU mesh, frozen for tests/test_torch_parallel.py, which
holds the PyTorch port's parallel/ to them bit for bit.

The outputs are taken with XLA's CPU code limited to AVX
(XLA_FLAGS=--xla_cpu_max_isa=AVX, set here before JAX is imported): with
FMA instructions XLA contracts `a*b + c` inside the jitted functions,
which moves BC1 words and normal-map values, and torch's eager ops never
contract. The test holds the normal map against the live (FMA) run too,
within 2 ulp.

Keys (numpy seeds in brackets):
  height [64, 16] f32 [11]: the height field;
  nm_<case> [64, 16, 4]: sharded_normal_map(mesh, amplitude, mirror_u,
      mirror_v, invert_sign) of height for each case of NORMAL_CASES;
  lib_batch [8, 16, 16, 4] f32 [20]: random RGBA, alpha uniform;
  lib_bc1 [8, 16, 8] u8: compress_library_fn(BC1_UNORM, mesh) of it;
  lib_bc1_mip<k> [8, blocks, 8] u8: the same with mips=True, level k
      (16, 8, 4, 2, 1).

Run from the repository root (about a minute):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/golden/generate_parallel.py
"""

from __future__ import annotations

import os
import pathlib

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_max_isa=AVX"
                           " --xla_force_host_platform_device_count=8"
                           ).strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# case -> (amplitude, mirror_u, mirror_v, invert_sign)
NORMAL_CASES = {"wrap": (2.0, False, False, False),
                "mirror_v": (2.0, False, True, False),
                "mirror_uv_inv": (0.7, True, True, True)}


def main() -> None:
    from directxtex_tpu.formats import FMT
    from directxtex_tpu.parallel import (
        compress_library_fn, make_mesh, rows_sharding, shard_batch,
        sharded_normal_map)

    mesh = make_mesh(jax.devices()[:8])
    out = {}
    height = np.random.default_rng(11).random((64, 16)).astype(np.float32)
    out["height"] = height
    for case, (amp, mu, mv, inv) in NORMAL_CASES.items():
        fn = sharded_normal_map(mesh, amp, mu, mv, inv)
        out[f"nm_{case}"] = np.asarray(fn(jax.device_put(
            jnp.asarray(height), rows_sharding(mesh))))
    batch = np.random.default_rng(20).random((8, 16, 16, 4)) \
        .astype(np.float32)
    out["lib_batch"] = batch
    (out["lib_bc1"],) = (np.asarray(o) for o in compress_library_fn(
        FMT.BC1_UNORM, mesh)(shard_batch(jnp.asarray(batch), mesh)))
    levels = compress_library_fn(FMT.BC1_UNORM, mesh, mips=True)(
        shard_batch(jnp.asarray(batch), mesh))
    for k, lvl in enumerate(levels):
        out[f"lib_bc1_mip{k}"] = np.asarray(lvl)
    path = pathlib.Path(__file__).resolve().parent / "parallel.npz"
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {sorted(out)}")


if __name__ == "__main__":
    main()
