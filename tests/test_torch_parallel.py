"""The port's parallel/ (directxtex_tpu_torch.parallel) against the JAX
package's, on the CPU: the port's mesh of ("cpu",) * 8 beside the JAX
package's 8-device virtual CPU mesh (tests/conftest.py).

Tolerances, per function:
- halo_exchange_rows (halo 1 and 3, wrap and clamp) and sharded_box_mip:
  bit for bit the JAX package's live output;
- sharded_normal_map: bit for bit the JAX package's run without FMA
  (XLA_FLAGS=--xla_cpu_max_isa=AVX), frozen in tests/golden/parallel.npz
  (tests/golden/generate_parallel.py), and within 2 ulp of the live
  jitted run, where XLA contracts multiply-adds (the count of values
  that differ is printed);
- sharded_mse: within 1e-6 relative of the JAX package's;
- compress_library_fn's BC1 words, with and without mips: equal to the
  JAX package's run without FMA (parallel.npz);
- the sharded encodes: equal to the port's unsharded encode.

Two faults of the JAX package are shown beside the port's ValueError: a
halo wider than a shard's rows returns a short slab, and the mip chain of
compress_library_fn fails on an odd side above 1.
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from directxtex_tpu_torch import parallel
from directxtex_tpu_torch.bc import bc67, bc123
from directxtex_tpu_torch.formats import FMT
from directxtex_tpu_torch.ops import compute_mse
from directxtex_tpu_torch.parallel.sharding import Mesh, gather
from directxtex_tpu_torch.texture import Texture

jpar = importlib.import_module("directxtex_tpu.parallel")
tio = importlib.import_module("directxtex_tpu_torch.io")

try:
    from jax import shard_map
except ImportError:  # pre-0.8 JAX
    from jax.experimental.shard_map import shard_map

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
CPU8 = ("cpu",) * 8
# case -> (amplitude, mirror_u, mirror_v, invert_sign), as
# tests/golden/generate_parallel.py
NORMAL_CASES = {"wrap": (2.0, False, False, False),
                "mirror_v": (2.0, False, True, False),
                "mirror_uv_inv": (0.7, True, True, True)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frozen():
    return np.load(GOLDEN / "parallel.npz")


@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh(CPU8)


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(jax.devices()[:8])


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def test_mesh_repeats_devices_and_defaults_to_cuda(monkeypatch):
    """A named device may repeat; with no devices named, every CUDA
    device (none here: ValueError, never the CPU)."""
    m = parallel.make_mesh(CPU8, axis="rows")
    assert m.size == 8 and m.axis == "rows"
    assert set(m.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError):
        parallel.make_mesh([])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA device"):
        parallel.make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.make_mesh().devices == (torch.device("cuda", 0),
                                            torch.device("cuda", 1))


def test_shard_batch_splits_and_refuses_as_jax(mesh, jmesh):
    """shard_batch gives mesh.size equal dim-0 chunks on their devices; N
    not a multiple of the mesh size raises ValueError, as JAX's
    device_put does."""
    x = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
    shards = parallel.shard_batch(x, mesh)
    assert len(shards) == 8 and all(s.shape == (2, 3) for s in shards)
    assert torch.equal(gather(shards), x)
    js = jpar.shard_batch(jnp.asarray(x.numpy()), jmesh)
    assert np.array_equal(np.asarray(js), x.numpy())
    with pytest.raises(ValueError):
        jpar.shard_batch(jnp.ones((10, 3)), jmesh)
    with pytest.raises(ValueError):
        parallel.shard_batch(torch.ones(10, 3), mesh)
    rep = parallel.replicated(mesh).place(x)
    assert len(rep) == 8 and all(torch.equal(r, x) for r in rep)
    assert parallel.batch_sharding(mesh).dim == 0
    assert parallel.rows_sharding(mesh).dim == 0


def test_sharded_bc1_matches_unsharded(mesh):
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(rng.random((64, 16, 4)).astype(np.float32))
    fn = parallel.sharded_compress_fn(
        lambda b: bc123.encode_bc1(b, 0.5, 0), mesh)
    out = fn(parallel.shard_batch(blocks, mesh))
    assert len(out) == 8
    assert torch.equal(gather(out), bc123.encode_bc1(blocks, 0.5, 0))
    assert torch.equal(gather(fn(blocks)), gather(out))


def test_sharded_bc7_quick_matches_unsharded(mesh):
    rng = np.random.default_rng(3)
    blocks = rng.random((64, 16, 4)).astype(np.float32)
    blocks[..., 3] = 1.0
    blocks = torch.from_numpy(blocks)

    def enc(b):
        return bc67.encode_bc7(b, flags=bc67._BC7_QUICK, opaque=True)

    out = parallel.sharded_compress_fn(enc, mesh)(blocks)
    assert torch.equal(gather(out), enc(blocks))


@pytest.mark.parametrize("shape", [(16, 32), (64, 8, 4)])
def test_sharded_mse_matches_jax(shape, mesh, jmesh):
    rng = np.random.default_rng(sum(shape))
    a = rng.random(shape).astype(np.float32)
    b = rng.random(shape).astype(np.float32)
    got = parallel.sharded_mse(mesh)(torch.from_numpy(a),
                                     torch.from_numpy(b))
    want = float(jpar.sharded_mse(jmesh)(
        jpar.shard_batch(jnp.asarray(a), jmesh),
        jpar.shard_batch(jnp.asarray(b), jmesh)))
    assert got.dtype == torch.float32 and got.device == mesh.devices[0]
    assert abs(float(got) - want) <= 1e-6 * want
    # compute_mse's per-channel mean over the same values
    if shape[-1] == 4:
        _, v = compute_mse(torch.from_numpy(a), torch.from_numpy(b))
        assert abs(float(got) - float(v.mean())) <= 1e-6 * want
    assert float(parallel.sharded_mse(mesh)(
        torch.ones(16, 32), torch.full((16, 32), 0.5))) == 0.25


def _jax_halo(jmesh, x, halo, wrap):
    fn = jax.jit(shard_map(
        lambda v: jpar.halo_exchange_rows(v, halo, "batch", wrap=wrap),
        mesh=jmesh, in_specs=P("batch"), out_specs=P("batch")))
    return np.asarray(fn(jax.device_put(jnp.asarray(x),
                                        NamedSharding(jmesh, P("batch")))))


@pytest.mark.parametrize("halo", [1, 3])
@pytest.mark.parametrize("wrap", [True, False])
def test_halo_exchange_matches_jax_and_padded_image(halo, wrap, mesh,
                                                    jmesh):
    """Each shard of 4 rows gets `halo` rows of its neighbours (halo 3:
    the rows a cubic filter reads): equal to the JAX exchange, and to the
    whole image padded (wrap, or the edge rows repeated) and cut again."""
    x = np.arange(32 * 8, dtype=np.float32).reshape(32, 8)
    got = parallel.halo_exchange_rows(
        parallel.rows_sharding(mesh).place(torch.from_numpy(x)), halo,
        wrap=wrap)
    assert all(s.shape == (4 + 2 * halo, 8) for s in got)
    assert np.array_equal(torch.cat(got).numpy(),
                          _jax_halo(jmesh, x, halo, wrap))
    padded = np.pad(x, ((halo, halo), (0, 0)),
                    mode="wrap" if wrap else "edge")
    for i, s in enumerate(got):
        assert np.array_equal(s.numpy(), padded[4 * i:4 * i + 4 + 2 * halo])


@pytest.mark.parametrize("wrap", [True, False])
def test_one_shard_halo_matches_jax(wrap):
    x = np.arange(6 * 3, dtype=np.float32).reshape(6, 3)
    got = parallel.halo_exchange_rows([torch.from_numpy(x)], 2, wrap=wrap)
    jm = jpar.make_mesh(jax.devices()[:1])
    assert np.array_equal(got[0].numpy(), _jax_halo(jm, x, 2, wrap))


def test_halo_wider_than_a_shard_jax_short_port_refuses(mesh, jmesh):
    """Halo 3 on eight 2-row shards of a 16 x 2 image: the JAX exchange
    returns (48, 2) where its contract is [H_loc + 2 * halo] a shard,
    (64, 2); the port raises ValueError."""
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    assert _jax_halo(jmesh, x, 3, True).shape == (48, 2)
    with pytest.raises(ValueError, match="halo 3 exceeds"):
        parallel.halo_exchange_rows(parallel.shard_batch(
            torch.from_numpy(x), mesh), 3)
    assert [s.shape[0] for s in parallel.halo_exchange_rows(
        parallel.shard_batch(torch.from_numpy(x), mesh), 2)] == [6] * 8


@pytest.mark.parametrize("case", sorted(NORMAL_CASES))
def test_sharded_normal_map_matches_jax(case, mesh, jmesh, frozen):
    """Bit for bit the JAX package's run without FMA; within 2 ulp of its
    live jitted run; a one-entry mesh gives the same bits."""
    amp, mu, mv, inv = NORMAL_CASES[case]
    height = frozen["height"]
    got = torch.cat(parallel.sharded_normal_map(mesh, amp, mu, mv, inv)(
        torch.from_numpy(height))).numpy()
    assert got.shape == (64, 16, 4)
    assert np.array_equal(_bits(got), _bits(frozen[f"nm_{case}"]))
    one = parallel.sharded_normal_map(parallel.make_mesh(["cpu"]), amp, mu,
                                      mv, inv)(torch.from_numpy(height))
    assert np.array_equal(_bits(one[0].numpy()), _bits(got))
    live = np.asarray(jpar.sharded_normal_map(jmesh, amp, mu, mv, inv)(
        jax.device_put(jnp.asarray(height), jpar.rows_sharding(jmesh))))
    ulp = np.abs(_bits(got).astype(np.int64) - _bits(live))
    assert ulp.max() <= 2, case
    print(f"normal map {case}: {int((ulp > 0).sum())} of {got.size} values "
          f"differ from the live jitted run (at most {int(ulp.max())} ulp)")


def test_sharded_box_mip_matches_jax(mesh, jmesh):
    rng = np.random.default_rng(12)
    img = (rng.random((32, 16, 4)) * rng.choice(
        [1e-3, 1.0, 1e3], (32, 16, 4))).astype(np.float32)
    got = torch.cat(parallel.sharded_box_mip(mesh)(torch.from_numpy(img)))
    want = np.asarray(jpar.sharded_box_mip(jmesh)(jax.device_put(
        jnp.asarray(img), jpar.rows_sharding(jmesh))))
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    one = parallel.sharded_box_mip(parallel.make_mesh(["cpu"]))(
        torch.from_numpy(img))
    assert torch.equal(one[0], got)


def test_sharded_box_mip_refuses_odd_rows(mesh):
    with pytest.raises(ValueError, match="even"):
        parallel.sharded_box_mip(mesh)(torch.zeros(24, 8, 4))
    with pytest.raises(ValueError, match="even"):
        parallel.sharded_box_mip(mesh)(torch.zeros(32, 7, 4))


@pytest.mark.parametrize("mips", [False, True])
def test_compress_library_fn_bc1_matches_frozen_jax(mips, mesh, frozen):
    batch = torch.from_numpy(frozen["lib_batch"])
    levels = parallel.compress_library_fn(FMT.BC1_UNORM, mesh,
                                          mips=mips)(batch)
    keys = [f"lib_bc1_mip{k}" for k in range(5)] if mips else ["lib_bc1"]
    assert len(levels) == len(keys)
    for lvl, key in zip(levels, keys):
        assert len(lvl) == 8
        assert np.array_equal(gather(lvl).numpy(), frozen[key]), key


def test_library_odd_side_jax_fails_port_refuses(mesh, jmesh):
    """A 12 x 12 batch with mips=True: 12 -> 6 -> 3, and the JAX function
    fails to reshape the 3 x 3 level; the port raises ValueError."""
    batch = np.random.default_rng(5).random((8, 12, 12, 4)) \
        .astype(np.float32)
    fn = jpar.compress_library_fn(FMT.BC1_UNORM, jmesh, mips=True)
    with pytest.raises(TypeError, match="reshape"):
        fn(jpar.shard_batch(jnp.asarray(batch), jmesh))
    with pytest.raises(ValueError, match="odd side"):
        parallel.compress_library_fn(FMT.BC1_UNORM, mesh, mips=True)(
            torch.from_numpy(batch))
    with pytest.raises(ValueError, match="not a BC format"):
        parallel.compress_library_fn(FMT.R8G8B8A8_UNORM, mesh)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("lib")
    rng = np.random.default_rng(20)
    paths = []
    for i in range(10):
        size = (8, 8) if i % 3 else (12, 6)
        p = str(d / f"t{i}.png")
        tio.save_texture(Texture.from_array(
            rng.random((*size, 4)).astype(np.float32), device="cpu"), p)
        paths.append(p)
    return paths


def test_load_library_matches_jax(pngs):
    """Threaded loads, the odd-sized files resized on the device: within
    4 ulp or 1e-6 of the JAX package's (the resize's products sum in
    another order), equal where no resize runs."""
    got = parallel.load_library(pngs, 8, 8, workers=4, device="cpu")
    want = jpar.load_library(pngs, 8, 8)
    assert got.shape == want.shape == (10, 8, 8, 4)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    g = got.numpy()
    assert (np.abs(g - want) <= np.maximum(4 * np.spacing(np.abs(want)),
                                           1e-6)).all()
    plain = [i for i in range(10) if i % 3]
    assert np.array_equal(g[plain], want[plain])


@pytest.mark.parametrize("mips", [False, True])
def test_compress_library_end_to_end(mips, pngs, mesh):
    """10 files on 8 shards (split unevenly, no padding): the words of
    compress_library_fn on the loaded batch, level by level."""
    outs = parallel.compress_library(pngs, FMT.BC1_UNORM, mesh, 8, 8,
                                     mips=mips)
    assert len(outs) == (4 if mips else 1)
    assert outs[0].shape == (10, 4, 8) and outs[-1].shape[:2] == (
        10, 1 if mips else 4)
    batch = parallel.load_library(pngs, 8, 8, device="cpu")
    one = parallel.compress_library_fn(
        FMT.BC1_UNORM, Mesh((torch.device("cpu"),)), mips=mips)(batch)
    for got, lvl in zip(outs, one):
        assert np.array_equal(got, lvl[0].numpy())
