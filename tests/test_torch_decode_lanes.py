"""The decode kernels' per-pixel arithmetic on the CPU (K1
csrc/bc7_decode.cu and K4 csrc/bc6h_decode.cu, a lane a pixel).

- Each lane takes its pixel's index at a closed-form bit position
  (bc67._index_field, the formula of dec::index_offset / index_width in
  csrc/decode_lanes.cuh) where the plain twins walk the fields in order;
  pinned here against that walk for every BC7 mode x shape x pixel and
  every BC6H mode row x shape x pixel, from the kernels' header lengths
  to the block's last bit.
- The f32 contracts that the kernels' f32 epilogue is held to on the card
  (bc67._bc7_decode_f32_plain, bc6h._bc6h_decode_f32_plain) against the
  JAX package's decode, frozen in tests/golden/decode_refs.npz."""

import pathlib

import numpy as np
import pytest
import torch

from directxtex_tpu_torch.bc import bc6h, bc67
from directxtex_tpu_torch.bc.bc67_tables import BC6H_MODE_INFO, FIXUPS

from test_torch_bc6h_decode import _mixed_blocks as _bc6h_mixed
from test_torch_bc7_decode import _layout_blocks, _mixed_blocks, _mode_blocks


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _walk(start, prec, anchors):
    """The sequential walk: (position, width) of each pixel's index."""
    out, pos = [], start
    for i in range(16):
        n = prec - (1 if i in anchors else 0)
        out.append((pos, n))
        pos += n
    return out, pos


def _bc7_index_start(mode):
    """The kernel's index start (p_idx in csrc/bc7_decode.cu): mode bits,
    shape, rotation, index mode, the endpoints, the p bits."""
    m = bc67._BC7_MODES[mode]
    n_ep = 2 * (m.partitions + 1)
    return (mode + 1 + m.partition_bits + m.rotation_bits
            + m.index_mode_bits + n_ep * sum(m.rgba_prec) + m.p_bits)


@pytest.mark.parametrize("mode", range(8))
def test_bc7_index_fields_closed_form(mode):
    m = bc67._BC7_MODES[mode]
    p_idx = _bc7_index_start(mode)
    for shape in range(1 << m.partition_bits):
        a2 = a3 = 16
        if m.partitions:
            fix = FIXUPS[m.partitions][shape]
            a2 = int(fix[1])
            if m.partitions == 2:
                a3 = int(fix[2])
        walk, end = _walk(p_idx, m.index_prec, {0, a2, a3})
        got = [bc67._index_field(i, m.index_prec, a2, a3) for i in range(16)]
        assert [(p_idx + off, n) for off, n in got] == walk, shape
        if m.index_prec2:
            # the second set starts where the first ends (p_idx2)
            assert end == p_idx + 16 * m.index_prec - (m.partitions + 1)
            walk, end = _walk(end, m.index_prec2, {0})
            got = [bc67._index_field(i, m.index_prec2) for i in range(16)]
            assert [(walk[0][0] + off, n) for off, n in got] == walk
        assert end == 128, shape


@pytest.mark.parametrize("row", range(14))
def test_bc6h_index_fields_closed_form(row):
    parts, iprec = BC6H_MODE_INFO[row][1], BC6H_MODE_INFO[row][3]
    hb = 82 if parts else 65       # header bits (csrc/bc6h_decode.cu)
    for shape in range(32 if parts else 1):
        a2 = int(FIXUPS[1][shape][1]) if parts else 16
        walk, end = _walk(hb, iprec, {0, a2})
        got = [bc67._index_field(i, iprec, a2) for i in range(16)]
        assert [(hb + off, n) for off, n in got] == walk, shape
        assert end == 128, shape
        # every field lies in the block's high 64 bits, as the kernel
        # reads it (w.hi >> (hb - 64 + offset))
        assert all(64 <= pos and pos + n <= 128 for pos, n in walk)


_BC7_SETS = {**{f"bc7_mode{m}": lambda m=m: _mode_blocks(m, 64, 500 + m)
                for m in range(8)},
             "bc7_mixed": _mixed_blocks, "bc7_layout": _layout_blocks}


@pytest.mark.parametrize("key", sorted(_BC7_SETS))
def test_bc7_f32_plain_equals_jax(key):
    got = bc67._bc7_decode_f32_plain(torch.from_numpy(_BC7_SETS[key]()))
    ref = np.load(GOLDEN / "decode_refs.npz")[key]
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))


@pytest.mark.parametrize("signed", [False, True])
def test_bc6h_f32_plain_equals_jax(signed):
    blocks = torch.from_numpy(_bc6h_mixed(signed))
    got = bc6h._bc6h_decode_f32_plain(blocks, signed)
    ref = np.load(GOLDEN / "decode_refs.npz")[
        "bc6h_mixed_s" if signed else "bc6h_mixed_u"]
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))
