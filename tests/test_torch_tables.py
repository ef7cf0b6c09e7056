"""The PyTorch port's carried state and block layout, pinned to the JAX
package: the BC6H/BC7 spec tables, the search and refine constants, the
packed tables in the CUDA headers, and image_to_blocks /
blocks_to_image."""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directxtex_tpu.bc import bc67 as jbc67
from directxtex_tpu.bc import bc67_tables as jtables
from directxtex_tpu.bc import common as jcommon
from directxtex_tpu_torch.bc import bc6h, bc67, common


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "directxtex_tpu_torch" / "csrc")
CUH = CSRC / "bc7_common.cuh"


@pytest.mark.parametrize("name", ["PARTITIONS", "FIXUPS", "WEIGHTS2",
                                  "WEIGHTS3", "WEIGHTS4", "BC6H_DESC",
                                  "BC6H_MODE_TO_INFO"])
def test_spec_tables_equal(name):
    got = bc67.tables_as_numpy()[name]
    ref = getattr(jtables, name)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_bc6h_mode_info_equal():
    assert bc67.tables_as_numpy()["BC6H_MODE_INFO"] == jtables.BC6H_MODE_INFO


@pytest.mark.parametrize("name", [
    "BC6H_SHARED_ROUNDS", "BC6H_GROUP_REFIT_MINPREC", "BC6H_LS_MAG_CAP",
    "BC6H_LADDER_LIGHT", "BC6H_LADDER_FULL", "BC6H_LADDER_MID",
    "BC6H_LADDER_MAXQ", "_BC7_MAXQUALITY", "_BC6H_MID", "BC6H_SHARED_FIT",
    "BC6H_REFIT_ROUNDS"])
def test_bc6h_constants_equal(name):
    assert getattr(bc6h, name) == getattr(jbc67, name)


def test_bc6h_shipped_settings_match_reference():
    # the port implements the shared-fit search without the keep-better
    # guard; the row groups are the JAX package's
    assert jbc67.BC6H_SHARED_FIT and not jbc67.BC6H_SHARED_KEEPBETTER
    assert bc6h._bc6h_row_groups() == jbc67._bc6h_row_groups()


@pytest.mark.parametrize("name", [
    "BC7_SHAPE_CANDIDATES", "_ON_AXIS_W", "_MODE4_IMS", "_MODE45_ROTS",
    "_POWER_ITERS", "BC7_SHARED2SUB_IPREC", "BC7_SHARED2SUB_ROUNDS",
    "BC7_SHARED45_ROUNDS", "LADDER_MOMENT"])
def test_search_constants_equal(name):
    assert bc67.tables_as_numpy()[name] == getattr(jbc67, name)


def test_default_tier_settings_match_reference():
    # the port implements the shared fits without the float keep-better
    assert jbc67.BC7_SHARED2SUB and jbc67.BC7_SHARED45
    assert not jbc67.BC7_SHARED_KEEPBETTER


@pytest.mark.parametrize("mode", range(8))
def test_mode_table_equal(mode):
    assert dataclasses.astuple(bc67._BC7_MODES[mode]) == \
        dataclasses.astuple(jbc67._BC7_MODES[mode])


def _cuh_array(name):
    body = re.search(name + r"\[64\] = \{(.*?)\};", CUH.read_text(),
                     re.S).group(1)
    return [int(v.rstrip("u"), 16) for v in re.findall(r"0x[0-9a-f]+u?",
                                                        body)]


@pytest.mark.parametrize("parts,pp_name,pa_name",
                         [(1, "c_pp2", "c_pa2"), (2, "c_pp3", "c_pa3")])
def test_cuda_header_tables_equal(parts, pp_name, pa_name):
    pp, pa = jbc67._packed_shape_tables_bc7(parts, 64)
    assert _cuh_array(pp_name) == list(pp)
    assert _cuh_array(pa_name) == list(pa)


@pytest.mark.parametrize("h,w", [(8, 12), (13, 7), (4, 4), (1, 9)])
def test_image_to_blocks_equal(h, w):
    rng = np.random.default_rng(h * 100 + w)
    img = rng.random((h, w, 4)).astype(np.float32)
    ref, nbh, nbw = jcommon.image_to_blocks(jnp.asarray(img))
    got, gbh, gbw = common.image_to_blocks(torch.from_numpy(img))
    assert (gbh, gbw) == (nbh, nbw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = common.blocks_to_image(got, h, w)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcommon.blocks_to_image(ref, h, w)))
    np.testing.assert_array_equal(back.numpy(), img)


def _cu_rows(text, name):
    body = re.search(name + r"\[[^=]*\] = \{(.*?)\n\};", text,
                     re.S).group(1)
    return [[int(v, 0) for v in re.findall(r"-?(?:0x)?[0-9a-f]+", row)]
            for row in re.findall(r"\{([^{}]*)\}", body)]


def test_bc6h_header_tables_equal():
    """The BC6H header runs, mode table and mode map in bc6h_common.cuh."""
    text = (CSRC / "bc6h_common.cuh").read_text()
    runs = _cu_rows(text.replace("u,", ",").replace("u}", "}"), "c_runs")
    for row in range(14):
        want = [fid | fbit << 4 | pos << 8 | ln << 16
                for fid, fbit, pos, ln in bc6h._header_runs(row)]
        assert runs[row] == want + [0] * (len(runs[row]) - len(want))
    info = re.search(r"c_info\[14\] = \{(.*?)\n\};", text, re.S).group(1)
    rows = [[int(v, 0) for v in re.findall(r"0x[0-9A-F]+|\d+", ln)]
            for ln in info.strip().splitlines()]
    for got, (mode, parts, tr, iprec, w, x, y, z) in zip(
            rows, jtables.BC6H_MODE_INFO):
        assert got == [mode, parts, int(tr), iprec, w[0], *x, *y, *z]
        assert w[0] == w[1] == w[2]
    m2r = re.search(r"c_mode_to_row\[32\] = \{(.*?)\};", text, re.S).group(1)
    assert [int(v) for v in re.findall(r"-?\d+", m2r)] == \
        list(jtables.BC6H_MODE_TO_INFO)


def test_bc6h_row_group_tables_equal():
    text = (CSRC / "bc6h_common.cuh").read_text()
    first = [int(v) for v in re.search(
        r"c_group_first\[6\] = \{(.*?)\}", text).group(1).split(",")]
    n = [int(v) for v in re.search(
        r"c_group_rows\[6\] = \{(.*?)\}", text).group(1).split(",")]
    assert [tuple(range(f, f + k)) for f, k in zip(first, n)] == \
        jbc67._bc6h_row_groups()
