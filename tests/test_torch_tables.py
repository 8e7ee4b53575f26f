"""The port's numpy tables and host-side constants equal the JAX package's."""

import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.ops import airlight as jair
from underwater_image_enhancement_tpu.ops import colorspace as jcs
from underwater_image_enhancement_tpu.ops import histeq as jhisteq
from underwater_image_enhancement_tpu.ops import lab_tables as jlt
from underwater_image_enhancement_tpu.ops import stretch as jstretch
from underwater_image_enhancement_tpu.pipeline import cast as jcast
from underwater_image_enhancement_tpu.utils import config as jconfig
from underwater_image_enhancement_tpu_torch.ops import airlight as tair
from underwater_image_enhancement_tpu_torch.ops import histeq as thisteq
from underwater_image_enhancement_tpu_torch.ops import lab_tables as tlt
from underwater_image_enhancement_tpu_torch.ops import stretch as tstretch
from underwater_image_enhancement_tpu_torch.pipeline import cast as tcast
from underwater_image_enhancement_tpu_torch.utils import config as tconfig

torch.set_num_threads(2)

TABLES = ["GAMMA_TAB", "CBRT_TAB", "COEFFS", "L2YF_TAB", "INV_GAMMA_TAB",
          "COEFFS_INV"]
SCALARS = ["LAB_SHIFT", "LAB_SHIFT2", "GAMMA_SCALE", "NCBRT", "L_SCALE",
           "L_SHIFT", "BASE_SHIFT", "BASE", "MIN_AB", "INV_GAMMA_SIZE",
           "AB_LIN_THRESH", "AB_LIN_K"]


@pytest.mark.parametrize("name", TABLES)
def test_table_equal(name):
    want, got = getattr(jlt, name), getattr(tlt, name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", SCALARS)
def test_scalar_equal(name):
    assert getattr(tlt, name) == getattr(jlt, name)


def test_kernel_table_blocks_hold_the_tables():
    """The flat blocks the CUDA kernels stage are the tables, in order."""
    f = tlt.FWD_TABLE
    assert f.dtype == np.int32
    np.testing.assert_array_equal(f[:2], [jlt.L_SCALE, jlt.L_SHIFT])
    np.testing.assert_array_equal(f[2:11], jlt.COEFFS.reshape(-1))
    np.testing.assert_array_equal(f[11:267], jlt.GAMMA_TAB)
    np.testing.assert_array_equal(f[267:], jlt.CBRT_TAB)
    i = tlt.INV_TABLE
    np.testing.assert_array_equal(i[:9], jlt.COEFFS_INV.reshape(-1))
    np.testing.assert_array_equal(
        i[9:15], [jlt.MIN_AB, jlt.BASE * 9 // 4, jlt.AB_LIN_THRESH,
                  jlt.AB_LIN_K, 128 * jlt.BASE // 500,
                  128 * jlt.BASE // 200 - 1])
    np.testing.assert_array_equal(i[15:271], jlt.L2YF_TAB[:, 0])
    np.testing.assert_array_equal(i[271:527], jlt.L2YF_TAB[:, 1])
    np.testing.assert_array_equal(i[527:], jlt.INV_GAMMA_TAB)


def test_forward_lab_u16_block_holds_the_tables():
    """The block the forward-LAB kernels stage: the header padded to 12
    ints, GAMMA_TAB, then CBRT_TAB as u16 pairs, each section on a 16-byte
    boundary."""
    f = tlt.FWD_TABLE_U16
    assert f.dtype == np.int32 and f.size == 12 + 256 + 3072 // 2
    np.testing.assert_array_equal(f[:11], tlt.FWD_TABLE[:11])
    assert f[11] == 0
    np.testing.assert_array_equal(f[12:268], jlt.GAMMA_TAB)
    np.testing.assert_array_equal(f[268:].view(np.uint16), jlt.CBRT_TAB)
    assert 12 * 4 % 16 == 0 and 268 * 4 % 16 == 0


def test_u8_grid_and_config_constants():
    np.testing.assert_array_equal(tstretch.U8_GRID, jstretch._U8_GRID)
    assert tconfig.SUPPORTED_FORMATS == jconfig.SUPPORTED_FORMATS
    assert tcast.CAST_NAMES == jcast.CAST_NAMES


@pytest.mark.parametrize("H,W", [(96, 128), (97, 131), (120, 160),
                                 (119, 157), (7, 9)])
def test_clahe_weights_equal_jax_prep(H, W):
    """The band-frame f32 interpolation fractions are the JAX package's."""
    x = np.zeros((1, H, W), np.int32)
    want = jhisteq._clahe_prep(x, 2.0, 8, 8)
    geo = thisteq._geometry(H, W, 8, 8)
    ya, xa = thisteq._clahe_weights(geo)
    assert (geo.th, geo.tw, geo.pt, geo.plf) == (want[4], want[5], want[8],
                                                  want[9])
    np.testing.assert_array_equal(ya, want[2])
    np.testing.assert_array_equal(xa, want[3])


@pytest.mark.parametrize("H,W", [(120, 160), (1080, 1920), (97, 131), (5, 3)])
def test_level_plan_equal(H, W):
    assert tair._level_plan(H, W, 1) == jair._level_plan(H, W, 1)


@pytest.mark.parametrize("n", [2, 19200, 12288, 2073600])
def test_lerp_indices_equal(n):
    import jax

    for p in (2.0, 3.0, 5.0, 10.0, 15.0, 20.0, 85.0, 90.0, 95.0, 97.0, 98.0):
        li, hi, lw, hw = jax.jit(
            lambda: jstretch._lerp_indices(n, p, p))()
        got = tstretch._lerp_indices(n, p)
        assert got[:2] == (int(li[0]), int(hi[0]))
        assert np.float32(got[2]) == np.asarray(lw)[0]
        assert np.float32(got[3]) == np.asarray(hw)[0]


def test_hsv_tables_and_arith_lab_constants_equal():
    np.testing.assert_array_equal(tlt.SDIV_TAB, jcs._SDIV_TAB)
    np.testing.assert_array_equal(tlt.HDIV_TAB, jcs._HDIV_TAB)
    assert tlt.SDIV_TAB.dtype == tlt.HDIV_TAB.dtype == np.int32
    np.testing.assert_array_equal(tlt.RGB2XYZ_F32, np.asarray(jcs._RGB2XYZ))
    np.testing.assert_array_equal(tlt.WHITE_F32, np.asarray(jcs._WHITE))
    assert tlt.RGB2XYZ_F32.dtype == tlt.WHITE_F32.dtype == np.float32


def test_phase1_config_equal():
    assert tconfig.DEFAULT_STRATEGIES == jconfig.DEFAULT_STRATEGIES
    assert tconfig.DEFAULT_QUALITY_WEIGHTS == jconfig.DEFAULT_QUALITY_WEIGHTS
    assert tconfig.FULL_QUALITY_WEIGHTS == jconfig.FULL_QUALITY_WEIGHTS
    t, j = tconfig.Config(), jconfig.Config()
    for f in ("image_folder", "output_folder", "save_all_enhanced",
              "batch_size", "fast_label", "quality_weights", "feature_folder",
              "strategy_folder", "model_folder", "report_folder",
              "strategies", "data_parallel", "n_devices"):
        assert getattr(t, f) == getattr(j, f), f
