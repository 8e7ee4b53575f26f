"""The host side of the inverse-LAB kernels (K3, K3g, K3b:
``csrc/lab_inverse.cu``) and of CLAHE apply (K2: ``csrc/clahe_apply.cu``):
K3's epilogue table, the packed table block the inverse kernels stage, and
the rectangles K2's blocks map (``kernels.clahe_apply_plan``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CLAHE_SHAPES, CLAHE_TILES
from underwater_image_enhancement_tpu.ops import colorspace as jcs
from underwater_image_enhancement_tpu.ops import lab_tables as jlt
from underwater_image_enhancement_tpu_torch.ops import histeq, kernels
from underwater_image_enhancement_tpu_torch.ops import lab_tables as tlt
from underwater_image_enhancement_tpu_torch.ops.layout import div

torch.set_num_threads(2)


def test_unit_lut_is_ieee_k_over_255_and_jax_u8_to_unit():
    """K3 gathers its unit output from this table: every entry is the
    correctly rounded k / 255 and the JAX package's u8_to_unit."""
    lut = kernels.unit_lut(torch.device("cpu")).numpy()
    assert lut.dtype == np.float32 and lut.shape == (256,)
    k = np.arange(256)
    ieee = np.float32(k.astype(np.float32) / np.float32(255.0))
    exact = k / 255.0  # float64: no f32 value lies nearer
    np.testing.assert_array_equal(lut, ieee)
    nearest = np.abs(lut.astype(np.float64) - exact)
    for step in (np.nextafter(lut, np.float32(2)), np.nextafter(lut, np.float32(-1))):
        assert (nearest <= np.abs(step.astype(np.float64) - exact)).all()
    np.testing.assert_array_equal(
        lut, np.asarray(jcs.u8_to_unit(jnp.arange(256, dtype=jnp.int32))))
    # and what the plain K3 gives for each u8 value
    v = torch.arange(256, dtype=torch.int32)
    assert torch.equal(torch.from_numpy(lut)[v.long()],
                       div(v.to(torch.float32), 255.0))


def test_inverse_lab_u8_block_holds_the_tables():
    """The block the inverse-LAB kernels stage: the header padded to 16
    ints, L2Y, L2IFY, then INV_GAMMA_TAB as bytes, each section on a
    16-byte boundary (the bytes of csrc/lab_inverse.cuh LabInvTables)."""
    i = tlt.INV_TABLE_U8
    assert i.dtype == np.int32 and i.size == 16 + 256 + 256 + 4096 // 4
    np.testing.assert_array_equal(i[:15], tlt.INV_TABLE[:15])
    assert i[15] == 0
    np.testing.assert_array_equal(i[16:272], jlt.L2YF_TAB[:, 0])
    np.testing.assert_array_equal(i[272:528], jlt.L2YF_TAB[:, 1])
    np.testing.assert_array_equal(i[528:].view(np.uint8), jlt.INV_GAMMA_TAB)
    assert all(n * 4 % 16 == 0 for n in (16, 272, 528)) and i.nbytes == 6208


@pytest.mark.parametrize("resident", [1, 81, 528, 660, 792, 1056, 10 ** 6])
def test_clahe_strip_rows_fill_a_wave(resident):
    """Strips of one height cover a tile's rows, no more of them a band
    block than one wave of ``resident`` blocks holds, nor than rows, and
    none lower than it need be for that."""
    for th in (1, 2, 9, 67, 135, 270, 512):
        for tx, ty in CLAHE_TILES:
            rows = kernels.clahe_strip_rows(th, tx, ty, resident)
            strips = -(-th // rows)
            want = min(-(-resident // ((tx + 1) * (ty + 1))), th)
            assert 1 <= rows <= th and strips * rows >= th
            assert strips <= want
            assert rows == 1 or -(-th // (rows - 1)) > want


@pytest.mark.parametrize("shape", CLAHE_SHAPES)
@pytest.mark.parametrize("tiles", CLAHE_TILES)
def test_clahe_apply_plan_covers_each_pixel_once(shape, tiles):
    """K2's rectangles cover every pixel of the plane exactly once, and
    each lies in one band block: its pixels share the four tiles whose
    LUTs the block packs."""
    H, W = shape
    geo = histeq._geometry(H, W, *tiles)
    th, tw, pt, plf, tx, ty = geo
    for resident in (1, 528, 792, 1056):
        rows = kernels.clahe_strip_rows(th, tx, ty, resident)
        plan = kernels.clahe_apply_plan(H, W, *geo, rows)
        assert len(plan) == (tx + 1) * (ty + 1) * -(-th // rows)
        seen = np.zeros((H, W), np.int32)
        for rect in plan:
            if rect is None:
                continue
            y0, y1, x0, x1 = rect
            assert 0 <= y0 < y1 <= H and 0 <= x0 < x1 <= W
            assert y1 - y0 <= rows
            # one band block: (y + pt) // th and (x + plf) // tw constant
            assert (y0 + pt) // th == (y1 - 1 + pt) // th
            assert (x0 + plf) // tw == (x1 - 1 + plf) // tw
            seen[y0:y1, x0:x1] += 1
        assert (seen == 1).all()


def test_clahe_plan_at_1080p():
    """At 1080p with 8x8 tiles and 6 blocks of each of 132 SMs: 81 band
    blocks of at most 135x240, 10 strips of 14 rows each, all blocks in
    one wave."""
    geo = histeq._geometry(1080, 1920, 8, 8)
    rows = kernels.clahe_strip_rows(geo.th, 8, 8, 6 * 132)
    assert (geo.th, geo.tw, rows) == (135, 240, 14)
    plan = kernels.clahe_apply_plan(1080, 1920, *geo, rows)
    assert len(plan) == 81 * 10
    assert sum(r is not None for r in plan) <= 6 * 132
