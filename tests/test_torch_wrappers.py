"""The public functions of ported modules that wrap ported planes functions
(HWC and batch forms, the float colour conversions, the numpy LAB oracles)
and ``features/basic``, each against the JAX package on the same seeded
input, at the tolerance of its own JAX test (named beside each case).

Where the port and JAX share their arithmetic (integer paths, percentiles,
the ordered means) the outputs are bit-equal; where the JAX function is
jitted and divides by a literal, or evaluates ``pow``/``cbrt``/a matrix
product, the port differs in the last bits and the JAX test's own
tolerance applies.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.features import basic as jbasic
from underwater_image_enhancement_tpu.metrics import quality as jquality
from underwater_image_enhancement_tpu.ops import airlight as jair
from underwater_image_enhancement_tpu.ops import colorspace as jcs
from underwater_image_enhancement_tpu.ops import dehaze as jdehaze
from underwater_image_enhancement_tpu.ops import edges as jedges
from underwater_image_enhancement_tpu.ops import lab_tables as jlt
from underwater_image_enhancement_tpu.ops import resize as jresize
from underwater_image_enhancement_tpu.ops import stretch as jstretch
from underwater_image_enhancement_tpu.pipeline import strategies as jstrat
from underwater_image_enhancement_tpu.testing import golden
from underwater_image_enhancement_tpu.testing import golden_features as gfeat
from underwater_image_enhancement_tpu_torch.features import basic as tbasic
from underwater_image_enhancement_tpu_torch.metrics import quality as tquality
from underwater_image_enhancement_tpu_torch.ops import airlight as tair
from underwater_image_enhancement_tpu_torch.ops import colorspace as tcs
from underwater_image_enhancement_tpu_torch.ops import dehaze as tdehaze
from underwater_image_enhancement_tpu_torch.ops import edges as tedges
from underwater_image_enhancement_tpu_torch.ops import lab_tables as tlt
from underwater_image_enhancement_tpu_torch.ops import resize as tresize
from underwater_image_enhancement_tpu_torch.ops import stretch as tstretch
from underwater_image_enhancement_tpu_torch.pipeline import enhance as tenh
from underwater_image_enhancement_tpu_torch.pipeline import six as tsix
from underwater_image_enhancement_tpu_torch.pipeline import strategies as tstrat

from tests import torch_frames

torch.set_num_threads(2)


def _psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(peak ** 2 / mse)


@pytest.fixture(scope="module")
def img():
    return torch_frames.underwater_img()


@pytest.fixture(scope="module")
def rgb_u8():
    return np.random.default_rng(42).integers(0, 256, (96, 128, 3),
                                              dtype=np.uint8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ----------------------------------------------------------------- colorspace

def test_gray_f32_and_unit_gray(img):
    """tests/test_colorspace.py: 1e-6 of cv2's float gray, 1e-7 of its u8
    gray / 255; the port equals JAX bit for bit."""
    got = tcs.rgb_to_gray_f32(_t(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcs.rgb_to_gray_f32(img)))
    assert np.abs(got - cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)).max() < 1e-6
    got = tcs.unit_to_gray_unit(_t(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcs.unit_to_gray_unit(img)))


def test_hsv_f32(img, rgb_u8):
    """The float HSV: S and V bit-equal to JAX (IEEE divisions), H within
    one f32 ulp of [0, 360)."""
    for x in (img, (rgb_u8 / np.float32(255)).astype(np.float32)):
        got = tcs.rgb_to_hsv_f32(_t(x)).numpy()
        want = np.asarray(jcs.rgb_to_hsv_f32(x))
        np.testing.assert_array_equal(got[..., 1:], want[..., 1:])
        assert np.abs(got[..., 0] - want[..., 0]).max() <= 3.1e-5


def test_float_lab_u8(rgb_u8, img):
    """rgb_to_lab_u8 / lab_to_rgb_u8 (the exact float formulas): within one
    u8 level of JAX on a few pixels (``pow`` and ``cbrt`` round their last
    bits otherwise), and the JAX test's gates against cv2 (tests/
    test_colorspace.py: <= 2 levels and 50 dB forward, 40 dB round trip)."""
    for x in (rgb_u8, (img * 255).astype(np.uint8)):
        x32 = x.astype(np.int32)
        lab = tcs.rgb_to_lab_u8(_t(x32)).numpy()
        want = np.asarray(jcs.rgb_to_lab_u8(x32))
        assert np.abs(lab - want).max() <= 1 and (lab != want).mean() < 1e-3
        back = tcs.lab_to_rgb_u8(_t(want)).numpy()
        back_j = np.asarray(jcs.lab_to_rgb_u8(want))
        assert np.abs(back - back_j).max() <= 1 and (back != back_j).mean() < 1e-3
    cv_lab = cv2.cvtColor(rgb_u8, cv2.COLOR_RGB2LAB).astype(np.int32)
    lab = tcs.rgb_to_lab_u8(_t(rgb_u8.astype(np.int32))).numpy()
    assert np.abs(lab - cv_lab).max() <= 2 and _psnr(lab, cv_lab, 255.0) > 50
    back_cv = cv2.cvtColor(cv2.cvtColor(rgb_u8, cv2.COLOR_RGB2LAB),
                           cv2.COLOR_LAB2RGB).astype(np.int32)
    assert _psnr(tcs.lab_to_rgb_u8(_t(lab)).numpy(), back_cv, 255.0) > 40


def test_lab_l_arith_hwc(rgb_u8):
    """The arithmetic L plane of an HWC u8 image: the planes form's values,
    within 1e-4 of JAX's (``pow``/``cbrt`` last bits, on a 0-255 scale)."""
    x = rgb_u8.astype(np.int32)
    got = tcs.rgb_u8_to_lab_l_arith(_t(x)).numpy()
    planes = tcs.rgb_u8_to_lab_l_arith_planes(*(_t(x[..., c]) for c in range(3)))
    np.testing.assert_array_equal(got, planes.numpy())
    assert np.abs(got - np.asarray(jcs.rgb_u8_to_lab_l_arith(x))).max() < 1e-4


def test_lab_numpy_oracles(rgb_u8):
    """The port's copies of the numpy LAB oracles equal the JAX package's."""
    np.testing.assert_array_equal(tlt.rgb_to_lab_u8_exact_np(rgb_u8),
                                  jlt.rgb_to_lab_u8_exact_np(rgb_u8))
    np.testing.assert_array_equal(tlt.lab_to_rgb_u8_exact_np(rgb_u8),
                                  jlt.lab_to_rgb_u8_exact_np(rgb_u8))
    v = np.arange(-9000, 40000, 7)
    np.testing.assert_array_equal(tlt.ab_to_xz_np(v), jlt.ab_to_xz_np(v))
    ab = np.arange(256)
    np.testing.assert_array_equal(tlt.adiv_np(ab), jlt.adiv_np(ab))
    np.testing.assert_array_equal(tlt.bdiv_np(ab), jlt.bdiv_np(ab))
    np.testing.assert_array_equal(
        tlt.rgb_to_lab_u8_exact_np(rgb_u8),
        cv2.cvtColor(rgb_u8, cv2.COLOR_RGB2LAB).astype(np.int32))


# -------------------------------------------------------------------- stretch

@pytest.mark.parametrize("method", ["sort", "radix", "index-u8", "hist",
                                    "hist-fast"])
def test_stretch_channel_and_color_enhancement(img, method):
    """stretch_channel and the HWC color_enhancement / enhance_contrast /
    white_balance: within 1e-6 of JAX (its jitted percentile index and
    /100 take other f32 roundings), bit-equal batch and single."""
    ch = np.ascontiguousarray(img[..., 1])
    got = tstretch.stretch_channel(_t(ch), 15.0, 95.0, method=method).numpy()
    want = np.asarray(jstretch.stretch_channel(ch, 15.0, 95.0, method=method))
    assert np.abs(got - want).max() <= 1e-6
    for fn, args in ((tstretch.color_enhancement, (10.0, 90.0)),
                     (tstretch.enhance_contrast, (15.0, 95.0)),
                     (tstretch.white_balance, (5.0,))):
        jfn = getattr(jstretch, fn.__name__)
        got = fn(_t(img), *args, method=method).numpy()
        assert np.abs(got - np.asarray(jfn(img, *args, method=method))).max() <= 1e-6
    batch = np.stack([img, img[::-1]])
    got_b = tstretch.color_enhancement(_t(batch), 10.0, 90.0, method=method)
    np.testing.assert_array_equal(
        got_b[1].numpy(),
        tstretch.color_enhancement(_t(batch[1]), 10.0, 90.0, method=method).numpy())


def test_percentiles_radix(img):
    """Bit-equal to the JAX radix select (tests/test_stretch_radix.py)."""
    planes = tuple(np.ascontiguousarray(img[..., c]) for c in range(3))
    pcts = (1.0, 15.0, 50.0, 95.0, 99.5)
    got = tstretch.percentiles_radix_planes(tuple(map(_t, planes)), pcts)
    want = jstretch.percentiles_radix_planes(planes, pcts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tstretch.percentiles_radix(_t(planes[0]), (50.0,)).numpy(),
        np.asarray(jstretch.percentiles_radix(planes[0], (50.0,))))


def test_gray_world_white_balance(img):
    """Bit-equal to the jitted JAX function, one image and a batch."""
    batch = np.stack([img, img[::-1] * np.float32(0.7)])
    for x in (img, batch):
        np.testing.assert_array_equal(
            tstretch.gray_world_white_balance(_t(x)).numpy(),
            np.asarray(jstretch.gray_world_white_balance(x)))


# --------------------------------------------------------------------- dehaze

@pytest.mark.parametrize("flavour", ["strategies", "six"])
def test_transmission_and_recover(img, flavour):
    """tests/test_filters.py's gates: the transmission >= 60 dB and the
    recovery >= 55 dB, against JAX and against the float64 oracle."""
    A = np.array([0.4, 0.7, 0.8], np.float32)
    if flavour == "strategies":
        got = tdehaze.estimate_transmission(_t(img), _t(A), 0.6, 20, 0.001)
        want = np.asarray(jdehaze.estimate_transmission(img, A, 0.6, 20, 0.001))
        oracle = golden.transmission(img.astype(np.float64), A, 0.6, 20, 0.001)
    else:
        got = tdehaze.estimate_transmission_six(_t(img), _t(A), 0.3, 20, 0.5)
        want = np.asarray(jdehaze.estimate_transmission_six(img, A, 0.3, 20, 0.5))
        oracle = golden.transmission_six(img.astype(np.float64), A, 0.3, 20, 0.5)
    assert _psnr(got.numpy(), want) > 60 and _psnr(got.numpy(), oracle) > 60
    j = tdehaze.recover_image(_t(img), got, _t(A)).numpy()
    assert _psnr(j, np.asarray(jdehaze.recover_image(img, want, A))) > 55
    np.testing.assert_array_equal(
        tdehaze.dark_channel(_t(img), _t(A), 1e-6).numpy(),
        np.asarray(jdehaze.dark_channel(img, A, 1e-6)))
    batch = np.stack([img, img[::-1]])
    tb = tdehaze.estimate_transmission(_t(batch), _t(A), 0.6, 20, 0.001)
    np.testing.assert_array_equal(
        tb[0].numpy(),
        tdehaze.estimate_transmission(_t(img), _t(A), 0.6, 20, 0.001).numpy())


# ------------------------------------------------------------------- airlight

def test_quadtree_airlight_hwc_and_batch(img):
    """A bit-equal to JAX's (tests/test_airlight.py holds JAX to 1e-6 of the
    oracles): the SAT descent, the exact descent, a batch, and the generic
    descent on the port's own corners."""
    batch = np.stack([img, img[::-1, ::-1].copy()])
    np.testing.assert_array_equal(tair.quadtree_airlight(_t(img)).numpy(),
                                  np.asarray(jair.quadtree_airlight(img)))
    np.testing.assert_array_equal(tair.quadtree_airlight_exact(_t(img)).numpy(),
                                  np.asarray(jair.quadtree_airlight_exact(img)))
    got = tair.quadtree_airlight_batch(_t(batch)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i],
                                      tair.quadtree_airlight(_t(batch[i])).numpy())
    planes = tuple(_t(img[..., c]) for c in range(3))
    gray = tcs.gray_u8_planes(*(tcs.quantize_u8(p) for p in planes))
    edge = tedges.canny_u8(gray).to(torch.float32)
    sats = tair._sat_rows(tair._stats7(torch.stack(list(planes) + [edge])))
    box = tair.quadtree_descend(
        lambda rows, cols: tair._corner_grid(sats, rows.tolist(), cols.tolist()),
        *img.shape[:2])
    _, want_box = tair.quadtree_airlight_planes(planes, return_box=True)
    assert box == want_box


# ---------------------------------------------------------- edges and resize

def test_canny_unit(img):
    gray = np.asarray(jcs.unit_to_gray_unit(img))
    np.testing.assert_array_equal(tedges.canny_unit(_t(gray)).numpy(),
                                  np.asarray(jedges.canny_unit(gray)))


@pytest.mark.parametrize("channels", [0, 3])
def test_resize_bilinear(channels):
    """tests/test_resize.py: within 1e-3 of cv2; within 1e-5 of JAX (its
    matrix products sum in another order)."""
    rng = np.random.default_rng(7)
    x = rng.random((97, 130, 3) if channels else (97, 130)).astype(np.float32)
    got = tresize.resize_bilinear(_t(x), 48, 64).numpy()
    assert got.shape == ((48, 64, 3) if channels else (48, 64))
    assert np.abs(got - cv2.resize(x, (64, 48),
                                   interpolation=cv2.INTER_LINEAR)).max() < 1e-3
    assert np.abs(got - np.asarray(jresize.resize_bilinear(x, 48, 64))).max() < 1e-5


# -------------------------------------------------- quality, six, strategies

def test_assess_vector_and_batch(img):
    """The 8 scores within 1e-3 of JAX (the port's metric gate), and the
    batch equal to the single vectors (tests/test_metrics.py: 1e-4)."""
    got = tquality.assess_all_vector(_t(img)).numpy()
    assert np.abs(got - np.asarray(jquality.assess_all_vector(img))).max() <= 1e-3
    batch = np.stack([img, img * np.float32(0.25)])
    gb = tquality.assess_batch(_t(batch)).numpy()
    for i in range(2):
        np.testing.assert_allclose(
            gb[i], tquality.assess_all_vector(_t(batch[i])).numpy(), atol=1e-4)


def test_six_strategy_batch(img):
    batch = np.stack([img, img[::-1].copy()])
    outs, codes = tenh.six_strategy_batch(batch, device="cpu")
    assert outs.shape == (2, 6) + img.shape and codes.shape == (2,)
    for i in range(2):
        single, code = tenh.six_strategy_single(batch[i], device="cpu")
        np.testing.assert_array_equal(outs[i].numpy(), single.numpy())
        assert int(codes[i]) == int(code)


@pytest.mark.parametrize("name", list(tsix.SIX_STRATEGIES))
def test_six_recipe_functions(img, name):
    """The six recipes' public forms (the JAX contract ``fn(img, *,
    method, A=None)``): the pipeline's recipe with the tier's airlight,
    bit for bit, in both tiers, and a batch equal to single images."""
    fn = tsix.SIX_STRATEGIES[name]
    for method, fast in (("radix", False), ("hist-fast", True)):
        A = tsix.airlight(tsix.split_planes(_t(img)), fast)
        want = tsix.run_strategy(name, _t(img), A, fast).numpy()
        np.testing.assert_array_equal(fn(_t(img), method=method).numpy(), want)
    batch = np.stack([img, img[::-1].copy()])
    np.testing.assert_array_equal(fn(_t(batch))[1].numpy(),
                                  fn(_t(batch[1])).numpy())
    with pytest.raises(ValueError, match="method"):
        fn(_t(img), method="nope")


@pytest.mark.parametrize("name", list(jstrat.STRATEGY_FNS))
def test_strategy_functions_match_jax(img, name):
    """The five strategy functions and ``apply_strategy``: 1e-6 of JAX for
    CLAHE and histogram equalization, >= 50 dB for the dehaze strategies
    (tests/test_strategies.py's gate), the batch equal to single images."""
    got = tstrat.apply_strategy(_t(img), name).numpy()
    np.testing.assert_array_equal(got, getattr(tstrat, name)(_t(img)).numpy())
    want = np.asarray(jstrat.apply_strategy(img, name))
    if name in tstrat.DEHAZE:
        assert _psnr(got, want) >= 50.0
    else:
        assert np.abs(got - want).max() <= 1e-6
    batch = np.stack([img, img[:, ::-1].copy()])
    gb = getattr(tstrat, name)(_t(batch)).numpy()
    np.testing.assert_array_equal(gb[0], got)


def test_apply_strategy_custom_params_and_errors(img):
    params = {"omega": 0.6, "guided_radius": 20, "L_low": 15, "L_high": 92,
              "apply_gamma": True}
    got = tstrat.apply_strategy(_t(img), "medium_dehazing", params).numpy()
    want = np.asarray(jstrat.apply_strategy(img, "medium_dehazing", params))
    assert _psnr(got, want) >= 50.0
    clahe = {"clip_limit": 3.0, "tile_grid_size": [4, 4], "apply_gamma": True}
    got = tstrat.apply_strategy(_t(img), "clahe_enhancement", clahe).numpy()
    want = np.asarray(jstrat.apply_strategy(img, "clahe_enhancement", clahe))
    assert np.abs(got - want).max() <= 1e-6
    with pytest.raises(ValueError, match="unknown strategy"):
        tstrat.apply_strategy(_t(img), "nope")


# ------------------------------------------------------------ features/basic

def test_basic_features(img):
    """tests/test_features.py:53: the 18 values within 1e-5 of the float64
    oracle, zeros after; against JAX bit for bit (the ordered means)."""
    got = tbasic.extract_basic_features(_t(img)).numpy()
    assert got.shape == (79,) and got.dtype == np.float32
    want = gfeat.extract_basic_features(img.astype(np.float64))
    np.testing.assert_allclose(got[:18], want[:18], atol=1e-5)
    assert (got[18:] == 0).all()
    np.testing.assert_array_equal(got, np.asarray(
        jbasic.extract_basic_features(img)))
    batch = np.stack([img, img[:, ::-1].copy()])
    gb = tbasic.extract_basic_batch(_t(batch)).numpy()
    np.testing.assert_array_equal(gb, np.asarray(jbasic.extract_basic_batch(batch)))
    np.testing.assert_array_equal(gb[0], got)
