"""The port's 79 features (features/full.py) and the ops only they use,
against the JAX package on the CPU: resize_u8 (also cv2), uniform LBP,
GLCM, the DCT (also cv2.dct), and the whole vector in both tiers.

Tolerances: resize bit-equal; LBP within 2.5/n (tests/test_features.py's
bar: a borderline f32 tie may flip); GLCM and DCT f32 sums within 1e-5
relative; the exact vector within 1e-4 relative or 1e-5 absolute; the
fast vector at the JAX suite's fast-versus-exact bar, 1 % relative or
0.02 absolute (the arithmetic LAB's cbrt and ** 2.4 round their last ulp
otherwise in torch than in XLA, and a rounded L, a or b can flip by 1)."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu.features import full as jfull
from underwater_image_enhancement_tpu.ops import dct as jdct
from underwater_image_enhancement_tpu.ops import resize as jresize
from underwater_image_enhancement_tpu.ops import texture as jtexture
from underwater_image_enhancement_tpu_torch.features import full as tfull
from underwater_image_enhancement_tpu_torch.ops import dct as tdct
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops import resize as tresize
from underwater_image_enhancement_tpu_torch.ops import texture as ttexture

torch.set_num_threads(2)


def _gray_u8(seed, shape=(120, 160), smooth=False):
    rng = np.random.default_rng(seed)
    if smooth:  # flat patches: ties between the LBP samples and the centre
        x = np.kron(rng.integers(0, 256, (shape[0] // 8, shape[1] // 8)),
                    np.ones((8, 8)))
        return x.astype(np.int32)
    return rng.integers(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("src,dst", [((120, 160), (128, 128)),
                                     ((97, 131), (128, 128)),
                                     ((1080 // 8, 1920 // 8), (128, 128)),
                                     ((5, 300), (128, 128)), ((1, 7), (4, 9)),
                                     ((300, 1), (128, 128))])
def test_resize_u8_bit_equal_to_jax_and_cv2(src, dst):
    x = _gray_u8(0, src)
    got = tresize.resize_u8(torch.from_numpy(x), *dst).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jresize.resize_u8(jnp.asarray(x), *dst)))
    np.testing.assert_array_equal(
        got, cv2.resize(x.astype(np.uint8), (dst[1], dst[0]),
                        interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_lbp_hist_matches_jax(seed, smooth):
    x = _gray_u8(seed, smooth=smooth)
    got = ttexture.lbp_uniform_hist(torch.from_numpy(x)).numpy()
    want = np.asarray(jtexture.lbp_uniform_hist(jnp.asarray(x)))
    assert got.dtype == np.float32 and got.shape == (10,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.5 / x.size)


@pytest.mark.parametrize("case", ["random", "smooth", "flat"])
def test_glcm_props_match_jax(case):
    x = {"random": _gray_u8(2, (128, 128)),
         "smooth": _gray_u8(3, (128, 128), smooth=True),
         "flat": np.full((128, 128), 9, np.int32)}[case]
    got = ttexture.glcm_props(torch.from_numpy(x)).numpy()
    want = np.asarray(jtexture.glcm_props(jnp.asarray(x)))
    assert got.shape == (6, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shape", [(120, 160), (97, 131), (8, 8)])
def test_dct2_matches_jax_and_cv2(shape):
    x = _gray_u8(4, shape).astype(np.float32)
    got = tdct.dct2(torch.from_numpy(x)).numpy()
    want = np.asarray(jdct.dct2(jnp.asarray(x)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    if shape[0] % 2 == 0 and shape[1] % 2 == 0:  # cv2.dct takes even sizes
        np.testing.assert_allclose(got, cv2.dct(x), rtol=0, atol=1e-5 * scale)


def _frames():
    uw = torch_frames.underwater_img()
    return {"underwater": uw, "random": torch_frames.img_unit(),
            "flipped": uw[::-1, ::-1].copy(),
            "flat": np.full((48, 64, 3), 0.5, np.float32)}


@pytest.fixture(scope="module")
def jax_features():
    return {(name, fast): (img, np.asarray(jfull.extract_all_features(
        jnp.asarray(img), fast=fast)))
        for name, img in _frames().items() for fast in (False, True)}


LBP = slice(35, 45)


@pytest.mark.parametrize("name", ["underwater", "random", "flipped", "flat"])
def test_features_exact_tier_match_jax(jax_features, name):
    img, want = jax_features[name, False]
    kernels.reset_launches()
    got = tfull.extract_all_features(torch.from_numpy(img)).numpy()
    assert sum(kernels.launches.values()) == 0  # CPU: plain versions
    assert got.shape == (tfull.FEATURE_DIM,) and got.dtype == np.float32
    assert np.isfinite(got).all()
    err = np.abs(got.astype(np.float64) - want)
    ok = (err <= 1e-4 * np.abs(want)) | (err <= 1e-5)
    ok[LBP] = err[LBP] <= 2.5 / (img.shape[0] * img.shape[1])
    assert ok.all(), (np.flatnonzero(~ok), got[~ok], want[~ok])


@pytest.mark.parametrize("name", ["underwater", "random", "flipped", "flat"])
def test_features_fast_tier_match_jax(jax_features, name):
    img, want = jax_features[name, True]
    got = tfull.extract_all_features(torch.from_numpy(img), fast=True).numpy()
    assert np.isfinite(got).all()
    err = np.abs(got.astype(np.float64) - want)
    ok = (err < 0.01 * np.maximum(np.abs(want), 1e-6)) | (err < 0.02)
    assert ok.all(), (np.flatnonzero(~ok), got[~ok], want[~ok])


def test_extract_batch_stacks_single_frames():
    imgs = np.stack([_frames()["underwater"], _frames()["flipped"]])
    got = tfull.extract_batch(torch.from_numpy(imgs))
    assert got.shape == (2, tfull.FEATURE_DIM)
    for i in range(2):
        assert torch.equal(got[i],
                           tfull.extract_all_features(torch.from_numpy(imgs[i])))


def test_flat_frame_guards():
    """A constant frame: skew 0 and kurtosis -3 by the m2 > 0 guards, GLCM
    correlation 1, everything finite."""
    got = tfull.extract_all_features(
        torch.from_numpy(_frames()["flat"])).numpy()
    assert np.isfinite(got).all()
    for c in range(3):
        assert got[4 * c + 2] == 0.0 and got[4 * c + 3] == -3.0
    assert got[45 + 2 * 4] == 1.0  # correlation's mean over the 4 angles
