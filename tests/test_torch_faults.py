"""The port's public contracts against the JAX package's, where the two
packages share a name: the HWC colour conversions (one (..., 3) array in,
JAX's shape and dtype out; the planes forms carry ``_planes``), the
parameter order of ``histeq.clahe_enhancement_planes``, the name
``cast_code`` of ``cast.correct_cast`` and ``guided_subsample`` of
``dehaze.estimate_transmission_planes``.  Each test calls the port the way
a caller of the JAX function would."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu.ops import colorspace as jcs
from underwater_image_enhancement_tpu.ops import dehaze as jdehaze
from underwater_image_enhancement_tpu.ops import histeq as jhisteq
from underwater_image_enhancement_tpu.pipeline import cast as jcast
from underwater_image_enhancement_tpu_torch.ops import colorspace as tcs
from underwater_image_enhancement_tpu_torch.ops import dehaze as tdehaze
from underwater_image_enhancement_tpu_torch.ops import histeq as thisteq
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.pipeline import cast as tcast

torch.set_num_threads(2)


def _rgb_u8(shape, seed):
    """u8 RGB with every grey level and the pure primaries in it."""
    rgb = np.random.default_rng(seed).integers(0, 256, shape + (3,))
    flat = rgb.reshape(-1, 3)
    flat[:256] = np.arange(256)[:, None]
    flat[256:259] = [[255, 0, 0], [0, 255, 0], [0, 0, 255]]
    return rgb.astype(np.int32)


SHAPES = [(61, 83), (2, 24, 40)]


@pytest.mark.parametrize("shape", SHAPES)
def test_hsv_hwc_matches_jax(shape):
    rgb = _rgb_u8(shape, 1)
    got = tcs.rgb_to_hsv_u8(torch.from_numpy(rgb))
    want = np.asarray(jcs.rgb_to_hsv_u8(jnp.asarray(rgb)))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    planes = tcs.rgb_to_hsv_u8_planes(
        *(torch.from_numpy(np.ascontiguousarray(rgb[..., c])) for c in range(3)))
    np.testing.assert_array_equal(torch.stack(planes, -1).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_lab_l_exact_hwc_matches_jax(shape, impl):
    rgb = _rgb_u8(shape, 2)
    before = dict(kernels.launches)
    got = tcs.rgb_to_lab_l_u8_exact(torch.from_numpy(rgb), impl=impl)
    assert kernels.launches == before  # a CPU tensor: the plain version
    want = np.asarray(jcs.rgb_to_lab_l_u8_exact(jnp.asarray(rgb), impl="xla"))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tcs.rgb_to_lab_l_u8_exact(torch.from_numpy(rgb), impl="fused")


@pytest.mark.parametrize("shape", SHAPES)
def test_lab_arith_hwc_matches_jax(shape):
    """Within one level of JAX (torch's and XLA's pow differ in the last
    ulp, as ``test_arith_lab_within_one_level_of_jax`` says), and equal to
    the planes form."""
    rgb = _rgb_u8(shape, 3)
    got = tcs.rgb_to_lab_u8_arith(torch.from_numpy(rgb))
    want = np.asarray(jcs.rgb_to_lab_u8_arith(jnp.asarray(rgb)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1
    assert (got.numpy() != want).mean() < 1e-3
    planes = tcs.rgb_to_lab_u8_arith_planes(
        *(torch.from_numpy(np.ascontiguousarray(rgb[..., c])) for c in range(3)))
    np.testing.assert_array_equal(torch.stack(planes, -1).numpy(), got.numpy())


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


@pytest.mark.parametrize("gamma", [None, 1.5])
def test_clahe_enhancement_planes_positional_matches_jax(gamma):
    """(planes, clip_limit, tiles_x, tiles_y, impl, lab_fast, gamma), all
    positional, in both packages; within the ulps of
    ``test_clahe_leg_matches_jax``."""
    img = torch_frames.img_unit()
    planes = [np.ascontiguousarray(img[..., c]) for c in range(3)]
    args = (3.0, 8, 8, "split", False, gamma)
    got = thisteq.clahe_enhancement_planes(
        tuple(torch.from_numpy(p) for p in planes), *args)
    want = jhisteq.clahe_enhancement_planes(
        tuple(jnp.asarray(p) for p in planes), *args)
    for g, w in zip(got, want):
        assert _ulps(g.numpy(), np.asarray(w)) <= (1 if gamma is None else 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_correct_cast_by_keyword_matches_jax(seed):
    img = np.random.default_rng(seed).uniform(0, 1, (40, 56, 3)).astype(
        np.float32)
    img[..., seed] += 0.2  # a red, green or blue cast
    img = np.clip(img, 0, 1)
    code = jcast.detect_cast(jnp.asarray(img))
    want = np.asarray(jcast.correct_cast(jnp.asarray(img), cast_code=code))
    t_code = tcast.detect_cast(torch.from_numpy(img))
    assert int(t_code) == int(code)
    got = tcast.correct_cast(torch.from_numpy(img), cast_code=t_code)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("guided_subsample", [1, 4])
@pytest.mark.parametrize("omega,r", [(0.5, 15), (0.6, 20)])
def test_estimate_transmission_planes_subsample_matches_jax(omega, r,
                                                            guided_subsample):
    """Within 1e-6 of the jitted JAX function (as
    ``test_estimate_transmission_planes_match_jax``), and above the JAX
    suite's 60 dB gate for the transmission."""
    rng = np.random.default_rng(5)
    planes = [rng.uniform(0, 1, (61, 83)).astype(np.float32) for _ in range(3)]
    A = rng.uniform(0.5, 1.0, 3).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda p, a: jdehaze.estimate_transmission_planes(
            p, a, omega, r, 0.001, guided_subsample=guided_subsample))(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(A)))
    got = tdehaze.estimate_transmission_planes(
        tuple(torch.from_numpy(p) for p in planes), torch.from_numpy(A),
        omega, r, 0.001, guided_subsample=guided_subsample).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    mse = float(np.mean((got.astype(np.float64) - want) ** 2))
    assert mse == 0 or 10 * np.log10(1.0 / mse) > 60
