"""The batch forms of CLAHE in the port (``histeq.clahe_u8_batch``,
``clahe_u8`` and ``clahe_enhancement_planes`` on planes with leading
dimensions, ``clahe_enhancement_planes_multi``, ``_clahe_lab_fused_batched``)
and the HWC ``histogram_equalization``.

Each image of a batch must equal the single-plane call bit for bit, and
the JAX package's batch form bit for bit (the Pallas kernels in interpret
mode where JAX reaches them: ``impl="pallas"``; the multi form runs JAX's
one-hot twin, which ``tests/test_pallas.py`` holds equal to the kernel).
The kernel wrappers keep their one-plane contract: a batch of B images is
B calls of K2 (or K5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.ops import colorspace as jcs
from underwater_image_enhancement_tpu.ops import histeq as jhisteq
from underwater_image_enhancement_tpu.testing import golden
from underwater_image_enhancement_tpu_torch.ops import colorspace as tcs
from underwater_image_enhancement_tpu_torch.ops import histeq as thisteq
from underwater_image_enhancement_tpu_torch.ops import kernels

from tests import torch_frames

torch.set_num_threads(2)

SHAPE = (90, 121)   # uneven tiles and a half-tile offset in both axes
CLIPS = (3.0, 1.5, 4.0)


def _u8_batch():
    return np.random.default_rng(11).integers(0, 256, (3,) + SHAPE
                                              ).astype(np.int32)


def _unit_frames():
    """Three (H, W, 3) unit frames on the u8 grid: the fixture crop, its
    flip and a random one."""
    img = torch_frames.underwater_img()[:SHAPE[0], :SHAPE[1]]
    rnd = np.random.default_rng(12).integers(0, 256, SHAPE + (3,))
    return np.stack([img, img[::-1, ::-1],
                     (rnd / np.float32(255)).astype(np.float32)])


def _planes(frames):
    return tuple(torch.from_numpy(np.ascontiguousarray(frames[..., c]))
                 for c in range(3))


@pytest.fixture(scope="module")
def jax_batch():
    x = jnp.asarray(_u8_batch())
    frames = _unit_frames()
    jp = tuple(jnp.asarray(frames[..., c]) for c in range(3))
    out = {
        "per_image": np.asarray(jhisteq.clahe_u8_batch(x, CLIPS,
                                                       impl="pallas")),
        "shared": np.asarray(jhisteq.clahe_u8_batch(x, 2.0, impl="pallas")),
        "vmap": np.asarray(jax.vmap(
            lambda p: jhisteq.clahe_u8(p, 3.0, impl="pallas"))(x)),
        "planes_vmap": [np.asarray(c) for c in jax.vmap(
            lambda r, g, b: jhisteq.clahe_enhancement_planes((r, g, b), 2.0)
        )(*jp)],
        "multi": [[np.asarray(c) for c in leg] for leg in
                  jhisteq.clahe_enhancement_planes_multi(
                      [tuple(c[i] for c in jp) for i in range(3)], CLIPS)],
    }
    L, a, b = jcs.rgb_unit_to_lab_planes(*jp, impl="pallas")
    out["fused"] = [np.asarray(c) for c in jhisteq._clahe_lab_fused_batched(
        L, a, b, 3.0, 8, 8)]
    return out


@pytest.mark.parametrize("clips", ["per_image", "shared"])
def test_clahe_u8_batch_equals_single_and_jax(jax_batch, clips):
    x = torch.from_numpy(_u8_batch())
    limits = CLIPS if clips == "per_image" else 2.0
    before = dict(kernels.launches)
    got = thisteq.clahe_u8_batch(x, limits)
    assert kernels.launches == before  # CPU tensors: the plain versions
    np.testing.assert_array_equal(got.numpy(), jax_batch[clips])
    for i in range(3):
        clip = CLIPS[i] if clips == "per_image" else 2.0
        np.testing.assert_array_equal(got[i].numpy(),
                                      thisteq.clahe_u8(x[i], clip).numpy())


def test_clahe_u8_batch_rejects_wrong_limit_count():
    with pytest.raises(ValueError, match="3 clip limits for 2 images"):
        thisteq.clahe_u8_batch(torch.zeros((2, 16, 16), dtype=torch.int32),
                               CLIPS)


def test_clahe_u8_leading_dims_equal_vmap(jax_batch):
    """``clahe_u8`` of (..., H, W) planes: JAX's vmap rule, bit for bit."""
    x = torch.from_numpy(_u8_batch())
    got = thisteq.clahe_u8(x, 3.0)
    np.testing.assert_array_equal(got.numpy(), jax_batch["vmap"])
    two = thisteq.clahe_u8(x.reshape(1, 3, *SHAPE), 3.0)
    np.testing.assert_array_equal(two[0].numpy(), got.numpy())


@pytest.mark.parametrize("impl", ["split", "fused"])
def test_clahe_enhancement_planes_batch(jax_batch, impl):
    """(B, H, W) planes: each image equals the single-image call and JAX's
    vmapped roundtrip, both impls."""
    planes = _planes(_unit_frames())
    got = thisteq.clahe_enhancement_planes(planes, 2.0, impl=impl)
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(),
                                      jax_batch["planes_vmap"][c])
    for i in range(3):
        single = thisteq.clahe_enhancement_planes(
            tuple(p[i] for p in planes), 2.0, impl=impl)
        for g, s in zip(got, single):
            np.testing.assert_array_equal(g[i].numpy(), s.numpy())


def test_clahe_enhancement_planes_multi(jax_batch):
    planes = _planes(_unit_frames())
    legs = [tuple(p[i] for p in planes) for i in range(3)]
    got = thisteq.clahe_enhancement_planes_multi(legs, CLIPS)
    for i in range(3):
        single = thisteq.clahe_enhancement_planes(legs[i], CLIPS[i])
        for c in range(3):
            np.testing.assert_array_equal(got[i][c].numpy(),
                                          single[c].numpy())
            np.testing.assert_array_equal(got[i][c].numpy(),
                                          jax_batch["multi"][i][c])


def test_clahe_lab_fused_batched(jax_batch):
    """K5 over a batch = CLAHE then the u8 inverse, and JAX's fused batch."""
    L, a, b = tcs.rgb_unit_to_lab_planes(*_planes(_unit_frames()))
    got = thisteq._clahe_lab_fused_batched(L, a, b, 3.0, 8, 8)
    want = tcs.lab_to_rgb_u8_exact_planes(thisteq.clahe_u8(L, 3.0), a, b)
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), want[c].numpy())
        np.testing.assert_array_equal(got[c].numpy(), jax_batch["fused"][c])


def test_histogram_equalization_hwc():
    """Per-channel equalizeHist of an HWC frame: the JAX function within
    one f32 ulp (its jitted /255 is a reciprocal multiply; the port's is
    IEEE), and the JAX suite's 50 dB gate against the oracle."""
    img = torch_frames.underwater_img()
    got = thisteq.histogram_equalization(torch.from_numpy(img)).numpy()
    want = np.asarray(jhisteq.histogram_equalization(img))
    assert np.abs(got - want).max() <= 6e-8
    mse = np.mean((got.astype(np.float64)
                   - golden.hist_eq(img.astype(np.float64))) ** 2)
    assert 10 * np.log10(1.0 / mse) > 50
