"""CLAHE (the CPU side of kernel K2) against the JAX Pallas kernel in
interpret mode and against cv2; the LAB-L CLAHE leg against JAX."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu.ops import colorspace as jcs
from underwater_image_enhancement_tpu.ops import histeq as jhisteq
from underwater_image_enhancement_tpu_torch.ops import histeq as thisteq
from underwater_image_enhancement_tpu_torch.ops import kernels

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def img_unit():
    """conftest's img_unit, drawn without the session rng
    (tests/torch_frames.py)."""
    return torch_frames.img_unit()


CLIPS = [1.5, 2.0, 3.0, 3.5, 4.0]
SHAPES = [(96, 128), (97, 131)]


def _plane(shape, seed=0):
    """Smooth gradient plus noise: uneven tile histograms that clip."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = 60 + 120 * yy / shape[0] + 40 * np.sin(xx / 9.0)
    return np.clip(base + rng.normal(0, 12, shape), 0, 255).astype(np.int32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("clip", CLIPS)
def test_clahe_u8_bit_equal_to_pallas_and_cv2(shape, clip):
    x = _plane(shape)
    got = thisteq.clahe_u8(torch.from_numpy(x), clip).numpy()
    want = np.asarray(jhisteq.clahe_u8(jnp.asarray(x), clip, impl="pallas"))
    np.testing.assert_array_equal(got, want)
    cv = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(
        x.astype(np.uint8))
    np.testing.assert_array_equal(got, cv)


@pytest.mark.parametrize("shape", SHAPES)
def test_clahe_luts_equal_jax_prep(shape):
    x = _plane(shape, seed=1)
    want = jhisteq._clahe_prep(jnp.asarray(x)[None], 2.0, 8, 8)
    luts, ya, xa, geo = thisteq.clahe_prep(torch.from_numpy(x), 2.0, 8, 8)
    # JAX gathers the 4 LUTs of each band block; its TL LUT of block
    # (i, j) for i, j >= 1 is tile (i-1, j-1)
    luts4 = np.asarray(want[1]).reshape(9, 9, 4, 256)
    np.testing.assert_array_equal(
        luts.numpy().reshape(8, 8, 256), luts4[1:, 1:, 0])
    np.testing.assert_array_equal(ya.numpy(), want[2])
    np.testing.assert_array_equal(xa.numpy(), want[3])


def test_clahe_apply_checks_geometry():
    x = torch.from_numpy(_plane((96, 128)))
    luts, ya, xa, geo = thisteq.clahe_prep(x, 2.0, 8, 8)
    with pytest.raises(ValueError):
        kernels.clahe_apply(x, luts, ya, xa, geo.th + 1, *geo[1:])
    with pytest.raises(ValueError):
        kernels.clahe_apply(x, luts[:-1], ya, xa, *geo)
    with pytest.raises(ValueError):
        kernels.clahe_apply(x, luts, ya.double(), xa, *geo)


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


def _jax_leg_pallas(planes, clip, gamma):
    """The CLAHE leg from the JAX package's Pallas kernels (interpret mode
    on the CPU): its clahe_enhancement_planes takes the XLA twins there."""
    L, a, b = jcs.rgb_unit_to_lab_planes(*planes, impl="pallas")
    L = jhisteq.clahe_u8(L, clip, impl="pallas")
    if gamma is None:
        return jcs.lab_to_rgb_unit_planes(L, a, b, impl="pallas")
    return jcs.lab_to_rgb_unit_gamma_planes(L, a, b, gamma, impl="pallas")


@pytest.mark.parametrize("gamma", [None, 1.2, 1.4, 1.5])
def test_clahe_enhancement_planes_matches_jax(img_unit, gamma):
    """The whole leg (K1 -> CLAHE -> K3 or K3g) against the JAX function
    and against the chain of its Pallas kernels: unit values within 1 ulp
    (jitted JAX compiles u8/255 to a reciprocal multiply, the port
    divides), gamma'd values within 2 ulp (torch.pow vs XLA pow in the
    256-entry LUT)."""
    planes = [np.ascontiguousarray(img_unit[..., c]) for c in range(3)]
    jp = tuple(jnp.asarray(p) for p in planes)
    got = thisteq.clahe_enhancement_planes(
        tuple(torch.from_numpy(p) for p in planes), 3.0, gamma=gamma)
    tol = 1 if gamma is None else 2
    for want in (jhisteq.clahe_enhancement_planes(jp, 3.0, gamma=gamma),
                 _jax_leg_pallas(jp, 3.0, gamma)):
        for g, w in zip(got, want):
            assert _ulps(g.numpy(), np.asarray(w)) <= tol
