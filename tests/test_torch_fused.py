"""The fused CLAHE apply + inverse LAB (kernel K5, ``kernels.clahe_lab_apply``)
and ``histeq.clahe_enhancement_planes(impl=...)``: the fused roundtrip
against the JAX package's ``impl="fused"`` (the Pallas ``clahe_lab_apply``
in interpret mode), called eagerly, bit for bit, and against the port's
split path.

Eagerly, because JAX's eager ``u8_to_unit`` divides by 255 (IEEE), as the
port does; under ``jax.jit`` XLA:CPU multiplies by the reciprocal instead,
1 ulp off on 126 of the 256 values.  With ``gamma`` JAX composes
``gamma_correction_pow``, the port gathers the same powers from its LUT:
within 2.4e-7 (the JAX package's own bound for the two,
tests/test_pallas.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.ops import histeq as jhisteq
from underwater_image_enhancement_tpu_torch.ops import histeq as thisteq
from underwater_image_enhancement_tpu_torch.ops import kernels

from tests import torch_frames

torch.set_num_threads(2)

SHAPES = [(90, 121), (120, 160)]
CLIPS = [2.0, 3.0]


def _planes(shape):
    """The fixture frame cropped to ``shape`` (90x121: tiles of uneven
    size and a half-tile offset in both axes)."""
    img = torch_frames.underwater_img()[:shape[0], :shape[1]]
    return tuple(np.ascontiguousarray(img[..., c]) for c in range(3))


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


@pytest.fixture(scope="module")
def jax_fused():
    out = {}
    for shape in SHAPES:
        jp = tuple(jnp.asarray(p) for p in _planes(shape))
        for clip in CLIPS:
            out[shape, clip, None] = [np.asarray(x) for x in
                                      jhisteq.clahe_enhancement_planes(
                                          jp, clip, impl="fused")]
        out[shape, 3.0, 1.4] = [np.asarray(x) for x in
                                jhisteq.clahe_enhancement_planes(
                                    jp, 3.0, impl="fused", gamma=1.4)]
    return out


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_bit_equal_to_jax_fused(jax_fused, shape, clip):
    planes = tuple(torch.from_numpy(p) for p in _planes(shape))
    before = dict(kernels.launches)
    got = thisteq.clahe_enhancement_planes(planes, clip, impl="fused")
    assert kernels.launches == before  # CPU tensors: the plain versions
    for g, w in zip(got, jax_fused[shape, clip, None]):
        assert g.dtype == torch.float32 and g.shape == shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("gamma", [None, 1.5, 1.2])
@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_bit_equal_to_split(shape, clip, gamma):
    planes = tuple(torch.from_numpy(p) for p in _planes(shape))
    fused = thisteq.clahe_enhancement_planes(planes, clip, gamma=gamma,
                                             impl="fused")
    split = thisteq.clahe_enhancement_planes(planes, clip, gamma=gamma,
                                             impl="split")
    auto = thisteq.clahe_enhancement_planes(planes, clip, gamma=gamma)
    for f, s, a in zip(fused, split, auto):
        assert torch.equal(f, s) and torch.equal(s, a)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_gamma_within_2p4e7_of_jax(jax_fused, shape):
    planes = tuple(torch.from_numpy(p) for p in _planes(shape))
    got = thisteq.clahe_enhancement_planes(planes, 3.0, impl="fused",
                                           gamma=1.4)
    for g, w in zip(got, jax_fused[shape, 3.0, 1.4]):
        assert float(np.abs(g.numpy() - w).max()) <= 2.4e-7


@pytest.mark.parametrize("lab_fast", [False, True])
def test_fused_kernel_plain_equals_apply_then_inverse(lab_fast):
    """K5's plain version is K2's followed by K3b's, on the planes the
    pipeline gives it (exact or approximate forward LAB)."""
    planes = tuple(torch.from_numpy(p) for p in _planes(SHAPES[0]))
    fwd = (kernels.lab_forward_unit_approx if lab_fast
           else kernels.lab_forward_unit)
    L, a, b = fwd(*planes)
    luts, ya, xa, geo = thisteq.clahe_prep(L, 2.0, 8, 8)
    got = kernels.clahe_lab_apply(L, a, b, luts, ya, xa, *geo)
    want = kernels.lab_inverse_u8(kernels.clahe_apply(L, luts, ya, xa, *geo),
                                  a, b)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)


def test_fused_lab_fast_equals_split_lab_fast():
    planes = tuple(torch.from_numpy(p) for p in _planes(SHAPES[1]))
    for f, s in zip(
            thisteq.clahe_enhancement_planes(planes, 3.0, lab_fast=True,
                                             impl="fused"),
            thisteq.clahe_enhancement_planes(planes, 3.0, lab_fast=True)):
        assert torch.equal(f, s)


def test_clahe_enhancement_hwc_matches_jax():
    """The HWC form (JAX jits it: its /255 is 1 ulp off IEEE on some
    values; the u8 values are equal)."""
    img = torch_frames.underwater_img()
    want = np.asarray(jhisteq.clahe_enhancement(jnp.asarray(img), 2.0))
    got = thisteq.clahe_enhancement(torch.from_numpy(img), 2.0)
    assert got.shape == img.shape
    assert _ulps(got.numpy(), want) <= 1
    np.testing.assert_array_equal(np.rint(got.numpy() * 255),
                                  np.rint(want * 255))


def test_unknown_impl_raises():
    planes = tuple(torch.from_numpy(p) for p in _planes(SHAPES[0]))
    with pytest.raises(ValueError):
        thisteq.clahe_enhancement_planes(planes, 2.0, impl="xla")


@pytest.mark.parametrize("bad", ["ab_shape", "ab_dtype", "tiles"])
def test_fused_kernel_checks_its_inputs(bad):
    L = torch.zeros((16, 24), dtype=torch.int32)
    a, b = L.clone(), L.clone()
    luts, ya, xa, geo = thisteq.clahe_prep(L, 2.0, 8, 8)
    if bad == "ab_shape":
        a = torch.zeros((16, 25), dtype=torch.int32)
    elif bad == "ab_dtype":
        b = b.float()
    else:
        geo = geo._replace(tiles_x=4)
    with pytest.raises((TypeError, ValueError)):
        kernels.clahe_lab_apply(L, a, b, luts, ya, xa, *geo)
