"""The u8 inverse LAB (kernel K3b, ``kernels.lab_inverse_u8``) and the u8
colour entry points built on it and on K1b: against the JAX Pallas kernel
``lab_inverse_planes`` in interpret mode, the JAX package's numpy oracle
and its HWC and leading-dimension forms, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.ops import colorspace as jcs
from underwater_image_enhancement_tpu.ops import lab_tables as jlt
from underwater_image_enhancement_tpu.ops import pallas_kernels as pk
from underwater_image_enhancement_tpu_torch.ops import colorspace as tcs
from underwater_image_enhancement_tpu_torch.ops import kernels

from tests.test_torch_colorspace import _lab_triples

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_inverse():
    out = {}
    for seed in (0, 1):
        p = _lab_triples(seed)
        out[seed] = (p, [np.asarray(x) for x in pk.lab_inverse_planes(
            *(jnp.asarray(x) for x in p))])
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_lab_inverse_u8_bit_equal_to_pallas_and_numpy(jax_inverse, seed):
    p, want = jax_inverse[seed]
    before = dict(kernels.launches)
    got = kernels.lab_inverse_u8(*(torch.from_numpy(x) for x in p))
    assert kernels.launches == before  # CPU tensors: the plain version
    oracle = jlt.lab_to_rgb_u8_exact_np(np.stack(p, -1).astype(np.uint8))
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), oracle[..., c])


@pytest.mark.parametrize("seed", [0, 1])
def test_lab_to_rgb_u8_exact_hwc_equals_jax(jax_inverse, seed):
    p, _ = jax_inverse[seed]
    lab = np.stack(p, -1)
    want = np.asarray(jcs.lab_to_rgb_u8_exact(jnp.asarray(lab)))
    got = tcs.lab_to_rgb_u8_exact(torch.from_numpy(lab))
    assert got.dtype == torch.int32 and got.shape == lab.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_rgb_to_lab_u8_exact_hwc_equals_jax(seed):
    rgb = np.random.default_rng(seed).integers(0, 256, (48, 72, 3),
                                               dtype=np.int32)
    want = np.asarray(jcs.rgb_to_lab_u8_exact(jnp.asarray(rgb)))
    got = tcs.rgb_to_lab_u8_exact(torch.from_numpy(rgb))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  jlt.rgb_to_lab_u8_exact_np(rgb.astype(np.uint8)))


def test_leading_dimensions_fold_into_rows(jax_inverse):
    """(2, H, W) planes, as the JAX Pallas path folds them into rows."""
    p = np.stack([jax_inverse[0][0], jax_inverse[1][0]], 1)  # (3, 2, H, W)
    want = jcs.lab_to_rgb_u8_exact_planes(*(jnp.asarray(x) for x in p),
                                          impl="pallas")
    got = tcs.lab_to_rgb_u8_exact_planes(*(torch.from_numpy(x) for x in p))
    for g, w in zip(got, want):
        assert g.shape == p.shape[1:]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    fwd_want = jcs.rgb_to_lab_u8_exact_planes(*(jnp.asarray(x) for x in p),
                                              impl="pallas")
    fwd = tcs.rgb_to_lab_u8_exact_planes(*(torch.from_numpy(x) for x in p))
    for g, w in zip(fwd, fwd_want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_u8_roundtrip_of_a_frame():
    """RGB -> LAB -> RGB on the u8 grid through K1b and K3b equals the JAX
    package's numpy oracles composed."""
    from tests.torch_frames import underwater_img

    rgb = np.rint(underwater_img() * 255).astype(np.int32)
    lab = tcs.rgb_to_lab_u8_exact(torch.from_numpy(rgb))
    back = tcs.lab_to_rgb_u8_exact(lab)
    want = jlt.lab_to_rgb_u8_exact_np(
        jlt.rgb_to_lab_u8_exact_np(rgb.astype(np.uint8)))
    np.testing.assert_array_equal(back.numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "rank"])
def test_lab_inverse_u8_checks_its_planes(bad):
    p = [torch.zeros((8, 8), dtype=torch.int32) for _ in range(3)]
    if bad == "dtype":
        p[0] = p[0].float()
    elif bad == "shape":
        p[1] = torch.zeros((8, 9), dtype=torch.int32)
    else:
        p = [x[None] for x in p]
    with pytest.raises((TypeError, ValueError)):
        kernels.lab_inverse_u8(*p)
