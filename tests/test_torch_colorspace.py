"""The LAB kernels' plain versions (the CPU side of kernels K1, K3, K3g)
against the JAX Pallas kernels in interpret mode, and against cv2."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.ops import colorspace as jcs
from underwater_image_enhancement_tpu_torch.ops import colorspace as tcs
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops import lab_tables as tlt
from underwater_image_enhancement_tpu_torch.ops import stretch as tstretch

torch.set_num_threads(2)

SHAPE = (64, 96)


def _unit_planes(seed):
    """Random f32 planes in [-0.1, 1.1]: off-grid and out-of-range values,
    with exact u8-grid values and the clip edges pinned in row 0."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.1, 1.1, (3,) + SHAPE).astype(np.float32)
    pins = np.array([0.0, 1.0, -0.1, 1.1, 1 / 255, 254 / 255, 0.5, 20 / 255],
                    np.float32)
    p[:, 0, :len(pins)] = pins
    grid = np.arange(256, dtype=np.float32) / np.float32(255)
    p[:, 1:4, :] = np.resize(grid, 3 * SHAPE[1]).reshape(3, SHAPE[1])
    return p


def _lab_triples(seed):
    """Random (L, a, b) u8 triples plus corners that reach the MIN_AB clamp
    (large a with small L) and both abToXZ branches."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (3,) + SHAPE).astype(np.int32)
    corners = [(L, a, b) for L in (0, 1, 20, 21, 128, 255)
               for a in (0, 255) for b in (0, 255)]
    for k, (L, a, b) in enumerate(corners):
        p[:, 0, k] = (L, a, b)
    return p


@pytest.fixture(scope="module")
def jax_forward():
    out = {}
    for seed in (0, 1):
        p = _unit_planes(seed)
        got = jcs.rgb_unit_to_lab_planes(*(jnp.asarray(x) for x in p),
                                         impl="pallas")
        out[seed] = (p, [np.asarray(x) for x in got])
    return out


@pytest.fixture(scope="module")
def jax_inverse():
    out = {}
    for seed in (0, 1):
        p = _lab_triples(seed)
        jp = [jnp.asarray(x) for x in p]
        out[seed] = {
            "planes": p,
            "u8": [np.asarray(x) for x in
                   jcs.lab_to_rgb_u8_exact_planes(*jp, impl="pallas")],
            "unit": [np.asarray(x) for x in
                     jcs.lab_to_rgb_unit_planes(*jp, impl="pallas")],
            "gamma": {g: [np.asarray(x) for x in jcs.lab_to_rgb_unit_gamma_planes(
                *jp, g, impl="pallas")] for g in (1.2, 1.4, 1.5)},
        }
    return out


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_lab_forward_bit_equal_to_pallas(jax_forward, seed):
    p, want = jax_forward[seed]
    got = kernels.lab_forward_unit_plain(*(torch.from_numpy(x) for x in p))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", [0, 1])
def test_lab_forward_wrapper_on_cpu_runs_plain(jax_forward, seed):
    """The wrapper sends CPU tensors to the plain version: same planes, no
    kernel launch counted."""
    p, want = jax_forward[seed]
    before = dict(kernels.launches)
    got = tcs.rgb_unit_to_lab_planes(*(torch.from_numpy(x) for x in p))
    assert kernels.launches == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", [0, 1])
def test_lab_triples_reach_the_clamp_and_both_branches(seed):
    """The inverse's inputs cover abToXZ's linear and cubic branches for x
    (from a) and z (from b), and its MIN_AB clamp, which u8 inputs reach
    only in z, at L = 0 and b = 255 (x stays above -1934)."""
    L, a, b = (x.astype(np.int64) for x in _lab_triples(seed))
    ify = tlt.L2YF_TAB[L, 1]
    x = ify + ((5 * a * 53687 + (1 << 7)) >> 13) - tlt.ADIV_OFFSET
    z = ify - (((b * 41943 + (1 << 4)) >> 9) - tlt.BDIV_OFFSET)
    assert z.min() == tlt.MIN_AB
    for v in (x, z):
        assert ((v > tlt.MIN_AB) & (v <= tlt.AB_LIN_THRESH)).any()
        assert (v > tlt.AB_LIN_THRESH).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_lab_inverse_u8_bit_equal_to_pallas(jax_inverse, seed):
    ref = jax_inverse[seed]
    got = kernels.lab_inverse_u8_plain(
        *(torch.from_numpy(x) for x in ref["planes"]))
    for g, w in zip(got, ref["u8"]):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", [0, 1])
def test_lab_inverse_unit_vs_pallas(jax_inverse, seed):
    """Unit output: IEEE v/255 of the same u8 values.  Observed within
    1 ulp, not bit-equal: the jitted Pallas kernel's division by 255 is
    compiled to a reciprocal multiply (1 ulp off on 126 of the 256 u8
    values), while the port divides; the u8 values are equal."""
    ref = jax_inverse[seed]
    got = tcs.lab_to_rgb_unit_planes(
        *(torch.from_numpy(x) for x in ref["planes"]))
    for g, w, u8 in zip(got, ref["unit"], ref["u8"]):
        assert g.dtype == torch.float32
        assert _ulps(g.numpy(), w) <= 1
        np.testing.assert_array_equal(g.numpy(), tstretch.U8_GRID[u8])


@pytest.mark.parametrize("g", [1.2, 1.4, 1.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_lab_inverse_gamma_within_2_ulp(jax_inverse, seed, g):
    """torch.pow and XLA's pow may differ in the last ulp of the LUT."""
    ref = jax_inverse[seed]
    got = tcs.lab_to_rgb_unit_gamma_planes(
        *(torch.from_numpy(x) for x in ref["planes"]), g)
    for a, w in zip(got, ref["gamma"][g]):
        assert _ulps(a.numpy(), w) <= 2


def test_lab_matches_cv2_both_ways():
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, SHAPE + (3,)).astype(np.uint8)
    planes = [torch.from_numpy(rgb[..., c].astype(np.int32)) for c in range(3)]
    lab = kernels.lab_forward_u8_plain(*planes)
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB)
    np.testing.assert_array_equal(np.stack([x.numpy() for x in lab], -1), want)
    back = kernels.lab_inverse_u8_plain(*(torch.from_numpy(
        want[..., c].astype(np.int32)) for c in range(3)))
    np.testing.assert_array_equal(np.stack([x.numpy() for x in back], -1),
                                  cv2.cvtColor(want, cv2.COLOR_LAB2RGB))


def test_gray_and_quantize_match_jax():
    p = _unit_planes(3)
    q_t = [tcs.quantize_u8(torch.from_numpy(x)) for x in p]
    q_j = [np.asarray(jcs.quantize_u8(jnp.asarray(x))) for x in p]
    for a, b in zip(q_t, q_j):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(
        tcs.gray_u8_planes(*q_t).numpy(),
        np.asarray(jcs.gray_u8_planes(*(jnp.asarray(x) for x in q_j))))
    k = torch.arange(256, dtype=torch.int32)
    np.testing.assert_array_equal(tcs.u8_to_unit(k).numpy(), tstretch.U8_GRID)


@pytest.mark.parametrize("bad", ["dtype", "shape", "stride", "device"])
def test_wrappers_check_inputs(bad):
    p = [torch.zeros(SHAPE, dtype=torch.float32) for _ in range(3)]
    if bad == "dtype":
        p[1] = p[1].double()
    elif bad == "shape":
        p[2] = torch.zeros((SHAPE[0], SHAPE[1] + 1))
    elif bad == "stride":
        p[0] = torch.zeros(SHAPE[::-1]).t()
    else:
        p = [x.to("meta") for x in p]
    with pytest.raises((TypeError, ValueError)):
        kernels.lab_forward_unit(*p)
    q = [x.to(torch.int32) if x.dtype == torch.float32 else x for x in p]
    with pytest.raises((TypeError, ValueError)):
        kernels.lab_inverse_unit(*q)


@pytest.mark.parametrize("g", [1.2, 1.4, 1.5])
def test_gamma_wrapper_checks_planes_and_builds_its_lut(g):
    """The gamma wrapper checks its planes like the others, and its LUT is
    torch.pow of the u8 grid on the planes' device."""
    q = [torch.zeros(SHAPE, dtype=torch.int32) for _ in range(3)]
    with pytest.raises(TypeError):
        kernels.lab_inverse_unit_gamma(q[0].long(), q[1], q[2], g)
    with pytest.raises(ValueError):
        kernels.lab_inverse_unit_gamma(q[0][:, :-1], q[1], q[2], g)
    lut = kernels.gamma_lut(g, torch.device("cpu"))
    assert lut.dtype == torch.float32 and lut.shape == (256,)
    assert torch.equal(lut, torch.from_numpy(tstretch.U8_GRID) ** g)
