"""The five config-flavour strategies (pipeline/strategies.py) and the
ops only they use, against the JAX package on the CPU: the
enhancement_strategies transmission flavours, the inverse gamma, and each
strategy in both tiers against ``STRATEGY_FNS_PLANES`` and
``STRATEGY_FNS_FAST_PLANES``.

Tolerances (the ``six`` ones): 1e-6 for CLAHE and histogram
equalization, >= 50 dB for the dehaze strategies, whose transmission
passes through f32 reductions and a guided filter before the percentile
stretch.  JAX on the CPU converts the fast tier's CLAHE leg exactly where
the TPU program, and the port, use K8 ``_approx``: that strategy is held
within 1e-6 of the TPU program's leg built here, and to JAX's CPU output
at the JAX suite's 25 dB fast-tier gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu.ops import colorspace as jcs
from underwater_image_enhancement_tpu.ops import dehaze as jdehaze
from underwater_image_enhancement_tpu.ops import histeq as jhisteq
from underwater_image_enhancement_tpu.ops import pallas_kernels as pk
from underwater_image_enhancement_tpu.ops import stretch as jstretch
from underwater_image_enhancement_tpu.pipeline.strategies import (
    STRATEGY_DISPLAY as J_DISPLAY,
    STRATEGY_FNS,
    STRATEGY_FNS_FAST_PLANES,
    STRATEGY_FNS_PLANES,
)
from underwater_image_enhancement_tpu_torch.ops import dehaze as tdehaze
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops import stretch as tstretch
from underwater_image_enhancement_tpu_torch.pipeline import strategies as ts

torch.set_num_threads(2)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


def _seeded_frame():
    rng = np.random.default_rng(2024)
    h, w = 120, 160  # the fixture's shape: JAX compiles each tier once
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([0.1 + 0.2 * (xx / w), 0.6 + 0.15 * np.sin(yy / 11.0),
                     0.4 + 0.2 * np.cos((xx - yy) / 23.0)], -1)
    img = np.clip(base + rng.normal(0, 0.04, (h, w, 3)), 0, 1)
    return (np.floor(img.astype(np.float32) * 255) / 255).astype(np.float32)


FRAMES = {"underwater": torch_frames.underwater_img, "seeded": _seeded_frame}


@pytest.fixture(scope="module")
def jax_outputs():
    out = {}
    for fname, make in FRAMES.items():
        img = make()
        for fast, fns in ((False, STRATEGY_FNS_PLANES),
                          (True, STRATEGY_FNS_FAST_PLANES)):
            out[fname, fast] = (img, {k: [np.asarray(p) for p in fn(
                jnp.asarray(img))] for k, fn in fns.items()})
    return out


def test_label_order_and_names_equal_jax():
    assert ts.LABEL_ORDER == tuple(STRATEGY_FNS)
    assert ts.STRATEGY_DISPLAY == J_DISPLAY


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ts.LABEL_ORDER)
@pytest.mark.parametrize("frame", list(FRAMES))
def test_strategy_matches_jax(jax_outputs, frame, name, fast):
    img, want = jax_outputs[frame, fast]
    kernels.reset_launches()
    got = ts.run_strategy(name, torch.from_numpy(img), fast)
    assert sum(kernels.launches.values()) == 0
    got = np.stack([p.numpy() for p in got], -1)
    ref = np.stack(want[name], -1)
    assert got.shape == img.shape and got.dtype == np.float32
    d = float(np.abs(got.astype(np.float64) - ref).max())
    if name in ts.DEHAZE:
        assert _psnr(got, ref) >= 50.0, (d, _psnr(got, ref))
    elif fast and name == "clahe_enhancement":
        assert _psnr(got, ref) >= 25.0, _psnr(got, ref)
    else:
        assert d <= 1e-6, d


@pytest.mark.parametrize("frame", list(FRAMES))
def test_fast_clahe_strategy_equals_the_tpu_program(frame):
    """K8 _approx (interpret), clahe_u8, the inverse, then the hist-fast
    stretch 20-85: the fast CLAHE strategy as the TPU program runs it."""
    img = FRAMES[frame]()
    planes = [jnp.asarray(np.ascontiguousarray(img[..., c])) for c in range(3)]
    L, a, b = pk.lab_forward_planes_unit_approx(*planes)
    L = jhisteq.clahe_u8(L, 2.0, impl="pallas")
    c = jcs.lab_to_rgb_unit_planes(L, a, b, impl="pallas")
    want = jstretch.color_enhancement_planes(c, 20.0, 85.0, method="hist-fast")
    got = ts.run_strategy("clahe_enhancement", torch.from_numpy(img), True)
    for g, w in zip(got, want):
        assert float(np.abs(g.numpy().astype(np.float64)
                            - np.asarray(w)).max()) <= 1e-6


@pytest.mark.parametrize("fast", [False, True])
def test_shared_airlight_equals_each_strategy_alone(fast):
    """strategy_planes shares one airlight (and the fast tier's refined
    dark channel) across the dehaze strategies: the same outputs."""
    img = torch.from_numpy(_seeded_frame())
    shared = ts.strategy_planes(img, fast)
    for name, outs in zip(ts.LABEL_ORDER, shared):
        alone = ts.run_strategy(name, img, fast)
        for a, b in zip(outs, alone):
            assert torch.equal(a, b), name


def _planes_and_A(seed):
    rng = np.random.default_rng(seed)
    planes = [rng.uniform(0, 1, (61, 83)).astype(np.float32) for _ in range(3)]
    A = rng.uniform(0.5, 1.0, 3).astype(np.float32)
    return planes, A


@pytest.mark.parametrize("omega,r", [(0.5, 15), (0.6, 20), (0.4, 10)])
def test_estimate_transmission_planes_match_jax(omega, r):
    planes, A = _planes_and_A(1)
    want = np.asarray(jax.jit(
        lambda p, a: jdehaze.estimate_transmission_planes(p, a, omega, r,
                                                          0.001))(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(A)))
    got = tdehaze.estimate_transmission_planes(
        tuple(torch.from_numpy(p) for p in planes), torch.from_numpy(A),
        omega, r, 0.001).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("omega", [0.5, 0.6, 0.4])
def test_estimate_transmission_shared_matches_jax(omega):
    planes, A = _planes_and_A(2)
    want = np.asarray(jax.jit(
        lambda p, a: jdehaze.estimate_transmission_planes_shared(
            p, a, omega, 15, 0.001, guided_subsample=4))(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(A)))
    got = tdehaze.estimate_transmission_planes_shared(
        tuple(torch.from_numpy(p) for p in planes), torch.from_numpy(A),
        omega, 15, 0.001, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gamma", [1.2, 1.5, 0.8])
def test_gamma_correction_inv_matches_jax(gamma):
    x = np.random.default_rng(3).uniform(-0.2, 1.2, (61, 83)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jstretch.gamma_correction_inv(
        v, gamma))(jnp.asarray(x)))
    got = tstretch.gamma_correction_inv(torch.from_numpy(x), gamma).numpy()
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)


def test_radix_is_the_exact_percentile():
    planes, _ = _planes_and_A(4)
    tp = tuple(torch.from_numpy(p) for p in planes)
    for a, b in zip(tstretch.color_enhancement_planes(tp, 15.0, 95.0,
                                                      method="radix"),
                    tstretch.color_enhancement_planes(tp, 15.0, 95.0,
                                                      method="sort")):
        assert torch.equal(a, b)
    want = np.asarray(jstretch.percentiles_radix(jnp.asarray(planes[0]),
                                                 (50.0, 25.0, 75.0)))
    got = tstretch.percentiles(tp[0], (50.0, 25.0, 75.0)).numpy()
    np.testing.assert_array_equal(got, want)
