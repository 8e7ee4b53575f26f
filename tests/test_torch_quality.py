"""The port's quality metrics (metrics/quality.py) and the ops under them,
against the JAX package on the CPU: Sobel and Laplacian (reflect-101),
the 256-bin histogram, the entropy, equalizeHist (also against cv2), the
8 metrics and the weighted totals under both weight sets and both tiers.

Tolerances: integer paths bit-equal; the float stencils bit-equal (the
same taps summed in the same order); metric scores within 1e-3 (their
means and standard deviations are reductions in another summation order
than XLA:CPU's)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu.metrics import quality as jq
from underwater_image_enhancement_tpu.ops import edges as jedges
from underwater_image_enhancement_tpu.ops import histeq as jhisteq
from underwater_image_enhancement_tpu.pipeline.strategies import (
    STRATEGY_FNS_PLANES,
)
from underwater_image_enhancement_tpu.utils import config as jconfig
from underwater_image_enhancement_tpu_torch.metrics import quality as tq
from underwater_image_enhancement_tpu_torch.ops import edges as tedges
from underwater_image_enhancement_tpu_torch.ops import histeq as thisteq
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.utils import config as tconfig

torch.set_num_threads(2)


def _images():
    """Planes of: the underwater fixture, a random frame, the fixture's
    CLAHE strategy output (JAX), a flat frame and a bright one."""
    uw = torch_frames.underwater_img()
    clahe = np.stack([np.asarray(p) for p in STRATEGY_FNS_PLANES[
        "clahe_enhancement"](jnp.asarray(uw))], -1)
    imgs = {"underwater": uw, "random": torch_frames.img_unit(),
            "clahe_out": clahe,
            "flat": np.full((48, 64, 3), 0.5, np.float32),
            "bright": np.clip(uw + 0.5, 0, 1).astype(np.float32)}
    return {k: tuple(np.ascontiguousarray(v[..., c]) for c in range(3))
            for k, v in imgs.items()}


@pytest.fixture(scope="module")
def jax_scores():
    """JAX's 8 scores and totals of each image, exact and fast tier, run
    eagerly: jitted, XLA:CPU's fused std of the flat frame's gray comes out
    5e-6 (a 1e-3 contrast score) where the exact value, eager JAX's and
    the port's, is 0."""
    out = {}
    for name, planes in _images().items():
        jp = tuple(jnp.asarray(p) for p in planes)
        for fast in (False, True):
            s = jq.assess_all_planes(jp, fast=fast)
            totals = {
                wn: float(jq.comprehensive_batch_planes(
                    tuple(p[None] for p in jp), w, fast=fast)[0])
                for wn, w in (("config", jconfig.DEFAULT_QUALITY_WEIGHTS),
                              ("full", jconfig.FULL_QUALITY_WEIGHTS))}
            out[name, fast] = (planes, {k: float(v) for k, v in s.items()},
                               totals)
    return out


IMAGES = ["underwater", "random", "clahe_out", "flat", "bright"]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", IMAGES)
def test_metric_scores_match_jax(jax_scores, name, fast):
    planes, want, _ = jax_scores[name, fast]
    kernels.reset_launches()
    got = tq.assess_all_planes(tuple(torch.from_numpy(p) for p in planes),
                               fast=fast)
    assert sum(kernels.launches.values()) == 0
    assert set(got) == set(tq.METRIC_NAMES)
    diffs = {k: abs(float(got[k]) - want[k]) for k in tq.METRIC_NAMES}
    assert max(diffs.values()) <= 1e-3, diffs


@pytest.mark.parametrize("weights", ["config", "full"])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", IMAGES)
def test_weighted_totals_match_jax(jax_scores, name, fast, weights):
    planes, _, totals = jax_scores[name, fast]
    w = {"config": tconfig.DEFAULT_QUALITY_WEIGHTS,
         "full": tconfig.FULL_QUALITY_WEIGHTS}[weights]
    tp = tuple(torch.from_numpy(p) for p in planes)
    got = tq.comprehensive_planes(tp, w, fast)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - totals[weights]) <= 1e-3
    batch = tq.comprehensive_batch_planes(tuple(p[None] for p in tp), w, fast)
    assert torch.equal(batch, got[None])
    nhwc = tq.comprehensive_batch(torch.stack(tp, -1)[None], w, fast)
    assert torch.equal(nhwc, got[None])


def test_comprehensive_assessment_weights_missing_keys_as_zero(jax_scores):
    """get(key, 0): the 6-weight dict leaves colorfulness and naturalness
    out of the total; None means the 8-metric defaults."""
    planes, want, totals = jax_scores["underwater", False]
    img = torch.from_numpy(np.stack(planes, -1))
    total, scores = tq.comprehensive_assessment(img)
    assert abs(float(total) - totals["full"]) <= 1e-3
    assert set(scores) == set(tq.METRIC_NAMES)
    total6, _ = tq.comprehensive_assessment(img,
                                            tconfig.DEFAULT_QUALITY_WEIGHTS)
    assert abs(float(total6) - totals["config"]) <= 1e-3
    j_total, _ = jq.comprehensive_assessment(jnp.asarray(np.stack(planes, -1)))
    assert abs(float(total) - float(j_total)) <= 1e-3


def _gray_unit(seed, shape=(37, 53)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape) / np.float32(255)).astype(np.float32)


@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("mode", ["reflect", "edge"])
@pytest.mark.parametrize("shape", [(37, 53), (2, 5), (1, 4)])
def test_sobel_bit_equal(axis, mode, shape):
    x = _gray_unit(1, shape)
    want = np.asarray(jedges.sobel(jnp.asarray(x), axis, mode))
    got = tedges.sobel(torch.from_numpy(x), axis, mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ksize", [1, 3])
@pytest.mark.parametrize("scale", [1.0, 255.0])
def test_laplacian_bit_equal_and_cv2(ksize, scale):
    x = (_gray_unit(2) * np.float32(scale)).astype(np.float32)
    want = np.asarray(jedges.laplacian(jnp.asarray(x), ksize))
    got = tedges.laplacian(torch.from_numpy(x), ksize).numpy()
    np.testing.assert_array_equal(got, want)
    cv = cv2.Laplacian(x, cv2.CV_32F, ksize=ksize)
    np.testing.assert_allclose(got, cv, rtol=1e-6, atol=1e-5 * scale)


def test_conv3x3_modes_differ_only_on_the_border():
    x = torch.from_numpy(_gray_unit(3))
    k = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    a, b = tedges.conv3x3(x, k, "reflect"), tedges.conv3x3(x, k, "edge")
    assert torch.equal(a[1:-1, 1:-1], b[1:-1, 1:-1])
    assert not torch.equal(a, b)
    with pytest.raises(ValueError):
        tedges.conv3x3(x, k, "wrap")


def test_histogram256_exact():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 256, (5, 3001)).astype(np.int32)
    got = thisteq.histogram256(torch.from_numpy(rows)).numpy()
    want = np.stack([np.bincount(r, minlength=256) for r in rows])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jhisteq.histogram256(jnp.asarray(rows))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entropy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    hi = (256, 17, 2)[seed]
    x = rng.integers(0, hi, (61, 83)).astype(np.int32)
    want = float(jax.jit(jhisteq.shannon_entropy_u8)(jnp.asarray(x)))
    got = float(thisteq.shannon_entropy_u8(torch.from_numpy(x)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("case", ["random", "narrow", "two_level", "flat"])
def test_equalize_hist_bit_equal_to_jax_and_cv2(case):
    rng = np.random.default_rng(5)
    x = {"random": rng.integers(0, 256, (61, 83)),
         "narrow": rng.integers(90, 120, (61, 83)),
         "two_level": rng.choice([3, 250], (61, 83)),
         "flat": np.full((61, 83), 77)}[case].astype(np.int32)
    got = thisteq.equalize_hist_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jhisteq.equalize_hist_u8(jnp.asarray(x))))
    np.testing.assert_array_equal(got, cv2.equalizeHist(x.astype(np.uint8)))


def test_histogram_equalization_planes_match_jax():
    planes = [np.ascontiguousarray(p) for p in
              np.moveaxis(torch_frames.underwater_img(), -1, 0)]
    want = jhisteq.histogram_equalization_planes(
        tuple(jnp.asarray(p) for p in planes))
    got = thisteq.histogram_equalization_planes(
        tuple(torch.from_numpy(p) for p in planes))
    for g, w in zip(got, want):
        # jitted XLA's /255 is a reciprocal multiply: 1 ulp at most
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1.2e-7,
                                   atol=0)
