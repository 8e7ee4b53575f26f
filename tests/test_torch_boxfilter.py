"""The port's box filter on planes that the window's pad reaches past,
against the JAX package's ``ops/boxfilter.box_filter`` and
``cv2.boxFilter``, and the paths that reach it on small frames
(``six_strategy_tuple`` in both tiers, the three dehazing or light
strategies) against JAX.

REFLECT_101 repeats where the pad is not smaller than the side: an index
folds onto [0, n-1] with period 2(n-1).  The window sums are the JAX
package's term for term, so the port is bit-equal to JAX; cv2 sums in
another order (within 1.2e-7 here).  The six and strategy gates are the
ones of ``tests/test_torch_six.py``, ``tests/test_torch_fast.py`` (the fast
tier's CLAHE recipes at 25 dB: JAX on the CPU converts LAB exactly where
the TPU program and the port use K8 ``_approx``) and
``tests/test_torch_strategies.py``.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.ops import boxfilter as jbox
from underwater_image_enhancement_tpu.pipeline.enhance import (
    six_strategy_tuple as jax_six,
)
from underwater_image_enhancement_tpu.pipeline.strategies import (
    STRATEGY_FNS_FAST_PLANES,
    STRATEGY_FNS_PLANES,
)
from underwater_image_enhancement_tpu_torch.ops import boxfilter as tbox
from underwater_image_enhancement_tpu_torch.pipeline import strategies as ts
from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
    SIX_ORDER,
    six_strategy_tuple,
)

torch.set_num_threads(2)

CASES = [((8, 8), 20), ((10, 10), 21), ((3, 200), 15), ((12, 40), 41),
         ((16, 16), 3), ((64, 64), 15)]
SMALL = {"8x8": (8, 8), "3x200": (3, 200)}
STRATEGIES = ("strong_dehazing", "medium_dehazing", "light_enhancement")


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


def _plane(shape):
    return np.random.default_rng(1).random(shape).astype(np.float32)


def _frame(shape):
    """An (H, W, 3) frame on the u8 grid, from its own generator."""
    x = np.random.default_rng(1).random(shape + (3,))
    return (np.floor(x * 255) / 255).astype(np.float32)


@pytest.mark.parametrize("shape,r", CASES)
def test_box_filter_equals_jax_and_cv2(shape, r):
    x = _plane(shape)
    got = tbox.box_filter(torch.from_numpy(x), r).numpy()
    want = np.asarray(jbox.box_filter(jnp.asarray(x), r))
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    ref = cv2.boxFilter(x, -1, (r, r), normalize=True,
                        borderType=cv2.BORDER_REFLECT_101)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_reflect_indices_fold_with_period(n):
    """The gather's indices against numpy's repeated reflection."""
    lo, hi = 3 * n + 2, 2 * n + 5
    idx = tbox._reflect_101(n, lo, hi, torch.device("cpu")).numpy()
    want = np.pad(np.arange(n), (lo, hi), mode="reflect") if n > 1 else \
        np.zeros(n + lo + hi, np.int64)
    np.testing.assert_array_equal(idx, want)


@pytest.fixture(scope="module")
def jax_small():
    out = {}
    for key, shape in SMALL.items():
        img = _frame(shape)
        for fast in (False, True):
            outs, code = jax_six(jnp.asarray(img), fast=fast)
            fns = STRATEGY_FNS_FAST_PLANES if fast else STRATEGY_FNS_PLANES
            strat = {k: np.stack([np.asarray(p) for p in
                                  fns[k](jnp.asarray(img))], -1)
                     for k in STRATEGIES}
            out[key, fast] = (img, [np.asarray(o) for o in outs], int(code),
                              strat)
    return out


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("key", list(SMALL))
def test_six_on_small_frames_matches_jax(jax_small, key, fast):
    img, want, want_code, _ = jax_small[key, fast]
    outs, code = six_strategy_tuple(img, fast=fast, device="cpu")
    assert int(code) == want_code
    for k, name in enumerate(SIX_ORDER):
        got = outs[k].numpy()
        assert got.shape == img.shape and np.isfinite(got).all()
        d = float(np.abs(got.astype(np.float64) - want[k]).max())
        psnr = _psnr(got, want[k])
        if fast:  # the gate of tests/test_torch_fast.py's six_fast test
            assert psnr >= (50.0 if name == "light_dehazing" else 25.0), (
                name, psnr)
        elif k >= 3:
            assert d <= 1e-6, (name, d)
        else:
            assert psnr >= 50.0, (name, psnr)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", STRATEGIES)
@pytest.mark.parametrize("key", list(SMALL))
def test_strategies_on_small_frames_match_jax(jax_small, key, name, fast):
    img, _, _, want = jax_small[key, fast]
    got = np.stack([p.numpy() for p in ts.run_strategy(
        name, torch.from_numpy(img), fast)], -1)
    assert got.shape == img.shape and np.isfinite(got).all()
    assert _psnr(got, want[name]) >= 50.0, _psnr(got, want[name])
