"""The six_stadigy recipes (six_stadigy.py:226-285), exact and fast tiers.

Each recipe runs channel-first on three (H, W) planes: dehaze (strategies
1-3, sharing one airlight estimate), percentile stretch, white balance,
and the LAB-L CLAHE leg, whose LAB forward, CLAHE apply and LAB inverse
steps are the package's CUDA kernels.  Constants live in
``utils/config.SIX_PARAMS``.

``fast=True`` is the JAX package's ``method="hist-fast"`` tier
(pipeline/six.py there): the banded-SAT airlight with 4 hysteresis rounds
(``airlight``), the fast guided filter on every 4th row, the hist-fast
percentiles, and the approximate forward LAB in the CLAHE legs.

``run_strategy(name, img, A, fast)`` is the pipeline's entry; the public
``strategy1_strong_dehazing`` ... ``strategy6_histogram_eq`` (and
``SIX_STRATEGIES``, with ``SIX_STRATEGIES_FAST`` its ``hist-fast`` twin)
take the JAX contract ``fn(img, *, method="radix"[,
A=None])`` on one image or a batch.
"""

from __future__ import annotations

import functools

import torch

from underwater_image_enhancement_tpu_torch.ops import dehaze, histeq, stretch
from underwater_image_enhancement_tpu_torch.ops.airlight import (
    quadtree_airlight_exact_planes,
    quadtree_airlight_planes,
)
from underwater_image_enhancement_tpu_torch.ops.layout import (
    split_planes,
    stack_planes,
)
from underwater_image_enhancement_tpu_torch.utils.config import SIX_PARAMS


def _method(fast: bool) -> str:
    return "hist-fast" if fast else "sort"


def airlight(planes, fast: bool = False) -> torch.Tensor:
    """The tier's airlight A (3,): the exact per-block-Canny descent, or
    the banded SAT with 4 hysteresis rounds."""
    if fast:
        return quadtree_airlight_planes(planes, edge_iters=4)
    return quadtree_airlight_exact_planes(planes)


def _restore(planes, A, omega, radius, eps, fast):
    t = dehaze.estimate_transmission_six_planes(
        planes, A, omega, radius, eps, guided_subsample=4 if fast else 1)
    return dehaze.recover_planes(planes, t, A)


def _gamma_pow(planes, g):
    return tuple(stretch.gamma_correction_pow(c, g) for c in planes)


def _clahe(planes, p, fast, gamma=None):
    return histeq.clahe_enhancement_planes(planes, p["clahe"], gamma=gamma,
                                           lab_fast=fast)


def _strategy1_strong_dehazing(img, A, fast: bool = False):
    """Dehaze .3/r20/eps .5 -> stretch 5-98 -> CLAHE 3.0 -> gamma**1.5."""
    p = SIX_PARAMS["strong_dehazing"]
    e = _restore(split_planes(img), A, *p["dehaze"], fast)
    e = stretch.enhance_contrast_planes(e, *p["stretch"], method=_method(fast))
    return stack_planes(_clahe(e, p, fast, gamma=p["gamma"]))


def _strategy2_medium_dehazing(img, A, fast: bool = False):
    """Dehaze .5/r15/eps .5 -> stretch 15-95 -> CLAHE 2.0."""
    p = SIX_PARAMS["medium_dehazing"]
    e = _restore(split_planes(img), A, *p["dehaze"], fast)
    e = stretch.enhance_contrast_planes(e, *p["stretch"], method=_method(fast))
    return stack_planes(_clahe(e, p, fast))


def _strategy3_light_dehazing(img, A, fast: bool = False):
    """Dehaze .7/r10/eps .1 -> stretch 20-85 -> white balance p2."""
    p = SIX_PARAMS["light_dehazing"]
    e = _restore(split_planes(img), A, *p["dehaze"], fast)
    e = stretch.enhance_contrast_planes(e, *p["stretch"], method=_method(fast))
    return stack_planes(stretch.white_balance_planes(e, p["wb"],
                                                     method=_method(fast)))


def _strategy4_clahe_enhancement(img, fast: bool = False):
    """CLAHE 4.0 -> stretch 10-95 -> white balance p3 -> gamma**1.3."""
    p = SIX_PARAMS["clahe_enhancement"]
    e = _clahe(split_planes(img), p, fast)
    e = stretch.enhance_contrast_planes(e, *p["stretch"], method=_method(fast))
    e = stretch.white_balance_planes(e, p["wb"], method=_method(fast))
    return stack_planes(_gamma_pow(e, p["gamma"]))


def _strategy5_white_balance(img, fast: bool = False):
    """White balance p2 -> stretch 15-90 -> CLAHE 1.5 -> gamma**1.2."""
    p = SIX_PARAMS["white_balance"]
    e = stretch.white_balance_planes(split_planes(img), p["wb"],
                                     method=_method(fast))
    e = stretch.enhance_contrast_planes(e, *p["stretch"], method=_method(fast))
    return stack_planes(_clahe(e, p, fast, gamma=p["gamma"]))


def _strategy6_histogram_eq(img, fast: bool = False):
    """Stretch 5-98 -> CLAHE 3.5 -> gamma**1.4."""
    p = SIX_PARAMS["histogram_eq"]
    e = stretch.enhance_contrast_planes(split_planes(img), *p["stretch"],
                                        method=_method(fast))
    return stack_planes(_clahe(e, p, fast, gamma=p["gamma"]))


# reference order; the dehaze recipes take the shared airlight A
_BUILDERS = {
    "strong_dehazing": _strategy1_strong_dehazing,
    "medium_dehazing": _strategy2_medium_dehazing,
    "light_dehazing": _strategy3_light_dehazing,
    "clahe_enhancement": _strategy4_clahe_enhancement,
    "white_balance": _strategy5_white_balance,
    "histogram_eq": _strategy6_histogram_eq,
}
DEHAZE_STRATEGIES = ("strong_dehazing", "medium_dehazing", "light_dehazing")


def run_strategy(name: str, img: torch.Tensor, A: torch.Tensor,
                 fast: bool = False):
    fn = _BUILDERS[name]
    return fn(img, A, fast) if name in DEHAZE_STRATEGIES else fn(img, fast)


def _public(name: str):
    """The JAX contract of a recipe: ``fn(img, *, method="radix"[, A=None])``
    on an (H, W, 3) image or a (B, H, W, 3) batch; ``method`` "hist-fast"
    is the fast tier, and a dehaze recipe without A runs the tier's
    airlight of the image."""
    def one(im, fast, A):
        if name in DEHAZE_STRATEGIES and A is None:
            A = airlight(split_planes(im), fast)
        return run_strategy(name, im, A, fast)

    def fn(img: torch.Tensor, *, method: str = "radix", A=None):
        if method not in ("radix", "sort", "hist-fast"):
            raise ValueError(f"{name}: method must be 'radix' or "
                             f"'hist-fast', got {method!r}")
        fast = method == "hist-fast"
        if img.ndim == 3:
            return one(img, fast, A)
        return torch.stack([one(im, fast, A) for im in img])

    def fn_no_a(img: torch.Tensor, *, method: str = "radix"):
        return fn(img, method=method)

    out = fn if name in DEHAZE_STRATEGIES else fn_no_a
    out.__doc__ = _BUILDERS[name].__doc__
    return out


SIX_STRATEGIES = {k: _public(k) for k in _BUILDERS}
# the histogram-percentile tier, as the JAX table of the same name
SIX_STRATEGIES_FAST = {k: functools.partial(fn, method="hist-fast")
                       for k, fn in SIX_STRATEGIES.items()}
strategy1_strong_dehazing = SIX_STRATEGIES["strong_dehazing"]
strategy2_medium_dehazing = SIX_STRATEGIES["medium_dehazing"]
strategy3_light_dehazing = SIX_STRATEGIES["light_dehazing"]
strategy4_clahe_enhancement = SIX_STRATEGIES["clahe_enhancement"]
strategy5_white_balance = SIX_STRATEGIES["white_balance"]
strategy6_histogram_eq = SIX_STRATEGIES["histogram_eq"]
