"""The six_stadigy recipes (six_stadigy.py:226-285), exact tier.

Each recipe runs channel-first on three (H, W) planes: dehaze (strategies
1-3, sharing one airlight estimate), percentile stretch, white balance,
and the LAB-L CLAHE leg, whose LAB forward, CLAHE apply and LAB inverse
steps are the package's CUDA kernels.  Constants live in
``utils/config.SIX_PARAMS``.  The ``--fast`` tier is not ported yet.
"""

from __future__ import annotations

import torch

from underwater_image_enhancement_tpu_torch.ops import dehaze, histeq, stretch
from underwater_image_enhancement_tpu_torch.ops.layout import (
    split_planes,
    stack_planes,
)
from underwater_image_enhancement_tpu_torch.utils.config import SIX_PARAMS


def _restore(planes, A, omega, radius, eps):
    t = dehaze.estimate_transmission_six_planes(planes, A, omega, radius, eps)
    return dehaze.recover_planes(planes, t, A)


def _gamma_pow(planes, g):
    return tuple(stretch.gamma_correction_pow(c, g) for c in planes)


def strategy1_strong_dehazing(img, A):
    """Dehaze .3/r20/eps .5 -> stretch 5-98 -> CLAHE 3.0 -> gamma**1.5."""
    p = SIX_PARAMS["strong_dehazing"]
    e = _restore(split_planes(img), A, *p["dehaze"])
    e = stretch.enhance_contrast_planes(e, *p["stretch"])
    return stack_planes(histeq.clahe_enhancement_planes(
        e, p["clahe"], gamma=p["gamma"]))


def strategy2_medium_dehazing(img, A):
    """Dehaze .5/r15/eps .5 -> stretch 15-95 -> CLAHE 2.0."""
    p = SIX_PARAMS["medium_dehazing"]
    e = _restore(split_planes(img), A, *p["dehaze"])
    e = stretch.enhance_contrast_planes(e, *p["stretch"])
    return stack_planes(histeq.clahe_enhancement_planes(e, p["clahe"]))


def strategy3_light_dehazing(img, A):
    """Dehaze .7/r10/eps .1 -> stretch 20-85 -> white balance p2."""
    p = SIX_PARAMS["light_dehazing"]
    e = _restore(split_planes(img), A, *p["dehaze"])
    e = stretch.enhance_contrast_planes(e, *p["stretch"])
    return stack_planes(stretch.white_balance_planes(e, p["wb"]))


def strategy4_clahe_enhancement(img):
    """CLAHE 4.0 -> stretch 10-95 -> white balance p3 -> gamma**1.3."""
    p = SIX_PARAMS["clahe_enhancement"]
    e = histeq.clahe_enhancement_planes(split_planes(img), p["clahe"])
    e = stretch.enhance_contrast_planes(e, *p["stretch"])
    e = stretch.white_balance_planes(e, p["wb"])
    return stack_planes(_gamma_pow(e, p["gamma"]))


def strategy5_white_balance(img):
    """White balance p2 -> stretch 15-90 -> CLAHE 1.5 -> gamma**1.2."""
    p = SIX_PARAMS["white_balance"]
    e = stretch.white_balance_planes(split_planes(img), p["wb"])
    e = stretch.enhance_contrast_planes(e, *p["stretch"])
    return stack_planes(histeq.clahe_enhancement_planes(
        e, p["clahe"], gamma=p["gamma"]))


def strategy6_histogram_eq(img):
    """Stretch 5-98 -> CLAHE 3.5 -> gamma**1.4."""
    p = SIX_PARAMS["histogram_eq"]
    e = stretch.enhance_contrast_planes(split_planes(img), *p["stretch"])
    return stack_planes(histeq.clahe_enhancement_planes(
        e, p["clahe"], gamma=p["gamma"]))


# reference order; the dehaze recipes take the shared airlight A
SIX_STRATEGIES = {
    "strong_dehazing": strategy1_strong_dehazing,
    "medium_dehazing": strategy2_medium_dehazing,
    "light_dehazing": strategy3_light_dehazing,
    "clahe_enhancement": strategy4_clahe_enhancement,
    "white_balance": strategy5_white_balance,
    "histogram_eq": strategy6_histogram_eq,
}
DEHAZE_STRATEGIES = ("strong_dehazing", "medium_dehazing", "light_dehazing")


def run_strategy(name: str, img: torch.Tensor, A: torch.Tensor):
    fn = SIX_STRATEGIES[name]
    return fn(img, A) if name in DEHAZE_STRATEGIES else fn(img)
