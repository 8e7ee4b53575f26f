"""Percentile contrast stretch, white balance and gamma on channel planes.

Counterpart of the JAX package's ``ops/stretch.py`` for the ``six`` exact
tier.  Percentiles follow ``np.percentile``'s linear interpolation.  The
JAX exact tier selects the order statistics with an O(n) radix select that
is bit-equal to its full-sort oracle; here one ``torch.sort`` of the
stacked channels gives the same order statistics, and the interpolation
is the same f32 arithmetic (indices and weights from ``_lerp_indices``,
then ``lv*lw + hv*hw`` with each product rounded).
"""

from __future__ import annotations

import numpy as np
import torch

_f32 = np.float32

# the 256 float32 values a decoded u8 image can take (k/255, IEEE f32
# division): the gamma LUT's grid and u8_to_unit's exact values
U8_GRID = np.arange(256, dtype=np.float32) / np.float32(255.0)


def _lerp_indices(n: int, pct: float):
    """np.percentile 'linear' index and weights in f32: q = pct/100 *
    (n-1); low/high = floor/ceil(q) clipped; weights (1-frac, frac)."""
    q = _f32(pct) / _f32(100.0) * (_f32(n) - _f32(1))
    low = np.floor(q)
    high_w = _f32(q - low)
    low_w = _f32(_f32(1.0) - high_w)
    low_i = int(np.clip(low, 0, n - 1))
    high_i = int(np.clip(np.ceil(q), 0, n - 1))
    return low_i, high_i, low_w, high_w


def percentiles_planes(planes, pcts) -> torch.Tensor:
    """Exact np.percentile-convention percentiles of same-shape planes:
    (len(planes), len(pcts)) f32, one sort for all planes."""
    flat = torch.stack([p.reshape(-1) for p in planes])
    n = flat.shape[1]
    srt = torch.sort(flat, dim=1).values
    idx = [_lerp_indices(n, p) for p in pcts]
    dev = flat.device
    lo = torch.tensor([i[0] for i in idx], device=dev)
    hi = torch.tensor([i[1] for i in idx], device=dev)
    lw = torch.tensor([i[2] for i in idx], dtype=torch.float32, device=dev)
    hw = torch.tensor([i[3] for i in idx], dtype=torch.float32, device=dev)
    return srt[:, lo] * lw + srt[:, hi] * hw


def color_enhancement_planes(planes, l_low=15.0, l_high=95.0,
                             eps: float = 1e-10):
    """Per-channel percentile stretch (p - lo) / (hi - lo + eps), clipped to
    [0, 1] (enhancement_strategies.py:251-273)."""
    pr = percentiles_planes(planes, (l_low, l_high))
    denom = pr[:, 1] - pr[:, 0] + eps
    return tuple(torch.clamp((p - pr[c, 0]) / denom[c], 0.0, 1.0)
                 for c, p in enumerate(planes))


def enhance_contrast_planes(planes, l_low=15.0, l_high=95.0):
    """six_stadigy.py:190-199 flavour (eps 1e-6)."""
    return color_enhancement_planes(planes, l_low, l_high, 1e-6)


def white_balance_planes(planes, percentile=5.0):
    """Symmetric percentile stretch (six_stadigy.py:210-219, eps 1e-6)."""
    return color_enhancement_planes(planes, percentile, 100.0 - percentile,
                                    1e-6)


def gamma_correction_pow(img: torch.Tensor, gamma=1.2) -> torch.Tensor:
    """img ** gamma, no clip (six_stadigy.py:221-224)."""
    return torch.pow(torch.clamp(img, min=0.0), float(gamma))
