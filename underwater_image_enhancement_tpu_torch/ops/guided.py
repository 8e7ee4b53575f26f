"""He et al. guided filter, the transmission-map refiner
(enhancement_strategies.py:16-46; six_stadigy.py:25-46)."""

from __future__ import annotations

import torch

from underwater_image_enhancement_tpu_torch.ops.boxfilter import box_filter


def guided_filter(I: torch.Tensor, p: torch.Tensor, r: int,
                  eps: float) -> torch.Tensor:
    """q = mean(a) * I + mean(b), a = cov(I,p)/(var(I)+eps),
    b = mean_p - a*mean_I.  I, p: (H, W) float32; r: window (cv2 ksize).
    The four first-stage means (and the two second-stage ones) go through
    one stacked box filter, as in the JAX package."""
    m = box_filter(torch.stack([I, p, I * p, I * I]), r)
    mean_I, mean_p, mean_Ip, mean_II = m[0], m[1], m[2], m[3]
    cov_Ip = mean_Ip - mean_I * mean_p
    var_I = mean_II - mean_I * mean_I
    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    mab = box_filter(torch.stack([a, b]), r)
    return mab[0] * I + mab[1]
