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


def guided_filter_fast(I: torch.Tensor, p: torch.Tensor, r: int, eps: float,
                       s: int = 4) -> torch.Tensor:
    """He et al.'s Fast Guided Filter as the JAX package runs it
    (guided.py:40-63): the (a, b) maps on every s-th row with an
    rs x r window, rs = max(r // s, 2), each row repeated s times back up
    and cropped to H, then applied at full resolution."""
    Is, ps = I[..., ::s, :], p[..., ::s, :]
    rs = max(r // s, 2)
    m = box_filter(torch.stack([Is, ps, Is * ps, Is * Is]), rs, rx=r)
    cov_Ip = m[2] - m[0] * m[1]
    var_I = m[3] - m[0] * m[0]
    a = cov_Ip / (var_I + eps)
    b = m[1] - a * m[0]
    mab = box_filter(torch.stack([a, b]), rs, rx=r)
    up = torch.repeat_interleave(mab, s, dim=-2)[..., :I.shape[-2], :]
    return up[0] * I + up[1]
