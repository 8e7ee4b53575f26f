"""Dark-channel-prior transmission and scene recovery, six_stadigy flavour
(six_stadigy.py:167-188): eps 1e-6 on A, transmission clipped before and
after the guided-filter refinement."""

from __future__ import annotations

import torch

from underwater_image_enhancement_tpu_torch.ops.colorspace import (
    gray_u8_planes,
    quantize_u8,
    u8_to_unit,
)
from underwater_image_enhancement_tpu_torch.ops.guided import (
    guided_filter,
    guided_filter_fast,
)


def estimate_transmission_six_planes(planes, A: torch.Tensor, omega: float,
                                     r: int, eps: float,
                                     guided_subsample: int = 1) -> torch.Tensor:
    """(r, g, b) f32 planes and A (3,) on the same device -> refined
    transmission (H, W), clipped to [0.1, 1].  guided_subsample > 1 refines
    with the row-subsampled fast guided filter (the ``--fast`` tier)."""
    Ae = A + 1e-6
    dark = torch.minimum(torch.minimum(planes[0] / Ae[0], planes[1] / Ae[1]),
                         planes[2] / Ae[2])
    t = torch.clamp(1.0 - omega * dark, 0.1, 1.0)
    gray = u8_to_unit(gray_u8_planes(*(quantize_u8(p) for p in planes)))
    if guided_subsample > 1:
        t = guided_filter_fast(gray, t, r, eps, guided_subsample)
    else:
        t = guided_filter(gray, t, r, eps)
    return torch.clamp(t, 0.1, 1.0)


def recover_planes(planes, t: torch.Tensor, A: torch.Tensor):
    """J = (I - A) / t + A per plane, clipped to [0, 1]."""
    return tuple(torch.clamp((p - A[c]) / t + A[c], 0.0, 1.0)
                 for c, p in enumerate(planes))
