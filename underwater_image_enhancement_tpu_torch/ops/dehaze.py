"""Dark-channel-prior transmission and scene recovery in both reference
flavours: six_stadigy's (six_stadigy.py:167-188; eps 1e-6 on A, the
transmission clipped before and after the guided-filter refinement) and
enhancement_strategies' (:208-249; eps 1e-10 on A, one final clip), with
the fast tier's refinement shared across every omega."""

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
    t = torch.clamp(1.0 - omega * _dark_channel(planes, A, 1e-6), 0.1, 1.0)
    gray = _gray_guide(planes)
    if guided_subsample > 1:
        t = guided_filter_fast(gray, t, r, eps, guided_subsample)
    else:
        t = guided_filter(gray, t, r, eps)
    return torch.clamp(t, 0.1, 1.0)


def _dark_channel(planes, A: torch.Tensor, a_eps: float) -> torch.Tensor:
    Ae = A + a_eps
    return torch.minimum(torch.minimum(planes[0] / Ae[0], planes[1] / Ae[1]),
                         planes[2] / Ae[2])


def _gray_guide(planes) -> torch.Tensor:
    return u8_to_unit(gray_u8_planes(*(quantize_u8(p) for p in planes)))


def estimate_transmission_planes(planes, A: torch.Tensor, omega: float,
                                 r: int, eps: float,
                                 guided_subsample: int = 1) -> torch.Tensor:
    """enhancement_strategies.py:208-234: t = 1 - omega * dark (A + 1e-10),
    refined by the guided filter on the u8 gray guide, then one clip to
    [0.1, 1].  guided_subsample > 1 refines with the row-subsampled fast
    guided filter (the throughput tier's approximation)."""
    t = 1.0 - omega * _dark_channel(planes, A, 1e-10)
    gray = _gray_guide(planes)
    if guided_subsample > 1:
        t = guided_filter_fast(gray, t, r, eps, guided_subsample)
    else:
        t = guided_filter(gray, t, r, eps)
    return torch.clamp(t, 0.1, 1.0)


def shared_refined_dark(planes, A: torch.Tensor, r: int, eps: float,
                        guided_subsample: int = 4) -> torch.Tensor:
    """The fast tier's one refinement for every omega: the fast guided
    filter of the dark channel itself.  The filter is linear in its input
    for a fixed guide, so gf(1 - omega * dark) = 1 - omega * gf(dark)."""
    return guided_filter_fast(_gray_guide(planes), _dark_channel(planes, A, 1e-10),
                              r, eps, guided_subsample)


def transmission_from_refined_dark(dark_refined: torch.Tensor,
                                   omega: float) -> torch.Tensor:
    return torch.clamp(1.0 - omega * dark_refined, 0.1, 1.0)


def estimate_transmission_planes_shared(planes, A: torch.Tensor, omega: float,
                                        r: int, eps: float,
                                        guided_subsample: int = 4) -> torch.Tensor:
    """The fast tier's transmission (the JAX function of the same name):
    clip(1 - omega * shared_refined_dark(...), 0.1, 1)."""
    return transmission_from_refined_dark(
        shared_refined_dark(planes, A, r, eps, guided_subsample), omega)


def recover_planes(planes, t: torch.Tensor, A: torch.Tensor):
    """J = (I - A) / t + A per plane, clipped to [0, 1]."""
    return tuple(torch.clamp((p - A[c]) / t + A[c], 0.0, 1.0)
                 for c, p in enumerate(planes))
