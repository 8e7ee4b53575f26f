"""Dark-channel-prior transmission and scene recovery in both reference
flavours: six_stadigy's (six_stadigy.py:167-188; eps 1e-6 on A, the
transmission clipped before and after the guided-filter refinement) and
enhancement_strategies' (:208-249; eps 1e-10 on A, one final clip), with
the fast tier's refinement shared across every omega.  The ``*_planes``
functions take (r, g, b) planes (H, W); ``dark_channel``,
``estimate_transmission[_six]`` and ``recover_image`` are the JAX
package's forms on (..., H, W, 3) images (A (3,), or one (3,) an
image)."""

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


def dark_channel(img: torch.Tensor, A, a_eps: float) -> torch.Tensor:
    """Per-pixel channel minimum of img / (A + a_eps); A broadcasts over
    (..., 3)."""
    A = torch.as_tensor(A, dtype=torch.float32, device=img.device)
    return torch.amin(img / (A + a_eps), dim=-1)


def _transmission(img: torch.Tensor, A, planes_fn) -> torch.Tensor:
    """planes_fn(planes, A_i) of each (H, W, 3) image of (..., H, W, 3),
    with A (3,) or one (3,) an image (..., 3) -> (..., H, W)."""
    A = torch.as_tensor(A, dtype=torch.float32, device=img.device)
    lead = img.shape[:-3]
    ims = img.reshape((-1,) + img.shape[-3:])
    As = A.expand(lead + (3,)).reshape(-1, 3)
    outs = [planes_fn(tuple(im[..., c].contiguous() for c in range(3)), a)
            for im, a in zip(ims, As)]
    return torch.stack(outs).reshape(img.shape[:-1])


def estimate_transmission(img: torch.Tensor, A, omega=0.95, r: int = 15,
                          eps: float = 0.001) -> torch.Tensor:
    """enhancement_strategies.py:208-234 of (..., H, W, 3) images and A (3,)
    -> (..., H, W): one final clip to [0.1, 1]."""
    return _transmission(img, A, lambda p, a: estimate_transmission_planes(
        p, a, omega, r, eps))


def estimate_transmission_six(img: torch.Tensor, A, omega, r: int,
                              eps: float) -> torch.Tensor:
    """six_stadigy.py:167-180 of (..., H, W, 3) images and A (3,) ->
    (..., H, W): clipped before and after the refinement."""
    return _transmission(img, A, lambda p, a: estimate_transmission_six_planes(
        p, a, omega, r, eps))


def recover_image(img: torch.Tensor, t: torch.Tensor, A) -> torch.Tensor:
    """Scene radiance J = (I - A) / t + A, clipped to [0, 1]; img (..., H,
    W, 3), t (..., H, W), A broadcastable to img."""
    A = torch.as_tensor(A, dtype=torch.float32, device=img.device)
    return torch.clamp((img - A) / t[..., None] + A, 0.0, 1.0)
