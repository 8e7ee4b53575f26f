"""Layout helpers shared by the channel-first pipelines."""

from __future__ import annotations

import torch


def split_planes(img: torch.Tensor):
    """(H, W, 3) -> three contiguous (H, W) channel planes: the kernels
    take dense planes, and every op of the six recipes is per plane."""
    return tuple(img[..., c].contiguous() for c in range(3))


def stack_planes(planes) -> torch.Tensor:
    """Three (H, W) planes -> (H, W, 3)."""
    return torch.stack(tuple(planes), dim=-1)


def div(x: torch.Tensor, d) -> torch.Tensor:
    """IEEE float32 ``x / d`` on every device.

    PyTorch's CUDA division by a CPU scalar multiplies by the scalar's
    reciprocal (1 ulp off for some inputs); dividing by a tensor on
    ``x``'s device keeps the correctly rounded quotient, so the CPU and the
    card agree bit for bit."""
    if not isinstance(d, torch.Tensor):
        d = torch.tensor(d, dtype=x.dtype, device=x.device)
    return x / d
