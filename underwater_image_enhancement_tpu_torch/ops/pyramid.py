"""Gaussian and Laplacian image pyramids (cv2.pyrDown/pyrUp semantics).

Counterpart of the JAX package's ``ops/pyramid.py``, the building block of
the Ancuti fusion (``pipeline/fusion.py``).  The 5-tap binomial kernel
[1 4 6 4 1]/16 runs separably with REFLECT_101 borders, as OpenCV's pyramid
filters do.  Each axis sums its five terms in the JAX order, ``k = 0..4``,
each term ``slice * (w * scale)`` (a convolution would sum in another
order), so the CPU path gives the JAX program's bits.  The JAX helpers
``_even_cols`` and ``_interleave_zeros`` work around the TPU's layout; here
they are a strided slice and a strided write.

All functions take (..., H, W) float32 planes: leading dimensions (the
colour channels, a batch) ride along.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of positions -pad..n+pad-1 under REFLECT_101
    (``jnp.pad(mode="reflect")``, periodic past one reflection; a length-1
    axis repeats)."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        i = np.zeros_like(i)
    else:
        period = 2 * (n - 1)
        i = i % period
        i = np.where(i < n, i, period - i)
    return torch.as_tensor(i, device=device)


def _blur5_axis(x: torch.Tensor, axis: int, scale: float = 1.0) -> torch.Tensor:
    """Separable 5-tap binomial blur along one axis, REFLECT_101 border."""
    n = x.shape[axis]
    xp = x.index_select(axis, _reflect_index(n, 2, x.device))
    out = None
    for k, w in enumerate(_K5):
        term = xp.narrow(axis, k, n) * (w * scale)
        out = term if out is None else out + term
    return out


def blur5(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """5x5 binomial blur of (..., H, W); ``scale`` multiplies the kernel."""
    return _blur5_axis(_blur5_axis(x, x.ndim - 2, scale), x.ndim - 1)


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown: blur, then keep the even rows and columns ->
    (..., ceil(H/2), ceil(W/2))."""
    return blur5(x)[..., ::2, ::2].contiguous()


def pyr_up(x: torch.Tensor, dst_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.pyrUp with an explicit dstsize: zeros between the samples, crop
    to (H, W), then the blur with the kernel times 4."""
    H, W = dst_hw
    h, w = x.shape[-2], x.shape[-1]
    up = x.new_zeros(x.shape[:-2] + (2 * h, 2 * w))
    up[..., ::2, ::2] = x
    return blur5(up[..., :H, :W], scale=4.0)


def gaussian_pyramid(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[G0 (= x), G1, ..., G_{levels-1}], each pyr_down of the previous."""
    pyr = [x]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def laplacian_pyramid(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[L0, ..., L_{n-2}, G_{n-1}]: band-pass residuals and the coarse
    top."""
    g = gaussian_pyramid(x, levels)
    lap = [g[i] - pyr_up(g[i + 1], tuple(g[i].shape[-2:]))
           for i in range(levels - 1)]
    lap.append(g[-1])
    return lap


def reconstruct(lap: List[torch.Tensor]) -> torch.Tensor:
    """Inverse of laplacian_pyramid: upsample and add, coarse to fine."""
    out = lap[-1]
    for lvl in reversed(lap[:-1]):
        out = lvl + pyr_up(out, tuple(lvl.shape[-2:]))
    return out


def blend_pyramids(inputs: torch.Tensor, weights: torch.Tensor,
                   levels: int) -> torch.Tensor:
    """The fusion core: sum_k GaussPyr(W_k) * LapPyr(I_k), collapsed.

    inputs: (K, ..., C, H, W) channel planes of K fusion inputs; weights:
    (K, ..., H, W) normalised weight maps, whose Gaussian pyramids serve
    all C channels.  Returns (..., C, H, W).  The JAX function takes no
    leading dimensions between K and C; here they are the batch of
    ``ancuti_fusion``."""
    K = inputs.shape[0]
    w_pyrs = [gaussian_pyramid(weights[k], levels) for k in range(K)]
    i_pyrs = [laplacian_pyramid(inputs[k], levels) for k in range(K)]
    fused = []
    for lvl in range(levels):
        acc = None
        for k in range(K):
            term = w_pyrs[k][lvl].unsqueeze(-3) * i_pyrs[k][lvl]
            acc = term if acc is None else acc + term
        fused.append(acc)
    return reconstruct(fused)
