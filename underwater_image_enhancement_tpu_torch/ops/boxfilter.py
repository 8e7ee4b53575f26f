"""Normalized box filter matching cv2.boxFilter(ksize=(r, r)) semantics.

Window of r x r (or r rows x rx cols) anchored at (r//2, rx//2),
REFLECT_101 border, mean.  The
window sums use the JAX package's log-doubling scheme (``_window_sum``)
term for term, so the f32 association, and hence every bit, matches it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _window_sum(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Sums over sliding windows of length r along ``dim`` (valid mode):
    window(2k) = window(k) + shifted window(k), then r from its binary
    decomposition, largest part first (~2*log2(r) passes)."""
    if r == 1:
        return x
    n_out = x.shape[dim] - r + 1
    sums = {1: x}
    span = 1
    while span * 2 <= r:
        prev = sums[span]
        m = prev.shape[dim]
        sums[span * 2] = (prev.narrow(dim, 0, m - span)
                          + prev.narrow(dim, span, m - span))
        span *= 2
    out = None
    off = 0
    rem = r
    p = span
    while rem > 0:
        if rem >= p:
            term = sums[p].narrow(dim, off, n_out)
            out = term if out is None else out + term
            off += p
            rem -= p
        p //= 2
    return out


@functools.lru_cache(maxsize=64)
def _reflect_101(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source indices of a REFLECT_101 pad of ``lo`` and ``hi`` around an
    axis of length ``n``, for any pad: the reflection repeats (an index
    folds onto [0, n-1] with period 2(n-1), as ``jnp.pad(mode="reflect")``
    and cv2's BORDER_REFLECT_101 do), and a side of 1 maps every index to
    0.  Kept per device, so a frame's filters copy no index to the card."""
    i = np.arange(-lo, n + hi)
    if n == 1:
        i = np.zeros_like(i)
    else:
        i = np.remainder(i, 2 * (n - 1))
        i = np.where(i >= n, 2 * (n - 1) - i, i)
    return torch.from_numpy(i).to(device)


def box_filter(x: torch.Tensor, r: int, rx: int | None = None) -> torch.Tensor:
    """Mean over an r x rx window (rx defaults to r) of x (..., H, W)
    float32, cv2.boxFilter compatible in the square case (REFLECT_101
    border, repeated where the pad reaches past a side, as JAX and cv2
    do).

    The JAX reference divides by the literal r*rx, which XLA compiles to a
    multiply by its f32 reciprocal; the port multiplies by the same f32
    reciprocal."""
    rx = r if rx is None else rx
    if r == 1 and rx == 1:
        return x
    hh, ww = x.shape[-2:]
    rows = _reflect_101(hh, r // 2, r - 1 - r // 2, x.device)
    cols = _reflect_101(ww, rx // 2, rx - 1 - rx // 2, x.device)
    xp = x[..., rows[:, None], cols]  # one gather, one padded copy
    s = _window_sum(_window_sum(xp, r, x.dim() - 2), rx, x.dim() - 1)
    return s * float(np.float32(1.0) / np.float32(r * rx))
