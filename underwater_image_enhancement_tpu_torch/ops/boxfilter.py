"""Normalized box filter matching cv2.boxFilter(ksize=(r, r)) semantics.

Window of r x r anchored at (r//2, r//2), REFLECT_101 border, mean.  The
window sums use the JAX package's log-doubling scheme (``_window_sum``)
term for term, so the f32 association, and hence every bit, matches it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


def box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Mean over an r x r window of x (..., H, W) float32, cv2.boxFilter
    compatible (REFLECT_101 border; needs r//2 <= min(H, W) - 1).

    The JAX reference divides by the literal r*r, which XLA compiles to a
    multiply by its f32 reciprocal; the port multiplies by the same f32
    reciprocal."""
    if r == 1:
        return x
    lo, hi = r // 2, r - 1 - r // 2
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    xp = F.pad(x4, (lo, hi, lo, hi), mode="reflect")  # == REFLECT_101
    s = _window_sum(_window_sum(xp, r, 2), r, 3)
    s = s.reshape(lead + tuple(s.shape[-2:]))
    return s * float(np.float32(1.0) / np.float32(r * r))
