"""Normalized box filter matching cv2.boxFilter(ksize=(r, r)) semantics.

Window of r x r (or r rows x rx cols) anchored at (r//2, rx//2),
REFLECT_101 border, mean.  The
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


def box_filter(x: torch.Tensor, r: int, rx: int | None = None) -> torch.Tensor:
    """Mean over an r x rx window (rx defaults to r) of x (..., H, W)
    float32, cv2.boxFilter compatible in the square case (REFLECT_101
    border; needs r//2 <= H - 1 and rx//2 <= W - 1).

    The JAX reference divides by the literal r*rx, which XLA compiles to a
    multiply by its f32 reciprocal; the port multiplies by the same f32
    reciprocal."""
    rx = r if rx is None else rx
    if r == 1 and rx == 1:
        return x
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    xp = F.pad(x4, (rx // 2, rx - 1 - rx // 2, r // 2, r - 1 - r // 2),
               mode="reflect")  # == REFLECT_101
    s = _window_sum(_window_sum(xp, r, 2), rx, 3)
    s = s.reshape(lead + tuple(s.shape[-2:]))
    return s * float(np.float32(1.0) / np.float32(r * rx))
