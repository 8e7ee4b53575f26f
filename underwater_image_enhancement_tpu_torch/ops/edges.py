"""3x3 correlation and cv2.Canny (aperture 3, L1 gradient) on int planes.

Counterpart of the JAX package's ``ops/edges.py``: Sobel with a REPLICATE
border, OpenCV's integer non-maximum-suppression sectors (TG22 = 13573 in
Q15) and tie-breaking, double threshold, and hysteresis bounded to a fixed
number of 8-connected dilation rounds (64 by default), which the JAX
package runs row-packed.  Here each round is one 3x3 max-pool: the same
``e | (weak & dilate8(e))`` recurrence, so the edge maps are bit-equal.
Planes may carry a leading batch dimension.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SOBEL_X = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
_SOBEL_Y = [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]
_TG22 = 13573  # tan(22.5 deg) in Q15, as in OpenCV canny.cpp


def conv3x3(x: torch.Tensor, kernel) -> torch.Tensor:
    """Correlate x (..., H, W) with a 3x3 kernel (nested lists) under cv2's
    BORDER_REPLICATE: nine shifted multiply-adds in the JAX package's
    order (its ``conv3x3(..., mode="edge")``)."""
    H, W = x.shape[-2], x.shape[-1]

    def edge_index(n):  # -1..n, clamped: the replicated border
        return torch.clamp(torch.arange(-1, n + 1, device=x.device), 0, n - 1)

    xp = x.index_select(-2, edge_index(H)).index_select(-1, edge_index(W))
    out = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            k = kernel[dy + 1][dx + 1]
            if k == 0:
                continue
            term = xp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W] * k
            out = term if out is None else out + term
    return out


def _shift_zero(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., i, j] = x[..., i+dy, j+dx], zero outside."""
    H, W = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (1, 1, 1, 1))
    return xp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def _hysteresis(strong: torch.Tensor, weak: torch.Tensor,
                iters: int) -> torch.Tensor:
    """strong | (weak reachable from strong in <= iters 8-connected steps),
    as float 0/1 planes (N, H, W); each round is a 3x3 max-pool (the
    8-neighbourhood dilation with the centre, zero outside)."""
    e = strong[:, None]
    w = weak[:, None]
    for _ in range(iters):
        e = torch.maximum(e, w * F.max_pool2d(e, 3, stride=1, padding=1))
    return e[:, 0]


def canny_u8(gray_u8: torch.Tensor, low: int = 50, high: int = 150,
             hysteresis_iters: int = 64, valid_hw=None) -> torch.Tensor:
    """cv2.Canny(gray, low, high) on u8-valued int planes (H, W) or
    (N, H, W) -> int32 {0, 1} edge map of the same shape.

    valid_hw=(h, w), ints or (N,) int tensors, restricts each plane to its
    top-left (h, w) region: with row h-1 and column w-1 replicated beyond
    it, zeroing the gradient magnitude outside makes the result inside
    exactly cv2.Canny of the (h, w) crop and zero outside (see the JAX
    package's canny_u8)."""
    single = gray_u8.dim() == 2
    g = (gray_u8[None] if single else gray_u8).to(torch.int32)
    dx = conv3x3(g, _SOBEL_X)
    dy = conv3x3(g, _SOBEL_Y)
    m = dx.abs() + dy.abs()
    if valid_hw is not None:
        h, w = (torch.as_tensor(v, device=g.device).reshape(-1, 1, 1)
                for v in valid_hw)
        rows = torch.arange(m.shape[-2], device=g.device)[None, :, None]
        cols = torch.arange(m.shape[-1], device=g.device)[None, None, :]
        m = torch.where((rows < h) & (cols < w), m, 0)

    ax = dx.abs()
    ay = dy.abs() << 15
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << 16)
    horiz = ay < tg22x
    vert = ay > tg67x
    s_pos = (dx ^ dy) < 0

    def sh(dy_, dx_):
        return _shift_zero(m, dy_, dx_)

    # OpenCV tie-breaking: strictly greater than one neighbour, >= the other
    nms_h = (m > sh(0, -1)) & (m >= sh(0, 1))
    nms_v = (m > sh(-1, 0)) & (m >= sh(1, 0))
    nms_d1 = (m > sh(-1, -1)) & (m > sh(1, 1))
    nms_d2 = (m > sh(-1, 1)) & (m > sh(1, -1))
    keep = torch.where(horiz, nms_h,
                       torch.where(vert, nms_v,
                                   torch.where(s_pos, nms_d2, nms_d1)))
    cand = (m > low) & keep
    strong = cand & (m > high)
    weak = cand & ~strong
    e = _hysteresis(strong.to(torch.float32), weak.to(torch.float32),
                    hysteresis_iters).to(torch.int32)
    return e[0] if single else e
