"""3x3 correlation, Sobel, Laplacian and cv2.Canny (aperture 3, L1
gradient).

Counterpart of the JAX package's ``ops/edges.py``: ``sobel`` and
``laplacian`` correlate float planes under BORDER_REFLECT_101 (cv2's
default), summing the nonzero taps in the JAX loop order; Canny takes
Sobel with a REPLICATE border, OpenCV's integer non-maximum-suppression
sectors (TG22 = 13573 in Q15) and tie-breaking, double threshold, and
hysteresis bounded to a fixed number of 8-connected dilation rounds (64 by
default), which the JAX
package runs row-packed: here the hysteresis kernel
(``kernels.hysteresis_propagate``, the same ``e | (weak & dilate8(e))``
recurrence), so the edge maps are bit-equal.  Planes may carry a leading
batch dimension.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from underwater_image_enhancement_tpu_torch.ops import kernels

_SOBEL_X = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
_SOBEL_Y = [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]
_TG22 = 13573  # tan(22.5 deg) in Q15, as in OpenCV canny.cpp


_LAP_K1 = [[0, 1, 0], [1, -4, 1], [0, 1, 0]]
_LAP_K3 = [[2, 0, 2], [0, -8, 0], [2, 0, 2]]


def _border_index(n: int, mode: str, device) -> torch.Tensor:
    """Source indices of positions -1..n under ``mode``: "edge" clamps
    (BORDER_REPLICATE), "reflect" mirrors without repeating the edge
    (BORDER_REFLECT_101, ``jnp.pad``'s reflect; a length-1 axis repeats)."""
    i = torch.arange(-1, n + 1, device=device)
    if mode == "reflect":
        i = torch.where(i < 0, -i, torch.where(i > n - 1, 2 * (n - 1) - i, i))
    elif mode != "edge":
        raise ValueError(f"unknown border mode {mode!r}")
    return torch.clamp(i, 0, n - 1)


def conv3x3(x: torch.Tensor, kernel, mode: str = "reflect") -> torch.Tensor:
    """Correlate x (..., H, W) with a 3x3 kernel (nested lists) under cv2
    border semantics, ``mode`` "reflect" (BORDER_REFLECT_101) or "edge"
    (BORDER_REPLICATE): the nonzero taps' shifted products summed in the
    JAX package's order."""
    H, W = x.shape[-2], x.shape[-1]
    xp = (x.index_select(-2, _border_index(H, mode, x.device))
          .index_select(-1, _border_index(W, mode, x.device)))
    out = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            k = kernel[dy + 1][dx + 1]
            if k == 0:
                continue
            term = xp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W] * k
            out = term if out is None else out + term
    return out


def sobel(x: torch.Tensor, axis: str, mode: str = "reflect") -> torch.Tensor:
    """cv2.Sobel(ksize=3) derivative along "x" (columns) or "y" (rows)."""
    return conv3x3(x, _SOBEL_X if axis == "x" else _SOBEL_Y, mode)


def laplacian(x: torch.Tensor, ksize: int = 1) -> torch.Tensor:
    """cv2.Laplacian, BORDER_REFLECT_101: ksize 1 the 4-neighbour kernel,
    ksize 3 [[2, 0, 2], [0, -8, 0], [2, 0, 2]]."""
    if ksize not in (1, 3):
        raise ValueError(f"laplacian: ksize must be 1 or 3, got {ksize}")
    return conv3x3(x, _LAP_K1 if ksize == 1 else _LAP_K3, "reflect")


def _shift_zero(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., i, j] = x[..., i+dy, j+dx], zero outside."""
    H, W = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (1, 1, 1, 1))
    return xp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def canny_u8(gray_u8: torch.Tensor, low: int = 50, high: int = 150,
             hysteresis_iters: int = 64, use_pallas="auto",
             valid_hw=None, valid_rows=None) -> torch.Tensor:
    """cv2.Canny(gray, low, high) on u8-valued int planes (H, W) or
    (N, H, W) -> int32 {0, 1} edge map of the same shape.

    use_pallas is the JAX choice between its hysteresis kernel and the
    row-packed XLA loop, which give the same bits; here the hysteresis is
    kernel K7 on a CUDA tensor and its plain version on a CPU one for every
    value.

    valid_hw=(h, w), ints or (N,) int tensors, restricts each plane to its
    top-left (h, w) region: with row h-1 and column w-1 replicated beyond
    it, zeroing the gradient magnitude outside makes the result inside
    exactly cv2.Canny of the (h, w) crop and zero outside (see the JAX
    package's canny_u8).

    valid_rows=(r0, r1), ints or 0-d int tensors, is the row-band analog
    for the halo'd blocks of a row-sharded plane (``parallel/six_spatial``):
    with rows r0 and r1-1 replicated beyond the band, zeroing the gradient
    magnitude outside rows [r0, r1) makes the result inside exactly those
    rows of the whole plane's Canny."""
    if use_pallas not in ("auto", True, False):
        raise ValueError(f"canny_u8: use_pallas must be 'auto', True or "
                         f"False, got {use_pallas!r}")
    single = gray_u8.dim() == 2
    g = (gray_u8[None] if single else gray_u8).to(torch.int32)
    dx = conv3x3(g, _SOBEL_X, "edge")
    dy = conv3x3(g, _SOBEL_Y, "edge")
    m = dx.abs() + dy.abs()
    if valid_hw is not None:
        h, w = (torch.as_tensor(v, device=g.device).reshape(-1, 1, 1)
                for v in valid_hw)
        rows = torch.arange(m.shape[-2], device=g.device)[None, :, None]
        cols = torch.arange(m.shape[-1], device=g.device)[None, None, :]
        m = torch.where((rows < h) & (cols < w), m, 0)
    if valid_rows is not None:
        r0, r1 = valid_rows
        rows = torch.arange(m.shape[-2], device=g.device)[None, :, None]
        m = torch.where((rows >= r0) & (rows < r1), m, 0)

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
    e = kernels.hysteresis_propagate(strong.to(torch.int32),
                                     weak.to(torch.int32), hysteresis_iters)
    return e[0] if single else e


def canny_unit(img_gray_unit: torch.Tensor, low: int = 50,
               high: int = 150) -> torch.Tensor:
    """Canny of a [0, 1] gray plane through the reference's (g*255).u8
    quantisation."""
    g = torch.clamp(img_gray_unit * 255.0, 0, 255).to(torch.int32)
    return canny_u8(g, low, high)
