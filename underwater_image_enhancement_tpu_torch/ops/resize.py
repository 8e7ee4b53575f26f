"""cv2.resize(INTER_LINEAR) on u8 planes, bit-exact fixed point.

Counterpart of the JAX package's ``ops/resize.py`` ``resize_u8`` (the GLCM
features' 128x128 downscale): cv2's source coordinate ``(float)((dx + 0.5)
* scale - 0.5)`` rounded to f32 before floor and fraction, weights
quantized to 2^-11 (round half to even), a horizontal pass in int32 with
single-tap border columns, then cv2's 8U vertical descale (each tap's
``(beta * (row >> 4)) >> 16`` summed, + 2, >> 2) with clamped border rows
that keep their fractional weights.  Integer arithmetic throughout, so
every device gives the same bytes.  ``resize_bilinear`` is the JAX
float form: two f32 interpolation matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _frac_f32(dst: int, src: int):
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s.astype(np.float32)


def _quant11(frac):
    """f32 (1 - f) * 2048 and f * 2048, cvRound (half to even)."""
    one, sc = np.float32(1.0), np.float32(2048.0)
    a0 = np.rint(((one - frac) * sc).astype(np.float32)).astype(np.int32)
    a1 = np.rint((frac * sc).astype(np.float32)).astype(np.int32)
    return a0, a1


def _coeffs_h(dst: int, src: int):
    """Horizontal taps (s0, s1) and weights: border columns collapse to one
    full-weight tap (cv2's HResize xmax handling); a 1-pixel source
    replicates."""
    if src == 1:
        z = np.zeros(dst, np.int64)
        return z, z, np.full(dst, 2048, np.int32), np.zeros(dst, np.int32)
    s, frac = _frac_f32(dst, src)
    frac = np.where(s < 0, np.float32(0.0), frac)
    s = np.maximum(s, 0)
    frac = np.where(s >= src - 1, np.float32(1.0), frac)
    s = np.minimum(s, src - 2)
    a0, a1 = _quant11(frac)
    return s, s + 1, a0, a1


def _coeffs_v(dst: int, src: int):
    """Vertical taps: rows clamped into range, fractional weights kept."""
    s, frac = _frac_f32(dst, src)
    a0, a1 = _quant11(frac)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), a0, a1


@functools.lru_cache(maxsize=None)
def _coeffs(H: int, W: int, out_h: int, out_w: int, device: torch.device):
    """The taps and weights of one resize on ``device``, copied once (a
    copy from host memory would wait for the device at every call)."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _coeffs_h(out_w, W) + _coeffs_v(out_h, H))


def resize_u8(img_u8: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize INTER_LINEAR of a u8-valued int plane (H, W) -> int32
    (out_h, out_w), bit-exact."""
    H, W = img_u8.shape
    sx0, sx1, ax0, ax1, sy0, sy1, ay0, ay1 = _coeffs(H, W, out_h, out_w,
                                                     img_u8.device)
    s = img_u8.to(torch.int32)
    rp = s[:, sx0] * ax0 + s[:, sx1] * ax1                   # (H, out_w)
    r0, r1 = rp[sy0], rp[sy1]
    v = (((ay0[:, None] * (r0 >> 4)) >> 16)
         + ((ay1[:, None] * (r1 >> 4)) >> 16) + 2) >> 2
    return torch.clamp(v, 0, 255)


def _interp_matrix(dst: int, src: int) -> np.ndarray:
    """(dst, src) row-interpolation operator, cv2 INTER_LINEAR mapping."""
    scale = src / dst
    x = (np.arange(dst) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    frac = x - x0
    x0c = np.clip(x0, 0, src - 1)
    x1c = np.clip(x0 + 1, 0, src - 1)
    m = np.zeros((dst, src), np.float32)
    m[np.arange(dst), x0c] += (1.0 - frac).astype(np.float32)
    m[np.arange(dst), x1c] += frac.astype(np.float32)
    return m


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W) or (H, W, C) float -> (out_h, out_w[, C]), cv2 INTER_LINEAR
    as two f32 interpolation matrices (the JAX package's formulation; the
    matrix products sum in another order than XLA's)."""
    H, W = img.shape[0], img.shape[1]
    mh = torch.as_tensor(_interp_matrix(out_h, H), device=img.device)
    mw = torch.as_tensor(_interp_matrix(out_w, W), device=img.device)
    if img.ndim == 2:
        return mh @ img @ mw.T
    return torch.einsum("hH,HWc,wW->hwc", mh, img, mw)
