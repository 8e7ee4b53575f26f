"""CLAHE with OpenCV-compatible integer semantics (cv2.createCLAHE).

Counterpart of the JAX package's ``ops/histeq.py`` for the ``six`` exact
tier: REFLECT_101 padding to tile multiples, integer tile histograms, clip
and redistribution with OpenCV's residual stepping, round-half-even LUTs
(tensor ops), then the per-pixel LUT blend in the CLAHE-apply kernel
(``kernels.clahe_apply``).  Bit-exact against cv2 on u8 planes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops import colorspace as cs
from underwater_image_enhancement_tpu_torch.ops import kernels


def _reflect101_index(n: int, n_out: int) -> np.ndarray:
    """Source indices of a REFLECT_101 extension of length n to n_out."""
    i = np.arange(n_out)
    if n == 1:
        return np.zeros(n_out, np.int64)
    period = 2 * (n - 1)
    i = i % period
    return np.where(i < n, i, period - i)


class ClaheGeometry(NamedTuple):
    th: int
    tw: int
    pt: int
    plf: int
    tiles_x: int
    tiles_y: int


def _geometry(H: int, W: int, tiles_x: int, tiles_y: int) -> ClaheGeometry:
    th, tw = -(-H // tiles_y), -(-W // tiles_x)
    return ClaheGeometry(th, tw, th // 2, tw // 2, tiles_x, tiles_y)


def _clahe_weights(geo: ClaheGeometry):
    """OpenCV's f32 interpolation fractions in the half-tile-padded band
    frame: index 0 is crop coordinate -pt (resp. -plf).  Host numpy f32,
    exactly the JAX package's _clahe_prep arithmetic."""
    f32 = np.float32
    by, bx = geo.tiles_y + 1, geo.tiles_x + 1
    tyf = (np.arange(-geo.pt, by * geo.th - geo.pt, dtype=f32)
           * f32(1.0 / geo.th) - f32(0.5)).astype(f32)
    txf = (np.arange(-geo.plf, bx * geo.tw - geo.plf, dtype=f32)
           * f32(1.0 / geo.tw) - f32(0.5)).astype(f32)
    return (tyf - np.floor(tyf)).astype(f32), (txf - np.floor(txf)).astype(f32)


def _clahe_luts(x: torch.Tensor, geo: ClaheGeometry, clip_limit: float):
    """Per-tile CLAHE LUTs of the REFLECT_101-padded plane x (th*tiles_y,
    tw*tiles_x) int32 -> (T, 256) int32, OpenCV integer arithmetic."""
    ty, tx, th, tw = geo.tiles_y, geo.tiles_x, geo.th, geo.tw
    T = ty * tx
    area = th * tw
    tiles = x.reshape(ty, th, tx, tw).permute(0, 2, 1, 3).reshape(T, area)
    tile_id = torch.arange(T, device=x.device)[:, None] * 256
    hist = torch.bincount((tiles + tile_id).reshape(-1).long(),
                          minlength=T * 256).reshape(T, 256).to(torch.int32)
    clip = max(int(clip_limit * area / 256.0), 1)
    clipped = torch.clamp(hist, max=clip)
    excess = (hist - clipped).sum(dim=1, dtype=torch.int32)
    redist = excess // 256
    residual = excess - redist * 256
    clipped = clipped + redist[:, None]
    # OpenCV residual loop: bins 0, step, 2*step, ... get +1 until the
    # residual is spent, step = max(256 // residual, 1)
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)[:, None]
    bins = torch.arange(256, device=x.device, dtype=torch.int32)[None, :]
    hits = (bins % step == 0) & (bins // step < residual[:, None])
    clipped = clipped + hits.to(torch.int32)
    cdf = torch.cumsum(clipped, dim=1).to(torch.float32)
    lut = torch.round(cdf * (255.0 / float(area)))
    return torch.clamp(lut, 0, 255).to(torch.int32).contiguous()


def clahe_prep(channel_u8: torch.Tensor, clip_limit: float,
               tiles_x: int, tiles_y: int):
    """The front half of CLAHE on a u8-valued int32 plane (H, W): the
    REFLECT_101 pad to tile multiples, the (T, 256) tile LUTs and the band
    frame's f32 weights -> (luts, ya, xa, geometry), the arguments of
    ``kernels.clahe_apply`` after the plane."""
    H, W = channel_u8.shape
    dev = channel_u8.device
    geo = _geometry(H, W, tiles_x, tiles_y)
    if (geo.th * tiles_y, geo.tw * tiles_x) == (H, W):
        x = channel_u8
    else:
        rows = _reflect101_index(H, geo.th * tiles_y)
        cols = _reflect101_index(W, geo.tw * tiles_x)
        x = channel_u8[torch.as_tensor(rows, device=dev)][
            :, torch.as_tensor(cols, device=dev)]
    luts = _clahe_luts(x, geo, clip_limit)
    ya, xa = (torch.as_tensor(w).to(dev) for w in _clahe_weights(geo))
    return luts, ya, xa, geo


def clahe_u8(channel_u8: torch.Tensor, clip_limit: float = 2.0,
             tiles_x: int = 8, tiles_y: int = 8) -> torch.Tensor:
    """cv2 CLAHE on a u8-valued int32 plane (H, W), bit-exact."""
    luts, ya, xa, geo = clahe_prep(channel_u8, clip_limit, tiles_x, tiles_y)
    return kernels.clahe_apply(channel_u8.contiguous(), luts, ya, xa, *geo)


def clahe_enhancement_planes(planes, clip_limit: float = 2.0,
                             tiles_x: int = 8, tiles_y: int = 8,
                             gamma: float | None = None):
    """LAB-L CLAHE roundtrip on (r, g, b) f32 unit planes -> same, bit-exact
    vs cv2 on the u8 grid.  ``gamma`` folds a trailing ``out**gamma`` into
    the inverse-LAB kernel's epilogue (a 256-entry LUT)."""
    L, a, b = cs.rgb_unit_to_lab_planes(*planes)
    L = clahe_u8(L, clip_limit, tiles_x, tiles_y)
    if gamma is not None:
        return cs.lab_to_rgb_unit_gamma_planes(L, a, b, gamma)
    return cs.lab_to_rgb_unit_planes(L, a, b)
