"""Uniform LBP and GLCM texture statistics, skimage-compatible.

Counterpart of the JAX package's ``ops/texture.py`` (the texture features,
feature_extraction.py:79-120):

- ``lbp_uniform_hist``: local_binary_pattern(P=8, R=1, 'uniform') with
  bilinear samples at (-sin(2 pi k/8), cos(2 pi k/8)), 0 outside the plane,
  bit k set where sample >= centre; label = popcount where the circular
  pattern has at most 2 transitions, else 9; a 10-bin density histogram.
  The sample keeps the JAX difference form ``s00 + fr*(s10 - s00) + fc*(s01
  - s00) + fr*fc*(s11 - s10 - s01 + s00)``, exactly s00 in flat regions;
  the product form flips ``sample >= centre`` ties.
- ``glcm_props``: graycomatrix(distance 1, angles 0, pi/4, pi/2, 3pi/4,
  levels 256, symmetric, normed) from an exact integer count of the 65536
  pair bins, then graycoprops' contrast, dissimilarity, homogeneity,
  energy, correlation and ASM.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_GLCM_OFFSETS = ((0, 1), (1, 1), (1, 0), (1, -1))  # angles 0, pi/4, pi/2, 3pi/4


def _shift0(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """out[i, j] = x[i + dr, j + dc], 0 outside (|dr|, |dc| <= 2)."""
    H, W = x.shape
    xp = F.pad(x, (2, 2, 2, 2))
    return xp[2 + dr:2 + dr + H, 2 + dc:2 + dc + W]


def _sample_shift(x: torch.Tensor, dr: float, dc: float) -> torch.Tensor:
    """x bilinearly sampled at (r + dr, c + dc), 0 outside."""
    if abs(dr - round(dr)) < 1e-6 and abs(dc - round(dc)) < 1e-6:
        return _shift0(x, int(round(dr)), int(round(dc)))
    r0, c0 = int(np.floor(dr)), int(np.floor(dc))
    fr, fc = dr - r0, dc - c0
    s00 = _shift0(x, r0, c0)
    s01 = _shift0(x, r0, c0 + 1)
    s10 = _shift0(x, r0 + 1, c0)
    s11 = _shift0(x, r0 + 1, c0 + 1)
    return (s00 + fr * (s10 - s00) + fc * (s01 - s00)
            + (fr * fc) * (s11 - s10 - s01 + s00))


def lbp_uniform_hist(gray_u8: torch.Tensor) -> torch.Tensor:
    """Uniform LBP (P=8, R=1) 10-bin density histogram of a u8-valued
    (H, W) plane -> (10,) f32."""
    x = gray_u8.to(torch.float32)
    P = 8
    bits = []
    for k in range(P):
        angle = 2.0 * np.pi * k / P
        dr, dc = -np.sin(angle), np.cos(angle)
        dr = 0.0 if abs(dr) < 1e-9 else float(dr)
        dc = 0.0 if abs(dc) < 1e-9 else float(dc)
        bits.append((_sample_shift(x, dr, dc) >= x).to(torch.int32))
    b = torch.stack(bits)
    ones = b.sum(0)
    trans = (b - torch.roll(b, 1, dims=0)).abs().sum(0)
    label = torch.where(trans <= 2, ones, P + 1)
    hist = torch.zeros(P + 2, dtype=torch.int32, device=x.device)
    hist.scatter_add_(0, label.reshape(-1).long(),
                      torch.ones(label.numel(), dtype=torch.int32,
                                 device=x.device))
    # / (H * W) as jitted XLA computes it: times the f32 reciprocal
    return hist.to(torch.float32) * float(np.float32(1.0)
                                          / np.float32(label.numel()))


def _glcm(gray_u8: torch.Tensor) -> torch.Tensor:
    """(4, 256, 256) symmetric normalised co-occurrence matrices, one per
    offset of ``_GLCM_OFFSETS``."""
    H, W = gray_u8.shape
    g = gray_u8.long()
    keys = []
    for k, (dr, dc) in enumerate(_GLCM_OFFSETS):
        r0, r1 = max(0, -dr), H - max(0, dr)
        c0, c1 = max(0, -dc), W - max(0, dc)
        a = g[r0:r1, c0:c1].reshape(-1)
        b = g[r0 + dr:r1 + dr, c0 + dc:c1 + dc].reshape(-1)
        keys.append(k * 65536 + a * 256 + b)
    key = torch.cat(keys)
    counts = torch.zeros(4 * 65536, dtype=torch.int32, device=g.device)
    counts.scatter_add_(0, key, torch.ones(key.numel(), dtype=torch.int32,
                                           device=g.device))
    p = counts.reshape(4, 256, 256)
    p = (p + p.transpose(1, 2)).to(torch.float32)
    return p / p.sum(dim=(1, 2), keepdim=True)


def glcm_props(gray_u8: torch.Tensor) -> torch.Tensor:
    """graycoprops over the 4 angles of a u8-valued (H, W) plane -> (6, 4)
    f32, rows contrast, dissimilarity, homogeneity, energy, correlation,
    ASM."""
    p = _glcm(gray_u8)
    i = torch.arange(256, dtype=torch.float32, device=p.device)[:, None]
    j = torch.arange(256, dtype=torch.float32, device=p.device)[None, :]
    diff = i - j

    def total(v):
        return v.sum(dim=(1, 2))

    contrast = total(p * diff ** 2)
    dissim = total(p * diff.abs())
    homog = total(p / (1.0 + diff ** 2))
    asm = total(p * p)
    mu_i = total(p * i)[:, None, None]
    mu_j = total(p * j)[:, None, None]
    s_i = torch.sqrt(total(p * (i - mu_i) ** 2))
    s_j = torch.sqrt(total(p * (j - mu_j) ** 2))
    corr = torch.where((s_i < 1e-15) | (s_j < 1e-15), 1.0,
                       total(p * (i - mu_i) * (j - mu_j)) / (s_i * s_j))
    return torch.stack([contrast, dissim, homog, torch.sqrt(asm), corr, asm])
