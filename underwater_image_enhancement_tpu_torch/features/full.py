"""The 79-value hand-crafted feature vector (feature_extraction.py:16-297).

Counterpart of the JAX package's ``features/full.py``:

  colour   (35): LAB u8 stats (mean, std, skew, kurtosis x 3), HSV u8
                 (mean, std x 3), the colour-cast block (CCF, M, D, mean a,
                 mean b), RGB float stats (mean, std, min, max x 3)
  texture  (22): uniform LBP 10-bin density + GLCM on the 128x128 resize
                 (6 props, mean and std over 4 angles)
  frequency (5): DCT band energies (low, mid, high), mean and std of |DCT|
  edges     (7): Sobel magnitude mean, std, max; Canny density;
                 Laplacian(ksize 3) abs-mean, std, var
  quality  (10): gray std, entropy, mean, median, p25, p75, range,
                 saturation mean and std, RMS contrast

The exact tier takes LAB from kernel K1b (``kernels.lab_forward_u8``), the
fast tier from the arithmetic conversion.  Moments are population ones
(``correction=0``) and scipy's skew and Fisher kurtosis, with the JAX
guards (``m2 > 0``, a 1e-30 floor).  Every value stays on the device until
the caller reads the vector.
"""

from __future__ import annotations

import torch

from underwater_image_enhancement_tpu_torch.ops import colorspace as cs
from underwater_image_enhancement_tpu_torch.ops import stretch
from underwater_image_enhancement_tpu_torch.ops.dct import dct2
from underwater_image_enhancement_tpu_torch.ops.edges import (
    canny_u8,
    laplacian,
    sobel,
)
from underwater_image_enhancement_tpu_torch.ops.histeq import shannon_entropy_u8
from underwater_image_enhancement_tpu_torch.ops.resize import resize_u8
from underwater_image_enhancement_tpu_torch.ops.texture import (
    glcm_props,
    lbp_uniform_hist,
)

FEATURE_DIM = 79


def _std(x: torch.Tensor) -> torch.Tensor:
    return torch.std(x, correction=0)


def _skew(x: torch.Tensor) -> torch.Tensor:
    m = x.mean()
    m2 = ((x - m) ** 2).mean()
    m3 = ((x - m) ** 3).mean()
    return torch.where(m2 > 0, m3 / torch.clamp(m2, min=1e-30) ** 1.5, 0.0)


def _kurtosis(x: torch.Tensor) -> torch.Tensor:
    m = x.mean()
    m2 = ((x - m) ** 2).mean()
    m4 = ((x - m) ** 4).mean()
    return torch.where(m2 > 0, m4 / torch.clamp(m2, min=1e-30) ** 2 - 3.0, -3.0)


def _color_features(planes, lab_f, hsv_f):
    """feature_extraction.py:16-77 (35 values)."""
    feats = []
    for ch in lab_f:
        feats += [ch.mean(), _std(ch), _skew(ch), _kurtosis(ch)]
    for ch in hsv_f:
        feats += [ch.mean(), _std(ch)]
    a, b = lab_f[1], lab_f[2]
    mean_a, mean_b = a.mean(), b.mean()
    M = torch.sqrt(mean_a ** 2 + mean_b ** 2)
    Da = (a - mean_a).abs().mean()
    Db = (b - mean_b).abs().mean()
    D = torch.sqrt(Da ** 2 + Db ** 2)
    feats += [M / (D + 1e-10), M, D, mean_a, mean_b]
    for ch in planes:
        feats += [ch.mean(), _std(ch), ch.min(), ch.max()]
    return feats


def _texture_features(gray_u8):
    """feature_extraction.py:79-120 (22 values)."""
    lbp = lbp_uniform_hist(gray_u8)
    props = glcm_props(resize_u8(gray_u8, 128, 128))  # (6, 4)
    feats = [lbp[i] for i in range(10)]
    for p in range(6):
        feats += [props[p].mean(), _std(props[p])]
    return feats


def _frequency_features(gray255):
    """feature_extraction.py:122-158 (5 values); gray255: the u8 gray as
    f32."""
    d = dct2(gray255)
    H, W = d.shape
    total = (d ** 2).sum()
    low = (d[:H // 4, :W // 4] ** 2).sum() / total
    mid = (d[H // 4:H // 2, W // 4:W // 2] ** 2).sum() / total
    high = (d[H // 2:, W // 2:] ** 2).sum() / total
    ad = d.abs()
    return [low, mid, high, ad.mean(), _std(ad)]


def _edge_features(gray_unit, gray_u8):
    """feature_extraction.py:160-200 (7 values)."""
    gx = sobel(gray_unit, "x")
    gy = sobel(gray_unit, "y")
    mag = torch.sqrt(gx ** 2 + gy ** 2)
    edges = canny_u8(gray_u8, 50, 150)
    lap = laplacian(gray_u8.to(torch.float32), ksize=3)
    return [mag.mean(), _std(mag), mag.max(),
            edges.to(torch.float32).mean(),
            lap.abs().mean(), _std(lap), torch.var(lap, correction=0)]


def _quality_features(gray_unit, gray_u8, hsv_unit_s):
    """feature_extraction.py:202-246 (10 values)."""
    g = gray_unit.reshape(-1)
    mean = g.mean()
    p50, p25, p75 = stretch.percentiles(g, (50.0, 25.0, 75.0))
    return [_std(g), shannon_entropy_u8(gray_u8), mean, p50, p25, p75,
            g.max() - g.min(), hsv_unit_s.mean(), _std(hsv_unit_s),
            torch.sqrt(((g - mean) ** 2).mean())]


def extract_all_features(img: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """(H, W, 3) f32 image in [0, 1] -> (79,) f32 features on its device.
    ``fast``: LAB from the arithmetic conversion (the throughput tier)."""
    planes = tuple(img[..., c] for c in range(3))
    u8 = tuple(cs.quantize_u8(p).contiguous() for p in planes)
    if fast:
        lab_f = cs.rgb_to_lab_u8_arith_planes(*u8)
    else:
        lab_f = tuple(c.to(torch.float32)
                      for c in cs.rgb_to_lab_u8_exact_planes(*u8))
    hsv_f = tuple(c.to(torch.float32) for c in cs.rgb_to_hsv_u8_planes(*u8))
    gray_u8 = cs.gray_u8_planes(*u8)
    gray_unit = cs.u8_to_unit(gray_u8)
    feats = (_color_features(planes, lab_f, hsv_f)
             + _texture_features(gray_u8)
             + _frequency_features(gray_u8.to(torch.float32))
             + _edge_features(gray_unit, gray_u8)
             + _quality_features(gray_unit, gray_u8, hsv_f[1] * cs.INV_255))
    return torch.stack(feats).to(torch.float32)


def extract_batch(imgs: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """(B, H, W, 3) -> (B, 79)."""
    return torch.stack([extract_all_features(im, fast) for im in imgs])
