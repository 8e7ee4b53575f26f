"""No-reference image quality: the reference's 8 metrics and their
weighted total (quality_assessment.py:14-286).

Counterpart of the JAX package's ``metrics/quality.py``, on one image's
(r, g, b) f32 unit planes (H, W):

  contrast     std of the u8 gray / 255, / 0.5 * 100
  sharpness    variance of Laplacian(ksize 1) of that gray, / 0.5 * 100
  entropy      Shannon entropy of the u8 gray, (e - 4) / 4 * 100
  saturation   mean HSV S / 255, * 100
  brightness   100 - |mean LAB L - 128| / 128 * 100: L from kernel K4
               (``kernels.lab_forward_l_u8``) on the exact tier, the
               arithmetic L on the fast tier
  edge_density Canny (64 hysteresis rounds, kernel K7) density / 0.2 * 100
  colorfulness Hasler-Suesstrunk on the float planes, / 0.5 * 100
  naturalness  100 - 200 * (oversaturated + too dark + too bright shares)

each clipped to [0, 100].  Standard deviations and variances are
population ones (``correction=0``), as ``jnp.std``/``jnp.var``.  Every
score is a 0-dim tensor on the planes' device: nothing is read back here.
``comprehensive_assessment`` weights with ``get(key, 0)`` like the
reference, so the 6-weight defaults zero colorfulness and naturalness.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops import colorspace as cs
from underwater_image_enhancement_tpu_torch.ops.edges import canny_u8, laplacian
from underwater_image_enhancement_tpu_torch.ops.histeq import shannon_entropy_u8
from underwater_image_enhancement_tpu_torch.utils.config import (
    FULL_QUALITY_WEIGHTS,
)

METRIC_NAMES = (
    "contrast", "sharpness", "entropy", "saturation",
    "brightness", "edge_density", "colorfulness", "naturalness",
)


def _clip100(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, 0.0, 100.0)


def assess_all_planes(planes, needed=None, fast: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """Scores of one image given as (r, g, b) f32 unit planes (H, W):
    all 8, or the metrics named in ``needed``.  ``fast`` computes the
    brightness metric's L with the arithmetic conversion."""
    k = METRIC_NAMES if needed is None else needed
    r, g, b = planes
    r8, g8, b8 = cs.quantize_u8(r), cs.quantize_u8(g), cs.quantize_u8(b)
    gray_u8 = cs.gray_u8_planes(r8, g8, b8)
    gray = cs.u8_to_unit(gray_u8)

    scores = {}
    if "contrast" in k:
        scores["contrast"] = _clip100(torch.std(gray, correction=0) / 0.5 * 100.0)
    if "sharpness" in k:
        lap = laplacian(gray, ksize=1)
        scores["sharpness"] = _clip100(torch.var(lap, correction=0) / 0.5 * 100.0)
    if "entropy" in k:
        scores["entropy"] = _clip100((shannon_entropy_u8(gray_u8) - 4.0) / 4.0
                                     * 100.0)
    if "saturation" in k or "naturalness" in k:
        sat = cs.hsv_s_u8_planes(r8, g8, b8).to(torch.float32) * cs.INV_255
    if "saturation" in k:
        scores["saturation"] = _clip100(sat.mean() * 100.0)
    if "brightness" in k:
        if fast:
            lab_l = cs.rgb_u8_to_lab_l_arith_planes(r8, g8, b8)
        else:
            lab_l = cs.rgb_to_lab_l_u8_exact_planes(r8, g8, b8).to(
                torch.float32)
        dev = (lab_l.mean() - 128.0).abs()
        scores["brightness"] = 100.0 - _clip100(dev / 128.0 * 100.0)
    if "edge_density" in k:
        edges = canny_u8(gray_u8, 50, 150)
        scores["edge_density"] = _clip100(
            edges.to(torch.float32).mean() / 0.2 * 100.0)
    if "colorfulness" in k:
        rg = r - g
        yb = 0.5 * (r + g) - b
        std_rgyb = torch.sqrt(torch.std(rg, correction=0) ** 2
                              + torch.std(yb, correction=0) ** 2)
        mean_rgyb = torch.sqrt(rg.mean() ** 2 + yb.mean() ** 2)
        scores["colorfulness"] = _clip100((std_rgyb + 0.3 * mean_rgyb)
                                          / 0.5 * 100.0)
    if "naturalness" in k:
        unnatural = ((sat > 0.9).to(torch.float32).mean()
                     + (gray < 0.1).to(torch.float32).mean()
                     + (gray > 0.9).to(torch.float32).mean())
        scores["naturalness"] = 100.0 - _clip100(unnatural * 200.0)
    return scores


def assess_all(img: torch.Tensor, needed=None, fast: bool = False
               ) -> Dict[str, torch.Tensor]:
    """``assess_all_planes`` of an (H, W, 3) image."""
    return assess_all_planes(tuple(img[..., c] for c in range(3)),
                             needed=needed, fast=fast)


def comprehensive_assessment(img: torch.Tensor, weights=None):
    """quality_assessment.py:215-286: (weighted total, all 8 scores);
    ``weights`` None is the 8-metric default, missing keys weigh 0."""
    w = FULL_QUALITY_WEIGHTS if weights is None else weights
    scores = assess_all(img)
    total = sum(scores[k] * w.get(k, 0) for k in METRIC_NAMES)
    return total, scores


def comprehensive_planes(planes, weights=None, fast: bool = False
                         ) -> torch.Tensor:
    """Weighted total of one image's planes, 0-dim f32: only the metrics
    of nonzero weight are computed, and the total sums them left to right
    in METRIC_NAMES order with f32 weights (the JAX label program's
    arithmetic)."""
    w = FULL_QUALITY_WEIGHTS if weights is None else weights
    needed = frozenset(k for k in METRIC_NAMES if w.get(k, 0) != 0)
    s = assess_all_planes(planes, needed=needed, fast=fast)
    total = torch.zeros((), dtype=torch.float32, device=planes[0].device)
    for k in METRIC_NAMES:
        if k in needed:
            total = total + s[k] * float(np.float32(w[k]))
    return total


def comprehensive_batch_planes(planes, weights=None, fast: bool = False
                               ) -> torch.Tensor:
    """(r, g, b) planes, each (B, H, W) -> (B,) weighted totals."""
    return torch.stack([
        comprehensive_planes(tuple(p[i] for p in planes), weights, fast)
        for i in range(planes[0].shape[0])])


def comprehensive_batch(imgs: torch.Tensor, weights=None,
                        fast: bool = False) -> torch.Tensor:
    """(B, H, W, 3) -> (B,) weighted totals."""
    return comprehensive_batch_planes(
        tuple(imgs[..., c] for c in range(3)), weights, fast)


def assess_all_vector(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) -> (8,) scores in METRIC_NAMES order."""
    s = assess_all(img)
    return torch.stack([s[k] for k in METRIC_NAMES])


def assess_batch(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, 8)."""
    return torch.stack([assess_all_vector(im) for im in imgs])
