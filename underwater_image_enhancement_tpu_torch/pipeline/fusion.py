"""Ancuti-style multi-scale fusion enhancement.

Counterpart of the JAX package's ``pipeline/fusion.py`` (Ancuti et al.,
"Enhancing Underwater Images and Videos by Fusion", CVPR 2012):

1. input 1: gray-world white balance (channel means equalised to the mean
   of the three, clipped to [0, 1]);
2. input 2: the LAB-L CLAHE roundtrip of input 1 (clip 2, 8x8 tiles): the
   forward LAB (K1), CLAHE apply (K2) and the inverse LAB (K3) on the card;
3. weight maps of each input: Laplacian contrast, RGB saturation and
   Achanta saliency (|| blur(Lab) - mean(Lab) ||), normalised with a +0.1
   regulariser;
4. the pyramid blend (``ops/pyramid.blend_pyramids``), at most 5 levels.

The JAX function is jitted, and the port repeats that program's arithmetic
where its last bit matters: the gray-world means, which CLAHE quantises to
u8, are ``reduce.xla_mean`` (XLA:CPU's summation order, times the
reciprocal of the count), so the gray-world planes equal the JAX
program's bit for bit; a division by a traced value stays IEEE
(``layout.div``).  The saliency weights are never quantised: their Lab
means are one ``torch.mean`` an image, and their Lab the colour module's
sRGB curve and Lab f; fusion's own literal divisions (``/ 3.0``,
``/ white``, ``/ 100.0``) are multiplies by the f32 reciprocal, as XLA
rewrites them.

``(B, H, W, 3)`` inputs run as one batch (the JAX function vmaps): the LAB
conversions fold the batch into rows, CLAHE runs once an image, and each
image equals the single-image call bit for bit.  Everything runs on the
input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops import lab_tables as lt
from underwater_image_enhancement_tpu_torch.ops import pyramid
from underwater_image_enhancement_tpu_torch.ops.colorspace import (
    _lab_f,
    _srgb_to_linear,
)
from underwater_image_enhancement_tpu_torch.ops.edges import laplacian
from underwater_image_enhancement_tpu_torch.ops.histeq import (
    clahe_enhancement_planes,
)
from underwater_image_enhancement_tpu_torch.ops.layout import div
from underwater_image_enhancement_tpu_torch.ops.stretch import (
    gray_world_white_balance_planes,
)

_W_EPS = 0.1  # Ancuti's weight regulariser delta
_f32 = np.float32


def _recip(d: float) -> float:
    """f32(1 / d): XLA's rewrite of a division by the literal ``d``."""
    return float(_f32(1.0) / _f32(d))


def gray_world_wb_planes(p):
    """Gray-world white balance of (r, g, b) planes (..., H, W): each
    channel scaled so that its mean matches the mean of the three channel
    means, clipped to [0, 1] (``stretch.gray_world_white_balance_planes``,
    the same arithmetic)."""
    return gray_world_white_balance_planes(p)


def gray_world_wb(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) [0, 1] -> the gray-world balanced image."""
    return torch.stack(gray_world_wb_planes(tuple(img[..., c]
                                                  for c in range(3))), dim=-1)


def _lab_float(p):
    """Continuous Lab of [0, 1] RGB planes: L in [0, 100], a and b near 0."""
    lin = [_srgb_to_linear(c) for c in p]
    m = lt.RGB2XYZ_F32
    white = (0.950456, 1.0, 1.088754)
    f = []
    for row in range(3):
        xyz = (lin[0] * float(m[row, 0]) + lin[1] * float(m[row, 1])
               + lin[2] * float(m[row, 2])) * _recip(white[row])
        f.append(_lab_f(xyz))
    L = 116.0 * f[1] - 16.0
    a = 500.0 * (f[0] - f[1])
    b = 200.0 * (f[1] - f[2])
    return L, a, b


def _plane_means(planes):
    """Means over (H, W) of same-shape planes (..., H, W) -> (..., P): one
    reduction an image, over its planes stacked into a fresh tensor, so
    that a batch equals its single frames bit for bit (the card's
    reduction order depends on the number of outputs and on the
    alignment of the data)."""
    flat = [p.reshape((-1,) + p.shape[-2:]) for p in planes]
    means = torch.stack([torch.stack([p[n] for p in flat]).mean(dim=(-2, -1))
                         for n in range(flat[0].shape[0])])
    return means.reshape(planes[0].shape[:-2] + (len(planes),))


def _weight_maps_all(inputs):
    """Laplacian contrast + saturation + saliency weights of each (r, g, b)
    input; one mean reduction an image serves every input's Lab means."""
    labs = [_lab_float(p) for p in inputs]
    means = _plane_means([c for lab in labs for c in lab])   # (..., 6)
    out = []
    for k, (p, (L, a, b)) in enumerate(zip(inputs, labs)):
        lum = 0.299 * p[0] + 0.587 * p[1] + 0.114 * p[2]
        w_contrast = torch.abs(laplacian(lum, ksize=1))
        d = [c - lum for c in p]
        w_sat = torch.sqrt((d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
                           * _recip(3.0))
        mL, ma, mb = (means[..., 3 * k + i, None, None] for i in range(3))
        dL = pyramid.blur5(L) - mL
        da = pyramid.blur5(a) - ma
        db = pyramid.blur5(b) - mb
        w_sal = torch.sqrt(dL * dL + da * da + db * db)
        # saliency lives on a [0, 100]-ish scale: / 100 to [0, 1]
        out.append(w_contrast + w_sat + w_sal * _recip(100.0))
    return out


def _fusion_levels(H: int, W: int) -> int:
    levels = 1
    while min(H, W) >> levels >= 16 and levels < 5:
        levels += 1
    return levels


def ancuti_fusion(img) -> torch.Tensor:
    """(H, W, 3) or (B, H, W, 3) [0, 1] f32 -> the fused enhancement, on
    the input's device (a numpy array runs on the CPU)."""
    img = torch.as_tensor(img, dtype=torch.float32)
    p = tuple(img[..., c].contiguous() for c in range(3))
    wb = gray_world_wb_planes(p)
    cl = clahe_enhancement_planes(wb, 2.0, 8, 8)

    w1, w2 = _weight_maps_all([wb, cl])
    norm = w1 + w2 + 2.0 * _W_EPS
    w1n = div(w1 + _W_EPS, norm)
    w2n = div(w2 + _W_EPS, norm)

    H, W = p[0].shape[-2:]
    levels = _fusion_levels(H, W)
    weights = torch.stack([w1n, w2n])                       # (2, ..., H, W)
    inputs = torch.stack([torch.stack(wb, dim=-3),
                          torch.stack(cl, dim=-3)])          # (2, ..., 3, H, W)
    fused = pyramid.blend_pyramids(inputs, weights, levels)  # (..., 3, H, W)
    return torch.clamp(torch.movedim(fused, -3, -1), 0.0, 1.0)
