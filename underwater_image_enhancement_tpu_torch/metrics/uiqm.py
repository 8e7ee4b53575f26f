"""UIQM and UCIQE, the no-reference underwater quality metrics.

Counterpart of the JAX package's ``metrics/uiqm.py`` (its docstring gives
the definitions and sources), on (H, W, 3) f32 unit images:

  UIQM  = 0.0282 UICM + 0.2953 UISM + 3.5753 UIConM
  UCIQE = 0.4680 sigma_c + 0.2745 con_l + 0.2576 mu_s

UICM: alpha-trimmed (0.1) mean and variance of R-G and (R+G)/2-B; UISM:
EME over 8x8 blocks of each channel times its Sobel magnitude, weighted
0.299/0.587/0.114; UIConM: |mean| of the entropy-weighted Michelson
contrast over 8x8 blocks of the channel mean.  UCIQE reads the exact u8
LAB (kernel K1b, ``colorspace.rgb_to_lab_u8_exact``) in CIELAB float
scale: sigma_c the std of the chroma / 100, con_l the p99 - p1 range of L
(``np.percentile``'s linear interpolation, indices and weights in f32 as
``jnp.percentile`` computes them) / 100, mu_s the mean HSV S / 255.
Moments are population ones (``correction=0``); the divisions by 100 and
255 are the jitted program's multiplies by the f32 reciprocal.  Every
score is a 0-dim tensor on the image's device.
"""

from __future__ import annotations

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops import colorspace as cs
from underwater_image_enhancement_tpu_torch.ops.edges import sobel
from underwater_image_enhancement_tpu_torch.ops.stretch import percentiles

UIQM_C = (0.0282, 0.2953, 3.5753)
UCIQE_C = (0.4680, 0.2745, 0.2576)
_ALPHA = 0.1
_BLOCK = 8
_EPS = 1e-8
# EME ratio epsilon: near-zero block minima make log(max/min) unstable
# across fp32/fp64; 1e-3 bounds the ratio (part of this metric's spec).
_EME_EPS = 1e-3
_INV_100 = float(np.float32(1.0) / np.float32(100.0))


def _alpha_trimmed_stats(x: torch.Tensor, alpha: float = _ALPHA):
    """Mean and variance of x after trimming the alpha fraction from each
    tail of its sorted values."""
    flat = torch.sort(x.reshape(-1)).values
    n = flat.shape[0]
    lo = int(alpha * n)
    window = flat[lo:n - lo]
    mu = window.mean()
    return mu, ((window - mu) ** 2).mean()


def uicm(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mu_rg, s2_rg = _alpha_trimmed_stats(r - g)
    mu_yb, s2_yb = _alpha_trimmed_stats(0.5 * (r + g) - b)
    return (-0.0268 * torch.sqrt(mu_rg ** 2 + mu_yb ** 2)
            + 0.1586 * torch.sqrt(s2_rg + s2_yb))


def _blocks(x: torch.Tensor, k: int = _BLOCK) -> torch.Tensor:
    """Crop to a multiple of k and reshape to (nb, k*k) blocks."""
    H, W = x.shape
    Hc, Wc = (H // k) * k, (W // k) * k
    return (x[:Hc, :Wc].reshape(Hc // k, k, Wc // k, k)
            .permute(0, 2, 1, 3).reshape(-1, k * k))


def _eme(x: torch.Tensor) -> torch.Tensor:
    """Enhancement measure estimation: mean of 2*log(max/min) over blocks."""
    b = _blocks(x)
    ratio = (b.amax(dim=1) + _EME_EPS) / (b.amin(dim=1) + _EME_EPS)
    return (2.0 * torch.log(ratio)).mean()


def uism(img: torch.Tensor) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=img.device)
    for c, wc in enumerate((0.299, 0.587, 0.114)):
        ch = img[..., c]
        gx, gy = sobel(ch, "x"), sobel(ch, "y")
        total = total + wc * _eme(torch.sqrt(gx * gx + gy * gy) * ch)
    return total


def uiconm(img: torch.Tensor) -> torch.Tensor:
    """logAMEE of the mean intensity (entropy-weighted Michelson contrast)."""
    b = _blocks(img.mean(dim=-1))
    mx, mn = b.amax(dim=1), b.amin(dim=1)
    m = (mx - mn) / (mx + mn + _EPS)
    term = torch.where(m > 0, m * torch.log(torch.clamp(m, min=_EPS)), 0.0)
    return term.mean().abs()


def uiqm(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) f32 in [0, 1] -> 0-dim UIQM."""
    c1, c2, c3 = UIQM_C
    return c1 * uicm(img) + c2 * uism(img) + c3 * uiconm(img)


def uciqe_terms(img: torch.Tensor):
    """UCIQE's (sigma_c, con_l, mu_s) of an (H, W, 3) f32 unit image."""
    u8 = cs.quantize_u8(img)
    lab = cs.rgb_to_lab_u8_exact(u8).to(torch.float32)
    L = lab[..., 0] * (100.0 / 255.0)
    a, b = lab[..., 1] - 128.0, lab[..., 2] - 128.0
    sigma_c = torch.std(torch.sqrt(a * a + b * b), correction=0) * _INV_100
    p1, p99 = percentiles(L, (1.0, 99.0))
    con_l = (p99 - p1) * _INV_100
    sat = cs.hsv_s_u8_planes(u8[..., 0], u8[..., 1], u8[..., 2])
    mu_s = (sat.to(torch.float32) * cs.INV_255).mean()
    return sigma_c, con_l, mu_s


def uciqe(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) f32 in [0, 1] -> 0-dim UCIQE (float CIELAB scale)."""
    k1, k2, k3 = UCIQE_C
    sigma_c, con_l, mu_s = uciqe_terms(img)
    return k1 * sigma_c + k2 * con_l + k3 * mu_s


def uiqm_batch(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B,) UIQM."""
    return torch.stack([uiqm(im) for im in imgs])


def uciqe_batch(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B,) UCIQE."""
    return torch.stack([uciqe(im) for im in imgs])
