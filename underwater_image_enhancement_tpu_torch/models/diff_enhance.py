"""The differentiable enhancement operator of vgg_16_UIE.py:24-128, the
fixed-parameter path of ``enhance``: percentile stretch (sorted-index
percentiles) -> dark-channel dehaze with a constant A = 0.6 -> ``img**gamma``
-> clamp, on NHWC batches.

Counterpart of the JAX package's ``models/diff_enhance.py`` (``enhance_vgg``
and its helpers).  Percentile indices are host f32 arithmetic
(``stretch.order_index``), so per-image parameters come in as numbers or
host arrays.  ``enhance_zoo`` is the six-parameter composite of the zoo
predictors.  The ``quantile`` mode and ``enhance_mlp`` come with the
trainers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops.layout import div
from underwater_image_enhancement_tpu_torch.ops.stretch import (
    _perc_pair_index_u8,
    order_index,
)


def _perc_pair_index(channel: torch.Tensor, l_low: float, l_high: float):
    """vgg_16_UIE.py:57-92: p = sorted[int(L/100*n)] (clamped), by a sort."""
    flat = torch.sort(channel.reshape(-1)).values
    lo, hi = order_index([l_low, l_high], flat.numel())
    return flat[int(lo)], flat[int(hi)]


_PERCENTILES = {"index": _perc_pair_index, "index-u8": _perc_pair_index_u8}


def per_image(v, batch: int) -> np.ndarray:
    """A scalar or per-image parameter -> (batch,) host float32."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.broadcast_to(np.asarray(v, np.float32).reshape(-1),
                           (batch,)).copy()


def color_stretch_batch(img: torch.Tensor, l_low, l_high,
                        mode: str = "index") -> torch.Tensor:
    """(B, H, W, C) in [0, 1], per-image L_low/L_high (numbers or (B,))
    -> per-channel (x - p_low) / (p_high - p_low + 1e-8), clipped.  mode:
    "index" (sort) or "index-u8" (256-bin histogram, exact on the u8
    grid)."""
    fn = _PERCENTILES[mode]
    B = img.shape[0]
    lo, hi = per_image(l_low, B), per_image(l_high, B)
    out = []
    for i in range(B):
        chans = []
        for c in range(img.shape[-1]):
            ch = img[i, ..., c]
            p_lo, p_hi = fn(ch, float(lo[i]), float(hi[i]))
            chans.append(torch.clamp(div(ch - p_lo, p_hi - p_lo + 1e-8),
                                     0.0, 1.0))
        out.append(torch.stack(chans, dim=-1))
    return torch.stack(out)


def dehaze_batch(img: torch.Tensor, omega) -> torch.Tensor:
    """vgg_16_UIE.py:94-117: dark-channel dehaze with constant A = 0.6."""
    om = torch.as_tensor(per_image(omega, img.shape[0]),
                         device=img.device).reshape(-1, 1, 1, 1)
    dark = torch.amin(img, dim=-1, keepdim=True)
    t = torch.clamp(1.0 - om * dark, 0.1, 1.0)
    return torch.clamp((img - 0.6) / t + 0.6, 0.0, 1.0)


def enhance_vgg(img: torch.Tensor, params: Dict[str, object],
                stretch_mode: str = "index") -> torch.Tensor:
    """vgg_16_UIE.py:32-55 forward.  img: (B, H, W, C) f32 in [0, 1].
    params: 'L_low', 'L_high', and optional 'omega' (enables the dehaze)
    and 'gamma' (img**gamma), each a number or (B,)."""
    out = color_stretch_batch(img, params["L_low"], params["L_high"],
                              stretch_mode)
    if "omega" in params:
        out = dehaze_batch(out, params["omega"])
    if "gamma" in params:
        g = torch.as_tensor(per_image(params["gamma"], img.shape[0]),
                            device=img.device).reshape(-1, 1, 1, 1)
        out = torch.pow(out + 1e-8, g)
    return torch.clamp(out, 0.0, 1.0)


def enhance_zoo(img: torch.Tensor, params: Dict[str, object],
                stretch_mode: str = "index") -> torch.Tensor:
    """The six-parameter composite of the model_architectures.py
    backbones: percentile stretch -> omega dehaze (vgg_16_UIE.py:32-55's
    order) -> the use_gamma-gated ``img**gamma`` (the soft gate of
    deep_learning_parameters.py:43-56) -> clamp.  img: (B, H, W, C) f32
    in [0, 1]; params: 'omega', 'gamma', 'L_low', 'L_high', 'use_gamma',
    each a number or (B,); other keys (guided_radius) are ignored."""
    B = img.shape[0]
    out = color_stretch_batch(img, params["L_low"], params["L_high"],
                              stretch_mode)
    out = dehaze_batch(out, params["omega"])

    def col(k):
        return torch.as_tensor(per_image(params[k], B),
                               device=img.device).reshape(-1, 1, 1, 1)

    g, use_g = col("gamma"), col("use_gamma")
    out = use_g * torch.pow(out + 1e-8, g) + (1.0 - use_g) * out
    return torch.clamp(out, 0.0, 1.0)
