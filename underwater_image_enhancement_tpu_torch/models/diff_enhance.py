"""The differentiable enhancement operators of vgg_16_UIE.py:24-128 and
deep_learning_parameters.py:24-90, on NHWC batches.

Counterpart of the JAX package's ``models/diff_enhance.py``:

- ``enhance_vgg``: percentile stretch -> dark-channel dehaze with a
  constant A = 0.6 -> ``img**gamma`` -> clamp (also the fixed-parameter
  path of ``enhance``).
- ``enhance_zoo``: the six-parameter composite of the zoo predictors.
- ``enhance_mlp``: stretch -> the use_gamma-gated ``img**(1/gamma)`` ->
  clamp, no dehaze (the MLP trainer's).

Stretch modes: ``index`` (``sorted[int(L/100*n)]``, no gradient to
L_low/L_high, as in the reference), ``index-u8`` (the same order
statistic from a 256-bin histogram, exact on the u8 grid) and
``quantile`` (``jnp.quantile``'s linear interpolation, which gives L_low
and L_high a gradient; the trainers' default).

Parameters are numbers, host arrays or tensors, each a scalar or one a
image.  Numbers and host arrays take the host path: percentile indices in
host f32 arithmetic (``stretch.order_index``), an image at a time.
Tensors (a predictor's output) stay on their device and in the autograd
graph: the whole batch is sorted at once and the percentiles gathered
there, and every clip is ``layers.clip`` (JAX's gradient on a bound).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.models.layers import clip
from underwater_image_enhancement_tpu_torch.ops.layout import div
from underwater_image_enhancement_tpu_torch.ops.stretch import (
    _perc_pair_index_u8,
    order_index,
)


def _f32(x) -> float:
    return float(np.float32(x))


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


def _column(v, img: torch.Tensor) -> torch.Tensor:
    """A parameter as a (B, 1, 1, 1) f32 tensor on img's device: a tensor
    as it is (in the graph), a number or host array through
    ``per_image``."""
    if isinstance(v, torch.Tensor):
        return v.reshape(-1, 1, 1, 1).to(img.device, img.dtype)
    return torch.as_tensor(per_image(v, img.shape[0]),
                           device=img.device).reshape(-1, 1, 1, 1)


def _sorted_channels(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H*W), each channel sorted."""
    B, H, W, C = img.shape
    flat = img.permute(0, 3, 1, 2).reshape(B, C, H * W)
    return torch.sort(flat, dim=-1, stable=True).values


def _gather(srt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """srt (B, C, n), idx (B,) int64 -> srt[b, c, idx[b]] as (B, C)."""
    B, C, _ = srt.shape
    return srt.gather(-1, idx.view(B, 1, 1).expand(B, C, 1)).squeeze(-1)


def _order_statistic(srt: torch.Tensor, pct: torch.Tensor) -> torch.Tensor:
    """The ``index`` percentile on the device: ``int(pct/100*n)``
    clipped, as ``stretch.order_index`` computes it, no gradient to
    pct."""
    n = srt.shape[-1]
    scale = _f32(np.float32(np.float32(1.0) / np.float32(100.0))
                 * np.float32(n))
    idx = torch.clamp((pct.detach() * scale).to(torch.int32), 0, n - 1)
    return _gather(srt, idx.long())


def _quantile(srt: torch.Tensor, pct: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(channel, pct / 100.0)`` (method "linear") of each
    sorted channel: ``q = pct/100*(n-1)``, the values at ``floor(q)`` and
    ``ceil(q)`` (clamped to [0, n-1]) weighted ``1-w`` and ``w`` with
    ``w = q - floor(q)``, so the gradient reaches pct.  Jitted XLA folds
    the ``/100`` into ``q``'s multiply: ``q = pct * f32(f32(1/100) *
    (n-1))`` (found by comparison with the jitted JAX function,
    ``tests/test_torch_train_models.py``)."""
    n = srt.shape[-1]
    scale = _f32(np.float32(np.float32(1.0) / np.float32(100.0))
                 * np.float32(n - 1))
    q = pct * scale
    low = torch.floor(q)
    high_w = q - low
    low_w = 1.0 - high_w
    lo = torch.clamp(low.detach(), 0, n - 1).long()
    hi = torch.clamp(torch.ceil(q.detach()), 0, n - 1).long()
    return (_gather(srt, lo) * low_w[:, None]
            + _gather(srt, hi) * high_w[:, None])


_DEVICE_PERCENTILES = {"index": _order_statistic, "quantile": _quantile}


def color_stretch_batch(img: torch.Tensor, l_low, l_high,
                        mode: str = "index") -> torch.Tensor:
    """(B, H, W, C) in [0, 1], per-image L_low/L_high (numbers, (B,) host
    arrays or tensors) -> per-channel (x - p_low) / (p_high - p_low +
    1e-8), clipped.  mode: "index" (sort), "index-u8" (256-bin histogram,
    exact on the u8 grid) or "quantile" (interpolated; tensors only carry
    its gradient)."""
    if mode not in ("index", "index-u8", "quantile"):
        raise KeyError(mode)
    B = img.shape[0]
    tensors = isinstance(l_low, torch.Tensor) or isinstance(l_high,
                                                            torch.Tensor)
    if mode == "quantile" or (tensors and mode == "index"):
        fn = _DEVICE_PERCENTILES[mode]
        srt = _sorted_channels(img)
        pcts = [_column(v, img).reshape(-1).expand(B) for v in (l_low, l_high)]
        p_lo, p_hi = (fn(srt, p)[:, None, None, :] for p in pcts)
        return clip((img - p_lo) / (p_hi - p_lo + 1e-8), 0.0, 1.0)
    fn = _PERCENTILES[mode]
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
    om = _column(omega, img)
    dark = torch.amin(img, dim=-1, keepdim=True)
    t = clip(1.0 - om * dark, 0.1, 1.0)
    return clip((img - 0.6) / t + 0.6, 0.0, 1.0)


def enhance_vgg(img: torch.Tensor, params: Dict[str, object],
                stretch_mode: str = "index") -> torch.Tensor:
    """vgg_16_UIE.py:32-55 forward.  img: (B, H, W, C) f32 in [0, 1].
    params: 'L_low', 'L_high', and optional 'omega' (enables the dehaze)
    and 'gamma' (img**gamma), each a number, (B,) or a tensor."""
    out = color_stretch_batch(img, params["L_low"], params["L_high"],
                              stretch_mode)
    if "omega" in params:
        out = dehaze_batch(out, params["omega"])
    if "gamma" in params:
        out = torch.pow(out + 1e-8, _column(params["gamma"], img))
    return clip(out, 0.0, 1.0)


def enhance_zoo(img: torch.Tensor, params: Dict[str, object],
                stretch_mode: str = "index") -> torch.Tensor:
    """The six-parameter composite of the model_architectures.py
    backbones: percentile stretch -> omega dehaze (vgg_16_UIE.py:32-55's
    order) -> the use_gamma-gated ``img**gamma`` (the soft gate of
    deep_learning_parameters.py:43-56) -> clamp.  img: (B, H, W, C) f32
    in [0, 1]; params: 'omega', 'gamma', 'L_low', 'L_high', 'use_gamma',
    each a number, (B,) or a tensor; other keys (guided_radius) are
    ignored."""
    out = color_stretch_batch(img, params["L_low"], params["L_high"],
                              stretch_mode)
    out = dehaze_batch(out, params["omega"])
    g, use_g = _column(params["gamma"], img), _column(params["use_gamma"], img)
    out = use_g * torch.pow(out + 1e-8, g) + (1.0 - use_g) * out
    return clip(out, 0.0, 1.0)


def enhance_mlp(img: torch.Tensor, params: Dict[str, object],
                stretch_mode: str = "index") -> torch.Tensor:
    """deep_learning_parameters.py:32-56 forward: stretch, then the
    use_gamma-gated ``img**(1/gamma)`` -> clamp.  params: 'L_low',
    'L_high', 'gamma', 'use_gamma', each a number, (B,) or a tensor."""
    out = color_stretch_batch(img, params["L_low"], params["L_high"],
                              stretch_mode)
    use_g = _column(params["use_gamma"], img)
    g = _column(params["gamma"], img)
    gamma_enhanced = torch.pow(out + 1e-8, 1.0 / g)
    out = use_g * gamma_enhanced + (1.0 - use_g) * out
    return clip(out, 0.0, 1.0)
