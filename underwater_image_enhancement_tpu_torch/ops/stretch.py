"""Percentile contrast stretch, white balance and gamma on channel planes.

Counterpart of the JAX package's ``ops/stretch.py``.  Three percentile
methods:

- ``"sort"`` (the exact tiers; ``"radix"``, the JAX exact tier's method,
  is another name for it): ``np.percentile``'s linear interpolation.  The
  JAX exact tier selects the order statistics with an
  O(n) radix select that is bit-equal to its full-sort oracle; here one
  ``torch.sort`` of the stacked channels gives the same order statistics,
  and the interpolation is the same f32 arithmetic (indices and weights
  from ``_lerp_indices``, then ``lv*lw + hv*hw`` with each product
  rounded).
- ``"hist-fast"`` (the ``--fast`` tier): ``perc_pairs_hist`` on every 8th
  row, the JAX two-level 32x32-bin histogram (``_perc_pair_hist``).
- ``_perc_pair_index_u8`` (``enhance_batch``): the sorted-index percentile
  ``sorted[int(pct/100*n)]`` from an exact 256-bin histogram.

The HWC forms (``color_enhancement``, ``enhance_contrast``,
``white_balance``) stretch each image of (..., H, W, C) per channel;
``gray_world_white_balance`` scales by the channel means (in XLA:CPU's
summation order, ``reduce.xla_mean``).

Percentile ranks and indices are host f32 arithmetic, in the order the
jitted JAX program computes them on XLA:CPU: with the six recipes' constant
percentiles XLA folds ``pct/100*(n-1)+1`` at compile time with an IEEE
division; with a traced percentile (``enhance_batch``'s parameters) it
rewrites ``pct/100*n`` to ``pct * f32(f32(1/100) * n)``; and it rewrites
the histogram's ``bin / ((k*k-1) / span)`` to ``(bin * span) *
f32(1/(k*k-1))``.
"""

from __future__ import annotations

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops.layout import div
from underwater_image_enhancement_tpu_torch.ops.reduce import xla_mean

_f32 = np.float32

# the 256 float32 values a decoded u8 image can take (k/255, IEEE f32
# division): the gamma LUT's grid and u8_to_unit's exact values
U8_GRID = np.arange(256, dtype=np.float32) / np.float32(255.0)


def _lerp_indices(n: int, pct: float):
    """np.percentile 'linear' index and weights in f32: q = pct/100 *
    (n-1); low/high = floor/ceil(q) clipped; weights (1-frac, frac)."""
    q = _f32(pct) / _f32(100.0) * (_f32(n) - _f32(1))
    low = np.floor(q)
    high_w = _f32(q - low)
    low_w = _f32(_f32(1.0) - high_w)
    low_i = int(np.clip(low, 0, n - 1))
    high_i = int(np.clip(np.ceil(q), 0, n - 1))
    return low_i, high_i, low_w, high_w


def percentiles_planes(planes, pcts) -> torch.Tensor:
    """Exact np.percentile-convention percentiles of same-shape planes:
    (len(planes), len(pcts)) f32, one sort for all planes."""
    flat = torch.stack([p.reshape(-1) for p in planes])
    n = flat.shape[1]
    srt = torch.sort(flat, dim=1).values
    idx = [_lerp_indices(n, p) for p in pcts]
    dev = flat.device
    lo = torch.tensor([i[0] for i in idx], device=dev)
    hi = torch.tensor([i[1] for i in idx], device=dev)
    lw = torch.tensor([i[2] for i in idx], dtype=torch.float32, device=dev)
    hw = torch.tensor([i[3] for i in idx], dtype=torch.float32, device=dev)
    return srt[:, lo] * lw + srt[:, hi] * hw


def percentiles(channel: torch.Tensor, pcts) -> torch.Tensor:
    """Exact np.percentile-convention percentiles of one plane ->
    (len(pcts),) f32 (the JAX ``percentiles_radix``)."""
    return percentiles_planes((channel,), pcts)[0]


def percentiles_radix_planes(planes, pcts):
    """The JAX ``percentiles_radix_planes``: exact np.percentile-convention
    percentiles of same-shape planes -> one (len(pcts),) f32 tensor a plane.
    The JAX package selects the order statistics by an O(n) radix select
    bit-equal to its sort; here one ``torch.sort`` gives them."""
    return tuple(percentiles_planes(planes, pcts).unbind(0))


def percentiles_radix(channel: torch.Tensor, pcts) -> torch.Tensor:
    """Single-plane ``percentiles_radix_planes``: (len(pcts),) f32."""
    return percentiles(channel, pcts)


def perc_pairs_hist(planes, l_low: float, l_high: float, k: int = 32,
                    subsample: int = 1) -> torch.Tensor:
    """Approximate (p_low, p_high) of each same-shape (H, W) plane from a
    two-level histogram (the JAX ``_perc_pair_hist``, per plane): k coarse
    buckets between the plane's min and max locate each target rank, k fine
    bins inside that bucket refine it; the result is the fine bin's left
    edge.  ``subsample`` > 1 takes every subsample-th row (min and max
    too).  -> (len(planes), 2) f32 on the planes' device.

    The planes and both percentiles go through one batch of tensor ops: the
    (plane, coarse, fine) histogram is one exact integer scatter-add (no
    host sync), and every f32 step is the JAX program's, elementwise."""
    x = torch.stack([p[::subsample, :] if subsample > 1 else p
                     for p in planes])                      # (C, h, W)
    C, n = x.shape[0], x[0].numel()
    flat = x.reshape(C, n)
    vmin, vmax = flat.amin(1), flat.amax(1)
    span = torch.clamp(vmax - vmin, min=1e-12)
    return _perc_select(_perc_hist(flat, vmin, span, k), vmin, span, n,
                        l_low, l_high)


def _perc_hist(flat: torch.Tensor, vmin: torch.Tensor, span: torch.Tensor,
               k: int = 32) -> torch.Tensor:
    """The exact (C, k, k) two-level histogram of (C, n) values between
    vmin and vmin + span (C,): the coarse bucket and the fine bin of each
    value, one integer scatter-add."""
    C = flat.shape[0]
    kk = k * k - 1
    scale = div(torch.full_like(vmin, kk), span)  # IEEE: a traced divisor
    idx = torch.clamp((flat - vmin[:, None]) * scale[:, None], 0, kk)
    hi_f = torch.floor(idx / k)  # exact: k is a power of two
    lo = torch.clamp(idx - hi_f * k, 0, k - 1)
    plane = torch.arange(C, device=flat.device)[:, None] * (k * k)
    key = plane + hi_f.to(torch.int64) * k + lo.to(torch.int64)
    hist = torch.zeros(C * k * k, dtype=torch.int32, device=flat.device)
    hist.scatter_add_(0, key.reshape(-1),
                      torch.ones(key.numel(), dtype=torch.int32,
                                 device=flat.device))
    return hist.reshape(C, k, k)


def _perc_select(hist: torch.Tensor, vmin: torch.Tensor, span: torch.Tensor,
                 n: int, l_low: float, l_high: float) -> torch.Tensor:
    """(p_low, p_high) of each plane from its exact (C, k, k) two-level
    histogram of n values between vmin and vmin + span (C,): the coarse
    bucket where each rank falls, then the fine bin inside it; its left
    edge -> (C, 2) f32.  ``perc_pairs_hist``'s second half, shared with
    the row-sharded percentiles (``parallel/six_spatial``), whose
    histograms are summed over the positions first."""
    C, k = hist.shape[0], hist.shape[1]
    kk = k * k - 1
    dev = hist.device
    c1 = torch.cumsum(hist.sum(2), 1)                       # (C, k)
    # constant percentiles: XLA folds the rank with an IEEE division
    rank = torch.tensor([float(_f32(_f32(_f32(p) / _f32(100.0)) * _f32(n - 1))
                               + _f32(1.0)) for p in (l_low, l_high)],
                        device=dev)                         # (2,)
    b1 = torch.clamp((c1[:, None, :] < rank[None, :, None]).sum(2), 0, k - 1)
    below = torch.where(b1 > 0,
                        torch.gather(c1, 1, torch.clamp(b1 - 1, min=0)), 0)
    fine = hist[torch.arange(C, device=dev)[:, None], b1]   # (C, 2, k)
    c2 = torch.cumsum(fine, 2) + below[..., None]
    b2 = torch.clamp((c2 < rank[None, :, None]).sum(2), 0, k - 1)
    # bin / scale: XLA rewrites b / (kk / span) to (b * span) * (1/kk)
    return vmin[:, None] + (b1 * k + b2).to(torch.float32) * span[:, None] \
        * float(_f32(1.0) / _f32(kk))


def _perc_pair_hist(channel: torch.Tensor, l_low: float, l_high: float,
                    k: int = 32, subsample: int = 1):
    """perc_pairs_hist of one plane -> (p_low, p_high), 0-dim tensors."""
    p = perc_pairs_hist((channel,), l_low, l_high, k, subsample)[0]
    return p[0], p[1]


def order_index(pct, n: int) -> np.ndarray:
    """int(pct/100*n) clipped to [0, n-1] for host percentiles (scalars or
    arrays), as jitted JAX computes it for a traced pct:
    ``pct * f32(f32(1/100) * n)``, truncated."""
    q = np.asarray(pct, np.float32) * (_f32(_f32(1.0) / _f32(100.0)) * _f32(n))
    return np.clip(q.astype(np.int32), 0, n - 1)


def _perc_pair_index_u8(channel: torch.Tensor, l_low: float, l_high: float):
    """EXACT sorted-index percentiles ``sorted[int(pct/100*n)]``
    (vgg_16_UIE.py:57-92) of a channel on the u8 grid, from a 256-bin
    histogram of round(channel*255): the order statistic sorted[i] is the
    first grid value v with #(q <= v) > i.  Bit-equal to the sort for
    u8-grid inputs (the JAX ``_perc_pair_index_u8``); 0-dim f32 tensors."""
    n = channel.numel()
    q = torch.clamp(torch.round(channel * 255.0), 0.0, 255.0).to(torch.int64)
    cdf = torch.cumsum(torch.bincount(q.reshape(-1), minlength=256), 0)
    grid = torch.as_tensor(U8_GRID, device=channel.device)
    return tuple(grid[(cdf <= int(i)).sum()]
                 for i in order_index([l_low, l_high], n))


def _stretch(planes, pairs, eps: float):
    """(p - lo) / (hi - lo + eps) per plane, clipped to [0, 1]."""
    return tuple(torch.clamp(div(p - lo, hi - lo + eps), 0.0, 1.0)
                 for p, (lo, hi) in zip(planes, pairs))


def _pair(channel: torch.Tensor, l_low, l_high, method: str):
    """(p_low, p_high) of one plane by ``method`` (``stretch_channel``)."""
    if method in ("sort", "radix"):
        p = percentiles(channel, (l_low, l_high))
        return p[0], p[1]
    if method == "index-u8":
        return _perc_pair_index_u8(channel, l_low, l_high)
    if method == "hist-fast":
        return _perc_pair_hist(channel, l_low, l_high, subsample=8)
    if method == "hist":
        return _perc_pair_hist(channel, l_low, l_high)
    raise ValueError(f"unknown percentile method {method!r}")


def stretch_channel(channel: torch.Tensor, l_low, l_high, eps: float = 1e-10,
                    method: str = "sort") -> torch.Tensor:
    """(channel - p_low) / (p_high - p_low + eps), clipped to [0, 1].
    method: "sort"/"radix" (exact np.percentile), "index-u8" (the
    sorted-index percentile of a u8-grid plane), "hist" (two-level
    histogram) or "hist-fast" (the histogram on every 8th row)."""
    return _stretch((channel,), (_pair(channel, l_low, l_high, method),),
                    eps)[0]


def color_enhancement_planes(planes, l_low=15.0, l_high=95.0,
                             eps: float = 1e-10, method: str = "sort"):
    """Per-channel percentile stretch (p - lo) / (hi - lo + eps), clipped to
    [0, 1] (enhancement_strategies.py:251-273).  method: "sort" or "radix"
    (exact np.percentile, one sort for the planes), "hist-fast"
    (``perc_pairs_hist`` on every 8th row, one pass for the planes), or
    "index-u8" or "hist" (``stretch_channel``, a plane at a time)."""
    if method in ("sort", "radix"):
        pr = percentiles_planes(planes, (l_low, l_high))
    elif method == "hist-fast":
        pr = perc_pairs_hist(planes, l_low, l_high, subsample=8)
    elif method in ("index-u8", "hist"):
        return tuple(stretch_channel(p, l_low, l_high, eps, method)
                     for p in planes)
    else:
        raise ValueError(f"unknown percentile method {method!r}")
    pairs = [(pr[c, 0], pr[c, 1]) for c in range(len(planes))]
    return _stretch(planes, pairs, eps)


def color_enhancement(img: torch.Tensor, l_low=15.0, l_high=95.0,
                      eps: float = 1e-10, method: str = "sort") -> torch.Tensor:
    """Per-channel percentile stretch of (..., H, W, C) images
    (enhancement_strategies.py:251-273): percentiles per leading-batch
    element and channel.  ``eps=1e-6`` is six_stadigy's enhance_contrast."""
    lead, hwc = img.shape[:-3], img.shape[-3:]
    flat = img.reshape((-1,) + hwc)
    outs = [torch.stack(color_enhancement_planes(
        tuple(im[..., c] for c in range(hwc[-1])), l_low, l_high, eps,
        method), dim=-1) for im in flat]
    return torch.stack(outs).reshape(lead + hwc)


def enhance_contrast(img: torch.Tensor, l_low=15.0, l_high=95.0,
                     method: str = "sort") -> torch.Tensor:
    """six_stadigy.py:190-199 flavour (eps 1e-6)."""
    return color_enhancement(img, l_low, l_high, eps=1e-6, method=method)


def white_balance(img: torch.Tensor, percentile=5.0,
                  method: str = "sort") -> torch.Tensor:
    """Symmetric percentile stretch (six_stadigy.py:210-219, eps 1e-6)."""
    return color_enhancement(img, percentile, 100.0 - percentile, eps=1e-6,
                             method=method)


def gray_world_white_balance_planes(planes):
    """Gray-world white balance of (r, g, b) planes (..., H, W): each
    channel scaled so that its mean matches the mean of the three channel
    means (``(m0 + m1 + m2) / 3``), clipped to [0, 1]; the means are per
    image, in XLA:CPU's summation order (``reduce.xla_mean``), and the /3
    is the f32 reciprocal multiply of the jitted JAX program."""
    means = xla_mean(torch.stack(tuple(planes)))           # (3, ...)
    target = (means[0] + means[1] + means[2]) * float(_f32(1.0) / _f32(3.0))
    return tuple(torch.clamp(c * div(target, torch.clamp(m, min=1e-6))
                             [..., None, None], 0.0, 1.0)
                 for c, m in zip(planes, means))


def gray_world_white_balance(img: torch.Tensor) -> torch.Tensor:
    """Gray-world white balance by channel-mean scaling of (..., H, W, 3)
    images (``gray_world_white_balance_planes``)."""
    out = gray_world_white_balance_planes(tuple(img[..., c]
                                                for c in range(3)))
    return torch.stack(out, dim=-1)


def enhance_contrast_planes(planes, l_low=15.0, l_high=95.0,
                            method: str = "sort"):
    """six_stadigy.py:190-199 flavour (eps 1e-6)."""
    return color_enhancement_planes(planes, l_low, l_high, 1e-6, method)


def white_balance_planes(planes, percentile=5.0, method: str = "sort"):
    """Symmetric percentile stretch (six_stadigy.py:210-219, eps 1e-6)."""
    return color_enhancement_planes(planes, percentile, 100.0 - percentile,
                                    1e-6, method)


def gamma_correction_pow(img: torch.Tensor, gamma=1.2) -> torch.Tensor:
    """img ** gamma, no clip (six_stadigy.py:221-224)."""
    return torch.pow(torch.clamp(img, min=0.0), float(gamma))


def gamma_correction_inv(img: torch.Tensor, gamma=1.2) -> torch.Tensor:
    """clip(max(img, 0) ** (1/gamma), 0, 1) (enhancement_strategies.py:
    276-285); 1/gamma is the f32 quotient jitted XLA folds."""
    inv = float(_f32(1.0) / _f32(gamma))
    return torch.clamp(torch.pow(torch.clamp(img, min=0.0), inv), 0.0, 1.0)
