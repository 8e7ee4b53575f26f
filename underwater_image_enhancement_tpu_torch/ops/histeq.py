"""Histograms, entropy, histogram equalization and CLAHE with
OpenCV-compatible integer semantics (cv2.equalizeHist, cv2.createCLAHE).

Counterpart of the JAX package's ``ops/histeq.py``.  Histograms are exact
integer counts from one ``scatter_add_`` (no host sync, unlike
``torch.bincount`` on a card).  CLAHE: REFLECT_101 padding to tile
multiples, integer tile histograms, clip and redistribution with OpenCV's
residual stepping, round-half-even LUTs (tensor ops), then the per-pixel
LUT blend in the CLAHE-apply kernel (``kernels.clahe_apply``), or in the
LAB roundtrip's fused kernel with the inverse LAB
(``kernels.clahe_lab_apply``).  Bit-exact against cv2 on u8 planes.

Batches (the JAX package's vmap rules and batch forms): ``clahe_u8_batch``
(a clip limit an image), ``clahe_u8`` and ``clahe_enhancement_planes`` on
planes with leading dimensions, ``clahe_enhancement_planes_multi`` and
``_clahe_lab_fused_batched`` build the LUTs of the batch in one pass, fold
the LAB conversions into rows, and call CLAHE apply (K2, or K5) once an
image: the kernels keep their one-plane contract, and each image equals
the single-plane call bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops import colorspace as cs
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops.layout import div


def _reflect101_index(n: int, n_out: int) -> np.ndarray:
    """Source indices of a REFLECT_101 extension of length n to n_out."""
    i = np.arange(n_out)
    if n == 1:
        return np.zeros(n_out, np.int64)
    period = 2 * (n - 1)
    i = i % period
    return np.where(i < n, i, period - i)


def histogram256(rows: torch.Tensor) -> torch.Tensor:
    """256-bin histograms of u8-valued int rows: (T, N) -> (T, 256) int32,
    exact, one scatter-add (no host sync)."""
    T = rows.shape[0]
    key = rows.long() + 256 * torch.arange(T, device=rows.device)[:, None]
    hist = torch.zeros(T * 256, dtype=torch.int32, device=rows.device)
    hist.scatter_add_(0, key.reshape(-1),
                      torch.ones(key.numel(), dtype=torch.int32,
                                 device=rows.device))
    return hist.reshape(T, 256)


def shannon_entropy_u8(plane_u8: torch.Tensor) -> torch.Tensor:
    """Base-2 Shannon entropy of a u8-valued int plane (skimage's
    shannon_entropy on u8 data) -> 0-dim f32."""
    # / n as jitted XLA computes it: times the f32 reciprocal (the same
    # bits on every device)
    inv_n = float(np.float32(1.0) / np.float32(plane_u8.numel()))
    p = histogram256(plane_u8.reshape(1, -1))[0].to(torch.float32) * inv_n
    return -torch.sum(torch.where(
        p > 0, p * torch.log2(torch.clamp(p, min=1e-30)), 0.0))


def equalize_hist_u8(channel_u8: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist on a u8-valued int32 plane (H, W): the first
    occupied bin maps to 0 and leaves the normaliser; lut[i] =
    rint((cdf[i] - cdf[i0]) * f32(255 / (n - hist[i0]))) with an IEEE
    division; a constant plane comes back unchanged."""
    lut, flat = _equalize_lut(histogram256(channel_u8.reshape(1, -1))[0],
                              channel_u8.numel())
    return torch.where(flat, channel_u8.to(torch.int32),
                       lut[channel_u8.long()])


def _equalize_lut(hist: torch.Tensor, n: int):
    """equalizeHist's LUT from the 256-bin histogram of n values -> (int32
    (256,) LUT, 0-d bool: the plane is constant and stays as it is).  The
    row-sharded WaterNet (``models/waternet.enhance_sharded``) sums the
    blocks' histograms first."""
    i0 = torch.argmax((hist > 0).to(torch.int32))  # the first occupied bin
    cdf = torch.cumsum(hist, 0)
    denom = (n - hist[i0]).to(torch.float32)
    scale = torch.where(denom > 0,
                        div(torch.full_like(denom, 255.0),
                            torch.clamp(denom, min=1.0)), 0.0)
    lut = torch.clamp(torch.round((cdf - cdf[i0]).to(torch.float32) * scale),
                      0, 255).to(torch.int32)
    return lut, ~(denom > 0)


def histogram_equalization_planes(planes):
    """Per-channel equalizeHist of quantize_u8 of f32 unit planes, back to
    unit floats (enhancement_strategies.py:330-345)."""
    return tuple(cs.u8_to_unit(equalize_hist_u8(cs.quantize_u8(p)))
                 for p in planes)


def histogram_equalization(img: torch.Tensor) -> torch.Tensor:
    """Per-channel equalizeHist of an (H, W, 3) f32 unit image, back to
    unit floats (enhancement_strategies.py:330-345)."""
    u8 = cs.quantize_u8(img)
    return cs.u8_to_unit(torch.stack([equalize_hist_u8(u8[..., c])
                                      for c in range(3)], dim=-1))


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


def _clip_counts(clip_limit, area: int) -> int:
    """OpenCV's clip count of one tile: max(int(limit * area / 256), 1)."""
    return max(int(clip_limit * area / 256.0), 1)


def _clahe_luts(x: torch.Tensor, geo: ClaheGeometry, clip_limits):
    """Per-tile CLAHE LUTs of the REFLECT_101-padded planes x (B,
    th*tiles_y, tw*tiles_x) int32 -> (B, T, 256) int32, OpenCV integer
    arithmetic; ``clip_limits`` holds one limit an image."""
    ty, tx, th, tw = geo.tiles_y, geo.tiles_x, geo.th, geo.tw
    B, T, area = x.shape[0], ty * tx, th * tw
    tiles = (x.reshape(B, ty, th, tx, tw).permute(0, 1, 3, 2, 4)
             .reshape(B * T, area))
    hist = histogram256(tiles)
    counts = [_clip_counts(c, area) for c in clip_limits]
    if len(set(counts)) == 1:
        # one count for the batch: a scalar clamp, no copy to the card
        clipped = torch.clamp(hist, max=counts[0])
    else:
        clip = torch.as_tensor(np.repeat(counts, T).astype(np.int32),
                               device=x.device)
        clipped = torch.minimum(hist, clip[:, None])
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
    return torch.clamp(lut, 0, 255).to(torch.int32).reshape(B, T, 256)


def _clahe_prep_batch(batch_u8: torch.Tensor, clip_limits,
                      tiles_x: int, tiles_y: int):
    """The front half of CLAHE on u8-valued int32 planes (B, H, W): the
    REFLECT_101 pad to tile multiples, the (B, T, 256) tile LUTs (one
    histogram pass for the batch, each image with its own clip limit) and
    the band frame's f32 weights -> (luts, ya, xa, geometry)."""
    H, W = batch_u8.shape[-2:]
    dev = batch_u8.device
    geo = _geometry(H, W, tiles_x, tiles_y)
    if (geo.th * tiles_y, geo.tw * tiles_x) == (H, W):
        x = batch_u8
    else:
        rows = _reflect101_index(H, geo.th * tiles_y)
        cols = _reflect101_index(W, geo.tw * tiles_x)
        x = batch_u8[:, torch.as_tensor(rows, device=dev)][
            :, :, torch.as_tensor(cols, device=dev)]
    luts = _clahe_luts(x, geo, clip_limits)
    ya, xa = (torch.as_tensor(w).to(dev) for w in _clahe_weights(geo))
    return luts, ya, xa, geo


def clahe_prep(channel_u8: torch.Tensor, clip_limit: float,
               tiles_x: int, tiles_y: int):
    """The front half of CLAHE on a u8-valued int32 plane (H, W): the
    REFLECT_101 pad to tile multiples, the (T, 256) tile LUTs and the band
    frame's f32 weights -> (luts, ya, xa, geometry), the arguments of
    ``kernels.clahe_apply`` after the plane."""
    luts, ya, xa, geo = _clahe_prep_batch(channel_u8[None], (clip_limit,),
                                          tiles_x, tiles_y)
    return luts[0], ya, xa, geo


_IMPLS = ("auto", "pallas", "xla")


def _check_impl(name: str, impl: str) -> None:
    """The JAX ``impl`` of CLAHE apply: "pallas" (the kernel), "xla" (its
    one-hot-matmul twin) or "auto"; they give the same bits.  Here each
    runs K2 on a CUDA tensor and its plain version on a CPU one."""
    if impl not in _IMPLS:
        raise ValueError(f"{name}: impl must be 'auto', 'pallas' or 'xla', "
                         f"got {impl!r}")


def clahe_u8(channel_u8: torch.Tensor, clip_limit: float = 2.0,
             tiles_x: int = 8, tiles_y: int = 8,
             impl: str = "auto") -> torch.Tensor:
    """cv2 CLAHE on a u8-valued int32 plane (H, W), bit-exact.  Planes
    with leading dimensions (..., H, W) go through ``clahe_u8_batch``, as
    the JAX function's vmap rule folds them into one batch."""
    _check_impl("clahe_u8", impl)
    if channel_u8.ndim > 2:
        shape = channel_u8.shape
        out = clahe_u8_batch(channel_u8.reshape((-1,) + shape[-2:]),
                             float(clip_limit), tiles_x, tiles_y, impl)
        return out.reshape(shape)
    luts, ya, xa, geo = clahe_prep(channel_u8, clip_limit, tiles_x, tiles_y)
    return kernels.clahe_apply(channel_u8.contiguous(), luts, ya, xa, *geo)


def clahe_u8_batch(batch_u8: torch.Tensor, clip_limit=2.0,
                   tiles_x: int = 8, tiles_y: int = 8,
                   impl: str = "auto") -> torch.Tensor:
    """cv2 CLAHE on u8-valued int32 planes (B, H, W) -> (B, H, W), each
    image bit-equal to ``clahe_u8`` of it.  ``clip_limit`` is one limit or
    a length-B tuple of per-image limits.  One histogram and LUT pass
    serves the batch; the apply is K2 once an image (the kernel's contract
    is one plane a call)."""
    _check_impl("clahe_u8_batch", impl)
    B = batch_u8.shape[0]
    clips = (clip_limit if isinstance(clip_limit, tuple)
             else (float(clip_limit),) * B)
    if len(clips) != B:
        raise ValueError(f"clahe_u8_batch: {len(clips)} clip limits for "
                         f"{B} images")
    luts, ya, xa, geo = _clahe_prep_batch(batch_u8, clips, tiles_x, tiles_y)
    return torch.stack([kernels.clahe_apply(batch_u8[i].contiguous(), luts[i],
                                            ya, xa, *geo) for i in range(B)])


def _clahe_lab_fused_batched(Lb, ab, bb, clip_limit: float,
                             tiles_x: int, tiles_y: int):
    """CLAHE of L and the inverse LAB to u8 in one kernel (K5,
    ``kernels.clahe_lab_apply``) on int32 planes (B, H, W) -> u8-valued
    int32 (r, g, b), each (B, H, W).  Bit-equal to ``clahe_u8`` then
    ``lab_to_rgb_u8_exact_planes``.  One LUT pass for the batch, then K5
    once an image."""
    B = Lb.shape[0]
    luts, ya, xa, geo = _clahe_prep_batch(Lb, (float(clip_limit),) * B,
                                          tiles_x, tiles_y)
    outs = [kernels.clahe_lab_apply(Lb[i].contiguous(), ab[i].contiguous(),
                                    bb[i].contiguous(), luts[i], ya, xa,
                                    *geo) for i in range(B)]
    return tuple(torch.stack([o[c] for o in outs]) for c in range(3))


def clahe_enhancement_planes(planes, clip_limit: float = 2.0,
                             tiles_x: int = 8, tiles_y: int = 8,
                             impl: str = "auto", lab_fast: bool = False,
                             gamma: float | None = None):
    """LAB-L CLAHE roundtrip on (r, g, b) f32 unit planes (..., H, W) ->
    same, bit-exact vs cv2 on the u8 grid.  ``gamma`` applies a trailing
    ``out**gamma`` as a 256-entry LUT (``kernels.gamma_lut``).  Leading
    dimensions are a batch (the JAX function's vmap rules): the LAB
    conversions fold them into rows, CLAHE runs once an image.

    ``impl``: "split" runs CLAHE apply (K2), then the inverse LAB with the
    /255 or the gamma LUT in its epilogue (K3, K3g); "fused" runs CLAHE
    apply and the inverse as one kernel (K5, ``kernels.clahe_lab_apply``),
    then ``u8_to_unit`` or the gamma LUT; "auto" is "split", as in the JAX
    package.  The two give the same bits.

    ``lab_fast=True`` (the ``--fast`` tier) converts forward with the
    approximate kernel ``kernels.lab_forward_unit_approx`` (L, a, b within 1
    of exact) on every device.  The JAX package takes that branch only on a
    TPU and converts exactly elsewhere; the port follows the TPU program, so
    its CPU path runs the approximate kernel's plain version."""
    if impl == "auto":
        impl = "split"
    if impl not in ("split", "fused"):
        raise ValueError(f"clahe_enhancement_planes: impl must be 'auto', "
                         f"'split' or 'fused', got {impl!r}")
    if lab_fast:
        L, a, b = cs._rows(kernels.lab_forward_unit_approx, planes)
    else:
        L, a, b = cs.rgb_unit_to_lab_planes(*planes)
    if impl == "fused" and L.ndim == 2:
        luts, ya, xa, geo = clahe_prep(L, clip_limit, tiles_x, tiles_y)
        rgb = kernels.clahe_lab_apply(L, a, b, luts, ya, xa, *geo)
    elif impl == "fused":
        shape = L.shape
        flat = tuple(x.reshape((-1,) + shape[-2:]) for x in (L, a, b))
        rgb = tuple(c.reshape(shape) for c in _clahe_lab_fused_batched(
            *flat, clip_limit, tiles_x, tiles_y))
    if impl == "fused":
        if gamma is not None:
            glut = kernels.gamma_lut(gamma, L.device)
            return tuple(glut[c.long()] for c in rgb)
        return tuple(cs.u8_to_unit(c) for c in rgb)
    L = clahe_u8(L, clip_limit, tiles_x, tiles_y)
    if gamma is not None:
        return cs.lab_to_rgb_unit_gamma_planes(L, a, b, gamma)
    return cs.lab_to_rgb_unit_planes(L, a, b)


def clahe_enhancement_planes_multi(planes_list, clip_limits,
                                   tiles_x: int = 8, tiles_y: int = 8):
    """N independent CLAHE-LAB roundtrips of same-shape (r, g, b) plane
    tuples, each with its own clip limit -> a list of N plane tuples, each
    bit-equal to ``clahe_enhancement_planes`` of it.  The LAB conversions
    fold the N images into rows (K1 and K3 once for all), the LUTs are one
    pass, and CLAHE apply is K2 once an image."""
    N = len(planes_list)
    H, W = planes_list[0][0].shape[-2:]
    stacked = tuple(torch.cat([pl[c].reshape(H, W) for pl in planes_list])
                    for c in range(3))                  # 3 x (N*H, W)
    L, a, b = cs.rgb_unit_to_lab_planes(*stacked)
    Lb = clahe_u8_batch(L.reshape(N, H, W), tuple(float(c) for c in clip_limits),
                        tiles_x, tiles_y)
    rgb = cs.lab_to_rgb_unit_planes(Lb.reshape(N * H, W), a, b)
    return [tuple(c[i * H:(i + 1) * H] for c in rgb) for i in range(N)]


def clahe_enhancement(img: torch.Tensor, clip_limit: float = 2.0,
                      tiles_x: int = 8, tiles_y: int = 8) -> torch.Tensor:
    """LAB-L CLAHE roundtrip of an (H, W, 3) f32 unit image -> same
    (enhancement_strategies.py:287-307, six_stadigy.py:201-208)."""
    planes = tuple(img[..., c].contiguous() for c in range(3))
    out = clahe_enhancement_planes(planes, clip_limit, tiles_x, tiles_y)
    return torch.stack(out, dim=-1)
