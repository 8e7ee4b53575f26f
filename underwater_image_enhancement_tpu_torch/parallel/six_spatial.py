"""The six strategies of ONE large frame sharded on rows over the port's
mesh: the JAX package's ``parallel/six_spatial.py``.

The frame is cut into one row block a position (``parallel/spatial``), and
the whole ``six`` workload runs block by block: cast detection and
correction, the quadtree airlight, three dehaze chains, percentile
stretches, white balance, five CLAHE-LAB round trips and the gammas.  The
only values that cross positions are those JAX's ``shard_map`` program
exchanges:

- sums of integer histograms (the percentile stretch and white balance:
  ``ops.stretch``'s two-level hist-fast histogram, summed exactly, so the
  percentiles are those of the whole frame bit for bit);
- the airlight's SAT corners, 7 x 3 x 3 a quadtree level, each position's
  masked row sums over W in XLA:CPU's order (``ops/reduce.xla_sum``) added
  in mesh order;
- the brightest pixel's max and first index (first in row-major order);
- one all-gather of the CLAHE tile LUTs a leg;
- halo rows for Canny (halo = hysteresis rounds + 2, replicated edges),
  for the fast guided filter's subsampled box windows (REFLECT_101) and
  nothing else.

Kernels on a card: the forward LAB of the CLAHE legs is K1b
(``colorspace.rgb_to_lab_u8_exact_planes``) and the inverse K3b, on every
device: the JAX program converts exactly, not through the fast tier's
approximate LAB.  Canny's propagation is K7, once a block; the airlight's
local row table K6 (``kernels.sat_rows``).  The CLAHE blend is the JAX
program's XLA blend, in PyTorch (``spatial._clahe_blend_rows``), not K2.

Shape rule: W % tiles == 0 and tiles % D == 0 (whole CLAHE tile rows a
position).  Any height works: H is REFLECT_101-row-padded to the next
multiple of lcm(D, tiles) and cropped after (the global sums and the
Canny mask the pad rows); heights that divide but put the blocks off the
stride-8 percentile grid (2160 rows over 8 positions: 270 rows a block)
select the grid's rows by their global index, and the guided filter
rebuilds the global coarse grid around each block (``_guided_fast_sharded
_strip``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops import colorspace as cs
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops.airlight import (
    quadtree_descend,
)
from underwater_image_enhancement_tpu_torch.ops.boxfilter import _window_sum
from underwater_image_enhancement_tpu_torch.ops.edges import canny_u8
from underwater_image_enhancement_tpu_torch.ops.layout import div
from underwater_image_enhancement_tpu_torch.ops.reduce import xla_sum
from underwater_image_enhancement_tpu_torch.ops.stretch import (
    _perc_hist,
    _perc_select,
    gamma_correction_pow,
)
from underwater_image_enhancement_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    _tensor,
)
from underwater_image_enhancement_tpu_torch.parallel.spatial import (
    _clahe_blocks,
    _device_index,
    _exchange_halo,
    _gather,
    _pad_cols,
    _pmax,
    _pmin,
    _psum,
    _psum_host,
    _psum_mean,
    _replicate,
    _shard,
)

AX = DATA_AXIS
_f32 = np.float32


# ---------------------------------------------------------------------------
# percentiles: ops.stretch's hist-fast histogram summed over the positions
# ---------------------------------------------------------------------------

def _grid_rows(Hl: int, i: int, subsample: int, valid_to):
    """Local rows of block i on the global stride-``subsample`` grid,
    below ``valid_to`` where the frame was padded."""
    g = i * Hl + np.arange(Hl)
    keep = g % subsample == 0
    if valid_to is not None:
        keep &= g < valid_to
    return np.nonzero(keep)[0]


def _perc_pair_hist_sharded(stacks, l_low, l_high, n_global: int,
                            k: int = 32, subsample: int = 8,
                            valid_to: int | None = None) -> list:
    """``stretch.perc_pairs_hist(..., subsample)`` of the whole frame from
    row blocks: stacks are one (C, Hl, W) stack of planes a position ->
    one (C, 2) (p_low, p_high) tensor a position, bit-equal to the
    single-device hist-fast percentiles.

    The min, the max and the (C, k, k) histogram run on the rows of the
    global stride grid.  Two row selections, the same set of rows:
    aligned (Hl % subsample == 0 and no pad rows), a local stride slice;
    otherwise each block's rows on the grid by their global index (and
    below ``valid_to``).  The min and max combine by ``_pmin``/``_pmax``,
    the integer histograms by ``_psum`` (exact)."""
    Hl = stacks[0].shape[-2]
    aligned = subsample <= 1 or (Hl % subsample == 0 and valid_to is None)
    subs = []
    for i, x in enumerate(stacks):
        if aligned:
            subs.append(x[:, ::subsample] if subsample > 1 else x)
        else:
            rows = _grid_rows(Hl, i, subsample, valid_to)
            subs.append(x.index_select(1, _device_index(rows, x.device)))
    C = stacks[0].shape[0]
    inf = torch.full((C,), float("inf"))
    vmin = _pmin([s.amin(dim=(1, 2)) if s.shape[1] else inf.to(s.device)
                  for s in subs])
    vmax = _pmax([s.amax(dim=(1, 2)) if s.shape[1] else (-inf).to(s.device)
                  for s in subs])
    spans = [torch.clamp(hi - lo, min=1e-12) for lo, hi in zip(vmin, vmax)]
    hist = _psum([_perc_hist(s.reshape(C, -1), lo, span, k)
                  for s, lo, span in zip(subs, vmin, spans)])[0]
    pairs = _perc_select(hist, vmin[0], spans[0], n_global, float(l_low),
                         float(l_high))
    return _replicate(pairs, stacks)


def _stretch_planes(planes, l_low, l_high, n_sub, valid_to=None) -> list:
    """Percentile stretch (eps 1e-6, as six's enhance_contrast_planes) of
    each position's (r, g, b) planes with the whole frame's percentiles."""
    stacks = [torch.stack(p) for p in planes]
    pairs = _perc_pair_hist_sharded(stacks, l_low, l_high, n_sub,
                                    valid_to=valid_to)
    return [tuple(torch.clamp(div(c - pr[j, 0], pr[j, 1] - pr[j, 0] + 1e-6),
                              0.0, 1.0) for j, c in enumerate(p))
            for p, pr in zip(planes, pairs)]


def _wb_planes(planes, percentile, n_sub, valid_to=None) -> list:
    return _stretch_planes(planes, percentile, 100.0 - percentile, n_sub,
                           valid_to=valid_to)


# ---------------------------------------------------------------------------
# Canny + quadtree airlight
# ---------------------------------------------------------------------------

def _canny_sharded(grays, iters: int, valid_to: int | None = None) -> list:
    """Bounded-hysteresis Canny of a row-sharded u8 plane, bit-equal to
    the whole plane's ``iters``-round propagation: a halo of iters + 2
    replicated rows covers Sobel's and NMS's reach (2 rows) and the
    longest strong-to-pixel chain (iters rows), and ``valid_rows`` zeroes
    the gradient magnitude on the halo rows past the frame (and on pad
    rows of a padded frame), so NMS at the frame's edges reads 0 there
    and hysteresis cannot seed from them.  One K7 launch a block."""
    h = iters + 2
    n, Hl = len(grays), grays[0].shape[0]
    globe = Hl * n if valid_to is None else valid_to
    out = []
    for i, ext in enumerate(_exchange_halo(grays, h, edge="edge")):
        s0 = i * Hl
        r0 = max(h - s0, 0)
        r1 = min(globe - s0 + h, Hl + 2 * h)
        e = canny_u8(ext, 50, 150, hysteresis_iters=iters, use_pallas=False,
                     valid_rows=(r0, r1))
        out.append(e[h:-h])
    return out


def _airlight_sharded(planes, H: int, W: int, edge_iters: int = 4,
                      valid_to: int | None = None):
    """``airlight.quadtree_airlight_planes`` with the SAT corners summed
    over the positions: each block keeps its local row-prefix table (K6),
    a corner at global (r, c) is the sum over the positions of each one's
    clipped local prefix row masked to columns < c, the descent runs on
    the host (one read a level), and the brightest pixel of the final box
    is the max of the positions' maxima, first in row-major order.  H is
    the true frame height: the descent never reaches pad rows.  -> one A
    (3,) a position."""
    Hl = planes[0][0].shape[0]
    grays = [cs.gray_u8_planes(*(cs.quantize_u8(p) for p in pl))
             for pl in planes]
    edges = _canny_sharded(grays, edge_iters, valid_to=valid_to)
    lsats = []
    for (r, g, b), e in zip(planes, edges):
        stats = torch.stack([r, g, b, r * r, g * g, b * b,
                             e.to(torch.float32)])
        lsats.append(kernels.sat_rows(stats, -2))          # (7, Hl+1, W)
    lanes = np.arange(W)
    home = lsats[0].device

    def corners(rows, cols):
        strips = []
        for i, ls in enumerate(lsats):
            loc = np.clip(rows - i * Hl, 0, Hl)
            strips.append(ls.index_select(1, _device_index(loc, ls.device))
                          .to(home))
        host = torch.stack(strips).cpu().numpy()          # (D, 7, 3, W)
        mask = (lanes[None, :] < cols[:, None]).astype(np.float32)
        return _psum_host([xla_sum(s[:, :, None, :] * mask[None, None], 1)
                           for s in host])                 # (7, 3, 3)

    r0, c0, h, w = quadtree_descend(corners, H, W, 1)

    # brightest pixel of the box: each block's first max of r + g + b in
    # its rows of the box, then the largest, first in row-major order
    vals, maxes, firsts = [], [], []
    for i, (r, g, b) in enumerate(planes):
        a, z = max(r0 - i * Hl, 0), min(r0 + h - i * Hl, Hl)
        if a >= z:
            continue
        crop = [p[a:z, c0:c0 + w] for p in (r, g, b)]
        score = (crop[0] + crop[1] + crop[2]).reshape(-1)
        li = torch.argmax(score)
        maxes.append(score[li].to(home))
        firsts.append((li // w + (i * Hl + a)) * W + c0 + li % w)
        vals.append(torch.stack([p.reshape(-1)[li] for p in crop]).to(home))
    maxes = torch.stack(maxes)
    gidx = torch.stack([f.to(home) for f in firsts])
    cand = torch.where(maxes == maxes.max(), gidx,
                       torch.iinfo(gidx.dtype).max)
    A = torch.stack(vals)[torch.argmin(cand)]
    return _replicate(A, [pl[0] for pl in planes])


# ---------------------------------------------------------------------------
# fast guided filter + dehaze chain
# ---------------------------------------------------------------------------

def _box_rows_sharded(stacks, ry: int, rx: int, rows_out: int) -> list:
    """Mean over ry rows x rx columns of (rows, C, W) row-sharded stacks,
    cv2 REFLECT_101 borders: ``boxfilter.box_filter`` with the row border
    from a halo exchange."""
    inv = float(_f32(1.0) / _f32(ry * rx))
    start = ry - ry // 2
    out = []
    for ext in _exchange_halo(stacks, ry):
        ext = _pad_cols(ext, rx // 2, rx - 1 - rx // 2)
        s = _window_sum(_window_sum(ext, ry, 0), rx, 2)
        out.append(s[start:start + rows_out] * inv)
    return out


def _guided_fast_sharded_strip(Is, ps, r: int, eps: float, s: int = 4,
                               valid_to: int | None = None) -> list:
    """``guided.guided_filter_fast`` on row blocks whose height is not a
    multiple of the stride s (2160 rows over 8 positions: 270), or of a
    padded frame.  Each block rebuilds its span of the global coarse grid
    (every s-th row of the true frame) and the two box passes' margins by
    gathering fine halo rows at computed offsets, runs the passes on it,
    and gathers the REFLECT_101-remapped coarse rows between them: every
    window sees the rows, in the order, of the single-device filter, so
    the result is bit-equal for any block height."""
    n, (Hl, W) = len(Is), Is[0].shape
    # the coarse grid of the true frame: pad rows never enter the model
    H = Hl * n if valid_to is None else valid_to
    Hc = -(-H // s)                     # global coarse rows
    rs = max(r // s, 2)
    Kc = (Hl - 1) // s + 2              # coarse rows spanning one block
    M1 = rs                             # a/b margin beyond the span
    K1 = Kc + 2 * M1                    # pass-1 output rows
    K0 = K1 + rs - 1                    # strip input rows
    hf = (M1 + rs + 1) * s              # fine halo reach
    K2 = Kc + rs - 1
    inv = float(_f32(1.0) / _f32(rs * r))
    pxl, pxh = r // 2, r - 1 - r // 2

    def remap(c):                       # REFLECT_101 on the coarse grid
        c = np.abs(c)
        return np.where(c > Hc - 1, 2 * (Hc - 1) - c, c)

    def box(x):
        x = _pad_cols(x, pxl, pxh)
        return _window_sum(_window_sum(x, rs, 0), r, 2) * inv

    out = []
    exts = _exchange_halo([torch.stack([I, p], dim=1)
                           for I, p in zip(Is, ps)], hf)
    for i, (ext, I) in enumerate(zip(exts, Is)):
        dev = I.device
        s0 = i * Hl
        c_lo = s0 // s
        base1 = c_lo - M1               # coarse row of pass-1 output 0
        base0 = base1 - rs // 2         # coarse row of strip input 0
        gfine = remap(base0 + np.arange(K0)) * s
        strip = ext.index_select(0, _device_index(
            np.clip(gfine - (s0 - hf), 0, Hl + 2 * hf - 1), dev))
        Ist, pst = strip[:, 0], strip[:, 1]
        m1 = box(torch.stack([Ist, pst, Ist * pst, Ist * Ist], dim=1))
        mean_i, mean_p = m1[:, 0], m1[:, 1]
        cov = m1[:, 2] - mean_i * mean_p
        var = m1[:, 3] - mean_i * mean_i
        a = cov / (var + eps)
        b = mean_p - a * mean_i         # row j <-> coarse base1 + j
        gc2 = (c_lo - rs // 2) + np.arange(K2)
        ab = torch.stack([a, b], dim=1).index_select(0, _device_index(
            np.clip(remap(gc2) - base1, 0, K1 - 1), dev))
        m2 = box(ab)
        # pad rows (global row >= H) clip onto the last true coarse row;
        # the caller crops them away
        ci = np.clip((s0 + np.arange(Hl)) // s - c_lo, 0, Kc - 1)
        up = m2.index_select(0, _device_index(ci, dev))    # (Hl, 2, W)
        out.append(up[:, 0] * I + up[:, 1])
    return out


def _guided_fast_sharded(Is, ps, r: int, eps: float, s: int = 4,
                         valid_to: int | None = None) -> list:
    """``guided.guided_filter_fast`` on row blocks: every s-th row taken
    locally (on the global grid when Hl % s == 0; otherwise, or on a
    padded frame, the strip variant rebuilds the true frame's grid), the
    linear model boxed on the subsampled rows with halo'd windows, each
    row repeated s times back."""
    Hl = Is[0].shape[0]
    if Hl % s != 0 or valid_to is not None:
        return _guided_fast_sharded_strip(Is, ps, r, eps, s, valid_to)
    rs = max(r // s, 2)
    sts = [torch.stack([I[::s], p[::s], I[::s] * p[::s], I[::s] * I[::s]],
                       dim=1) for I, p in zip(Is, ps)]   # (hs, 4, W)
    hs = sts[0].shape[0]
    abs_ = []
    for m in _box_rows_sharded(sts, rs, r, hs):
        mean_i, mean_p = m[:, 0], m[:, 1]
        cov = m[:, 2] - mean_i * mean_p
        var = m[:, 3] - mean_i * mean_i
        a = cov / (var + eps)
        abs_.append(torch.stack([a, mean_p - a * mean_i], dim=1))
    out = []
    for mab, I in zip(_box_rows_sharded(abs_, rs, r, hs), Is):
        up = torch.repeat_interleave(mab, s, dim=0)[:Hl]
        out.append(up[:, 0] * I + up[:, 1])
    return out


def _restore_sharded(planes, A, omega, r: int, eps: float,
                     valid_to: int | None = None) -> list:
    """six's dehaze of each position's planes with the shared airlight:
    the dark channel's transmission refined by the row-sharded fast
    guided filter on the u8 gray guide, then the scene recovery."""
    ts, grays = [], []
    for p, a in zip(planes, A):
        Ae = a + 1e-6
        dark = torch.minimum(torch.minimum(p[0] / Ae[0], p[1] / Ae[1]),
                             p[2] / Ae[2])
        ts.append(torch.clamp(1.0 - omega * dark, 0.1, 1.0))
        grays.append(cs.u8_to_unit(cs.gray_u8_planes(
            *(cs.quantize_u8(c) for c in p))))
    ts = [torch.clamp(t, 0.1, 1.0)
          for t in _guided_fast_sharded(grays, ts, r, eps, valid_to=valid_to)]
    return [tuple(torch.clamp((c - a[k]) / t + a[k], 0.0, 1.0)
                  for k, c in enumerate(p))
            for p, t, a in zip(planes, ts, A)]


# ---------------------------------------------------------------------------
# CLAHE-LAB round trip (whole tile rows a position; one LUT all-gather)
# ---------------------------------------------------------------------------

def _clahe_rows_sharded(blocks, clip_limit: float, tiles: int, H: int,
                        W: int) -> list:
    """``histeq.clahe_u8`` of whole-tile-row blocks: local tile LUTs, one
    all-gather, the local blend; bit-identical to the single-device op
    (``spatial.clahe_spatial``'s construction)."""
    return _clahe_blocks(blocks, float(clip_limit), tiles, H, W)


def _clahe_lab_sharded(planes, clip_limit: float, tiles: int, H: int,
                       W: int) -> list:
    """The LAB-L CLAHE round trip of each position's (r, g, b) planes: the
    exact u8 LAB (K1b), CLAHE of L over the positions, the exact inverse
    (K3b), back to [0, 1]."""
    labs = [cs.rgb_to_lab_u8_exact_planes(*(cs.quantize_u8(c) for c in p))
            for p in planes]
    Ls = _clahe_rows_sharded([lab[0] for lab in labs], clip_limit, tiles,
                             H, W)
    return [tuple(cs.u8_to_unit(c)
                  for c in cs.lab_to_rgb_u8_exact_planes(L, lab[1], lab[2]))
            for L, lab in zip(Ls, labs)]


# ---------------------------------------------------------------------------
# the six strategies + the public entry
# ---------------------------------------------------------------------------

def _pad_rows_reflect101(img: torch.Tensor, pad: int) -> torch.Tensor:
    """``pad`` REFLECT_101 rows (cv2's BORDER_DEFAULT, which cv2's CLAHE
    also pads to tile multiples with) appended at the bottom."""
    if pad == 0:
        return img
    H = img.shape[0]
    if not pad < H:
        raise AssertionError(f"row pad {pad} >= frame height {H}")
    return torch.cat([img, img[H - 1 - pad:H - 1].flip(0)], dim=0)


def six_strategy_spatial(img, mesh: Mesh, tiles: int = 8):
    """All six strategies of one (H, W, 3) frame row-sharded over ``mesh``
    -> ((6, H, W, 3) f32 on ``mesh.devices[0]``, int32 cast code), the JAX
    program's per-image body of ``six_strategy_single(img, fast=True)``
    with exact LAB conversions.

    Any H works: when H is not a multiple of lcm(mesh.size, tiles) the
    frame is REFLECT_101-row-padded to the next one, computed and cropped;
    the percentiles, cast means, Canny and the airlight mask the pad rows,
    and only the windowed ops (the guided filter, CLAHE's tiles when H %
    tiles != 0) see the pad.  W must be a multiple of ``tiles`` and
    ``tiles`` of the mesh size."""
    img = _tensor(img).to(torch.float32)
    H, W, _ = img.shape
    D = mesh.size
    if not (W % tiles == 0 and tiles % D == 0):
        raise AssertionError(
            "needs W % tiles == 0 and whole CLAHE tile rows per device")
    align = math.lcm(D, tiles)
    Hp = -(-H // align) * align
    img = _pad_rows_reflect101(img, Hp - H)
    outs, code = _six_spatial_padded(img, mesh, tiles,
                                     H if Hp != H else None)
    if Hp != H:
        outs = outs[:, :H]
    return outs, code


def _cast_sharded(planes, Ht: int, W: int, valid_h) -> tuple:
    """Cast detection from the whole frame's channel means (each
    position's sums over its true rows, in XLA:CPU's order, added in mesh
    order, times f32(1 / (Ht * W))) and the correction of every block ->
    (planes, code)."""
    r_m, g_m, b_m = _psum_mean([torch.stack(p) for p in planes], Ht * W,
                               valid_h)
    greenish = (g_m > r_m) and (g_m > b_m) and ((g_m - r_m) > _f32(0.05))
    bluish = (b_m > r_m) and (b_m > g_m) and ((b_m - r_m) > _f32(0.05))
    code = 1 if greenish else 2 if bluish else 0
    # every channel times its scale (1, or 0.85 for g when greenish and b
    # when bluish), clipped to [0, 1]
    scale = (1.0, 0.85 if code == 1 else 1.0, 0.85 if code == 2 else 1.0)
    out = []
    for p in planes:
        out.append(tuple(torch.clamp(x * torch.full(
            (), k, dtype=torch.float32, device=x.device), 0.0, 1.0)
            for x, k in zip(p, scale)))
    return out, code


def _six_spatial_padded(img: torch.Tensor, mesh: Mesh, tiles: int,
                        valid_h: int | None):
    """The sharded six program on an alignment-padded frame; ``valid_h``
    is the true height (None: no padding).  -> ((6, H, W, 3), code).  The
    percentiles and CLAHE are bit-equal to the single-device hist-fast
    path on unpadded frames, Canny by the halo and ``valid_rows``; the
    airlight's corners and the cast means add each position's f32 sums in
    mesh order."""
    H, W, _ = img.shape
    D = mesh.size
    Ht = H if valid_h is None else valid_h
    # the stride-8 percentile rows below the true height (ch[::8])
    n_sub = (-(-Ht // 8)) * W
    blocks = _shard(img, mesh, "six_strategy_spatial")
    planes = [tuple(b[..., c].contiguous() for c in range(3))
              for b in blocks]
    planes, code = _cast_sharded(planes, Ht, W, valid_h)
    A = _airlight_sharded(planes, Ht, W, valid_to=valid_h)

    def st(p, lo, hi):
        return _stretch_planes(p, lo, hi, n_sub, valid_to=valid_h)

    def wb(p, pct):
        return _wb_planes(p, pct, n_sub, valid_to=valid_h)

    def cl(p, c):
        return _clahe_lab_sharded(p, c, tiles, H, W)

    def gm(p, g):
        return [tuple(gamma_correction_pow(c, g) for c in x) for x in p]

    def rst(omega, r, eps):
        return _restore_sharded(planes, A, omega, r, eps, valid_to=valid_h)

    s1 = gm(cl(st(rst(0.3, 20, 5e-1), 5.0, 98.0), 3.0), 1.5)
    s2 = cl(st(rst(0.5, 15, 5e-1), 15.0, 95.0), 2.0)
    s3 = wb(st(rst(0.7, 10, 1e-1), 20.0, 85.0), 2.0)
    s4 = gm(wb(st(cl(planes, 4.0), 10.0, 95.0), 3.0), 1.3)
    s5 = gm(cl(st(wb(planes, 2.0), 15.0, 90.0), 1.5), 1.2)
    s6 = gm(cl(st(planes, 5.0, 98.0), 3.5), 1.4)

    outs = _gather([torch.stack([torch.stack(s[i], dim=-1)
                                 for s in (s1, s2, s3, s4, s5, s6)])
                    for i in range(D)], dim=1)
    code = torch.tensor(code, dtype=torch.int32, device=outs.device)
    return outs, code
