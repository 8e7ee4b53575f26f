"""Quadtree atmospheric-light estimation: the exact per-block-Canny descent
and the banded-SAT descent of the ``--fast`` tier.

Reference: six_stadigy.py:48-157.  From the full frame, split into four
children, score each with Q = mean brightness + (B+G-2R)/n - mean channel
variance - Canny edge density of the child crop, descend into the best
(first max wins), stop at ``min_size``, and return the RGB of the
brightest pixel (max R+G+B, first in row-major order) of the final box.

``quadtree_airlight_exact_planes`` is the JAX package's function of the
same name: the brightness and variance sums come from row-prefix tables
(SAT corners), the edge term from Canny on each child crop (the four
children of a level batched into one (4, bh, bw) call, with the crop's last
row and column replicated to the level's buffer size).

``quadtree_airlight_planes`` is the JAX package's banded SAT (its
``quadtree_airlight_planes``): one global Canny edge map is an eighth
statistic plane, only the sums of bands of ``_BAND`` rows are
prefix-summed, and each corner row is rebuilt from the band prefix plus
the masked sum of the fewer than ``_BAND`` rows left.

Both descents run on the host: one device-to-host read per quadtree level
(about log2(min(H, W)) of them).  ``quadtree_airlight[_exact|_batch]`` are
the JAX package's forms on (H, W, 3) images and batches, and
``quadtree_descend`` its descent on a caller's SAT corners.

Summation order matters here (near-tie descents flip on last-bit
differences), so every f32 sum repeats the association XLA:CPU gives the
reference:

- prefix sums (``jnp.cumsum``): ``kernels.sat_rows`` (csrc/scan.cu; its
  plain version ``kernels.xla_cumsum``): blocks of 16 summed in order,
  block totals scanned recursively and added as an exclusive prefix;
- sums over fewer than 32 values (the band sums, the in-band remainders):
  in order, x0 + x1 + ... (``reduce.seq_sum``);
- longer sums (the corners' masked sums over W): XLA:CPU's tree-reduction
  rewrite, windows of 32 with the axis zero-padded to a multiple of 32
  (half the padding in front), each window summed in order, repeated on
  the window sums while more than 32 remain (``reduce.xla_sum``).

The prefix sums run as one kernel on the card; the short sums are
elementwise adds of tensors, and the long ones host numpy f32 adds, so the
CPU path and the card give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops.colorspace import (
    gray_u8_planes,
    quantize_u8,
)
from underwater_image_enhancement_tpu_torch.ops.edges import canny_u8
from underwater_image_enhancement_tpu_torch.ops.reduce import seq_sum, xla_sum

_BAND = 8        # banded-SAT row stride (the JAX package's _BAND)


def _sat_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-prefix table with a leading zero row: (P, H, W) -> (P, H+1, W)."""
    return kernels.sat_rows(x.contiguous(), -2)


def _corner_grid(sat_rows: torch.Tensor, rows, cols) -> torch.Tensor:
    """(P, H+1, W) row prefixes, 3 rows and 3 cols (host ints) -> (P, 3, 3)
    SAT corners: grid[p, t, s] = sum of plane p over [0, rows[t]) x
    [0, cols[s])."""
    strip = sat_rows[:, list(rows), :]
    return kernels.sat_rows(strip, -1)[:, :, list(cols)]


def _level_plan(H: int, W: int, min_size: int):
    """Per-level max child sizes: repeated floor/ceil halving keeps each
    level's sizes within {a, a+1}, so a buffer of the level maximum holds
    any child reachable at that depth."""
    h_set, w_set = {H}, {W}
    plan = []
    while max(h_set) > min_size and max(w_set) > min_size:
        h_set = {s for h in h_set for s in (h // 2, h - h // 2)}
        w_set = {s for w in w_set for s in (w // 2, w - w // 2)}
        plan.append((max(h_set), max(w_set)))
    return plan


def _edge_counts(gray: torch.Tensor, cand, bh: int, bw: int) -> torch.Tensor:
    """Canny edge count (4,) of each child crop (r, c, h, w) in ``cand``, on
    a (4, bh, bw) buffer with the crop's last row/col replicated outward."""
    dev = gray.device
    rows = np.stack([r + np.minimum(np.arange(bh), h - 1)
                     for r, _, h, _ in cand])
    cols = np.stack([c + np.minimum(np.arange(bw), w - 1)
                     for _, c, _, w in cand])
    rows_t = torch.as_tensor(rows, device=dev)
    cols_t = torch.as_tensor(cols, device=dev)
    buf = gray[rows_t[:, :, None], cols_t[:, None, :]]
    hs = [h for _, _, h, _ in cand]
    ws = [w for _, _, _, w in cand]
    edges = canny_u8(buf, 50, 150, valid_hw=(hs, ws))
    return edges.sum(dim=(1, 2))


def _scores(grid: np.ndarray, ec: np.ndarray, cand) -> np.ndarray:
    """Q of the 4 children from the (6, 3, 3) SAT corners and edge counts,
    in the reference's f32 operation order.  The JAX reference divides the
    variance sum by the literal 3.0, which XLA compiles to a multiply by
    the f32 reciprocal; so does this."""
    f32 = np.float32

    def box(ri, ci, rj, cj):
        return grid[:, rj, cj] - grid[:, ri, cj] - grid[:, rj, ci] + grid[:, ri, ci]

    sums = np.stack([box(0, 0, 1, 1), box(0, 1, 1, 2),
                     box(1, 0, 2, 1), box(1, 1, 2, 2)])  # (4, 6)
    ns = np.array([h * w for _, _, h, w in cand], np.float32)
    sr, sg, sb = sums[:, 0], sums[:, 1], sums[:, 2]
    s2r, s2g, s2b = sums[:, 3], sums[:, 4], sums[:, 5]
    t1 = (sr + sg + sb) / (f32(3.0) * ns)
    t2 = (sb + sg - f32(2.0) * sr) / ns

    def var(s1, s2):
        m = s1 / ns
        return s2 / ns - m * m

    t3 = (var(sr, s2r) + var(sg, s2g) + var(sb, s2b)) * (f32(1.0) / f32(3.0))
    return t1 + t2 - t3 - ec.astype(np.float32) / ns


def _stats7(x):
    """The descent's statistic planes [r, g, b, r^2, g^2, b^2, e] from
    [r, g, b, e] stacked on the first axis (tensor or numpy array)."""
    cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
    return cat([x[:3], x[:3] * x[:3], x[3:]])


def quadtree_airlight_planes(planes, min_size: int = 1, edge_iters: int = 64,
                             return_box: bool = False):
    """Banded-SAT descent with one global Canny edge map (hysteresis
    bounded to ``edge_iters`` rounds; the ``--fast`` tier passes 4): (r, g,
    b) f32 planes (H, W) -> A (3,) f32 on their device (and the final
    (r0, c0, h, w) box when ``return_box``)."""
    r, g, b = planes
    H, W = r.shape
    gray = gray_u8_planes(*(quantize_u8(p) for p in planes))
    edge = canny_u8(gray, 50, 150,
                    hysteresis_iters=edge_iters).to(torch.float32)
    S = _BAND
    nb = -(-H // S)
    src = torch.stack([r, g, b, edge])                      # (4, H, W)
    stats = F.pad(_stats7(src), (0, 0, 0, nb * S - H)).reshape(7, nb, S, W)
    band_prefix = kernels.sat_rows(seq_sum(stats, 2).contiguous(), -2)
    offs = np.arange(S)
    lanes = np.arange(W)
    r0, c0, h, w = 0, 0, H, W
    for _ in _level_plan(H, W, min_size):
        if not (h > min_size and w > min_size):
            break
        mh, mw = h // 2, w // 2
        cand = [(r0, c0, mh, mw), (r0, c0 + mw, mh, w - mw),
                (r0 + mh, c0, h - mh, mw), (r0 + mh, c0 + mw, h - mh, w - mw)]
        rows = np.array([r0, r0 + mh, r0 + h])
        cols = np.array([c0, c0 + mw, c0 + w])
        bidx = rows // S
        ids = np.clip(bidx[:, None] * S + offs[None, :], 0, H - 1)
        idx = torch.as_tensor(np.concatenate([bidx, ids.reshape(-1)]),
                              device=r.device)
        # the one host read of this level: the band prefix at the three
        # corner rows and the raw rows of their bands
        host = torch.cat([
            band_prefix.index_select(1, idx[:3]).reshape(-1, W),
            src.index_select(1, idx[3:]).reshape(-1, W)]).cpu().numpy()
        base = host[:21].reshape(7, 3, W)
        seg = host[21:].reshape(4, 3, S, W)
        m = (offs[None, :] < (rows - bidx * S)[:, None]).astype(np.float32)
        part = seq_sum(_stats7(seg) * m[None, :, :, None], 2)  # (7, 3, W)
        strip = base + part
        cmask = (lanes[None, :] < cols[:, None]).astype(np.float32)
        grid = xla_sum(strip[:, :, None, :] * cmask[None, None], 1)
        se = (grid[6, 1:, 1:] - grid[6, :-1, 1:] - grid[6, 1:, :-1]
              + grid[6, :-1, :-1]).reshape(-1)
        k = int(np.argmax(_scores(grid[:6], se, cand)))
        r0, c0, h, w = cand[k]
    A = _brightest_pixel(planes, r0, c0, h, w)
    return (A, (r0, c0, h, w)) if return_box else A


def quadtree_airlight_exact_planes(planes, min_size: int = 1,
                                   return_box: bool = False):
    """(r, g, b) f32 planes (H, W) -> A (3,) f32 on their device (and the
    final (r0, c0, h, w) box when ``return_box``)."""
    r, g, b = planes
    H, W = r.shape
    gray = gray_u8_planes(*(quantize_u8(p) for p in planes))
    sats = _sat_rows(torch.stack([r, g, b, r * r, g * g, b * b]))
    r0, c0, h, w = 0, 0, H, W
    for bh, bw in _level_plan(H, W, min_size):
        if not (h > min_size and w > min_size):
            break
        mh, mw = h // 2, w // 2
        cand = [(r0, c0, mh, mw), (r0, c0 + mw, mh, w - mw),
                (r0 + mh, c0, h - mh, mw), (r0 + mh, c0 + mw, h - mh, w - mw)]
        grid = _corner_grid(sats, (r0, r0 + mh, r0 + h), (c0, c0 + mw, c0 + w))
        ec = _edge_counts(gray, cand, bh, bw)
        # the one host read of this level
        grid_np, ec_np = (t.cpu().numpy() for t in (grid, ec))
        k = int(np.argmax(_scores(grid_np, ec_np, cand)))
        r0, c0, h, w = cand[k]
    A = _brightest_pixel(planes, r0, c0, h, w)
    return (A, (r0, c0, h, w)) if return_box else A


def _brightest_pixel(planes, r0: int, c0: int, h: int, w: int) -> torch.Tensor:
    """RGB of the max-(R+G+B) pixel of the box, first in row-major order."""
    crop = [p[r0:r0 + h, c0:c0 + w] for p in planes]
    flat = int(torch.argmax((crop[0] + crop[1] + crop[2]).reshape(-1)))
    i, j = r0 + flat // w, c0 + flat % w
    return torch.stack([p[i, j] for p in planes])


def quadtree_descend(corners_fn, H: int, W: int, min_size: int = 1):
    """The quadtree descent on SAT corners: score the 4 children of each
    level from 9 corners, take the first best child, repeat down to
    ``min_size``.  corners_fn(rows (3,), cols (3,)) (host int arrays) ->
    (7, 3, 3) corners of the [r, g, b, r^2, g^2, b^2, edges] stack over
    [0, rows[t]) x [0, cols[s]) (a tensor or a numpy array; read to the
    host once a level).  Returns the final (r0, c0, h, w) box as ints."""
    r0, c0, h, w = 0, 0, H, W
    for _ in _level_plan(H, W, min_size):
        if not (h > min_size and w > min_size):
            break
        mh, mw = h // 2, w // 2
        cand = [(r0, c0, mh, mw), (r0, c0 + mw, mh, w - mw),
                (r0 + mh, c0, h - mh, mw), (r0 + mh, c0 + mw, h - mh, w - mw)]
        grid = corners_fn(np.array([r0, r0 + mh, r0 + h]),
                          np.array([c0, c0 + mw, c0 + w]))
        if isinstance(grid, torch.Tensor):
            grid = grid.cpu().numpy()
        grid = np.asarray(grid, np.float32)
        se = (grid[6, 1:, 1:] - grid[6, :-1, 1:] - grid[6, 1:, :-1]
              + grid[6, :-1, :-1]).reshape(-1)
        k = int(np.argmax(_scores(grid[:6], se, cand)))
        r0, c0, h, w = cand[k]
    return r0, c0, h, w


def _split(img: torch.Tensor):
    return tuple(img[..., c].contiguous() for c in range(3))


def quadtree_airlight(img: torch.Tensor, min_size: int = 1) -> torch.Tensor:
    """Airlight RGB (3,) of one (H, W, 3) image in [0, 1]: the banded-SAT
    descent with one global Canny edge map (``quadtree_airlight_planes``)."""
    return quadtree_airlight_planes(_split(img), min_size)


def quadtree_airlight_batch(imgs: torch.Tensor, min_size: int = 1
                            ) -> torch.Tensor:
    """(B, H, W, 3) -> (B, 3), ``quadtree_airlight`` of each image."""
    return torch.stack([quadtree_airlight(im, min_size) for im in imgs])


def quadtree_airlight_exact(img: torch.Tensor, min_size: int = 1
                            ) -> torch.Tensor:
    """Airlight RGB (3,) of one (H, W, 3) image by the exact descent, Canny
    rerun on every child crop (``quadtree_airlight_exact_planes``)."""
    return quadtree_airlight_exact_planes(_split(img), min_size)
