"""Quadtree atmospheric-light estimation, exact per-block-Canny descent.

Reference: six_stadigy.py:48-157.  From the full frame, split into four
children, score each with Q = mean brightness + (B+G-2R)/n - mean channel
variance - Canny edge density of the child crop, descend into the best
(first max wins), stop at ``min_size``, and return the RGB of the
brightest pixel (max R+G+B, first in row-major order) of the final box.

Counterpart of the JAX package's ``quadtree_airlight_exact_planes``: the
brightness and variance sums come from row-prefix tables (SAT corners),
the edge term from Canny on each child crop (the four children of a level
batched into one (4, bh, bw) call, with the crop's last row and column
replicated to the level's buffer size).  The descent runs on the host: one
device-to-host read per quadtree level (about log2(min(H, W)) of them),
which this first slice accepts.

Summation order matters here (near-tie descents flip on last-bit
differences), so the prefix sums are not ``torch.cumsum``: ``xla_cumsum``
reproduces the association XLA:CPU gives the reference's ``jnp.cumsum``
(blocks of 16 summed in order, block totals scanned recursively and added
as an exclusive prefix).  It is built from elementwise adds, so the CPU and
the card give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops.colorspace import (
    gray_u8_planes,
    quantize_u8,
)
from underwater_image_enhancement_tpu_torch.ops.edges import canny_u8

_SCAN_BLOCK = 16


def xla_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive f32 prefix sum along ``dim`` with XLA:CPU's association."""
    dim = dim % x.dim()
    n = x.shape[dim]
    xm = x.movedim(dim, -1)
    if n <= _SCAN_BLOCK:
        out = torch.empty_like(xm)
        acc = xm[..., 0]
        out[..., 0] = acc
        for k in range(1, n):
            acc = acc + xm[..., k]
            out[..., k] = acc
        return out.movedim(-1, dim)
    nb = -(-n // _SCAN_BLOCK)
    pad = nb * _SCAN_BLOCK - n
    xp = torch.nn.functional.pad(xm, (0, pad)) if pad else xm
    blocks = xp.reshape(xp.shape[:-1] + (nb, _SCAN_BLOCK))
    inner = xla_cumsum(blocks, -1)
    outer = xla_cumsum(inner[..., -1], -1)
    excl = torch.nn.functional.pad(outer[..., :-1], (1, 0))
    res = (inner + excl[..., None]).reshape(xp.shape)[..., :n]
    return res.movedim(-1, dim)


def _sat_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-prefix table with a leading zero row: (P, H, W) -> (P, H+1, W)."""
    return torch.nn.functional.pad(xla_cumsum(x, -2), (0, 0, 1, 0))


def _corner_grid(sat_rows: torch.Tensor, rows, cols) -> torch.Tensor:
    """(P, H+1, W) row prefixes, 3 rows and 3 cols (host ints) -> (P, 3, 3)
    SAT corners: grid[p, t, s] = sum of plane p over [0, rows[t]) x
    [0, cols[s])."""
    strip = sat_rows[:, list(rows), :]
    c = torch.nn.functional.pad(xla_cumsum(strip, -1), (1, 0))
    return c[:, :, list(cols)]


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
