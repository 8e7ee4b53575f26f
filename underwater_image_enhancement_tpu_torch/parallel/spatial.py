"""Row sharding of one frame over the port's one-process mesh: the JAX
package's ``parallel/spatial.py``.

A sharded frame is a list of row blocks, one a mesh position, in mesh
order, each on its position's device (``_shard``).  Where JAX runs one
``shard_map`` program, the port runs each step of its per-position
``local`` code as a loop over the blocks, and the collectives between the
steps are private helpers over lists of per-position partial results:

- ``_exchange_halo``: each block extended by ``halo`` rows of its
  neighbours, multi-hop when the halo is taller than a block (rows come
  from as many blocks as they span), then the rows past the frame's edges
  remapped as JAX remaps them (REFLECT_101 or replicate);
- ``_psum``, ``_pmax``, ``_pmin``, ``_all_gather``: the partials combined
  in mesh order on the first position's device, and the result copied back
  to each position (once a distinct device).  ``_psum`` adds left to
  right, ``((p0 + p1) + p2) + ...``: the order in which ``lax.psum`` adds
  over the JAX suite's CPU devices (bit for bit on f32 values spread over
  40 binades on 2, 4 and 8 devices, where the right fold differs:
  ``tests/test_torch_spatial.py::test_psum_order_equals_jax``).  Integer sums are
  exact in any order.  ``_psum_host`` is the same fold of host (numpy)
  partials, for values the host reads anyway; ``_psum_mean`` the means
  of a frame from its blocks' sums in XLA:CPU's order
  (``reduce.xla_sum``), as JAX's program sums a block.

No threads and no ``torch.distributed``: one host thread issues each
position's work in turn, and positions may repeat a device.

- ``box_filter_spatial``: cv2's box filter with the row border from a halo
  exchange.
- ``stretch_spatial``: the percentile stretch from a 4096-bin histogram
  summed across positions (as f32, as JAX sums it).
- ``enhance_spatial``: the predictor's enhance (stretch, A = 0.6 dehaze,
  gamma) of a frame too large for one device.
- ``guided_filter_spatial``: the guided filter, two halo exchanges.
- ``clahe_spatial``: CLAHE on whole tile rows a position: local tile LUTs,
  one all-gather, the bilinear blend with the rows offset by the block's
  first row; bit-equal to ``histeq.clahe_u8``.

Each function takes the port's ``Mesh`` and an (H, W) or (H, W, 3) tensor
or numpy array and returns the whole result on ``mesh.devices[0]``.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops.boxfilter import (
    _reflect_101,
    _window_sum,
)
from underwater_image_enhancement_tpu_torch.ops.histeq import (
    ClaheGeometry,
    _clahe_luts,
    _clahe_weights,
    _geometry,
)
from underwater_image_enhancement_tpu_torch.ops.layout import div
from underwater_image_enhancement_tpu_torch.ops.reduce import xla_sum
from underwater_image_enhancement_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    _tensor,
)

_f32 = np.float32


# ---------------------------------------------------------------------------
# blocks and collectives
# ---------------------------------------------------------------------------

def _shard(x, mesh: Mesh, name: str = "spatial"):
    """Rows of x (a tensor or numpy array, rows first) cut into mesh.size
    equal blocks, each moved to its position's device; f32 unless x is an
    integer array."""
    x = _tensor(x)
    if not x.dtype.is_floating_point:
        x = x.to(torch.int32)
    else:
        x = x.to(torch.float32)
    D = mesh.size
    if x.shape[0] % D:
        raise ValueError(f"{name}: {x.shape[0]} rows do not divide over "
                         f"{D} mesh positions")
    hl = x.shape[0] // D
    return [x[i * hl:(i + 1) * hl].to(dev)
            for i, dev in enumerate(mesh.devices)]


def _gather(blocks, dim: int = 0) -> torch.Tensor:
    """Per-position blocks concatenated along ``dim`` on the first
    position's device (``mesh.gather_shards``)."""
    home = blocks[0].device
    return torch.cat([b.to(home) for b in blocks], dim=dim)


def _replicate(value: torch.Tensor, blocks) -> list:
    """``value`` copied to each position's device, once a distinct
    device."""
    copies: Dict[torch.device, torch.Tensor] = {}
    out = []
    for b in blocks:
        if b.device not in copies:
            copies[b.device] = value.to(b.device)
        out.append(copies[b.device])
    return out


def _fold(parts, op) -> list:
    """The positions' partials combined by ``op`` in mesh order, op(op(p0,
    p1), p2) ..., on the first position's device; the result copied back
    to each position."""
    home = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p.to(home))
    return _replicate(acc, parts)


def _psum(parts) -> list:
    """``lax.psum``: ((p0 + p1) + p2) + ... (``_fold``)."""
    return _fold(parts, torch.add)


def _pmax(parts) -> list:
    return _fold(parts, torch.maximum)


def _pmin(parts) -> list:
    return _fold(parts, torch.minimum)


def _psum_host(parts) -> np.ndarray:
    """``_psum`` of host partials (numpy f32 or ints), one value for every
    position."""
    acc = np.asarray(parts[0])
    for p in parts[1:]:
        acc = acc + np.asarray(p)
    return acc


def _block_sums(stacks) -> list:
    """Each position's (P, Hl, W) stack summed over (Hl, W) in XLA:CPU's
    order (``reduce.xla_sum``, a block's ``jnp.sum`` in JAX's program) ->
    one (P,) f32 numpy array a position.  The stacks of positions that
    share a device are reduced together."""
    by_dev: Dict[torch.device, list] = {}
    for k, s in enumerate(stacks):
        by_dev.setdefault(s.device, []).append(k)
    out = [None] * len(stacks)
    for ks in by_dev.values():
        sums = xla_sum(torch.stack([stacks[k] for k in ks]), 2).cpu().numpy()
        for k, v in zip(ks, sums):
            out[k] = v
    return out


def _psum_mean(stacks, n: int, valid_h: int | None = None) -> np.ndarray:
    """Means over a frame's n true pixels of each position's (P, Hl, W)
    stack: each block's sums over its rows above ``valid_h`` (the rows of
    a padded frame's true height; all where None) in XLA:CPU's order,
    added in mesh order, times f32(1 / n) -> (P,) f32 numpy, the same on
    every position."""
    if valid_h is not None:
        hl = stacks[0].shape[1]
        keep = [int(np.clip(valid_h - i * hl, 0, hl))
                for i in range(len(stacks))]
        stacks = [torch.cat([x[:, :k], torch.zeros_like(x[:, k:])], 1)
                  for x, k in zip(stacks, keep)]
    return _psum_host(_block_sums(stacks)) * _f32(_f32(1.0) / _f32(n))


def _all_gather(parts, dim: int = 0) -> list:
    """``lax.all_gather(..., tiled=True)``: the partials concatenated
    along ``dim`` in mesh order, on every position."""
    return _replicate(_gather(parts, dim), parts)


@functools.lru_cache(maxsize=256)
def _halo_plan(hl: int, n: int, i: int, halo: int, edge: str):
    """Global source rows of position i's extended block (hl + 2*halo rows)
    as JAX builds them: the ring-wrapped neighbours' rows (s0 - halo + p)
    mod H, then rows past [0, H) remapped to their REFLECT_101 or
    replicated source, clipped to the extension.  -> ((block, first,
    last) runs, the index of each extended row into their concatenation)."""
    Hg = hl * n
    s0 = i * hl
    L = hl + 2 * halo
    grow = s0 - halo + np.arange(L)
    if edge == "edge":
        src_g = np.clip(grow, 0, Hg - 1)
    else:
        src_g = np.where(grow < 0, -grow,
                         np.where(grow > Hg - 1, 2 * (Hg - 1) - grow, grow))
    src_p = np.clip(src_g - s0 + halo, 0, L - 1)
    rows = (s0 - halo + src_p) % Hg
    runs, offset, index = [], 0, np.empty(L, np.int64)
    for j in sorted(set((rows // hl).tolist())):
        local = rows[rows // hl == j] % hl
        lo, hi = int(local.min()), int(local.max())
        sel = rows // hl == j
        index[sel] = offset + rows[sel] % hl - lo
        runs.append((j, lo, hi + 1))
        offset += hi + 1 - lo
    return tuple(runs), index


def _exchange_halo(blocks, halo: int, edge: str = "reflect101") -> list:
    """Each row block (rows first) extended by ``halo`` rows of its
    neighbours on each side, on its own device: multi-hop when the halo
    is taller than a block (rows come from every block they span).  Rows
    past the frame's edges are remapped after assembly, as JAX's
    ``_exchange_halo`` does: ``"reflect101"`` mirrors rows 1..halo (cv2's
    BORDER_DEFAULT), ``"edge"`` replicates the first and last rows."""
    if edge not in ("reflect101", "edge"):
        raise ValueError(f"_exchange_halo: unknown edge {edge!r}")
    n, hl = len(blocks), blocks[0].shape[0]
    out = []
    for i, blk in enumerate(blocks):
        if halo == 0:
            out.append(blk)
            continue
        runs, index = _halo_plan(hl, n, i, halo, edge)
        pool = torch.cat([blocks[j][lo:hi].to(blk.device)
                          for j, lo, hi in runs])
        out.append(pool.index_select(0, _device_index(index, blk.device)))
    return out


_INDEX: Dict[tuple, torch.Tensor] = {}


def _device_index(index: np.ndarray, device) -> torch.Tensor:
    """An int64 index kept per device, so that a frame's exchanges copy no
    index to the card twice."""
    key = (index.tobytes(), str(device))
    if key not in _INDEX:
        if len(_INDEX) > 512:
            _INDEX.clear()
        _INDEX[key] = torch.as_tensor(index).to(device)
    return _INDEX[key]


def _pad_cols(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """REFLECT_101 pad of the last axis (``jnp.pad(mode="reflect")``)."""
    return x.index_select(-1, _reflect_101(x.shape[-1], lo, hi, x.device))


# ---------------------------------------------------------------------------
# box filter, stretch, enhance, guided filter
# ---------------------------------------------------------------------------

def box_filter_spatial(x, r: int, mesh: Mesh) -> torch.Tensor:
    """cv2-compatible box filter of a (H, W) frame sharded on rows (each
    block's rows filtered with a halo of r rows; the columns are whole).

    Requires H divisible by the mesh size."""
    halo = r
    lo, hi = r // 2, r - 1 - r // 2
    inv = float(_f32(1.0) / _f32(r * r))
    out = []
    for blk in _exchange_halo(_shard(x, mesh, "box_filter_spatial"), halo):
        s = _window_sum(_window_sum(_pad_cols(blk, lo, hi), r, 0), r, 1)
        start = halo - lo
        out.append(s[start:start + blk.shape[0] - 2 * halo] * inv)
    return _gather(out)


_BINS = 4096


def _histogram(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """Exact int32 counts of the int64 bin indices ``idx`` (one
    scatter-add, no host sync)."""
    hist = torch.zeros(bins, dtype=torch.int32, device=idx.device)
    flat = idx.reshape(-1)
    return hist.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))


def _quantile_from_hist(hist: torch.Tensor, vmin, vmax, q, n):
    """The value at percentile q of n values from a 4096-bin f32 histogram
    between vmin and vmax: the first bin whose count reaches the rank
    (``searchsorted``), times the bin width."""
    cdf = torch.cumsum(hist, 0)
    target = torch.tensor([q / 100.0 * (n - 1) + 1.0], dtype=torch.float32,
                          device=hist.device)
    b = torch.clamp(torch.searchsorted(cdf, target)[0], 0, _BINS - 1)
    # b * (vmax - vmin) / 4095: XLA multiplies by the f32 reciprocal
    return vmin + (b.to(torch.float32) * (vmax - vmin)) * float(
        _f32(1.0) / _f32(_BINS - 1))


def _stretch_blocks(blocks, l_low: float, l_high: float, n: int) -> list:
    """Per-channel percentile stretch of (Hl, W, 3) blocks with the
    percentiles of the whole frame (n pixels a channel)."""
    outs = [[] for _ in blocks]
    for c in range(3):
        chs = [b[..., c] for b in blocks]
        lo_all = _pmin([ch.amin() for ch in chs])
        hi_all = _pmax([ch.amax() for ch in chs])
        hists = []
        for ch, lo, hi in zip(chs, lo_all, hi_all):
            scale = torch.where(hi > lo, div(torch.full_like(hi, _BINS - 1),
                                             hi - lo), 0.0)
            idx = torch.clamp((ch - lo) * scale, 0, _BINS - 1).to(torch.int64)
            hists.append(_histogram(idx, _BINS).to(torch.float32))
        hist = _psum(hists)
        for k, (ch, h, lo, hi) in enumerate(zip(chs, hist, lo_all, hi_all)):
            p_lo = _quantile_from_hist(h, lo, hi, l_low, n)
            p_hi = _quantile_from_hist(h, lo, hi, l_high, n)
            outs[k].append(torch.clamp((ch - p_lo) / (p_hi - p_lo + 1e-8),
                                       0.0, 1.0))
    return [torch.stack(o, dim=-1) for o in outs]


def stretch_spatial(img, l_low: float, l_high: float,
                    mesh: Mesh) -> torch.Tensor:
    """Percentile stretch of a (H, W, 3) frame sharded on rows; the
    percentiles of the whole frame from a 4096-bin histogram a channel
    summed across positions (to 1/4096 of the range, as ``ops.stretch``'s
    method "hist")."""
    blocks = _shard(img, mesh, "stretch_spatial")
    n = sum(b.shape[0] for b in blocks) * blocks[0].shape[1]
    return _gather(_stretch_blocks(blocks, float(l_low), float(l_high), n))


def enhance_spatial(img, params, mesh: Mesh) -> torch.Tensor:
    """The predictor's enhance of one (H, W, 3) frame sharded on rows: the
    histogram percentile stretch, the A = 0.6 dehaze and the gamma
    (vgg_16_UIE.py:32-55)."""
    blocks = _shard(img, mesh, "enhance_spatial")
    n = sum(b.shape[0] for b in blocks) * blocks[0].shape[1]
    omega, gamma = float(params["omega"]), float(params["gamma"])
    out = []
    for blk in _stretch_blocks(blocks, float(params["L_low"]),
                               float(params["L_high"]), n):
        dark = blk.amin(dim=-1, keepdim=True)
        t = torch.clamp(1.0 - omega * dark, 0.1, 1.0)
        dehazed = torch.clamp((blk - 0.6) / t + 0.6, 0.0, 1.0)
        out.append(torch.clamp(torch.pow(dehazed + 1e-8, gamma), 0.0, 1.0))
    return _gather(out)


def guided_filter_spatial(guide, src, r: int, eps: float,
                          mesh: Mesh) -> torch.Tensor:
    """He et al.'s guided filter of one (H, W) frame sharded on rows: two
    halo exchanges, one a box-filter stage; the single-device
    ``ops.guided.guided_filter``'s values."""
    halo = r
    lo, hi = r // 2, r - 1 - r // 2
    inv = float(_f32(1.0) / _f32(r * r))

    def box(stack, h_rows):
        s = _window_sum(_window_sum(_pad_cols(stack, lo, hi), r, 1), r, 2)
        return s[:, halo - lo:halo - lo + h_rows] * inv

    g_blocks = _shard(guide, mesh, "guided_filter_spatial")
    p_blocks = _shard(src, mesh, "guided_filter_spatial")
    a_blocks, b_blocks = [], []
    for gh, ph, g in zip(_exchange_halo(g_blocks, halo),
                         _exchange_halo(p_blocks, halo), g_blocks):
        m = box(torch.stack([gh, ph, gh * ph, gh * gh]), g.shape[0])
        cov = m[2] - m[0] * m[1]
        var = m[3] - m[0] * m[0]
        a = cov / (var + eps)
        a_blocks.append(a)
        b_blocks.append(m[1] - a * m[0])
    out = []
    for ah, bh, g in zip(_exchange_halo(a_blocks, halo),
                         _exchange_halo(b_blocks, halo), g_blocks):
        mab = box(torch.stack([ah, bh]), g.shape[0])
        out.append(mab[0] * g + mab[1])
    return _gather(out)


# ---------------------------------------------------------------------------
# CLAHE on whole tile rows
# ---------------------------------------------------------------------------

def _clahe_blend_rows(xb: torch.Tensor, luts: torch.Tensor, ya, xa, geo,
                      row0: int) -> torch.Tensor:
    """CLAHE's bilinear LUT blend of the rows row0.. of a plane whose full
    (tiles, 256) LUT set is ``luts``: ``kernels.clahe_apply_plain`` with
    the rows offset by row0 (the four LUT values gathered, then the f32
    blend, each product and sum rounded, round half to even)."""
    th, tw, pt, plf, tiles_x, tiles_y = geo
    Hl, W = xb.shape
    dev = xb.device
    yb = torch.arange(Hl, device=dev) + (row0 + pt)
    xbi = torch.arange(W, device=dev) + plf
    i, j = yb // th, xbi // tw
    r1 = torch.clamp(i - 1, 0, tiles_y - 1)[:, None]
    r2 = torch.clamp(i, 0, tiles_y - 1)[:, None]
    c1 = torch.clamp(j - 1, 0, tiles_x - 1)[None, :]
    c2 = torch.clamp(j, 0, tiles_x - 1)[None, :]
    v = torch.clamp(xb, 0, 255).long()
    flat = luts.reshape(-1)

    def lut(rr, cc):
        return flat[(rr * tiles_x + cc) * 256 + v].to(torch.float32)

    wy, wx = ya[yb][:, None], xa[xbi][None, :]
    wy1, wx1 = 1.0 - wy, 1.0 - wx
    top = lut(r1, c1) * wx1 + lut(r1, c2) * wx
    bot = lut(r2, c1) * wx1 + lut(r2, c2) * wx
    val = top * wy1 + bot * wy
    return torch.clamp(torch.round(val), 0, 255).to(torch.int32)


def _clahe_blocks(blocks, clip_limit: float, tiles: int, H: int,
                  W: int) -> list:
    """CLAHE (``histeq.clahe_u8``, tiles x tiles) of u8-valued int32 row
    blocks that hold whole tile rows each: each position's tile LUTs, one
    all-gather of the (tiles * tiles, 256) set, each block blended with
    its rows' global offsets."""
    geo = _geometry(H, W, tiles, tiles)
    ty_local = tiles // len(blocks)
    local_geo = ClaheGeometry(geo.th, geo.tw, geo.pt, geo.plf, tiles,
                              ty_local)
    luts = _all_gather([_clahe_luts(b[None], local_geo, (clip_limit,))[0]
                        for b in blocks])
    ya_np, xa_np = _clahe_weights(geo)
    out = []
    weights: Dict[torch.device, tuple] = {}
    for k, (b, lt) in enumerate(zip(blocks, luts)):
        if b.device not in weights:
            weights[b.device] = (torch.as_tensor(ya_np).to(b.device),
                                 torch.as_tensor(xa_np).to(b.device))
        ya, xa = weights[b.device]
        out.append(_clahe_blend_rows(b, lt, ya, xa, geo, k * b.shape[0]))
    return out


def clahe_spatial(channel_u8, clip_limit: float, mesh: Mesh,
                  tiles: int = 8) -> torch.Tensor:
    """CLAHE of one (H, W) u8-valued plane sharded on tile rows: each
    position histograms and clips its own tile rows, one all-gather shares
    the (tiles * tiles, 256) LUT set, and the blend is local (a pixel
    reads the LUTs of its 4 surrounding tiles).  Bit-identical to the
    single-device ``histeq.clahe_u8``.

    Requires H, W divisible by ``tiles`` and ``tiles`` divisible by the
    mesh size (a block is whole tile rows)."""
    H, W = _tensor(channel_u8).shape
    D = mesh.size
    if not (H % tiles == 0 and W % tiles == 0 and tiles % D == 0):
        raise AssertionError("clahe_spatial needs tile-aligned sharding")
    blocks = _shard(_tensor(channel_u8).to(torch.int32), mesh,
                    "clahe_spatial")
    return _gather(_clahe_blocks(blocks, float(clip_limit), tiles, H, W))
