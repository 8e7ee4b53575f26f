"""Ancuti multi-scale fusion of ONE large frame sharded on rows over the
port's mesh: the JAX package's ``parallel/fusion_spatial.py``.

Three quarters of the pyramid blend's pixels are on the fine level, so
that level runs row-sharded, with 2-row halos (REFLECT_101 at the frame's
edges) for the 5-tap binomial blur; from the half-resolution level down,
G1 (2 inputs x 3 channels + 2 weight maps = 8 half-resolution planes) is
gathered once and the coarse levels run once a distinct device.  The
final collapse upsamples the coarse reconstruction back into each block
with one coarse halo row a side sliced from the gathered plane: at the
frame's top the halo reflects (coarse row 1), at its bottom it repeats the
last coarse row, which after the zero interleave gives ``pyr_up``'s
REFLECT_101 at the fine level.

The pipeline is ``pipeline/fusion.ancuti_fusion``'s: gray-world white
balance (the channel means of the whole frame, each position's sums in
XLA:CPU's order added in mesh order) and the sharded CLAHE-LAB round trip
(``six_spatial._clahe_lab_sharded``: K1b, CLAHE, K3b) as the two inputs,
Laplacian-contrast + saturation + saliency weight maps (the saliency's
means summed the same way), and the normalised blend over Gaussian and
Laplacian pyramids.

Shape rule: W % tiles == 0 and tiles % D == 0.  Any height works: the
frame is REFLECT_101-row-padded to the next multiple of lcm(2 * D, tiles)
and cropped after, the global means masking the pad rows.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops import pyramid
from underwater_image_enhancement_tpu_torch.ops.edges import laplacian
from underwater_image_enhancement_tpu_torch.ops.layout import div
from underwater_image_enhancement_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    _tensor,
)
from underwater_image_enhancement_tpu_torch.parallel.six_spatial import (
    _clahe_lab_sharded,
    _pad_rows_reflect101,
)
from underwater_image_enhancement_tpu_torch.parallel.spatial import (
    _all_gather,
    _exchange_halo,
    _gather,
    _psum_mean,
    _shard,
)
from underwater_image_enhancement_tpu_torch.pipeline.fusion import (
    _W_EPS,
    _fusion_levels,
    _lab_float,
    _recip,
)

AX = DATA_AXIS
_f32 = np.float32


def _blur5_sharded(blocks) -> list:
    """5x5 binomial blur of row-sharded (rows, ..., W) stacks: the term
    order of ``pyramid.blur5``, REFLECT_101 at the frame's edges by the
    halo's remap."""
    out = []
    for ext in _exchange_halo(blocks, 2):
        b = pyramid._blur5_axis(ext, 0)
        out.append(pyramid._blur5_axis(b, ext.dim() - 1)[2:-2])
    return out


def _pyr_down_sharded(blocks) -> list:
    """``pyr_down`` of row blocks of even height: a block's row 0 is
    globally even, so its even rows are those of the global grid."""
    return [b[::2][..., ::2] for b in _blur5_sharded(blocks)]


def _interleave_zeros(x: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., n, ...) -> (..., 2n, ...) with zeros in the odd slots of
    ``dim``."""
    shape = list(x.shape)
    shape[dim] *= 2
    return torch.stack([x, torch.zeros_like(x)], dim=dim + 1).reshape(shape)


def _pyr_up_rows(coarse_rows: torch.Tensor, dst_h: int, dst_w: int):
    """``pyr_up`` of a (hc + 2, Wc) coarse block that carries one halo row
    a side -> the (dst_h, dst_w) centre rows."""
    up = _interleave_zeros(coarse_rows, 0)              # (dst_h + 4, Wc)
    up = _interleave_zeros(up, 1)[:, :dst_w]
    b = pyramid._blur5_axis(pyramid._blur5_axis(up, 0, 4.0), 1)
    return b[2:-2]


def _coarse_rows_with_halo(rep: torch.Tensor, c0: int, hc: int):
    """Rows [c0-1, c0+hc+1) of a gathered coarse plane, with the frame
    borders that give ``pyr_up``'s fine-level REFLECT_101 after the zero
    interleave: the top halo row reflects (fine pad row -2 = fine row 2 =
    coarse row 1), the bottom one repeats the last coarse row (fine pad
    row H reflects to fine row H-2 = coarse Hc-1, since fine row H-1 is a
    zero slot)."""
    padded = torch.cat([rep[1:2], rep, rep[-1:]], dim=0)
    return padded[c0:c0 + hc + 2]


def _weight_map_sharded(planes, H: int, W: int, valid_h=None) -> list:
    """``pipeline.fusion``'s weight map (Laplacian contrast + saturation +
    saliency / 100) of each position's (r, g, b) planes, with halo'd
    Laplacian and blurs and the saliency's Lab means over the whole
    frame's H true rows."""
    labs = [_lab_float(p) for p in planes]
    means = _psum_mean([torch.stack(lab) for lab in labs], H * W, valid_h)
    lums = [0.299 * p[0] + 0.587 * p[1] + 0.114 * p[2] for p in planes]
    contrast = [torch.abs(laplacian(e, ksize=1))[1:-1]
                for e in _exchange_halo(lums, 1)]
    blurred = _blur5_sharded([torch.stack(lab, dim=1) for lab in labs])
    m = [torch.tensor(float(v), device=lums[0].device) for v in means]
    out = []
    for p, lum, wc, bl in zip(planes, lums, contrast, blurred):
        d = [c - lum for c in p]
        w_sat = torch.sqrt((d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
                           * _recip(3.0))
        ds = [bl[:, j] - m[j].to(bl.device) for j in range(3)]
        w_sal = torch.sqrt(ds[0] * ds[0] + ds[1] * ds[1] + ds[2] * ds[2])
        out.append(wc + w_sat + w_sal * _recip(100.0))
    return out


def ancuti_fusion_spatial(img, mesh: Mesh, tiles: int = 8) -> torch.Tensor:
    """``pipeline.fusion.ancuti_fusion`` of one (H, W, 3) frame sharded on
    rows -> (H, W, 3) f32 on ``mesh.devices[0]``.

    Any H works: a frame whose height does not divide into even
    whole-tile blocks is REFLECT_101-row-padded to the next multiple of
    lcm(2 * mesh.size, tiles), computed and cropped; the white balance's
    and the saliency's means mask the pad rows.  Where that pad target is
    cv2's own CLAHE pad (tiles * ceil(H / tiles)) the result is the single
    device's to float noise; where it overshoots it (H = 120 over 4
    positions pads to 128) the sharded CLAHE runs a one-row-coarser tile
    grid, a valid fusion of the same frame."""
    img = _tensor(img).to(torch.float32)
    H, W, _ = img.shape
    D = mesh.size
    if not (W % tiles == 0 and tiles % D == 0):
        raise AssertionError
    align = math.lcm(2 * D, tiles)
    Hp = -(-H // align) * align
    img = _pad_rows_reflect101(img, Hp - H)
    out = _fusion_spatial_padded(img, mesh, tiles, H if Hp != H else None)
    return out[:H] if Hp != H else out


def _fusion_spatial_padded(img: torch.Tensor, mesh: Mesh, tiles: int,
                           valid_h: int | None) -> torch.Tensor:
    H, W, _ = img.shape
    D = mesh.size
    Ht = H if valid_h is None else valid_h    # the true (unpadded) height
    levels = _fusion_levels(Ht, W)            # the true frame's levels
    Hl = H // D
    blocks = _shard(img, mesh, "ancuti_fusion_spatial")
    p = [tuple(b[..., c].contiguous() for c in range(3)) for b in blocks]

    # gray-world white balance on the whole frame's channel means
    means = _psum_mean([torch.stack(x) for x in p], Ht * W, valid_h)
    gray = (means[0] + means[1] + means[2]) * _f32(_recip(3.0))
    wb = []
    for x in p:
        dev = x[0].device
        g = torch.tensor(float(gray), device=dev)
        wb.append(tuple(torch.clamp(div(c * g, float(max(m, _f32(1e-6)))),
                                    0.0, 1.0) for c, m in zip(x, means)))
    cl = _clahe_lab_sharded(wb, 2.0, tiles, H, W)

    w1 = _weight_map_sharded(wb, Ht, W, valid_h)
    w2 = _weight_map_sharded(cl, Ht, W, valid_h)
    w1n, w2n = [], []
    for a, b in zip(w1, w2):
        norm = a + b + 2.0 * _W_EPS
        w1n.append(div(a + _W_EPS, norm))
        w2n.append(div(b + _W_EPS, norm))

    if levels == 1:
        # one level: the blend is the weighted average
        return _gather([torch.clamp(torch.stack(
            [u * x[c] + v * y[c] for c in range(3)], dim=-1), 0.0, 1.0)
            for u, v, x, y in zip(w1n, w2n, wb, cl)])

    # 8 fine planes a block, rows first: 2 inputs x 3 channels + 2 weights
    fine = [torch.stack(list(x) + list(y) + [u, v], dim=1)
            for x, y, u, v in zip(wb, cl, w1n, w2n)]
    g1 = _all_gather(_pyr_down_sharded(fine))      # (Hc, 8, Wc) everywhere
    hc = Hl // 2

    # the coarse levels once a distinct device, on the gathered G1s
    rec: Dict[torch.device, torch.Tensor] = {}
    for g in g1:
        if g.device in rec:
            continue
        w_pyrs = [pyramid.gaussian_pyramid(g[:, 6 + k], levels - 1)
                  for k in range(2)]
        i_pyrs = [pyramid.laplacian_pyramid(
            torch.movedim(g[:, 3 * k:3 * k + 3], 1, 0), levels - 1)
            for k in range(2)]
        fused = [w_pyrs[0][lvl][None] * i_pyrs[0][lvl]
                 + w_pyrs[1][lvl][None] * i_pyrs[1][lvl]
                 for lvl in range(levels - 1)]
        rec[g.device] = pyramid.reconstruct(fused)  # (3, Hc, Wc)

    out = []
    for i, (f, g, u, v) in enumerate(zip(fine, g1, w1n, w2n)):
        def up0(coarse):
            return _pyr_up_rows(_coarse_rows_with_halo(coarse, i * hc, hc),
                                Hl, W)

        lap0 = [f[:, k] - up0(g[:, k]) for k in range(6)]
        rec1 = rec[g.device]
        out.append(torch.clamp(torch.stack(
            [u * lap0[c] + v * lap0[3 + c] + up0(rec1[c]) for c in range(3)],
            dim=-1), 0.0, 1.0))
    return _gather(out)
