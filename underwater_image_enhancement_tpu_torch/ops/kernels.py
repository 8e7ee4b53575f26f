"""The hand-written CUDA kernels of the ported paths, their wrappers, and
their plain PyTorch versions.

Each wrapper checks its inputs, then dispatches on the input tensors'
device: a CPU tensor goes to the plain version, a CUDA tensor launches the
kernel through the extension built from ``csrc/`` (``utils/cuda_build.py``;
a failed build or launch raises, nothing falls back).  ``launches[name]``
counts kernel launches, and only those.

| wrapper                  | CUDA source             | replaces (pallas_kernels.py)   |
|--------------------------|-------------------------|--------------------------------|
| lab_forward_unit         | csrc/lab_forward.cu     | lab_forward_planes_unit        |
| lab_forward_unit_approx  | csrc/lab_forward.cu     | lab_forward_planes_unit_approx |
| lab_forward_unit_fast    | csrc/lab_forward.cu     | lab_forward_planes_unit_fast   |
| lab_forward_u8           | csrc/lab_forward.cu     | lab_forward_planes             |
| lab_forward_l_u8         | csrc/lab_forward.cu     | lab_forward_l_plane            |
| surrogate_corrections    | csrc/probe.cu           | _corrections (the probe)       |
| clahe_apply              | csrc/clahe_apply.cu     | clahe_apply                    |
| clahe_lab_apply          | csrc/clahe_lab_apply.cu | clahe_lab_apply                |
| lab_inverse_unit         | csrc/lab_inverse.cu     | lab_inverse_planes_unit        |
| lab_inverse_unit_gamma   | csrc/lab_inverse.cu     | lab_inverse_planes_unit_gamma  |
| lab_inverse_u8           | csrc/lab_inverse.cu     | lab_inverse_planes             |
| hysteresis_propagate     | csrc/hysteresis.cu      | hysteresis_propagate           |
| sat_rows                 | csrc/scan.cu            | sat_rows (in XLA:CPU's order)  |

The plain versions repeat the kernels' integer and f32 arithmetic with
tensor ops (table indexing, ``torch.div(..., rounding_mode="trunc")`` for
C division, separate multiplies and adds), so they run on either device
and agree with the kernels bit for bit.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from underwater_image_enhancement_tpu_torch.ops import lab_tables as lt
from underwater_image_enhancement_tpu_torch.ops.layout import div
from underwater_image_enhancement_tpu_torch.ops.stretch import U8_GRID
from underwater_image_enhancement_tpu_torch.utils import cuda_build

launches: Dict[str, int] = {
    "lab_forward_unit": 0,
    "lab_forward_unit_approx": 0,
    "lab_forward_u8": 0,
    "lab_forward_l_u8": 0,
    "lab_forward_unit_fast": 0,
    "surrogate_corrections": 0,
    "clahe_apply": 0,
    "clahe_lab_apply": 0,
    "lab_inverse_unit": 0,
    "lab_inverse_unit_gamma": 0,
    "lab_inverse_u8": 0,
    "hysteresis_propagate": 0,
    "sat_rows": 0,
}

_TABLES: Dict[Tuple[str, str], torch.Tensor] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _table(name: str, device: torch.device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _TABLES:
        src = {"fwd": lt.FWD_TABLE, "fwd_u16": lt.FWD_TABLE_U16,
               "inv": lt.INV_TABLE, "inv_u8": lt.INV_TABLE_U8}[name]
        _TABLES[key] = torch.as_tensor(src, dtype=torch.int32).to(device)
    return _TABLES[key]


def _check(name: str, tensors, dtype, ndim: int | None = 2) -> torch.device:
    """Same device (the CPU or a CUDA card), dtype and non-empty shape
    (``ndim`` dimensions unless None); contiguous."""
    dev = tensors[0].device
    shape = tuple(tensors[0].shape)
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if (tuple(t.shape) != shape or 0 in shape
                or (ndim is not None and len(shape) != ndim)):
            raise ValueError(f"{name}: expected equal non-empty "
                             f"{ndim or 'N'}-D tensors, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _launch(name: str, *args, counter: str | None = None):
    """Run the extension's entry point ``name`` (csrc/bindings.cpp) on CUDA
    tensors and count the launch under ``counter`` (default ``name``); a
    build or launch error raises."""
    out = getattr(cuda_build.extension(), name)(*args)
    launches[counter or name] += 1
    return out


# ---------------------------------------------------------------------------
# Forward LAB (csrc/lab_forward.cu)
# ---------------------------------------------------------------------------

def _descale(v: torch.Tensor, n: int) -> torch.Tensor:
    return (v + (1 << (n - 1))) >> n


def ctrunc_div(v: torch.Tensor, d: int) -> torch.Tensor:
    """C integer division: truncates toward zero (``//`` floors)."""
    return torch.div(v, d, rounding_mode="trunc")


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """``(img * 255).astype(uint8)``: clip, then truncate; int32 out."""
    return torch.clamp(img * 255.0, 0.0, 255.0).to(torch.int32)


def lab_forward_u8_plain(r8, g8, b8, cbrt_fn=None, l_only: bool = False):
    """OpenCV RGB2Lab_b on u8-valued int32 planes (inputs clipped to
    [0, 255]) -> int32 (L, a, b), or L alone with ``l_only`` (one cube root,
    no fX/fZ).  ``cbrt_fn(idx)`` replaces the CBRT_TAB gather (the
    approximate tier's surrogate)."""
    tab = _table("fwd", r8.device)
    h = 2 + 9
    gamma, cbrt = tab[h:h + 256], tab[h + 256:]
    R, G, B = (gamma[torch.clamp(p, 0, 255).long()] for p in (r8, g8, b8))
    C = lt.COEFFS

    def cbrt_of(row):
        acc = R * int(C[row, 0]) + G * int(C[row, 1]) + B * int(C[row, 2])
        idx = torch.clamp(_descale(acc, lt.LAB_SHIFT), 0, lt.NCBRT - 1)
        return cbrt[idx.long()] if cbrt_fn is None else cbrt_fn(idx)

    clip = lambda v: torch.clamp(v, 0, 255)  # noqa: E731
    fY = cbrt_of(1)
    L = clip(_descale(lt.L_SCALE * fY + lt.L_SHIFT, lt.LAB_SHIFT2))
    if l_only:
        return L
    fX, fZ = cbrt_of(0), cbrt_of(2)
    a = clip(_descale(500 * (fX - fY) + (128 << lt.LAB_SHIFT2), lt.LAB_SHIFT2))
    b = clip(_descale(200 * (fY - fZ) + (128 << lt.LAB_SHIFT2), lt.LAB_SHIFT2))
    return L, a, b


def lab_forward_u8(r8, g8, b8):
    """Bit-exact RGB2LAB on u8-valued int32 planes (H, W), clipped to
    [0, 255] -> int32 (L, a, b) planes (kernel K1b)."""
    dev = _check("lab_forward_u8", (r8, g8, b8), torch.int32)
    if dev.type == "cpu":
        return lab_forward_u8_plain(r8, g8, b8)
    return _launch("lab_forward_u8", r8, g8, b8, _table("fwd_u16", dev))


def lab_forward_l_u8_plain(r8, g8, b8):
    return lab_forward_u8_plain(r8, g8, b8, l_only=True)


def lab_forward_l_u8(r8, g8, b8):
    """The L plane alone of ``lab_forward_u8``: one cube root and one output
    plane (kernel K4, the brightness metric's input)."""
    dev = _check("lab_forward_l_u8", (r8, g8, b8), torch.int32)
    if dev.type == "cpu":
        return lab_forward_l_u8_plain(r8, g8, b8)
    return _launch("lab_forward_l_u8", r8, g8, b8, _table("fwd_u16", dev))


def lab_forward_unit_plain(r, g, b):
    return lab_forward_u8_plain(quantize_u8(r), quantize_u8(g), quantize_u8(b))


def lab_forward_unit(r, g, b):
    """quantize_u8 + bit-exact RGB2LAB on f32 unit planes (H, W) -> int32
    (L, a, b) planes."""
    dev = _check("lab_forward_unit", (r, g, b), torch.float32)
    if dev.type == "cpu":
        return lab_forward_unit_plain(r, g, b)
    return _launch("lab_forward_unit", r, g, b, _table("fwd_u16", dev))


def _c32(v: float) -> float:
    """The f32 constant numpy gives for ``v``."""
    return float(np.float32(v))


def _newton_cbrt(t: torch.Tensor, steps: int) -> torch.Tensor:
    """f32 cube root as t * rcbrt(t)**2 (the JAX ``_newton_cbrt``): t
    clamped to 1e-30, rcbrt from the bit-trick seed ``0x54A21D2A - bits //
    3`` and ``steps`` division-free Newton steps r * ((4 - t*r*r*r) / 3)."""
    tc = torch.clamp(t, min=_c32(1e-30))
    r = (0x54A21D2A - torch.div(tc.view(torch.int32), 3,
                                rounding_mode="floor")).view(torch.float32)
    for _ in range(steps):
        r = r * ((4.0 - tc * (r * r) * r) * _c32(1.0 / 3.0))
    return tc * (r * r)


def cbrt_tab_surrogate(idx: torch.Tensor, steps: int = 4) -> torch.Tensor:
    """The JAX ``_cbrt_tab_surrogate(idx, steps)``: CBRT_TAB[idx] evaluated
    as round(labF(idx/2040) * 2**15), each f32 op rounded on its own in the
    JAX order.  Two steps are within 1 of the table; four differ from it on
    a few entries, which ``surrogate_corrections`` finds."""
    t = idx.to(torch.float32) * _c32(1.0 / 2040.0)
    f = torch.where(t < _c32(0.008856), t * _c32(7.787) + _c32(16.0 / 116.0),
                    _newton_cbrt(t, steps))
    return torch.round(f * 32768.0).to(torch.int32)


def cbrt_tab_approx(idx: torch.Tensor) -> torch.Tensor:
    """``cbrt_tab_surrogate(idx, 2)``: the six --fast tier's cube root."""
    return cbrt_tab_surrogate(idx, 2)


def ig_tab_surrogate(idx: torch.Tensor) -> torch.Tensor:
    """The JAX ``_ig_tab_surrogate``: INV_GAMMA_TAB[idx] evaluated as
    clip(round(255 * sRGB-gamma(idx/4096))), x**(1/2.4) as
    sqrt(sqrt(cbrt(x)))**5 with a 3-step Newton cube root and correctly
    rounded square roots."""
    x = idx.to(torch.float32) * _c32(1.0 / 4096.0)
    s = torch.sqrt(torch.sqrt(_newton_cbrt(x, 3)))
    s2 = s * s
    p = s2 * s2 * s
    g = torch.where(x <= _c32(0.0031308), x * _c32(12.92),
                    _c32(1.055) * p - _c32(0.055))
    return torch.clamp(torch.round(255.0 * g), 0, 255).to(torch.int32)


def lab_forward_unit_approx_plain(r, g, b):
    return lab_forward_u8_plain(quantize_u8(r), quantize_u8(g), quantize_u8(b),
                                cbrt_fn=cbrt_tab_approx)


def lab_forward_unit_approx(r, g, b):
    """The six --fast tier's forward LAB: as lab_forward_unit with the
    cube-root table replaced by ``cbrt_tab_approx`` (L, a, b each within 1
    of the exact conversion)."""
    dev = _check("lab_forward_unit_approx", (r, g, b), torch.float32)
    if dev.type == "cpu":
        return lab_forward_unit_approx_plain(r, g, b)
    return _launch("lab_forward_unit_approx", r, g, b, _table("fwd_u16", dev))


def apply_corrections(v: torch.Tensor, idx: torch.Tensor, corr) -> torch.Tensor:
    """The JAX ``_apply_corrections``: v + delta where idx == i, one fix-up
    after the other."""
    for i, d in zip(*corr):
        v = v + torch.where(idx == i, d, 0).to(v.dtype)
    return v


def lab_forward_unit_fast_plain(r, g, b):
    corr = surrogate_corrections("cbrt", r.device)
    if corr is None:
        return lab_forward_unit_plain(r, g, b)
    return lab_forward_u8_plain(
        quantize_u8(r), quantize_u8(g), quantize_u8(b),
        cbrt_fn=lambda idx: apply_corrections(cbrt_tab_surrogate(idx), idx,
                                              corr))


_FIXUPS: Dict[str, torch.Tensor] = {}


def _cbrt_fixups(dev: torch.device) -> torch.Tensor | None:
    """The probe's cube-root fix-ups on ``dev`` as one (2, k) int32 tensor
    (indices, deltas), copied once per device; None where the probe found
    too many differences, or a delta outside int16, the type in which the
    kernel keeps them (the kernel then reads the table)."""
    corr = surrogate_corrections("cbrt", dev)
    if corr is None or any(not -32768 <= d < 32768 for d in corr[1]):
        return None
    if str(dev) not in _FIXUPS:
        _FIXUPS[str(dev)] = torch.tensor(corr, dtype=torch.int32,
                                         device=dev).reshape(2, -1)
    return _FIXUPS[str(dev)]


def lab_forward_unit_fast(r, g, b):
    """lab_forward_unit with CBRT_TAB evaluated as the 4-step surrogate
    plus the fix-ups the probe found on this device (kernel K8 ``_fast``):
    bit-equal to lab_forward_unit by construction.  Where the probe returns
    None the same kernel reads the table, as the JAX kernel does."""
    dev = _check("lab_forward_unit_fast", (r, g, b), torch.float32)
    if dev.type == "cpu":
        return lab_forward_unit_fast_plain(r, g, b)
    return _launch("lab_forward_unit_fast", r, g, b, _table("fwd_u16", dev),
                   _cbrt_fixups(dev))


# ---------------------------------------------------------------------------
# The surrogate probe (csrc/probe.cu)
# ---------------------------------------------------------------------------

# table name -> (its surrogate, the table, the probe kernel's selector)
_SURROGATES = {
    "cbrt": (cbrt_tab_surrogate, lt.CBRT_TAB, 0),
    "inv_gamma": (ig_tab_surrogate, lt.INV_GAMMA_TAB, 1),
}
MAX_CORRECTIONS = 32
_CORRECTIONS: Dict[Tuple[str, str], object] = {}


def _probe_index(name: str, device) -> torch.Tensor:
    n = len(_SURROGATES[name][1])
    return torch.arange(n, dtype=torch.int32, device=device)


def surrogate_values_plain(name: str, device):
    """The surrogate of table ``name`` ("cbrt" or "inv_gamma") at every
    index of the table, with tensor ops on ``device``."""
    return _SURROGATES[name][0](_probe_index(name, device))


def surrogate_values(name: str, device):
    """``surrogate_values_plain``; on a CUDA device the probe kernel K9
    computes it, with the arithmetic of the kernels that consume it."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return surrogate_values_plain(name, dev)
    if dev.type != "cuda":
        raise ValueError(f"surrogate_values: unsupported device {dev}")
    return _launch("surrogate_probe", _probe_index(name, dev),
                   _SURROGATES[name][2], counter="surrogate_corrections")


def _corrections_of(name: str, got: torch.Tensor):
    delta = (np.asarray(_SURROGATES[name][1], np.int64)
             - got.cpu().numpy().astype(np.int64))
    nz = np.nonzero(delta)[0]
    if len(nz) > MAX_CORRECTIONS:
        return None
    return tuple(int(i) for i in nz), tuple(int(d) for d in delta[nz])


def surrogate_corrections_plain(name: str, device):
    return _corrections_of(name, surrogate_values_plain(name, device))


def surrogate_corrections(name: str, device):
    """The JAX ``_corrections(name)``: the sparse ``(indices, deltas)``
    that make the surrogate equal its table on ``device``, or None (read
    the table) where more than 32 entries differ.  Probed once per table
    and device, by that device's own arithmetic (kernel K9 on a card);
    cached."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (name, str(dev))
    if key not in _CORRECTIONS:
        _CORRECTIONS[key] = _corrections_of(name, surrogate_values(name, dev))
    return _CORRECTIONS[key]


# ---------------------------------------------------------------------------
# CLAHE apply (csrc/clahe_apply.cu)
# ---------------------------------------------------------------------------

def _check_clahe(src, luts, ya, xa, th, tw, pt, plf, tiles_x, tiles_y):
    dev = _check("clahe_apply", (src,), torch.int32)
    H, W = src.shape
    if th != -(-H // tiles_y) or tw != -(-W // tiles_x):
        raise ValueError("clahe_apply: tile size does not match the plane")
    if not (0 <= pt < th and 0 <= plf < tw):
        raise ValueError("clahe_apply: half-tile offsets out of range")
    for t, dtype, shape in ((luts, torch.int32, (tiles_y * tiles_x, 256)),
                            (ya, torch.float32, ((tiles_y + 1) * th,)),
                            (xa, torch.float32, ((tiles_x + 1) * tw,))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"clahe_apply: expected a contiguous {dtype} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return dev


def clahe_apply_plain(src, luts, ya, xa, th, tw, pt, plf, tiles_x, tiles_y):
    H, W = src.shape
    dev = src.device
    yb = torch.arange(H, device=dev) + pt
    xb = torch.arange(W, device=dev) + plf
    i, j = yb // th, xb // tw
    r1 = torch.clamp(i - 1, 0, tiles_y - 1)[:, None]
    r2 = torch.clamp(i, 0, tiles_y - 1)[:, None]
    c1 = torch.clamp(j - 1, 0, tiles_x - 1)[None, :]
    c2 = torch.clamp(j, 0, tiles_x - 1)[None, :]
    v = torch.clamp(src, 0, 255).long()
    flat = luts.reshape(-1)

    def lut(rr, cc):
        return flat[(rr * tiles_x + cc) * 256 + v].to(torch.float32)

    wy, wx = ya[yb][:, None], xa[xb][None, :]
    wy1, wx1 = 1.0 - wy, 1.0 - wx
    top = lut(r1, c1) * wx1 + lut(r1, c2) * wx
    bot = lut(r2, c1) * wx1 + lut(r2, c2) * wx
    val = top * wy1 + bot * wy
    return torch.clamp(torch.round(val), 0, 255).to(torch.int32)


def clahe_strip_rows(th: int, tiles_x: int, tiles_y: int,
                     resident: int) -> int:
    """The rows of a strip of csrc/clahe_apply.cu: as many strips of equal
    height a band block ((tiles_y+1)*(tiles_x+1) of them) as one wave of
    ``resident`` blocks holds, at most one a row."""
    bands = (tiles_x + 1) * (tiles_y + 1)
    strips = min(-(-resident // bands), th)
    return -(-th // strips)


def clahe_apply_plan(H, W, th, tw, pt, plf, tiles_x, tiles_y, strip_rows):
    """The rectangles (y0, y1, x0, x1) of the (H, W) plane that the blocks
    of csrc/clahe_apply.cu map, in grid order: block (band block i*(tiles_x
    +1)+j, strip s) takes rows s*strip_rows.. of band block (i, j), cropped
    to the plane; an empty one (None) maps nothing."""
    rects = []
    for i in range(tiles_y + 1):
        for j in range(tiles_x + 1):
            band_y1 = min((i + 1) * th - pt, H)
            x0, x1 = max(j * tw - plf, 0), min((j + 1) * tw - plf, W)
            for s in range(-(-th // strip_rows)):
                y0 = max(i * th - pt, 0) + s * strip_rows
                y1 = min(y0 + strip_rows, band_y1)
                rects.append((y0, y1, x0, x1) if y0 < y1 and x0 < x1
                             else None)
    return rects


def clahe_apply(src, luts, ya, xa, th, tw, pt, plf, tiles_x, tiles_y):
    """Map a u8-valued int32 plane (H, W) through its (tiles_y*tiles_x,
    256) int32 tile LUTs with OpenCV's f32 bilinear blend.  ya/xa are the
    f32 interpolation fractions in the half-tile-padded band frame, of
    lengths (tiles_y+1)*th and (tiles_x+1)*tw; pixel (y, x) sits at band
    coordinates (y+pt, x+plf)."""
    geom = (th, tw, pt, plf, tiles_x, tiles_y)
    dev = _check_clahe(src, luts, ya, xa, *geom)
    if dev.type == "cpu":
        return clahe_apply_plain(src, luts, ya, xa, *geom)
    return _launch("clahe_apply", src, luts, ya, xa, *geom)


def clahe_lab_apply_plain(L, a, b, luts, ya, xa, th, tw, pt, plf, tiles_x,
                          tiles_y):
    mapped = clahe_apply_plain(L, luts, ya, xa, th, tw, pt, plf, tiles_x,
                               tiles_y)
    return lab_inverse_u8_plain(mapped, a, b)


def clahe_lab_apply(L, a, b, luts, ya, xa, th, tw, pt, plf, tiles_x, tiles_y):
    """clahe_apply of the L plane followed by lab_inverse_u8 with the a and
    b planes, in one pass (kernel K5): int32 (L, a, b) planes (H, W) and
    clahe_apply's LUTs and fractions -> u8-valued int32 (r, g, b); the
    mapped L never reaches device memory."""
    geom = (th, tw, pt, plf, tiles_x, tiles_y)
    dev = _check("clahe_lab_apply", (L, a, b), torch.int32)
    _check_clahe(L, luts, ya, xa, *geom)
    if dev.type == "cpu":
        return clahe_lab_apply_plain(L, a, b, luts, ya, xa, *geom)
    return _launch("clahe_lab_apply", L, a, b, luts, ya, xa,
                   _table("inv_u8", dev), *geom)


# ---------------------------------------------------------------------------
# Inverse LAB (csrc/lab_inverse.cu)
# ---------------------------------------------------------------------------

def lab_inverse_u8_plain(L, a, b):
    """OpenCV Lab2RGBinteger on int32 planes -> u8-valued int32 (r, g, b)."""
    tab = _table("inv", L.device)
    h = 15
    l2y, l2ify, ig = tab[h:h + 256], tab[h + 256:h + 512], tab[h + 512:]
    Lc = torch.clamp(L, 0, 255).long()
    y, ify = l2y[Lc], l2ify[Lc]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - lt.ADIV_OFFSET
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - lt.BDIV_OFFSET

    def ab_to_xz(v):
        v = torch.clamp(v, lt.MIN_AB, lt.AB_MAX)
        lin = ctrunc_div(v * 108, 841) - lt.AB_LIN_K
        cub = ctrunc_div(ctrunc_div(v * v, lt.BASE) * v, lt.BASE)
        return torch.where(v <= lt.AB_LIN_THRESH, lin, cub)

    x, z = ab_to_xz(ify + adiv), ab_to_xz(ify - bdiv)
    C = lt.COEFFS_INV
    outs = []
    for ch in range(3):
        idx = _descale(x * int(C[ch, 0]) + y * int(C[ch, 1])
                       + z * int(C[ch, 2]), 14)
        outs.append(ig[torch.clamp(idx, 0, lt.INV_GAMMA_SIZE - 1).long()])
    return tuple(outs)


def lab_inverse_u8(L, a, b):
    """Bit-exact LAB2RGB on int32 (L, a, b) planes (H, W) -> u8-valued
    int32 (r, g, b) planes (kernel K3b)."""
    dev = _check("lab_inverse_u8", (L, a, b), torch.int32)
    if dev.type == "cpu":
        return lab_inverse_u8_plain(L, a, b)
    return _launch("lab_inverse_u8", L, a, b, _table("inv_u8", dev))


def lab_inverse_unit_plain(L, a, b):
    return tuple(div(v.to(torch.float32), 255.0)
                 for v in lab_inverse_u8_plain(L, a, b))


@functools.lru_cache(maxsize=None)
def unit_lut(device: torch.device) -> torch.Tensor:
    """(256,) f32 table k / 255 (IEEE, ``stretch.U8_GRID``) on ``device``
    (read-only): K3's epilogue gathers its unit output from it."""
    return torch.as_tensor(U8_GRID, device=device)


@functools.lru_cache(maxsize=None)
def gamma_lut(gamma: float, device: torch.device) -> torch.Tensor:
    """(256,) f32 table (k/255)**gamma, ``torch.pow`` on ``device`` (built
    once per gamma and device; read-only): the outputs of the inverse lie
    on the u8 grid, so their power is a lookup."""
    return torch.pow(torch.as_tensor(U8_GRID, device=device), float(gamma))


def lab_inverse_unit_gamma_plain(L, a, b, gamma: float):
    glut = gamma_lut(gamma, L.device)
    return tuple(glut[v.long()] for v in lab_inverse_u8_plain(L, a, b))


def lab_inverse_unit(L, a, b):
    """Bit-exact LAB2RGB on int32 (L, a, b) planes -> f32 unit planes
    (v / 255, IEEE)."""
    dev = _check("lab_inverse_unit", (L, a, b), torch.int32)
    if dev.type == "cpu":
        return lab_inverse_unit_plain(L, a, b)
    return _launch("lab_inverse_lut", L, a, b, _table("inv_u8", dev),
                   unit_lut(dev), counter="lab_inverse_unit")


def lab_inverse_unit_gamma(L, a, b, gamma: float):
    """lab_inverse_unit followed by ``out**gamma``, which the kernel gathers
    from ``gamma_lut(gamma)`` (built on the planes' device), so the six
    recipes' trailing gamma costs no extra pass over the frame."""
    dev = _check("lab_inverse_unit_gamma", (L, a, b), torch.int32)
    if dev.type == "cpu":
        return lab_inverse_unit_gamma_plain(L, a, b, gamma)
    return _launch("lab_inverse_lut", L, a, b, _table("inv_u8", dev),
                   gamma_lut(gamma, dev), counter="lab_inverse_unit_gamma")


# ---------------------------------------------------------------------------
# Canny hysteresis (csrc/hysteresis.cu)
# ---------------------------------------------------------------------------

def hysteresis_propagate_plain(strong, weak, iters: int):
    """``iters`` rounds of e | (weak & dilate8(e)) from e = strong, each a
    3x3 max-pool of the float 0/1 state (zero outside the plane)."""
    e = (strong != 0).to(torch.float32)[:, None]
    w = (weak != 0).to(torch.float32)[:, None]
    for _ in range(iters):
        e = torch.maximum(e, w * F.max_pool2d(e, 3, stride=1, padding=1))
    return e[:, 0].to(torch.int32)


SMEM_BYTES = 232448  # shared memory a block of an H100 can have (227 KB)
WHOLE_PLANE_CELLS = 270 * 480  # the largest plane run in one block


def hysteresis_tile(iters: int, H: int, W: int):
    """csrc/hysteresis.cu's plan for ``iters`` rounds on (H, W) planes:
    (tile_h, halo_rows, halo_words, group), the region being tile_h + 2 *
    halo_rows rows of ``group`` 32-cell words (3 words a cell of shared
    memory), the output tile group - 2 * halo_words words wide; None where
    no region fits.

    A plane of at most 512 columns and 270x480 cells is one region, with no
    halo.  Otherwise the halo is ``iters`` rows and ceil(iters / 32) words,
    the region 16 words wide (32 where the halo leaves fewer than 4 words
    of tile), and the tile ``iters`` rows high, within [32, 128], halved
    until the region fits: 64x384 cells in a 192x512 region at 64 rounds,
    32x448 in 40x512 at 4 (the regions' words are read from the packed
    planes, so the halo costs rounds, not bytes)."""
    if W <= 512 and H * W <= WHOLE_PLANE_CELLS and 12 * H * 16 <= SMEM_BYTES:
        return H, 0, 0, 16
    hw = -(-iters // 32)
    for group in (16, 32):
        if group - 2 * hw < (4 if group == 16 else 1):
            continue
        th = min(128, max(32, iters))
        while th >= 8:
            if 12 * (th + 2 * iters) * group <= SMEM_BYTES:
                return th, iters, hw, group
            th //= 2
    return None


def hysteresis_propagate(strong, weak, iters: int = 64):
    """strong | (weak reachable from strong in <= iters 8-connected steps)
    on (N, H, W) int32 {0, 1} planes, zero outside each plane -> int32."""
    dev = _check("hysteresis_propagate", (strong, weak), torch.int32, 3)
    if iters < 0:
        raise ValueError("hysteresis_propagate: iters must be >= 0")
    if dev.type == "cpu":
        return hysteresis_propagate_plain(strong, weak, iters)
    plan = hysteresis_tile(iters, *strong.shape[1:])
    if plan is None:
        raise ValueError(f"hysteresis_propagate: {iters} rounds need more "
                         "shared memory than a block has")
    return _launch("hysteresis_propagate", strong, weak, int(iters), *plan)


# ---------------------------------------------------------------------------
# Prefix sums in XLA:CPU's order (csrc/scan.cu)
# ---------------------------------------------------------------------------

SCAN_BLOCK = 16
SCAN_MAX_LENGTH = 1 << 16  # the longest axis csrc/scan.cu scans in one launch


def xla_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive f32 prefix sum along ``dim`` with XLA:CPU's association
    (the reference's jnp.cumsum): blocks of 16 summed in order, block
    totals scanned by the same rule and added as an exclusive prefix.
    Elementwise adds only, so the CPU and the card give the same bits."""
    dim = dim % x.dim()
    n = x.shape[dim]
    xm = x.movedim(dim, -1)
    if n <= SCAN_BLOCK:
        out = torch.empty_like(xm)
        acc = xm[..., 0]
        out[..., 0] = acc
        for k in range(1, n):
            acc = acc + xm[..., k]
            out[..., k] = acc
        return out.movedim(-1, dim)
    nb = -(-n // SCAN_BLOCK)
    pad = nb * SCAN_BLOCK - n
    xp = F.pad(xm, (0, pad)) if pad else xm
    blocks = xp.reshape(xp.shape[:-1] + (nb, SCAN_BLOCK))
    inner = xla_cumsum(blocks, -1)
    outer = xla_cumsum(inner[..., -1], -1)
    excl = F.pad(outer[..., :-1], (1, 0))
    res = (inner + excl[..., None]).reshape(xp.shape)[..., :n]
    return res.movedim(-1, dim)


def sat_rows_plain(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [1, 0]
    return F.pad(xla_cumsum(x, dim), pad)


def sat_rows(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Prefix sums along ``dim`` of a contiguous f32 tensor in XLA:CPU's
    association, with a leading zero inserted along ``dim``: (P, H, W) ->
    (P, H+1, W) row tables by default; a (P, 3, W) strip scanned along
    dim=-1 gives the descent's SAT corners."""
    dev = _check("sat_rows", (x,), torch.float32, None)
    if x.dim() == 0 or x.numel() >= 1 << 31:
        raise ValueError("sat_rows: expected 1 to 2**31 - 1 values")
    d = dim % x.dim()
    if dev.type == "cpu":
        return sat_rows_plain(x, d)
    if x.shape[d] > SCAN_MAX_LENGTH:
        raise ValueError(f"sat_rows: {x.shape[d]} values along dim {dim}; "
                         f"the kernel scans at most {SCAN_MAX_LENGTH}")
    return _launch("sat_rows", x, d, True)
