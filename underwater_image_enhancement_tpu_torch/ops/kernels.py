"""The hand-written CUDA kernels of the ``six`` exact tier, their wrappers,
and their plain PyTorch versions.

Each wrapper checks its inputs, then dispatches on the input tensors'
device: a CPU tensor goes to the plain version, a CUDA tensor launches the
kernel through the extension built from ``csrc/`` (``utils/cuda_build.py``;
a failed build or launch raises, nothing falls back).  ``launches[name]``
counts kernel launches, and only those.

| wrapper                  | CUDA source          | replaces (pallas_kernels.py)    |
|--------------------------|----------------------|---------------------------------|
| lab_forward_unit         | csrc/lab_forward.cu  | lab_forward_planes_unit         |
| clahe_apply              | csrc/clahe_apply.cu  | clahe_apply                     |
| lab_inverse_unit         | csrc/lab_inverse.cu  | lab_inverse_planes_unit         |
| lab_inverse_unit_gamma   | csrc/lab_inverse.cu  | lab_inverse_planes_unit_gamma   |

The plain versions repeat the kernels' integer and f32 arithmetic with
tensor ops (table indexing, ``torch.div(..., rounding_mode="trunc")`` for
C division, separate multiplies and adds), so they run on either device
and agree with the kernels bit for bit.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from underwater_image_enhancement_tpu_torch.ops import lab_tables as lt
from underwater_image_enhancement_tpu_torch.ops.layout import div
from underwater_image_enhancement_tpu_torch.ops.stretch import U8_GRID
from underwater_image_enhancement_tpu_torch.utils import cuda_build

launches: Dict[str, int] = {
    "lab_forward_unit": 0,
    "clahe_apply": 0,
    "lab_inverse_unit": 0,
    "lab_inverse_unit_gamma": 0,
}

_TABLES: Dict[Tuple[str, str], torch.Tensor] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _table(name: str, device: torch.device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _TABLES:
        src = {"fwd": lt.FWD_TABLE, "inv": lt.INV_TABLE}[name]
        _TABLES[key] = torch.as_tensor(src, dtype=torch.int32).to(device)
    return _TABLES[key]


def _check(name: str, tensors, dtype) -> torch.device:
    """Same device (the CPU or a CUDA card), dtype and 2-D shape;
    contiguous."""
    dev = tensors[0].device
    shape = tuple(tensors[0].shape)
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape or len(shape) != 2 or 0 in shape:
            raise ValueError(f"{name}: expected equal non-empty 2-D planes, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: planes must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _launch(name: str, *args):
    """Run the extension's entry point ``name`` (csrc/bindings.cpp) on CUDA
    tensors and count the launch; a build or launch error raises."""
    out = getattr(cuda_build.extension(), name)(*args)
    launches[name] += 1
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


def lab_forward_u8_plain(r8, g8, b8):
    """OpenCV RGB2Lab_b on u8-valued int32 planes (inputs clipped to
    [0, 255]) -> int32 (L, a, b)."""
    tab = _table("fwd", r8.device)
    h = 2 + 9
    gamma, cbrt = tab[h:h + 256], tab[h + 256:]
    R, G, B = (gamma[torch.clamp(p, 0, 255).long()] for p in (r8, g8, b8))
    C = lt.COEFFS

    def cbrt_of(row):
        acc = R * int(C[row, 0]) + G * int(C[row, 1]) + B * int(C[row, 2])
        idx = torch.clamp(_descale(acc, lt.LAB_SHIFT), 0, lt.NCBRT - 1)
        return cbrt[idx.long()]

    fX, fY, fZ = cbrt_of(0), cbrt_of(1), cbrt_of(2)
    clip = lambda v: torch.clamp(v, 0, 255)  # noqa: E731
    L = clip(_descale(lt.L_SCALE * fY + lt.L_SHIFT, lt.LAB_SHIFT2))
    a = clip(_descale(500 * (fX - fY) + (128 << lt.LAB_SHIFT2), lt.LAB_SHIFT2))
    b = clip(_descale(200 * (fY - fZ) + (128 << lt.LAB_SHIFT2), lt.LAB_SHIFT2))
    return L, a, b


def lab_forward_unit_plain(r, g, b):
    return lab_forward_u8_plain(quantize_u8(r), quantize_u8(g), quantize_u8(b))


def lab_forward_unit(r, g, b):
    """quantize_u8 + bit-exact RGB2LAB on f32 unit planes (H, W) -> int32
    (L, a, b) planes."""
    dev = _check("lab_forward_unit", (r, g, b), torch.float32)
    if dev.type == "cpu":
        return lab_forward_unit_plain(r, g, b)
    return _launch("lab_forward_unit", r, g, b, _table("fwd", dev))


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


def lab_inverse_unit_plain(L, a, b):
    return tuple(div(v.to(torch.float32), 255.0)
                 for v in lab_inverse_u8_plain(L, a, b))


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
    return _launch("lab_inverse_unit", L, a, b, _table("inv", dev))


def lab_inverse_unit_gamma(L, a, b, gamma: float):
    """lab_inverse_unit followed by ``out**gamma``, which the kernel gathers
    from ``gamma_lut(gamma)`` (built on the planes' device), so the six
    recipes' trailing gamma costs no extra pass over the frame."""
    dev = _check("lab_inverse_unit_gamma", (L, a, b), torch.int32)
    if dev.type == "cpu":
        return lab_inverse_unit_gamma_plain(L, a, b, gamma)
    return _launch("lab_inverse_unit_gamma", L, a, b, _table("inv", dev),
                   gamma_lut(gamma, dev))
