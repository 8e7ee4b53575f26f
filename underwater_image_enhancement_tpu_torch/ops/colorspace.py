"""Colour-space conversions with OpenCV-compatible integer semantics.

Counterpart of the JAX package's ``ops/colorspace.py``: its public
functions, and the ``*_planes`` forms the ported paths run.  Integer
images are int32 tensors holding u8 values, as channel planes.  The exact LAB conversions go through the hand-written
kernels of ``ops/kernels.py`` (plain versions on CPU tensors), which also
hold ``quantize_u8`` and ``ctrunc_div`` (the JAX ``_ctrunc_div``).  HSV is
cv2's fixed-point 8U path with its division tables (``lab_tables``); the
fast tier's arithmetic LAB is f32 elementwise math, within a few u8 levels
of the exact one.

``u8_to_unit`` is IEEE ``/ 255``, the values of ``stretch.U8_GRID`` and of
a decoded frame.  Jitted JAX compiles the same division to a multiply by
the reciprocal (1 ulp off on 126 of the 256 values); eager JAX divides.

The float conversions (``rgb_to_gray_f32``, ``rgb_to_hsv_f32``,
``rgb_to_lab_u8``, ``lab_to_rgb_u8``) are the exact formulas in f32 (no
kernel); torch's ``pow`` rounds its last bit otherwise than XLA's
``cbrt`` and ``pow``, so the float LAB lands one u8 level off JAX's on
rare pixels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops import lab_tables as lt
from underwater_image_enhancement_tpu_torch.ops.kernels import quantize_u8  # noqa: F401
from underwater_image_enhancement_tpu_torch.ops.layout import div

# x / 255.0 as jitted XLA computes it (a multiply by the f32 reciprocal):
# the same bits on every device, for the metrics' and features' HSV S
INV_255 = float(np.float32(1.0) / np.float32(255.0))

# cv2 5.x RGB2GRAY fixed-point weights (shift 15)
_GRAY_SHIFT = 15
_R2Y = 9798
_G2Y = 19235
_B2Y = 32768 - _R2Y - _G2Y  # 3735


def u8_to_unit(img_u8: torch.Tensor) -> torch.Tensor:
    """u8-valued int tensor -> float32 in [0, 1] (IEEE ``/ 255``)."""
    return div(img_u8.to(torch.float32), 255.0)


def gray_u8_planes(r, g, b) -> torch.Tensor:
    """Bit-exact cv2 RGB2GRAY from u8-valued int32 planes."""
    acc = r * _R2Y + g * _G2Y + b * _B2Y + (1 << (_GRAY_SHIFT - 1))
    return acc >> _GRAY_SHIFT


def rgb_to_gray_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """cv2 RGB2GRAY of a (..., 3) u8-valued int tensor -> (...)."""
    return gray_u8_planes(rgb_u8[..., 0], rgb_u8[..., 1], rgb_u8[..., 2])


@functools.lru_cache(maxsize=None)
def _hsv_table(name: str, device: torch.device) -> torch.Tensor:
    """lab_tables' SDIV_TAB or HDIV_TAB on ``device``, copied once (a copy
    from host memory would wait for the device at every call)."""
    return torch.as_tensor(getattr(lt, name), device=device)


def _gather(name: str, idx: torch.Tensor) -> torch.Tensor:
    return _hsv_table(name, idx.device)[idx.long()]


def _hsv_v_s(r8, g8, b8):
    """HSV's V, the max - min spread and S = (diff * sdiv[v] + 2^11) >> 12."""
    v = torch.maximum(torch.maximum(r8, g8), b8)
    diff = v - torch.minimum(torch.minimum(r8, g8), b8)
    return v, diff, (diff * _gather("SDIV_TAB", v) + (1 << 11)) >> 12


def hsv_s_u8_planes(r8, g8, b8) -> torch.Tensor:
    """cv2 8U RGB2HSV's S from u8-valued int32 planes, bit-exact."""
    return _hsv_v_s(r8, g8, b8)[2]


def rgb_to_hsv_u8_planes(r8, g8, b8):
    """cv2 8U RGB2HSV on u8-valued int32 planes, bit-exact -> (h, s, v)
    planes: H in [0, 180), S and V in [0, 255].  h = (term * hdiv[diff] +
    2^11) >> 12 (+180 if negative), term chosen by the first channel equal
    to the max in the order r, g, b."""
    v, diff, s = _hsv_v_s(r8, g8, b8)
    term = torch.where(v == r8, g8 - b8,
                       torch.where(v == g8, b8 - r8 + 2 * diff,
                                   r8 - g8 + 4 * diff))
    h = (term * _gather("HDIV_TAB", diff) + (1 << 11)) >> 12
    h = torch.where(h < 0, h + 180, h)
    h = torch.where(diff == 0, 0, h)
    return h, s, v


def _channels(rgb_u8: torch.Tensor):
    """The three channel planes of a (..., 3) u8-valued tensor, int32."""
    return tuple(rgb_u8[..., c].to(torch.int32) for c in range(3))


def rgb_to_hsv_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2HSV of a (..., 3) u8-valued int tensor, bit-exact ->
    int32 (..., 3): H in [0, 180), S and V in [0, 255] (the JAX
    ``rgb_to_hsv_u8``)."""
    return torch.stack(rgb_to_hsv_u8_planes(*_channels(rgb_u8)), dim=-1)


def _rows(kernel, planes):
    """A pointwise plane kernel on same-shape planes of any rank >= 2: the
    leading dimensions fold into rows (the JAX package's row fold); planes
    (H, W) go to the kernel unchanged."""
    shp = planes[0].shape
    if len(shp) == 2:
        return kernel(*(p.contiguous() for p in planes))
    outs = kernel(*(p.reshape(-1, shp[-1]).contiguous() for p in planes))
    return tuple(o.reshape(shp) for o in outs)


def _impl(name: str, impl: str) -> None:
    """The JAX ``impl`` choice: "auto", "pallas" and "xla" give the same
    bits there; here all three run the kernel on a CUDA tensor (its plain
    version on a CPU one)."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"{name}: impl must be 'auto', 'pallas' or 'xla', "
                         f"got {impl!r}")


def rgb_to_lab_u8_exact_planes(r, g, b_, impl: str = "auto"):
    """Bit-exact RGB2LAB on u8-valued int32 planes (..., H, W) -> int32
    L/a/b (kernel K1b, ``kernels.lab_forward_u8``)."""
    _impl("rgb_to_lab_u8_exact_planes", impl)
    return _rows(kernels.lab_forward_u8, (r, g, b_))


def rgb_to_lab_u8_exact(rgb_u8: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2LAB of a (..., 3) u8-valued int tensor, bit-exact
    (kernel K1b) -> int32 (..., 3)."""
    return torch.stack(rgb_to_lab_u8_exact_planes(*_channels(rgb_u8)), dim=-1)


def lab_to_rgb_u8_exact_planes(L, a, b, impl: str = "auto"):
    """Bit-exact LAB2RGB on int32 planes (..., H, W) -> u8-valued int32
    (r, g, b) (kernel K3b, ``kernels.lab_inverse_u8``)."""
    _impl("lab_to_rgb_u8_exact_planes", impl)
    return _rows(kernels.lab_inverse_u8, (L, a, b))


def lab_to_rgb_u8_exact(lab_u8: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_LAB2RGB of a (..., 3) u8-valued int tensor, bit-exact
    (kernel K3b) -> int32 (..., 3)."""
    return torch.stack(lab_to_rgb_u8_exact_planes(*_channels(lab_u8)), dim=-1)


def rgb_to_lab_l_u8_exact_planes(r8, g8, b8) -> torch.Tensor:
    """The L plane alone of ``rgb_to_lab_u8_exact_planes`` (kernel K4,
    ``kernels.lab_forward_l_u8``): the brightness metric reads only L."""
    return kernels.lab_forward_l_u8(*(p.contiguous() for p in (r8, g8, b8)))


def rgb_to_lab_l_u8_exact(rgb_u8: torch.Tensor,
                          impl: str = "auto") -> torch.Tensor:
    """The L plane of cv2.COLOR_RGB2LAB of a (..., 3) u8-valued int tensor,
    bit-exact -> int32 (...) (the JAX ``rgb_to_lab_l_u8_exact``), through
    kernel K4 with the leading dimensions folded into rows.  ``impl`` is
    JAX's: "auto", "pallas" and "xla" all give the same bits there, and
    here all three run K4 on a CUDA tensor (its plain version on a CPU
    one), which is bit-equal to its plain version."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"rgb_to_lab_l_u8_exact: impl must be 'auto', "
                         f"'pallas' or 'xla', got {impl!r}")
    planes = _channels(rgb_u8)
    shp = planes[0].shape
    if len(shp) < 2:
        return rgb_to_lab_l_u8_exact(rgb_u8[None], impl)[0]
    rows = (p.reshape(-1, shp[-1]).contiguous() for p in planes)
    return kernels.lab_forward_l_u8(*rows).reshape(shp)


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    d = 6.0 / 29.0
    return torch.where(t > d ** 3, torch.pow(torch.clamp(t, min=0.0), 1.0 / 3.0),
                       t / (3.0 * d * d) + 4.0 / 29.0)


def _linear_planes(r8, g8, b8):
    return tuple(_srgb_to_linear(u8_to_unit(p)) for p in (r8, g8, b8))


def _xyz_row(lin, k: int) -> torch.Tensor:
    """Row k of RGB2XYZ applied to the linear planes, over the white."""
    m = lt.RGB2XYZ_F32
    acc = lin[0] * float(m[k, 0]) + lin[1] * float(m[k, 1]) + lin[2] * float(m[k, 2])
    return acc / float(lt.WHITE_F32[k])


def rgb_to_lab_u8_arith_planes(r8, g8, b8):
    """The fast tier's arithmetic RGB2LAB on u8-valued int planes -> f32
    (L, a, b) planes, rounded and clipped to [0, 255] but not cast: sRGB
    linearisation, the XYZ matrix, labF with a cube root.  Within a few u8
    levels of the exact integer pipeline (the JAX ``rgb_to_lab_u8_arith``;
    its ``cbrt`` and ``** 2.4`` round their last ulp otherwise than torch's
    ``pow``)."""
    lin = _linear_planes(r8, g8, b8)
    fx, fy, fz = (_lab_f(_xyz_row(lin, k)) for k in range(3))
    L = (116.0 * fy - 16.0) * 255.0 / 100.0
    a = 500.0 * (fx - fy) + 128.0
    b = 200.0 * (fy - fz) + 128.0
    return tuple(torch.clamp(torch.round(v), 0.0, 255.0) for v in (L, a, b))


def rgb_to_lab_u8_arith(rgb_u8: torch.Tensor) -> torch.Tensor:
    """``rgb_to_lab_u8_arith_planes`` of a (..., 3) u8-valued int tensor ->
    f32 (..., 3) (the JAX ``rgb_to_lab_u8_arith``)."""
    return torch.stack(rgb_to_lab_u8_arith_planes(*_channels(rgb_u8)), dim=-1)


def rgb_u8_to_lab_l_arith_planes(r8, g8, b8) -> torch.Tensor:
    """The arithmetic L plane (u8 scale, f32, not rounded) of u8-valued
    int planes: the fast tier's brightness input (the JAX
    ``rgb_u8_to_lab_l_arith_planes``)."""
    y = _xyz_row(_linear_planes(r8, g8, b8), 1)
    return (116.0 * _lab_f(y) - 16.0) * 255.0 / 100.0


def rgb_unit_to_lab_planes(r, g, b_, impl: str = "auto"):
    """quantize_u8 + bit-exact RGB2LAB on f32 unit planes (..., H, W) ->
    int32 L/a/b (kernel K1, ``kernels.lab_forward_unit``; leading
    dimensions fold into rows)."""
    _impl("rgb_unit_to_lab_planes", impl)
    return _rows(kernels.lab_forward_unit, (r, g, b_))


def rgb_unit_to_lab_planes_fast(r, g, b):
    """rgb_unit_to_lab_planes with the cube-root table evaluated as the
    probe-corrected 4-step surrogate (kernel K8 ``_fast``,
    ``kernels.lab_forward_unit_fast``; the JAX
    ``lab_forward_planes_unit_fast``): the same planes, by construction."""
    return kernels.lab_forward_unit_fast(r, g, b)


def lab_to_rgb_unit_planes(L, a, b, impl: str = "auto"):
    """Bit-exact LAB2RGB + u8_to_unit on int32 planes (..., H, W) (kernel
    K3)."""
    _impl("lab_to_rgb_unit_planes", impl)
    return _rows(kernels.lab_inverse_unit, (L, a, b))


def lab_to_rgb_unit_gamma_planes(L, a, b, gamma: float, impl: str = "auto"):
    """lab_to_rgb_unit_planes followed by ``out**gamma`` (six_stadigy's
    post-CLAHE gamma): the outputs lie on the u8 grid, so the power is a
    256-entry LUT gathered in the inverse kernel's epilogue (kernel K3g)."""
    _impl("lab_to_rgb_unit_gamma_planes", impl)
    return _rows(lambda *p: kernels.lab_inverse_unit_gamma(*p, gamma),
                 (L, a, b))


# ---------------------------------------------------------------------------
# float-math conversions (the JAX package's non-kernel helpers)
# ---------------------------------------------------------------------------

def rgb_to_gray_f32(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2GRAY's float path: 0.299 R + 0.587 G + 0.114 B."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def unit_to_gray_unit(img: torch.Tensor) -> torch.Tensor:
    """The reference's ``cvtColor((img*255).u8, RGB2GRAY) / 255``: f32 gray
    on the u8 grid."""
    return u8_to_unit(rgb_to_gray_u8(quantize_u8(img)))


def rgb_to_hsv_f32(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2HSV on float input: H in [0, 360), S and V in [0, 1]
    (IEEE divisions, as the JAX function's traced ones)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    safe_diff = torch.where(diff == 0, 1.0, diff)
    safe_v = torch.where(v == 0, 1.0, v)
    s = torch.where(v == 0, 0.0, div(diff, safe_v))
    term = torch.where(v == r, g - b,
                       torch.where(v == g, b - r + 2.0 * diff,
                                   r - g + 4.0 * diff))
    h = torch.where(diff == 0, 0.0, div(60.0 * term, safe_diff))
    h = torch.where(h < 0, h + 360.0, h)
    return torch.stack([h, s, v], dim=-1)


def rgb_to_lab_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2LAB of a (..., 3) u8-valued tensor by the exact float
    formulas (sRGB companding, D65) -> int32 (..., 3): L*255/100, a and b
    offset by 128; within ~2 u8 levels of cv2's tables.  The JAX function
    is ``rgb_to_lab_u8_arith`` cast to int32, and so is this one."""
    return rgb_to_lab_u8_arith(rgb_u8).to(torch.int32)


def _lab_f_inv(ft: torch.Tensor) -> torch.Tensor:
    d = 6.0 / 29.0
    return torch.where(ft > d, ft ** 3, 3.0 * d * d * (ft - 4.0 / 29.0))


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


# the f32 inverse of the f64 RGB2XYZ matrix (the JAX package's _XYZ2RGB)
_XYZ2RGB_F32 = np.linalg.inv(lt._M_RGB2XYZ).astype(np.float32)


def lab_to_rgb_u8(lab_u8: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_LAB2RGB of a (..., 3) int tensor by the exact float
    formulas (the inverse of ``rgb_to_lab_u8``) -> int32 (..., 3)."""
    lab = lab_u8.to(torch.float32)
    L = div(lab[..., 0] * 100.0, 255.0)
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    fy = div(L + 16.0, 116.0)
    fx = fy + div(a, 500.0)
    fz = fy - div(b, 200.0)
    xyz = [_lab_f_inv(f) * float(w) for f, w in zip((fx, fy, fz), lt.WHITE_F32)]
    m = _XYZ2RGB_F32
    lin = [xyz[0] * float(m[k, 0]) + xyz[1] * float(m[k, 1])
           + xyz[2] * float(m[k, 2]) for k in range(3)]
    srgb = torch.stack([_linear_to_srgb(c) for c in lin], dim=-1)
    return torch.clamp(torch.round(srgb * 255.0), 0, 255).to(torch.int32)


def rgb_u8_to_lab_l_arith(rgb_u8: torch.Tensor) -> torch.Tensor:
    """``rgb_u8_to_lab_l_arith_planes`` of a (..., 3) u8-valued tensor ->
    f32 (...): the arithmetic L plane (u8 scale, not rounded)."""
    return rgb_u8_to_lab_l_arith_planes(*_channels(rgb_u8))
