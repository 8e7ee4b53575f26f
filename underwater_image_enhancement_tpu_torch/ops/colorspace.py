"""Colour-space conversions with OpenCV-compatible integer semantics.

Counterpart of the JAX package's ``ops/colorspace.py``, limited to what the
``six`` exact tier runs.  Integer images are int32 tensors holding u8
values.  The LAB legs go through the hand-written kernels of
``ops/kernels.py`` (plain versions on CPU tensors), which also hold
``quantize_u8`` and ``ctrunc_div`` (the JAX ``_ctrunc_div``).

``u8_to_unit`` is IEEE ``/ 255``, the values of ``stretch.U8_GRID`` and of
a decoded frame.  Jitted JAX compiles the same division to a multiply by
the reciprocal (1 ulp off on 126 of the 256 values); eager JAX divides.
"""

from __future__ import annotations

import torch

from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops.kernels import quantize_u8  # noqa: F401
from underwater_image_enhancement_tpu_torch.ops.layout import div

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


def rgb_unit_to_lab_planes(r, g, b):
    """quantize_u8 + bit-exact RGB2LAB on f32 unit planes -> int32 L/a/b
    (kernel K1, ``kernels.lab_forward_unit``)."""
    return kernels.lab_forward_unit(r, g, b)


def lab_to_rgb_unit_planes(L, a, b):
    """Bit-exact LAB2RGB + u8_to_unit (kernel K3)."""
    return kernels.lab_inverse_unit(L, a, b)


def lab_to_rgb_unit_gamma_planes(L, a, b, gamma: float):
    """lab_to_rgb_unit_planes followed by ``out**gamma`` (six_stadigy's
    post-CLAHE gamma): the outputs lie on the u8 grid, so the power is a
    256-entry LUT gathered in the inverse kernel's epilogue (kernel K3g)."""
    return kernels.lab_inverse_unit_gamma(L, a, b, gamma)
