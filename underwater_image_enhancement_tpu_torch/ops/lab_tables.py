"""OpenCV's integer RGB2Lab_b / Lab2RGBinteger tables, built with numpy.

The port's own copy of the reference tables (the JAX package's
``ops/lab_tables.py`` builds the same arrays; tests hold them equal).  The
cube-root table is built in float32 to match OpenCV's softfloat table init.
"""

from __future__ import annotations

import numpy as np

LAB_SHIFT = 12
LAB_SHIFT2 = 15
GAMMA_SCALE = 2040  # 255 * 8
NCBRT = 3072        # 256 * 3/2 * 8

_M_RGB2XYZ = np.array(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]])
_WHITE_D65 = np.array([0.950456, 1.0, 1.088754])


def _build_gamma_tab() -> np.ndarray:
    x = np.arange(256) / 255.0
    lin = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    return np.round(lin * GAMMA_SCALE).astype(np.int32)


def _build_cbrt_tab() -> np.ndarray:
    f32 = np.float32
    t = (np.arange(NCBRT) / f32(GAMMA_SCALE)).astype(f32)
    f = np.where(t < f32(0.008856),
                 t * f32(7.787) + f32(16.0 / 116.0),
                 np.cbrt(t.astype(f32)).astype(f32))
    return np.round((f * f32(1 << LAB_SHIFT2)).astype(f32)).astype(np.int32)


GAMMA_TAB = _build_gamma_tab()          # (256,) 0..2040
CBRT_TAB = _build_cbrt_tab()            # (3072,) 0..32768
COEFFS = np.round(_M_RGB2XYZ / _WHITE_D65[:, None]
                  * (1 << LAB_SHIFT)).astype(np.int32)
L_SCALE = (116 * 255 + 50) // 100
L_SHIFT = -((16 * 255 * (1 << LAB_SHIFT2) + 50) // 100)

BASE_SHIFT = 14
BASE = 1 << BASE_SHIFT          # 16384
MIN_AB = -8145
AB_MAX = BASE * 9 // 4
INV_GAMMA_SIZE = 4096
AB_LIN_THRESH = 3390            # ~ 6/29 * BASE
AB_LIN_K = (BASE * 16 // 116) * 108 // 841
ADIV_OFFSET = 128 * BASE // 500
BDIV_OFFSET = 128 * BASE // 200 - 1


def _build_l2yf() -> np.ndarray:
    """LabToYF_b: L_u8 -> (y, ify) in BASE scale (threshold L_u8 <= 20)."""
    i = np.arange(256)
    fy = (i * 100.0 / 255.0 + 16.0) / 116.0
    y = np.where(i <= 20, np.round(i * BASE * 100.0 / (255.0 * 903.3)),
                 np.round(BASE * fy ** 3))
    ify = np.where(i <= 20,
                   np.round(BASE * (7.787 * i * 100.0 / (255.0 * 903.3)
                                    + 16.0 / 116.0)),
                   np.round(BASE * fy))
    return np.stack([y, ify], axis=1).astype(np.int32)  # (256, 2)


def _build_inv_gamma() -> np.ndarray:
    x = np.arange(INV_GAMMA_SIZE) / float(INV_GAMMA_SIZE)
    s = np.where(x <= 0.0031308, x * 12.92,
                 1.055 * np.maximum(x, 0.0) ** (1 / 2.4) - 0.055)
    return np.clip(np.round(255.0 * s), 0, 255).astype(np.int32)


L2YF_TAB = _build_l2yf()
INV_GAMMA_TAB = _build_inv_gamma()
COEFFS_INV = np.round(
    np.linalg.inv(_M_RGB2XYZ) * _WHITE_D65[None, :] * (1 << 12)
).astype(np.int32)  # rows: R,G,B over (x, y, z)

# Flat int32 table blocks handed to the CUDA kernels (and sliced by their
# plain versions), so every constant the kernels use comes from here.
FWD_HEADER = np.concatenate([[L_SCALE, L_SHIFT], COEFFS.reshape(-1)])
FWD_TABLE = np.concatenate([FWD_HEADER, GAMMA_TAB, CBRT_TAB]).astype(np.int32)
INV_HEADER = np.concatenate([
    COEFFS_INV.reshape(-1),
    [MIN_AB, AB_MAX, AB_LIN_THRESH, AB_LIN_K, ADIV_OFFSET, BDIV_OFFSET]])
INV_TABLE = np.concatenate([INV_HEADER, L2YF_TAB[:, 0], L2YF_TAB[:, 1],
                            INV_GAMMA_TAB]).astype(np.int32)
