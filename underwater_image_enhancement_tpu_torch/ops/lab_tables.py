"""OpenCV's integer RGB2Lab_b / Lab2RGBinteger tables, its 8U HSV
division tables, and the f32 constants of the arithmetic LAB, built with
numpy.

The port's own copy of the reference tables (the JAX package's
``ops/lab_tables.py`` and ``ops/colorspace.py`` build the same arrays;
tests hold them equal).  The cube-root table is built in float32 to match
OpenCV's softfloat table init.
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
# FWD_TABLE as csrc/lab_forward.cu stages it: the header padded to 12 ints,
# GAMMA_TAB, then CBRT_TAB (values 4520..37555) as u16 pairs in int32 words,
# entry 2k in the low half: sections on 16-byte boundaries, 7216 bytes
FWD_TABLE_U16 = np.concatenate([
    FWD_HEADER, [0], GAMMA_TAB,
    CBRT_TAB.astype(np.uint16).view(np.int32)]).astype(np.int32)
INV_HEADER = np.concatenate([
    COEFFS_INV.reshape(-1),
    [MIN_AB, AB_MAX, AB_LIN_THRESH, AB_LIN_K, ADIV_OFFSET, BDIV_OFFSET]])
INV_TABLE = np.concatenate([INV_HEADER, L2YF_TAB[:, 0], L2YF_TAB[:, 1],
                            INV_GAMMA_TAB]).astype(np.int32)
# INV_TABLE as the inverse-LAB kernels (csrc/lab_inverse.cu, and K5 in
# csrc/clahe_lab_apply.cu) stage it: the header padded to 16 ints,
# L2Y, L2IFY, then INV_GAMMA_TAB (values 0..255) as bytes, four an int32
# word, entry 4k in the low byte: the layout of its shared-memory tables,
# copied in 16-byte chunks, 6208 bytes
INV_TABLE_U8 = np.concatenate([
    INV_HEADER, [0], L2YF_TAB[:, 0], L2YF_TAB[:, 1],
    INV_GAMMA_TAB.astype(np.uint8).view(np.int32)]).astype(np.int32)

# cv2 8U RGB2HSV fixed-point division tables (hsv_shift 12), np.round (half
# to even): sdiv[i] = round((255 << 12) / i), hdiv[i] = round((180 << 12) /
# (6 i)), 0 at i = 0.
SDIV_TAB = np.zeros(256, np.int32)
SDIV_TAB[1:] = np.round((255 << 12) / np.arange(1, 256)).astype(np.int32)
HDIV_TAB = np.zeros(256, np.int32)
HDIV_TAB[1:] = np.round((180 << 12) / (6.0 * np.arange(1, 256))).astype(np.int32)

# the arithmetic (fast-tier) LAB's sRGB -> XYZ matrix and D65 white, f32
RGB2XYZ_F32 = _M_RGB2XYZ.astype(np.float32)
WHITE_F32 = _WHITE_D65.astype(np.float32)


# ---------------------------------------------------------------------------
# numpy oracles of the two integer pipelines (bit-exact against cv2 8U)
# ---------------------------------------------------------------------------

def _descale(v, n):
    return (v + (1 << (n - 1))) >> n


def rgb_to_lab_u8_exact_np(rgb_u8: np.ndarray) -> np.ndarray:
    """Numpy reference of the integer forward (cv2 RGB2LAB 8U): (..., 3)
    u8 values -> int32 (..., 3)."""
    rgb = rgb_u8.astype(np.int64)
    R, G, B = (GAMMA_TAB[rgb[..., c]].astype(np.int64) for c in range(3))
    C = COEFFS.astype(np.int64)
    fX, fY, fZ = (CBRT_TAB[np.clip(_descale(
        R * C[k, 0] + G * C[k, 1] + B * C[k, 2], LAB_SHIFT), 0, NCBRT - 1)]
        .astype(np.int64) for k in range(3))
    L = _descale(L_SCALE * fY + L_SHIFT, LAB_SHIFT2)
    a = _descale(500 * (fX - fY) + 128 * (1 << LAB_SHIFT2), LAB_SHIFT2)
    b = _descale(200 * (fY - fZ) + 128 * (1 << LAB_SHIFT2), LAB_SHIFT2)
    return np.clip(np.stack([L, a, b], -1), 0, 255).astype(np.int32)


def _ctrunc_div(a, b):
    """C integer division (truncation toward zero) of array a by int b > 0."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


def ab_to_xz_np(v: np.ndarray) -> np.ndarray:
    """abToXZ_b as arithmetic (no table): v in BASE scale (may be
    negative)."""
    v = np.clip(v, MIN_AB, AB_MAX)
    lin = _ctrunc_div(v * 108, 841) - AB_LIN_K
    cub = _ctrunc_div(_ctrunc_div(v * v, BASE) * v, BASE)
    return np.where(v <= AB_LIN_THRESH, lin, cub)


def adiv_np(a):
    return ((5 * a * 53687 + (1 << 7)) >> 13) - ADIV_OFFSET


def bdiv_np(b):
    return ((b * 41943 + (1 << 4)) >> 9) - BDIV_OFFSET


def lab_to_rgb_u8_exact_np(lab_u8: np.ndarray) -> np.ndarray:
    """Numpy reference of the integer inverse (cv2 LAB2RGB 8U): (..., 3)
    int values -> u8-valued int32 (..., 3)."""
    lab = lab_u8.astype(np.int64)
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    y = L2YF_TAB[L, 0].astype(np.int64)
    ify = L2YF_TAB[L, 1].astype(np.int64)
    x = ab_to_xz_np(ify + adiv_np(a))
    z = ab_to_xz_np(ify - bdiv_np(b))
    C = COEFFS_INV.astype(np.int64)
    out = []
    for ch in range(3):
        idx = _descale(C[ch, 0] * x + C[ch, 1] * y + C[ch, 2] * z, 14)
        out.append(INV_GAMMA_TAB[np.clip(idx, 0, INV_GAMMA_SIZE - 1)])
    return np.stack(out, -1).astype(np.int32)
