"""libtiff's colour conversions for its RGBA reader, in numpy: YCbCr and
CIE L*a*b* to 8-bit RGB with the bytes libtiff 4.7 gives (``tif_color.c``
and ``tif_getimage.c``), so that ``tiff.decode_tiff`` reads these files as
``cv2.imread`` does.

YCbCr goes through ``TIFFYCbCrToRGBInit``'s tables: the luma
coefficients (YCbCrCoefficients, 0.299, 0.587, 0.114 by default) as
16.16 fixed-point factors, each code's value on the ReferenceBlackWhite
range (0, 255, 128, 255, 128, 255 by default) in float, truncated; then
``TIFFYCbCrtoRGB`` adds them in integers and clamps to 0-255.

CIE L*a*b* goes through ``TIFFCIELabToRGBInit`` with ``display_sRGB``
(a gamma of 2.4 over a table of 1501 entries) and the WhitePoint tag (D50
by default), then ``TIFFCIELab16ToXYZ`` (8-bit samples scaled to 16
bits: L by 257, a* and b* by 256) and ``TIFFXYZToRGB``, each step in
float32 as libtiff computes it.
"""

from __future__ import annotations

import numpy as np

_F = np.float32
_SHIFT = 16
_ONE_HALF = 1 << (_SHIFT - 1)
# tif_aux.c's defaults
_LUMA = (0.299, 0.587, 0.114)
_REF_BLACK_WHITE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
# tif_dir.h's CIE D50, TIFFVGetFieldDefaulted's WhitePoint
_D50 = (_F(96.4250), _F(100.0), _F(82.4680))
_D50_WHITE = (_D50[0] / (_D50[0] + _D50[1] + _D50[2]),
              _D50[1] / (_D50[0] + _D50[1] + _D50[2]))
# tif_getimage.c's display_sRGB
_SRGB_MATRIX = np.array([[3.2410, -1.5374, -0.4986],
                         [-0.9692, 1.8760, 0.0416],
                         [0.0556, -0.2040, 1.0570]], np.float32)
_SRGB_Y_WHITE, _SRGB_Y_BLACK, _SRGB_V_WHITE, _SRGB_GAMMA = (
    _F(100.0), _F(1.0), 255, _F(2.4))
_RANGE = 1500  # CIELABTORGB_TABLE_RANGE


def _fix(x) -> int:
    """``FIX``: a float32 factor as 16.16 fixed point, rounded."""
    return int(float(x) * (1 << _SHIFT) + 0.5)


def _code_to_value(c: np.ndarray, black, white, top) -> np.ndarray:
    """``Code2V`` clamped as ``CLAMPw`` and truncated: ``(c - (int)black)
    * top / (white - black)`` in float32, within +-4096."""
    black, white = _F(black), _F(white)
    span = white - black
    v = (c - int(black)).astype(np.float32) * _F(top) / (
        span if span != 0 else _F(1))
    return np.trunc(np.clip(v, _F(-4096), _F(4096))).astype(np.int64)


def ycbcr_tables(luma=None, ref_black_white=None):
    """``TIFFYCbCrToRGBInit``'s (Y, Cr->R, Cb->B, Cr->G, Cb->G) tables,
    each 256 int64, from the YCbCrCoefficients and ReferenceBlackWhite
    values (float32, or None for libtiff's defaults)."""
    red, green, blue = (_F(v) for v in (luma or _LUMA))
    rbw = [_F(v) for v in (ref_black_white or _REF_BLACK_WHITE)]
    two = _F(2)
    f1 = two - two * red
    f2 = red * f1 / green
    f3 = two - two * blue
    f4 = blue * f3 / green
    d1, d2, d3, d4 = (_fix(np.clip(f, _F(0), two)) for f in (f1, f2, f3, f4))
    d2, d4 = -d2, -d4
    x = np.arange(-128, 128, dtype=np.int64)
    cr = _code_to_value(x, rbw[4] - _F(128), rbw[5] - _F(128), 127)
    cb = _code_to_value(x, rbw[2] - _F(128), rbw[3] - _F(128), 127)
    y = _code_to_value(x + 128, rbw[0], rbw[1], 255)
    return (y, (d1 * cr + _ONE_HALF) >> _SHIFT, (d3 * cb + _ONE_HALF) >> _SHIFT,
            d2 * cr, d4 * cb + _ONE_HALF)


def ycbcr_to_rgb(ycc: np.ndarray, luma=None,
                 ref_black_white=None) -> np.ndarray:
    """(..., 3) uint8 Y, Cb, Cr -> (..., 3) uint8 RGB as
    ``TIFFYCbCrtoRGB`` gives it with ``ycbcr_tables``."""
    y_tab, cr_r, cb_b, cr_g, cb_g = ycbcr_tables(luma, ref_black_white)
    y, cb, cr = (ycc[..., k] for k in range(3))
    base = y_tab[y]
    rgb = np.stack([base + cr_r[cr], base + ((cb_g[cb] + cr_g[cr]) >> _SHIFT),
                    base + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _srgb_table() -> np.ndarray:
    """``Yr2r``: ``255 * (float)pow(i / 1500, 1 / 2.4)`` in float32."""
    gamma = 1.0 / float(_SRGB_GAMMA)
    return _F(_SRGB_V_WHITE) * np.power(
        np.arange(_RANGE + 1) / _RANGE, gamma).astype(np.float32)


def lab_to_xyz(L: np.ndarray, a: np.ndarray, b: np.ndarray, white):
    """``TIFFCIELab16ToXYZ`` of 16-bit L (0-65535) and a*, b* (256 times
    the CIE values) -> float32 X, Y, Z, for the reference white ``white``
    (X0, Y0, Z0)."""
    x0, y0, z0 = white
    L = L.astype(np.float32) * _F(100) / _F(65535)
    dark = L < _F(8.856)
    y_dark = L * y0 / _F(903.292)
    cby_dark = _F(7.787) * (y_dark / y0) + _F(16) / _F(116)
    cby_lit = (L + _F(16)) / _F(116)
    cby = np.where(dark, cby_dark, cby_lit)
    Y = np.where(dark, y_dark, y0 * cby_lit * cby_lit * cby_lit)

    def cube(t, ref):
        return np.where(t < _F(0.2069), ref * (t - _F(0.13793)) / _F(7.787),
                        ref * t * t * t)

    X = cube(a.astype(np.float32) / _F(256) / _F(500) + cby, x0)
    Z = cube(cby - b.astype(np.float32) / _F(256) / _F(200), z0)
    return X, Y, Z


def xyz_to_rgb(X: np.ndarray, Y: np.ndarray, Z: np.ndarray) -> np.ndarray:
    """``TIFFXYZToRGB`` on ``display_sRGB`` -> (..., 3) uint8: luminances
    through the matrix, clipped to the display's black and white, each a
    step of ``(100 - 1) / 1500`` into ``_srgb_table``, rounded."""
    table = _srgb_table()
    step = (_SRGB_Y_WHITE - _SRGB_Y_BLACK) / _F(_RANGE)
    out = []
    for m in _SRGB_MATRIX:
        lum = m[0] * X + m[1] * Y + m[2] * Z
        lum = np.minimum(np.maximum(lum, _SRGB_Y_BLACK), _SRGB_Y_WHITE)
        i = np.minimum((lum - _SRGB_Y_BLACK) / step, _F(_RANGE)).astype(
            np.int64)
        v = table[i].astype(np.float64)
        out.append(np.minimum((v + 0.5).astype(np.int64), _SRGB_V_WHITE))
    return np.stack(out, -1).astype(np.uint8)


def reference_white(white_point=None) -> tuple:
    """``initCIELabConversion``'s reference white (X0, Y0 = 100, Z0) from
    the WhitePoint chromaticity (x, y), D50 where None."""
    x, y = (_F(v) for v in (white_point or _D50_WHITE))
    hundred = _F(100)
    return x / y * hundred, hundred, (_F(1) - x - y) / y * hundred


def cielab_to_rgb(lab: np.ndarray, bits: int, white_point=None) -> np.ndarray:
    """(..., 3) CIE L*a*b* samples (8-bit: L unsigned, a* and b* signed
    bytes; 16-bit: L unsigned, a* and b* signed, as uint16 words) -> (...,
    3) uint8 RGB as libtiff's ``putcontig8bitCIELab8`` and ``...16``
    give it."""
    if bits == 8:
        L = lab[..., 0].astype(np.int64) * 257
        a = lab[..., 1].astype(np.uint8).view(np.int8).astype(np.int64) * 256
        b = lab[..., 2].astype(np.uint8).view(np.int8).astype(np.int64) * 256
    else:
        L = lab[..., 0].astype(np.int64)
        a = lab[..., 1].astype(np.uint16).view(np.int16).astype(np.int64)
        b = lab[..., 2].astype(np.uint16).view(np.int16).astype(np.int64)
    if white_point is not None and white_point[1] == 0:
        raise ValueError("CIELab TIFF of WhitePoint y = 0, which libtiff "
                         "refuses")
    return xyz_to_rgb(*lab_to_xyz(L, a, b, reference_white(white_point)))
