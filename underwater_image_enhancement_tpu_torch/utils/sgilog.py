"""SGILog TIFF strips and tiles (compression 34676, SGILog, under
photometric interpretation 32844, LogL, or 32845, LogLuv; 34677,
SGILog24, under LogLuv), decoded as libtiff 4.7.1's ``tif_luv.c``, the
codec inside cv2 5.0.0, decodes them.

Each row is coded alone.  SGILog rows are byte planes, most significant
first (LogL: the two bytes of a 16-bit log luminance, its sign in bit
15; LogLuv: those two, then the u and v bytes), each plane run-length
coded: a byte of 128 or more is a run of ``byte - 126`` copies of the
next byte, a smaller one a literal of that many bytes (0 does nothing).
A run or literal that passes the row's end is cut there and its last
bytes are read as the next plane's codes; a row whose data ends first
fails, and with it the strip (``decode`` gives the rows before it).
SGILog24 rows are three bytes a pixel: a 10-bit log luminance, then a
14-bit code of (u, v).

The values, as libtiff's ``LogL16toY``, ``LogL10toY``, ``uv_decode``,
``LogLuv32toXYZ`` and ``LogLuv24toXYZ`` make them in doubles: Y =
exp(ln 2 / 256 (Le + 0.5) - 64 ln 2) (C's ``exp``, Python's
``math.exp``, never numpy's), u and v ``1 / 410 (byte + 0.5)`` or the
centre of the code's square in ``_USTART``/``_NUS`` (an invalid code the
neutral point), x = 9u / (6u - 16v + 12), y = 4v / (6u - 16v + 12), X =
x / y Y, Z = (1 - x - y) / y Y, each stored as a float; a luminance of
0 or below gives 0 for all three.  libtiff's RGBA reader asks for 8 bits
(``rgb8``, ``gray8``): ``XYZtoRGB24``'s CCIR-709 matrix on the floats,
then ``(int)(256 sqrt(c))`` clamped to 0 and 255, and LogL's
``L16toGry`` ``(int)(256 sqrt(Y))`` the same.  cv2 itself asks LogLuv
for floats (``xyz``).

``_USTART`` and ``_NUS`` are libtiff's ``uv_row`` table (``uvcode.h``:
each row of v's squares, its first u and its count of squares; the
codes count the squares row by row), recovered by calling libtiff's
``uv_decode`` on every 14-bit code and inverting each code's (u, v); the
163 rows equal the ``uv_row`` bytes of libtiff's ``tif_luv.o``.
"""

from __future__ import annotations

import functools
import math

import numpy as np

SGILOG, SGILOG24 = 34676, 34677
LOGL, LOGLUV = 32844, 32845
_LN2 = 0.69314718055994530942
# float constants of uvcode.h, promoted to double where they are used
_UV_SQSIZ = float(np.float32(0.0035))
_UV_VSTART = float(np.float32(0.01694))
_U_NEU, _V_NEU = 0.210526316, 0.473684211
_UVSCALE = 410.0
_USTART = (
    0.247663, 0.243779, 0.241684, 0.237874, 0.235906, 0.232153, 0.228352,
    0.226259, 0.222371, 0.22041, 0.21471, 0.212714, 0.210721, 0.204976,
    0.202986, 0.199245, 0.195525, 0.19356, 0.189878, 0.186216, 0.186216,
    0.182592, 0.179003, 0.175466, 0.172001, 0.172001, 0.168612, 0.168612,
    0.163575, 0.158642, 0.158642, 0.158642, 0.153815, 0.153815, 0.149097,
    0.149097, 0.142746, 0.142746, 0.142746, 0.13827, 0.13827, 0.13827,
    0.132166, 0.132166, 0.126204, 0.126204, 0.126204, 0.120381, 0.120381,
    0.120381, 0.120381, 0.112962, 0.112962, 0.112962, 0.10745, 0.10745,
    0.10745, 0.10745, 0.100343, 0.100343, 0.100343, 0.095126, 0.095126,
    0.095126, 0.095126, 0.088276, 0.088276, 0.088276, 0.088276, 0.081523,
    0.081523, 0.081523, 0.081523, 0.074861, 0.074861, 0.074861, 0.074861,
    0.06829, 0.06829, 0.06829, 0.06829, 0.063573, 0.063573, 0.063573, 0.063573,
    0.057219, 0.057219, 0.057219, 0.057219, 0.050985, 0.050985, 0.050985,
    0.050985, 0.050985, 0.044859, 0.044859, 0.044859, 0.044859, 0.040571,
    0.040571, 0.040571, 0.040571, 0.036339, 0.036339, 0.036339, 0.036339,
    0.032139, 0.032139, 0.032139, 0.032139, 0.027947, 0.027947, 0.027947,
    0.023739, 0.023739, 0.023739, 0.023739, 0.019504, 0.019504, 0.019504,
    0.016976, 0.016976, 0.016976, 0.016976, 0.012639, 0.012639, 0.012639,
    0.009991, 0.009991, 0.009991, 0.009016, 0.009016, 0.009016, 0.006217,
    0.006217, 0.005097, 0.005097, 0.005097, 0.003909, 0.003909, 0.00234,
    0.002389, 0.001068, 0.001653, 0.000717, 0.001614, 0.00027, 0.000484,
    0.001103, 0.001242, 0.001188, 0.001011, 0.000709, 0.000301, 0.002416,
    0.003251, 0.003246, 0.004141, 0.005963, 0.008839, 0.01049, 0.016994,
    0.023659)
_NUS = (
    4, 6, 7, 9, 10, 12, 14, 15, 17, 18, 21, 22, 23, 26, 27, 29, 31, 32, 34, 36,
    36, 38, 40, 42, 44, 44, 46, 46, 49, 52, 52, 52, 55, 55, 58, 58, 62, 62, 62,
    65, 65, 65, 69, 69, 73, 73, 73, 77, 77, 77, 77, 82, 82, 82, 86, 86, 86, 86,
    91, 91, 91, 95, 95, 95, 95, 100, 100, 100, 100, 105, 105, 105, 105, 110,
    110, 110, 110, 115, 115, 115, 115, 119, 119, 119, 119, 124, 124, 124, 124,
    129, 129, 129, 129, 129, 134, 134, 134, 134, 138, 138, 138, 138, 142, 142,
    142, 142, 146, 146, 146, 146, 150, 150, 150, 154, 154, 154, 154, 158, 158,
    158, 161, 161, 161, 161, 165, 165, 165, 168, 168, 168, 170, 170, 170, 173,
    173, 175, 175, 175, 177, 177, 177, 170, 164, 157, 150, 143, 136, 129, 123,
    115, 109, 103, 97, 89, 82, 76, 69, 62, 55, 47, 40, 31, 21)


def check(compression: int, photometric: int, spp: int, planar: int,
          color: bool) -> None:
    """ValueError where cv2 gives None for an SGILog file."""
    if photometric not in (LOGL, LOGLUV):
        # LogLuvSetupDecode: "Inappropriate photometric interpretation"
        raise ValueError(f"SGILog TIFF of photometric interpretation "
                         f"{photometric}, which cv2 does not read")
    if photometric == LOGL and compression != SGILOG:
        raise ValueError("SGILog24 LogL TIFF, which cv2 does not read")
    if photometric == LOGL and spp != 1:
        raise ValueError(f"LogL TIFF of {spp} samples, which cv2 does not "
                         "read")
    if photometric == LOGLUV and (spp != 3 or planar != 1):
        raise ValueError(f"LogLuv TIFF of {spp} samples (planar "
                         f"configuration {planar}), which cv2 does not read")


def _rle(data: bytes, rows: int, width: int, planes: int):
    """``LogL16Decode``/``LogLuvDecode32``'s byte planes -> (bytes of
    (rows, planes, width), the rows decoded whole)."""
    out = bytearray(rows * planes * width)
    pos, end = 0, len(data)
    for r in range(rows):
        for p in range(planes):
            base = (r * planes + p) * width
            i = 0
            while i < width and pos < end:
                b = data[pos]
                if b >= 128:
                    if end - pos < 2:
                        break
                    k = min(b - 126, width - i)
                    out[base + i:base + i + k] = data[pos + 1:pos + 2] * k
                    pos += 2
                else:
                    # while (--cc && rc-- && i < npixels): the header and
                    # each byte copied
                    k = min(b, width - i, end - pos - 1)
                    out[base + i:base + i + k] = data[pos + 1:pos + 1 + k]
                    pos += 1 + k
                i += k
            if i != width:
                return out, r
    return out, rows


def decode(chunk: bytes, compression: int, photometric: int, rows: int,
           width: int):
    """A strip or tile -> ((rows, width) codes, the rows decoded before
    the first that fails): LogL's signed 16-bit words (int16), LogLuv's
    32-bit words (L16, u8, v8) or 24-bit ones (L10, uv14) (uint32)."""
    if compression == SGILOG24:
        good = min(rows, len(chunk) // (3 * width))
        b = np.zeros(rows * width * 3, np.uint32)
        b[:good * width * 3] = np.frombuffer(chunk, np.uint8)[
            :good * width * 3]
        b = b.reshape(rows, width, 3)
        return (b[..., 0] << 16) | (b[..., 1] << 8) | b[..., 2], good
    planes = 2 if photometric == LOGL else 4
    raw, good = _rle(chunk, rows, width, planes)
    p = np.frombuffer(bytes(raw), np.uint8).reshape(rows, planes, width)
    p = p.astype(np.uint32)
    if planes == 2:
        return ((p[:, 0] << 8) | p[:, 1]).astype(np.uint16).view(
            np.int16), good
    return (p[:, 0] << 24) | (p[:, 1] << 16) | (p[:, 2] << 8) | p[:, 3], good


@functools.cache
def _l16_y() -> np.ndarray:
    """``LogL16toY`` of each 16-bit code (by its bits as unsigned)."""
    y = [0.0] + [math.exp(_LN2 / 256.0 * (le + 0.5) - _LN2 * 64.0)
                 for le in range(1, 0x8000)]
    return np.array(y + [0.0] + [-v for v in y[1:]])


@functools.cache
def _l10_y() -> np.ndarray:
    """``LogL10toY`` of each 10-bit code."""
    return np.array([0.0] + [math.exp(_LN2 / 64.0 * (p + 0.5) - _LN2 * 12.0)
                             for p in range(1, 1024)])


@functools.cache
def _uv_codes() -> np.ndarray:
    """``uv_decode`` of each 14-bit code -> (16384, 2) u, v; the codes past
    the table the neutral (U_NEU, V_NEU)."""
    uv = np.empty((16384, 2))
    uv[:] = _U_NEU, _V_NEU
    code = 0
    for vi, (ustart, nus) in enumerate(zip(_USTART, _NUS)):
        ui = np.arange(nus)
        uv[code:code + nus, 0] = float(np.float32(ustart)) + (
            ui + 0.5) * _UV_SQSIZ
        uv[code:code + nus, 1] = _UV_VSTART + (vi + 0.5) * _UV_SQSIZ
        code += nus
    return uv


def xyz(codes: np.ndarray, compression: int) -> np.ndarray:
    """LogLuv codes -> (..., 3) float32 X, Y, Z (``LogLuv32toXYZ``,
    ``LogLuv24toXYZ``)."""
    if compression == SGILOG24:
        lum = _l10_y()[(codes >> 14) & 0x3FF]
        u, v = np.moveaxis(_uv_codes()[codes & 0x3FFF], -1, 0)
    else:
        lum = _l16_y()[codes >> 16]
        u = 1.0 / _UVSCALE * (((codes >> 8) & 0xFF) + 0.5)
        v = 1.0 / _UVSCALE * ((codes & 0xFF) + 0.5)
    s = 1.0 / (6.0 * u - 16.0 * v + 12.0)
    x = 9.0 * u * s
    y = 4.0 * v * s
    out = np.stack([x / y * lum, lum, (1.0 - x - y) / y * lum], -1)
    out[lum <= 0] = 0
    return out.astype(np.float32)


def _to8(c: np.ndarray) -> np.ndarray:
    """``(int)(256 sqrt(c))``, 0 at or below 0, 255 from 1."""
    with np.errstate(invalid="ignore"):
        v = np.floor(256.0 * np.sqrt(np.maximum(c, 0)))
    return np.where(c <= 0, 0, np.where(c >= 1, 255, v)).astype(np.uint8)


def rgb8(codes: np.ndarray, compression: int) -> np.ndarray:
    """LogLuv codes -> (..., 3) uint8 RGB as ``XYZtoRGB24`` makes them from
    ``xyz``'s floats."""
    f = xyz(codes, compression).astype(np.float64)
    X, Y, Z = f[..., 0], f[..., 1], f[..., 2]
    r = 2.690 * X + -1.276 * Y + -0.414 * Z
    g = -1.022 * X + 1.978 * Y + 0.044 * Z
    b = 0.061 * X + -0.224 * Y + 1.163 * Z
    return np.stack([_to8(r), _to8(g), _to8(b)], -1)


def gray8(codes: np.ndarray) -> np.ndarray:
    """LogL codes -> uint8 gray as ``L16toGry`` makes it."""
    return _to8(_l16_y())[codes.view(np.uint16)]


# OpenCV's XYZ2sRGB_D65 (float), its rows in RGB order
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535],
                     [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]], np.float32)


def xyz_to_rgb(f: np.ndarray) -> np.ndarray:
    """(H, W, 3) float32 X, Y, Z -> RGB as cv2 5.0.0's ``cvtColor(...,
    COLOR_XYZ2BGR)`` computes it in float32, bit for bit: each row's first
    ``W // 4 * 4`` pixels in its 4-lane loop, ``c0 x + (c1 y + c2 z)``,
    the rest in its scalar loop, ``(c0 x + c1 y) + c2 z``, every product
    and sum rounded to float32 (no fused multiply-add)."""
    x, y, z = f[..., 0], f[..., 1], f[..., 2]
    vector = (np.arange(f.shape[1]) < f.shape[1] // 4 * 4)[:, None]
    out = np.empty(f.shape, np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        for i, (c0, c1, c2) in enumerate(_XYZ2RGB):
            px, py, pz = x * c0, y * c1, z * c2
            out[..., i] = np.where(vector[:, 0], px + (py + pz),
                                   (px + py) + pz)
    return out
