"""A BMP codec in numpy.  ``encode_bmp`` writes the bytes ``cv2.imwrite``
writes for a colour image; ``decode_bmp`` reads every BMP that cv2 5.0.0's
own decoder (OpenCV's ``grfmt_bmp.cpp``) reads, with its pixels, and
raises ValueError where it gives None.

The headers: the 12-byte OS/2 BITMAPCOREHEADER (16-bit sizes, a palette
of 3-byte entries) and BITMAPINFOHEADER or any longer one.  The pixels:
1-, 4- and 8-bit palettes (4-byte entries, ``clrUsed`` of them or
2**bits, an index past them black), 16-bit 5-5-5 (BI_RGB, or BI_BITFIELDS
with the 5-5-5 or 5-6-5 masks, each field shifted to the top of its byte
with no bits replicated), 24-bit, 32-bit BI_RGB (the fourth byte dropped)
and BI_BITFIELDS, and RLE8 and RLE4, bottom-up or top-down.  A 32-bit
BI_BITFIELDS file is read as OpenCV reads it: its masks only from a
header of 56 bytes or more (after a 40-byte header they are ignored and
the bytes read as B, G, R, A), each field scaled by ``255 / max`` in
float32 and truncated, an absent alpha 255.

The channels cv2 gives in ``IMREAD_UNCHANGED``: one, the gray of the
colours by OpenCV's weights, for a palette whose entries are all gray and
for every OS/2 file; four for 32-bit BI_BITFIELDS; three otherwise.
``IMREAD_COLOR`` gives three.  RLE follows OpenCV's decoder: runs, absolute
runs (padded to a word), end of line and end of bitmap fill what they skip
with palette entry 0, and so does a delta, counted on from the current
pixel over the rows; a run past its row is refused, and an RLE8 run that
ends a row takes the row's end of line with it.
"""

from __future__ import annotations

import struct

import numpy as np

_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
# OpenCV's BGR-to-gray weights of R, G and B, 14-bit fixed point
_GRAY = (4899, 9617, 1868)


def opencv_gray(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's ``icvCvt_BGR2Gray_8u_C3C1R`` (and ``BGRA2Gray``, which its
    image decoders use) of (..., 3) uint8 RGB."""
    c = rgb.astype(np.int32)
    return ((c[..., 0] * _GRAY[0] + c[..., 1] * _GRAY[1]
             + c[..., 2] * _GRAY[2] + (1 << 13)) >> 14).astype(np.uint8)


class _Reader:
    """OpenCV's RBaseStream: reads past the data's end raise ValueError."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError("corrupt BMP: data past the file's end")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


def _header(data: bytes):
    """(width, height, bits, compression, palette (256, 3) RGB or None,
    whether cv2 reads it as colour, masks (R, G, B, A) or None, pixel
    offset) as OpenCV's ``BmpDecoder::readHeader`` finds them."""
    if len(data) < 18 or data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset, size = struct.unpack("<II", data[10:18])
    palette, masks, color = None, None, True
    if size >= 36:
        if len(data) < 50:
            raise ValueError("corrupt BMP: short header")
        W, H, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
        (used,) = struct.unpack("<I", data[46:50])
        if comp > _BI_BITFIELDS:
            raise ValueError(f"BMP of compression {comp}, which cv2 does "
                             "not read")
        if bpp == 32 and comp == _BI_BITFIELDS and size >= 56:
            masks = struct.unpack("<4I", _Reader(data, 54).take(16))
        if bpp <= 8:
            if used > 256:
                raise ValueError("corrupt BMP: more than 256 colours")
            n = used or 1 << bpp
            raw = _Reader(data, 14 + size).take(4 * n)
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = np.frombuffer(raw, np.uint8).reshape(n, 4)[:, 2::-1]
            color = bool((palette[:1 << bpp] != palette[:1 << bpp, :1]).any())
        elif bpp == 16 and comp == _BI_BITFIELDS:
            bits = struct.unpack("<3I", _Reader(data, 14 + size).take(12))
            if bits == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif bits != (0xF800, 0x7E0, 0x1F):
                raise ValueError("16-bit BMP with bit fields other than "
                                 "5-5-5 and 5-6-5, which cv2 does not read")
        elif bpp == 16 and comp == _BI_RGB:
            bpp = 15
    elif size == 12:  # OS/2: cv2 reads it as gray in IMREAD_UNCHANGED
        W, H, _, bpp = struct.unpack("<HHHH", _Reader(data, 18).take(8))
        comp, color = _BI_RGB, False
        if bpp == 16:
            raise ValueError("16-bit OS/2 BMP, which cv2 does not read")
        if bpp <= 8:
            n = 1 << bpp
            raw = _Reader(data, 26).take(3 * n)
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = np.frombuffer(raw, np.uint8).reshape(n, 3)[:, ::-1]
    else:
        raise ValueError(f"BMP with a {size}-byte header, which cv2 does "
                         "not read")
    if W <= 0 or H == 0:
        raise ValueError("corrupt BMP: empty image")
    if W > 1 << 20 or abs(H) > 1 << 20 or W * abs(H) > 1 << 30:
        raise ValueError("BMP past cv2's image size limits")
    if bpp not in (1, 4, 8, 15, 16, 24, 32):
        raise ValueError(f"{bpp}-bit BMP, which cv2 does not read")
    if (comp == _BI_RLE8 and bpp != 8) or (comp == _BI_RLE4 and bpp != 4):
        raise ValueError(f"RLE BMP of {bpp} bits, which cv2 does not read")
    return W, H, bpp, comp, palette, color, masks, offset


def _fill(out: np.ndarray, x: int, y: int, count: int, value) -> tuple:
    """OpenCV's ``FillUniColor``: ``count`` pixels of ``value`` from
    (x, y) on, row after row (the rows in file order), stopping past the
    last row -> the new (x, y)."""
    H, W = out.shape
    while True:
        end = min(x + count, W)
        count -= end - x
        out[y, x:end] = value
        x = end
        if x >= W:
            x, y = 0, y + 1
            if y >= H:
                break
        if count <= 0:
            break
    return x, y


def _rle(data: bytes, offset: int, W: int, H: int, bits: int) -> np.ndarray:
    """An RLE8 or RLE4 stream -> (H, W) palette indices, rows in file
    order, as OpenCV's decoder reads it."""
    out = np.zeros((H, W), np.uint8)
    rd = _Reader(data, offset)
    x = y = 0
    line_end_flag = 0
    while True:
        n, code = rd.take(2)
        if n:  # a run
            if x + n > W:
                raise ValueError("corrupt BMP: an RLE run past its row")
            if bits == 8:
                prev = y
                x, y = _fill(out, x, y, n, code)
                line_end_flag = y - prev
                if y >= H:
                    break
            else:
                out[y, x:x + n] = np.resize([code >> 4, code & 15], n)
                x += n
        elif code > 2:  # an absolute run, padded to a word
            if x + code > W:
                raise ValueError("corrupt BMP: an RLE run past its row")
            if bits == 8:
                raw = rd.take((code + 1) & ~1)
                out[y, x:x + code] = np.frombuffer(raw, np.uint8)[:code]
            else:
                raw = np.frombuffer(rd.take((((code + 1) >> 1) + 1) & ~1),
                                    np.uint8)
                out[y, x:x + code] = np.stack(
                    [raw >> 4, raw & 15], -1).reshape(-1)[:code]
            x += code
            line_end_flag = 0
        else:  # end of line (0), end of bitmap (1), delta (2)
            dx, dy = W - x, H - y
            if bits == 4:  # OpenCV's RLE4: every escape moves by dx only
                if code == 2:
                    dx = rd.take(2)[0]
                x, y = _fill(out, x, y, dx, 0)
            elif code or not line_end_flag or dx < W:
                if code == 2:
                    dx, dy = rd.take(2)
                x, y = _fill(out, x, y, dx + (dy * W if code else 0), 0)
            line_end_flag = 0
            if y >= H:
                break
    return out


def _unpack(rows: np.ndarray, W: int, bits: int) -> np.ndarray:
    per = 8 // bits
    shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
    return ((rows[..., None] >> shifts) & ((1 << bits) - 1)).reshape(
        rows.shape[0], -1)[:, :W]


def _masked(px: np.ndarray, masks) -> np.ndarray:
    """32-bit pixels -> (H, W, 4) RGBA by OpenCV's bit-field masks: each
    field times ``255 / max`` of its mask in float32, truncated; alpha 255
    without its mask."""
    v = px.astype("<u4").view(np.uint32).astype(np.int64)
    out = np.empty(v.shape + (4,), np.uint8)
    for k, m in enumerate(masks):
        if not m:
            out[..., k] = 255
            continue
        shift = (m & -m).bit_length() - 1
        scale = np.float32(255) / np.float32(m >> shift)
        out[..., k] = (((v & m) >> shift).astype(np.float32) * scale).astype(
            np.int64)
    return out


def decode_bmp(data: bytes, color: bool = False) -> np.ndarray:
    """BMP bytes -> (H, W, C) uint8: what ``cv2.imread(path,
    IMREAD_UNCHANGED)`` gives (C = 1, 3 or 4, as the module docstring
    says), in RGB order; with ``color`` what ``IMREAD_COLOR`` gives (C =
    3).  ValueError where cv2 gives None."""
    W, Hs, bpp, comp, palette, is_color, masks, offset = _header(data)
    H = abs(Hs)
    if comp in (_BI_RLE8, _BI_RLE4):
        px = _rle(data, offset, W, H, bpp)
    else:
        stride = (W * (16 if bpp == 15 else bpp) + 31) // 32 * 4
        rows = np.frombuffer(_Reader(data, offset).take(stride * H),
                             np.uint8).reshape(H, stride)
        if bpp < 8:
            px = _unpack(rows, W, bpp)
        elif bpp == 8:
            px = rows[:, :W]
        elif bpp in (15, 16):
            v = rows[:, :2 * W].copy().view("<u2").astype(np.int32)
            if bpp == 15:
                px = np.stack([(v >> 7) & 0xF8, (v >> 2) & 0xF8,
                               (v << 3) & 0xF8], -1)
            else:
                px = np.stack([(v >> 8) & 0xF8, (v >> 3) & 0xFC,
                               (v << 3) & 0xF8], -1)
            px = px.astype(np.uint8)
        else:
            px = rows[:, :W * bpp // 8].reshape(H, W, bpp // 8)
            if bpp == 32 and comp == _BI_BITFIELDS and masks is not None \
                    and all(masks[:3]):
                px = _masked(rows[:, :4 * W].copy().view("<u4"), masks)
            else:
                px = np.concatenate([px[..., 2::-1], px[..., 3:]], -1)
    if Hs > 0:  # bottom-up
        px = px[::-1]
    if palette is not None:
        px = palette[px]
    if color:
        return np.ascontiguousarray(px[..., :3])
    if not is_color:
        return opencv_gray(px[..., :3])[..., None]
    if bpp == 32 and comp == _BI_BITFIELDS:
        return np.ascontiguousarray(px)
    return np.ascontiguousarray(px[..., :3])


def encode_bmp(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the 24-bit BMP ``cv2.imwrite`` writes for the
    BGR image: a BITMAPINFOHEADER (BI_RGB, no image size, resolution or
    palette), bottom-up BGR rows each padded with zeros to 4 bytes."""
    a = np.asarray(rgb)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"cannot encode an array of {a.dtype} and shape "
                         f"{a.shape} as BMP: (H, W, 3) uint8 RGB")
    H, W = a.shape[:2]
    stride = (W * 3 + 3) & ~3
    rows = np.zeros((H, stride), np.uint8)
    rows[:, :W * 3] = a[::-1, :, ::-1].reshape(H, W * 3)
    header = 14 + 40
    return (b"BM" + struct.pack("<IIIIiiHHIIiiII", header + stride * H, 0,
                                header, 40, W, H, 1, 24, _BI_RGB, 0, 0, 0,
                                0, 0)
            + rows.tobytes())
