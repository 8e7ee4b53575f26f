"""An uncompressed BMP codec in numpy.  ``encode_bmp`` writes the bytes
``cv2.imwrite`` writes for a colour image; ``decode_bmp`` is equal to
``cv2.imread`` on the files it takes: BI_RGB with 8-bit palette, 24-bit or 32-bit pixels, and
32-bit BI_BITFIELDS with the standard masks (as cv2 writes 32-bit files),
bottom-up or top-down, with a BITMAPINFOHEADER or a later one.  Other BMPs
(1-, 4- and 16-bit, RLE, other masks, OS/2 headers) raise
``Unsupported``."""

from __future__ import annotations

import struct

import numpy as np

from underwater_image_enhancement_tpu_torch.utils.jpeg import Unsupported

_BI_RGB, _BI_BITFIELDS = 0, 3
# the red, green and blue masks of a standard 32-bit BMP
_STANDARD_MASKS = (0x00FF0000, 0x0000FF00, 0x000000FF)


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> (H, W, 3) uint8 RGB.  Raises ``Unsupported`` for the
    BMPs above, ValueError for corrupt ones."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    if hsize < 40:
        raise Unsupported("OS/2 BMP (BITMAPCOREHEADER)")
    W, Hs, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    (clr_used,) = struct.unpack("<I", data[46:50])
    if comp == _BI_BITFIELDS and bpp == 32:
        masks = struct.unpack("<III", data[54:66])
        if masks != _STANDARD_MASKS:
            raise Unsupported("BMP with bit-field masks "
                              + ", ".join(f"{m:#x}" for m in masks))
    elif comp != _BI_RGB:
        raise Unsupported(f"compressed BMP (compression {comp}, {bpp}-bit)")
    if bpp not in (8, 24, 32):
        raise Unsupported(f"{bpp}-bit BMP")
    H = abs(Hs)
    if W <= 0 or H == 0:
        raise ValueError("corrupt BMP: empty image")
    stride = (W * bpp + 31) // 32 * 4
    if offset + stride * H > len(data):
        raise ValueError("corrupt BMP: truncated pixel data")
    rows = np.frombuffer(data, np.uint8, stride * H, offset).reshape(H, stride)
    if Hs > 0:  # bottom-up
        rows = rows[::-1]
    if bpp == 8:
        n = min(clr_used or 256, 256)
        pal = np.zeros((256, 3), np.uint8)  # indices past the palette: black
        start = 14 + hsize
        pal[:n] = np.frombuffer(data, np.uint8, 4 * n, start).reshape(n, 4)[:, 2::-1]
        return pal[rows[:, :W]]
    px = bpp // 8
    return np.ascontiguousarray(rows[:, :W * px].reshape(H, W, px)[..., 2::-1])


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
