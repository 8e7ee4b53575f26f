"""Sun raster (``.sr``/``.ras``) in numpy, after OpenCV's
``grfmt_sunras.cpp``.  ``decode_sunras`` reads what ``cv2.imdecode`` of
cv2 5.0.0 reads, with its samples, and raises ValueError where it gives
None; ``encode_sunras`` writes the bytes ``cv2.imencode(".sr")`` writes.

cv2 5.0.0 reads RT_OLD and RT_STANDARD files of 1, 8, 24 and 32 bits,
rows padded to 16 bits, with an RMT_EQUAL_RGB colormap (at most
``2**bits`` entries, 1 and 8 bits only; an index past it black) or none.
It refuses RT_BYTE_ENCODED and RT_FORMAT_RGB files: its header check
compares the image's matrix type where it means the encoding, so no file
of either type passes it.  The channels in ``IMREAD_UNCHANGED``: three
for 24 and 32 bits and for a colormap with a colour in it; else one,
through a gray table that only a colormap fills, so that a 1- or 8-bit
file without a colormap reads as zeros there (``IMREAD_COLOR`` reads its
gray ramp).  24-bit pixels are B, G, R; 32-bit ones X, B, G, R.  Arrays
are in RGB order.

The encoder writes an RT_STANDARD header (the length field the padded
rows' bytes) and the rows of B, G, R samples padded to 16 bits; cv2 pads
a row with the next row's first byte (after the last row, a byte past
the image, written 0 here).
"""

from __future__ import annotations

import struct

import numpy as np

from underwater_image_enhancement_tpu_torch.utils.bmp import opencv_gray
from underwater_image_enhancement_tpu_torch.utils.pxm import check_size

MAGIC = 0x59A66A95
RT_OLD, RT_STANDARD = 0, 1
RMT_NONE, RMT_EQUAL_RGB = 0, 1


def decode_sunras(data: bytes, color: bool = False) -> np.ndarray:
    """Sun raster bytes -> cv2's image (module docstring)."""
    if len(data) < 32:
        raise ValueError("Sun raster cut short")
    (magic, width, height, bits, _, kind, maptype,
     maplength) = struct.unpack(">8i", data[:32])
    if magic != struct.unpack(">i", struct.pack(">I", MAGIC))[0]:
        raise ValueError("not a Sun raster file")
    pal_size = (1 << bits) * 3 if 0 < bits <= 8 else 0
    if not (width > 0 and height > 0 and bits in (1, 8, 24, 32)
            and kind in (RT_OLD, RT_STANDARD)
            and ((maptype == RMT_NONE and maplength == 0)
                 or (maptype == RMT_EQUAL_RGB and 0 < maplength <= pal_size
                     and bits <= 8))):
        raise ValueError("Sun raster header refused")
    check_size(width, height)
    palette = np.zeros((256, 3), np.uint8)  # R, G, B
    if maplength:
        cmap = data[32:32 + maplength]
        if len(cmap) < maplength:
            raise ValueError("Sun raster cut short")
        n = maplength // 3
        palette[:n] = np.frombuffer(cmap[:3 * n], np.uint8).reshape(3, n).T
        entries = palette[:1 << bits]
        three = bool((entries != entries[:, :1]).any())
    else:
        three = bits > 8
        if bits <= 8:
            palette[:1 << bits] = (np.arange(1 << bits) * 255
                                   // ((1 << bits) - 1))[:, None]
    pitch = ((width * bits + 7) // 8 + 1) & -2
    body = data[32 + maplength:32 + maplength + pitch * height]
    if len(body) < pitch * height:
        raise ValueError("Sun raster cut short")
    rows = np.frombuffer(body, np.uint8).reshape(height, pitch)
    if bits == 24:
        return rows[:, :3 * width].reshape(height, width, 3)[..., ::-1].copy()
    if bits == 32:
        return rows[:, :4 * width].reshape(height, width, 4)[..., :0:-1].copy()
    idx = (np.unpackbits(rows, axis=1)[:, :width] if bits == 1
           else rows[:, :width])
    if color or three:
        return palette[idx]
    gray = (opencv_gray(palette) if maptype == RMT_EQUAL_RGB
            else np.zeros(256, np.uint8))
    return gray[idx]


def encode_sunras(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> cv2's ``.sr``/``.ras`` bytes (module
    docstring)."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f".sr: an (H, W, 3) uint8 RGB image, not "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape[:2]
    step = (w * 3 + 1) & -2
    body = np.zeros(h * w * 3 + 1, np.uint8)
    body[:-1] = a[..., ::-1].reshape(-1)
    rows = np.lib.stride_tricks.as_strided(body, (h, step), (w * 3, 1))
    return (struct.pack(">8I", MAGIC, w, h, 24, step * h, RT_STANDARD,
                        RMT_NONE, 0) + rows.tobytes())
