"""A BMP writer for the tests of the port's BMP decoder and for
``chip_smoke.py`` (whose machine has no cv2), numpy + ``struct`` only.

``bmp(rows, width, height, bpp, ...)`` writes a file around pixel data
given as bytes: a BITMAPINFOHEADER (or the 12-byte OS/2
BITMAPCOREHEADER, or a V4/V5 header), a palette (4-byte entries, 3-byte
for OS/2), bit-field masks, and the rows bottom-up unless ``top_down``.
``pack(samples, bpp)`` packs (H, W) palette indices or 16-bit values into
rows padded to 4 bytes; ``rle8`` and ``rle4`` code (H, W) palette indices
as the RLE8 and RLE4 compressions do, rows bottom-up, with runs,
absolute runs (an odd one padded to a word), and end of line and end of
bitmap escapes; a stream of escapes built by hand (a delta, an early end)
is written with ``codes``.
"""

from __future__ import annotations

import struct

import numpy as np

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def pack(samples: np.ndarray, bpp: int) -> bytes:
    """(H, W) values -> rows of ``bpp`` bits a pixel (most significant
    bits first below 8, little-endian at 16 and 32), each padded to 4
    bytes, in the order given."""
    a = np.asarray(samples)
    h, w = a.shape[:2]
    stride = (w * bpp + 31) // 32 * 4
    out = np.zeros((h, stride), np.uint8)
    if bpp >= 8:
        raw = a.astype({8: np.uint8, 16: "<u2", 24: np.uint8,
                        32: "<u4"}[bpp]).reshape(h, -1).view(np.uint8)
        out[:, :raw.shape[1]] = raw
        return out.tobytes()
    per = 8 // bpp
    n = -(-w // per)
    padded = np.zeros((h, n * per), np.int64)
    padded[:, :w] = a
    shifts = (8 - bpp * (1 + np.arange(per))).astype(np.int64)
    out[:, :n] = (padded.reshape(h, n, per) << shifts).sum(-1)
    return out.tobytes()


def bmp(pixels: bytes, width: int, height: int, bpp: int,
        compression: int = BI_RGB, palette=None, header: int = 40,
        masks=None, top_down: bool = False, clr_used=None,
        offset=None) -> bytes:
    """A BMP file of ``pixels`` (the rows as stored).  ``palette``: (N, 3)
    RGB entries; ``header``: 12 (BITMAPCOREHEADER: 16-bit sizes, 3-byte
    palette entries), 40, 108 or 124; ``masks``: the red, green, blue and
    (V4/V5) alpha bit fields, after a 40-byte header or in a V4/V5 one;
    ``clr_used`` the header's count of colours (default: the palette's
    length, 0 for none); ``offset``: the pixel data's offset in the file
    (default: right after the palette)."""
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]  # BGR
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    h = -height if top_down else height
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, h & 0xFFFF, 1, bpp)
    else:
        used = (len(palette) if palette is not None else 0) if (
            clr_used is None) else clr_used
        info = struct.pack("<IiiHHIIiiII", header, width, h, 1, bpp,
                           compression, len(pixels), 2835, 2835, used, 0)
        m = list(masks or ()) + [0] * (4 - len(masks or ()))
        if header > 40:
            info += struct.pack("<4I", *m) + b"\0" * (header - 56)
        elif masks is not None:
            info += struct.pack("<3I", *m[:3])
    start = 14 + len(info) + len(pal)
    offset = start if offset is None else offset
    gap = b"\0" * max(0, offset - start)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + info + pal + gap + pixels)


def codes(*parts) -> bytes:
    """RLE codes from parts: ("run", n, index_byte), ("abs", [bytes]),
    ("eol",), ("eob",), ("delta", dx, dy); an absolute run's bytes are
    padded to a word."""
    out = bytearray()
    for part in parts:
        kind = part[0]
        if kind == "run":
            out += bytes([part[1], part[2]])
        elif kind == "abs":
            data = bytes(part[2]) if len(part) > 2 else bytes(part[1])
            n = part[1] if len(part) > 2 else len(data)
            out += bytes([0, n]) + data + b"\0" * (len(data) & 1)
        elif kind == "eol":
            out += b"\0\0"
        elif kind == "eob":
            out += b"\0\1"
        elif kind == "delta":
            out += bytes([0, 2, part[1], part[2]])
    return bytes(out)


def _row_parts(row, bits: int):
    """One row of palette indices as RLE parts: runs of 3 or more equal
    pixels (RLE4: of one or two alternating indices) as runs, the rest
    as absolute runs of 3 to 255 pixels (shorter ones as runs)."""
    parts, i, n = [], 0, len(row)
    pair = bits == 4
    while i < n:
        j = i + 1
        while j < n and j - i < 255 and row[j] == row[i if not pair
                                                       else i + (j - i) % 2]:
            j += 1
        if j - i >= 3 or j == n:
            hi = row[i]
            lo = row[i + 1] if pair and j - i > 1 else hi
            parts.append(("run", j - i, (hi << 4 | lo) if pair else hi))
            i = j
            continue
        j = i
        while j < n and j - i < 255 and not (
                j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        if j - i < 3:
            for k in range(i, j):
                parts.append(("run", 1, (row[k] << 4) if pair else row[k]))
        else:
            seg = list(row[i:j])
            if pair:
                seg = seg + [0] * (len(seg) & 1)
                data = [seg[k] << 4 | seg[k + 1]
                        for k in range(0, len(seg), 2)]
                parts.append(("abs", j - i, data))
            else:
                parts.append(("abs", seg))
        i = j
    return parts


def rle(indices: np.ndarray, bits: int) -> bytes:
    """(H, W) palette indices coded as RLE8 (``bits`` 8) or RLE4 (4): the
    rows bottom-up, each ending in an end of line, the last in an end of
    bitmap."""
    parts = []
    rows = np.asarray(indices)[::-1].tolist()
    for k, row in enumerate(rows):
        parts += _row_parts(row, bits)
        parts.append(("eob",) if k == len(rows) - 1 else ("eol",))
    return codes(*parts)
