"""A PNG writer for the tests, numpy + ``zlib`` + ``struct`` only: every
colour type and bit depth the PNG specification allows, PLTE and tRNS,
ancillary chunks, Adam7 interlace, the image data cut into several IDAT
chunks, and a filter type chosen for each row.  The card machine has no
cv2, so ``chip_smoke.py`` writes its PNG files with it too.

A file is ``encode(samples, depth, ctype, ...)``: ``samples`` an (H, W)
or (H, W, C) array of integer sample values (palette indices for colour
type 3), packed most significant bit first below 8 bits and big-endian at
16.  ``filters`` gives a row's filter type: an int for every row, or a
function of the row's number counted over the whole file (Adam7's passes
one after the other); the default cycles 0-4.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of the seven passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(tag: bytes, body: bytes) -> bytes:
    """A chunk with its length and CRC."""
    crc = zlib.crc32(tag + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) sample values -> (h, row bytes) uint8: big-endian at 16
    bits, packed most significant bit first (the row padded to a byte)
    below 8."""
    h, w, c = samples.shape
    s = samples.reshape(h, w * c).astype(np.int64)
    if depth == 16:
        return s.astype(">u2").view(np.uint8).reshape(h, 2 * w * c)
    if depth == 8:
        return s.astype(np.uint8)
    per = 8 // depth
    n = -(-w * c // per)
    padded = np.zeros((h, n * per), np.int64)
    padded[:, :w * c] = s
    shifts = (8 - depth * (1 + np.arange(per))).astype(np.int64)
    return (padded.reshape(h, n, per) << shifts).sum(-1).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_row(ft: int, raw: np.ndarray, prev: np.ndarray,
               bpp: int) -> np.ndarray:
    """One row of bytes under filter type ``ft`` (0-4), ``prev`` the row
    above (zeros for a pass's first row), ``bpp`` bytes a pixel (at least
    1)."""
    x = raw.astype(np.int64)
    b = prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[ft]
    return ((x - pred) & 255).astype(np.uint8)


def _image_data(samples, depth, bpp, filters, first_row=0):
    """The filtered bytes of one (sub)image: a filter byte, then the row;
    nothing for an empty image.  Returns (bytes, rows written)."""
    h, w = samples.shape[:2]
    if h == 0 or w == 0:
        return b"", 0
    rows = pack_rows(samples, depth)
    out, prev = [], np.zeros(rows.shape[1], np.uint8)
    for y in range(h):
        ft = filters if isinstance(filters, int) else filters(first_row + y)
        out.append(bytes([ft]) + filter_row(ft, rows[y], prev, bpp).tobytes())
        prev = rows[y]
    return b"".join(out), h


def raw_data(samples: np.ndarray, depth: int, interlace: bool = False,
             filters=None) -> bytes:
    """The uncompressed image data of ``samples`` ((H, W, C))."""
    filters = (lambda y: y % 5) if filters is None else filters
    bpp = max(1, samples.shape[2] * depth // 8)
    if not interlace:
        return _image_data(samples, depth, bpp, filters)[0]
    out, n = [], 0
    for x0, y0, dx, dy in ADAM7:
        part, k = _image_data(samples[y0::dy, x0::dx], depth, bpp, filters, n)
        out.append(part)
        n += k
    return b"".join(out)


def encode(samples: np.ndarray, depth: int = 8, ctype: int | None = None,
           *, palette=None, trns=None, interlace: bool = False,
           filters=None, chunks=(), idat_parts: int = 1,
           level: int = 6) -> bytes:
    """PNG bytes of ``samples``.  ``ctype`` defaults from the channels
    (1 gray, 2 gray + alpha, 3 RGB, 4 RGBA).  ``palette``: (N, 3) RGB of
    colour type 3; ``trns``: the tRNS body's values (a palette's alphas,
    or gray's one value, or RGB's three); ``chunks``: ancillary (tag,
    body) pairs written before PLTE; ``idat_parts``: the compressed stream
    cut into that many IDAT chunks."""
    a = np.asarray(samples)
    a = a[..., None] if a.ndim == 2 else a
    if ctype is None:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[a.shape[2]]
    if a.shape[2] != CHANNELS[ctype] or depth not in DEPTHS[ctype]:
        raise ValueError(f"colour type {ctype} at depth {depth} with "
                         f"{a.shape[2]} samples a pixel")
    if a.min(initial=0) < 0 or a.max(initial=0) >= 1 << depth:
        raise ValueError(f"a sample outside {depth} bits")
    H, W = a.shape[:2]
    out = [SIGNATURE, chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, ctype, 0, 0, int(interlace)))]
    out += [chunk(tag, body) for tag, body in chunks]
    if palette is not None:
        out.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        fmt = "B" if ctype == 3 else "H"
        out.append(chunk(b"tRNS", struct.pack(f">{len(trns)}{fmt}", *trns)))
    z = zlib.compress(raw_data(a, depth, interlace, filters), level)
    cuts = np.linspace(0, len(z), idat_parts + 1).astype(int)
    out += [chunk(b"IDAT", z[s:e]) for s, e in zip(cuts[:-1], cuts[1:])]
    out.append(chunk(b"IEND", b""))
    return b"".join(out)
