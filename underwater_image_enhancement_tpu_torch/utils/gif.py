"""The first image of a GIF, as cv2 5.0.0's decoder (OpenCV's
``grfmt_gif.cpp``) gives it: ``decode_gif`` returns its pixels and raises
ValueError where ``cv2.imdecode`` gives None.

What cv2 does, and so what this does:

- The whole file is walked first, to its trailer: a file cut short, or a
  block that is neither an extension, an image nor the trailer, is
  refused.  The signature is ``GIF87a`` or ``GIF89a``; the logical screen
  is not empty; the background index lies in the global table, where
  there is one.
- The canvas is the logical screen, filled with the global table's
  background colour (black without a global table), alpha 0.  The first
  image must lie inside it; its descriptor may be smaller and offset.
- The last graphic control extension before the image gives its
  transparent index: those pixels keep the canvas.  The last graphic
  control extension in the file decides the channels: four (alpha 255 on
  the image's other pixels) where it sets the transparency flag and
  ``IMREAD_UNCHANGED`` is asked for, else three.
- An index is looked up in the local table, then past its end in the
  global one; past both it is refused.  With neither table, index 1 is
  white and any other index ``i`` the gray ``i``.
- LZW of a minimum code size 2-11 over the sub-blocks: clear codes, code
  widths growing to 12 bits, a full table kept until the next clear
  code, an index of 8 bits (a literal code past 255 keeps its low
  byte).  The image must get exactly its pixels: more or fewer, or a code
  past the table, is refused.  The end code, or the data's end, ends the
  stream.  (Past the end code, and for a code that the last byte's
  padding completes, cv2 reads from a table it has freed; a pixel past
  the image is refused here.)
- An interlaced image's rows come in the four passes (0, 8), (4, 8),
  (2, 4), (1, 2).

Arrays are in RGB(A) order.
"""

from __future__ import annotations

import struct

import numpy as np

from underwater_image_enhancement_tpu_torch.utils.pxm import (
    ByteStream,
    check_size,
)

# an index with neither table: i gray, 1 white
_NO_TABLE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
_NO_TABLE[1] = 255


class _Stream(ByteStream):
    def sub_blocks(self) -> bytes:
        """The data of a run of sub-blocks, to its empty one."""
        out = []
        n = self.byte()
        while n:
            out.append(self.take(n))
            n = self.byte()
        return b"".join(out)

    def table(self, flags: int):
        return (np.frombuffer(self.take(3 << ((flags & 7) + 1)),
                              np.uint8).reshape(-1, 3)
                if flags & 0x80 else None)


def _walk(s: _Stream) -> bool:
    """Walk the blocks to the trailer -> whether the last graphic control
    extension sets the transparency flag."""
    alpha = False
    while True:
        kind = s.byte()
        if kind == 0x3B:
            return alpha
        if kind == 0x21:
            label = s.byte()
            body = s.sub_blocks()
            if label == 0xF9:
                alpha = bool(body[:1]) and bool(body[0] & 1)
        elif kind == 0x2C:
            s.table(s.take(9)[8])
            s.byte()
            s.sub_blocks()
        else:
            raise ValueError(f"GIF: unknown block {kind:#x}")


def _lzw(stream: bytes, min_size: int, npix: int) -> np.ndarray:
    """The indices of an LZW stream (module docstring)."""
    clear = 1 << min_size
    init = [bytes([i & 0xFF]) for i in range(clear)] + [b"", b""]
    table, width, prev = list(init), min_size + 1, None
    out = bytearray()
    nbits, pos = 8 * len(stream), 0
    padded = stream + b"\0\0\0"
    while pos + width <= nbits:
        at = pos >> 3
        code = (int.from_bytes(padded[at:at + 3], "little")
                >> (pos & 7)) & ((1 << width) - 1)
        pos += width
        if code == clear + 1:
            break
        if code == clear:
            table, width, prev = list(init), min_size + 1, None
            continue
        if prev is None:
            if code >= clear:
                raise ValueError("GIF: LZW code past the table")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError("GIF: LZW code past the table")
            if len(table) < 4096:
                table.append(prev + entry[:1])
        out += entry
        if len(out) > npix:
            raise ValueError("GIF: more pixels than the image holds")
        prev = entry
        if len(table) == 1 << width and width < 12:
            width += 1
    if len(out) != npix:
        raise ValueError("GIF: fewer pixels than the image holds")
    return np.frombuffer(bytes(out), np.uint8)


def decode_gif(data: bytes, color: bool = False) -> np.ndarray:
    """GIF bytes -> the first image as (H, W, 3) uint8 RGB, or (H, W, 4)
    RGBA (module docstring)."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    s = _Stream(data, 6)
    sw, sh, flags, bg, _ = struct.unpack("<HHBBB", s.take(7))
    if not (sw > 0 and sh > 0):
        raise ValueError("GIF: empty logical screen")
    gct = s.table(flags)
    if gct is not None and bg >= len(gct):
        raise ValueError("GIF: background index past the global table")
    start = s.pos
    alpha = _walk(s) and not color
    check_size(sw, sh)
    s.pos = start
    transparent = None
    kind = s.byte()
    while kind == 0x21:
        label = s.byte()
        if label == 0xF9:
            if s.byte() != 4:
                raise ValueError("GIF: graphic control extension not 4 bytes")
            gce = s.take(4)
            transparent = gce[3] if gce[0] & 1 else None
        s.sub_blocks()
        kind = s.byte()
    if kind != 0x2C:
        raise ValueError("GIF without an image")
    left, top, w, h, iflags = struct.unpack("<HHHHB", s.take(9))
    if not (w > 0 and h > 0 and left + w <= sw and top + h <= sh):
        raise ValueError("GIF: image outside the logical screen")
    lct = s.table(iflags)
    min_size = s.byte()
    if not 2 <= min_size <= 11:
        raise ValueError("GIF: LZW minimum code size out of range")
    idx = _lzw(s.sub_blocks(), min_size, w * h).reshape(h, w)
    if iflags & 0x40:
        order = np.concatenate([np.arange(a, h, d) for a, d in
                                ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    if lct is None and gct is None:
        colours = _NO_TABLE
    else:
        colours = np.zeros((256, 3), np.uint8)
        known = np.zeros(256, bool)
        for t in (gct, lct):
            if t is not None:
                colours[:len(t)], known[:len(t)] = t, True
        shown = idx if transparent is None else idx[idx != transparent]
        if not known[shown].all():
            raise ValueError("GIF: an index past the colour tables")
    canvas = np.zeros((sh, sw, 4), np.uint8)
    if gct is not None:
        canvas[..., :3] = gct[bg]
    pix = np.concatenate([colours[idx], np.full((h, w, 1), 255, np.uint8)],
                         2)
    region = canvas[top:top + h, left:left + w]
    keep = (np.zeros((h, w), bool) if transparent is None
            else idx == transparent)
    region[~keep] = pix[~keep]
    return canvas if alpha else np.ascontiguousarray(canvas[..., :3])
