"""A TIFF encoder in numpy: the file ``cv2.imwrite`` writes for a colour
image through libtiff (LZW with the horizontal predictor, chunky RGB,
8 bits a sample).

The strips are libtiff's: ``_rows_per_strip`` rows each (cv2's 8 KiB
strips), each row differenced by the predictor (each sample less the one
three before it in the row, mod 256) and each strip coded alone by
``tif_lzw.c``'s encoder.  The directory follows the strips, as libtiff
writes it: twelve tags, then their out-of-line values in libtiff's order.
"""

from __future__ import annotations

import struct

import numpy as np

from underwater_image_enhancement_tpu_torch.utils.jpeg import pack_msb

_CLEAR, _EOI, _FIRST = 256, 257, 258
_CODE_MAX = (1 << 12) - 1
_CHECK_GAP = 10000
_SHORT, _LONG = 3, 4


def _rows_per_strip(width: int, height: int) -> int:
    """cv2's strip height: as many rows as fit in 8 KiB, at least 1, at
    most the image."""
    return max(1, min(height, (1 << 13) // (width * 3)))


def _ratio(incount: int, outcount: int) -> int:
    """tif_lzw.c CALCRATIO: input bytes over output bits, 24.8 fixed
    point."""
    if incount <= 0x7FFFFF:
        return (incount << 8) // outcount
    out = outcount >> 8
    return incount // out if out else 0x7FFFFFFF


def _lzw_encode(data: bytes) -> bytes:
    """One strip as libtiff's LZWEncode and LZWPostEncode code it: a clear
    code first; codes of 9 to 12 bits, one bit wider as soon as the next
    free code needs it; the table cleared when it reaches 4094 codes, or
    when the input-to-output ratio, checked every 10000 input bytes,
    stops improving; the last code, then EOI, then the bits padded to a
    byte."""
    codes, widths = [], []
    emit, width = codes.append, widths.append
    nbits, maxcode, free_ent = 9, 511, _FIRST
    incount = outcount = ratio = 0
    checkpoint = _CHECK_GAP
    table: dict = {}
    if data:
        emit(_CLEAR)
        width(nbits)
        outcount += nbits
        ent = data[0]
        incount = 1
        for c in data[1:]:
            incount += 1
            key = (c << 12) | ent
            code = table.get(key)
            if code is not None:
                ent = code
                continue
            emit(ent)
            width(nbits)
            outcount += nbits
            ent = c
            table[key] = free_ent
            free_ent += 1
            if free_ent == _CODE_MAX - 1:  # the table is full
                clear = True
            elif free_ent > maxcode:
                nbits += 1
                maxcode = (1 << nbits) - 1
                clear = False
            elif incount >= checkpoint:
                checkpoint = incount + _CHECK_GAP
                rat = _ratio(incount, outcount)
                clear = rat <= ratio
                if not clear:
                    ratio = rat
            else:
                clear = False
            if clear:
                table.clear()
                ratio = incount = outcount = 0
                free_ent = _FIRST
                emit(_CLEAR)
                width(nbits)
                nbits, maxcode = 9, 511
        emit(ent)
        width(nbits)
        free_ent += 1
        if free_ent == _CODE_MAX - 1:
            emit(_CLEAR)
            width(nbits)
            nbits = 9
        elif free_ent > maxcode:
            nbits += 1
    emit(_EOI)
    width(nbits)
    body, (tail, rest) = pack_msb(np.asarray(codes), np.asarray(widths))
    return body + (bytes([(tail << (8 - rest)) & 255]) if rest else b"")


def _entry(tag: int, kind: int, values, at: int):
    """(IFD entry, out-of-line bytes or b""): values of up to 4 bytes sit
    in the entry, longer ones at ``at``."""
    fmt = "<%d%s" % (len(values), "H" if kind == _SHORT else "I")
    raw = struct.pack(fmt, *values)
    if len(raw) <= 4:
        return (struct.pack("<HHI", tag, kind, len(values))
                + raw.ljust(4, b"\0"), b"")
    return struct.pack("<HHII", tag, kind, len(values), at), raw


def encode_tiff(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the little-endian TIFF ``cv2.imwrite``
    writes for the BGR image: tags 256/257 (size), 258 (8, 8, 8), 259 = 5
    (LZW), 262 = 2 (RGB), 273/279 (strip offsets and byte counts), 277 =
    3, 278 (rows per strip), 284 = 1 (chunky), 317 = 2 (horizontal
    predictor), 339 (1, 1, 1: unsigned).  The byte counts are SHORTs
    where libtiff writes them so: more than one strip, each under 6553
    bytes before coding."""
    a = np.asarray(rgb)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"cannot encode an array of {a.dtype} and shape "
                         f"{a.shape} as TIFF: (H, W, 3) uint8 RGB")
    H, W = a.shape[:2]
    rps = _rows_per_strip(W, H)
    rows = np.ascontiguousarray(a).reshape(H, W * 3)
    diff = rows.copy()
    diff[:, 3:] = rows[:, 3:] - rows[:, :-3]  # uint8: mod 256
    strips = [_lzw_encode(diff[s:s + rps].tobytes())
              for s in range(0, H, rps)]
    offsets = np.cumsum([8] + [len(s) for s in strips])[:-1].tolist()
    counts = [len(s) for s in strips]
    end = offsets[-1] + counts[-1]
    ifd = end + (end & 1)
    count_kind = (_SHORT if len(strips) > 1 and rps * W * 3 < 0xFFFF // 10
                  else _LONG)

    def short_long(v):
        return (_SHORT if v <= 0xFFFF else _LONG, [v])

    tags = {256: short_long(W), 257: short_long(H),
            258: (_SHORT, [8, 8, 8]), 259: (_SHORT, [5]),
            262: (_SHORT, [2]), 273: (_LONG, offsets), 277: (_SHORT, [3]),
            278: short_long(rps), 279: (count_kind, counts),
            284: (_SHORT, [1]), 317: (_SHORT, [2]),
            339: (_SHORT, [1, 1, 1])}
    at = ifd + 2 + 12 * len(tags) + 4
    entries, extra = {}, []
    for tag in (258, 279, 273, 339):  # libtiff's order for the values
        entries[tag], raw = _entry(tag, *tags[tag], at)
        extra.append(raw)
        at += len(raw)
    for tag in tags:
        if tag not in entries:
            entries[tag], _ = _entry(tag, *tags[tag], 0)
    return b"".join(
        [b"II*\x00", struct.pack("<I", ifd)] + strips + [b"\0" * (ifd - end),
         struct.pack("<H", len(tags))]
        + [entries[t] for t in sorted(entries)] + [b"\0\0\0\0"] + extra)
