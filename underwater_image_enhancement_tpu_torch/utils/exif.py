"""EXIF orientation as ``cv2.imread(path)`` (``IMREAD_COLOR``) of cv2 5.0.0
reads and applies it, numpy only.  ``IMREAD_UNCHANGED`` applies none, so
only the training loader's reading (``io.imread_u8``) turns an image.

Where cv2 finds the tag:

- a JPEG's APP1 segments before its first scan that begin
  ``Exif\\0\\0``, in file order: the first whose IFD0 yields an
  Orientation entry decides;
- a PNG's first ``eXIf`` chunk that libpng keeps (its CRC right, at least
  2 bytes, beginning ``II`` or ``MM``; a later one is a duplicate), before
  or after the image data.

How OpenCV's ``ExifReader`` reads the TIFF structure: little-endian where
it begins ``II``, else big-endian; the magic 42 at byte 2; IFD0 at the
offset at byte 4; its entry count, then 12-byte entries in order.  The
first Orientation entry (tag 0x0112) gives the 16-bit value at its byte 8,
whatever its type and count say.  An entry it reads a value of and finds
past the data's end (a string, a rational) or a read past the end ends
the parse, keeping an Orientation entry met before.  Values 1-8 give the
transforms of ``TRANSFORMS``; any other value, or no entry, none.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

ORIENTATION = 0x0112
# the IFD0 tags whose values OpenCV's ExifReader reads (the others it
# skips): strings (the count, then the bytes at the offset where the count
# is over 4), rationals (so many 8-byte pairs at the offset), 16-bit and
# 32-bit values in the entry
_STRINGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298)
_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3,
              0x0214: 6}
_U16 = (0x0128, 0x0213)
_U32 = (0x8769,)


class _Past(Exception):
    """A read past the TIFF data's end: OpenCV's ExifParsingError."""


def orientation(tiff: bytes) -> Optional[int]:
    """The Orientation value of a TIFF structure's IFD0 as OpenCV's
    ``ExifReader`` reads it, or None where it finds none."""
    order = "<" if tiff[:2] == b"II" else ">"
    n = len(tiff)

    def u16(at):
        if at + 2 > n:
            raise _Past
        return struct.unpack_from(order + "H", tiff, at)[0]

    def u32(at):
        if at + 4 > n:
            raise _Past
        return struct.unpack_from(order + "I", tiff, at)[0]

    try:
        if u16(2) != 42:
            return None
        ifd = u32(4)
        for i in range(u16(ifd)):
            entry = ifd + 2 + 12 * i
            tag = u16(entry)
            if tag == ORIENTATION:
                return u16(entry + 8)
            if tag in _STRINGS:
                count = u32(entry + 4)
                start = u32(entry + 8) if count > 4 else 8
                if start + count > n:
                    raise _Past
            elif tag in _RATIONALS:
                u32(u32(entry + 8) + 8 * _RATIONALS[tag] - 4)
            elif tag in _U16:
                u16(entry + 8)
            elif tag in _U32:
                u32(entry + 8)
    except _Past:
        return None
    return None


def jpeg_orientation(data: bytes) -> Optional[int]:
    """The Orientation cv2 takes from a JPEG: that of the first APP1
    ``Exif\\0\\0`` segment before the first SOS whose IFD0 has one."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos + 3 > len(data):
            return None
        marker = data[pos]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 1
            continue
        if marker in (0xD9, 0xDA):
            return None
        (length,) = struct.unpack_from(">H", data, pos + 1)
        body = data[pos + 3:pos + 1 + length]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            found = orientation(body[6:])
            if found is not None:
                return found
        pos += 1 + length
    return None


def png_exif_valid(body: bytes) -> bool:
    """Whether libpng keeps an ``eXIf`` chunk whose CRC is right: at least
    2 bytes, beginning ``II`` or ``MM``."""
    return len(body) >= 2 and body[:1] in (b"I", b"M") and body[1] == body[0]


# cv2's ExifTransform (loadsave.cpp) of an (H, W, ...) array, by value
TRANSFORMS = {
    2: lambda a: a[:, ::-1],  # flip left-right
    3: lambda a: a[::-1, ::-1],  # rotate 180
    4: lambda a: a[::-1],  # flip top-bottom
    5: lambda a: a.swapaxes(0, 1),  # transpose
    6: lambda a: a.swapaxes(0, 1)[:, ::-1],  # rotate 90 clockwise
    7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],  # transverse
    8: lambda a: a.swapaxes(0, 1)[::-1],  # rotate 90 counter-clockwise
}


def apply(img: np.ndarray, value: Optional[int]) -> np.ndarray:
    """``img`` turned as cv2 turns it for the Orientation ``value`` (None
    or a value outside 2-8: unchanged), contiguous."""
    turn = TRANSFORMS.get(value)
    return np.ascontiguousarray(img if turn is None else turn(img))
