"""A TIFF codec in numpy.  ``encode_tiff`` writes the file ``cv2.imwrite``
writes for a colour image through libtiff (LZW with the horizontal
predictor, chunky RGB, 8 or 16 bits a sample); ``decode_tiff`` reads the
files ``cv2.imread`` reads, with cv2's pixels.

The strips are libtiff's: ``_rows_per_strip`` rows each (cv2's 8 KiB
strips), each row differenced by the predictor (each sample less the one
three before it in the row, mod 2**bits, written little-endian) and each
strip coded alone by ``tif_lzw.c``'s encoder.  The directory follows the
strips, as libtiff writes it: twelve tags, then their out-of-line values
in libtiff's order.

The decoder takes the first directory (the first page, as ``cv2.imread``
returns it) of a little- or big-endian classic TIFF or BigTIFF: 1, 4
(palette), 8, 10, 12, 14, 16, 32 or 64 bits a sample, unsigned, signed
or float (32 and 64 bits); gray, WhiteIsZero, RGB with or without an
extra sample, gray with extra samples, palette (16-bit or 8-bit
colormaps; 8-bit chunky with extra samples; without a colormap of 3 *
2**bits values, from 8 bits, gray as libtiff takes it), CMYK, JPEG YCbCr,
uncompressed YCbCr at every subsampling libtiff's RGBA reader takes,
CIELab (``tiff_color.py``), LogL and LogLuv (``sgilog.py``); chunky or
planar, in strips or tiles (cropped at the image's edges); stored
uncompressed, PackBits, Deflate (8 and 32946, through ``zlib``), LZW
(``tif_lzw.c``'s codes, and the old style's LSB-first ones), JPEG (each
strip or tile a JPEG of 8-bit samples after the JPEGTables tag,
``jpeg.decode_jpeg_chunk``, its components as they are but YCbCr's in
chunky files, whatever the photometric interpretation), CCITT RLE, RLEW,
Group 3 and Group 4 (``fax3.py``), SGILog and SGILog24 (``sgilog.py``),
ThunderScan (4-bit palette strips, ``_thunder_decode``; tiles read as
zeros, as libtiff has no tile decoder for it), or of a compression
libtiff does not know (JPEG 2000 among them: zero samples, as libtiff's
RGBA reader gives them); fill order 1 or 2; LZW and Deflate with the
horizontal predictor, or the floating-point one on floats; orientations
1-4; without StripByteCounts (or with a single strip's count libtiff
doubts) the counts estimated as libtiff estimates them; a strip that
decodes short zero-filled as libtiff's RGBA reader reads it.  cv2's two
paths and libtiff's RGBA reader are ``decode_tiff``'s, with cv2's array
type.  What cv2 refuses (2-bit and 24-bit samples, 16-bit floats, 16-bit
palette and CMYK, orientations 5-8, old-style JPEG, 12-bit JPEG, LZMA,
ZSTD, WebP, JBIG, LERC, PixarLog, NeXT, CCITT of other than one 1-bit
sample, ThunderScan of other than 4 bits, SGILog of other photometric
interpretations, LogL in SGILog24, ICCLab, ITULab, transparency masks,
no photometric interpretation, predictors other than 1-3 and predictor 3
on integers, JPEG without its tables, no StripByteCounts and more than
one strip a plane, a strip of no bytes or past the file's end, ...)
raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from underwater_image_enhancement_tpu_torch.utils import (
    exif,
    fax3,
    sgilog,
    tiff_color,
)
from underwater_image_enhancement_tpu_torch.utils.bmp import opencv_gray
from underwater_image_enhancement_tpu_torch.utils.jpeg import (
    decode_jpeg_chunk,
    pack_msb,
)

_CLEAR, _EOI, _FIRST = 256, 257, 258
_CODE_MAX = (1 << 12) - 1
_CHECK_GAP = 10000
_SHORT, _LONG = 3, 4


def _rows_per_strip(row_bytes: int, height: int) -> int:
    """cv2's strip height: as many rows as fit in 8 KiB, at least 1, at
    most the image."""
    return max(1, min(height, (1 << 13) // row_bytes))


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
    """(H, W, 3) uint8 or uint16 RGB -> the little-endian TIFF
    ``cv2.imwrite`` writes for the BGR image: tags 256/257 (size), 258 (8
    or 16 a sample), 259 = 5 (LZW), 262 = 2 (RGB), 273/279 (strip offsets
    and byte counts), 277 = 3, 278 (rows per strip), 284 = 1 (chunky),
    317 = 2 (horizontal predictor, on the samples' values), 339 (1, 1, 1:
    unsigned).  The byte counts are SHORTs where libtiff writes them so:
    more than one strip, each under 6553 bytes before coding."""
    a = np.asarray(rgb)
    if (a.dtype not in (np.uint8, np.uint16) or a.ndim != 3
            or a.shape[2] != 3):
        raise ValueError(f"cannot encode an array of {a.dtype} and shape "
                         f"{a.shape} as TIFF: (H, W, 3) uint8 RGB or "
                         "uint16 RGB")
    H, W = a.shape[:2]
    row_bytes = W * 3 * a.dtype.itemsize
    rps = _rows_per_strip(row_bytes, H)
    rows = np.ascontiguousarray(a).reshape(H, W * 3)
    diff = rows.copy()
    diff[:, 3:] = rows[:, 3:] - rows[:, :-3]  # mod 2**bits
    diff = diff.astype(a.dtype.newbyteorder("<"))
    strips = [_lzw_encode(diff[s:s + rps].tobytes())
              for s in range(0, H, rps)]
    offsets = np.cumsum([8] + [len(s) for s in strips])[:-1].tolist()
    counts = [len(s) for s in strips]
    end = offsets[-1] + counts[-1]
    ifd = end + (end & 1)
    count_kind = (_SHORT if len(strips) > 1 and rps * row_bytes < 0xFFFF // 10
                  else _LONG)

    def short_long(v):
        return (_SHORT if v <= 0xFFFF else _LONG, [v])

    tags = {256: short_long(W), 257: short_long(H),
            258: (_SHORT, [8 * a.dtype.itemsize] * 3), 259: (_SHORT, [5]),
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


# struct formats of the integer TIFF field types (BYTE, SHORT, LONG,
# SBYTE, SSHORT, SLONG, IFD, and BigTIFF's LONG8, SLONG8, IFD8); the real
# types (RATIONAL, SRATIONAL, FLOAT, DOUBLE) by their sizes; UNDEFINED
# values are kept as bytes, tags of other types are not read
_INT_FORMAT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I",
               16: "Q", 17: "q", 18: "Q"}
_REAL_SIZE = {5: 8, 10: 8, 11: 4, 12: 8}
_UNDEFINED = 7
_LOGL, _LOGLUV = 32844, 32845
_FAX = (fax3.RLE, fax3.G3, fax3.G4, fax3.RLEW)
# what cv2's libtiff refuses: cv2 gives None
_REFUSED_PHOTOMETRIC = {4: "transparency mask", 9: "ICCLab", 10: "ITULab"}
_REFUSED_COMPRESSIONS = {6: "old-style JPEG", 32766: "NeXT",
                         32909: "PixarLog",
                         34661: "JBIG", 34887: "LERC", 34925: "LZMA",
                         50000: "ZSTD", 50001: "WebP"}
_SGILOG = (sgilog.SGILOG, sgilog.SGILOG24)
_THUNDERSCAN = 32809
_NONE, _LZW, _JPEG, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS = (
    1, 5, 7, 32946, 8, 32773)
_READ_COMPRESSIONS = (_NONE, _LZW, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS,
                      _JPEG, _THUNDERSCAN) + _FAX + _SGILOG
_MINISWHITE, _MINISBLACK, _RGB, _PALETTE, _CMYK, _YCBCR, _CIELAB = (
    0, 1, 2, 3, 5, 6, 8)
# SampleFormat -> numpy kind
_KINDS = {1: "u", 2: "i", 3: "f"}
# libtiff's RGBA reader reads these sample sizes
_RGBA_BITS = (1, 2, 4, 8, 16)
# OpenCV's icvCvt_BGRA2Gray_16u_CnC1R: 14-bit fixed-point gray weights of
# the first three samples (after its swap of red and blue)
_GRAY16_WEIGHTS = (4899, 9617, 1868)


def _reals(order: str, kind: int, count: int, raw: bytes) -> tuple:
    """RATIONAL, SRATIONAL, FLOAT or DOUBLE values as libtiff's
    ``TIFFReadDirEntryFloatArray`` gives them: float32, a fraction as
    ``(float)n / (float)d`` (0 where d is 0)."""
    if kind in (5, 10):
        v = np.frombuffer(raw, order + ("u4" if kind == 5 else "i4")).reshape(
            count, 2).astype(np.float32)
        den = np.where(v[:, 1] == 0, np.float32(1), v[:, 1])
        out = np.where(v[:, 1] == 0, np.float32(0), v[:, 0] / den)
    else:
        out = np.frombuffer(raw, order + ("f4" if kind == 11 else "f8"))
    return tuple(out.astype(np.float32).tolist())


def _entries(data: bytes):
    """The first directory of a classic TIFF (version 42) or a BigTIFF
    (version 43: 8-byte offsets, entry counts and value counts, 20-byte
    entries holding up to 8 bytes of values) -> (byte order, bytes of
    values an entry holds, struct format of an offset, [(tag, type, count,
    value field)])."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None:
        raise ValueError("not a TIFF file")
    (version,) = struct.unpack(order + "H", data[2:4])
    if version == 43:
        if struct.unpack(order + "HH", data[4:8]) != (8, 0):
            raise ValueError("corrupt BigTIFF: offsets not of 8 bytes")
        (at,) = struct.unpack(order + "Q", data[8:16])
        word, entry, inline = "Q", 20, 8
        (n,) = struct.unpack(order + "Q", data[at:at + 8])
        at += 8
    elif version == 42:
        (at,) = struct.unpack(order + "I", data[4:8])
        word, entry, inline = "I", 12, 4
        (n,) = struct.unpack(order + "H", data[at:at + 2])
        at += 2
    else:
        raise ValueError(f"not a TIFF file (version {version})")
    out = []
    for k in range(n):
        e = data[at + entry * k:at + entry * (k + 1)]
        tag, kind, count = struct.unpack(order + "HH" + word,
                                         e[:entry - inline])
        out.append((tag, kind, count, e[entry - inline:]))
    return order, inline, word, out


def _directory(data: bytes) -> dict:
    """The first directory's tags (``_entries``): tag -> tuple of values
    (integers; float32 for the real types) or bytes (UNDEFINED)."""
    order, inline, word, entries = _entries(data)
    tags = {}
    for tag, kind, count, field in entries:
        if kind in _INT_FORMAT:
            size = struct.calcsize(_INT_FORMAT[kind]) * count
        elif kind in _REAL_SIZE:
            size = _REAL_SIZE[kind] * count
        elif kind == _UNDEFINED:
            size = count
        else:
            continue
        if count == 0:
            continue
        if size <= inline:
            raw = field[:size]
        else:
            (off,) = struct.unpack(order + word, field)
            raw = data[off:off + size]
        if len(raw) != size:
            raise ValueError(f"corrupt TIFF: tag {tag} past the file's end")
        if kind == _UNDEFINED:
            tags[tag] = bytes(raw)
        elif kind in _REAL_SIZE:
            tags[tag] = _reals(order, kind, count, raw)
        else:
            tags[tag] = struct.unpack(f"{order}{count}{_INT_FORMAT[kind]}",
                                      raw)
    return tags


# libtiff's TIFFDataWidth: the bytes of a value of each field type
_TYPE_WIDTH = {1: 1, 2: 1, 6: 1, 7: 1, 3: 2, 8: 2, 4: 4, 9: 4, 11: 4, 13: 4,
               5: 8, 10: 8, 12: 8, 16: 8, 17: 8, 18: 8}


def _directory_bytes(data: bytes) -> int:
    """The bytes that ``EstimateStripByteCounts`` (tif_dirread.c) counts as
    not image data: the header, the first directory and the values its
    entries hold out of line; ValueError for an entry of a type libtiff
    has no width for."""
    _, inline, _, entries = _entries(data)
    big = inline == 8
    space = (16 + 8 + 20 * len(entries) + 8 if big
             else 8 + 2 + 12 * len(entries) + 4)
    for tag, kind, count, _ in entries:
        if kind not in _TYPE_WIDTH:
            raise ValueError(f"TIFF without StripByteCounts, tag {tag} of "
                             f"unknown type {kind}")
        size = _TYPE_WIDTH[kind] * count
        space += size if size > inline else 0
    return space


def _lzw_decode(data: bytes, size: int) -> bytes:
    """A strip or tile coded by ``tif_lzw.c``, the first ``size`` bytes:
    MSB-first codes of 9 to 12 bits, one bit wider once the table holds the
    width's last code but one (``LZWDecode``); or, where the data begins
    0x00 and an odd byte (a clear code read least significant bit first),
    the old style's LSB-first codes, one bit wider once the table holds
    the width's last code (``LZWDecodeCompat``)."""
    old = len(data) >= 2 and data[0] == 0 and data[1] & 1
    grow = 0 if old else 1
    out, have = [], 0
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, prev = 9, None
    acc = nacc = 0
    pos, end = 0, len(data)
    while have < size:
        while nacc < nbits and pos < end:
            if old:
                acc |= data[pos] << nacc
            else:
                acc = (acc << 8) | data[pos]
            pos += 1
            nacc += 8
        if nacc < nbits:
            break  # no EOI: libtiff keeps what the strip gave
        nacc -= nbits
        if old:
            code = acc & ((1 << nbits) - 1)
            acc >>= nbits
        else:
            code = (acc >> nacc) & ((1 << nbits) - 1)
            acc &= (1 << nacc) - 1
        if code == _CLEAR:
            del table[_FIRST:]
            nbits, prev = 9, None
            continue
        if code == _EOI:
            break
        if prev is None:
            if code >= 256:
                raise ValueError("corrupt LZW: a first code past the "
                                 "literals")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError(f"corrupt LZW: code {code} past the table "
                                 f"({len(table)})")
            if len(table) >= (1 << nbits) - grow and nbits < 12:
                nbits += 1
        out.append(entry)
        have += len(entry)
        prev = entry
    return b"".join(out)[:size]


def _packbits_decode(data: bytes, size: int) -> bytes:
    """PackBits: a header n, then n + 1 literal bytes (n < 128) or one byte
    repeated 257 - n times (n > 128); 128 is skipped.  Where the data ends
    inside a run, what came before it."""
    out, have, pos = [], 0, 0
    while have < size and pos < len(data):
        n = data[pos]
        pos += 1
        if n < 128:
            if pos + n + 1 > len(data):
                break  # libtiff copies no literal run cut short
            chunk = data[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            chunk = data[pos:pos + 1] * (257 - n)
            pos += 1
        else:
            continue
        out.append(chunk)
        have += len(chunk)
    return b"".join(out)[:size]


# each byte value with its bits reversed: FillOrder 2
_REVERSED = np.array([int(f"{v:08b}"[::-1], 2) for v in range(256)],
                     np.uint8)


# ThunderScan's 2- and 3-bit deltas; 2 and 4 mark a skipped pixel
_DELTA2 = (0, 1, 0, -1)
_DELTA3 = (0, 1, 2, 3, 0, -3, -2, -1)


def _thunder_decode(data: bytes, rows: int, width: int) -> bytes:
    """4-bit ThunderScan rows as libtiff's ``ThunderDecode`` decodes them,
    each from its own last pixel 0: a byte's top two bits choose a run of
    the last pixel (its low six bits long; one that would pass the row's
    end writes nothing), three 2-bit or two 3-bit deltas from it, or a raw
    pixel.  A row that does not end at its width is zeroed from where it
    stopped, and ends the strip."""
    row_bytes = (width + 1) // 2
    out = bytearray(rows * row_bytes)
    pos, end = 0, len(data)
    for r in range(rows):
        op = r * row_bytes
        last = npix = 0
        while pos < end and npix < width:
            n = data[pos]
            pos += 1
            kind = n & 0xC0
            if kind == 0:  # a run
                if npix & 1:
                    out[op] |= last
                    last = out[op]
                    op += 1
                    npix += 1
                    n -= 1
                else:
                    last |= last << 4
                npix += n
                if npix <= width:
                    while n > 0:
                        out[op] = last
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    out[op] &= 0xF0
                last &= 0xF
                continue
            if kind == 0x40:
                steps = [_DELTA2[d] for d in ((n >> 4) & 3, (n >> 2) & 3,
                                               n & 3) if d != 2]
            elif kind == 0x80:
                steps = [_DELTA3[d] for d in ((n >> 3) & 7, n & 7) if d != 4]
            else:
                steps = [n - last]  # a raw pixel
            for step in steps:
                # SETPIXEL: each delta from the pixel before
                last = (last + step) & 0xF
                if npix < width:
                    if npix & 1:
                        out[op] |= last
                        op += 1
                    else:
                        out[op] = last << 4
                    npix += 1
        if npix != width:
            out[op:r * row_bytes + row_bytes] = bytes(
                max(0, r * row_bytes + row_bytes - op))
            break
    return bytes(out)


def _decode_chunk(data: bytes, compression: int, size: int) -> bytes:
    if compression == _NONE:
        return data[:size]
    if compression == _LZW:
        return _lzw_decode(data, size)
    if compression == _PACKBITS:
        return _packbits_decode(data, size)
    return zlib.decompressobj().decompress(data, size)


class _Layout:
    """What a directory's tags say: the image's size, samples, photometric
    interpretation, coding and chunks, the array type cv2 gives, and which
    of cv2's two reading paths takes it."""

    def __init__(self, tags: dict, color: bool):
        self.tags = tags
        try:
            self.W, self.H = tags[256][0], tags[257][0]
        except KeyError:
            raise ValueError("corrupt TIFF: no image size") from None
        if self.W <= 0 or self.H <= 0:
            raise ValueError("corrupt TIFF: empty image")
        if self.W > 1 << 20 or self.H > 1 << 20 or self.W * self.H > 1 << 30:
            raise ValueError("TIFF past cv2's image size limits")
        bits = tags.get(258, (1,))
        self.spp = tags.get(277, (1,))[0]
        if len(set(bits)) != 1:
            # libtiff: "Cannot handle different values per sample"
            raise ValueError("TIFF with different bits a sample")
        self.bits = bits[0]
        fmt = set(tags.get(339, (1,)))
        if len(fmt) != 1:
            raise ValueError("TIFF with different sample formats")
        self.fmt = fmt.pop()
        self.photometric = tags.get(262, (None,))[0]
        # TIFFReadDirectory: a Colormap of another count is ignored, and a
        # palette file of 8 bits and up without one is read as RGB (3
        # samples; the two past the first already counted as extra, which
        # the RGBA reader refuses) or gray
        self.palette_as_rgb = False
        if (self.photometric == _PALETTE and self.bits >= 8
                and len(tags.get(320, ())) != 3 << self.bits):
            self.palette_as_rgb = self.spp == 3
            self.photometric = _RGB if self.spp == 3 else _MINISBLACK
        self.compression = tags.get(259, (_NONE,))[0]
        self.planar = tags.get(284, (1,))[0] if self.spp > 1 else 1
        extra = tags.get(338, ())
        # libtiff's RGBA reader: an unspecified extra sample of a pixel of
        # over 3 samples counts as an associated alpha
        self.alpha = extra[0] if extra and extra[0] in (1, 2) else (
            1 if extra and self.spp > 3 else 0)
        self.orientation = tags.get(274, (1,))[0]
        self.fill_order = tags.get(266, (1,))[0]
        self.predictor = tags.get(317, (1,))[0]
        if self.compression not in (_LZW, _DEFLATE, _ADOBE_DEFLATE):
            self.predictor = 1  # libtiff's predictor goes with these
        self.subsampling = (tuple(tags.get(530, (2, 2))[:2])
                            if self.photometric == _YCBCR else (1, 1))
        # OpenCV's readHeader: past 8 bits only gray and RGB of 1, 3 or 4
        # samples keep their depth; the rest is read as 8 bits a channel
        self.depth = self.bits
        if self.bits > 8 and (self.photometric is None
                              or self.photometric > _RGB
                              or self.spp not in (1, 3, 4)):
            self.depth = 8
        self.check(color)
        # cv2 reads a file of over 8 bits in IMREAD_UNCHANGED itself (its
        # 16-, 32- and 64-bit cases), every other through libtiff's RGBA
        # reader, 8 bits a channel
        self.raw = self.depth > 8 and not color
        # a compression libtiff does not know decodes nothing; the RGBA
        # reader goes on with its zeroed buffer
        self.zeros = self.compression not in _READ_COMPRESSIONS
        size = 1 if self.depth <= 8 else 2 if self.depth <= 16 else (
            self.depth // 8)
        self.dtype = (np.dtype(np.float32) if self.photometric == _LOGLUV
                      else np.dtype(f"{_KINDS[self.fmt]}{size}"))

    def check(self, color: bool) -> None:
        """ValueError where cv2 gives None."""
        bits, spp, ph, fmt = self.bits, self.spp, self.photometric, self.fmt
        if ph == _LOGLUV and self.compression in _SGILOG:
            self.check_logluv(color)
            return
        # OpenCV's readHeader: 1, 8, 10, 12, 14, 16, 32 or 64 bits, 4 for a
        # palette; unsigned or signed up to 16 bits, float from 32
        if bits not in (1, 8, 10, 12, 14, 16, 32, 64) and not (
                bits == 4 and ph == _PALETTE):
            raise ValueError(f"{bits}-bit TIFF, which cv2 does not read")
        if fmt not in _KINDS or (fmt == 3 and self.depth <= 16):
            raise ValueError(f"TIFF of SampleFormat {fmt} at {self.depth} "
                             "bits, which cv2 does not read")
        if (color or self.depth <= 8) and bits not in _RGBA_BITS:
            raise ValueError(f"{bits}-bit TIFF, which libtiff's RGBA reader "
                             "(IMREAD_COLOR) refuses")
        if not 1 <= spp <= 4:
            raise ValueError(f"TIFF of {spp} samples a pixel, which cv2 "
                             "does not read")
        if ph is None:
            # OpenCV's readHeader fails on TIFFGetField of tag 262
            raise ValueError("TIFF without a photometric interpretation, "
                             "which cv2 does not read")
        if ph in _REFUSED_PHOTOMETRIC:
            raise ValueError(f"{_REFUSED_PHOTOMETRIC[ph]} TIFF, which "
                             "cv2 does not read")
        if ph in (_LOGL, _LOGLUV) and self.compression not in _SGILOG:
            raise ValueError("LogL or LogLuv TIFF without SGILog "
                             "compression, which cv2 does not read")
        if self.compression in _REFUSED_COMPRESSIONS:
            raise ValueError(f"{_REFUSED_COMPRESSIONS[self.compression]} "
                             "TIFF, which cv2 does not read")
        if self.compression in _FAX and (bits != 1 or spp != 1):
            # libtiff's Fax3SetupState: "Bits/sample must be 1", and the
            # RGBA reader fails on more than one sample
            raise ValueError(f"CCITT TIFF of {spp} {bits}-bit samples, "
                             "which cv2 does not read")
        if self.compression == _THUNDERSCAN and bits != 4:
            # ThunderSetupDecode: "only supports 4bits per sample"
            raise ValueError(f"ThunderScan TIFF of {bits}-bit samples, "
                             "which cv2 does not read")
        if self.compression in _SGILOG:
            sgilog.check(self.compression, ph, spp, self.planar, color)
        if self.compression not in _READ_COMPRESSIONS and self.depth > 8 \
                and not color:
            # libtiff decodes none of its strips and cv2 stops
            raise ValueError(f"compression {self.compression} TIFF of "
                             f"{bits}-bit samples, which cv2 does not read")
        if self.compression == _JPEG and bits != 8:
            # libtiff's JPEG codec: "Unsupported JPEG data precision"
            raise ValueError(f"JPEG TIFF of {bits}-bit samples, which cv2 "
                             "does not read")
        if self.predictor == 3 and fmt != 3:
            raise ValueError("TIFF of predictor 3 on integer samples, which "
                             "cv2 does not read")
        if self.predictor not in (1, 2, 3):
            # libtiff's PredictorSetup: "not supported"
            raise ValueError(f"TIFF of predictor {self.predictor}, which "
                             "libtiff does not read")
        if self.predictor == 2 and bits not in (8, 16, 32, 64):
            raise ValueError(f"TIFF of predictor 2 on {bits}-bit samples, "
                             "which libtiff does not read")
        if 5 <= self.orientation <= 8:
            # cv2 turns the image into a new array and imread refuses it
            raise ValueError(f"TIFF of orientation {self.orientation}, "
                             "which cv2 does not read")
        if ph in (_MINISWHITE, _MINISBLACK, _LOGL, _LOGLUV):
            return
        if ph == _RGB:
            if spp not in (3, 4) or bits == 1:
                raise ValueError(f"{bits}-bit RGB TIFF of {spp} samples, "
                                 "which cv2 does not read")
            if self.palette_as_rgb and (color or self.depth <= 8):
                raise ValueError("palette TIFF of 3 samples without its "
                                 "colormap, which libtiff's RGBA reader "
                                 "does not read")
        elif ph == _PALETTE:
            # TIFFRGBAImageOK: extra samples only in chunky files of 8 bits
            # and up (libtiff counts every sample past the first as extra
            # where tag 338 says fewer)
            if spp > 1 and (self.planar == 2 or bits < 8):
                raise ValueError(f"{bits}-bit palette TIFF of {spp} samples "
                                 f"(planar configuration {self.planar}), "
                                 "which libtiff's RGBA reader does not read")
            if bits == 16:
                raise ValueError("16-bit palette TIFF, which cv2 does not "
                                 "read")
            if len(self.tags.get(320, ())) != 3 << bits:
                raise ValueError("palette TIFF without its colormap")
        elif ph == _CMYK:
            if bits != 8 or spp != 4:
                raise ValueError(f"{bits}-bit CMYK TIFF of {spp} samples, "
                                 "which cv2 does not read")
        elif ph == _YCBCR:
            if self.compression != _JPEG or self.planar == 2:
                self.check_ycbcr()
        elif ph == _CIELAB:
            # TIFFRGBAImageOK, and no put routine for planar CIELab
            if spp != 3 or bits not in (8, 16) or self.planar != 1:
                raise ValueError(f"{bits}-bit CIELab TIFF of {spp} samples "
                                 f"(planar configuration {self.planar}), "
                                 "which libtiff's RGBA reader does not read")
        else:
            raise ValueError(f"TIFF of photometric interpretation {ph}, "
                             "which cv2 does not read")

    def check_logluv(self, color: bool) -> None:
        """LogLuv, which OpenCV's readHeader takes before it looks at the
        samples' size or format: libtiff's LogLuv codec and, in
        IMREAD_COLOR, ``TIFFRGBAImageOK``."""
        sgilog.check(self.compression, self.photometric, self.spp,
                     self.planar, color)
        if color and (self.bits not in _RGBA_BITS or self.fmt == 3
                      or len(self.tags.get(338, ())) != 0):
            raise ValueError(f"LogLuv TIFF of {self.bits}-bit samples of "
                             f"SampleFormat {self.fmt} (extra samples "
                             f"{self.tags.get(338, ())}), which libtiff's "
                             "RGBA reader (IMREAD_COLOR) refuses")
        if 5 <= self.orientation <= 8:
            raise ValueError(f"TIFF of orientation {self.orientation}, "
                             "which cv2 does not read")

    def check_ycbcr(self) -> None:
        """Uncompressed YCbCr as libtiff's RGBA reader takes it: 8-bit,
        three samples, a put routine for the subsampling (chunky: 4x4, 4x2,
        4x1, 2x2, 2x1, 1x2, 1x1; planar: 1x1)."""
        hs, vs = self.subsampling
        if self.bits != 8 or self.spp != 3:
            raise ValueError(f"{self.bits}-bit YCbCr TIFF of {self.spp} "
                             "samples, which libtiff's RGBA reader does not "
                             "read")
        if hs not in (1, 2, 4) or vs not in (1, 2, 4) or vs > hs and (
                hs, vs) != (1, 2) or (self.planar == 2 and (hs, vs) != (1, 1)):
            raise ValueError(f"YCbCr TIFF of subsampling {hs}x{vs} "
                             f"(planar configuration {self.planar}), which "
                             "libtiff's RGBA reader does not read")

    def chunks(self, data: bytes):
        """(tile width, tile height, tiled, offsets, byte counts); the
        counts estimated where the file has none, or one strip whose count
        libtiff's ``ByteCountLooksBad`` doubts (``_estimated_counts``)."""
        tags = self.tags
        if 322 in tags:
            tw, th = tags[322][0], tags.get(323, (0,))[0]
            offsets, counts = tags.get(324), tags.get(325)
        else:  # strips: full-width tiles of RowsPerStrip rows
            tw, th = self.W, min(tags.get(278, (self.H,))[0], self.H)
            offsets, counts = tags.get(273), tags.get(279)
        if offsets is None:
            raise ValueError("corrupt TIFF: no strip or tile offsets")
        if tw <= 0 or th <= 0:
            raise ValueError("corrupt TIFF: empty strips or tiles")
        n = -(-self.W // tw) * -(-self.H // th) * (
            self.spp if self.planar == 2 else 1)
        if len(offsets) < n:
            raise ValueError("corrupt TIFF: too few strips or tiles")
        if counts is None or (n == 1 and 322 not in tags
                              and _count_looks_bad(data, self, offsets[0],
                                                   counts[0], tw, th)):
            counts = _estimated_counts(data, self, n, offsets[:n], tw, th)
        if len(counts) < n:
            raise ValueError("corrupt TIFF: too few strips or tiles")
        return tw, th, 322 in tags, offsets, counts


def _row_bytes(width: int, samples: int, bits: int) -> int:
    return -(-width * samples * bits // 8)


def _unpack(raw: bytes, rows: int, tw: int, n: int, bits: int,
            dtype) -> np.ndarray:
    """A chunk's bytes -> (rows, tw, n) sample values; below 8 bits and at
    10, 12 and 14 each row is packed most significant bit first and padded
    to a byte.  10-, 12- and 14-bit values come shifted to 16 bits, as
    OpenCV's ``_unpack10To16`` and its kin give them."""
    if bits in (10, 12, 14):
        row, per = _row_bytes(tw, n, bits), bits // 2  # 4 samples a packet
        k = -(-tw * n // 4)
        packed = np.zeros((rows, k * per), np.uint64)
        packed[:, :row] = np.frombuffer(raw, np.uint8).reshape(rows, row)
        word = np.bitwise_or.reduce(packed.reshape(rows, k, per) << (
            8 * np.arange(per - 1, -1, -1, dtype=np.uint64)), axis=2)
        v = (word[..., None] >> (bits * np.arange(3, -1, -1,
                                                  dtype=np.uint64)))
        v = (v & np.uint64((1 << bits) - 1)) << np.uint64(16 - bits)
        return v.reshape(rows, -1)[:, :tw * n].astype(np.uint16).reshape(
            rows, tw, n)
    if bits >= 8:
        return np.frombuffer(raw, dtype).reshape(rows, tw, n)
    per = 8 // bits
    packed = np.frombuffer(raw, np.uint8).reshape(rows, -1)
    shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
    values = (packed[..., None] >> shifts) & ((1 << bits) - 1)
    return values.reshape(rows, -1)[:, :tw * n].reshape(rows, tw, n)


def _fp_unpredict(raw: bytes, rows: int, tw: int, n: int,
                  size: int) -> np.ndarray:
    """libtiff's floating-point predictor undone (``fpAcc``): in each row
    every byte summed with the one ``n`` (the samples of a pixel) before
    it, mod 256, then the row's byte planes (most significant first)
    regathered into samples -> (rows, tw, n) big-endian unsigned words."""
    a = np.frombuffer(raw, np.uint8).reshape(rows, tw * size, n)
    a = np.cumsum(a, axis=1, dtype=np.uint8).reshape(rows, size, tw * n)
    return np.ascontiguousarray(a.transpose(0, 2, 1)).view(
        f">u{size}").reshape(rows, tw, n)


def _ycbcr_chunk(raw: bytes, rows: int, tw: int, hs: int,
                 vs: int) -> np.ndarray:
    """An uncompressed YCbCr chunk of ``hs`` x ``vs`` subsampling -> (rows,
    tw, 3) Y, Cb, Cr: block rows of ceil(tw / hs) blocks, each its hs * vs
    lumas in rows then Cb and Cr, every pixel of a block with its
    chroma; blocks cut at the chunk's edge keep their pixels inside, as
    libtiff's ``putcontig8bitYCbCr*tile`` routines take them."""
    bw, bh = -(-tw // hs), -(-rows // vs)
    blk = np.frombuffer(raw, np.uint8)[:bw * bh * (hs * vs + 2)].reshape(
        bh, bw, hs * vs + 2)
    y = blk[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(0, 2, 1, 3)
    out = np.empty((bh, vs, bw, hs, 3), np.uint8)
    out[..., 0] = y
    out[..., 1:] = blk[:, None, :, None, hs * vs:]
    return out.reshape(bh * vs, bw * hs, 3)[:rows, :tw]


def _ycbcr44_skewed(raw: bytes, rows: int, tw: int, w: int) -> bytes:
    """A 4x4-subsampled tile cut at the image's right edge (``w`` of its
    ``tw`` columns inside) as ``putcontig8bitYCbCr44tile`` walks it: past
    each block row's ceil(w / 4) blocks of 18 bytes it skips
    ``(tw - w) // 4`` blocks of 10 bytes (the 4x2 routine's size), so its
    block rows after the first start early.  The bytes it reads, laid out
    as the tile's block rows."""
    full = tw // 4 * 18
    step = -(-w // 4) * 18 + (tw - w) // 4 * 10
    return b"".join(raw[r * step:r * step + full]
                    for r in range(-(-rows // 4)))


def _ycbcr_unpredict(raw: bytes, lay: "_Layout", tiled: bool) -> bytes:
    """The horizontal predictor undone on subsampled YCbCr blocks as
    libtiff undoes it: on rows of ``TIFFScanlineSize`` bytes (a block
    row's bytes over the vertical subsampling, rounded down; in tiles
    ``TIFFTileRowSize``, three bytes a column), each byte summed with the
    one three before it, mod 256.  Where the chunk is not whole rows, or
    a row not whole pixels, libtiff's predictor fails and the RGBA reader
    goes on with the bytes as decoded."""
    hs, vs = lay.subsampling
    row = (lay.tags[322][0] * 3 if tiled
           else -(-lay.W // hs) * (hs * vs + 2) // vs)
    if row == 0 or len(raw) % row or row % 3:
        return raw
    a = np.frombuffer(raw, np.uint8).reshape(-1, row // 3, 3)
    return np.cumsum(a, axis=1, dtype=np.uint8).tobytes()


def _chunk_bytes(lay: "_Layout", rows: int, tw: int, n: int) -> int:
    """The bytes a strip or tile of ``rows`` rows decodes to."""
    if lay.photometric == _YCBCR and lay.planar == 1:
        hs, vs = lay.subsampling
        return -(-rows // vs) * -(-tw // hs) * (hs * vs + 2)
    return rows * _row_bytes(tw, n, lay.bits)


def _estimated_counts(data: bytes, lay: "_Layout", n: int, offsets,
                      tw: int, th: int) -> list:
    """The byte counts of a file without StripByteCounts (or
    TileByteCounts), as libtiff 4.7.1's ``TIFFReadDirectory`` and
    ``EstimateStripByteCounts`` make them: ValueError (``MissingRequired``)
    unless there is one chunk, or one a sample of a planar file; else,
    compressed, the file's bytes less ``_directory_bytes`` (over the
    samples a pixel for a planar file) for each chunk, the last cut at the
    file's end; uncompressed, a chunk's bytes (a strip's rows times
    ``TIFFScanlineSize``)."""
    if n != (lay.spp if lay.planar == 2 else 1):
        raise ValueError("TIFF without StripByteCounts of more than one "
                         "strip or tile a plane, which libtiff does not read")
    if lay.compression == _NONE:
        pn = 1 if lay.planar == 2 else lay.spp
        if 322 in lay.tags:
            return [_chunk_bytes(lay, th, tw, pn)] * n
        if lay.photometric == _YCBCR and lay.planar == 1:
            hs, vs = lay.subsampling
            row = -(-lay.W // hs) * (hs * vs + 2) // vs  # 8-bit samples
        else:
            row = _row_bytes(lay.W, pn, lay.bits)
        return [row * lay.H] * n
    space = len(data) - _directory_bytes(data)
    if space < 0:
        space = len(data)  # libtiff's choice
    if lay.planar == 2:
        space //= lay.spp
    return [space] * (n - 1) + [max(0, min(space, len(data) - offsets[-1]))]


def _count_looks_bad(data: bytes, lay: "_Layout", offset: int, count: int,
                     tw: int, th: int) -> bool:
    """libtiff's ``ByteCountLooksBad`` of a file's one strip: a count of 0
    at a nonzero offset, or, uncompressed, one past the file's end or
    short of the strip's rows."""
    if offset == 0:
        return False
    if count == 0:
        return True
    if lay.compression != _NONE:
        return False
    return (offset <= len(data) and count > len(data) - offset) or (
        count < _estimated_counts(data, lay, 1, [offset], tw, th)[0])


def _skewed(block: np.ndarray, w: int, h: int, step: int) -> np.ndarray:
    """The samples that a put routine of libtiff's RGBA reader takes from
    a tile cut at the image's right edge (``w`` of its columns and ``h`` of
    its rows in the image) when it steps from one row to the next by
    ``step`` bytes of the tile's buffer in the host's (little-endian)
    byte order: 16-bit samples read at the byte where they fall, odd ones
    too."""
    th, tw, n = block.shape
    size = block.dtype.itemsize
    flat = block.astype(block.dtype.newbyteorder("<")).reshape(-1).view(
        np.uint8)
    at = (np.arange(h)[:, None, None] * step
          + (np.arange(w)[:, None] * n + np.arange(n)) * size)
    vals = flat[at]
    if size == 2:
        vals = vals.astype(np.uint16) | (flat[at + 1].astype(np.uint16) << 8)
    out = np.zeros((th, tw, n), vals.dtype)
    out[:h, :w] = vals
    return out


def _samples(data: bytes, lay: _Layout) -> np.ndarray:
    """The image's (H, W, samples) values, native unsigned: uint8 (8 bits
    and below), uint16 (10 to 16 bits, shifted to 16), uint32 or uint64:
    the strips or tiles (each sample's plane apart for planar files)
    decoded, bit-reversed first for FillOrder 2, the predictor's sums
    undone (horizontal: on the samples' bits; floating point:
    ``_fp_unpredict``); YCbCr blocks spread over their pixels
    (``_ycbcr_chunk``); zeros for a compression libtiff does not know.
    Tiles cut at the right edge are taken as the RGBA reader takes them
    where its put routine steps rows by other than the tile's row bytes
    (``_skewed``)."""
    W, H, bits, spp = lay.W, lay.H, lay.bits, lay.spp
    size = 1 if bits <= 8 else 2 if bits <= 16 else bits // 8
    if lay.zeros:
        return np.zeros((H, W, spp), f"u{size}")
    order = "<" if data[:2] == b"II" else ">"
    tw, th, tiled, offsets, counts = lay.chunks(data)
    planes = spp if lay.planar == 2 else 1
    n = spp // planes  # samples in a chunk's pixel
    dtype = np.dtype(order + f"u{size}")
    out = np.empty((H, W, spp), dtype.newbyteorder("="))
    # the gray and palette put routines of the RGBA reader step rows by
    # ``tw - w`` bytes where they mean pixels: 16-bit gray samples, or
    # 8-bit ones of a pixel of more than one
    skew = not lay.raw and planes == 1 and (
        lay.photometric in (_MINISWHITE, _MINISBLACK) and (bits == 16
                                                           or spp > 1)
        or lay.photometric == _PALETTE and spp > 1)
    ycbcr = lay.photometric == _YCBCR and lay.compression != _JPEG
    tables = lay.tags.get(347, b"")
    space = "ycc" if lay.photometric == _YCBCR else "rgb"
    across, down = -(-W // tw), -(-H // th)
    fax = (fax3.FaxDecoder(lay.compression, tw, lay.tags.get(292, (0,))[0]
                           if lay.compression == fax3.G3 else 0)
           if lay.compression in _FAX else None)
    for k in range(across * down * planes):
        p, kk = divmod(k, across * down)
        y, x = kk // across * th, kk % across * tw
        rows = th if tiled else min(th, H - y)
        chunk = _chunk_at(data, offsets[k], counts[k])
        if lay.compression == _JPEG:
            block = _jpeg_block(tables, chunk, space, rows, tw, n, tiled,
                                y + rows >= H)
        else:
            if lay.fill_order == 2:
                chunk = _reversed(chunk)
            want = _chunk_bytes(lay, rows, tw, n)
            if fax is not None:
                raw = fax.decode(chunk, rows, offsets[k])
            elif lay.compression == _THUNDERSCAN:
                # libtiff: "ThunderScan tile decoding is not implemented",
                # and the RGBA reader goes on with its zeroed tile
                raw = (bytes(want) if tiled
                       else _thunder_decode(chunk, rows, tw))
            else:
                raw = _decode_chunk(chunk, lay.compression, want)
            if len(raw) < want:
                if lay.raw:  # cv2's own path stops
                    raise ValueError("corrupt TIFF: a strip or tile decodes "
                                     "short")
                # libtiff's LZW, Deflate and PackBits decoders zero what
                # they do not decode, its uncompressed one the whole chunk,
                # and the RGBA reader goes on with it
                if lay.compression == _NONE:
                    raw = b""
                raw += bytes(want - len(raw))
            if ycbcr and planes == 1:
                if lay.predictor == 2:
                    raw = _ycbcr_unpredict(raw, lay, tiled)
                w = min(tw, W - x)
                if tiled and lay.subsampling == (4, 4) and w < tw:
                    raw = _ycbcr44_skewed(raw, rows, tw, w)
                block = _ycbcr_chunk(raw, rows, tw, *lay.subsampling)
            elif lay.predictor == 3:
                block = _fp_unpredict(raw, rows, tw, n, size)
            else:
                block = _unpack(raw, rows, tw, n, bits, dtype)
        if lay.predictor == 2 and not (ycbcr and planes == 1):
            # sums mod 2**bits of the samples' values
            block = np.cumsum(block, axis=1, dtype=out.dtype)
        w, h = min(tw, W - x), min(rows, H - y)
        if skew and tiled and w < tw:
            block = _skewed(block, w, h, dtype.itemsize * n * w + tw - w)
        out[y:y + rows, x:x + tw, p * n:(p + 1) * n] = block[:H - y, :W - x]
    return out


def _chunk_at(data: bytes, offset: int, count: int) -> bytes:
    """A strip or tile's bytes; ValueError where libtiff's
    ``TIFFFillStrip`` fails, and cv2 with it."""
    if count == 0 or offset + count > len(data):
        raise ValueError("corrupt TIFF: a strip or tile of no bytes or "
                         "past the file's end")
    return data[offset:offset + count]


def _reversed(chunk: bytes) -> bytes:
    """A FillOrder 2 chunk's bytes, each one's bits reversed."""
    return _REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()


def _sgilog_image(data: bytes, lay: _Layout, color: bool) -> np.ndarray:
    """An SGILog file as cv2 reads it: LogLuv in IMREAD_UNCHANGED by cv2
    itself (libtiff's float X, Y, Z, a strip or tile at a time, then
    ``sgilog.xyz_to_rgb`` of the whole image: float32 RGB; a strip or tile
    that fails refuses the file; an orientation flips the floats before
    their conversion), everything else through libtiff's RGBA reader (8
    bits: LogL one gray channel, signed where the file's samples are,
    LogLuv RGB; the rows from a failing one on stay 0)."""
    tw, th, tiled, offsets, counts = lay.chunks(data)
    W, H = lay.W, lay.H
    own = lay.photometric == _LOGLUV and not color
    n = 1 if lay.photometric == _LOGL else 3
    out = np.zeros((H, W, n), np.float32 if own else np.uint8)
    across = -(-W // tw)
    for k in range(across * -(-H // th)):
        y, x = k // across * th, k % across * tw
        rows = th if tiled else min(th, H - y)
        chunk = _chunk_at(data, offsets[k], counts[k])
        if lay.fill_order == 2:
            chunk = _reversed(chunk)
        codes, good = sgilog.decode(chunk, lay.compression, lay.photometric,
                                    rows, tw)
        if own and good < rows:
            raise ValueError("corrupt SGILog TIFF: a strip or tile decodes "
                             "short")
        codes = codes[:good]
        if own:
            block = sgilog.xyz(codes, lay.compression)
        elif n == 1:
            block = sgilog.gray8(codes)[..., None]
        else:
            block = sgilog.rgb8(codes, lay.compression)
        block = block[:H - y, :W - x]
        out[y:y + len(block), x:x + block.shape[1]] = block
    if own:  # cv2 flips the floats (the whole image), then converts them
        turn = lay.orientation if lay.orientation in (2, 3, 4) else 1
        return sgilog.xyz_to_rgb(exif.apply(out, turn))
    if color and n == 1:
        out = np.repeat(out, 3, axis=2)
    elif not color and lay.fmt == 2:
        out = out.view(np.int8)
    return _orient(out, lay)


def _jpeg_block(tables: bytes, chunk: bytes, space: str, rows: int,
                tw: int, n: int, tiled: bool, last: bool) -> np.ndarray:
    """A JPEG strip or tile as libtiff's JPEG codec decodes it: its frame
    as wide as the chunk and as tall (a last strip may be taller, which
    libtiff cuts), ``n`` components."""
    img = decode_jpeg_chunk(tables, chunk, space)
    img = img.reshape(img.shape[:2] + (-1,))
    h, w, c = img.shape
    if c != n:
        raise ValueError("JPEG TIFF: improper JPEG component count")
    if (w, h) != (tw, rows) and not (w == tw and h > rows and last
                                     and not tiled):
        raise ValueError(f"JPEG TIFF: a {w}x{h} JPEG in a {tw}x{rows} "
                         "strip or tile")
    return img[:rows]


def _to8(v: np.ndarray) -> np.ndarray:
    """libtiff's RGBA reader's ``Bitdepth16To8`` of 16-bit samples."""
    return ((v.astype(np.uint32) + 128) // 257).astype(np.uint8)


def _gray_map(lay: _Layout) -> np.ndarray:
    """``setupMap``/``makebwmap``: a gray sample's 8-bit value by its value
    (16 bits: by its high byte), ``x * 255 / range`` in integers, reversed
    for WhiteIsZero."""
    top = 255 if lay.bits == 16 else (1 << lay.bits) - 1
    x = np.arange(top + 1)
    if lay.photometric == _MINISWHITE:
        x = top - x
    return (x * 255 // top).astype(np.uint8)


def _palette(lay: _Layout) -> np.ndarray:
    """(2**bits, 3) uint8 RGB of the colormap, as libtiff's ``checkcmap``
    and ``cvtcmap`` give it: each entry's high byte, or the entries as they
    are where none of the 2**bits of each channel reaches 256 (libtiff
    warns "Assuming 8-bit colormap")."""
    n = 1 << lay.bits
    cmap = np.asarray(lay.tags[320][:3 * n], np.int64).reshape(3, n).T
    return (cmap if (cmap < 256).all() else cmap >> 8).astype(np.uint8)


def _premultiply(c: np.ndarray, a: np.ndarray) -> np.ndarray:
    """libtiff's ``UaToAa``: a colour under an unassociated alpha."""
    return ((c.astype(np.uint32) * a + 127) // 255).astype(np.uint8)


def _rgba(s: np.ndarray, lay: _Layout):
    """(H, W, samples) values -> what libtiff's RGBA reader makes of them:
    (gray (H, W) uint8 or None, RGB (H, W, 3) uint8 or None, alpha (H, W)
    uint8 or None), one of the first two set."""
    ph, planar = lay.photometric, lay.planar == 2
    if ph in (_MINISWHITE, _MINISBLACK):
        if not planar:  # put*bwtile, put*greytile: the first sample mapped
            v = s[..., 0] >> 8 if lay.bits == 16 else s[..., 0]
            return _gray_map(lay)[v], None, None
        # gtTileSeparate takes a planar gray as RGB, with no map
        g = _to8(s[..., 0]) if lay.bits == 16 else s[..., 0]
        a = None
        if lay.alpha:
            a = _to8(s[..., 1]) if lay.bits == 16 else s[..., 1]
            if lay.alpha == 2:
                g = _premultiply(g, a)
        return g, None, a
    if ph == _PALETTE:
        return None, _palette(lay)[s[..., 0]], None
    if ph == _YCBCR and (lay.compression != _JPEG or planar):
        return None, _ycbcr_rgb(s, lay.tags), None
    if ph == _CIELAB:  # putcontig8bitCIELab8, putcontig8bitCIELab16
        return None, tiff_color.cielab_to_rgb(
            s, lay.bits, _counted(lay.tags, 318, 2)), None
    if ph == _CMYK:  # putRGBcontig8bitCMYKtile, putCMYKseparate8bittile
        k = 255 - s[..., 3:].astype(np.int32)
        return None, (k * (255 - s[..., :3].astype(np.int32)) // 255).astype(
            np.uint8), None
    rgb = _to8(s[..., :3]) if lay.bits == 16 else s[..., :3]
    a = None
    if lay.spp == 4:
        a = _to8(s[..., 3]) if lay.bits == 16 else s[..., 3]
        if lay.alpha == 2:
            rgb = _premultiply(rgb, a[..., None])
    return None, rgb, a


def _counted(tags: dict, tag: int, count: int):
    """A tag's values where it holds ``count`` of them, else None (libtiff
    ignores a tag of a fixed count given another)."""
    v = tags.get(tag)
    return v if v is not None and len(v) == count else None


def _ycbcr_rgb(s: np.ndarray, tags: dict) -> np.ndarray:
    """Uncompressed YCbCr through ``tiff_color.ycbcr_to_rgb`` with the
    YCbCrCoefficients and ReferenceBlackWhite tags, refused as
    ``initYCbCrConversion`` refuses them."""
    luma = _counted(tags, 529, 3)
    rbw = _counted(tags, 532, 6)
    if luma is not None and (np.isnan(luma).any() or luma[1] == 0):
        raise ValueError("YCbCr TIFF of invalid YCbCrCoefficients")
    if rbw is not None and not all(-0x7FFFFF7F < v < 0x7FFFFFFF
                                   for v in rbw):
        raise ValueError("YCbCr TIFF of invalid ReferenceBlackWhite")
    return tiff_color.ycbcr_to_rgb(s, luma, rbw)


def _cv2_own(s: np.ndarray, lay: _Layout) -> np.ndarray:
    """cv2's own reading of a file of over 8 bits (``readData``'s 16-, 32-
    and 64-bit cases): the samples as they are, in cv2's type, except a
    gray of 3 or 4 samples of 10 to 16 bits, which
    ``icvCvt_BGRA2Gray_16u_CnC1R`` turns into one weighted plane of the
    first three (on the samples' bits as unsigned, before their shift to
    16 bits).  Signed samples of 10 to 14 bits come shifted to 16 and
    saturated at 32767."""
    if lay.depth <= 16:
        if lay.photometric in (_MINISWHITE, _MINISBLACK) and lay.spp > 1:
            shift = 16 - lay.bits
            w = (s[..., :3] >> shift).astype(np.int64) @ np.array(
                _GRAY16_WEIGHTS)
            s = (((w + (1 << 13)) >> 14) << shift).astype(np.uint16)[
                ..., None]
        if lay.fmt == 2 and lay.bits < 16:
            return np.minimum(s, 32767).astype(np.int16)
    return s.view(lay.dtype)


def decode_tiff(data: bytes, color: bool = False) -> np.ndarray:
    """The first page of TIFF bytes -> (H, W, C): what
    ``cv2.imread(path, IMREAD_UNCHANGED)`` gives, in RGB order and cv2's
    type (uint8, int8, uint16, int16, uint32, int32, uint64, int64,
    float32 or float64), or with ``color`` what ``IMREAD_COLOR`` gives
    (uint8, C = 3).

    cv2 takes one of two paths.  A file of over 8 bits a sample that is
    gray, WhiteIsZero or RGB of 1, 3 or 4 samples is its own reading in
    IMREAD_UNCHANGED (``_cv2_own``): the samples as they are, whatever
    the photometric interpretation (WhiteIsZero is not reversed) and extra
    sample say (a planar file's samples too, where cv2 gives the first
    plane and memory it never wrote: the port gives the samples); 10-,
    12- and 14-bit samples shifted to 16 bits; gray of 3 or 4 samples as
    one weighted plane.  LogLuv is cv2's own reading too, whatever its
    samples' size: float32 RGB (``_sgilog_image``).  Every other file
    goes through
    libtiff's RGBA reader (``tif_getimage.c``, 8 bits a channel): gray and
    WhiteIsZero through ``_gray_map`` (16 bits by the high byte, and in a
    tile cut at the right edge with ``put16bitbwtile``'s row step:
    ``_skewed``), a planar gray as RGB (16 bits by ``Bitdepth16To8``, an
    unassociated alpha premultiplied), palette through ``_palette`` (its
    first sample; extra samples ignored), RGB
    with 16 bits ``(v + 128) // 257`` and an unassociated alpha
    premultiplied ``(c * a + 127) // 255``, CMYK ``(255 - c) * (255 - k) /
    255``, chunky JPEG YCbCr through libjpeg's RGB, other YCbCr and
    CIELab through ``tiff_color``, LogL and LogLuv as libtiff's 8-bit
    SGILog output; signed samples as their bits unsigned,
    the result signed bytes where cv2's type is.  A compression libtiff
    does not know (JPEG 2000 among them) reads as zero samples there.  cv2
    then keeps one channel for gray interpretations, LogL and 1-bit files
    (a 1-bit palette's gray by OpenCV's BGRA-to-gray weights), four for 4
    samples but a palette's (alpha 255 for CMYK), else three;
    IMREAD_COLOR three.
    Orientations 2-4 flip the image as ``exif.TRANSFORMS``, in both
    modes; 5-8 raise ValueError, as ``cv2.imread`` gives None.  Raises
    ValueError for corrupt files and those cv2 refuses."""
    lay = _Layout(_directory(data), color)
    if lay.compression in _SGILOG:
        return _sgilog_image(data, lay, color)
    s = _samples(data, lay)
    if lay.raw:
        return _orient(_cv2_own(s, lay), lay)
    gray, rgb, a = _rgba(s, lay)
    gray_out = lay.photometric in (_MINISWHITE, _MINISBLACK) or (
        lay.bits == 1)
    if color:
        out = (np.repeat(gray[..., None], 3, axis=2) if rgb is None
               else rgb)
    elif gray_out:
        out = (opencv_gray(rgb) if gray is None else gray)[..., None]
    elif lay.spp == 4 and lay.photometric != _PALETTE:
        alpha = np.full(rgb.shape[:2], 255, np.uint8) if a is None else a
        out = np.concatenate([rgb, alpha[..., None]], axis=2)
    else:
        out = rgb
    if not color and lay.fmt == 2:
        out = out.view(np.int8)
    return _orient(out, lay)


def _orient(img: np.ndarray, lay: _Layout) -> np.ndarray:
    """Orientations 2-4 as cv2 applies them: the image flipped as
    ``exif.TRANSFORMS`` says, except that through the RGBA reader each
    column of a tiled file's tiles is flipped left-right in place (cv2
    reads a tile at a time, which the reader flips alone)."""
    o = lay.orientation
    if o not in (2, 3, 4):
        return img
    tw = lay.tags[322][0] if 322 in lay.tags else lay.W
    if o != 4 and tw < lay.W and not lay.raw:
        img = img.copy()
        for x in range(0, lay.W, tw):
            img[:, x:x + tw] = img[:, x:x + tw][:, ::-1]
        o = 4 if o == 3 else 1
    return exif.apply(img, o)
