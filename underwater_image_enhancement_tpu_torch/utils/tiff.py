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
returns it) of a little- or big-endian file: 1, 4 (palette), 8 or 16 bits
a sample, unsigned; gray, WhiteIsZero, RGB with or without an extra
sample, gray with extra samples, palette (16-bit or 8-bit colormaps),
CMYK and JPEG YCbCr; chunky or planar, in strips or tiles (cropped at the
image's edges); stored uncompressed, PackBits, Deflate (8 and 32946,
through ``zlib``), LZW (``tif_lzw.c``'s codes, and the old style's LSB-first
ones) or JPEG (each strip or tile a JPEG after the JPEGTables tag,
``jpeg.decode_jpeg_chunk``); fill order 1 or 2; LZW and Deflate with the
horizontal predictor or none; orientations 1-4.  cv2's two paths and
libtiff's RGBA reader are ``decode_tiff``'s.  What cv2 refuses (2-bit
and 24-bit samples, 16-bit palette and CMYK, orientations 5-8, old-style
JPEG, LZMA, ZSTD, WebP, ICCLab, ITULab, transparency masks, predictor 3 on
integers, JPEG without its tables, ...) raises ValueError; what it reads
and the port does not (ROADMAP Queue 1 item 11.9: floating-point, signed,
10-, 12-, 14- and 32-bit samples, CIELab, uncompressed YCbCr, LogL and
LogLuv under SGILog, CCITT and JPEG 2000 compression, BigTIFF) raises
``Unsupported`` with its variant's name.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from underwater_image_enhancement_tpu_torch.utils import exif
from underwater_image_enhancement_tpu_torch.utils.bmp import opencv_gray
from underwater_image_enhancement_tpu_torch.utils.jpeg import (
    Unsupported,
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
# SBYTE, SSHORT, SLONG, IFD); UNDEFINED values are kept as bytes, tags of
# other types are not read
_INT_FORMAT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I"}
_UNDEFINED = 7
# what cv2 reads and the port does not (ROADMAP Queue 1 item 11.9)
_PHOTOMETRIC = {8: "CIELab", 32844: "LogL", 32845: "LogLuv"}
_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4",
                 34712: "JPEG 2000"}
# what cv2's libtiff refuses: cv2 gives None
_REFUSED_PHOTOMETRIC = {4: "transparency mask", 9: "ICCLab", 10: "ITULab"}
_REFUSED_COMPRESSIONS = {6: "old-style JPEG", 34925: "LZMA", 50000: "ZSTD",
                         50001: "WebP"}
_SGILOG = (34676, 34677)
_NONE, _LZW, _JPEG, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS = (
    1, 5, 7, 32946, 8, 32773)
_MINISWHITE, _MINISBLACK, _RGB, _PALETTE, _CMYK, _YCBCR = 0, 1, 2, 3, 5, 6


def _directory(data: bytes) -> dict:
    """The first directory's tags: tag -> tuple of values (the integer
    types) or bytes (UNDEFINED)."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None:
        raise ValueError("not a TIFF file")
    (version,) = struct.unpack(order + "H", data[2:4])
    if version == 43:
        raise Unsupported("BigTIFF")
    if version != 42:
        raise ValueError(f"not a TIFF file (version {version})")
    (at,) = struct.unpack(order + "I", data[4:8])
    (n,) = struct.unpack(order + "H", data[at:at + 2])
    tags = {}
    for k in range(n):
        entry = data[at + 2 + 12 * k:at + 14 + 12 * k]
        tag, kind, count = struct.unpack(order + "HHI", entry[:8])
        if (kind not in _INT_FORMAT and kind != _UNDEFINED) or count == 0:
            continue
        size = (count if kind == _UNDEFINED
                else struct.calcsize(_INT_FORMAT[kind]) * count)
        if size <= 4:
            raw = entry[8:8 + size]
        else:
            (off,) = struct.unpack(order + "I", entry[8:12])
            raw = data[off:off + size]
        if len(raw) != size:
            raise ValueError(f"corrupt TIFF: tag {tag} past the file's end")
        tags[tag] = (bytes(raw) if kind == _UNDEFINED else struct.unpack(
            f"{order}{count}{_INT_FORMAT[kind]}", raw))
    return tags


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
    repeated 257 - n times (n > 128); 128 is skipped."""
    out, have, pos = [], 0, 0
    while have < size and pos < len(data):
        n = data[pos]
        pos += 1
        if n < 128:
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
    interpretation, coding and chunks, and which of cv2's two reading
    paths takes it."""

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
        self.photometric = tags.get(262, (None,))[0]
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
        self.check(color)
        # cv2 reads 16-bit gray (one sample), RGB and RGBA as the samples
        # are in IMREAD_UNCHANGED; every other file through libtiff's RGBA
        # reader, 8 bits a channel
        self.raw = (self.bits == 16 and not color and (
            (self.photometric in (_MINISWHITE, _MINISBLACK)
             and self.spp == 1) or self.photometric == _RGB))

    def check(self, color: bool) -> None:
        """ValueError where cv2 gives None, ``Unsupported`` naming what it
        reads and the port does not."""
        bits, spp, ph = self.bits, self.spp, self.photometric
        fmt = set(self.tags.get(339, (1,)))
        if fmt - {1}:
            kinds = {2: "signed", 3: "floating-point"}
            kind = kinds.get(max(fmt), "untyped")
            if color and kind != "signed":
                raise ValueError(f"{kind} TIFF, which IMREAD_COLOR refuses")
            raise Unsupported(f"{kind} {bits}-bit TIFF")
        if bits in (10, 12, 14, 32, 64):
            if color:
                raise ValueError(f"{bits}-bit TIFF, which IMREAD_COLOR "
                                 "refuses")
            raise Unsupported(f"{bits}-bit TIFF")
        # OpenCV's readHeader: 1, 8, 10, 12, 14, 16, 32 or 64 bits, 4 for a
        # palette
        if bits not in (1, 8, 16) and not (bits == 4 and ph == _PALETTE):
            raise ValueError(f"{bits}-bit TIFF, which cv2 does not read")
        if not 1 <= spp <= 4:
            raise ValueError(f"TIFF of {spp} samples a pixel, which cv2 "
                             "does not read")
        if ph is None:
            raise Unsupported("TIFF without a photometric interpretation")
        if ph in _REFUSED_PHOTOMETRIC:
            raise ValueError(f"{_REFUSED_PHOTOMETRIC[ph]} TIFF, which "
                             "cv2 does not read")
        if ph in (32844, 32845) and self.compression not in _SGILOG:
            raise ValueError("LogL or LogLuv TIFF without SGILog "
                             "compression, which cv2 does not read")
        if ph in _PHOTOMETRIC:
            raise Unsupported(f"{_PHOTOMETRIC[ph]} TIFF")
        if self.compression in _REFUSED_COMPRESSIONS:
            raise ValueError(f"{_REFUSED_COMPRESSIONS[self.compression]} "
                             "TIFF, which cv2 does not read")
        if self.compression in _COMPRESSIONS:
            raise Unsupported(f"{_COMPRESSIONS[self.compression]} TIFF")
        if self.compression not in (_NONE, _LZW, _DEFLATE, _ADOBE_DEFLATE,
                                    _PACKBITS, _JPEG):
            raise Unsupported(f"compression {self.compression} TIFF")
        if ph == _YCBCR and self.compression != _JPEG:
            raise Unsupported("YCbCr TIFF")
        if self.compression == _JPEG and (bits != 8 or self.planar != 1
                                          or ph not in (_MINISBLACK, _RGB,
                                                        _YCBCR)):
            raise Unsupported("JPEG TIFF of other than 8-bit chunky gray, "
                              "RGB or YCbCr")
        if self.predictor == 3:
            raise ValueError("TIFF of predictor 3 on integer samples, which "
                             "cv2 does not read")
        if self.predictor not in (1, 2):
            raise Unsupported(f"TIFF of predictor {self.predictor}")
        if self.predictor == 2 and bits not in (8, 16):
            raise ValueError(f"TIFF of predictor 2 on {bits}-bit samples, "
                             "which libtiff does not read")
        if 5 <= self.orientation <= 8:
            # cv2 turns the image into a new array and imread refuses it
            raise ValueError(f"TIFF of orientation {self.orientation}, "
                             "which cv2 does not read")
        if ph in (_MINISWHITE, _MINISBLACK):
            if bits == 16 and spp > 2 and not color:
                raise Unsupported(f"16-bit gray TIFF with {spp - 1} extra "
                                  "samples")
        elif ph == _RGB:
            if spp not in (3, 4) or bits == 1:
                raise ValueError(f"{bits}-bit RGB TIFF of {spp} samples, "
                                 "which cv2 does not read")
        elif ph == _PALETTE:
            if spp != 1:
                raise Unsupported(f"palette TIFF of {spp} samples a pixel")
            if bits == 16:
                raise ValueError("16-bit palette TIFF, which cv2 does not "
                                 "read")
            if len(self.tags.get(320, ())) < 3 << bits:
                raise ValueError("palette TIFF without its colormap")
        elif ph == _CMYK:
            if bits != 8 or spp != 4:
                raise ValueError(f"{bits}-bit CMYK TIFF of {spp} samples, "
                                 "which cv2 does not read")
        elif ph != _YCBCR:
            raise ValueError(f"TIFF of photometric interpretation {ph}, "
                             "which cv2 does not read")

    def chunks(self):
        """(tile width, tile height, tiled, offsets, byte counts)."""
        tags = self.tags
        if 322 in tags:
            tw, th = tags[322][0], tags.get(323, (0,))[0]
            offsets, counts = tags.get(324), tags.get(325)
        else:  # strips: full-width tiles of RowsPerStrip rows
            tw, th = self.W, min(tags.get(278, (self.H,))[0], self.H)
            offsets, counts = tags.get(273), tags.get(279)
        if offsets is None:
            raise ValueError("corrupt TIFF: no strip or tile offsets")
        if counts is None:
            raise Unsupported("TIFF without strip or tile byte counts")
        if tw <= 0 or th <= 0:
            raise ValueError("corrupt TIFF: empty strips or tiles")
        n = -(-self.W // tw) * -(-self.H // th) * (
            self.spp if self.planar == 2 else 1)
        if len(offsets) < n or len(counts) < n:
            raise ValueError("corrupt TIFF: too few strips or tiles")
        return tw, th, 322 in tags, offsets, counts


def _row_bytes(width: int, samples: int, bits: int) -> int:
    return -(-width * samples * bits // 8)


def _unpack(raw: bytes, rows: int, tw: int, n: int, bits: int,
            dtype) -> np.ndarray:
    """A chunk's bytes -> (rows, tw, n) sample values; below 8 bits each
    row is packed most significant bit first and padded to a byte."""
    if bits >= 8:
        return np.frombuffer(raw, dtype).reshape(rows, tw, n)
    per = 8 // bits
    packed = np.frombuffer(raw, np.uint8).reshape(rows, -1)
    shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
    values = (packed[..., None] >> shifts) & ((1 << bits) - 1)
    return values.reshape(rows, -1)[:, :tw * n].reshape(rows, tw, n)


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
    """The image's (H, W, samples) values, native uint8 (8 bits and
    below) or uint16: the strips or tiles (each sample's plane apart for
    planar files) decoded, bit-reversed first for FillOrder 2, the
    predictor's sums undone.  Tiles cut at the right edge are taken as
    the RGBA reader takes them where its put routine steps rows by other
    than the tile's row bytes (``_skewed``)."""
    W, H, bits, spp = lay.W, lay.H, lay.bits, lay.spp
    order = "<" if data[:2] == b"II" else ">"
    tw, th, tiled, offsets, counts = lay.chunks()
    planes = spp if lay.planar == 2 else 1
    n = spp // planes  # samples in a chunk's pixel
    dtype = np.dtype(np.uint8 if bits <= 8 else order + "u2")
    out = np.empty((H, W, spp), dtype.newbyteorder("="))
    # the gray put routines of the RGBA reader step rows by ``tw - w``
    # bytes where they mean pixels: 16-bit samples, or 8-bit ones of a
    # pixel of more than one
    skew = (not lay.raw and planes == 1 and (bits == 16 or spp > 1)
            and lay.photometric in (_MINISWHITE, _MINISBLACK))
    tables = lay.tags.get(347, b"")
    space = "ycc" if lay.photometric == _YCBCR else "rgb"
    across, down = -(-W // tw), -(-H // th)
    for k in range(across * down * planes):
        p, kk = divmod(k, across * down)
        y, x = kk // across * th, kk % across * tw
        rows = th if tiled else min(th, H - y)
        chunk = data[offsets[k]:offsets[k] + counts[k]]
        if lay.compression == _JPEG:
            block = _jpeg_block(tables, chunk, space, rows, tw, n, tiled,
                                y + rows >= H)
        else:
            if lay.fill_order == 2:
                chunk = _REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
            size = rows * _row_bytes(tw, n, bits)
            raw = _decode_chunk(chunk, lay.compression, size)
            if len(raw) < size:
                raise ValueError("corrupt TIFF: a strip or tile decodes "
                                 "short")
            block = _unpack(raw, rows, tw, n, bits, dtype)
        if lay.predictor == 2:  # sums mod 2**bits of the samples' values
            block = np.cumsum(block, axis=1, dtype=out.dtype)
        w, h = min(tw, W - x), min(rows, H - y)
        if skew and tiled and w < tw:
            block = _skewed(block, w, h, dtype.itemsize * n * w + tw - w)
        out[y:y + rows, x:x + tw, p * n:(p + 1) * n] = block[:H - y, :W - x]
    return out


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


def decode_tiff(data: bytes, color: bool = False) -> np.ndarray:
    """The first page of TIFF bytes -> (H, W, C) uint8 or uint16: what
    ``cv2.imread(path, IMREAD_UNCHANGED)`` gives, in RGB order, or with
    ``color`` what ``IMREAD_COLOR`` gives (uint8, C = 3).

    cv2 takes one of two paths.  16-bit gray (one sample), RGB and RGBA
    in IMREAD_UNCHANGED are its own reading: the samples as they are,
    whatever the photometric interpretation (WhiteIsZero is not reversed)
    and extra sample say (a planar file's samples too, where cv2 gives
    the first plane and memory it never wrote: the port gives the
    samples).  Every other file goes through libtiff's RGBA reader
    (``tif_getimage.c``, 8 bits a channel): gray and WhiteIsZero through
    ``_gray_map`` (16 bits by the high byte, and in a tile cut at the
    right edge with ``put16bitbwtile``'s row step: ``_skewed``), a
    planar gray as RGB (16 bits by ``Bitdepth16To8``, an unassociated
    alpha premultiplied), palette through ``_palette``, RGB with 16 bits
    ``(v + 128) // 257`` and an unassociated alpha premultiplied
    ``(c * a + 127) // 255``, CMYK ``(255 - c) * (255 - k) / 255``, JPEG
    YCbCr through libjpeg's RGB.  cv2 then keeps one channel for gray
    interpretations and 1-bit files (a 1-bit palette's gray by OpenCV's
    BGRA-to-gray weights), four for 4 samples (alpha 255 for CMYK), else
    three; IMREAD_COLOR three.  Orientations 2-4 flip the image as
    ``exif.TRANSFORMS``, in both modes; 5-8 raise ValueError, as cv2
    gives None.  Raises ``Unsupported`` for the variants cv2 reads and the
    port does not, ValueError for corrupt files and those cv2 refuses."""
    lay = _Layout(_directory(data), color)
    s = _samples(data, lay)
    if lay.raw:
        out = s
    else:
        gray, rgb, a = _rgba(s, lay)
        gray_out = lay.photometric in (_MINISWHITE, _MINISBLACK) or (
            lay.bits == 1)
        if color:
            out = (np.repeat(gray[..., None], 3, axis=2) if rgb is None
                   else rgb)
        elif gray_out:
            out = (opencv_gray(rgb) if gray is None else gray)[..., None]
        elif lay.spp == 4:
            alpha = np.full(rgb.shape[:2], 255, np.uint8) if a is None else a
            out = np.concatenate([rgb, alpha[..., None]], axis=2)
        else:
            out = rgb
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
