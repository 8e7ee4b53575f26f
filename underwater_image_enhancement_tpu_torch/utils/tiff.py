"""A TIFF codec in numpy.  ``encode_tiff`` writes the file ``cv2.imwrite``
writes for a colour image through libtiff (LZW with the horizontal
predictor, chunky RGB, 8 or 16 bits a sample); ``decode_tiff`` reads the
8- and 16-bit files ``cv2.imread`` reads, with cv2's pixels.

The strips are libtiff's: ``_rows_per_strip`` rows each (cv2's 8 KiB
strips), each row differenced by the predictor (each sample less the one
three before it in the row, mod 2**bits, written little-endian) and each
strip coded alone by ``tif_lzw.c``'s encoder.  The directory follows the
strips, as libtiff writes it: twelve tags, then their out-of-line values
in libtiff's order.

The decoder takes the first directory (the first page, as ``cv2.imread``
returns it) of a little- or big-endian file: 8 or 16 bits a sample,
unsigned, chunky, gray (BlackIsZero), RGB or RGB with one extra sample,
top-left orientation, in strips or tiles (cropped at the image's edges),
stored uncompressed, PackBits, Deflate (8 and 32946, through ``zlib``) or
LZW (``tif_lzw.c``'s MSB-first codes, one bit wider as the table reaches
the next width's last code), LZW and Deflate with the horizontal predictor
(on the samples' values, mod 2**bits, in the file's byte order) or none.
Any other file raises ``Unsupported`` with its variant's name.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from underwater_image_enhancement_tpu_torch.utils.jpeg import (
    Unsupported,
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
# SBYTE, SSHORT, SLONG, IFD); tags of other types are not read
_INT_FORMAT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I"}
_PHOTOMETRIC = {0: "WhiteIsZero", 3: "palette", 4: "transparency mask",
                5: "CMYK", 6: "YCbCr", 8: "CIELab", 9: "ICCLab",
                10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4",
                 6: "old-style JPEG", 7: "JPEG", 34712: "JPEG 2000",
                 34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
_NONE, _LZW, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS = 1, 5, 32946, 8, 32773


def _directory(data: bytes) -> dict:
    """The first directory's integer tags: tag -> tuple of values."""
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
        if kind not in _INT_FORMAT or count == 0:
            continue
        size = struct.calcsize(_INT_FORMAT[kind]) * count
        if size <= 4:
            raw = entry[8:8 + size]
        else:
            (off,) = struct.unpack(order + "I", entry[8:12])
            raw = data[off:off + size]
        if len(raw) != size:
            raise ValueError(f"corrupt TIFF: tag {tag} past the file's end")
        tags[tag] = struct.unpack(f"{order}{count}{_INT_FORMAT[kind]}", raw)
    return tags


def _lzw_decode(data: bytes, size: int) -> bytes:
    """A strip or tile coded by ``tif_lzw.c``: MSB-first codes of 9 to 12
    bits, one bit wider once the table holds the width's last code but
    one; the first ``size`` bytes."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise Unsupported("old-style LZW TIFF")
    out, have = [], 0
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, prev = 9, None
    acc = nacc = 0
    pos, end = 0, len(data)
    while have < size:
        while nacc < nbits and pos < end:
            acc = (acc << 8) | data[pos]
            pos += 1
            nacc += 8
        if nacc < nbits:
            break  # no EOI: libtiff keeps what the strip gave
        nacc -= nbits
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
            if len(table) >= (1 << nbits) - 1 and nbits < 12:
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


def _decode_chunk(data: bytes, compression: int, size: int) -> bytes:
    if compression == _NONE:
        return data[:size]
    if compression == _LZW:
        return _lzw_decode(data, size)
    if compression == _PACKBITS:
        return _packbits_decode(data, size)
    return zlib.decompressobj().decompress(data, size)


def _variant(tags: dict) -> tuple:
    """(bits a sample, samples a pixel, compression, predictor) of a file
    the decoder reads; ``Unsupported`` naming any other variant."""
    bits = set(tags.get(258, (1,)))
    if bits not in ({8}, {16}):
        raise Unsupported(f"{'/'.join(map(str, sorted(bits)))}-bit TIFF")
    (depth,) = bits
    if set(tags.get(339, (1,))) != {1}:
        kinds = {2: "signed", 3: "floating-point"}
        raise Unsupported(
            f"{kinds.get(tags[339][0], 'untyped')} {depth}-bit TIFF")
    spp = tags.get(277, (1,))[0]
    if 262 not in tags:
        raise Unsupported("TIFF without a photometric interpretation")
    photometric = tags[262][0]
    if photometric in _PHOTOMETRIC:
        raise Unsupported(f"{_PHOTOMETRIC[photometric]} TIFF")
    if not 1 <= spp <= 4 or (photometric == 2 and spp < 3):
        raise ValueError(f"TIFF of photometric interpretation {photometric} "
                         f"with {spp} samples a pixel, which cv2 does not "
                         "read either")
    if (photometric, spp) == (1, 2):
        raise Unsupported("gray and alpha TIFF")
    if (photometric, spp) not in ((1, 1), (2, 3), (2, 4)):
        raise Unsupported(f"TIFF of photometric interpretation "
                          f"{photometric} with {spp} samples a pixel")
    if spp > 1 and tags.get(284, (1,))[0] != 1:
        raise Unsupported("planar TIFF")
    if tags.get(274, (1,))[0] != 1:
        raise Unsupported(f"TIFF of orientation {tags[274][0]}")
    if tags.get(266, (1,))[0] != 1:
        raise Unsupported("TIFF of fill order 2")
    compression = tags.get(259, (_NONE,))[0]
    if compression not in (_NONE, _LZW, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS):
        name = _COMPRESSIONS.get(compression, f"compression {compression}")
        raise Unsupported(f"{name} TIFF")
    predictor = tags.get(317, (1,))[0]
    if compression in (_NONE, _PACKBITS):
        predictor = 1  # libtiff applies the predictor to LZW and Deflate
    if predictor not in (1, 2):
        raise Unsupported(f"TIFF of predictor {predictor}")
    return depth, spp, compression, predictor


def _bw16_tile(block: np.ndarray, w: int, h: int) -> np.ndarray:
    """A 16-bit gray tile as libtiff's RGBA reader gives it (each value's
    high byte, kept here in the high byte): its ``put16bitbwtile`` steps
    from one row to the next by the tile's skew (``tw - w`` for a tile cut
    at the image's right edge) in bytes, where it means samples, so row r
    of a cut tile starts ``r * (2 * w + tw - w)`` bytes into the tile in
    the host's byte order, at an odd byte where that is odd."""
    th, tw = block.shape[:2]
    flat = block.astype("<u2").reshape(-1).view(np.uint8)
    at = (np.arange(h)[:, None] * (w + tw) + 2 * np.arange(w) + 1)
    hi = np.zeros((th, tw, 1), np.uint16)
    hi[:h, :w, 0] = flat[at].astype(np.uint16) << 8
    return hi


def decode_tiff(data: bytes, color: bool = False) -> np.ndarray:
    """The first page of 8- or 16-bit TIFF bytes -> (H, W, C) uint8 or
    uint16, C = 1 (gray), 3 (RGB) or 4 (RGB and its extra sample): what
    ``cv2.imread(path, IMREAD_UNCHANGED)`` gives, in RGB order.  At 8
    bits cv2 reads through libtiff's RGBA reader, which premultiplies
    colours under an unassociated alpha, ``(c * a + 127) // 255``; at 16
    bits it reads the samples as they are, whatever the extra sample.
    ``color``: what ``IMREAD_COLOR`` gives, uint8, the same at 8 bits; at
    16 bits through the RGBA reader as well: gray ``v >> 8``
    (``put16bitbwtile``, with its row step in tiles: ``_bw16_tile``), RGB
    ``(v + 128) // 257`` (its ``Bitdepth16To8``) and then the
    premultiplication.  Raises ``Unsupported`` for the variants the
    module docstring leaves out, ValueError for corrupt files."""
    tags = _directory(data)
    depth, spp, compression, predictor = _variant(tags)
    order = "<" if data[:2] == b"II" else ">"
    try:
        W, H = tags[256][0], tags[257][0]
    except KeyError:
        raise ValueError("corrupt TIFF: no image size") from None
    if W <= 0 or H <= 0:
        raise ValueError("corrupt TIFF: empty image")
    if 322 in tags:  # tiles
        tw, th = tags[322][0], tags.get(323, (0,))[0]
        offsets, counts = tags.get(324), tags.get(325)
    else:  # strips: full-width tiles of RowsPerStrip rows
        tw, th = W, min(tags.get(278, (H,))[0], H)
        offsets, counts = tags.get(273), tags.get(279)
    if offsets is None:
        raise ValueError("corrupt TIFF: no strip or tile offsets")
    if counts is None:
        raise Unsupported("TIFF without strip or tile byte counts")
    if tw <= 0 or th <= 0:
        raise ValueError("corrupt TIFF: empty strips or tiles")
    across, down = -(-W // tw), -(-H // th)
    if len(offsets) < across * down or len(counts) < across * down:
        raise ValueError("corrupt TIFF: too few strips or tiles")
    dtype = np.dtype(np.uint8 if depth == 8 else order + "u2")
    out = np.empty((H, W, spp), dtype.newbyteorder("="))
    for k in range(across * down):
        y, x = k // across * th, k % across * tw
        rows = th if 322 in tags else min(th, H - y)  # the last strip's
        size = rows * tw * spp * dtype.itemsize
        chunk = data[offsets[k]:offsets[k] + counts[k]]
        raw = _decode_chunk(chunk, compression, size)
        if len(raw) < size:
            raise ValueError("corrupt TIFF: a strip or tile decodes short")
        block = np.frombuffer(raw, dtype).reshape(rows, tw, spp)
        if predictor == 2:  # sums mod 2**depth of the samples' values
            block = np.cumsum(block, axis=1, dtype=out.dtype)
        if color and depth == 16 and spp == 1 and 322 in tags:
            block = _bw16_tile(block, min(tw, W - x), min(rows, H - y))
        out[y:y + rows, x:x + tw] = block[:H - y, :W - x]
    unassociated = spp == 4 and tags.get(338, (0,))[0] == 2
    if depth == 16:
        if not color:
            return out
        if spp == 1:
            return (out >> 8).astype(np.uint8)
        out = ((out.astype(np.uint32) + 128) // 257).astype(np.uint8)
    if unassociated:  # libtiff's RGBA reader premultiplies
        a = out[..., 3:].astype(np.uint32)
        out[..., :3] = (out[..., :3] * a + 127) // 255
    return out
