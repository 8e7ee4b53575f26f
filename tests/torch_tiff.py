"""A TIFF writer for the tests of the port's TIFF decoder and for
``chip_smoke.py`` (whose machine has no cv2), numpy + ``zlib`` +
``struct`` only.

``tiff(pages, ...)`` writes one directory a page after the pages' data:
strips or tiles (padded at the image's edges), chunky or planar
(``planar=2``: each sample's plane in strips or tiles of its own, the
planes one after the other), samples of 1, 2, 4, 8 or 16 bits (below 8
each row packed most significant bit first and padded to a byte; at 16 in
the file's byte order), the horizontal predictor, and a strip or tile
coded by any compression the tests need: none, LZW (libtiff's codes, or
``"lzw-old"``: the old LSB-first codes of ``tif_lzw.c``'s
``LZWDecodeCompat``, written with tag 259 = 5), PackBits, Deflate (8 and
32946) or JPEG (``jpeg=``: a function that codes one chunk), or by a
``coder=`` of its own: ``ccitt`` (CCITT RLE, RLEW, Group 3 1-D and 2-D,
Group 4: T.4's Modified Huffman, Modified READ and Modified Modified
READ coders) and ``sgilog_coder`` (SGILog's LogL and LogLuv run-length
planes, SGILog24's packed pixels; ``sgilog_page`` carries the codes and
``sgilog_codes`` makes them from X, Y, Z).  With ``fill_order=2`` every
coded chunk's bits are reversed in each byte, as a file of FillOrder 2
stores them.  ``tags`` adds or replaces entries: (type, values), values
bytes for the types BYTE, ASCII and UNDEFINED; None drops the entry.
"""

from __future__ import annotations

import bisect
import math
import struct
import zlib

import numpy as np

from tests import torch_png
from underwater_image_enhancement_tpu_torch.utils import tiff as ttiff

# bits reversed in each byte value
REVERSED = np.array([int(f"{v:08b}"[::-1], 2) for v in range(256)],
                    np.uint8)


def reverse_bits(raw: bytes) -> bytes:
    return REVERSED[np.frombuffer(raw, np.uint8)].tobytes()


def packbits(raw: bytes) -> bytes:
    """PackBits: repeats of 3 to 128 bytes, literal runs of up to 128."""
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and j - i < 128 and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), raw[i]])
            i = j
            continue
        j = i + 1
        while j < len(raw) and j - i < 128 and not (
                j + 2 < len(raw) and raw[j] == raw[j + 1] == raw[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + raw[i:j]
        i = j
    return bytes(out)


def lzw_old(raw: bytes) -> bytes:
    """``raw`` in the old-style LZW codes that libtiff's
    ``LZWDecodeCompat`` reads: a clear code first, then LZW codes packed
    least significant bit first, each as wide as the decoder reads it (9
    bits, one wider once the decoder's table holds 2**bits entries: one
    code later than the new style), a clear code where the table would
    pass 4093 entries, EOI, the bits padded to a byte."""
    codes = [256]
    table: dict = {}
    free = 258
    if raw:
        ent = raw[0]
        for c in raw[1:]:
            code = table.get((ent, c))
            if code is not None:
                ent = code
                continue
            codes.append(ent)
            table[(ent, c)] = free
            free += 1
            ent = c
            if free == 4094:
                codes.append(256)
                table.clear()
                free = 258
        codes.append(ent)
    codes.append(257)
    widths, nbits, entries = [], 9, None
    for code in codes:
        widths.append(nbits)
        if code == 256:
            nbits, entries = 9, None
        elif entries is None:
            entries = 258  # the first code after a clear adds no entry
        else:
            entries += 1
            if entries > (1 << nbits) - 1:
                nbits = min(nbits + 1, 12)
    acc = nacc = 0
    out = bytearray()
    for code, w in zip(codes, widths):
        acc |= code << nacc
        nacc += w
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def code(raw: bytes, compression) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return ttiff._lzw_encode(raw)
    if compression == "lzw-old":
        return lzw_old(raw)
    if compression == 32773:
        return packbits(raw)
    if compression in (8, 32946):
        return zlib.compress(raw)
    raise ValueError(f"no coder for compression {compression}")


def pack_msb(blk: np.ndarray, bits: int) -> np.ndarray:
    """(rows, cols, samples) unsigned values -> (rows, row bytes) uint8:
    each row's samples of ``bits`` bits (up to 16) packed most significant
    bit first, the row padded to a byte."""
    rows = blk.shape[0]
    v = blk.reshape(rows, -1).astype(">u2")
    b = np.unpackbits(v.view(np.uint8).reshape(rows, -1, 2), axis=2)
    b = b.reshape(rows, -1, 16)[..., 16 - bits:].reshape(rows, -1)
    return np.packbits(b, axis=1)


def fp_predict(raw: bytes, row_samples: int, bps: int, stride: int) -> bytes:
    """Rows of native (little-endian) samples of ``bps`` bytes, each row
    ``row_samples`` of them -> libtiff's floating-point predictor
    (``fpDiff``): each row's bytes regathered into planes, most
    significant first, then each byte less the one ``stride`` before it in
    the row, mod 256."""
    a = np.frombuffer(raw, np.uint8).reshape(-1, row_samples, bps)
    planes = a[..., ::-1].transpose(0, 2, 1).reshape(a.shape[0], -1)
    out = planes.copy()
    out[:, stride:] = planes[:, stride:] - planes[:, :-stride]
    return out.tobytes()


def _rows(blk: np.ndarray, bits: int, order: str) -> bytes:
    """(rows, cols, samples) values -> the chunk's bytes: packed rows below
    8 bits and at 10, 12 and 14 (most significant bit first), the file's
    byte order from 16 bits up (any dtype: unsigned, signed, float)."""
    if bits < 8:
        return torch_png.pack_rows(blk, bits).tobytes()
    if bits in (10, 12, 14):
        return pack_msb(blk, bits).tobytes()
    if blk.dtype.itemsize > 1:
        return blk.astype(blk.dtype.newbyteorder(order)).tobytes()
    return blk.astype(np.uint8).tobytes()


_PACK = {1: "B", 3: "H", 4: "I", 5: "I", 6: "b", 8: "h", 9: "i", 10: "i",
         11: "f", 12: "d", 16: "Q"}


def _value_bytes(order: str, kind: int, vals) -> tuple:
    """(count, packed bytes) of an entry's values; RATIONAL and SRATIONAL
    values as numerator, denominator, numerator, ..."""
    if kind in (2, 7) or (kind == 1 and isinstance(vals, bytes)):
        return len(vals), bytes(vals)
    count = len(vals) // 2 if kind in (5, 10) else len(vals)
    return count, struct.pack(order + _PACK[kind] * len(vals), *vals)


def tiff(pages, order="<", tile=None, compression=1, predictor=1,
         photometric=None, planar=1, rows_per_strip=None, bits=None,
         fill_order=1, tags=None, jpeg=None, big=False,
         block=None, coder=None) -> bytes:
    """A TIFF of ``pages`` ((H, W) or (H, W, C) arrays of sample values,
    unsigned, signed or float; SampleFormat 2 or 3 written for the last
    two), linked in order.  ``bits`` a sample (default the dtype's),
    ``tile`` (width, height) or strips of ``rows_per_strip`` rows (one
    strip where None), ``compression`` as the module docstring says
    (``jpeg(block, plane)`` codes a chunk for compression 6 or 7),
    ``predictor`` 2 (on the samples' bits as unsigned integers) or 3
    (libtiff's floating-point predictor, ``fp_predict``), ``big``: a
    BigTIFF (version 43, 8-byte offsets and counts), ``block(blk)``: a
    chunk's uncoded bytes from its (rows, tile width, samples) values in
    place of the samples' own, ``coder(blk)``: a chunk's coded bytes
    from its values (``ccitt`` and ``sgilog`` make them) in place of
    ``compression``'s coder."""
    data, dirs = bytearray(16 if big else 8), []
    for img in pages:
        a = img if img.ndim == 3 else img[..., None]
        H, W, C = a.shape
        depth = bits or a.dtype.itemsize * 8
        planes = [a] if planar == 1 else [a[..., c:c + 1] for c in range(C)]
        tw, th = tile or (W, rows_per_strip or H)
        offsets, counts = [], []
        for p, plane in enumerate(planes):
            for y in range(0, H, th):
                for x in range(0, W, tw):
                    rows = th if tile else min(th, H - y)
                    blk = np.zeros((rows, tw, plane.shape[2]), plane.dtype)
                    part = plane[y:y + rows, x:x + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    n = plane.shape[2]
                    if predictor == 2:
                        flat = blk.reshape(rows, -1)
                        if flat.dtype.kind != "u":
                            flat = flat.view(f"u{flat.dtype.itemsize}")
                        flat = flat.copy()
                        flat[:, n:] = flat[:, n:] - flat[:, :-n]
                        blk = flat.view(blk.dtype).reshape(blk.shape)
                    if coder is not None:
                        chunk = coder(blk)
                    elif compression in (6, 7):
                        chunk = jpeg(blk, p)
                    else:
                        raw = (block(blk) if block
                               else _rows(blk, depth, order))
                        if predictor == 3:
                            size = blk.dtype.itemsize
                            raw = fp_predict(blk.astype(blk.dtype.newbyteorder(
                                "<")).tobytes(), tw * n, size, n)
                        chunk = code(raw, compression)
                    if fill_order == 2:
                        chunk = reverse_bits(chunk)
                    offsets.append(len(data))
                    counts.append(len(chunk))
                    data += chunk + b"\0" * (len(chunk) & 1)
        entries = {256: (4, [W]), 257: (4, [H]), 258: (3, [depth] * C),
                   259: (3, [5 if compression == "lzw-old" else compression]),
                   262: (3, [photometric if photometric is not None
                             else 1 if C <= 2 else 2]),
                   277: (3, [C]), 284: (3, [planar]), 317: (3, [predictor])}
        if a.dtype.kind in "if":
            entries[339] = (3, [2 if a.dtype.kind == "i" else 3] * C)
        if fill_order != 1:
            entries[266] = (3, [fill_order])
        at = 16 if big else 4
        if tile:
            entries.update({322: (3, [tw]), 323: (3, [th]),
                            324: (at, offsets), 325: (at, counts)})
        else:
            entries.update({273: (at, offsets), 278: (4, [th]),
                            279: (at, counts)})
        entries.update(tags or {})
        entries = {k: v for k, v in entries.items() if v is not None}
        dirs.append(entries)
    links = []
    inline = 8 if big else 4
    for entries in dirs:
        at = len(data)
        values_at = at + (8 if big else 2) + (20 if big else 12) * len(
            entries) + (8 if big else 4)
        head = struct.pack(order + ("Q" if big else "H"), len(entries))
        values = b""
        for tag in sorted(entries):
            kind, vals = entries[tag]
            count, raw = _value_bytes(order, kind, vals)
            if len(raw) <= inline:
                head += struct.pack(order + "HH" + ("Q" if big else "I"),
                                    tag, kind, count)
                head += raw.ljust(inline, b"\0")
            else:
                head += struct.pack(order + "HH" + ("QQ" if big else "II"),
                                    tag, kind, count, values_at + len(values))
                values += raw + b"\0" * (len(raw) & 1)
        links.append(at + len(head))
        data += head + b"\0" * inline + values
        data += b"\0" * (len(data) & 1)
        link = order + ("Q" if big else "I")
        if len(links) == 1:
            magic = (b"II" if order == "<" else b"MM") + struct.pack(
                order + "H", 43 if big else 42)
            data[:len(magic)] = magic
            if big:
                data[4:16] = struct.pack(order + "HHQ", 8, 0, at)
            else:
                data[4:8] = struct.pack(link, at)
        else:
            data[links[-2]:links[-2] + inline] = struct.pack(link, at)
    return bytes(data)


def ycbcr_block(hs: int, vs: int):
    """A ``block`` for ``tiff``: a chunk's (rows, tile width, 3) Y, Cb, Cr
    -> libtiff's subsampled YCbCr layout: block rows of ceil(width / hs)
    blocks, each its hs * vs lumas (rows of hs) then the Cb and Cr of the
    block's first pixel; blocks past the chunk's edge padded with zeros."""
    def code(blk: np.ndarray) -> bytes:
        rows, tw = blk.shape[:2]
        bh, bw = -(-rows // vs), -(-tw // hs)
        pad = np.zeros((bh * vs, bw * hs, 3), np.uint8)
        pad[:rows, :tw] = blk
        y = pad[..., 0].reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3)
        return np.concatenate([y.reshape(bh, bw, hs * vs),
                               pad[::vs, ::hs, 1:]], -1).tobytes()
    return code


def jpeg_split(data: bytes, markers=(0xDB, 0xC4)) -> tuple:
    """A JPEG file -> (its tables as an abbreviated tables-only stream:
    SOI, the DQT and DHT segments (those of ``markers``), EOI; the file
    without them or any APPn segment), as libtiff's JPEG codec splits a
    stream between the JPEGTables tag and a strip or tile."""
    tables, rest, pos = [b"\xff\xd8"], [b"\xff\xd8"], 2
    while True:
        marker = data[pos + 1]
        if marker == 0xDA:
            rest.append(data[pos:])
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos:pos + 2 + length]
        if marker in markers:
            tables.append(seg)
        elif not 0xE0 <= marker <= 0xEF:
            rest.append(seg)
        pos += 2 + length
    return b"".join(tables) + b"\xff\xd9", b"".join(rest)


def _changes(row: np.ndarray) -> np.ndarray:
    """A row of bits (1 black) -> its changing elements: the positions
    where the colour differs from the pixel before (white before the
    first), black ones at even indices."""
    row = np.asarray(row, np.int8).reshape(-1)
    return np.flatnonzero(np.diff(np.concatenate([[0], row])))


def _runs(row: np.ndarray) -> list:
    """A row's run lengths, white first (0 where it starts black)."""
    edges = np.concatenate([[0], _changes(row), [len(row)]])
    return np.diff(edges).tolist()


def mh_codes(run: int, black: bool) -> list:
    """One run in Modified Huffman codes: 2560 make-ups while past 2560,
    a make-up of the 64s (the shared codes from 1792), a terminating
    code."""
    from underwater_image_enhancement_tpu_torch.utils import fax3
    term = fax3.BLACK_TERMINATING if black else fax3.WHITE_TERMINATING
    makeup = fax3.BLACK_MAKEUP if black else fax3.WHITE_MAKEUP
    out = []
    while run > 2560:
        out.append(fax3.SHARED_MAKEUP[-1])
        run -= 2560
    if run >= 64:
        m = run // 64
        out.append(makeup[m - 1] if m <= 27 else fax3.SHARED_MAKEUP[m - 28])
        run -= 64 * m
    out.append(term[run])
    return out


def mh_row(row: np.ndarray) -> str:
    return "".join("".join(mh_codes(r, bool(k & 1)))
                   for k, r in enumerate(_runs(row)))


def mr_row(row: np.ndarray, ref: np.ndarray, used=None) -> str:
    """One row in T.4's Modified READ codes against the reference row
    ``ref``: pass where b2 lies left of a1, vertical where |a1 - b1| <= 3,
    else horizontal; each mode's name added to the set ``used``."""
    from underwater_image_enhancement_tpu_torch.utils import fax3
    width = len(row)
    a = _changes(row).tolist() + [width] * 2
    b = _changes(ref).tolist() + [width] * 3
    modes = {k: v[0] for k, v in fax3.MODES.items()}
    out, a0, black = [], -1, False
    while a0 < width:
        ia = bisect.bisect_right(a, a0)
        a1, a2 = a[ia], a[ia + 1]
        # b1: the first change right of a0 to the colour opposite a0's
        ib = bisect.bisect_right(b, a0)
        ib += (ib & 1) != black
        b1, b2 = b[ib], b[ib + 1]
        if b2 < a1:
            mode = "pass"
            out.append(modes[mode])
            a0 = b2
        elif abs(a1 - b1) <= 3:
            d = a1 - b1
            mode = "V0" if d == 0 else f"VR{d}" if d > 0 else f"VL{-d}"
            out.append(modes[mode])
            a0, black = a1, not black
        else:
            mode = "horizontal"
            out.append(modes[mode]
                       + "".join(mh_codes(a1 - max(a0, 0), black))
                       + "".join(mh_codes(a2 - a1, not black)))
            a0 = a2
        if used is not None:
            used.add(mode)
    return "".join(out)


def _bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return np.packbits(np.frombuffer(bits.encode(), np.uint8) - 48).tobytes()


def _reader_align(lookups: list, avail: int, pos: int) -> tuple:
    """libtiff's ``Fax3DecodeRLE`` reading an RLEW row of ``lookups``
    ((bits a lookup wants, bits its code takes)) from a chunk at an even
    file offset, its accumulator holding ``avail`` bits of the ``pos``
    bytes it has loaded: a byte loaded, and another where it still holds
    fewer bits than the lookup wants; after the row the bits past a
    multiple of 16 dropped, and a byte skipped where none are left at an
    odd offset -> (avail, pos) where the next row starts, at bit ``8 * pos
    - avail``."""
    for need, width in lookups:
        if avail < need:
            avail += 8
            pos += 1
            if avail < need:
                avail += 8
                pos += 1
        avail -= width
    avail -= avail % 16
    if avail == 0 and pos & 1:
        pos += 1
    return avail, pos


def ccitt(blk: np.ndarray, compression: int, options: int = 0, k: int = 4,
          first_eol: bool = True, rtc: bool = True, two_d_first=False,
          align: str = "reader", used=None) -> bytes:
    """A chunk of bits ((rows, width) or (rows, width, 1), 1 black) coded
    for TIFF compression 2 (RLE: Modified Huffman rows, each padded to a
    byte), 32771 (RLEW: rows padded to where libtiff's reader starts the
    next, ``_reader_align``, or with ``align="writer"`` to 16 bits from
    the chunk's start, as libtiff's writer pads them), 3 (Group 3: an EOL
    before each row, the first only with ``first_eol``, and the RTC, six
    EOLs, with ``rtc``; ``options`` bit 0: Modified READ, a tag bit after
    each EOL, 1-D every ``k`` rows, the first row 2-D with
    ``two_d_first``; bit 2: zero fill bits before each EOL so that it
    ends a byte) or 4 (Group 4: Modified Modified READ against an
    all-white first reference, then the EOFB); the 2-D modes coded added
    to the set ``used``."""
    from underwater_image_enhancement_tpu_torch.utils import fax3
    rows = np.asarray(blk).reshape(blk.shape[0], -1).astype(bool)
    width = rows.shape[1]
    out, have = [], 0
    if compression in (2, 32771):
        avail = pos = 0
        for row in rows:
            runs = [mh_codes(r, bool(i & 1)) for i, r in enumerate(_runs(row))]
            bits = "".join("".join(c) for c in runs)
            if compression == 2 or align == "writer":
                bits += "0" * (-len(bits) % (8 if compression == 2 else 16))
            else:
                lookups = [(13 if i & 1 else 12, len(c))
                           for i, codes in enumerate(runs) for c in codes]
                avail, pos = _reader_align(lookups, avail, pos)
                bits += "0" * (8 * pos - avail - have - len(bits))
            out.append(bits)
            have += len(bits)
        return _bytes("".join(out))
    ref = np.zeros(width, bool)
    for y, row in enumerate(rows):
        one_d = compression == 3 and not options & 1
        start = len(out)
        if compression == 3:
            if y or first_eol:
                fill = "0" * (-(have + 12) % 8) if options & 4 else ""
                out.append(fill + fax3.EOL)
            if options & 1:
                one_d = y % k == 0 and not (y == 0 and two_d_first)
                out.append("1" if one_d else "0")
        out.append(mh_row(row) if one_d else mr_row(row, ref, used))
        have += sum(map(len, out[start:]))
        ref = row
    if compression == 4:
        out.append(fax3.EOL * 2)
    elif rtc:
        out.append((fax3.EOL + ("1" if options & 1 else "")) * 6)
    return _bytes("".join(out))


def sgilog_rle(plane: bytes, min_run: int = 4) -> bytes:
    """One byte plane of a row in SGILog's run-length codes: runs of
    ``min_run`` or more equal bytes (up to 129 at a time) as ``(126 + n,
    byte)``, the bytes between as literals of up to 127."""
    a = np.frombuffer(plane, np.uint8)
    n = len(a)
    if n == 0:
        return b""
    first = np.flatnonzero(np.concatenate([[True], a[1:] != a[:-1]]))
    ends = np.append(first[1:], n)
    runlen = ends[np.cumsum(np.isin(np.arange(n), first)) - 1] - np.arange(n)
    at = np.where(runlen >= min_run, np.arange(n), n)
    nxt = np.minimum.accumulate(at[::-1])[::-1].tolist()
    runlen = runlen.tolist()
    out, i = bytearray(), 0
    while i < n:
        if runlen[i] >= min_run:
            k = min(runlen[i], 129)
            out += bytes([126 + k, plane[i]])
            i += k
            continue
        j = min(nxt[i], i + 127)
        out += bytes([j - i]) + plane[i:j]
        i = j
    return bytes(out)


def sgilog_page(codes: np.ndarray, photometric: int) -> np.ndarray:
    """SGILog codes -> the int16 page ``tiff`` writes for them (the sample
    values only carry the codes to ``sgilog_coder``): LogL's 16-bit codes
    as they are; LogLuv's 32- or 24-bit codes as (high 16 bits, low 16
    bits, 0)."""
    c = np.asarray(codes)
    if photometric == 32844:
        return c.astype(np.uint16).view(np.int16)
    return np.stack([(c >> 16).astype(np.uint16), (c & 0xFFFF).astype(
        np.uint16), np.zeros(c.shape, np.uint16)], -1).view(np.int16)


def sgilog_coder(photometric: int, compression: int = 34676,
                 min_run: int = 4):
    """A ``coder`` for ``tiff`` of a ``sgilog_page``: each row of LogL as
    its two byte planes and of LogLuv (34676) as its four, each plane
    ``sgilog_rle``-coded; LogLuv 34677 three bytes a pixel."""
    def code(blk: np.ndarray) -> bytes:
        b = blk.view(np.uint16).astype(np.uint32)
        if photometric == 32844:
            words, shifts = b[..., 0], (8, 0)
        else:
            words, shifts = (b[..., 0] << 16) | b[..., 1], (24, 16, 8, 0)
        if compression == 34677:
            return np.stack([(words >> s) & 255 for s in (16, 8, 0)],
                            -1).astype(np.uint8).tobytes()
        return b"".join(
            sgilog_rle(((row >> s) & 255).astype(np.uint8).tobytes(),
                       min_run)
            for row in words for s in shifts)
    return code


def frame_xyz(u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> float64 X, Y, Z: the samples over 255 taken
    as linear sRGB, each product and sum its own IEEE operation (no matrix
    product, whose order a BLAS chooses)."""
    rgb = u8.astype(np.float64) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return np.stack([0.412453 * r + 0.357580 * g + 0.180423 * b,
                     0.212671 * r + 0.715160 * g + 0.072169 * b,
                     0.019334 * r + 0.119193 * g + 0.950227 * b], -1)


def _log2(a: np.ndarray) -> np.ndarray:
    """log2 of positive values through C's ``log2`` (``math.log2``) on
    each distinct value, the same on every host's numpy."""
    vals, inv = np.unique(a, return_inverse=True)
    return np.array([math.log2(v) for v in vals.tolist()])[inv].reshape(
        a.shape)


def sgilog_codes(xyz: np.ndarray, compression: int = 34676,
                 photometric: int = 32845) -> np.ndarray:
    """Float X, Y, Z (..., 3) -> SGILog codes near them: LogL's
    ``floor(256 (log2 Y + 64))`` (signed), LogLuv 32's with u' and v'
    bytes ``floor(410 u')``, LogLuv 24's ``floor(64 (log2 Y + 12))`` and
    the square of (u', v') in the port's uv table, clamped to it."""
    from underwater_image_enhancement_tpu_torch.utils import sgilog
    f = np.asarray(xyz, np.float64)
    X, Y, Z = f[..., 0], f[..., 1], f[..., 2]
    mag = np.abs(Y)
    lg = _log2(np.where(mag > 0, mag, 1.0))
    den = X + 15.0 * Y + 3.0 * Z
    ok = den > 0
    safe = np.where(ok, den, 1.0)
    u = np.where(ok, 4.0 * X / safe, sgilog._U_NEU)
    v = np.where(ok, 9.0 * Y / safe, sgilog._V_NEU)
    if compression == 34677:
        le = np.where(Y > 0, np.clip(np.floor(64 * (lg + 12)), 0, 1023),
                      0).astype(np.uint32)
        vi = np.clip(np.floor((v - sgilog._UV_VSTART) / sgilog._UV_SQSIZ),
                     0, len(sgilog._NUS) - 1).astype(int)
        nus = np.array(sgilog._NUS)
        start = np.array(sgilog._USTART, np.float32).astype(np.float64)
        ui = np.clip(np.floor((u - start[vi]) / sgilog._UV_SQSIZ), 0,
                     nus[vi] - 1).astype(int)
        ncum = np.concatenate([[0], np.cumsum(nus)[:-1]])
        return (le << 14) | (ncum[vi] + ui).astype(np.uint32)
    le = np.where(Y != 0, np.clip(np.floor(256 * (lg + 64)), 1, 0x7FFF),
                  0).astype(np.uint32) | np.where(Y < 0, 0x8000, 0).astype(
        np.uint32)
    if photometric == 32844:
        return le.astype(np.uint16)
    ub = np.clip(np.floor(410 * u), 0, 255).astype(np.uint32)
    vb = np.clip(np.floor(410 * v), 0, 255).astype(np.uint32)
    return (le << 16) | (ub << 8) | vb
