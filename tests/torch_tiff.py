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
32946) or JPEG (``jpeg=``: a function that codes one chunk).  With
``fill_order=2`` every coded chunk's bits are reversed in each byte, as a
file of FillOrder 2 stores them.  ``tags`` adds or replaces entries:
(type, values), values bytes for the types BYTE, ASCII and UNDEFINED;
None drops the entry.
"""

from __future__ import annotations

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
         block=None) -> bytes:
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
    place of the samples' own."""
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
                    if compression in (6, 7):
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
