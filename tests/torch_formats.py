"""Writers of the simple formats outside ``SUPPORTED_FORMATS`` for the
tests of the port's readers and for ``chip_smoke.py`` (whose machine has
no cv2), numpy + ``struct`` only.  Each writes what a format allows, not
what one encoder does, so that a reader meets the variants cv2 meets:

- ``pnm``: P1-P6, ASCII or binary, any maxval, with a header of any
  whitespace and comments; ``pam``: P7 with any header lines;
  ``pfm``: PF/Pf of either byte order and any scale.
- ``sunras``: a Sun raster header around given rows (``sunras_rows`` pads
  samples to 16 bits), any type, colormap or none; ``sunras_rle`` codes
  bytes as RT_BYTE_ENCODED does (the 0x80 escape).
- ``hdr``: a Radiance header around RGBE quads written flat, as new-style
  RLE scanlines (literals only, or runs wherever two bytes repeat), or
  with old-style ``1 1 1 n`` repeats (``hdr_old_rle``); ``rgbe_float``
  gives the samples a quad stands for, ``rgbe_quads`` the quads of
  samples.
- ``gif``: GIF87a/89a of any frames (global and local tables,
  interlace, offsets, graphic control extensions, other extensions) with
  an LZW coder (``lzw_codes``, ``pack_codes``) that can leave out the
  first clear code and the end code, defer the clear code when the table
  is full, or add codes.
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# netpbm and PFM
# ---------------------------------------------------------------------------


def pnm(code: int, samples: np.ndarray, maxval: int = 255,
        head: bytes = b"P%d\n%d %d\n%s", sep: bytes = b" ") -> bytes:
    """P1-P6 of (H, W) or (H, W, 3) samples in file order.  ``head`` is
    formatted with the code, width, height and maxval (empty for P1 and
    P4); ASCII samples are joined by ``sep``, one row a line."""
    a = np.asarray(samples)
    h, w = a.shape[:2]
    mv = b"" if code in (1, 4) else b"%d\n" % maxval
    out = head % (code, w, h, mv)
    if code == 4:
        return out + np.packbits(a.reshape(h, w) != 0, axis=1).tobytes()
    if code >= 4:
        return out + a.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    rows = a.reshape(h, -1)
    return out + b"\n".join(sep.join(b"%d" % v for v in r)
                            for r in rows.tolist()) + b"\n"


def pam(samples: np.ndarray, maxval: int = 255, tupltype: bytes = None,
        lines: bytes = b"", head: bytes = None) -> bytes:
    """P7 of (H, W, depth) samples; ``lines`` go before ENDHDR, ``head``
    replaces the whole header."""
    a = np.asarray(samples)
    h, w, d = a.shape
    if head is None:
        head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (w, h, d,
                                                                  maxval)
        if tupltype is not None:
            head += b"TUPLTYPE " + tupltype + b"\n"
        head += lines + b"ENDHDR\n"
    return head + a.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def pfm(samples: np.ndarray, scale: bytes = b"-1", head: bytes = None
        ) -> bytes:
    """PF (H, W, 3) or Pf (H, W) float32 samples in RGB order, rows
    written bottom-up, the byte order the scale's sign gives."""
    a = np.asarray(samples, np.float32)
    kind = b"F" if a.ndim == 3 else b"f"
    h, w = a.shape[:2]
    big = not scale.startswith(b"-")
    if head is None:
        head = b"P%s\n%d %d\n%s\n" % (kind, w, h, scale)
    return head + a[::-1].astype(">f4" if big else "<f4").tobytes()


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------

SUN_MAGIC = 0x59A66A95


def sunras_rows(samples: np.ndarray, bits: int) -> bytes:
    """(H, W) indices (1 or 8 bits) or (H, W, C) bytes -> rows padded to
    16 bits."""
    a = np.asarray(samples)
    h = a.shape[0]
    if bits == 1:
        rows = np.packbits(a != 0, axis=1)
    else:
        rows = a.astype(np.uint8).reshape(h, -1)
    out = np.zeros((h, rows.shape[1] + rows.shape[1] % 2), np.uint8)
    out[:, :rows.shape[1]] = rows
    return out.tobytes()


def sunras(body: bytes, width: int, height: int, bits: int, kind: int = 1,
           cmap: np.ndarray = None, maptype: int = None,
           length: int = None) -> bytes:
    """A Sun raster around ``body``: ``cmap`` (N, 3) RGB written as the
    RMT_EQUAL_RGB planes R, G, B."""
    plane = b"" if cmap is None else np.asarray(cmap, np.uint8).T.tobytes()
    if maptype is None:
        maptype = 0 if cmap is None else 1
    return struct.pack(">8I", SUN_MAGIC, width, height, bits,
                       len(body) if length is None else length, kind,
                       maptype, len(plane)) + plane + body


def _runs(a: np.ndarray, most: int):
    """Runs of equal items along the first axis, cut at ``most`` ->
    (starts, lengths)."""
    brk = np.ones(len(a), bool)
    brk[1:] = (a[1:] != a[:-1]).reshape(len(a) - 1, -1).any(1)
    rs = np.flatnonzero(brk)
    rl = np.diff(np.append(rs, len(a)))
    nc = -(-rl // most)
    k = np.arange(nc.sum()) - np.repeat(np.cumsum(nc) - nc, nc)
    return (np.repeat(rs, nc) + most * k,
            np.minimum(most, np.repeat(rl, nc) - most * k))


def sunras_rle(body: bytes) -> bytes:
    """RT_BYTE_ENCODED: a run of 3 or more (at most 256) as ``0x80 n-1
    v``, a lone 0x80 as ``0x80 0``, other bytes as they are."""
    b = np.frombuffer(body, np.uint8)
    starts, lens = _runs(b, 256)
    v = b[starts]
    run = lens >= 3
    size = np.where(run, 3, np.where(v == 0x80, 2 * lens, lens))
    off = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    out[off[run]], out[off[run] + 1], out[off[run] + 2] = (
        0x80, lens[run] - 1, v[run])
    lit = ~run
    k = np.arange(size[lit].sum()) - np.repeat(
        np.cumsum(size[lit]) - size[lit], size[lit])
    out[np.repeat(off[lit], size[lit]) + k] = np.where(
        np.repeat(v[lit], size[lit]) == 0x80, np.where(k % 2, 0, 0x80),
        np.repeat(v[lit], size[lit]))
    return out.tobytes()


# ---------------------------------------------------------------------------
# Radiance HDR
# ---------------------------------------------------------------------------

HDR_HEAD = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n"


def rgbe_float(quads: np.ndarray) -> np.ndarray:
    """(..., 4) R, G, B, E bytes -> (..., 3) float32: ``byte * 2**(E -
    136)``, 0 where E is 0."""
    e = quads[..., 3:].astype(np.float64)
    f = np.where(e > 0, 2.0 ** (e - 136), 0.0)
    return (quads[..., :3] * f).astype(np.float32)


def rgbe_quads(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float32 R, G, B >= 0 -> (..., 4) RGBE bytes as Radiance's
    ``float2rgbe`` codes them: the largest channel's exponent, each
    mantissa ``channel * float32(m * 256 / max)`` truncated; 0 below
    1e-32."""
    rgb = np.asarray(rgb, np.float32)
    v = rgb.max(-1).astype(np.float64)
    live = v >= 1e-32
    m, e = np.frexp(np.where(live, v, 1.0))
    scale = (m * 256.0 / np.where(live, v, 1.0)).astype(np.float32)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = (rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = e + 128
    out[~live] = 0
    return out


def _rle_channel(b: np.ndarray, runs: bool) -> bytes:
    out = bytearray()
    i, n = 0, len(b)
    while i < n:
        j = i
        while runs and j < n and j - i < 127 and b[j] == b[i]:
            j += 1
        if j - i >= 2:
            out += bytes([128 + j - i, b[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (
                runs and j + 1 < n and b[j] == b[j + 1]):
            j += 1
        out += bytes([j - i]) + bytes(b[i:j])
        i = j
    return bytes(out)


def hdr(quads: np.ndarray, mode: str = "flat", head: bytes = None) -> bytes:
    """A Radiance file of (H, W, 4) RGBE quads: ``flat``, or new-style
    RLE scanlines of ``literals`` only or with ``runs``."""
    q = np.asarray(quads, np.uint8)
    h, w = q.shape[:2]
    out = bytearray(HDR_HEAD % (h, w) if head is None else head)
    if mode == "flat":
        return bytes(out) + q.tobytes()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            out += _rle_channel(q[y, :, c], mode == "runs")
    return bytes(out)


def hdr_old_rle(quads: np.ndarray, width: int) -> tuple:
    """Old-style RLE of (N, 4) quads in raster order: a run of equal
    quads becomes the quad and ``1 1 1 n`` repeats (n < 256), the stream
    padded with zero quads to rows of ``width`` -> (file, the stream's
    quads as (H, width, 4), as a flat reader reads them)."""
    q = np.asarray(quads, np.uint8).reshape(-1, 4)
    starts, lens = _runs(q, len(q))
    marks = -(-(lens - 1) // 255)
    first = np.cumsum(1 + marks) - 1 - marks
    stream = np.zeros((int((1 + marks).sum()), 4), np.uint8)
    stream[first] = q[starts]
    k = np.arange(marks.sum()) - np.repeat(np.cumsum(marks) - marks, marks)
    pos = np.repeat(first + 1, marks) + k
    stream[pos, :3] = 1
    stream[pos, 3] = np.minimum(255, np.repeat(lens - 1, marks) - 255 * k)
    h = -(-len(stream) // width)
    flat = np.zeros((h * width, 4), np.uint8)
    flat[:len(stream)] = stream
    flat = flat.reshape(h, width, 4)
    return hdr(flat), flat


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def lzw_codes(indices, min_size: int, clear_first: bool = True,
              end: bool = True, defer_clear: bool = False) -> list:
    """GIF's LZW of an index sequence -> [(code, width)]: the code width
    grows when the next code reaches it, a clear code when the table is
    full (or, ``defer_clear``, the full table kept)."""
    clear = 1 << min_size
    codes, width, table, nxt = [], min_size + 1, {}, clear + 2
    if clear_first:
        codes.append((clear, width))
    seq = np.asarray(indices).reshape(-1).tolist()
    prefix = seq[0]
    for k in seq[1:]:
        code = table.get((prefix, k))
        if code is not None:
            prefix = code
            continue
        codes.append((prefix, width))
        if nxt < 4096:
            table[prefix, k] = nxt
            nxt += 1
            if nxt > 1 << width and width < 12:
                width += 1
        elif not defer_clear:
            codes.append((clear, width))
            table, nxt, width = {}, clear + 2, min_size + 1
        prefix = k
    codes.append((prefix, width))
    if end:
        codes.append((clear + 1, width))
    return codes


def pack_codes(codes) -> bytes:
    """[(code, width)] -> bytes, least significant bit first."""
    out, acc, nbits = bytearray(), 0, 0
    for c, w in codes:
        acc |= c << nbits
        nbits += w
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _table(t, flags: int) -> tuple:
    if t is None:
        return flags, b""
    t = np.asarray(t, np.uint8)
    bits = max(1, (len(t) - 1).bit_length())
    full = np.zeros((1 << bits, 3), np.uint8)
    full[:len(t)] = t
    return flags | 0x80 | (bits - 1), full.tobytes()


INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


def gce(transparent: int = None, disposal: int = 0) -> bytes:
    """A graphic control extension."""
    return bytes([0x21, 0xF9, 4, (disposal & 7) << 2 | (transparent
                                                        is not None),
                  0, 0, transparent or 0, 0])


def gif_image(idx: np.ndarray, left: int = 0, top: int = 0, lct=None,
              interlace: bool = False, min_size: int = None,
              stream: bytes = None, **lzw) -> bytes:
    """An image descriptor, its local table and its LZW data (``stream``
    given, or coded from the (h, w) indices)."""
    idx = np.asarray(idx)
    h, w = idx.shape
    flags, table = _table(lct, 0x40 if interlace else 0)
    if interlace:
        idx = idx[np.concatenate([np.arange(a, h, d) for a, d in INTERLACE])]
    if min_size is None:
        min_size = max(2, int(idx.max()).bit_length())
    if stream is None:
        stream = pack_codes(lzw_codes(idx, min_size, **lzw))
    return (b"\x2c" + struct.pack("<HHHHB", left, top, w, h, flags) + table
            + bytes([min_size]) + sub_blocks(stream))


def gif(width: int, height: int, blocks, gct=None, bg: int = 0,
        version: bytes = b"89a") -> bytes:
    """A GIF of a logical screen, a global table and the given blocks
    (``gif_image``, ``gce`` or other extensions), then the trailer."""
    flags, table = _table(gct, 0x70)
    return (b"GIF" + version + struct.pack("<HHBBB", width, height, flags,
                                           bg, 0)
            + table + b"".join(blocks) + b"\x3b")
