"""Radiance RGBE (``.hdr``/``.pic``) in numpy, after OpenCV's ``rgbe.cpp``
and ``grfmt_hdr.cpp``.  ``decode_hdr`` reads what ``cv2.imdecode`` of cv2
5.0.0 reads, with its samples, and raises ValueError where it gives None;
``encode_hdr`` writes the bytes ``cv2.imencode(".hdr")`` writes for a
uint8 image.

The header: lines (``fgets`` of at most 127 bytes) up to a blank one,
one of them ``FORMAT=32-bit_rle_rgbe``; then ``-Y H +X W`` (``sscanf``'s
whitespace rules; no other orientation).  The pixels: a scanline of 8 to
0x7fff pixels that starts ``2 2`` with the width is new-style RLE (each of
R, G, B, E in turn: a byte past 128 a run of ``b - 128``, else a literal
of ``b`` bytes; a count of 0, or one past the scanline, is refused); any
other scanline start, and every narrower or wider image, is read flat from
there on, four bytes a pixel.  Old-style RLE (``1 1 1 n`` repeats) is not
expanded: cv2 reads those quads as pixels, and so does this.  A sample is
``byte * 2**(e - 136)`` in float32 (0 where e is 0); ``IMREAD_COLOR``
gives ``saturate_cast<uchar>(v * 255)`` (``pxm.float_to_u8``).  Arrays
are in RGB order.

The encoder: cv2's header with ``#?RADIANCE``, the samples ``u8 *
float32(1 / 255)``, each pixel as ``float2rgbe`` gives it (the mantissas
truncated), and ``RGBE_WriteBytes_RLE``'s runs of 4 to 127 and literals of
up to 128 bytes, vectorised over the whole image.
"""

from __future__ import annotations

import re

import numpy as np

from underwater_image_enhancement_tpu_torch.utils.pxm import (
    check_size,
    float_to_u8,
)

_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_SIZE = re.compile(rb"-Y[ \t\n\v\f\r]*([+-]?\d+)[ \t\n\v\f\r]*\+X"
                   rb"[ \t\n\v\f\r]*([+-]?\d+)")


def _fgets(data: bytes, pos: int):
    """C's ``fgets`` into a 128-byte buffer: (line, next position)."""
    if pos >= len(data):
        raise ValueError("RGBE read error")
    nl = data.find(b"\n", pos, pos + 127)
    end = min(len(data), pos + 127 if nl < 0 else nl + 1)
    return data[pos:end], end


def _c_str(line: bytes) -> bytes:
    return line.split(b"\0", 1)[0]


def _header(data: bytes):
    """(width, height, offset of the pixels) of an RGBE file."""
    if not (data.startswith(b"#?RGBE") or data.startswith(b"#?RADIANCE")):
        raise ValueError("not a Radiance HDR file")
    line, pos = _fgets(data, 0)
    has_format = False
    while line[0] not in (0, 10):
        has_format |= _c_str(line) == _FORMAT
        line, pos = _fgets(data, pos)
    if not has_format:
        raise ValueError("RGBE bad file format: missing FORMAT specifier")
    line, pos = _fgets(data, pos)
    m = _SIZE.match(_c_str(line))
    if m is None:
        raise ValueError("RGBE bad file format: missing image size specifier")
    height, width = int(m.group(1)), int(m.group(2))
    if max(abs(height), abs(width)) >= 1 << 31:
        raise ValueError("RGBE: image size too large")
    check_size(width, height)
    return width, height, pos


def _scanline(data: bytes, pos: int, width: int):
    """One new-style RLE scanline after its 4-byte start -> (4, width)
    bytes, next position."""
    out = bytearray()
    for end in range(width, 4 * width + 1, width):
        while len(out) < end:
            if pos + 2 > len(data):
                raise ValueError("RGBE read error")
            count = data[pos]
            if count > 128:
                count -= 128
                if count > end - len(out):
                    raise ValueError("RGBE bad file format: bad scanline data")
                out += data[pos + 1:pos + 2] * count
                pos += 2
            else:
                if count == 0 or count > end - len(out):
                    raise ValueError("RGBE bad file format: bad scanline data")
                if pos + 1 + count > len(data):
                    raise ValueError("RGBE read error")
                out += data[pos + 1:pos + 1 + count]
                pos += 1 + count
    return np.frombuffer(bytes(out), np.uint8).reshape(4, width), pos


def _rgbe_to_float(q: np.ndarray) -> np.ndarray:
    """(..., 4) R, G, B, E bytes -> (..., 3) float32 (``rgbe2float``)."""
    e = q[..., 3].astype(np.int64)
    f = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return q[..., :3].astype(np.float32) * f[..., None]


def decode_hdr(data: bytes, color: bool = False) -> np.ndarray:
    """RGBE bytes -> (H, W, 3) float32 RGB, or with ``color`` uint8
    (module docstring)."""
    width, height, pos = _header(data)
    quads = np.empty((height, width, 4), np.uint8)
    y = 0
    if 8 <= width <= 0x7FFF:
        while y < height:
            start = data[pos:pos + 4]
            if len(start) < 4:
                raise ValueError("RGBE read error")
            if start[0] != 2 or start[1] != 2 or start[2] & 0x80:
                break  # not run-length encoded: flat from here on
            if (start[2] << 8 | start[3]) != width:
                raise ValueError("RGBE bad file format: wrong scanline width")
            planes, pos = _scanline(data, pos + 4, width)
            quads[y] = planes.T
            y += 1
    if y < height:
        n = (height - y) * width * 4
        if pos + n > len(data):
            raise ValueError("RGBE read error")
        quads[y:] = np.frombuffer(data, np.uint8, n, pos).reshape(-1, width, 4)
    img = _rgbe_to_float(quads)
    if not color:
        return img
    with np.errstate(over="ignore"):  # past float32: INT_MIN, then 0
        return float_to_u8(img * np.float32(255))


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float32 R, G, B >= 0 -> (..., 4) bytes (``float2rgbe``)."""
    v = rgb.max(-1)
    live = v.astype(np.float64) >= 1e-32
    safe = np.where(live, v, np.float32(1))
    m, e = np.frexp(safe)
    scale = (m.astype(np.float64) * 256.0 / safe.astype(np.float64)).astype(
        np.float32)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = (rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = (e + 128).astype(np.uint8)
    out[~live] = 0
    return out


def _chunks(starts, lengths, size):
    """Each span cut into chunks of at most ``size`` from the left ->
    (starts, lengths)."""
    nc = -(-lengths // size)
    if (nc == 1).all():
        return starts, lengths
    k = np.arange(nc.sum()) - np.repeat(np.cumsum(nc) - nc, nc)
    return (np.repeat(starts, nc) + size * k,
            np.minimum(size, np.repeat(lengths, nc) - size * k))


def _pieces(flat: np.ndarray, width: int):
    """The runs ``RGBE_WriteBytes_RLE`` steps through, rows of ``width``
    each: maximal runs of equal bytes, cut into pieces of at most 127 from
    the left -> (starts, lengths)."""
    brk = np.ones(flat.size, bool)
    brk[1:] = flat[1:] != flat[:-1]
    brk[::width] = True
    rs = np.flatnonzero(brk)
    rl = np.diff(np.append(rs, flat.size))
    cut = np.flatnonzero(rl > 127)  # few: split only these
    if cut.size == 0:
        return rs, rl
    more = (rl[cut] - 1) // 127
    k = 1 + np.arange(more.sum()) - np.repeat(np.cumsum(more) - more, more)
    at = np.repeat(cut + 1, more)
    tail = np.repeat(rl[cut], more) - 127 * k
    rl[cut] = 127
    return (np.insert(rs, at, np.repeat(rs[cut], more) + 127 * k),
            np.insert(rl, at, np.minimum(127, tail)))


def _rle(planes: np.ndarray) -> bytes:
    """(H, 4, W) bytes -> the scanlines ``RGBE_WritePixels_RLE`` writes:
    each scanline's ``2 2 W`` start, then R, G, B and E, each run-length
    encoded on its own."""
    height, _, width = planes.shape
    flat = planes.reshape(-1)
    ps, pl = _pieces(flat, width)
    long_ = pl >= 4
    seg = ps // width
    # a gap: the short pieces between two long ones (or a row's ends)
    gstart = ~long_
    gstart[1:] &= long_[:-1] | (seg[1:] != seg[:-1])
    gid = np.cumsum(gstart) - 1
    first = np.flatnonzero(gstart)
    g_pos = ps[first]
    g_len = np.bincount(gid[~long_], pl[~long_], len(first)).astype(np.int64)
    g_cnt = np.bincount(gid[~long_], None, len(first))
    g_run = (g_cnt == 1) & (pl[first] >= 2)  # one short run of 2 or 3
    c_pos, c_len = _chunks(g_pos[~g_run], g_len[~g_run], 128)
    r_pos = np.concatenate([ps[long_], g_pos[g_run]])
    r_len = np.concatenate([pl[long_], g_len[g_run]])
    pos = np.concatenate([r_pos, c_pos])
    size = np.concatenate([np.full(r_pos.size, 2), 1 + c_len])
    order = np.argsort(pos, kind="stable")
    pos_s = pos[order]
    line = 4 * width
    off_s = np.cumsum(size[order]) - size[order] + 4 * (pos_s // line + 1)
    off = np.empty_like(off_s)
    off[order] = off_s
    out = np.empty(int(size.sum()) + 4 * height, np.uint8)
    heads = np.searchsorted(pos_s, np.arange(height) * line)
    before = np.concatenate([[0], np.cumsum(size[order])])[heads]
    h_off = before + 4 * np.arange(height)
    for j, b in enumerate((2, 2, width >> 8, width & 0xFF)):
        out[h_off + j] = b
    ro, co = off[:r_pos.size], off[r_pos.size:]
    out[ro] = 128 + r_len
    out[ro + 1] = flat[r_pos]
    out[co] = c_len
    k = np.arange(c_len.sum()) - np.repeat(np.cumsum(c_len) - c_len, c_len)
    out[np.repeat(co + 1, c_len) + k] = flat[np.repeat(c_pos, c_len) + k]
    return out.tobytes()


def encode_hdr(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> cv2's ``.hdr`` bytes (module docstring)."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f".hdr: an (H, W, 3) uint8 RGB image, not "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape[:2]
    quads = _float_to_rgbe(a.astype(np.float32)
                           * (np.float32(1) / np.float32(255)))
    head = b"#?RADIANCE\n%s\n-Y %d +X %d\n" % (_FORMAT, h, w)
    if w < 8 or w > 0x7FFF:
        return head + quads.tobytes()
    return head + _rle(np.ascontiguousarray(quads.transpose(0, 2, 1)))
