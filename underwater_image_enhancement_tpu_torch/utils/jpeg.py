"""A baseline JPEG codec in numpy: a decoder bit-equal to libjpeg-turbo's
default decompression (what ``cv2.imread`` returns for these files), and
``encode_jpeg``, which writes the bytes ``cv2.imwrite`` writes with its
defaults (see its docstring).

Covers sequential Huffman JPEG (SOF0 baseline and SOF1 extended), 8-bit,
with 1 or 3 components, any sampling factors whose ratios libjpeg
upsamples (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and the like), restart
intervals, one or several scans.  Anything else (progressive or arithmetic
coding, 12 bits, lossless, CMYK) raises ``Unsupported``.  A file cut short
in its entropy-coded data decodes as ``cv2.imread`` decodes it (libjpeg
pads the data with zero bits and leaves the MCUs after the one in progress
grey); one cut short before its first scan's data raises ValueError.

The arithmetic is libjpeg's, integer for integer:

- the ``islow`` inverse DCT (``jidctint.c``: CONST_BITS 13, PASS1_BITS 2)
  with the int16 lanes of libjpeg-turbo's x86 SIMD version, which cv2
  runs: wrapping dequantisation and sums, saturating passes and samples;
- fancy upsampling (``jdsample.c``): the h2v1 and h2v2 triangle filters
  with their biases (box replication where the component is at most 2
  samples wide), libjpeg-turbo's h1v2 filter, replication for other
  integral factors; rows above the first and below the last repeat them;
- YCbCr to RGB with the fixed-point tables of ``jdcolor.c`` (SCALEBITS
  16); three components are RGB, not YCbCr, where an Adobe APP14 marker
  (and no JFIF one) says transform 0 or the component ids are 'R', 'G',
  'B' (``jdapimin.c``).

The entropy decoding runs in Python, one table lookup a symbol: a 16-bit
lookahead table gives each code's length and symbol (libjpeg's lookahead,
widened to every code length), and a window of 32 bits at the bit
position gives the code and its extra bits in one read.  Everything after
it (dequantisation, the IDCT, upsampling, colour) is vectorised.
"""

from __future__ import annotations

import struct

import numpy as np


class Unsupported(ValueError):
    """A file that cv2 reads and this package's decoders do not."""


ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {
    0xC2: "progressive JPEG (SOF2)", 0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)", 0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded JPEG (SOF10)", 0xCB: "lossless JPEG (SOF11)",
    0xCD: "arithmetic-coded JPEG (SOF13)", 0xCE: "arithmetic-coded JPEG (SOF14)",
    0xCF: "arithmetic-coded JPEG (SOF15)",
}


# ---------------------------------------------------------------------------
# Entropy decoding
# ---------------------------------------------------------------------------

def _huffman_lut(counts, symbols, ac: bool):
    """The 65536-entry lookahead tables of a Huffman table, indexed by the
    next 16 bits of the stream.  ``slow[peek]`` = (code length << 8) |
    symbol for the code that ``peek`` starts with (0 where none does).
    ``fast[peek]`` = (bits to advance, run, value) where the code and its
    extra bits fit in the 16 (the value sign-extended as libjpeg's
    HUFF_EXTEND; run 15 and value 0 for ZRL, run 64 for EOB, the run 0 for
    DC), or (0, 0, 0) where they do not."""
    slow = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            slow[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    peek = np.arange(1 << 16, dtype=np.int64)
    n, rs = slow >> 8, slow & 255
    size = rs & 15 if ac else rs
    adv = n + size
    ok = (slow != 0) & (adv <= 16)
    raw = (peek >> np.maximum(16 - adv, 0)) & ((1 << size) - 1)
    val = np.where((size > 0) & (raw < (1 << np.maximum(size - 1, 0))),
                   raw - ((1 << size) - 1), raw)
    run = np.zeros_like(rs)
    if ac:
        run = np.where(size > 0, rs >> 4, np.where(rs == 0xF0, 15, 64))
    fast = list(zip(np.where(ok, adv, 0).tolist(), np.where(ok, run, 0).tolist(),
                    np.where(ok, val, 0).tolist()))
    return fast, slow.tolist()


# zero bytes past a segment's end: one block (at most 64 symbols of at
# most 32 bits) started inside the segment reads no window past them
_TAIL = 256


def _windows(seg: bytes) -> list:
    """win[p] = the 40 bits of bytes p..p+4 of the segment (zeros past its
    end, as libjpeg reads past a marker), as Python ints, for every p up
    to ``_TAIL`` bytes past the end."""
    b = np.frombuffer(seg + bytes(_TAIL + 8), np.uint8).astype(np.int64)
    n = len(seg) + _TAIL + 1
    w = np.zeros(n, np.int64)
    for k in range(5):
        w = (w << 8) | b[k:k + n]
    return w.tolist()


_ZERO_WINDOWS = [0] * (_TAIL + 1)


def _unstuff(data: bytes) -> bytes:
    return data.replace(b"\xff\x00", b"\xff")


def _slow_symbol(win, pos, slow, ac):
    """(bits to advance, run, value) of the symbol at ``pos`` whose code
    and extra bits take more than 16 bits: from a 32-bit window."""
    bits = (win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFFFFFF
    e = slow[bits >> 16]
    if not e:
        raise ValueError("corrupt JPEG: bad Huffman code")
    n, rs = e >> 8, e & 255
    s = rs & 15 if ac else rs
    v = (bits >> (32 - n - s)) & ((1 << s) - 1) if s else 0
    if s and v < 1 << (s - 1):
        v -= (1 << s) - 1
    if not ac:
        return n + s, 0, v
    return n + s, (rs >> 4) if s else (15 if rs == 0xF0 else 64), v


def _decode_segment(seg, order, per_mcu, comps, coef_idx, coef_val) -> bool:
    """Decode the blocks ``order`` [(component, block index)] of one
    restart interval, ``per_mcu`` blocks an MCU, appending each nonzero
    coefficient's (flat index, value) to the two lists.  Where the blocks
    need more bits than the segment holds (a truncated file), decode as
    libjpeg does (``jdhuff.c``): the MCU in progress reads zero bits, and
    the later MCUs stay zero.  Returns whether the data ran out."""
    win, nbits = _windows(seg), 8 * len(seg)
    pos = 0
    pred = [0] * len(comps)
    append_i, append_v = coef_idx.append, coef_val.append
    for j, (ci, base) in enumerate(order):
        if pos > nbits:
            if j % per_mcu == 0:
                return True
            # the rest of the MCU reads zero bits only
            win, pos, nbits = _ZERO_WINDOWS, 0, -1
        (dc_fast, dc_slow), (ac_fast, ac_slow), out_base = comps[ci]
        adv, _, diff = dc_fast[(win[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
        if not adv:
            adv, _, diff = _slow_symbol(win, pos, dc_slow, False)
        pos += adv
        dc = pred[ci] = pred[ci] + diff
        flat = out_base + base * 64
        if dc:
            append_i(flat)
            append_v(dc)
        k = 1
        while k < 64:
            adv, run, v = ac_fast[(win[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
            if not adv:
                adv, run, v = _slow_symbol(win, pos, ac_slow, True)
            pos += adv
            k += run
            if v:  # a run past the block's end lands on its last position,
                # as in libjpeg (jpeg_natural_order's 16 extra entries)
                append_i(flat + min(k, 63))
                append_v(v)
            k += 1
    return pos > nbits


# ---------------------------------------------------------------------------
# The inverse DCT (jpeg_idct_islow as libjpeg-turbo's x86 SIMD code runs it)
# ---------------------------------------------------------------------------

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _wrap16(v):
    """The low 16 bits of ``v`` as a signed value (an int16 store)."""
    return ((v + 32768) & 0xFFFF) - 32768


def _idct_1d(c, shift):
    """One pass of jpeg_idct_islow on the eight int16 inputs c[0..7]
    (arrays of equal shape) -> the eight outputs, each DESCALEd by
    ``shift`` and saturated to int16.  The products are exact; the sums
    in0 +- in4, in7 + in3 and in5 + in1 wrap at 16 bits, where the SIMD
    code adds int16 lanes (jidctint-avx2.asm, jidctint-sse2.asm)."""
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = _wrap16(c[0] + c[4]) << CONST_BITS
    tmp1 = _wrap16(c[0] - c[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, _wrap16(t0 + t2), _wrap16(t1 + t3)
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    outs = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return [np.clip((o + half) >> shift, -32768, 32767) for o in outs]


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(B, 64) natural-order coefficients and a (64,) natural-order
    quantisation table -> (B, 8, 8) uint8 samples, as libjpeg-turbo's x86
    SIMD jpeg_idct_islow computes them (what cv2 runs): int16
    coefficients and products of the quantisation (wrapping), int16
    passes (saturating), and the samples saturated to [0, 255] where the C
    code's range-limit table would wrap.  On the data an encoder writes
    the two agree; on the garbage a truncated file decodes to they do
    not."""
    c = _wrap16(coefs.astype(np.int64)).reshape(-1, 8, 8)
    deq = _wrap16(c * quant.astype(np.int64).reshape(8, 8))
    # pass 1: columns (inputs deq[:, k, :], k the vertical frequency); a
    # block with no coefficient beyond its first row takes the SIMD code's
    # shortcut, row 0 << PASS1_BITS in int16
    ws = np.stack(_idct_1d([deq[:, k, :] for k in range(8)],
                           CONST_BITS - PASS1_BITS), axis=1)
    flat = ~c[:, 1:, :].any(axis=(1, 2))
    ws[flat] = _wrap16(deq[flat, :1, :] << PASS1_BITS)
    # pass 2: rows (inputs ws[:, :, j]), then the samples
    out = _idct_1d([ws[:, :, j] for j in range(8)],
                   CONST_BITS + PASS1_BITS + 3)
    return (np.clip(np.stack(out, axis=2), -128, 127) + 128).astype(np.uint8)


# ---------------------------------------------------------------------------
# Upsampling (jdsample.c) and colour (jdcolor.c)
# ---------------------------------------------------------------------------

def _upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component plane (dh, dw) uint8 upsampled by (fv, fh) as libjpeg
    does with fancy upsampling on."""
    if fh == 1 and fv == 1:
        return p
    x = p.astype(np.int32)
    dh, dw = x.shape
    if fh == 2 and fv == 1 and dw > 2:  # h2v1_fancy_upsample
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        out = np.empty((dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    if fh == 1 and fv == 2:  # h1v2_fancy_upsample (libjpeg-turbo)
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * dh, dw), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out.astype(np.uint8)
    if fh == 2 and fv == 2 and dw > 2:  # h2v2_fancy_upsample
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * dh, 2 * dw), np.int32)
        for v, near in ((0, up), (1, down)):
            cs = 3 * x + near  # column sums
            left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            out[v::2, 0::2] = (3 * cs + left + 8) >> 4
            out[v::2, 1::2] = (3 * cs + right + 7) >> 4
        return out.astype(np.uint8)
    # h2v1_upsample, h2v2_upsample and int_upsample: replication
    return np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table, indexed by the u8 sample."""
    scale = 16
    half = 1 << (scale - 1)

    def fix(v):
        return int(v * (1 << scale) + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + half) >> scale
    cb_b = (fix(1.77200) * x + half) >> scale
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert on u8 planes -> (H, W, 3) uint8 RGB."""
    yi = y.astype(np.int64)
    r = yi + _CR_R[cr]
    g = yi + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = yi + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# The file
# ---------------------------------------------------------------------------

def _scan_end(data: bytes, pos: int) -> int:
    """Offset of the marker that ends the entropy-coded data at ``pos``
    (not a stuffed 0xFF00 and not a restart marker), or of the file's end.
    0xFF bytes at the very end are no data: libjpeg reads them as the
    fill bytes of the EOI marker it supplies at the end of the file."""
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            return len(data)
        if pos + 1 >= len(data):
            return pos
        nxt = data[pos + 1]
        if nxt == 0x00 or 0xD0 <= nxt <= 0xD7:
            pos += 2
        elif nxt == 0xFF:
            pos += 1
        else:
            return pos


def _split_restarts(data: bytes) -> list:
    """The restart intervals of an entropy-coded segment, unstuffed."""
    parts, start, pos = [], 0, 0
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            break
        if 0xD0 <= data[pos + 1] <= 0xD7:
            parts.append(data[start:pos])
            start = pos = pos + 2
        else:
            pos += 2
    parts.append(data[start:])
    return [_unstuff(p) for p in parts]


class _Frame:
    """SOF, and the coefficients of every component in one flat array (in
    zigzag order within a block; component k's blocks from offset[k])."""

    def __init__(self, body: bytes):
        prec, self.H, self.W, nc = struct.unpack(">BHHB", body[:6])
        if len(body) < 6 + 3 * nc:
            raise ValueError("corrupt JPEG: short frame header")
        if prec != 8:
            raise Unsupported(f"{prec}-bit JPEG")
        if nc not in (1, 3):
            raise Unsupported(f"JPEG with {nc} components"
                              + (" (CMYK or YCCK)" if nc == 4 else ""))
        if self.H == 0 or self.W == 0:
            raise Unsupported("JPEG with its height in a DNL marker")
        # (id, h, v, quantisation table) a component
        self.comps = [(body[6 + 3 * k], body[7 + 3 * k] >> 4,
                       body[7 + 3 * k] & 15, body[8 + 3 * k])
                      for k in range(nc)]
        if any(not (1 <= h <= 4 and 1 <= v <= 4) for _, h, v, _ in self.comps):
            raise ValueError("corrupt JPEG: sampling factor out of range")
        self.hmax = max(c[1] for c in self.comps)
        self.vmax = max(c[2] for c in self.comps)
        self.mcus_x = -(-self.W // (8 * self.hmax))
        self.mcus_y = -(-self.H // (8 * self.vmax))
        # blocks a row and a column of each component's array
        self.blocks = [(self.mcus_y * v, self.mcus_x * h)
                       for _, h, v, _ in self.comps]
        sizes = [by * bx * 64 for by, bx in self.blocks]
        self.offset = np.cumsum([0] + sizes)[:-1].tolist()
        self.coef = np.zeros(sum(sizes), np.int64)

    def comp_size(self, k: int):
        """libjpeg's downsampled_height, downsampled_width of component k."""
        _, h, v, _ = self.comps[k]
        return (-(-self.H * v // self.vmax), -(-self.W * h // self.hmax))

    def scan_order(self, members):
        """(component, block index) of each block of a scan of the
        components ``members``, in coding order, and the blocks an MCU."""
        if len(members) == 1:  # non-interleaved: the component's own blocks
            k = members[0]
            dh, dw = self.comp_size(k)
            bx = self.blocks[k][1]
            by_n, bx_n = -(-dh // 8), -(-dw // 8)
            blk = (np.arange(by_n)[:, None] * bx + np.arange(bx_n)).ravel()
            return [(k, int(b)) for b in blk], 1
        per_mcu = []  # (component, block row, block col) within an MCU
        for k in members:
            _, h, v, _ = self.comps[k]
            per_mcu += [(k, y, x) for y in range(v) for x in range(h)]
        order = []
        for my in range(self.mcus_y):
            for mx in range(self.mcus_x):
                for k, y, x in per_mcu:
                    _, h, v, _ = self.comps[k]
                    order.append(
                        (k, (my * v + y) * self.blocks[k][1] + mx * h + x))
        return order, len(per_mcu)


def _decode_scan(frame: _Frame, header: bytes, entropy: bytes, restart: int,
                 dc_tabs, ac_tabs) -> None:
    ns = header[0] if header else 0
    if ns == 0 or len(header) < 4 + 2 * ns:
        raise ValueError("corrupt JPEG: short scan header")
    ids = [c[0] for c in frame.comps]
    members, luts = [], [None] * len(frame.comps)
    for j in range(ns):
        cid, tables = header[1 + 2 * j], header[2 + 2 * j]
        if cid not in ids:
            raise ValueError("corrupt JPEG: scan of an unknown component")
        k = ids.index(cid)
        members.append(k)
        if tables >> 4 not in dc_tabs or tables & 15 not in ac_tabs:
            raise ValueError("corrupt JPEG: missing Huffman table")
        luts[k] = (dc_tabs[tables >> 4], ac_tabs[tables & 15],
                   frame.offset[k])
    order, per_mcu = frame.scan_order(members)
    per = (restart * per_mcu) if restart else len(order)
    segs = _split_restarts(entropy)
    # libjpeg's out-of-data flag: set where an MCU needs bits past its
    # segment's end, cleared by a restart marker.  An interval whose
    # marker never came reads zero bits until the flag is set; once it is
    # set with no marker to come, every later MCU of the scan stays zero.
    out = False
    for r, start in enumerate(range(0, len(order), per)):
        if r < len(segs):
            out = False
        elif out:
            break
        idx, val = [], []
        out = _decode_segment(segs[r] if r < len(segs) else b"",
                              order[start:start + per], per_mcu, luts, idx,
                              val)
        frame.coef[np.asarray(idx, np.int64)] = val


def _color_space(frame: _Frame, jfif: bool, adobe_transform) -> str:
    """jdapimin.c default_decompress_parms for 3 components."""
    if jfif:
        return "ycc"
    if adobe_transform is not None:
        return "rgb" if adobe_transform == 0 else "ycc"
    ids = tuple(c[0] for c in frame.comps)
    return "rgb" if ids == (82, 71, 66) else "ycc"


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W) uint8 gray or (H, W, 3) uint8 RGB, as libjpeg
    decompresses them by default.  Raises ``Unsupported`` for files outside
    this decoder's scope, ValueError for corrupt ones."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    qt, dc_tabs, ac_tabs = {}, {}, {}
    frame, restart, jfif, adobe_transform = None, 0, False, None
    scanned = False
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError("corrupt JPEG: expected a marker")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > len(data):
            raise ValueError("corrupt JPEG: truncated marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        short = pos + length - len(data)
        if marker == 0xDA and 0 < short <= 3:
            # cut in the scan's Ss, Se and Ah/Al, which a sequential
            # decoder ignores (libjpeg warns): libjpeg's file source
            # supplies FF D9 again and again past the end, so these bytes
            # are read from that, and an odd count leaves a D9 as data
            data += b"\xff\xd9\xff\xd9"[:short] + b"\xd9" * (short % 2)
        if length < 2 or pos + length > len(data):
            raise ValueError("corrupt JPEG: truncated marker segment")
        body = data[pos + 2:pos + length]
        pos += length
        if marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDB:
            p = 0
            while p < len(body):
                wide = body[p] >> 4
                n = 128 if wide else 64
                if p + 1 + n > len(body):
                    raise ValueError("corrupt JPEG: short quantisation table")
                vals = np.frombuffer(body[p + 1:p + 1 + n],
                                     ">u2" if wide else np.uint8)
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                qt[body[p] & 15] = q
                p += 1 + n
        elif marker == 0xC4:
            p = 0
            while p < len(body):
                counts = list(body[p + 1:p + 17])
                n = sum(counts)
                if p + 17 + n > len(body):
                    raise ValueError("corrupt JPEG: short Huffman table")
                ac = bool(body[p] >> 4)
                lut = _huffman_lut(counts, list(body[p + 17:p + 17 + n]), ac)
                (ac_tabs if ac else dc_tabs)[body[p] & 15] = lut
                p += 17 + n
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker in (0xC0, 0xC1):
            frame = _Frame(body)
        elif marker in _SOF_NAMES:
            raise Unsupported(_SOF_NAMES[marker])
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: SOS before SOF")
            stop = _scan_end(data, pos)
            _decode_scan(frame, body, data[pos:stop], restart, dc_tabs,
                         ac_tabs)
            pos, scanned = stop, True
    if frame is None:
        raise ValueError("corrupt JPEG: no frame")
    if not scanned:  # libjpeg: "JPEG datastream contains no image"
        raise ValueError("corrupt JPEG: no scan")
    planes = []
    for k, (_, h, v, tq) in enumerate(frame.comps):
        if tq not in qt:
            raise ValueError("corrupt JPEG: missing quantisation table")
        by, bx = frame.blocks[k]
        off = frame.offset[k]
        zz = frame.coef[off:off + by * bx * 64].reshape(-1, 64)
        nat = np.empty_like(zz)
        nat[:, ZIGZAG] = zz
        px = idct_islow(nat, qt[tq]).reshape(by, bx, 8, 8)
        px = px.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        dh, dw = frame.comp_size(k)
        fh, fv = frame.hmax // h, frame.vmax // v
        if frame.hmax % h or frame.vmax % v:
            raise Unsupported("JPEG with fractional sampling ratios")
        planes.append(_upsample(px[:dh, :dw], fh, fv)[:frame.H, :frame.W])
    if len(planes) == 1:
        return planes[0]
    if _color_space(frame, jfif, adobe_transform) == "rgb":
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)


# ---------------------------------------------------------------------------
# Encoding: cv2.imwrite's defaults (libjpeg-turbo, baseline, quality 95,
# 4:2:0, the islow forward DCT, the standard Huffman tables)
# ---------------------------------------------------------------------------

# jcparam.c's base tables (natural order) and Annex K's Huffman tables as
# (code counts by length 1..16, symbols)
_STD_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
              92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
              100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
             + [99] * 32),
)
_AC_SYMBOLS_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_SYMBOLS_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
_HUFFMAN = {  # (class, table id) -> (counts, symbols); class 0 DC, 1 AC
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
             _AC_SYMBOLS_LUMA),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
             _AC_SYMBOLS_CHROMA),
}


def _huffman_codes(counts, symbols):
    """The canonical codes of a table: (code by symbol, length by symbol),
    256 entries each (0 where the symbol has no code)."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


QUALITY = 95  # cv2.imwrite's IMWRITE_JPEG_QUALITY default


def _quality_tables():
    """jcparam.c jpeg_set_quality(QUALITY, force_baseline=TRUE): the two
    (64,) natural-order tables, jcparam's scale (200 - 2 * quality) in
    percent, clamped to 1..255."""
    scale = 200 - 2 * QUALITY
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in _STD_QUANT)


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c rgb_ycc_convert on (H, W, 3) uint8 -> Y, Cb, Cr int64
    planes: the fixed-point tables (16 scale bits), Y rounded by ONE_HALF,
    Cb and Cr by ONE_HALF - 1 about their 128 offset."""
    def fix(v):
        return int(v * 65536 + 0.5)

    r, g, b = (rgb[..., c].astype(np.int64) for c in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b
          + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b
          + offset + half - 1) >> 16
    return y, cb, cr


def _edge(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """A plane expanded to (h, w) by repeating its last row and column."""
    return np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])), mode="edge")


def _h2v2_downsample(p: np.ndarray) -> np.ndarray:
    """jcsample.c h2v2_downsample: 2x2 sums plus a bias that alternates 1,
    2 along each output row, shifted down by 2."""
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = 1 + (np.arange(s.shape[1]) & 1)
    return (s + bias) >> 2


def _fdct_1d(d, first: bool):
    """One pass of jfdctint.c jpeg_fdct_islow over the eight inputs d[0..7]
    (arrays of equal shape): pass 1 (``first``) scales by 2**PASS1_BITS,
    pass 2 takes it off again."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS

    def descale(x, n=shift):
        return (x + (1 << (n - 1))) >> n

    out = [None] * 8
    if first:
        out[0], out[4] = (tmp10 + tmp11) << PASS1_BITS, (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out[2] = descale(z1 + tmp13 * FIX_0_765366865)
    out[6] = descale(z1 - tmp12 * FIX_1_847759065)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    out[7] = descale(tmp4 + z1 + z3)
    out[5] = descale(tmp5 + z2 + z4)
    out[3] = descale(tmp6 + z2 + z3)
    out[1] = descale(tmp7 + z1 + z4)
    return out


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """(B, 8, 8) int samples less 128 -> (B, 8, 8) natural-order
    coefficients scaled up by 8, as jpeg_fdct_islow leaves them."""
    d = samples.astype(np.int64)
    rows = np.stack(_fdct_1d([d[:, :, k] for k in range(8)], True), axis=2)
    return np.stack(_fdct_1d([rows[:, k, :] for k in range(8)], False),
                    axis=1)


def _quantize(coefs: np.ndarray, table: np.ndarray) -> np.ndarray:
    """jcdctmgr.c quantize on (B, 64) natural-order coefficients: the
    divisor q * 8 as compute_reciprocal's reciprocal, correction and shift,
    |x| rounded half up and the sign put back."""
    recip, corr, shift = [], [], []
    for q in table.tolist():
        div = int(q) << 3
        r = 16 + div.bit_length() - 1
        fq, fr = divmod(1 << r, div)
        c = div // 2
        if fr == 0:  # a power of two
            fq, r = fq >> 1, r - 1
        elif fr <= div // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    a = ((np.abs(coefs) + np.array(corr)) * np.array(recip)) >> np.array(shift)
    return np.where(coefs < 0, -a, a)


def _category(v: np.ndarray) -> np.ndarray:
    """The bit length of |v| (the Huffman category), 0 for 0."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def pack_msb(values: np.ndarray, lengths: np.ndarray) -> tuple:
    """Codes of up to 32 bits (``values``, each ``lengths`` bits long)
    packed first bit first -> (bytes of the whole bits, the bits left
    over in the last partial byte as (value, count))."""
    values = values.astype(np.int64)
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    start = np.cumsum(lengths) - lengths
    byte, off = start >> 3, start & 7
    # each code aligned in a 40-bit window at its first byte
    win = values << (40 - off - lengths)
    n = (total + 7) >> 3
    out = np.zeros(n + 5, np.int64)
    for k in range(5):
        out += np.bincount(byte + k, weights=(win >> (32 - 8 * k)) & 255,
                           minlength=n + 5).astype(np.int64)
    full = total >> 3
    rest = total & 7
    return (out[:full].astype(np.uint8).tobytes(),
            (int(out[full]) >> (8 - rest) if rest else 0, rest))


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8h, 8w) -> (h, w, 8, 8)."""
    h, w = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(h, 8, w, 8).transpose(0, 2, 1, 3)


def _coefficients(rgb: np.ndarray, tables) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> the quantised coefficients of each MCU's six
    blocks (four Y, Cb, Cr) in scan order, (MCUs * 6, 64) zigzag."""
    H, W = rgb.shape[:2]
    mx, my = -(-W // 16), -(-H // 16)  # MCUs a row, MCU rows
    wb, hb = -(-W // 8), -(-H // 8)  # Y blocks with samples
    y, cb, cr = _rgb_to_ycc(rgb)
    # Y: the real blocks, then the dummies of the last MCU column and row
    yq = np.zeros((2 * my, 2 * mx, 64), np.int64)
    blocks = _blocks(_edge(y, 8 * hb, 8 * wb) - 128).reshape(-1, 8, 8)
    yq[:hb, :wb] = _quantize(fdct_islow(blocks).reshape(-1, 64),
                             tables[0]).reshape(hb, wb, 64)
    if wb % 2:
        yq[:hb, wb, 0] = yq[:hb, wb - 1, 0]
    if hb % 2:
        yq[hb, :, 0] = np.repeat(yq[hb - 1, 1::2, 0], 2)
    mcus = [yq.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4)
            .reshape(my, mx, 4, 64)]
    for p in (cb, cr):
        # the rows to a whole row pair and the columns to whole MCUs, then
        # the downsampled plane's last row repeated to whole MCUs
        sub = _h2v2_downsample(_edge(p, H + H % 2, 16 * mx))
        sub = _edge(sub, 8 * my, 8 * mx) - 128
        q = _quantize(fdct_islow(_blocks(sub).reshape(-1, 8, 8))
                      .reshape(-1, 64), tables[1])
        mcus.append(q.reshape(my, mx, 1, 64))
    return np.concatenate(mcus, axis=2)[..., ZIGZAG].reshape(-1, 64)


def _entropy_codes(coef: np.ndarray) -> tuple:
    """The scan's codes, each a Huffman code followed by its extra bits:
    (values, bit lengths).  A block's symbols take ``count`` slots from
    ``base``: its DC difference (from the component's previous block),
    each nonzero AC after its run of zeros (a run of 16 or more sends a
    ZRL symbol for each 16 first), an EOB where the block ends in zeros.
    Y blocks take table 0, Cb and Cr table 1."""
    nblk = coef.shape[0]
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), nblk // 6)
    dc = coef[:, 0]
    diff = np.empty_like(dc)
    for c in range(3):
        diff[comp == c] = np.diff(dc[comp == c], prepend=0)
    blk, pos = np.nonzero(coef[:, 1:])
    pos = pos + 1
    first = np.ones(blk.size, bool)
    first[1:] = blk[1:] != blk[:-1]
    run = pos - np.where(first, 0, np.concatenate([[0], pos[:-1]])) - 1
    zrl = run >> 4
    slots = zrl + 1
    last = np.zeros(nblk, np.int64)
    last[blk] = pos  # row-major order: the block's last nonzero writes last
    count = (1 + np.bincount(blk, weights=slots, minlength=nblk)
             .astype(np.int64) + (last < 63))
    base = np.cumsum(count) - count
    total = int(count.sum())
    # the slots left unset are the EOBs: AC symbol 0, no extra bits
    sym = np.zeros(total, np.int64)
    extra = np.zeros(total, np.int64)
    nbits = np.zeros(total, np.int64)
    is_ac = np.ones(total, bool)
    cat = _category(diff)
    sym[base], nbits[base], is_ac[base] = cat, cat, False
    extra[base] = np.where(diff < 0, diff + (1 << cat) - 1, diff)
    cum = np.cumsum(slots)
    block_cum = np.zeros(nblk, np.int64)  # the slots before a block's ACs
    block_cum[blk[first]] = (cum - slots)[first]
    at = base[blk] + cum - block_cum[blk]
    v = coef[blk, pos]
    cat = _category(v)
    sym[at], nbits[at] = ((run & 15) << 4) | cat, cat
    extra[at] = np.where(v < 0, v + (1 << cat) - 1, v)
    sym[np.repeat(at - zrl, zrl) + np.arange(int(zrl.sum()))
        - np.repeat(np.cumsum(zrl) - zrl, zrl)] = 0xF0
    hcode = np.zeros(total, np.int64)
    hlen = np.zeros(total, np.int64)
    table = np.minimum(comp, 1)[np.repeat(np.arange(nblk), count)]
    for (kind, t), (counts, symbols) in _HUFFMAN.items():
        sel = (is_ac == bool(kind)) & (table == t)
        code, length = _huffman_codes(counts, symbols)
        hcode[sel], hlen[sel] = code[sym[sel]], length[sym[sel]]
    return (hcode << nbits) | extra, hlen + nbits


def _headers(H: int, W: int, tables) -> bytes:
    """SOI, the JFIF APP0, a DQT a table, SOF0, a DHT a table (DC and AC
    of table 0, then of table 1) and the SOS, as libjpeg writes them."""
    head = [b"\xff\xd8",
            _segment(0xE0, b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 0, 1,
                                                     1, 0, 0))]
    for t, tq in enumerate(tables):
        head.append(_segment(0xDB, bytes([t]) + tq[ZIGZAG].astype(np.uint8)
                             .tobytes()))
    head.append(_segment(0xC0, struct.pack(">BHHB", 8, H, W, 3)
                         + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for t in (0, 1):
        for kind in (0, 1):
            counts, symbols = _HUFFMAN[(kind, t)]
            head.append(_segment(0xC4, bytes([(kind << 4) | t])
                                 + bytes(counts) + symbols))
    head.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                      0])))
    return b"".join(head)


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the JPEG file ``cv2.imwrite`` writes for the
    BGR image with its defaults (libjpeg-turbo: baseline, quality 95,
    4:2:0, JFIF 1.01 with a 1:1 density, no restart markers).

    As libjpeg computes it: the colour conversion above; Y's edges
    repeated to whole blocks; the chroma planes' last column repeated to
    whole MCUs and their last row to an even count before
    ``h2v2_downsample``, then the downsampled plane's last row repeated
    to whole MCUs (jcprepct.c's ``expand_bottom_edge``); the islow forward
    DCT of samples less 128; quantisation; the blocks of the last MCU
    column and row that lie past the image are jccoefct.c's dummy blocks
    (no AC, the DC of the block before them in the MCU).  Interleaved MCUs
    are Huffman coded with Annex K's tables, 0xFF bytes stuffed with 0x00
    and the last byte padded with 1 bits."""
    a = np.asarray(rgb)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"cannot encode an array of {a.dtype} and shape "
                         f"{a.shape} as JPEG: (H, W, 3) uint8 RGB")
    H, W = a.shape[:2]
    if not (0 < H <= 65535 and 0 < W <= 65535):
        raise ValueError(f"cannot encode a {H}x{W} image as JPEG")
    tables = _quality_tables()
    data, (tail, rest) = pack_msb(*_entropy_codes(_coefficients(a, tables)))
    if rest:  # the last byte padded with 1 bits
        data += bytes([(tail << (8 - rest)) | ((1 << (8 - rest)) - 1)])
    return (_headers(H, W, tables) + data.replace(b"\xff", b"\xff\x00")
            + b"\xff\xd9")
