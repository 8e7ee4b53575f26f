"""A JPEG codec in numpy: a decoder bit-equal to libjpeg-turbo's default
decompression (what ``cv2.imread`` returns for these files), and
``encode_jpeg``, which writes the bytes ``cv2.imwrite`` writes with its
defaults (see its docstring).

Covers every JPEG that cv2 5.0.0 reads: sequential (SOF0 baseline, SOF1
extended) and progressive (SOF2) files, Huffman- or arithmetic-coded
(SOF9, SOF10), 8-bit, with 1, 3 or 4 components (gray; RGB or YCbCr;
CMYK or YCCK as ``_color_space`` tells them apart), any sampling factors
whose ratios libjpeg upsamples (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and the
like), restart intervals, one or several scans; and lossless files
(SOF3) of 2-8 bits with 1, 3 or 4 components.  What cv2 refuses raises
ValueError, as it is unreadable there too: a precision other than these,
hierarchical (SOF5-7, SOF13-15) and arithmetic lossless (SOF11) frames, a
height left to a DNL marker, fractional sampling ratios, 2 or more than
4 components, a lossless file in YCbCr or YCCK (libjpeg-turbo converts no
colour in lossless mode), or gray when ``color`` asks for
``IMREAD_COLOR``'s BGR.  No file raises ``Unsupported``.  A file cut
short in its entropy-coded data decodes as ``cv2.imread`` decodes it
(libjpeg pads the data with zero bits, the MCU in progress decodes from
them, and the MCUs after it keep what earlier scans put there: grey in a
sequential file); one cut short before its first scan's data raises
ValueError.

A progressive file's scans follow ``jdphuff.c``: DC first and refine
scans (interleaved or not), AC first and refine scans of one component,
EOB runs, restart intervals resetting the predictors and the EOB run,
the progression checks that make libjpeg fail.  Where a coefficient is
not fully known when the file ends (a script that stops before Al=0, or
a file cut short), libjpeg-turbo's block smoothing (``jdcoefct.c``
``decompress_smooth_data``) estimates the first nine AC coefficients,
and the DC where no AC data came, from the 5x5 neighbourhood of DC
values; ``_smooth`` repeats it.

Arithmetic coding follows ``jdarith.c``: T.81 Annex D's QM decoder
(``_QM``; Table D.2 as ``_ARITAB``), the DC contexts of the DAC
conditioning L and U and the AC magnitude bins split at Kx, statistics a
table shared by the components that name it, all reset at each restart,
zero bytes read past the data; the progressive scans keep the Huffman
ones' order rules and block smoothing.  Lossless files follow
``jdlhuff.c``, ``jddiffct.c`` and ``jdlossls.c``: predictors 1-7 and the
point transform, the first row of a scan or restart interval predicted
from 2**(P-Pt-1) and then the sample to its left, restarts of whole MCU
rows, the samples replicated to full size and converted to no other
colour space.

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

# the SOF markers this decoder reads: (process, arithmetic coding)
_SOF_KINDS = {0xC0: ("sequential", False), 0xC1: ("sequential", False),
              0xC2: ("progressive", False), 0xC3: ("lossless", False),
              0xC9: ("sequential", True), 0xCA: ("progressive", True)}
# the SOF markers libjpeg-turbo does not decode (cv2 gives None)
_SOF_REFUSED = {
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "hierarchical JPEG (SOF13)", 0xCE: "hierarchical JPEG (SOF14)",
    0xCF: "hierarchical JPEG (SOF15)",
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
    DC), or (0, 0, 0) where they do not.  Built a code and an extra-bits
    value at a time, each filling its run of peeks (codes past 16 bits, in
    a table that holds too many, fill none)."""
    slow = [0] * (1 << 16)
    fast = [(0, 0, 0)] * (1 << 16)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            sym = symbols[k]
            span = 1 << (16 - length)
            lo = code << (16 - length)
            code += 1
            k += 1
            if lo >= 1 << 16:
                continue
            slow[lo:lo + span] = [(length << 8) | sym] * span
            size = sym & 15 if ac else sym
            if length + size > 16:
                continue
            run = 0
            if ac:
                run = sym >> 4 if size else (15 if sym == 0xF0 else 64)
            step = span >> size
            for r in range(1 << size):
                v = r - (1 << size) + 1 if size and r < 1 << (size - 1) else r
                at = lo + r * step
                fast[at:at + step] = [(length + size, run, v)] * step
        code <<= 1
    return fast, slow


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


def _check_frame(frame, tiff: bool) -> None:
    """ValueError for the frames cv2 gives None for: a precision other than
    8 bits (2 to 8 in a lossless file; cv2 reads libjpeg-turbo's 8-bit
    samples only), 2 or more than 4 components (no colour conversion to
    BGR; in a TIFF's strip, which libtiff has libjpeg decode with no
    conversion, more than 4), a height left to a DNL marker (libjpeg does
    not take one)."""
    prec, lossless = frame.precision, frame.lossless
    if not (2 <= prec <= 8 if lossless else prec == 8):
        raise ValueError(f"{prec}-bit {'lossless ' if lossless else ''}JPEG")
    if len(frame.comps) not in ((1, 2, 3, 4) if tiff else (1, 3, 4)):
        raise ValueError(f"JPEG with {len(frame.comps)} components")
    if frame.H == 0 or frame.W == 0:
        raise ValueError("JPEG with its height in a DNL marker")


class _Frame:
    """SOF, and the coefficients of every component in one flat array (in
    zigzag order within a block; component k's blocks from offset[k]), or
    a lossless frame's samples (a data unit of one sample, ``samples``)."""

    def __init__(self, body: bytes, kind: str = "sequential",
                 arithmetic: bool = False):
        if len(body) < 6:
            raise ValueError("corrupt JPEG: short frame header")
        prec, self.H, self.W, nc = struct.unpack(">BHHB", body[:6])
        if nc == 0 or len(body) < 6 + 3 * nc:
            raise ValueError("corrupt JPEG: short frame header")
        self.lossless = kind == "lossless"
        self.arithmetic = arithmetic
        # samples a data unit's side: a block of 8, or one sample
        unit = self.unit = 1 if self.lossless else 8
        self.precision = prec
        progressive = kind == "progressive"
        # (id, h, v, quantisation table) a component
        self.comps = [(body[6 + 3 * k], body[7 + 3 * k] >> 4,
                       body[7 + 3 * k] & 15, body[8 + 3 * k])
                      for k in range(nc)]
        if any(not (1 <= h <= 4 and 1 <= v <= 4) for _, h, v, _ in self.comps):
            raise ValueError("corrupt JPEG: sampling factor out of range")
        self.hmax = max(c[1] for c in self.comps)
        self.vmax = max(c[2] for c in self.comps)
        self.mcus_x = -(-self.W // (unit * self.hmax))
        self.mcus_y = -(-self.H // (unit * self.vmax))
        # blocks a row and a column of each component's array
        self.blocks = [(self.mcus_y * v, self.mcus_x * h)
                       for _, h, v, _ in self.comps]
        sizes = [by * bx * unit * unit for by, bx in self.blocks]
        self.offset = np.cumsum([0] + sizes)[:-1].tolist()
        # each component's quantisation table, latched at its first scan
        self.quant = [None] * nc
        # a lossless frame's samples, each component's from its scan
        self.samples = [None] * nc
        self.progressive = progressive
        if not progressive:
            self.coef = np.zeros(sum(sizes), np.int64)
        else:
            # libjpeg's whole-image coefficient buffer (zeroed), as a list
            # the scans update in place (``_read`` makes ``coef`` of it at
            # the end); coef_bits[k][i] is the Al of component k's zigzag
            # coefficient i (-1 before any scan), prev_bits its value
            # before the component's latest scan
            self.plist = [0] * sum(sizes)
            self.coef_bits = [[-1] * 64 for _ in range(nc)]
            self.prev_bits = [[-1] * 64 for _ in range(nc)]
            self.scans = 0
            # the last iMCU row whose decoding left libjpeg's out-of-data
            # flag clear (master->last_good_iMCU_row)
            self.last_good = 0

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
            by_n, bx_n = -(-dh // self.unit), -(-dw // self.unit)
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


def _scan_members(frame: _Frame, header: bytes, qt):
    """The components of a scan (frame indices) and each one's (DC table
    id, AC table id); latches each component's quantisation table at its
    first scan, as ``jdinput.c`` does (``qt`` None: a lossless frame, which
    has none)."""
    ns = header[0] if header else 0
    if ns == 0 or len(header) < 4 + 2 * ns:
        raise ValueError("corrupt JPEG: short scan header")
    ids = [c[0] for c in frame.comps]
    members, tables = [], []
    for j in range(ns):
        cid, t = header[1 + 2 * j], header[2 + 2 * j]
        if cid not in ids:
            raise ValueError("corrupt JPEG: scan of an unknown component")
        k = ids.index(cid)
        members.append(k)
        tables.append((t >> 4, t & 15))
        if qt is not None and frame.quant[k] is None:
            tq = frame.comps[k][3]
            if tq not in qt:
                raise ValueError("corrupt JPEG: missing quantisation table")
            frame.quant[k] = qt[tq]
    return members, tables


def _decode_scan(frame: _Frame, header: bytes, entropy: bytes, restart: int,
                 dc_tabs, ac_tabs, qt) -> None:
    members, tables = _scan_members(frame, header, qt)
    luts = [None] * len(frame.comps)
    for k, (td, ta) in zip(members, tables):
        if td not in dc_tabs or ta not in ac_tabs:
            raise ValueError("corrupt JPEG: missing Huffman table")
        luts[k] = (dc_tabs[td], ac_tabs[ta], frame.offset[k])
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


# ---------------------------------------------------------------------------
# Progressive scans (jdphuff.c)
# ---------------------------------------------------------------------------

_DC_FIRST, _DC_REFINE, _AC_FIRST, _AC_REFINE = range(4)


def _prog_segment(kind, seg, order, per_mcu, luts, c, Ss, Se, Al):
    """Decode the blocks ``order`` [(component, block index)] of one
    restart interval of a progressive scan of ``kind`` into the
    coefficient list ``c`` (zigzag within a block, in place), as
    ``jdphuff.c`` does: the DC predictors and the EOB run start at zero.
    Where the data runs out, the MCU in progress reads zero bits and the
    MCUs after it are left as they are.  Returns the index (within the
    interval) of the MCU in which the data ran out, or None."""
    win, nbits = _windows(seg), 8 * len(seg)
    pos = 0
    pred = [0] * len(luts)
    eobrun = 0
    p1 = 1 << Al
    m1 = -p1
    for j, (ci, base) in enumerate(order):
        if pos > nbits:
            if j % per_mcu == 0:
                return j // per_mcu - 1
            win, pos, nbits = _ZERO_WINDOWS, 0, -1
        fast, slow, out_base = luts[ci]
        flat = out_base + base * 64
        if kind == _DC_FIRST:
            adv, _, diff = fast[(win[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
            if not adv:
                adv, _, diff = _slow_symbol(win, pos, slow, False)
            pos += adv
            v = pred[ci] = pred[ci] + diff
            v <<= Al
            c[flat] = v if -32768 <= v < 32768 else _wrap16(v)
        elif kind == _DC_REFINE:
            if (win[pos >> 3] >> (39 - (pos & 7))) & 1:
                c[flat] |= p1
            pos += 1
        elif kind == _AC_FIRST:
            if eobrun:
                eobrun -= 1
                continue
            k = Ss
            while k <= Se:
                peek = (win[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF
                adv, run, v = fast[peek]
                if not adv:
                    adv, run, v = _slow_symbol(win, pos, slow, True)
                pos += adv
                if run == 64:  # EOBr: 2**r - 1 more blocks end here too
                    r = (slow[peek] & 255) >> 4
                    eobrun = (1 << r) - 1
                    if r:
                        eobrun += (win[pos >> 3] >> (40 - (pos & 7) - r)) \
                            & ((1 << r) - 1)
                        pos += r
                    break
                k += run
                if v:
                    v <<= Al
                    c[flat + (k if k < 64 else 63)] = \
                        v if -32768 <= v < 32768 else _wrap16(v)
                k += 1
        else:  # _AC_REFINE
            k = Ss
            if not eobrun:
                while k <= Se:
                    e = slow[(win[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError("corrupt JPEG: bad Huffman code")
                    pos += e >> 8
                    r, s = (e >> 4) & 15, e & 15
                    if s:  # a new coefficient: its sign bit comes first
                        s = p1 if (win[pos >> 3] >> (39 - (pos & 7))) & 1 \
                            else m1
                        pos += 1
                    elif r != 15:  # EOBr
                        eobrun = 1 << r
                        if r:
                            eobrun += (win[pos >> 3]
                                       >> (40 - (pos & 7) - r)) & ((1 << r) - 1)
                            pos += r
                        break
                    # pass r zero coefficients (stopping on the one the
                    # new value goes to), a correction bit a nonzero one
                    while True:
                        f = flat + k
                        cur = c[f]
                        if cur:
                            if (win[pos >> 3] >> (39 - (pos & 7))) & 1 \
                                    and not cur & p1:
                                c[f] = cur + (p1 if cur >= 0 else m1)
                            pos += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                        if k > Se:
                            break
                    if s:
                        c[flat + (k if k < 64 else 63)] = s
                    k += 1
            if eobrun:
                # the rest of the band: a correction bit a nonzero one
                for f in range(flat + k, flat + Se + 1):
                    cur = c[f]
                    if cur:
                        if (win[pos >> 3] >> (39 - (pos & 7))) & 1 \
                                and not cur & p1:
                            c[f] = cur + (p1 if cur >= 0 else m1)
                        pos += 1
                eobrun -= 1
    return len(order) // per_mcu - 1 if pos > nbits else None


def _scan_kind(frame: _Frame, members, Ss, Se, Ah, Al) -> int:
    """The kind of a progressive scan, after libjpeg's checks
    (``jdphuff.c`` start_pass_phuff_decoder): a progression it cannot
    decode raises ValueError, as cv2 then returns None.  Updates the
    components' coefficient bits as libjpeg does (its warnings about
    inconsistent progressions do not stop it)."""
    dc = Ss == 0
    bad = (Se != 0) if dc else (Ss > Se or Se > 63 or len(members) != 1)
    if (Ah and Al != Ah - 1) or bad or Al > 13:
        raise ValueError(f"corrupt JPEG: bad progression (Ss={Ss} Se={Se} "
                         f"Ah={Ah} Al={Al})")
    for k in members:
        cur, prev = frame.coef_bits[k], frame.prev_bits[k]
        for i in range(min(Ss, 1), max(Se, 9) + 1):
            prev[i] = cur[i] if frame.scans > 1 else 0
        for i in range(Ss, Se + 1):
            cur[i] = Al
    if dc:
        return _DC_REFINE if Ah else _DC_FIRST
    return _AC_REFINE if Ah else _AC_FIRST


def _decode_prog_scan(frame: _Frame, header: bytes, entropy: bytes,
                      restart: int, dc_tabs, ac_tabs, qt) -> None:
    """One scan of a progressive frame into ``frame.plist``, and the last
    good iMCU row after it."""
    members, tables = _scan_members(frame, header, qt)
    ns = len(members)
    Ss, Se, A = header[1 + 2 * ns], header[2 + 2 * ns], header[3 + 2 * ns]
    frame.scans += 1
    kind = _scan_kind(frame, members, Ss, Se, A >> 4, A & 15)
    luts = [None] * len(frame.comps)
    for k, (td, ta) in zip(members, tables):
        if kind == _DC_REFINE:
            luts[k] = (None, None, frame.offset[k])
            continue
        tabs, t = (dc_tabs, td) if kind == _DC_FIRST else (ac_tabs, ta)
        if t not in tabs:
            raise ValueError("corrupt JPEG: missing Huffman table")
        luts[k] = tabs[t] + (frame.offset[k],)
    order, per_mcu = frame.scan_order(members)
    n_mcu = len(order) // per_mcu
    per = restart if restart else n_mcu
    segs = _split_restarts(entropy)
    # libjpeg's out-of-data flag is set from the MCU in which an interval
    # ran out until the restart marker that begins the next interval
    # present: ``flagged`` holds those (first MCU, next interval's MCU)
    flagged, out = [], False
    for r, start in enumerate(range(0, n_mcu, per)):
        if r < len(segs):
            out = False
        elif out:
            break
        bad = _prog_segment(kind, segs[r] if r < len(segs) else b"",
                            order[start * per_mcu:(start + per) * per_mcu],
                            per_mcu, luts, frame.plist, Ss, Se, A & 15)
        if bad is not None:
            out = True
            end = start + per if r + 1 < len(segs) else n_mcu
            flagged.append((start + bad, end))
    # an iMCU row that starts with the flag clear is the last good one so
    # far (the rows block smoothing takes the latest scan's bits for)
    if ns > 1:
        first = range(0, n_mcu, frame.mcus_x)
    else:
        v = frame.comps[members[0]][2]
        dh, dw = frame.comp_size(members[0])
        bx_n = -(-dw // 8)
        first = range(0, n_mcu, v * bx_n)
    for y, m in enumerate(first):
        if not any(a < m <= b for a, b in flagged):
            frame.last_good = y


# ---------------------------------------------------------------------------
# Arithmetic decoding (T.81 Annex D's QM decoder as jdarith.c runs it)
# ---------------------------------------------------------------------------

# Table D.2 (jaricom.c): each state's (Qe, the next state after an LPS
# with the MPS switch in bit 7, the next state after an MPS); state 113
# is the fixed bin of probability one half that never adapts
_ARITAB = [(q, (sw << 7) | lps, mps) for q, lps, mps, sw in (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0))]
FIXED_BIN = 113


class _QM:
    """The QM decoder of one restart interval (``jdarith.c``
    arith_decode): the C and A registers and the bit counter, fed the
    interval's unstuffed bytes and zero bytes past their end (as libjpeg
    supplies zeros once it meets a marker).  ``bit(st, i)`` decodes a
    decision with the statistics bin ``st[i]`` (bit 7 the MPS, the rest
    the state) and updates the bin."""

    __slots__ = ("data", "pos", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.c, self.a, self.ct = 0, 0, -16  # two bytes to read first

    def bit(self, st, i: int) -> int:
        a = self.a
        if a < 0x8000:  # renormalise, reading bytes into C (D.2.6)
            c, ct, data, pos = self.c, self.ct, self.data, self.pos
            while a < 0x8000:
                ct -= 1
                if ct < 0:
                    c = (c << 8) | (data[pos] if pos < len(data) else 0)
                    pos += 1
                    ct += 8
                    if ct < 0:
                        ct += 1
                        if ct == 0:  # the two first bytes are in
                            a = 0x8000
                a <<= 1
            self.c, self.ct, self.pos = c, ct, pos
        sv = st[i]
        qe, nl, nm = _ARITAB[sv & 0x7F]
        a -= qe
        temp = a << self.ct
        if self.c >= temp:  # the LPS sub-interval, or an exchange
            self.c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a = a
        return sv >> 7


class _Overflow(Exception):
    """jdarith.c's "bad code" (a spectral or magnitude overflow): the rest
    of the restart interval decodes to nothing."""


def _arith_magnitude(qm, st, sp, first):
    """Figures F.23 and F.24 (F.21 and F.22 are the caller's): the
    magnitude category from the bin ``sp`` on (``first`` the bin the
    categories from 2 up continue in, None for a DC value, whose second
    decision already reads there), then the magnitude's bits; returns
    (|v|, the category's top bit, which the DC context reads)."""
    m = qm.bit(st, sp)
    if m:
        if first is None:
            sp = 20
            while qm.bit(st, sp):
                m <<= 1
                if m == 0x8000:
                    raise _Overflow
                sp += 1
        elif qm.bit(st, sp):
            m <<= 1
            sp = first
            while qm.bit(st, sp):
                m <<= 1
                if m == 0x8000:
                    raise _Overflow
                sp += 1
    top = v = m
    sp += 14
    m >>= 1
    while m:
        if qm.bit(st, sp):
            v |= m
        m >>= 1
    return v + 1, top


def _arith_dc(qm, st, ctx, L, U):
    """One DC difference (F.19): (value, the component's next context)."""
    if not qm.bit(st, ctx):
        return 0, 0
    sign = qm.bit(st, ctx + 1)
    # the category's first decision at SP or SN, the others at X1 on
    v, m = _arith_magnitude(qm, st, ctx + 2 + sign, None)
    if m < (1 << L) >> 1:
        ctx = 0
    elif m > (1 << U) >> 1:
        ctx = 12 + 4 * sign
    else:
        ctx = 4 + 4 * sign
    return (-v if sign else v), ctx


def _arith_ac(qm, st, fixed, k, K):
    """The sign and magnitude of a nonzero AC coefficient at band index k
    whose decisions start at bin 3 * (k - 1) + 2 (F.21-F.24)."""
    sign = qm.bit(fixed, 0)
    v, _ = _arith_magnitude(qm, st, 3 * (k - 1) + 2, 189 if k <= K else 217)
    return -v if sign else v


def _arith_segment(kind, seg, order, comps, c, Ss, Se, Al, cond):
    """Decode the blocks ``order`` [(component, block index)] of one
    restart interval of an arithmetic-coded scan into the zigzag
    coefficient list ``c`` (in place): ``kind`` None for a sequential
    scan, else a progressive scan's kind.  ``comps[ci]`` is (DC table, AC
    table, offset).  The statistics areas, the DC predictions and
    contexts start afresh (``process_restart``); a bad code leaves the
    rest of the interval as it was."""
    qm = _QM(seg)
    dc_L, dc_U, ac_K = cond
    dc_stats, ac_stats = {}, {}
    for comp in comps:
        if comp is not None:
            dc_stats.setdefault(comp[0], bytearray(64))
            ac_stats.setdefault(comp[1], bytearray(256))
    fixed = bytearray([FIXED_BIN])
    last, ctx = [0] * len(comps), [0] * len(comps)
    p1, m1 = 1 << Al, -1 << Al
    try:
        for ci, base in order:
            td, ta, out_base = comps[ci]
            flat = out_base + base * 64
            if kind is None or kind == _DC_FIRST:
                d, ctx[ci] = _arith_dc(qm, dc_stats[td], ctx[ci], dc_L[td],
                                       dc_U[td])
                last[ci] += d
                c[flat] = _wrap16(last[ci] << Al)
                if kind is None:  # the block's AC coefficients (F.20)
                    st, K, k = ac_stats[ta], ac_K[ta], 0
                    while k < 63:
                        sp = 3 * k
                        if qm.bit(st, sp):  # EOB
                            break
                        while True:
                            k += 1
                            if qm.bit(st, sp + 1):
                                break
                            sp += 3
                            if k >= 63:
                                raise _Overflow
                        c[flat + k] = _wrap16(_arith_ac(qm, st, fixed, k, K))
            elif kind == _DC_REFINE:
                if qm.bit(fixed, 0):
                    c[flat] |= p1
            elif kind == _AC_FIRST:
                st, K, k = ac_stats[ta], ac_K[ta], Ss
                while k <= Se:
                    sp = 3 * (k - 1)
                    if qm.bit(st, sp):  # EOB
                        break
                    while not qm.bit(st, sp + 1):
                        sp += 3
                        k += 1
                        if k > Se:
                            raise _Overflow
                    c[flat + k] = _wrap16(_arith_ac(qm, st, fixed, k, K) << Al)
                    k += 1
            else:  # _AC_REFINE (G.1.3.3)
                st = ac_stats[ta]
                kex = Se  # the previous stage's end of block
                while kex > 0 and not c[flat + kex]:
                    kex -= 1
                k = Ss
                while k <= Se:
                    sp = 3 * (k - 1)
                    if k > kex and qm.bit(st, sp):  # EOB
                        break
                    while True:
                        cur = c[flat + k]
                        if cur:  # a correction bit
                            if qm.bit(st, sp + 2):
                                c[flat + k] = cur + (m1 if cur < 0 else p1)
                            break
                        if qm.bit(st, sp + 1):  # newly nonzero
                            c[flat + k] = m1 if qm.bit(fixed, 0) else p1
                            break
                        sp += 3
                        k += 1
                        if k > Se:
                            raise _Overflow
                    k += 1
    except _Overflow:
        pass


def _decode_arith_scan(frame: _Frame, header: bytes, entropy: bytes,
                       restart: int, cond, qt) -> None:
    """One scan of an arithmetic-coded frame (SOF9 sequential, SOF10
    progressive) into ``frame.coef`` or ``frame.plist``: libjpeg's checks
    of a progressive scan, then each restart interval from its own bytes
    (one whose marker never came reads zero bytes, as libjpeg does)."""
    members, tables = _scan_members(frame, header, qt)
    ns = len(members)
    Ss, Se, A = header[1 + 2 * ns], header[2 + 2 * ns], header[3 + 2 * ns]
    comps = [None] * len(frame.comps)
    for k, (td, ta) in zip(members, tables):
        comps[k] = (td, ta, frame.offset[k])
    if frame.progressive:
        frame.scans += 1
        kind = _scan_kind(frame, members, Ss, Se, A >> 4, A & 15)
        c, Al = frame.plist, A & 15
    else:
        kind, c, Al, Ss, Se = None, frame.coef, 0, 0, 63
    order, per_mcu = frame.scan_order(members)
    n_mcu = len(order) // per_mcu
    per = restart if restart else n_mcu
    segs = _split_restarts(entropy)
    if kind is None:
        c = frame.coef.tolist()
    for r, start in enumerate(range(0, n_mcu, per)):
        _arith_segment(kind, segs[r] if r < len(segs) else b"",
                       order[start * per_mcu:(start + per) * per_mcu],
                       comps, c, Ss, Se, Al, cond)
    if kind is None:
        frame.coef = np.array(c, np.int64)
    else:
        # jdarith.c never flags missing data: every row is a good one
        frame.last_good = frame.mcus_y - 1


# ---------------------------------------------------------------------------
# Lossless (SOF3: jdlhuff.c, jddiffct.c and jdlossls.c)
# ---------------------------------------------------------------------------

def _lossless_symbol(win, pos, slow):
    """(bits to advance, difference) of the code at ``pos`` where the fast
    table has none: its code and extra bits take more than 16 bits, or its
    category is 16 (the difference 32768, no extra bits)."""
    bits = (win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFFFFFF
    e = slow[bits >> 16]
    if not e:
        raise ValueError("corrupt JPEG: bad Huffman code")
    n, s = e >> 8, e & 255
    if s == 16:
        return n, 32768
    v = (bits >> (32 - n - s)) & ((1 << s) - 1) if s else 0
    if s and v < 1 << (s - 1):
        v -= (1 << s) - 1
    return n + s, v


def _lossless_row(win, pos, nbits, tables, count):
    """Decode ``count`` differences (one MCU row) from ``pos``, the i-th
    with the Huffman tables ``tables[i % len(tables)]`` (an MCU's samples
    in order).  Where the data runs out the rest of the row reads zero
    bits (libjpeg's bit reader), which give every later sample the
    difference of its table's all-zero code.  Returns (the differences,
    the new position, whether the data ran out)."""
    per = len(tables)
    out = []
    append = out.append
    for i in range(count):
        if pos > nbits:
            zero = []
            for fast, slow in tables:
                adv, _, v = fast[0]
                zero.append(v if adv else _lossless_symbol(_ZERO_WINDOWS, 0,
                                                           slow)[1])
            out += [zero[j % per] for j in range(i, count)]
            return out, pos, True
        fast, slow = tables[i % per]
        adv, _, v = fast[(win[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
        if not adv:
            adv, v = _lossless_symbol(win, pos, slow)
        pos += adv
        append(v)
    return out, pos, pos > nbits


def _lossless_layout(frame: _Frame, members):
    """A lossless scan's MCUs: (the component of each sample of an MCU, the
    MCUs a row, the MCU rows, each sample's index in its component's
    array in coding order as (component, flat index) arrays).  An
    interleaved MCU holds v x h samples of each component, dummies past a
    component's own samples included; a one-component scan's MCU is one
    of the component's own samples."""
    if len(members) == 1:
        k = members[0]
        dh, dw = frame.comp_size(k)
        bx = frame.blocks[k][1]
        flat = (np.arange(dh)[:, None] * bx + np.arange(dw)).ravel()
        return [k], dw, dh, np.full(flat.size, k), flat
    comp, at = [], []
    for k in members:
        _, h, v, _ = frame.comps[k]
        comp += [k] * (v * h)
        at += [(y, x, h, v, frame.blocks[k][1]) for y in range(v)
               for x in range(h)]
    my, mx = np.divmod(np.arange(frame.mcus_x * frame.mcus_y), frame.mcus_x)
    flat = np.stack([(my * v + y) * bx + mx * h + x
                     for y, x, h, v, bx in at], axis=1).ravel()
    return (comp, frame.mcus_x, frame.mcus_y,
            np.tile(np.array(comp), frame.mcus_x * frame.mcus_y), flat)


def _undifference(d: np.ndarray, psv: int, first, start: int) -> np.ndarray:
    """jdlossls.c's undifferencing of a component's (rows, columns)
    differences: rows in ``first`` (a scan's or restart's first row) from
    ``start`` then the sample to the left, the first sample of other rows
    from the one above, the others by predictor ``psv``; every sample
    modulo 2**16.  Predictors 1-5 are linear in the sample to the left
    and run as prefix sums; 6 and 7 run sample by sample."""
    rows, width = d.shape
    x = np.zeros((rows, width), np.int64)
    for r in range(rows):
        dr = d[r]
        if first[r]:
            x[r] = (start + np.cumsum(dr)) & 0xFFFF
            continue
        up = x[r - 1]
        if psv == 2:
            x[r] = (dr + up) & 0xFFFF
        elif psv == 3:
            x[r] = (dr + np.concatenate([up[:1], up[:-1]])) & 0xFFFF
        elif psv in (1, 4, 5):
            step = dr.copy()
            if psv == 4:
                step[1:] += up[1:] - up[:-1]
            elif psv == 5:
                step[1:] += (up[1:] - up[:-1]) >> 1
            x[r] = (up[0] + np.cumsum(step)) & 0xFFFF
        else:
            dl, ul = dr.tolist(), up.tolist()
            ra = (dl[0] + ul[0]) & 0xFFFF
            out = [ra]
            if psv == 6:
                for j in range(1, width):
                    ra = (dl[j] + ul[j] + ((ra - ul[j - 1]) >> 1)) & 0xFFFF
                    out.append(ra)
            else:
                for j in range(1, width):
                    ra = (dl[j] + ((ra + ul[j]) >> 1)) & 0xFFFF
                    out.append(ra)
            x[r] = out
    return x


def _decode_lossless_scan(frame: _Frame, header: bytes, entropy: bytes,
                          restart: int, dc_tabs, dc_max) -> None:
    """One scan of a lossless frame: libjpeg-turbo's checks (predictor
    1-7, Se and Ah 0, Pt under the precision, DC symbols up to 16, a
    restart interval of whole MCU rows), the differences of every MCU row
    (a row after the data ran out gives zeros and resets the predictors,
    until a restart marker that is present), then each component's
    samples (``frame.samples``)."""
    members, tables = _scan_members(frame, header, None)
    ns = len(members)
    psv, Se, A = header[1 + 2 * ns], header[2 + 2 * ns], header[3 + 2 * ns]
    Al = A & 15
    if not 1 <= psv <= 7 or Se or A >> 4 or Al >= frame.precision:
        raise ValueError(f"corrupt JPEG: bad lossless scan (psv={psv} "
                         f"Se={Se} Ah={A >> 4} Al={Al})")
    luts = [None] * len(frame.comps)
    for k, (td, _) in zip(members, tables):
        if td not in dc_tabs:
            raise ValueError("corrupt JPEG: missing Huffman table")
        if dc_max[td] > 16:
            raise ValueError("corrupt JPEG: lossless table symbol past 16")
        luts[k] = dc_tabs[td]
    pattern, per_row, n_rows, comp_of, flat_of = _lossless_layout(frame,
                                                                  members)
    if restart % per_row:
        raise ValueError(f"corrupt JPEG: restart interval {restart} is not "
                         f"a whole number of MCU rows ({per_row})")
    mcu_tables = [luts[k] for k in pattern]
    count = per_row * len(pattern)  # samples an MCU row
    every = restart // per_row if restart else n_rows
    segs = _split_restarts(entropy)
    got = np.zeros(n_rows * count, np.int64)
    reset, out = set(), False
    win, pos, nbits = _ZERO_WINDOWS, 0, -1
    for j in range(n_rows):
        if j % every == 0:
            reset.add(j)
            r = j // every
            if r < len(segs):
                win, nbits = _windows(segs[r]), 8 * len(segs[r])
                pos, out = 0, False
            elif not out:
                win, pos, nbits = _windows(b""), 0, 0
        if out:
            reset.add(j)
            continue
        row, pos, out = _lossless_row(win, pos, nbits, mcu_tables, count)
        got[j * count:(j + 1) * count] = row
    diffs = [np.zeros(by * bx, np.int64) for by, bx in frame.blocks]
    for k in members:
        diffs[k][flat_of[comp_of == k]] = got[comp_of == k]
    for k in members:
        by, bx = frame.blocks[k]
        dh, dw = frame.comp_size(k)
        v = frame.comps[k][2]
        # a reset takes effect at the first row of the iMCU row (v rows)
        # it falls in, when that row is undifferenced
        imcu = {j if ns > 1 else j // v for j in reset}
        first = [r % v == 0 and r // v in imcu for r in range(dh)]
        x = _undifference(diffs[k].reshape(by, bx)[:dh, :dw], psv, first,
                          1 << (frame.precision - Al - 1))
        frame.samples[k] = ((x << Al) & 0xFF).astype(np.uint8)


# ---------------------------------------------------------------------------
# Block smoothing (libjpeg-turbo's jdcoefct.c, 5x5 DC neighbourhoods)
# ---------------------------------------------------------------------------

# A kernel is the 5x5 DC neighbourhood's weights (block rows -2..2, block
# columns -2..2) for one coefficient, keyed by its zigzag index: the
# first five AC coefficients where some AC data came, and the first nine
# and the DC (key 0) where none did (DC interpolation).
_SMOOTH_AC = {
    1: ((0,) * 5, (0,) * 5, (-7, 50, 0, -50, 7), (0,) * 5, (0,) * 5),
    2: ((0, 0, -7, 0, 0), (0, 0, 50, 0, 0), (0,) * 5, (0, 0, -50, 0, 0),
        (0, 0, 7, 0, 0)),
    3: ((0, 0, -1, 0, 0), (0, 0, 13, 0, 0), (0, 0, -24, 0, 0),
        (0, 0, 13, 0, 0), (0, 0, -1, 0, 0)),
    4: ((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), (0,) * 5, (1, -10, 0, 10, -1),
        (0, 1, 0, -1, 0)),
    5: ((0,) * 5, (0,) * 5, (-1, 13, -24, 13, -1), (0,) * 5, (0,) * 5),
}
_SMOOTH_DC = {
    1: ((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3), (-3, 38, 0, -38, 3),
        (-3, 13, 0, -13, 3), (-1, -1, 0, 1, 1)),
    2: ((-1, -3, -3, -3, -1), (-1, 13, 38, 13, -1), (0,) * 5,
        (1, -13, -38, -13, 1), (1, 3, 3, 3, 1)),
    3: ((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0),
        (0, 2, 7, 2, 0), (0, 0, 1, 0, 0)),
    4: ((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), (0,) * 5, (0, -9, 0, 9, 0),
        (1, 0, 0, 0, -1)),
    5: ((0,) * 5, (0, 2, -5, 2, 0), (1, 7, -14, 7, 1), (0, 2, -5, 2, 0),
        (0,) * 5),
    6: ((0,) * 5, (0, 1, 0, -1, 0), (0, 2, 0, -2, 0), (0, 1, 0, -1, 0),
        (0,) * 5),
    7: ((0,) * 5, (0, 1, -3, 1, 0), (0,) * 5, (0, -1, 3, -1, 0), (0,) * 5),
    8: ((0,) * 5, (0, 1, 0, -1, 0), (0, -3, 0, 3, 0), (0, 1, 0, -1, 0),
        (0,) * 5),
    9: ((0,) * 5, (0, 1, 2, 1, 0), (0,) * 5, (0, -1, -2, -1, 0), (0,) * 5),
    0: ((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6), (-8, 42, 152, 42, -8),
        (-6, 6, 42, 6, -6), (-2, -6, -8, -6, -2)),
}


def _smoothing_latch(frame: _Frame):
    """``smoothing_ok``: None where libjpeg does not smooth, else each
    component's latched coefficient bits (zigzag 0..9) and those before
    its latest scan."""
    useful = False
    latch = []
    for k in range(len(frame.comps)):
        q = frame.quant[k]
        if q is None or not q[ZIGZAG[:10]].all():
            return None
        cur = frame.coef_bits[k]
        if cur[0] < 0:
            return None
        prev = frame.prev_bits[k] if frame.scans > 1 else [-1] * 64
        latch.append((cur[:10], [cur[0]] + prev[1:10]))
        useful |= any(b != 0 for b in cur[1:10])
    return latch if useful else None


def _neighbour_rows(by_real: int, v: int, total: int) -> np.ndarray:
    """For each block row b of a component (``by_real`` rows with
    samples, v block rows an iMCU row, ``total`` iMCU rows), the block
    rows libjpeg reads as rows -2..2 of its neighbourhood
    (decompress_smooth_data's pointers, whose edge tests count the last
    iMCU row's block rows as if every iMCU row had as many)."""
    rows = []
    for b in range(by_real):
        R, br = divmod(b, v)
        block_rows = v if R < total - 1 else (by_real % v or v)
        ib, n = R * block_rows + br, block_rows * total
        prev = b - 1 if ib > 0 else b
        pprev = b - 2 if ib > 1 else prev
        nxt = b + 1 if ib < n - 1 else b
        nnxt = b + 2 if ib < n - 2 else nxt
        rows.append((pprev, prev, b, nxt, nnxt))
    return np.array(rows, np.int64).reshape(-1, 5)


def _smooth(frame: _Frame, k: int, zz: np.ndarray, latch) -> np.ndarray:
    """Component k's (by, bx, 64) zigzag coefficients with libjpeg-turbo's
    block smoothing applied to its blocks that hold samples."""
    v = frame.comps[k][2]
    dh, dw = frame.comp_size(k)
    by_real, bx_real = -(-dh // 8), -(-dw // 8)
    q = frame.quant[k][ZIGZAG[:10]].astype(np.int64)
    rows = _neighbour_rows(by_real, v, frame.mcus_y)
    cols = np.clip(np.arange(bx_real)[:, None] + np.arange(-2, 3), 0,
                   bx_real - 1)
    # hood[b, x, i, j]: the DC at neighbourhood row i, column j
    hood = zz[..., 0][rows[:, None, :, None], cols[None, :, None, :]]
    out = zz.copy()
    # iMCU rows past the last good one take the bits before the last scan
    past = (np.arange(by_real) // v) > frame.last_good
    for bits, sel in zip(latch, (~past, past)):
        if not sel.any():
            continue
        change_dc = all(b == -1 for b in bits[1:10])
        blk = out[:by_real, :bx_real][sel]
        for i, kern in (_SMOOTH_DC if change_dc else _SMOOTH_AC).items():
            if i and bits[i] == 0:
                continue
            num = q[0] * np.einsum("bij,ij->b", hood[sel].reshape(-1, 5, 5),
                                   np.array(kern)).reshape(blk.shape[:-1])
            pred = ((q[i] << 7) + np.abs(num)) // (q[i] << 8)
            if i and bits[i] > 0:
                pred = np.minimum(pred, (1 << bits[i]) - 1)
            pred = np.where(num < 0, -pred, pred)
            if i:
                blk[..., i] = np.where(blk[..., i] == 0, pred, blk[..., i])
            else:
                blk[..., 0] = pred
        out[:by_real, :bx_real][sel] = blk
    return out


def _color_space(frame: _Frame, jfif: bool, adobe_transform) -> str:
    """jdapimin.c default_decompress_parms: the colour space of 3 or 4
    components ("rgb", "ycc", "cmyk" or "ycck")."""
    if len(frame.comps) == 4:  # Adobe transform 0 or no marker: CMYK
        return "cmyk" if adobe_transform in (None, 0) else "ycck"
    if jfif:
        return "ycc"
    if adobe_transform is not None:
        return "rgb" if adobe_transform == 0 else "ycc"
    ids = tuple(c[0] for c in frame.comps)
    if ids == (82, 71, 66):
        return "rgb"
    # libjpeg-turbo 3 takes a lossless file's other ids as RGB
    return "rgb" if frame.unit == 1 else "ycc"


def cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """OpenCV's CMYK to BGR conversion (``icvCvt_CMYK2BGR_8u_C4C3R``) of
    u8 planes, in RGB order: each of C, M, Y becomes
    ``k - ((255 - v) * k >> 8)``."""
    k = k.astype(np.int32)
    return np.stack([k - (((255 - p.astype(np.int32)) * k) >> 8)
                     for p in (c, m, y)], axis=-1).astype(np.uint8)


def _to_rgb(planes, space: str) -> np.ndarray:
    """Upsampled component planes in the frame's colour space -> (H, W)
    gray or (H, W, 3) RGB, as cv2 gets them from libjpeg."""
    if len(planes) == 1:
        return planes[0]
    if space == "rgb":
        return np.stack(planes, axis=-1)
    if space == "ycc":
        return ycc_to_rgb(*planes)
    if space == "ycck":  # jdcolor.c ycck_cmyk_convert: CMY = 255 - RGB
        planes = [255 - p for p in np.moveaxis(ycc_to_rgb(*planes[:3]), -1,
                                                0)] + [planes[3]]
    return cmyk_to_rgb(*planes)


def _read(data: bytes, tiff: bool = False):
    """Parse a JPEG and decode its scans -> (frame, whether it has a JFIF
    marker, the Adobe transform or None).  ``frame.coef`` then holds the
    quantised coefficients of every component (zigzag within a block,
    component k's padded block array from ``frame.offset[k]``).  ``tiff``:
    a TIFF's strip or tile (``_check_frame``)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    qt, dc_tabs, ac_tabs, dc_max = {}, {}, {}, {}
    frame, restart, jfif, adobe_transform = None, 0, False, None
    # the arithmetic conditioning a table (DAC): DC L and U, AC Kx
    cond = ([0] * 16, [1] * 16, [5] * 16)
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
                symbols = list(body[p + 17:p + 17 + n])
                lut = _huffman_lut(counts, symbols, ac)
                (ac_tabs if ac else dc_tabs)[body[p] & 15] = lut
                if not ac:
                    dc_max[body[p] & 15] = max(symbols, default=0)
                p += 17 + n
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xCC:  # jdmarker.c get_dac
            for p in range(0, len(body) - 1, 2):
                index, val = body[p], body[p + 1]
                if index >= 32:
                    raise ValueError(f"corrupt JPEG: DAC index {index}")
                if index >= 16:
                    cond[2][index - 16] = val
                elif val & 15 > val >> 4:
                    raise ValueError(f"corrupt JPEG: DAC value {val:#x}")
                else:
                    cond[0][index], cond[1][index] = val & 15, val >> 4
        elif marker in _SOF_KINDS:
            frame = _Frame(body, *_SOF_KINDS[marker])
            _check_frame(frame, tiff)
        elif marker in _SOF_REFUSED:
            raise ValueError(_SOF_REFUSED[marker] + ", which libjpeg-turbo "
                             "does not decode")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: SOS before SOF")
            stop = _scan_end(data, pos)
            entropy = data[pos:stop]
            if frame.lossless:
                _decode_lossless_scan(frame, body, entropy, restart, dc_tabs,
                                      dc_max)
            elif frame.arithmetic:
                _decode_arith_scan(frame, body, entropy, restart, cond, qt)
            else:
                scan = (_decode_prog_scan if frame.progressive
                        else _decode_scan)
                scan(frame, body, entropy, restart, dc_tabs, ac_tabs, qt)
            pos, scanned = stop, True
    if frame is None:
        raise ValueError("corrupt JPEG: no frame")
    if not scanned:  # libjpeg: "JPEG datastream contains no image"
        raise ValueError("corrupt JPEG: no scan")
    if frame.lossless:
        return frame, jfif, adobe_transform
    if frame.progressive:
        frame.coef = np.array(frame.plist, np.int64)
    for k, (_, _, _, tq) in enumerate(frame.comps):
        if frame.quant[k] is None:  # a component no scan reached
            if tq not in qt:
                raise ValueError("corrupt JPEG: missing quantisation table")
            frame.quant[k] = qt[tq]
    return frame, jfif, adobe_transform


def decode_jpeg(data: bytes, color: bool = False) -> np.ndarray:
    """JPEG bytes -> (H, W) uint8 gray or (H, W, 3) uint8 RGB, what
    ``cv2.imread`` gives in ``IMREAD_UNCHANGED`` (``color`` False) or in
    ``IMREAD_COLOR`` (True), in RGB order (libjpeg's default
    decompression; CMYK and YCCK through OpenCV's CMYK formula).  The two
    modes differ only on a lossless gray file, which ``IMREAD_COLOR``
    refuses.  ValueError where cv2 gives None."""
    frame, jfif, adobe_transform = _read(data)
    return _decode_frame(frame, _color_space(frame, jfif, adobe_transform),
                         color)


def decode_jpeg_chunk(tables: bytes, data: bytes, space: str) -> np.ndarray:
    """A strip or tile of a JPEG-compressed TIFF -> (H, W) or (H, W, C)
    uint8, as libtiff's JPEG codec has libjpeg decode it: the
    tables-only stream ``tables`` (the JPEGTables tag, SOI ... EOI, or
    b"") read first, so the chunk's own tables replace its tables, and the
    colour space that libtiff sets in place of the markers' (``space``:
    "ycc" for a YCbCr image, which libtiff's RGBA reader has libjpeg
    convert to RGB; "rgb" for any other, whose components come out as
    they are)."""
    if tables[:2] == b"\xff\xd8" and data[:2] == b"\xff\xd8":
        body = tables[2:-2] if tables[-2:] == b"\xff\xd9" else tables[2:]
        data = data[:2] + body + data[2:]
    frame = _read(data, tiff=True)[0]
    return _decode_frame(frame, space, False)


def _decode_frame(frame: _Frame, space: str, color: bool) -> np.ndarray:
    """A parsed frame's image in the colour space ``space``."""
    if any(frame.hmax % h or frame.vmax % v for _, h, v, _ in frame.comps):
        # jdsample.c: JERR_FRACT_SAMPLE_NOTIMPL, cv2 gives None
        raise ValueError("JPEG with fractional sampling ratios")
    if frame.lossless:
        return _lossless_image(frame, space, color)
    latch = _smoothing_latch(frame) if frame.progressive else None
    planes = []
    for k, (_, h, v, _) in enumerate(frame.comps):
        by, bx = frame.blocks[k]
        off = frame.offset[k]
        zz = frame.coef[off:off + by * bx * 64].reshape(by, bx, 64)
        if latch is not None:
            zz = _smooth(frame, k, zz, latch[k])
        zz = zz.reshape(-1, 64)
        nat = np.empty_like(zz)
        nat[:, ZIGZAG] = zz
        px = idct_islow(nat, frame.quant[k]).reshape(by, bx, 8, 8)
        px = px.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        dh, dw = frame.comp_size(k)
        fh, fv = frame.hmax // h, frame.vmax // v
        planes.append(_upsample(px[:dh, :dw], fh, fv)[:frame.H, :frame.W])
    return _to_rgb(planes, space)


def _lossless_image(frame: _Frame, space: str, color: bool) -> np.ndarray:
    """A lossless frame's samples as cv2 gets them: each component
    replicated to full size (libjpeg-turbo upsamples without its triangle
    filter when a data unit is one sample), then gray, RGB or CMYK as they
    are; libjpeg-turbo converts no colour in lossless mode, so a YCbCr or
    YCCK file, and with ``color`` (``IMREAD_COLOR``'s BGR) a gray one,
    raise ValueError, as cv2 gives None."""
    gray = len(frame.comps) == 1
    if (color and gray) or (not gray and space in ("ycc", "ycck")):
        raise ValueError(f"lossless JPEG in {'gray' if gray else space}: "
                         "libjpeg-turbo converts no colour in lossless mode")
    planes = []
    for k, (_, h, v, _) in enumerate(frame.comps):
        p = frame.samples[k]
        if p is None:  # a component no scan reached
            p = np.zeros(frame.comp_size(k), np.uint8)
        p = np.repeat(np.repeat(p, frame.vmax // v, axis=0), frame.hmax // h,
                      axis=1)
        planes.append(p[:frame.H, :frame.W])
    return _to_rgb(planes, space)


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
