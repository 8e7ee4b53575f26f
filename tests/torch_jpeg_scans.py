"""JPEG writers for the tests of the port's decoders and for
``chip_smoke.py`` (whose machine has no cv2), numpy only.

``transcode(data, script)`` takes the quantised coefficients of a
sequential JPEG (from the port's decoder, ``utils/jpeg._read``) and writes
them as a progressive (SOF2) file under a scan script, as ``jpegtran
-progressive`` does: each scan's Huffman tables are built from its own
symbol counts (Annex K.2, ``jchuff.c`` jpeg_gen_optimal_table) and come
in a DHT before it, and a restart interval may be set.  Runs of blocks
that end in zeros are sent one EOB0 a block (no longer EOB runs; cv2's
own progressive files supply those).  The coefficients are the baseline
file's, so the decode of the transcoded file must equal the baseline
file's bit for bit, unless the script stops before Al=0 (then libjpeg
smooths the blocks whose coefficients it does not fully know).

A script is a list of scans (components, Ss, Se, Ah, Al), components as
indices into the frame's; ``script(name, n_components)`` gives the named
ones the tests use.

The variants cv2 reads and cannot write: ``sequential`` (1, 3 or 4
components of planes given, any sampling, Adobe and JFIF markers: CMYK
and YCCK files), ``recomponent`` (a file's own components copied into a
new one, so a CMYK file's planes are known without cv2), ``lossless``
(SOF3: predictors 1-7, the point transform, restarts, precisions 2-16)
and ``arithmetic`` (a file's coefficients arithmetic-coded as
``jcarith.c`` codes them: SOF9, or SOF10 under a script, with DAC
conditioning and restarts).  ``exif_tiff``, ``with_app1`` and
``with_png_chunks`` put an EXIF Orientation into a JPEG or a PNG.
"""

from __future__ import annotations

import struct

import numpy as np

from underwater_image_enhancement_tpu_torch.utils import jpeg as tjpeg


def _progression(nc: int):
    """jcparam.c jpeg_simple_progression: the script cv2 writes with
    IMWRITE_JPEG_PROGRESSIVE (10 scans for YCbCr, 6 for gray; its
    all-purpose script for other component counts)."""
    if nc != 3:
        each = [(k,) for k in range(nc)]
        dc = tuple(range(nc))
        return ([(dc, 0, 0, 0, 1)] + [(c, 1, 5, 0, 2) for c in each]
                + [(c, 6, 63, 0, 2) for c in each]
                + [(c, 1, 63, 2, 1) for c in each] + [(dc, 0, 0, 1, 0)]
                + [(c, 1, 63, 1, 0) for c in each])
    return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
            ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
            ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
            ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]


def script(name: str, nc: int):
    """The named scan scripts for a frame of ``nc`` components:
    ``cv2`` (cv2's own), ``spectral`` (spectral selection only),
    ``dc_each`` (the DC of each component in a scan of its own),
    ``three_step`` (successive approximation Al 2, 1, 0 of the DC and of
    every band), ``stops_at_1`` (the same without its last step: every
    coefficient's lowest bit is never sent)."""
    comps = tuple(range(nc))
    if name == "cv2":
        return _progression(nc)
    if name == "spectral":
        return ([(comps, 0, 0, 0, 0)]
                + [((k,), 1, 5, 0, 0) for k in comps]
                + [((k,), 6, 63, 0, 0) for k in comps])
    if name == "dc_each":
        return ([((k,), 0, 0, 0, 0) for k in comps]
                + [((k,), 1, 63, 0, 0) for k in comps])
    if name in ("three_step", "stops_at_1"):
        out = [(comps, 0, 0, 0, 2)] + [((k,), 1, 63, 0, 2) for k in comps]
        out += [(comps, 0, 0, 2, 1)] + [((k,), 1, 63, 2, 1) for k in comps]
        if name == "three_step":
            out += ([(comps, 0, 0, 1, 0)]
                    + [((k,), 1, 63, 1, 0) for k in reversed(comps)])
        return out
    raise ValueError(f"unknown script {name!r}")


SCRIPTS = ("cv2", "spectral", "dc_each", "three_step", "stops_at_1")


def optimal_table(freq):
    """jchuff.c jpeg_gen_optimal_table: (counts by code length 1..16,
    symbols) of a Huffman table for the symbol counts ``freq`` (256), with
    the reserved all-ones code point and the 16-bit length limit."""
    freq = list(freq) + [1]
    size = [0] * 257
    others = [-1] * 257
    while True:
        c1 = c2 = -1
        v1 = v2 = 1 << 62
        for i in range(257):  # ties go to the larger symbol
            if freq[i] and freq[i] <= v1:
                v1, c1 = freq[i], i
        for i in range(257):
            if freq[i] and freq[i] <= v2 and i != c1:
                v2, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        size[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            size[c1] += 1
        others[c1] = c2
        size[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            size[c2] += 1
    bits = [0] * 33
    for s in size:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved code point
    symbols = [s for n in range(1, 33) for s in range(256) if size[s] == n]
    return bits[1:17], symbols


class _Events:
    """One restart interval's codes: a Huffman symbol followed by extra
    bits (``sym`` >= 0), or bits alone (``sym`` -1); ``val`` and ``n``
    are the extra bits and their count.  A sequential scan's DC symbols
    are kept as 256 + symbol, so that one code array (DC codes after the
    AC ones) serves both classes."""

    def __init__(self):
        self.sym, self.val, self.n = [], [], []

    def add(self, sym, x):
        """``sym``'s run nibble with the category of the nonzero ``x`` (a
        DC difference where ``sym`` is 0 and 0 is allowed) and its bits."""
        n = abs(x).bit_length()
        self.sym.append(sym | n)
        self.val.append(x if x >= 0 else x + (1 << n) - 1)
        self.n.append(n)

    def pack(self, code, length) -> bytes:
        sym = np.array(self.sym, np.int64)
        n = np.array(self.n, np.int64)
        s = np.maximum(sym, 0)
        vals = np.where(sym >= 0, code[s] << n, 0) | np.array(self.val,
                                                              np.int64)
        lens = np.where(sym >= 0, length[s], 0) + n
        data, (tail, rest) = tjpeg.pack_msb(vals, lens)
        if rest:  # the last byte padded with 1 bits
            data += bytes([(tail << (8 - rest)) | ((1 << (8 - rest)) - 1)])
        return data.replace(b"\xff", b"\xff\x00")


def _ac_first(ev, nz, x, width):
    """One block of an AC first scan: ``nz`` the band positions of its
    nonzero point-transformed values ``x``; one EOB0 where it ends in
    zeros."""
    sym, val, n = ev.sym, ev.val, ev.n
    prev = -1
    for i in nz:
        r = i - prev - 1
        while r > 15:
            sym.append(0xF0)
            val.append(0)
            n.append(0)
            r -= 16
        ev.add(r << 4, x[i])
        prev = i
    if prev < width - 1:
        sym.append(0x00)
        val.append(0)
        n.append(0)


def _ac_refine(ev, nz, t, neg, width):
    """One block of an AC refine scan (``jcphuff.c`` encode_mcu_AC_refine
    with every EOB run one block long): ``nz`` the band positions where
    the point-transformed magnitude ``t`` is nonzero, ``neg`` the signs."""
    sym, val, n = ev.sym, ev.val, ev.n
    eob = max((i for i in nz if t[i] == 1), default=-1)
    prev, r, pending = -1, 0, []
    for i in nz:
        r += i - prev - 1  # the zeros since the last symbol
        prev = i
        while r > 15 and i <= eob:
            sym.append(0xF0)
            val.append(0)
            n.append(0)
            r -= 16
            for b in pending:  # the corrections the ZRL passes over
                sym.append(-1)
                val.append(b)
                n.append(1)
            pending = []
        if t[i] > 1:  # a correction bit for a coefficient known before
            pending.append(t[i] & 1)
            continue
        sym.append((r << 4) | 1)
        val.append(0 if neg[i] else 1)
        n.append(1)
        for b in pending:
            sym.append(-1)
            val.append(b)
            n.append(1)
        pending, r = [], 0
    if prev < width - 1 or pending:
        sym.append(0x00)  # EOB0, then the corrections after the last new one
        val.append(0)
        n.append(0)
        for b in pending:
            sym.append(-1)
            val.append(b)
            n.append(1)


def _segments(data: bytes):
    """(marker, body) of each segment before the first SOS."""
    out, p = [], 2
    while data[p + 1] != 0xDA:
        (n,) = struct.unpack(">H", data[p + 2:p + 4])
        out.append((data[p + 1], data[p + 4:p + 2 + n]))
        p += 2 + n
    return out


def transcode(data: bytes, scans, restart: int = 0) -> bytes:
    """The sequential JPEG ``data`` rewritten as a progressive one with the
    scan script ``scans`` and ``restart`` MCUs a restart interval (0:
    none), its coefficients unchanged."""
    frame = tjpeg._read(data)[0]
    coef = [frame.coef[off:off + by * bx * 64].reshape(-1, 64)
            for off, (by, bx) in zip(frame.offset, frame.blocks)]
    head = [b"\xff\xd8"]
    for marker, body in _segments(data):
        if marker in (0xC0, 0xC1):
            marker = 0xC2
        elif marker in (0xC4, 0xDD):
            continue
        head.append(tjpeg._segment(marker, body))
    if restart:
        head.append(tjpeg._segment(0xDD, struct.pack(">H", restart)))
    out = [b"".join(head)]
    ids = [c[0] for c in frame.comps]
    for members, Ss, Se, Ah, Al in scans:
        order, per_mcu = frame.scan_order(list(members))
        n_mcu = len(order) // per_mcu
        per = restart or n_mcu
        # each member's point-transformed band, as lists a block
        band = {}
        for k in members:
            c = coef[k][:, Ss:Se + 1]
            t = np.abs(c) >> Al
            blk, pos = np.nonzero(t)
            nz = np.split(pos, np.searchsorted(blk, np.arange(1, len(c))))
            # the DC shifts arithmetically (jcphuff.c), an AC's magnitude
            x = c >> Al if Ss == 0 else np.where(c < 0, -t, t)
            band[k] = ([z.tolist() for z in nz], t.tolist(), x.tolist(),
                       (c < 0).tolist())
        intervals = []
        for start in range(0, n_mcu, per):
            ev = _Events()
            pred = [0] * len(ids)
            for k, b in order[start * per_mcu:(start + per) * per_mcu]:
                nz, t, x, neg = band[k]
                if Ss == 0 and not Ah:  # DC first
                    ev.add(0, x[b][0] - pred[k])
                    pred[k] = x[b][0]
                elif Ss == 0:  # DC refine: the next bit
                    ev.sym.append(-1)
                    ev.val.append(x[b][0] & 1)
                    ev.n.append(1)
                elif not Ah:
                    _ac_first(ev, nz[b], x[b], Se - Ss + 1)
                else:
                    _ac_refine(ev, nz[b], t[b], neg[b], Se - Ss + 1)
            intervals.append(ev)
        code = length = np.zeros(256, np.int64)
        if not (Ss == 0 and Ah):  # a DC refine scan has no table
            freq = np.zeros(256, np.int64)
            for ev in intervals:
                s = np.array(ev.sym, np.int64)
                freq += np.bincount(s[s >= 0], minlength=256)
            counts, symbols = optimal_table(freq.tolist())
            cls = 0 if Ss == 0 else 1
            out.append(tjpeg._segment(0xC4, bytes([cls << 4]) + bytes(counts)
                                      + bytes(symbols)))
            code, length = tjpeg._huffman_codes(counts, symbols)
        sos = bytes([len(members)])
        for k in members:
            sos += bytes([ids[k], 0])
        out.append(tjpeg._segment(0xDA, sos + bytes([Ss, Se, (Ah << 4) | Al])))
        for r, ev in enumerate(intervals):
            if r:
                out.append(bytes([0xFF, 0xD0 + (r - 1) % 8]))
            out.append(ev.pack(code, length))
    out.append(b"\xff\xd9")
    return b"".join(out)


# ---------------------------------------------------------------------------
# Sequential Huffman files of 1, 3 or 4 components at any sampling
# ---------------------------------------------------------------------------

JFIF = (0xE0, b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0))


def adobe(transform: int):
    """An Adobe APP14 segment (version 100, no flags) naming ``transform``:
    0 for RGB or CMYK, 1 for YCbCr, 2 for YCCK."""
    return 0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)


def frame_body(H: int, W: int, comps, precision: int = 8) -> bytes:
    """A SOF segment's body; ``comps`` (id, h, v, quantisation table)."""
    return struct.pack(">BHHB", precision, H, W, len(comps)) + b"".join(
        bytes([cid, (h << 4) | v, tq]) for cid, h, v, tq in comps)


def component_plane(plane: np.ndarray, size, H: int, W: int) -> np.ndarray:
    """A full-size (H, W) plane sampled at a component's ``size`` (dh, dw):
    the nearest sample at or above each position, so that any ratio,
    fractional ones too, gives a plane."""
    dh, dw = size
    rows = np.minimum(np.arange(dh) * H // dh, H - 1)
    cols = np.minimum(np.arange(dw) * W // dw, W - 1)
    return plane[rows][:, cols]


def coefficients(frame, planes, tables) -> list:
    """Each component's quantised coefficients over its whole block array,
    (blocks, 64) in zigzag order: the component's samples (``planes`` at
    full size, sampled by ``component_plane``), their last row and column
    repeated to whole blocks, the islow forward DCT and the quantiser of
    the port's encoder with the component's table."""
    out = []
    for k, (_, _, _, tq) in enumerate(frame.comps):
        by, bx = frame.blocks[k]
        p = component_plane(planes[k], frame.comp_size(k), frame.H, frame.W)
        p = np.pad(p.astype(np.int64), ((0, 8 * by - p.shape[0]),
                                        (0, 8 * bx - p.shape[1])), mode="edge")
        blocks = p.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3) - 128
        q = tjpeg._quantize(tjpeg.fdct_islow(blocks.reshape(-1, 8, 8))
                            .reshape(-1, 64), tables[tq])
        out.append(q[:, tjpeg.ZIGZAG])
    return out


def _intervals(frame, restart: int, members):
    """(the scan's blocks in coding order, blocks an MCU, [(first, end)
    block of each restart interval])."""
    order, per_mcu = frame.scan_order(list(members))
    n_mcu = len(order) // per_mcu
    per = restart or n_mcu
    return order, per_mcu, [(s * per_mcu, min(s + per, n_mcu) * per_mcu)
                            for s in range(0, n_mcu, per)]


def _dht(cls: int, tid: int, counts, symbols) -> bytes:
    return tjpeg._segment(0xC4, bytes([(cls << 4) | tid]) + bytes(counts)
                          + bytes(symbols))


def _with_restarts(parts) -> bytes:
    """Restart intervals' bytes joined by RST0-RST7 in turn."""
    out = []
    for r, p in enumerate(parts):
        if r:
            out.append(bytes([0xFF, 0xD0 + (r - 1) % 8]))
        out.append(p)
    return b"".join(out)


def _write_sequential(frame, body: bytes, coef, quant: dict, app,
                      restart: int) -> bytes:
    """A sequential Huffman file of the frame ``body`` (``frame`` its
    geometry) with each component's zigzag coefficients ``coef``: SOI,
    ``app``, a DQT a table of ``quant`` {id: natural-order table}, the SOF,
    one DC and one AC table built for the scan, DRI where ``restart``, one
    interleaved scan (one component: its own blocks), EOI."""
    nc = len(frame.comps)
    order, _, spans = _intervals(frame, restart, range(nc))
    intervals = []
    for a, b in spans:
        ev, pred = _Events(), [0] * nc
        for k, blk in order[a:b]:
            c = coef[k][blk].tolist()
            ev.add(256, c[0] - pred[k])
            pred[k] = c[0]
            _ac_first(ev, [i for i in range(63) if c[1 + i]], c[1:], 63)
        intervals.append(ev)
    freq = np.zeros(512, np.int64)
    for ev in intervals:
        s = np.array(ev.sym, np.int64)
        freq += np.bincount(s[s >= 0], minlength=512)
    ac, dc = optimal_table(freq[:256].tolist()), optimal_table(
        freq[256:].tolist())
    code_ac, len_ac = tjpeg._huffman_codes(*ac)
    code_dc, len_dc = tjpeg._huffman_codes(*dc)
    code = np.concatenate([code_ac, code_dc])
    length = np.concatenate([len_ac, len_dc])
    out = [b"\xff\xd8"] + [tjpeg._segment(m, b) for m, b in app]
    for t, q in sorted(quant.items()):
        out.append(tjpeg._segment(0xDB, bytes([t]) + np.asarray(q)[
            tjpeg.ZIGZAG].astype(np.uint8).tobytes()))
    out += [tjpeg._segment(0xC0, body), _dht(0, 0, *dc), _dht(1, 0, *ac)]
    if restart:
        out.append(tjpeg._segment(0xDD, struct.pack(">H", restart)))
    out.append(tjpeg._segment(0xDA, bytes([nc]) + b"".join(
        bytes([c[0], 0]) for c in frame.comps) + bytes([0, 63, 0])))
    out.append(_with_restarts([ev.pack(code, length) for ev in intervals]))
    return b"".join(out) + b"\xff\xd9"


def sequential(planes, factors=None, ids=None, app=(JFIF,),
               restart: int = 0) -> bytes:
    """A sequential Huffman JPEG of full-size u8 ``planes`` (1, 3 or 4 of
    them, (H, W) each; the components' own samples, no colour conversion)
    with sampling ``factors`` [(h, v)] (default 1x1), component ``ids``
    (default 1, 2, ...), the segments ``app`` [(marker, body)] after SOI,
    ``restart`` MCUs a restart interval, one interleaved scan (one scan of
    one component for a single plane) and Huffman tables built for the
    scan.  Quality 95's tables: the luminance one for the first and fourth
    component, the chrominance one for the others.  The frame is written
    as the arguments say, what a decoder refuses too (2 components,
    fractional sampling ratios)."""
    nc = len(planes)
    H, W = planes[0].shape
    factors = factors or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    tables = tjpeg._quality_tables()
    comps = [(ids[k], h, v, 0 if k in (0, 3) else 1)
             for k, (h, v) in enumerate(factors)]
    body = frame_body(H, W, comps)
    frame = tjpeg._Frame(body)
    return _write_sequential(
        frame, body, coefficients(frame, planes, tables),
        {c[3]: tables[c[3]] for c in comps}, app, restart)


def recomponent(data: bytes, picks, app=(), restart: int = 0) -> bytes:
    """A sequential Huffman JPEG whose components are copies of the JPEG
    ``data``'s components ``picks`` (their sampling, quantisation tables
    and coefficients), with ids 1, 2, ... and the segments ``app``:
    ``(0, 1, 2, 0)`` with an Adobe marker makes a CMYK or YCCK file whose
    K is the first component, ``(0, 1, 2)`` with ``adobe(0)`` one whose
    decode is the components' upsampled planes (no colour conversion)."""
    src = tjpeg._read(data)[0]
    comps = [(k + 1,) + src.comps[j][1:] for k, j in enumerate(picks)]
    body = frame_body(src.H, src.W, comps)
    frame = tjpeg._Frame(body)
    coef = [src.coef[src.offset[j]:src.offset[j] + by * bx * 64]
            .reshape(-1, 64) for j, (by, bx) in
            zip(picks, (src.blocks[j] for j in picks))]
    quant = {src.comps[j][3]: src.quant[j] for j in picks}
    return _write_sequential(frame, body, coef, quant, app, restart)


# ---------------------------------------------------------------------------
# Lossless files (SOF3): predictors 1-7, the point transform, restarts
# ---------------------------------------------------------------------------

def _predict(x: np.ndarray, psv: int, first, start: int) -> np.ndarray:
    """The predictions of T.81 H.1.2.1 for the samples ``x`` (rows by
    columns, ints), rows in ``first`` starting a scan or restart interval
    (the first sample ``start``, the others the sample to the left), the
    first sample of any other row the one above it."""
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    corner = np.concatenate([up[:, :1], up[:, :-1]], axis=1)
    a, b, c = left, up, corner
    pred = {1: a, 2: b, 3: c, 4: a + b - c, 5: a + ((b - c) >> 1),
            6: b + ((a - c) >> 1), 7: (a + b) >> 1}[psv].copy()
    pred[:, 0] = up[:, 0]
    pred[first] = left[first]
    pred[first, 0] = start
    return pred


def lossless(planes, psv: int = 1, pt: int = 0, precision: int = 8,
             factors=None, ids=None, app=(), restart_rows: int = 0) -> bytes:
    """A lossless Huffman JPEG (SOF3) of full-size integer ``planes`` (1
    to 4, values under 2**precision): predictor ``psv``, point transform
    ``pt``, sampling ``factors`` [(h, v)] (components sampled as in
    ``component_plane``), component ``ids``, the segments ``app`` after
    SOI, a restart interval of ``restart_rows`` MCU rows (0: none), one
    interleaved scan (one scan of one component for a single plane) and a
    Huffman table built for the differences.  The differences are taken modulo 2**16 as T.81 H.1.2.1 says,
    where 32768 has category 16 and no extra bits."""
    nc = len(planes)
    H, W = planes[0].shape
    factors = factors or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    comps = [(ids[k], h, v, 0) for k, (h, v) in enumerate(factors)]
    body = frame_body(H, W, comps, precision)
    frame = tjpeg._Frame(body, "lossless")
    cats, extras = [], []
    for k, (_, h, v, _) in enumerate(comps):
        size = frame.comp_size(k)
        x = component_plane(planes[k], size, H, W).astype(np.int64) >> pt
        rows = np.arange(size[0])
        span = restart_rows * (v if nc > 1 else 1)
        first = rows % span == 0 if span else rows == 0
        d = (x - _predict(x, psv, first, 1 << (precision - pt - 1))) & 0xFFFF
        d = np.where(d > 32768, d - 65536, d)
        # the MCU grid: dummy samples past the component's own difference 0
        by, bx = frame.blocks[k]
        full = np.zeros((by, bx), np.int64)
        full[:size[0], :size[1]] = d
        cats.append(full.ravel())
    # MCUs a row: the MCU columns, or the samples of a one-component row
    per_row = frame.mcus_x if nc > 1 else frame.comp_size(0)[1]
    order, _, spans = _intervals(frame, restart_rows * per_row, range(nc))
    flat = np.concatenate(cats)
    starts = np.cumsum([0] + [c.size for c in cats])[:-1]
    idx = np.array([starts[k] + b for k, b in order], np.int64)
    diff = flat[idx]
    mag = np.abs(diff)
    cat = np.where(diff == 32768, 16, np.frexp(mag.astype(np.float64))[1])
    nbits = np.where(cat == 16, 0, cat)
    extra = np.where(diff < 0, diff + (1 << nbits) - 1, diff) \
        & ((1 << nbits) - 1)
    table = optimal_table(np.bincount(cat, minlength=256).tolist())
    code, length = tjpeg._huffman_codes(*table)
    parts = []
    for a, b in spans:
        data, (tail, rest) = tjpeg.pack_msb(
            (code[cat[a:b]] << nbits[a:b]) | extra[a:b],
            length[cat[a:b]] + nbits[a:b])
        if rest:
            data += bytes([(tail << (8 - rest)) | ((1 << (8 - rest)) - 1)])
        parts.append(data.replace(b"\xff", b"\xff\x00"))
    out = [b"\xff\xd8"] + [tjpeg._segment(m, b) for m, b in app]
    out += [tjpeg._segment(0xC3, body), _dht(0, 0, *table)]
    if restart_rows:
        out.append(tjpeg._segment(0xDD, struct.pack(">H",
                                                    restart_rows * per_row)))
    out.append(tjpeg._segment(0xDA, bytes([nc]) + b"".join(
        bytes([cid, 0]) for cid in ids) + bytes([psv, 0, pt])))
    out.append(_with_restarts(parts))
    return b"".join(out) + b"\xff\xd9"


# ---------------------------------------------------------------------------
# Arithmetic coding (jcarith.c): a file's coefficients as SOF9 or SOF10
# ---------------------------------------------------------------------------

class QMEncoder:
    """T.81 Annex D's QM encoder as ``jcarith.c`` runs it (arith_encode,
    its carry and 0xFF stacking, finish_pass), over the statistics bins
    the decoder reads (``utils/jpeg._ARITAB``)."""

    def __init__(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1
        self.out = bytearray()

    def _emit_zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte_out(self, temp: int) -> None:
        """One byte ready (``temp`` = C >> 19): the carry into the bytes
        held back, the stacked 0xFF bytes, or the new byte held back."""
        if temp > 0xFF:  # a carry over the stacked 0xFF bytes
            if self.buffer >= 0:
                self._emit_zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc  # the stacked 0xFF bytes became 0x00
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._emit_zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, st, i: int, val: int) -> None:
        sv = st[i]
        qe, nl, nm = tjpeg._ARITAB[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:  # renormalise (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        """D.1.8: the C in the interval with the most trailing zero bits,
        then the bytes left, those of value zero at the end left out."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._emit_zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._emit_zeros()
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if not self.c & mask:
                    break
                b = (self.c >> shift) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


def _encode_magnitude(enc, st, sp, v, first) -> None:
    """F.8 and F.9 for |v| >= 1 from the bin ``sp`` (``first`` the bins of
    the categories from 2 up in an AC table, None for a DC value)."""
    v -= 1
    m = 0
    if v:
        enc.encode(st, sp, 1)
        m = 1
        v2 = v >> 1
        if first is None:
            sp = 20
            while v2:
                enc.encode(st, sp, 1)
                m <<= 1
                sp += 1
                v2 >>= 1
        elif v2:
            enc.encode(st, sp, 1)
            m <<= 1
            sp = first
            v2 >>= 1
            while v2:
                enc.encode(st, sp, 1)
                m <<= 1
                sp += 1
                v2 >>= 1
    enc.encode(st, sp, 0)
    sp += 14
    m >>= 1
    while m:
        enc.encode(st, sp, 1 if m & v else 0)
        m >>= 1


def _encode_dc(enc, st, ctx: int, v: int, L: int, U: int) -> int:
    """One DC difference (F.4): returns the component's next context."""
    if v == 0:
        enc.encode(st, ctx, 0)
        return 0
    enc.encode(st, ctx, 1)
    enc.encode(st, ctx + 1, 1 if v < 0 else 0)
    sign = int(v < 0)
    a = -v if v < 0 else v
    _encode_magnitude(enc, st, ctx + 2 + sign, a, None)
    m = 1 << ((a - 1).bit_length() - 1) if a > 1 else 0
    if m < (1 << L) >> 1:
        return 0
    return (12 if m > (1 << U) >> 1 else 4) + 4 * sign


def _encode_ac(enc, st, fixed, k: int, v: int, K: int) -> None:
    enc.encode(fixed, 0, 1 if v < 0 else 0)
    _encode_magnitude(enc, st, 3 * (k - 1) + 2, abs(v),
                      189 if k <= K else 217)


def _arith_block(enc, kind, blk, st_dc, st_ac, fixed, state, ci, Ss, Se,
                 Ah, Al, cond):
    """One block of a scan (``jcarith.c`` encode_mcu and the four
    progressive encoders); ``kind`` None for a sequential scan."""
    (L, U, K), last, ctx = cond, state[0], state[1]
    if kind in (None, "dc_first"):
        x = blk[0] >> Al
        ctx[ci] = _encode_dc(enc, st_dc, ctx[ci], x - last[ci], L, U)
        last[ci] = x
        if kind is None:
            ke = max((k for k in range(1, 64) if blk[k]), default=0)
            k = 1
            while k <= ke:
                sp = 3 * (k - 1)
                enc.encode(st_ac, sp, 0)
                while not blk[k]:
                    enc.encode(st_ac, sp + 1, 0)
                    sp += 3
                    k += 1
                enc.encode(st_ac, sp + 1, 1)
                _encode_ac(enc, st_ac, fixed, k, blk[k], K)
                k += 1
            if k <= 63:
                enc.encode(st_ac, 3 * (k - 1), 1)
        return
    if kind == "dc_refine":
        enc.encode(fixed, 0, (blk[0] >> Al) & 1)
        return
    t = [abs(blk[k]) >> Al for k in range(64)]
    ke = max((k for k in range(Ss, Se + 1) if t[k]), default=0)
    kex = 0
    if kind == "ac_refine":
        kex = max((k for k in range(1, ke + 1) if abs(blk[k]) >> Ah),
                  default=0)
    k = Ss
    while k <= ke:
        sp = 3 * (k - 1)
        if kind == "ac_first" or k > kex:
            enc.encode(st_ac, sp, 0)
        while True:
            if t[k]:
                if kind == "ac_refine" and t[k] >> 1:  # a correction bit
                    enc.encode(st_ac, sp + 2, t[k] & 1)
                else:
                    enc.encode(st_ac, sp + 1, 1)
                    if kind == "ac_first":
                        _encode_ac(enc, st_ac, fixed, k,
                                   -t[k] if blk[k] < 0 else t[k], K)
                    else:
                        enc.encode(fixed, 0, 1 if blk[k] < 0 else 0)
                break
            enc.encode(st_ac, sp + 1, 0)
            sp += 3
            k += 1
        k += 1
    if k <= Se:
        enc.encode(st_ac, 3 * (k - 1), 1)


def arithmetic(data: bytes, scans=None, restart: int = 0, dac=()) -> bytes:
    """The JPEG ``data``'s quantised coefficients (any file the port's
    decoder reads in the DCT modes) rewritten arithmetic-coded, as
    ``jcarith.c`` codes them: sequential (SOF9, one interleaved scan, one
    scan of one component for gray) where ``scans`` is None, else
    progressive (SOF10) under the script ``scans`` (as ``transcode``
    takes it); ``restart`` MCUs a restart interval; ``dac`` [(class,
    table, value)] the conditioning a DAC segment sets (class 0: value
    U << 4 | L, class 1: Kx).  The first component takes table 0, the
    others table 1 (so they share the statistics of one table).  No cv2
    writes such files; the port's decoder and cv2's read them."""
    frame = tjpeg._read(data)[0]
    nc = len(frame.comps)
    coef = [frame.coef[off:off + by * bx * 64].reshape(-1, 64).tolist()
            for off, (by, bx) in zip(frame.offset, frame.blocks)]
    cond = {(0, t): (0, 1) for t in range(2)}
    K = {t: 5 for t in range(2)}
    for cls, t, val in dac:
        if cls:
            K[t] = val
        else:
            cond[(0, t)] = (val & 15, val >> 4)
    head = [b"\xff\xd8"]
    for marker, body in _segments(data):
        if marker in (0xC0, 0xC1, 0xC2):
            marker = 0xC9 if scans is None else 0xCA
        elif marker in (0xC4, 0xDD):
            continue
        head.append(tjpeg._segment(marker, body))
    if dac:
        head.append(tjpeg._segment(0xCC, b"".join(
            bytes([(cls << 4) | t, val]) for cls, t, val in dac)))
    if restart:
        head.append(tjpeg._segment(0xDD, struct.pack(">H", restart)))
    out = [b"".join(head)]
    ids = [c[0] for c in frame.comps]
    tab = [0 if k == 0 else 1 for k in range(nc)]
    for members, Ss, Se, Ah, Al in (scans or [(tuple(range(nc)), 0, 63, 0,
                                                0)]):
        if scans is None:
            kind = None
        elif Ss == 0:
            kind = "dc_refine" if Ah else "dc_first"
        else:
            kind = "ac_refine" if Ah else "ac_first"
        order, _, spans = _intervals(frame, restart, members)
        parts = []
        for a, b in spans:
            enc = QMEncoder()
            st_dc = {t: bytearray(64) for t in set(tab)}
            st_ac = {t: bytearray(256) for t in set(tab)}
            fixed = bytearray([tjpeg.FIXED_BIN])
            state = ([0] * nc, [0] * nc)
            for k, blk in order[a:b]:
                t = tab[k]
                _arith_block(enc, kind, coef[k][blk], st_dc[t], st_ac[t],
                             fixed, state, k, Ss, Se, Ah, Al,
                             cond[(0, t)] + (K[t],))
            parts.append(enc.finish())
        sos = bytes([len(members)]) + b"".join(
            bytes([ids[k], (tab[k] << 4) | tab[k]]) for k in members)
        out.append(tjpeg._segment(0xDA, sos + bytes([Ss, Se, (Ah << 4) | Al])))
        out.append(_with_restarts(parts))
    out.append(b"\xff\xd9")
    return b"".join(out)


# ---------------------------------------------------------------------------
# EXIF: a TIFF structure with an Orientation, in a JPEG's APP1 or a PNG's
# eXIf chunk
# ---------------------------------------------------------------------------

def exif_tiff(orientation: int = 1, order: str = "II", ifd: int = 8,
              entries=None) -> bytes:
    """A TIFF structure as an APP1 ``Exif`` segment or a PNG ``eXIf``
    chunk holds it: byte order ``order`` ("II" or "MM"), IFD0 at the
    offset ``ifd`` (zero bytes before it), its ``entries`` [(tag, type,
    count, value)] (by default one SHORT Orientation of ``orientation``;
    a SHORT value in the entry's first two bytes, any other type's in its
    four), no next IFD."""
    e = "<" if order == "II" else ">"
    out = order.encode() + struct.pack(e + "HI", 42, ifd) + bytes(ifd - 8)
    entries = [(0x0112, 3, 1, orientation)] if entries is None else entries
    out += struct.pack(e + "H", len(entries))
    for tag, typ, count, value in entries:
        val = (struct.pack(e + "HH", value, 0) if typ == 3
               else struct.pack(e + "I", value))
        out += struct.pack(e + "HHI", tag, typ, count) + val
    return out + struct.pack(e + "I", 0)


def with_app1(data: bytes, *bodies) -> bytes:
    """The JPEG ``data`` with an APP1 segment of each body inserted after
    SOI and a JFIF APP0 (``b"Exif\\0\\0" + exif_tiff(...)`` for EXIF)."""
    p = 2
    if data[2:4] == b"\xff\xe0":
        p = 4 + struct.unpack(">H", data[4:6])[0]
    return data[:p] + b"".join(tjpeg._segment(0xE1, b) for b in bodies) \
        + data[p:]


def with_png_chunks(data: bytes, chunks, after_idat: bool = False) -> bytes:
    """The PNG ``data`` with the whole chunks ``chunks`` (bytes each)
    inserted before its first IDAT, or before IEND."""
    p = data.index(b"IEND" if after_idat else b"IDAT") - 4
    return data[:p] + b"".join(chunks) + data[p:]
