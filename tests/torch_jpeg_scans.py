"""A lossless baseline-to-progressive JPEG transcoder, numpy only, for the
tests of the port's progressive decoder and for ``chip_smoke.py`` (whose
machine has no cv2).

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
"""

from __future__ import annotations

import struct

import numpy as np

from underwater_image_enhancement_tpu_torch.utils import jpeg as tjpeg


def _progression(nc: int):
    """jcparam.c jpeg_simple_progression: the script cv2 writes with
    IMWRITE_JPEG_PROGRESSIVE (10 scans for YCbCr, 6 for gray)."""
    if nc == 1:
        return [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]
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
    are the extra bits and their count."""

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
