"""CCITT bi-level strips and tiles (TIFF compressions 2, 3, 4 and 32771),
decoded as libtiff 4.7.1's ``tif_fax3.c``, the codec inside cv2 5.0.0,
decodes them, errors included.

The codes are T.4's: white and black terminating codes (runs 0-63),
make-up codes (64-1728) and the make-up codes both colours share
(1792-2560), the EOL (eleven zeros and a one), and the 2-D modes (pass,
horizontal, V0, VR1-3, VL1-3, and the extension code, which libtiff does
not decode).  ``_tables`` are libtiff's lookup tables (``tif_fax3sm.c``):
12 bits a white code, 13 a black one, 7 a mode, each entry (state, bits
taken, run), eleven zeros an EOL (seven in the mode table), any other
unknown code a "bad code word" that takes no bits.

``FaxDecoder`` keeps libtiff's state for one image: the run arrays, which
later strips and rows see as they were left, and per strip the bit
accumulator (bytes taken least significant bit first after each byte's
bits are reversed, the stream padded with zeros past its end), the EOL
count and the reference line (all white at a strip's start).

- Compression 2 (RLE): Modified Huffman rows, no EOL, the leftover bits
  of the accumulator's last byte dropped after each row; 32771 (RLEW) the
  same to 16 bits: the accumulator's bits past a multiple of 16 dropped,
  and a byte skipped where none are left at an odd file offset
  (libtiff's alignment of the mapped file, not of the stream).
- Compression 3 (Group 3): each row found past an EOL (bits are skipped
  to one, then zeros); with T4Options bit 0 each EOL is followed by a tag
  bit, 1 for a 1-D row, 0 for a 2-D one.
- Compression 4 (Group 4): 2-D rows with no EOL, the first against an
  all-white line; an EOL (the EOFB) ends the strip.

Errors as libtiff meets them: a row whose runs fall short of its width
is filled white, one that runs past it loses the runs that cross it
(``CLEANUP_RUNS``); an unknown code ends its row there; the data's end ends
the strip after its row is filled; a row of more runs than the arrays
hold ends the strip before it is filled.  What a strip does not decode
stays 0 (white), as in the zeroed buffer of libtiff's RGBA reader.
"""

from __future__ import annotations

import functools

import numpy as np

# libtiff's table states
(_NULL, _PASS, _HORIZ, _V0, _VR, _VL, _EXT, _TERMW, _TERMB, _MAKEUPW,
 _MAKEUPB, _MAKEUP, _EOL) = range(13)

WHITE_TERMINATING = (
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100")
BLACK_TERMINATING = (
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111")
# make-up codes of 64, 128, ..., 1728
WHITE_MAKEUP = (
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011")
BLACK_MAKEUP = (
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101")
# the make-up codes of both colours: 1792, 1856, ..., 2560
SHARED_MAKEUP = (
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111")
EOL = "000000000001"
# the 2-D modes: (code, state, parameter)
MODES = {"pass": ("0001", _PASS, 0), "horizontal": ("001", _HORIZ, 0),
         "V0": ("1", _V0, 0), "VR1": ("011", _VR, 1),
         "VR2": ("000011", _VR, 2), "VR3": ("0000011", _VR, 3),
         "VL1": ("010", _VL, 1), "VL2": ("000010", _VL, 2),
         "VL3": ("0000010", _VL, 3), "extension": ("0000001", _EXT, 0)}

RLE, RLEW, G3, G4 = 2, 32771, 3, 4
_M32 = 0xFFFFFFFF


def _table(size: int, codes) -> list:
    """libtiff's ``FillTable``: each code's entry at every index of
    ``size`` bits whose low bits are the code read first bit first."""
    table = [(_NULL, 0, 0)] * (1 << size)
    for bits, state, param in codes:
        first = int(bits[::-1], 2)
        for index in range(first, 1 << size, 1 << len(bits)):
            table[index] = (state, len(bits), param)
    return table


@functools.cache
def _tables() -> tuple:
    """libtiff's white, black and mode tables, built at first use."""
    eol = [("0" * 11, _EOL, 0)]
    shared = [(c, _MAKEUP, 1792 + 64 * k)
              for k, c in enumerate(SHARED_MAKEUP)]
    tables = []
    for makeup, state, term, terminating in (
            (WHITE_MAKEUP, _MAKEUPW, _TERMW, WHITE_TERMINATING),
            (BLACK_MAKEUP, _MAKEUPB, _TERMB, BLACK_TERMINATING)):
        tables.append([(c, state, 64 * (k + 1)) for k, c in enumerate(makeup)]
                      + shared + [(c, term, k)
                                  for k, c in enumerate(terminating)] + eol)
    white, black = tables
    main = list(MODES.values()) + [("0" * 7, _EOL, 0)]
    return _table(12, white), _table(13, black), _table(7, main)


_REVERSE = bytes(int(f"{v:08b}"[::-1], 2) for v in range(256))


def _i32(x: int) -> int:
    """A C ``int`` of a sum wider than 32 bits."""
    return ((x + 0x80000000) & _M32) - 0x80000000


class _EndOfData(Exception):
    """The stream ran out with no bits left (libtiff's ``eoflab``)."""


class _Overflow(Exception):
    """A run past the run arrays: libtiff's decoder returns at once."""


class FaxDecoder:
    """One image's CCITT decoder: ``compression`` 2, 3, 4 or 32771,
    ``options`` the T4Options of a Group 3 file, rows ``width`` pixels
    wide (the tile width in tiles).  ``decode`` takes the strips or tiles
    in the order libtiff's RGBA reader reads them."""

    def __init__(self, compression: int, width: int, options: int = 0):
        self.mode = compression
        self.two_d = compression == G4 or (compression == G3 and options & 1)
        self.width = width
        nruns = -(-(width + 1) // 32) * 32
        self.nruns = nruns * 2 if self.two_d else nruns
        self.runs = [0] * (2 * self.nruns)
        self.no_eol = False

    def decode(self, chunk: bytes, rows: int, offset: int = 0) -> bytes:
        """A strip or tile's coded bytes (first bit most significant; a
        FillOrder 2 chunk reversed before) at file ``offset`` -> ``rows``
        rows of ``ceil(width / 8)`` bytes, 1 bits black."""
        bits = np.zeros((rows, self.width + 1), np.int8)
        spans = _decode(self, chunk.translate(_REVERSE), rows, offset & 1)
        if spans:
            r, x0, x1 = (np.asarray(v) for v in zip(*spans))
            flat = bits.reshape(-1)
            np.add.at(flat, r * (self.width + 1) + x0, 1)
            np.add.at(flat, r * (self.width + 1) + x1, -1)
        on = np.cumsum(bits[:, :self.width], axis=1, dtype=np.int8) > 0
        return np.packbits(on, axis=1).tobytes()


def _decode(st: FaxDecoder, data: bytes, nrows: int, odd: int) -> list:
    """The strip's black spans (row, first, past last) as ``Fax3DecodeRLE``,
    ``Fax3Decode1D``, ``Fax3Decode2D`` or ``Fax4Decode`` fill them."""
    white, black, main = _tables()
    runs, nruns, lastx = st.runs, st.nruns, st.width
    end = len(data)
    acc = avail = pos = 0
    eolcnt = 0
    a0 = rl = pa = pb = b1 = 0
    thisrun = cur = 0
    ref = nruns
    if st.two_d:
        runs[ref], runs[ref + 1] = lastx, 0
    spans = []

    def need(n):
        """``NeedBits8``/``NeedBits16``: a byte or two more where fewer
        than ``n`` bits are held; past the data's end zeros, or the end
        where no bit is left."""
        nonlocal acc, avail, pos
        if avail < n:
            if pos >= end:
                if avail == 0:
                    raise _EndOfData
                avail = n
            else:
                acc |= data[pos] << avail
                pos += 1
                avail += 8
                if avail < n:
                    if pos >= end:
                        avail = n
                    else:
                        acc |= data[pos] << avail
                        pos += 1
                        avail += 8

    def look(n, table):
        nonlocal acc, avail
        need(n)
        ent = table[acc & ((1 << n) - 1)]
        acc >>= ent[1]
        avail -= ent[1]
        return ent

    def drop(n):
        nonlocal acc, avail
        acc >>= n
        avail -= n

    def setvalue(x):
        nonlocal pa, a0, rl
        if pa >= thisrun + nruns:
            raise _Overflow
        runs[pa] = (rl + x) & _M32
        pa += 1
        a0 = _i32(a0 + x)
        rl = 0

    def cleanup():
        """``CLEANUP_RUNS``: a pending make-up run kept; a row short of
        its width filled white, one past it cut back to the runs inside
        and filled white."""
        nonlocal pa, a0
        if rl:
            setvalue(0)
        if a0 != lastx:
            while a0 > lastx and pa > thisrun:
                pa -= 1
                a0 = _i32(a0 - runs[pa])
            if a0 < lastx:
                if a0 < 0:
                    a0 = 0
                if (pa - thisrun) & 1:
                    setvalue(0)
                setvalue(lastx - a0)
            elif a0 > lastx:
                setvalue(lastx)
                setvalue(0)

    def fill(row):
        """``_TIFFFax3fillruns``: an odd count padded with 0, each run cut
        at the row's end in the array itself, black runs kept."""
        stop = pa
        if (stop - thisrun) & 1:
            runs[stop] = 0
            stop += 1
        x = 0
        for i in range(thisrun, stop, 2):
            run = runs[i]
            if x + run > lastx or run > lastx:
                run = runs[i] = lastx - x
            x += run
            run = runs[i + 1]
            if x + run > lastx or run > lastx:
                run = runs[i + 1] = lastx - x
            if run:
                spans.append((row, x, x + run))
                x += run

    def sync_eol():
        """``SYNC_EOL``: unless an EOL was just read, bits skipped one at
        a time to eleven zeros; then zero bytes, zero bits, and the one.
        Where the data ends first, libtiff (from 4.6) takes the image for
        one without EOLs: the strip is read again from its start for this
        row on, and later rows and strips look for no EOL."""
        nonlocal eolcnt, acc, avail, pos
        if st.no_eol:
            return
        try:
            if eolcnt == 0:
                while True:
                    need(11)
                    if acc & 0x7FF == 0:
                        break
                    drop(1)
            while True:
                need(8)
                if acc & 0xFF:
                    break
                drop(8)
        except _EndOfData:
            st.no_eol = True
            acc = avail = pos = eolcnt = 0
            return
        while acc & 1 == 0:
            drop(1)
        drop(1)
        eolcnt = 0

    def run_codes(one_d, table, term, makeup):
        """One run's make-up codes and terminating code; False where the
        row ends at an unknown code or an EOL (which ``EXPAND1D`` counts,
        and ``EXPAND2D`` takes for an unknown code)."""
        nonlocal a0, rl, eolcnt
        width = 12 if table is white else 13
        while True:
            state, _, param = look(width, table)
            if state == term:
                setvalue(param)
                return True
            if state == makeup or state == _MAKEUP:
                a0 += param
                rl += param
                continue
            if state == _EOL and one_d:
                eolcnt = 1
            return False

    def expand1d():
        """``EXPAND1D``: white and black runs to the row's width; a pair of
        empty runs dropped."""
        nonlocal pa
        while True:
            if not run_codes(True, white, _TERMW, _MAKEUPW) or a0 >= lastx:
                break
            if not run_codes(True, black, _TERMB, _MAKEUPB) or a0 >= lastx:
                break
            if runs[pa - 1] == 0 and runs[pa - 2] == 0:
                pa -= 2
        cleanup()

    def check_b1():
        nonlocal b1, pb
        if pa != thisrun:
            while b1 <= a0 and b1 < lastx:
                if pb + 1 >= ref + nruns:
                    raise _Overflow
                b1 = _i32(b1 + ((runs[pb] + runs[pb + 1]) & _M32))
                pb += 2

    def next_b1():
        nonlocal b1, pb
        if pb >= ref + nruns:
            raise _Overflow
        b1 = _i32(b1 + runs[pb])
        pb += 1

    def expand2d():
        """``EXPAND2D``: modes to the row's width; a run left open at the
        width wants a final V0; an EOL or the extension code ends the row
        with a run to the width in the current colour."""
        nonlocal pa, a0, rl, b1, pb, eolcnt
        while a0 < lastx:
            if pa >= thisrun + nruns:
                raise _Overflow
            state, _, param = look(7, main)
            if state == _PASS:
                check_b1()
                if pb + 1 >= ref + nruns:
                    raise _Overflow
                next_b1()
                rl += b1 - a0
                a0 = b1
                next_b1()
            elif state == _HORIZ:
                if (pa - thisrun) & 1:
                    ok = (run_codes(False, black, _TERMB, _MAKEUPB)
                          and run_codes(False, white, _TERMW, _MAKEUPW))
                else:
                    ok = (run_codes(False, white, _TERMW, _MAKEUPW)
                          and run_codes(False, black, _TERMB, _MAKEUPB))
                if not ok:
                    break
                check_b1()
            elif state == _V0 or state == _VR:
                check_b1()
                setvalue(b1 - a0 + param)
                next_b1()
            elif state == _VL:
                check_b1()
                if b1 < a0 + param:
                    break
                setvalue(b1 - a0 - param)
                pb -= 1
                b1 = _i32(b1 - runs[pb])
            elif state == _EXT or state == _EOL:
                runs[pa] = (lastx - a0) & _M32
                pa += 1
                if state == _EOL:
                    need(4)
                    drop(4)
                    eolcnt = 1
                break
            else:
                break
        else:
            if rl:
                if rl + a0 < lastx:
                    need(1)
                    if not acc & 1:
                        cleanup()
                        return
                    drop(1)
                setvalue(0)
        cleanup()

    line = 0
    try:
        while line < nrows:
            a0 = rl = 0
            if st.two_d:
                pa = thisrun = cur
                pb = ref
            else:
                pa = thisrun
            try:
                if st.mode == G4:
                    b1 = _i32(runs[pb])
                    pb += 1
                    expand2d()
                    if eolcnt:  # the EOFB, or an EOL: the strip ends
                        fill(line)
                        break
                elif st.two_d:  # Group 3 2-D: a tag bit past each EOL
                    sync_eol()
                    need(1)
                    one_d = acc & 1
                    drop(1)
                    b1 = _i32(runs[pb])
                    pb += 1
                    if one_d:
                        expand1d()
                    else:
                        expand2d()
                elif st.mode == G3:
                    sync_eol()
                    expand1d()
                else:
                    expand1d()
            except _EndOfData:
                cleanup()
                fill(line)
                break
            fill(line)
            if st.mode == RLE:
                drop(avail & 7)
            elif st.mode == RLEW:
                drop(avail & 15)
                if avail == 0 and (pos + odd) & 1:
                    pos += 1
            if st.two_d:
                if pa < thisrun + nruns or st.mode == G4:
                    setvalue(0)  # the imaginary change for the reference
                cur, ref = ref, cur
            line += 1
    except _Overflow:
        pass
    return spans
