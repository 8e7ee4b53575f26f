"""The netpbm family and PFM in numpy, after OpenCV's ``grfmt_pxm.cpp``,
``grfmt_pam.cpp`` and ``grfmt_pfm.cpp``: ``decode_pnm`` (P1-P6),
``decode_pam`` (P7) and ``decode_pfm`` (``PF``/``Pf``) read what
``cv2.imdecode`` of cv2 5.0.0 reads, with its samples, in
``IMREAD_UNCHANGED`` or (``color=True``) ``IMREAD_COLOR``, and raise
ValueError where it gives None or raises.  The encoders write the bytes
``cv2.imencode`` writes for an RGB frame as ``.ppm``/``.pnm`` (P6),
``.pam`` and ``.pfm``; for ``.pgm`` and ``.pbm`` cv2 refuses a colour
frame, and ``refuse_colour`` raises ValueError.

Arrays are cv2's with the colour channels in RGB order (alpha stays
last); a gray image is 2-D.  What cv2 does, and so what these do:

- P1-P6: header numbers may be split by any whitespace and ``#`` comments
  (to the end of the line); one byte after the last header number is
  skipped and the samples start there.  A maxval above 255 gives uint16.
  ASCII samples past maxval are clipped to it, and at 8 bits scaled by
  ``v * 255 // maxval``; binary samples are taken as they are.  P1's
  ``1`` and P4's set bits are black.  ``IMREAD_COLOR`` gives three
  channels of 8 bits, a 16-bit sample ``v >> 8``.
- P7: the header lines are case-sensitive; WIDTH, HEIGHT, DEPTH (1-4) and
  MAXVAL are needed, TUPLTYPE is needed unless DEPTH is 1 (maxval under
  256) or 3 (maxval under 256), and must match DEPTH.  The colour samples
  are read as if they were in BGR order.  MAXVAL 1 reads each row's first
  ``ceil(W / 8)`` bytes as bits (set: 255), which cv2 refuses for DEPTH 2
  and 4 in ``IMREAD_UNCHANGED``.  In ``IMREAD_COLOR`` cv2 converts only
  the first ``ceil(W / DEPTH)`` pixels of a DEPTH 2 or 4 row and leaves
  the rest unwritten; here every pixel is converted.
- PFM: rows bottom-up, the scale's sign the byte order (negative: little
  endian), samples multiplied by ``float32(1 / |scale|)`` unless it is 1;
  ``IMREAD_COLOR`` rounds half to even and saturates (``float_to_u8``),
  and keeps a gray ``Pf`` 2-D (``cv2.imdecode``; ``cv2.imread`` of the
  file gives None there).
"""

from __future__ import annotations

import re

import numpy as np

# cv2's validateInputImageSize
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30
_INT_MAX = (1 << 31) - 1
_SPACE = b" \t\n\v\f\r"
_DIGITS = b"0123456789"


def check_size(width: int, height: int) -> None:
    """ValueError for an image cv2 refuses by its size."""
    if not (0 < width <= MAX_SIDE and 0 < height <= MAX_SIDE
            and width * height <= MAX_PIXELS):
        raise ValueError(f"image size {width}x{height} refused")


def float_to_u8(v: np.ndarray) -> np.ndarray:
    """OpenCV's ``saturate_cast<uchar>`` of float32 samples: rounded half
    to even to int32, where NaN, infinities and values past int32 give
    INT_MIN, then clipped to [0, 255]."""
    with np.errstate(invalid="ignore"):  # signalling NaNs
        r = np.rint(np.asarray(v, np.float32).astype(np.float64))
    ok = np.isfinite(r) & (r >= -2.0 ** 31) & (r < 2.0 ** 31)
    return np.clip(np.where(ok, r, 0.0), 0, 255).astype(np.uint8)


class ByteStream:
    """OpenCV's RLByteStream over ``data``: a read past the end raises."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("file cut short")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("file cut short")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def number(self, maxdigits: int = 0) -> int:
        """grfmt_pxm's ReadNumber: skip whitespace and ``#`` comments,
        read digits; the byte after them is consumed, unless ``maxdigits``
        digits stopped the read first."""
        code = self.byte()
        while code not in _DIGITS:
            if code == 35:  # '#': to the end of the line
                code = self.byte()
                while code not in b"\n\r":
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise ValueError(f"PXM: unexpected byte {code:#x}")
        val = digits = 0
        while True:
            val = val * 10 + code - 48
            if val > _INT_MAX:
                raise ValueError("PXM: number too large")
            digits += 1
            if maxdigits and digits >= maxdigits:
                return val
            code = self.byte()
            if code not in _DIGITS:
                return val


_TOKENS = re.compile(rb"\d+")


def _ascii(s: ByteStream, n: int, maxdigits: int = 0) -> np.ndarray:
    """n ASCII numbers as ``ByteStream.number`` reads them (int64)."""
    rest = s.data[s.pos:]
    if not rest.translate(None, _SPACE + _DIGITS):  # no comments: split
        if maxdigits == 1:
            digits = rest.translate(None, _SPACE)
            if len(digits) < n:
                raise ValueError("PXM: too few samples")
            return np.frombuffer(digits[:n], np.uint8).astype(np.int64) - 48
        tokens = _TOKENS.findall(rest, 0)
        if len(tokens) < n:
            raise ValueError("PXM: too few samples")
        if len(tokens) == n and not rest[-1:].translate(None, _DIGITS):
            raise ValueError("file cut short")  # no byte after the last
        if any(len(t) > 10 for t in tokens[:n]):
            raise ValueError("PXM: number too large")
        vals = np.array(tokens[:n], np.int64)
        if n and vals.max() > _INT_MAX:
            raise ValueError("PXM: number too large")
        return vals
    return np.array([s.number(maxdigits) for _ in range(n)], np.int64)


def _unpack_bits(rows: np.ndarray, width: int) -> np.ndarray:
    """(h, bytes) -> (h, width) bits, most significant first."""
    return np.unpackbits(rows, axis=1)[:, :width]


def decode_pnm(data: bytes, color: bool = False) -> np.ndarray:
    """P1-P6 bytes -> cv2's image (module docstring)."""
    s = ByteStream(data)
    if s.byte() != 80:
        raise ValueError("not a PNM file")
    code = s.byte() - 48
    if code not in range(1, 7):
        raise ValueError("not a PNM file")
    bpp = (1, 8, 24)[(code - 1) % 3]
    binary = code >= 4
    nch = 3 if bpp == 24 else 1
    width, height = s.number(), s.number()
    maxval = s.number() if bpp > 1 else 1
    if maxval > 65535 or not (width > 0 and height > 0 and maxval > 0):
        raise ValueError("PXM: bad header")
    check_size(width, height)
    wide = maxval > 255
    if bpp == 1:
        if binary:
            rows = np.frombuffer(s.take(height * (-(-width // 8))), np.uint8)
            bits = _unpack_bits(rows.reshape(height, -1), width)
        else:
            bits = (_ascii(s, width * height, 1) != 0).reshape(height, width)
        img = np.where(bits != 0, 0, 255).astype(np.uint8)
        return np.repeat(img[..., None], 3, 2) if color else img
    n = width * height * nch
    if binary:
        raw = s.take(n * (2 if wide else 1))
        v = (np.frombuffer(raw, ">u2").astype(np.uint16) if wide
             else np.frombuffer(raw, np.uint8).copy())
    else:
        a = np.minimum(_ascii(s, n), maxval)
        if wide:
            v = a.astype(np.uint16)
        else:
            v = (a * 255 // maxval).astype(np.uint8)
    v = v.reshape(height, width, nch)
    if color:
        if wide:
            v = (v >> 8).astype(np.uint8)
        return np.repeat(v, 3, 2) if nch == 1 else v
    return v[..., 0] if nch == 1 else v


# PAM: the header fields; TUPLTYPE -> its channels
_PAM_FIELDS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE",
               b"ENDHDR")
_PAM_TYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2,
              b"RGB": 3, b"RGB_ALPHA": 4}


def _pam_line(s: ByteStream):
    """grfmt_pam's ReadPAMHeaderLine -> (field, or None for a comment,
    value).  An identifier of more than 8 bytes or an unknown one, or a
    value past 255 bytes, is refused."""
    code = s.byte()
    while code in _SPACE:
        code = s.byte()
    if code == 35:
        while code not in b"\n\r":
            code = s.byte()
        return None, b""
    ident = bytearray()
    while len(ident) < 8 and code not in _SPACE:
        ident.append(code)
        code = s.byte()
    if code not in _SPACE or bytes(ident) not in _PAM_FIELDS:
        raise ValueError(f"PAM: unknown header field {bytes(ident)!r}")
    if code not in b"\n\r":
        code = s.byte()
        while code in b" \t\v\f":
            code = s.byte()
    value = bytearray()
    while len(value) < 255 and code not in b"\n\r":
        value.append(code)
        code = s.byte()
    if code not in b"\n\r":
        raise ValueError("PAM: header value too long")
    return bytes(ident), bytes(value).rstrip(_SPACE)


def _pam_header(s: ByteStream):
    """(width, height, depth, maxval) of a PAM header, checked as cv2
    checks it."""
    if s.take(2) != b"P7" or s.byte() not in b"\n\r":
        raise ValueError("not a PAM file")
    fields, tupl = {}, None
    while True:
        field, value = _pam_line(s)
        if field is None:
            continue
        if field == b"ENDHDR":
            break
        if field == b"TUPLTYPE":
            if value not in _PAM_TYPES:
                raise ValueError(f"PAM: unknown TUPLTYPE {value!r}")
            tupl = _PAM_TYPES[value]
            continue
        if field in fields or not value.isdigit() or len(value) > 10:
            raise ValueError(f"PAM: bad {field.decode()} line")
        fields[field] = int(value)
    if len(fields) != 4:
        raise ValueError("PAM: header field missing")
    width, height, depth, maxval = (fields[k] for k in _PAM_FIELDS[:4])
    if maxval > 65535 or width > _INT_MAX or height > _INT_MAX:
        raise ValueError("PAM: bad header")
    if tupl is None:
        if depth not in (1, 3) or maxval > 255:
            raise ValueError("PAM: no TUPLTYPE")
        tupl = depth
    if not 1 <= depth <= 4 or tupl != depth:
        raise ValueError("PAM: DEPTH does not match its TUPLTYPE")
    return width, height, depth, maxval


def decode_pam(data: bytes, color: bool = False) -> np.ndarray:
    """P7 bytes -> cv2's image (module docstring)."""
    s = ByteStream(data)
    width, height, depth, maxval = _pam_header(s)
    check_size(width, height)
    wide = maxval > 255
    raw = s.take(width * height * depth * (2 if wide else 1))
    if maxval == 1:
        if not color and depth in (2, 4):
            raise ValueError("PAM: bit samples of 2 or 4 channels refused")
        rows = np.frombuffer(raw, np.uint8).reshape(height, -1)
        img = np.where(_unpack_bits(rows[:, :-(-width // 8)], width), 255,
                       0).astype(np.uint8)
        return np.repeat(img[..., None], 3, 2) if color or depth == 3 else img
    v = (np.frombuffer(raw, ">u2").astype(np.uint16) if wide
         else np.frombuffer(raw, np.uint8).copy()).reshape(height, width,
                                                           depth)
    if color:
        if wide:
            v = (v >> 8).astype(np.uint8)
        if depth <= 2:
            return np.repeat(v[..., :1], 3, 2)
        return v[..., 2::-1] if depth == 3 else v[..., :3]
    if depth == 1:
        return v[..., 0]
    if depth == 2:
        return v
    return np.concatenate([v[..., 2::-1], v[..., 3:]], 2)


_INT = re.compile(rb"[+-]?\d+")
_FLOAT = re.compile(
    rb"[+-]?(?:0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)"
    rb"(?:[pP][+-]?\d+)?|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    rb"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?|[nN][aA][nN])")


def _pfm_token(s: ByteStream) -> bytes:
    """grfmt_pfm's read_number: the bytes up to the first whitespace (at
    most 2048; a byte past 127 is refused)."""
    out = bytearray()
    while len(out) < 2048:
        c = s.byte()
        if c > 127:
            raise ValueError("PFM: byte past 127 in the header")
        if c in _SPACE:
            break
        out.append(c)
    return bytes(out)


def _atoi(tok: bytes) -> int:
    m = _INT.match(tok)
    v = int(m.group()) if m else 0
    if abs(v) > _INT_MAX:
        raise ValueError("PFM: number too large")
    return v


def _atof(tok: bytes) -> float:
    m = _FLOAT.match(tok)
    if not m:
        return 0.0
    t = m.group().decode()
    if "x" in t.lower() and "n" not in t.lower():
        sign = -1.0 if t.startswith("-") else 1.0
        return sign * float.fromhex(t.lstrip("+-"))
    return float(t)


def decode_pfm(data: bytes, color: bool = False) -> np.ndarray:
    """PF/Pf bytes -> cv2's image (module docstring): float32, or with
    ``color`` uint8 (2-D for ``Pf``)."""
    s = ByteStream(data)
    if s.byte() != 80:
        raise ValueError("not a PFM file")
    kind = s.byte()
    if kind not in b"Ff" or s.byte() != 10:
        raise ValueError("not a PFM file")
    nch = 3 if kind == 70 else 1
    width, height = _atoi(_pfm_token(s)), _atoi(_pfm_token(s))
    scale = _atof(_pfm_token(s))
    check_size(width, height)
    if not abs(scale) > 0.0:
        raise ValueError("PFM: scale 0")
    order = "<" if scale < 0 else ">"
    raw = s.take(width * height * nch * 4)
    img = np.frombuffer(raw, order + "f4").astype(np.float32).reshape(
        height, width, nch)[::-1]
    alpha = 1.0 / abs(scale)
    if abs(alpha - 1.0) >= np.finfo(np.float64).eps:
        with np.errstate(invalid="ignore"):  # inf * 0, as in cv2
            img = img * np.float32(alpha) + np.float32(0.0)
    img = np.ascontiguousarray(img[..., 0] if nch == 1 else img)
    return float_to_u8(img) if color else img


def _rgb_u8(img: np.ndarray, what: str) -> np.ndarray:
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"{what}: an (H, W, 3) uint8 RGB image, not "
                         f"{a.dtype} {a.shape}")
    return a


def encode_ppm(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> cv2's ``.ppm``/``.pnm`` bytes (P6)."""
    a = _rgb_u8(img, ".ppm")
    h, w = a.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + a.tobytes()


def refuse_colour(img: np.ndarray) -> bytes:
    """``.pgm``/``.pbm``: cv2 writes one-channel images only, and refuses
    the colour frames the port writes (ValueError)."""
    raise ValueError(".pgm/.pbm: cv2 writes one-channel images only, "
                     f"not {np.asarray(img).shape}")


def encode_pam(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> cv2's ``.pam`` bytes: no TUPLTYPE, the
    samples in BGR order."""
    a = _rgb_u8(img, ".pam")
    h, w = a.shape[:2]
    return (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\nENDHDR\n"
            % (w, h) + np.ascontiguousarray(a[..., ::-1]).tobytes())


def encode_pfm(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> cv2's ``.pfm`` bytes: the samples 0-255 as
    little-endian float32, rows bottom-up."""
    a = _rgb_u8(img, ".pfm")
    h, w = a.shape[:2]
    return b"PF\n%d %d\n-1\n" % (w, h) + a[::-1].astype("<f4").tobytes()
