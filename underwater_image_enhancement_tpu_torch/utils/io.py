"""Host-side image IO with no image library: a PNG codec built on
``zlib`` + ``struct`` + numpy, the JPEG, BMP, TIFF, netpbm/PFM, Sun
raster, Radiance HDR and GIF codecs of ``jpeg.py``, ``bmp.py``,
``tiff.py``, ``pxm.py``, ``sunras.py``, ``hdr.py`` and ``gif.py``, plus
the folder helpers of the JAX package's ``utils/io.py`` (collect,
decode-ahead, write-behind).

A file's format is found from its first bytes, not its suffix, as cv2
does.  Reading follows the reference's load conventions (main.py:91-113)
and gives what the JAX package's ``cv2.imread(path, IMREAD_UNCHANGED)``
and channel handling give: RGB out, grayscale replicated to RGB, alpha
dropped, float32 samples over 255 (``imread_unit``; a 16-bit PNG or TIFF
reads up to 257, as it does in the JAX package, a float TIFF, PFM or HDR
its samples over 255).  ``imread_u8`` reads as
the JAX training loader's ``cv2.imread(path)`` (``IMREAD_COLOR``) does:
8 bits, a 16-bit sample as cv2 converts it for its format, then turned as
a JPEG's or PNG's EXIF Orientation says (``exif.py``; ``IMREAD_UNCHANGED``
turns nothing).  PNG is read in every colour type and depth, with PLTE,
tRNS and Adam7 (``decode_png``); JPEG in every variant cv2 reads
(``jpeg.py``: baseline, progressive, arithmetic-coded and lossless; gray,
RGB, YCbCr, CMYK and YCCK); BMP in every variant cv2 reads (``bmp.py``:
OS/2 headers, 1- to 32-bit, bit fields, RLE8 and RLE4); TIFF in the
variants ``tiff.py`` lists (its Orientation applied as cv2 applies it, in
both modes; float, 10- to 16-bit samples, BigTIFF, uncompressed YCbCr,
CIELab, CCITT (``fax3.py``) and SGILog (``sgilog.py``) among them);
netpbm P1-P7 and PFM (``pxm.py``), Sun raster (``sunras.py``), Radiance
HDR (``hdr.py``: float32, as PFM) and the first image of a GIF
(``gif.py``).  Unreadable files give None so callers can
skip them; so do the files cv2 reads and the port does not (WebP, JPEG
2000 and AVIF), and those on which the JAX package's channel handling
raises (a two-channel PAM; a signed, 32- or 64-bit integer or float64
TIFF, LogL's signed bytes among them), which ``read_image`` names.

Writing picks the encoder from the suffix, case-insensitive, as
``cv2.imwrite`` does (``WRITERS``): PNG and APNG (one frame: the PNG's
bytes, as cv2 writes it), JPEG, BMP, TIFF, PPM/PNM/PGM/PBM, PAM, PFM, Sun
raster and HDR, each in the bytes of cv2's defaults.  A suffix cv2 writes
and the port does not (``UNPORTED_WRITERS``) and one cv2 cannot write
raise ValueError.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np

from underwater_image_enhancement_tpu_torch.utils.bmp import (
    decode_bmp,
    encode_bmp,
)
from underwater_image_enhancement_tpu_torch.utils import exif
from underwater_image_enhancement_tpu_torch.utils.config import SUPPORTED_FORMATS
from underwater_image_enhancement_tpu_torch.utils.gif import decode_gif
from underwater_image_enhancement_tpu_torch.utils.hdr import (
    decode_hdr,
    encode_hdr,
)
from underwater_image_enhancement_tpu_torch.utils.jpeg import (
    Unsupported,
    decode_jpeg,
    encode_jpeg,
)
from underwater_image_enhancement_tpu_torch.utils.pxm import (
    decode_pam,
    decode_pfm,
    decode_pnm,
    encode_pam,
    encode_pfm,
    encode_ppm,
    refuse_colour,
)
from underwater_image_enhancement_tpu_torch.utils.sunras import (
    decode_sunras,
    encode_sunras,
)
from underwater_image_enhancement_tpu_torch.utils.tiff import (
    decode_tiff,
    encode_tiff,
)

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples a pixel, and the depths it allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(tag + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def _zlib_header_for_size(stream: bytearray, size: int) -> None:
    """libpng's ``optimize_cmf`` (pngwutil.c): for data of at most 16 KiB,
    the CMF byte's window size (CINFO) lowered while the data fits in half
    the window, FCHECK recomputed; the deflate body is left as it is."""
    if size > 16384 or stream[0] & 0x0F != 8 or stream[0] >> 4 > 7:
        return
    cinfo = stream[0] >> 4
    half = 1 << (cinfo + 7)
    while size <= half and cinfo > 0:
        half >>= 1
        cinfo -= 1
    stream[0] = cmf = (cinfo << 4) | 8
    flg = stream[1] & 0xE0
    stream[1] = flg + 31 - ((cmf << 8) + flg) % 31


def encode_png(u8: np.ndarray) -> bytes:
    """(H, W), (H, W, 1|3|4) uint8 -> the PNG bytes that
    ``cv2.imencode(".png")`` (OpenCV 5.0.0 with libpng and zlib 1.2.13)
    writes for the image: every row Sub-filtered (filter 0 on a frame one
    pixel wide, as libpng's filter choice gives), one zlib stream of level
    1 and strategy ``Z_RLE``, its header rewritten as libpng's
    ``optimize_cmf`` does, cut into IDAT chunks of 8192 bytes."""
    a = np.ascontiguousarray(u8, dtype=np.uint8)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        ctype = 0
    elif a.ndim == 3 and a.shape[2] in (3, 4):
        ctype = 2 if a.shape[2] == 3 else 6
    else:
        raise ValueError(f"cannot encode an array of shape {a.shape} as PNG")
    H, W = a.shape[:2]
    c = a[0, 0].size
    rows = a.reshape(H, -1)
    raw = np.empty((H, 1 + rows.shape[1]), np.uint8)
    raw[:, 1:] = rows
    if W > 1:  # Sub: each sample less the one a pixel before it, mod 256
        raw[:, 0] = 1
        np.subtract(rows[:, c:], rows[:, :-c], out=raw[:, 1 + c:])
    else:
        raw[:, 0] = 0
    z = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
    stream = bytearray(z.compress(raw.tobytes()) + z.flush())
    _zlib_header_for_size(stream, raw.size)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)
    return b"".join(
        [_SIGNATURE, _chunk(b"IHDR", ihdr)]
        + [_chunk(b"IDAT", bytes(stream[i:i + 8192]))
           for i in range(0, len(stream), 8192)]
        + [_chunk(b"IEND", b"")])


def _unfilter_row(ft: int, line: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    if ft == 0:
        return line
    if ft == 1:  # Sub: running sum per sample lane, mod 256
        return np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if ft == 2:  # Up
        return line + prev
    if ft not in (3, 4):
        raise ValueError(f"bad PNG filter type {ft}")
    cur = line.astype(np.int64).tolist()
    up = prev.astype(np.int64).tolist()
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = up[x]
        if ft == 3:  # Average
            cur[x] = (cur[x] + ((a + b) >> 1)) & 255
        else:  # Paeth
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[x] = (cur[x] + pred) & 255
    return np.asarray(cur, np.uint8)


def _header(body: bytes) -> tuple:
    """IHDR's (W, H, depth, colour type, interlace); ValueError where
    libpng finds it invalid (sides past its default limit of 1,000,000
    included) or the image is past cv2's 2**30 pixels."""
    if len(body) != 13:
        raise ValueError("PNG IHDR of the wrong length")
    W, H, depth, ctype, compression, filtering, interlace = struct.unpack(
        ">IIBBBBB", body)
    if (not 0 < W <= 1_000_000 or not 0 < H <= 1_000_000 or W * H > 1 << 30
            or depth not in _DEPTHS.get(ctype, ()) or compression
            or filtering or interlace > 1):
        raise ValueError("invalid PNG IHDR")
    return W, H, depth, ctype, interlace


def _chunks(data: bytes):
    """(W, H, depth, colour type, interlace, palette, tRNS body, zlib
    stream, eXIf body or None) of a PNG, its chunks taken as cv2's libpng
    takes them: IHDR
    first; every chunk whole and IEND present (cv2 refuses a file cut
    short anywhere); a CRC error ends the read in a critical chunk but
    IEND and drops an ancillary chunk; an unknown critical chunk ends the
    read; the image data is the first run of IDAT chunks; tRNS counts
    only where it is valid, before the first IDAT and, for a palette,
    after PLTE (the first valid one wins); PLTE is read only for a
    palette image, cut to the depth's 2**depth entries, and given twice
    ends the read; the first eXIf that libpng keeps
    (``exif.png_exif_valid``), before or after the image data."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, head, palette, trns, idat, run = 8, None, None, None, [], 0
    exif_body = None
    while True:
        if pos + 12 > len(data):
            raise ValueError("PNG cut short")
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise ValueError("PNG cut short")
        body = data[pos + 8:end - 4]
        crc_ok = (zlib.crc32(tag + body) & 0xFFFFFFFF
                  == struct.unpack(">I", data[end - 4:end])[0])
        pos = end
        critical = not tag[0] & 0x20
        if head is None and tag != b"IHDR":
            raise ValueError("PNG without IHDR first")
        if not crc_ok and tag != b"IEND":
            if critical:
                raise ValueError(f"PNG {tag!r} CRC error")
            continue
        if tag != b"IDAT" and run == 1:
            run = 2  # the image data ends at the first other chunk
        if tag == b"IHDR":
            if head is not None:
                raise ValueError("PNG with two IHDR chunks")
            head = _header(body)
            W, H, depth, ctype, interlace = head
        elif tag == b"PLTE":
            if palette is not None:
                raise ValueError("PNG with two PLTE chunks")
            if ctype == 3:
                if run or not 0 < length <= 768 or length % 3:
                    raise ValueError("invalid PNG palette")
                pal = np.frombuffer(body, np.uint8).reshape(-1, 3)
                palette = pal[:1 << depth]
            else:
                palette = np.zeros((0, 3), np.uint8)  # ignored, as libpng
        elif tag == b"IDAT":
            if ctype == 3 and palette is None:
                raise ValueError("PNG palette image without PLTE")
            if run < 2:
                idat.append(body)
                run = 1
        elif tag == b"tRNS":
            if trns is None and not run and (
                    (ctype == 0 and length == 2)
                    or (ctype == 2 and length == 6)
                    or (ctype == 3 and palette is not None
                        and 0 < length <= len(palette))):
                trns = body
        elif tag == b"eXIf":
            if exif_body is None and exif.png_exif_valid(body):
                exif_body = body
        elif tag == b"IEND":
            break
        elif critical:
            raise ValueError(f"PNG with an unknown critical chunk {tag!r}")
    return (W, H, depth, ctype, interlace, palette, trns, b"".join(idat),
            exif_body)


def _samples(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """(h, row bytes) unfiltered rows -> (h, w, c) samples: big-endian at
    16 bits, unpacked most significant bit first below 8."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, c)
    if depth < 8:
        per = 8 // depth
        shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
        rows = ((rows[..., None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, -1)[:, :w * c]
    return rows.reshape(h, w, c)


def _unfilter(raw: np.ndarray, h: int, w: int, c: int, depth: int):
    """One (sub)image's h filtered rows from ``raw`` -> (h, w, c) samples."""
    stride = -(-w * c * depth // 8)
    bpp = max(1, c * depth // 8)
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return _samples(out, w, c, depth)


def _passes(W: int, H: int, interlace: int):
    """(x0, y0, dx, dy, w, h) of the image's passes: one, or Adam7's seven
    with the empty ones left out (they carry no bytes)."""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        w, h = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if w > 0 and h > 0:
            yield x0, y0, dx, dy, w, h


def decode_png(data: bytes) -> np.ndarray:
    """``_decode_png``'s image."""
    return _decode_png(data)[0]


def _decode_png(data: bytes):
    """PNG bytes -> ((H, W) or (H, W, C) uint8, or uint16 at 16 bits; the
    Orientation of its eXIf chunk or None).  The image is what
    ``cv2.imdecode(data, IMREAD_UNCHANGED)`` gives, in RGB order.  Every
    colour type and depth, filter types 0-4, Adam7 interlace: gray (1-,
    2- and 4-bit samples scaled to 8 bits as libpng's
    ``expand_gray_1_2_4_to_8`` does, tRNS ignored: cv2 gives it no alpha),
    gray + alpha (C = 2), RGB (C = 4 with a tRNS colour: alpha 0 on it,
    else the depth's maximum, compared on the sample's low byte at 8
    bits), palette (RGB from PLTE, black past its end; C = 4 with tRNS:
    its alphas, 255 past them) and RGBA.  gAMA, sBIT and the other
    ancillary chunks change no sample, as in cv2.  ValueError where cv2
    gives None (``_chunks``; a zlib stream that does not end, which
    libpng reads to its end, or that holds too few bytes; a bad filter
    type); ``zlib.error`` on a corrupt stream."""
    W, H, depth, ctype, interlace, palette, trns, stream, exif_body = \
        _chunks(data)
    turn = None if exif_body is None else exif.orientation(exif_body)
    z = zlib.decompressobj()
    raw = np.frombuffer(z.decompress(stream), np.uint8)
    if not z.eof:
        raise ValueError("PNG image data cut short")
    c = _CHANNELS[ctype]
    out = np.empty((H, W, c), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy, w, h in _passes(W, H, interlace):
        n = h * (1 + -(-w * c * depth // 8))
        if at + n > raw.size:
            raise ValueError("PNG image data cut short")
        out[y0::dy, x0::dx] = _unfilter(raw[at:at + n], h, w, c, depth)
        at += n
    if ctype == 3:
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[:len(palette), :3] = palette
        if trns is not None:
            table[:len(trns), 3] = np.frombuffer(trns, np.uint8)
        return table[out[..., 0]][..., :3 if trns is None else 4], turn
    if ctype == 0:
        scale = 255 // ((1 << depth) - 1) if depth < 8 else 1
        return (out[..., 0] * np.uint8(scale) if scale > 1
                else out[..., 0]), turn
    if ctype == 2 and trns is not None:
        key = np.array(struct.unpack(">3H", trns), np.uint32)
        if depth == 8:
            key &= 0xFF
        alpha = np.where((out == key).all(-1), 0, np.iinfo(out.dtype).max)
        return np.concatenate([out, alpha[..., None].astype(out.dtype)],
                              -1), turn
    return out, turn


# first bytes of the other formats cv2 reads (OpenEXR is not among them:
# cv2 5.0.0 is built without it, and a file of its signature is unknown)
_OTHER_FORMATS = (
    (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"), (b"\xffO\xffQ", "JPEG 2000"),
)
_SPACE = b" \t\n\v\f\r"


def _is_avif(data: bytes) -> bool:
    """An ISO-BMFF ``ftyp`` box at byte 4 whose major or a compatible
    brand is ``avif`` or ``avis``."""
    if data[4:8] != b"ftyp" or len(data) < 16:
        return False
    size = int.from_bytes(data[:4], "big")
    box = data[8:min(len(data), size if size >= 16 else 16)]
    brands = [box[:4]] + [box[i:i + 4] for i in range(8, len(box) - 3, 4)]
    return b"avif" in brands or b"avis" in brands


def decode_image(data: bytes, color: bool = False) -> np.ndarray:
    """Image bytes -> (H, W, 3) RGB, the format found from the signature:
    what ``cv2.imread(path, IMREAD_UNCHANGED)`` of the file and the JAX
    package's channel handling give (uint8, or uint16 for a 16-bit PNG,
    TIFF, PNM or PAM and a 10- to 14-bit TIFF's samples shifted to 16
    bits, or float32 for PFM, HDR and a float TIFF; gray, a gray-palette
    or OS/2 BMP, a gray TIFF and a gray netpbm, PFM or Sun raster
    replicated, alpha dropped, a CMYK TIFF's fourth channel too), or with
    ``color``
    what ``IMREAD_COLOR`` gives (uint8: a 16-bit PNG's samples ``v >> 8``,
    a TIFF as ``tiff.decode_tiff(color=True)`` and a BMP as
    ``bmp.decode_bmp(color=True)`` give it, a lossless gray JPEG refused,
    PFM and HDR samples rounded and saturated, a gray PFM refused as
    ``cv2.imread`` refuses it; then a JPEG's or PNG's EXIF orientation
    applied, ``exif.py``; a TIFF's own Orientation is applied in both
    modes by ``decode_tiff``).  Raises ``Unsupported`` for a format (or
    variant) that cv2 reads and the port does not, and where the JAX
    package's channel handling raises on what cv2 gives (a two-channel
    PAM; a TIFF of signed, 32- or 64-bit integer or float64 samples,
    which ``cvtColor`` refuses); ValueError for anything else it cannot
    read."""
    turn = None
    head = data[:3]
    netpbm = (len(head) == 3 and head[0] == 80 and head[2] in _SPACE)
    if data[:8] == _SIGNATURE:
        img, turn = _decode_png(data)
        if color and img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
    elif data[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(data, color)
        turn = exif.jpeg_orientation(data) if color else None
    elif data[:2] == b"BM":
        img = decode_bmp(data, color)
    elif data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        img = decode_tiff(data, color=color)
        if img.dtype not in (np.uint8, np.uint16, np.float32):
            # cvtColor takes 8-bit, 16-bit and float32 images only
            kind = {"i": "signed", "u": "unsigned"}.get(img.dtype.kind,
                                                      "floating-point")
            raise Unsupported(f"{kind} {8 * img.dtype.itemsize}-bit TIFF, "
                              "on which the JAX reader raises")
    elif netpbm and head[1] in b"123456":
        img = decode_pnm(data, color)
    elif netpbm and head[1] == 55:  # P7
        img = decode_pam(data, color)
        if img.ndim == 3 and img.shape[2] == 2:
            raise Unsupported("two-channel PAM")
    elif netpbm and head[1] in b"Ff":
        img = decode_pfm(data, color)
        if color and img.ndim == 2:  # cv2.imread gives None
            raise ValueError("a gray PFM in IMREAD_COLOR")
    elif data[:4] == b"\x59\xa6\x6a\x95":
        img = decode_sunras(data, color)
    elif data.startswith(b"#?RGBE") or data.startswith(b"#?RADIANCE"):
        img = decode_hdr(data, color)
    elif data[:3] == b"GIF":
        img = decode_gif(data, color)
    else:
        if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
            raise Unsupported("WebP")
        if _is_avif(data):
            raise Unsupported("AVIF")
        for sig, name in _OTHER_FORMATS:
            if data.startswith(sig):
                raise Unsupported(name)
        raise ValueError("unknown image format")
    if img.ndim == 2 or img.shape[2] == 1:
        img = np.repeat(img.reshape(img.shape[:2] + (1,)), 3, axis=2)
    elif img.shape[2] == 2:  # gray + alpha
        img = np.repeat(img[..., :1], 3, axis=2)
    else:
        img = img[..., :3]
    return exif.apply(img, turn) if color else np.ascontiguousarray(img)


def read_image(path: str, color: bool = False):
    """(image, None) with the image as ``decode_image(data, color)`` gives
    it; (None, reason) where the file is a format cv2 reads and the port
    does not; (None, None) where it is unreadable."""
    try:
        return decode_image(Path(path).read_bytes(), color), None
    except Unsupported as e:
        return None, str(e)
    except (OSError, ValueError, zlib.error, struct.error):
        return None, None


def imread_u8(path: str) -> Optional[np.ndarray]:
    """Read an image as (H, W, 3) uint8 RGB, as the JAX package's
    ``train/data._imread_rgb`` (``cv2.imread(path)``, ``IMREAD_COLOR``)
    reads it; None if unreadable or of a format the port does not read."""
    return read_image(path, color=True)[0]


def to_unit(img: np.ndarray) -> np.ndarray:
    """A decoded sample array as the JAX package's ``imread_unit`` makes it
    float: ``/ 255`` in float32, so a 16-bit file reaches 65535 / 255 =
    257."""
    return img.astype(np.float32) / 255.0


def imread_unit(path: str) -> Optional[np.ndarray]:
    """Read an image as float32 RGB, the samples over 255 (the JAX
    package's ``imread_unit``: [0, 1] for 8-bit files, [0, 257] for 16-bit
    ones); None if unreadable or of a format the port does not read."""
    img = read_image(path)[0]
    return None if img is None else to_unit(img)


# the suffixes cv2 writes (cv2.haveImageWriter) and their encoders here
WRITERS = {".png": encode_png, ".apng": encode_png,
           ".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".jpe": encode_jpeg,
           ".bmp": encode_bmp, ".dib": encode_bmp,
           ".tif": encode_tiff, ".tiff": encode_tiff,
           ".ppm": encode_ppm, ".pnm": encode_ppm, ".pgm": refuse_colour,
           ".pbm": refuse_colour, ".pam": encode_pam, ".pfm": encode_pfm,
           ".sr": encode_sunras, ".ras": encode_sunras,
           ".hdr": encode_hdr, ".pic": encode_hdr}
UNPORTED_WRITERS = (".webp", ".jp2", ".avif", ".gif")


def encoder_for(path: str):
    """The encoder of ``path``'s suffix (case-insensitive); ValueError for a
    suffix the port does not write."""
    suffix = Path(path).suffix.lower()
    if suffix in WRITERS:
        return WRITERS[suffix]
    if suffix in UNPORTED_WRITERS:
        raise ValueError(f"{path}: cv2 writes {suffix} files and the port "
                         f"does not; it writes {', '.join(WRITERS)}")
    raise ValueError(f"{path}: could not find a writer for the suffix "
                     f"{suffix!r}")


def imwrite_unit(path: str, img: np.ndarray) -> None:
    """Write an RGB image in the format of the path's suffix (``WRITERS``):
    uint8 arrays as they are, float [0, 1] arrays as the reference's (clip
    * 255) truncated to uint8, in the bytes ``cv2.imwrite`` writes for
    them.  JPEG, BMP, TIFF, PPM/PNM (P6), PAM, PFM (the samples 0-255 as
    float32), Sun raster and HDR (the samples over 255, RGBE) take (H, W,
    3) images; PNG and APNG also gray and RGBA.  PGM and PBM raise
    ValueError: cv2 writes one-channel images only there (the JAX
    package's ``cv2.imwrite`` of its colour frame writes no file and
    raises nothing)."""
    encode = encoder_for(path)
    img = np.asarray(img)
    u8 = img if img.dtype == np.uint8 else (np.clip(img, 0, 1) * 255).astype(np.uint8)
    data = encode(u8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(data)


def collect_images(folder: str, formats: Optional[List[str]] = None) -> List[Path]:
    """Glob by supported extension, case-insensitive (main.py:45-61,
    six_stadigy.py:360-364)."""
    fmts = formats or SUPPORTED_FORMATS
    return [p for p in sorted(Path(folder).iterdir()) if p.suffix.lower() in fmts]


class AsyncWriter:
    """Write-behind encoder (``imwrite_unit``, its format by the suffix) on a host thread pool (zlib and numpy release the GIL for
    part of each encode), so the device does not wait for encodes.  In-flight writes are
    bounded; ``close()`` joins them and returns [(path, error_str)] for
    any that failed."""

    def __init__(self, workers: int = 4, max_inflight: int = 16):
        import threading
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="imwrite")
        self._slots = threading.Semaphore(max_inflight)
        self._lock = threading.Lock()
        self._errors: List[tuple] = []

    def write(self, path: str, img: np.ndarray) -> None:
        """Queue an image for writing (blocks while max_inflight are queued)."""
        self._slots.acquire()

        def task():
            try:
                imwrite_unit(path, img)
            except Exception as e:  # noqa: BLE001 - reported via close()
                with self._lock:
                    self._errors.append((path, str(e)))
            finally:
                self._slots.release()

        self._pool.submit(task)

    def close(self) -> List[tuple]:
        self._pool.shutdown(wait=True)
        return list(self._errors)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def decode_iter(files, log=print, min_size: int = 0):
    """Decode-ahead iterator: yields (path, ``imread_unit``'s float32 RGB)
    in order while a background thread decodes the next images (queue of
    8).  Unreadable files, files of a format the port does not read
    ("unsupported by the port: <format>"), and images under ``min_size``
    pixels on either side, are logged and skipped."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=8)
    end = object()

    def producer():
        for path in files:
            img, why = read_image(str(path))
            if img is not None:
                img = to_unit(img)
            q.put((path, img, why))
        q.put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            break
        path, img, why = item
        if img is None:
            log(f"warning: {path.name} unsupported by the port: {why}"
                if why else f"warning: unreadable {path.name}")
            continue
        if min_size and (img.shape[0] < min_size or img.shape[1] < min_size):
            log(f"warning: {path.name} too small, skipping")
            continue
        yield path, img
    t.join()
