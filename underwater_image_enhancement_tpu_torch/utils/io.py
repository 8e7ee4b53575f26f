"""Host-side image IO with no image library: an 8-bit PNG codec built on
``zlib`` + ``struct`` + numpy, the JPEG, BMP and TIFF codecs of
``jpeg.py``, ``bmp.py`` and ``tiff.py``, plus the folder helpers of
the JAX package's ``utils/io.py`` (collect, decode-ahead, write-behind).

A file's format is found from its first bytes, not its suffix, as cv2
does.  Reading follows the reference's load conventions (main.py:91-113)
and gives what the JAX package's ``cv2.imread(path, IMREAD_UNCHANGED)``
and channel handling give: RGB out, grayscale replicated to RGB, alpha
dropped, float32 in [0, 1].  Unreadable files give None so callers can skip
them; so do the files cv2 reads and the port does not (16-bit TIFF,
progressive JPEG, 16-bit PNG and the other formats and variants that
``jpeg.py``, ``bmp.py``, ``tiff.py`` and ``decode_png`` leave out), which
``read_u8`` names.

Writing picks the encoder from the suffix, case-insensitive, as
``cv2.imwrite`` does (``WRITERS``): PNG, JPEG (the bytes of cv2's
defaults), BMP and TIFF (cv2's bytes).  A suffix cv2 writes and the port
does not (``UNPORTED_WRITERS``) and one cv2 cannot write raise
ValueError.
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
from underwater_image_enhancement_tpu_torch.utils.config import SUPPORTED_FORMATS
from underwater_image_enhancement_tpu_torch.utils.jpeg import (
    Unsupported,
    decode_jpeg,
    encode_jpeg,
)
from underwater_image_enhancement_tpu_torch.utils.tiff import (
    decode_tiff,
    encode_tiff,
)

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _chunk(tag: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(tag + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def encode_png(u8: np.ndarray, level: int = 1) -> bytes:
    """(H, W), (H, W, 1|3|4) uint8 -> PNG bytes (filter type 0 rows)."""
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
    raw = np.zeros((H, 1 + a[0].size), np.uint8)
    raw[:, 1:] = a.reshape(H, -1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


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


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8.  Supports 8-bit gray, gray
    +alpha, RGB and RGBA without interlace, filter types 0-4."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise Unsupported(f"PNG of depth {depth}, colour type {ctype}, "
                          f"interlace {interlace}")
    bpp = _CHANNELS[ctype]
    stride = W * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:H * (stride + 1)].reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out.reshape(H, W) if bpp == 1 else out.reshape(H, W, bpp)


# first bytes of the other formats cv2 reads
_OTHER_FORMATS = (
    (b"GIF8", "GIF"),
    (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"), (b"\xffO\xffQ", "JPEG 2000"),
    (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"),
    (b"v/1\x01", "OpenEXR"), (b"\x59\xa6\x6a\x95", "Sun raster"),
)


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8 RGB, the format found from the
    signature.  Raises ``Unsupported`` for a format (or variant) that cv2
    reads and the port does not, ValueError for anything else it cannot
    read."""
    if data[:8] == _SIGNATURE:
        img = decode_png(data)
    elif data[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(data)
    elif data[:2] == b"BM":
        return decode_bmp(data)
    elif data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        img = decode_tiff(data)
    else:
        if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
            raise Unsupported("WebP")
        if data[:1] == b"P" and data[1:2] in b"1234567" and len(data) > 2:
            raise Unsupported("PNM")
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
    return np.ascontiguousarray(img)


def read_u8(path: str):
    """(image, None) with the image as (H, W, 3) uint8 RGB; (None, reason)
    where the file is a format cv2 reads and the port does not; (None,
    None) where it is unreadable."""
    try:
        return decode_image(Path(path).read_bytes()), None
    except Unsupported as e:
        return None, str(e)
    except (OSError, ValueError, zlib.error, struct.error):
        return None, None


def imread_u8(path: str) -> Optional[np.ndarray]:
    """Read an image as (H, W, 3) uint8 RGB; None if unreadable or of a
    format the port does not read."""
    return read_u8(path)[0]


def imread_unit(path: str) -> Optional[np.ndarray]:
    """Read an image as float32 RGB in [0, 1]; None if unreadable."""
    img = imread_u8(path)
    return None if img is None else img.astype(np.float32) / 255.0


# the suffixes cv2 writes (cv2.haveImageWriter) and their encoders here
WRITERS = {".png": encode_png,
           ".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".jpe": encode_jpeg,
           ".bmp": encode_bmp, ".dib": encode_bmp,
           ".tif": encode_tiff, ".tiff": encode_tiff}
UNPORTED_WRITERS = (".webp", ".jp2", ".pbm", ".pgm", ".ppm", ".pnm", ".pam",
                    ".pfm", ".sr", ".ras", ".hdr", ".pic", ".avif", ".gif",
                    ".apng")


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
    * 255) truncated to uint8.  JPEG, BMP and TIFF take (H, W, 3) images;
    PNG also gray and RGBA."""
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
    """Write-behind encoder (``imwrite_unit``: PNG, JPEG, BMP or TIFF by
    the suffix) on a host thread pool (zlib and numpy release the GIL for
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
    """Decode-ahead iterator: yields (path, float32 RGB [0, 1]) in order
    while a background thread decodes the next images (queue of 8).
    Unreadable files, files of a format the port does not read ("unsupported
    by the port: <format>"), and images under ``min_size`` pixels on either
    side, are logged and skipped."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=8)
    end = object()

    def producer():
        for path in files:
            img, why = read_u8(str(path))
            if img is not None:
                img = img.astype(np.float32) / 255.0
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
