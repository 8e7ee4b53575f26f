"""Host-side image IO with no image library: an 8-bit PNG codec built on
``zlib`` + ``struct`` + numpy, plus the folder helpers of the JAX
package's ``utils/io.py`` (collect, decode-ahead, write-behind).

Reading follows the reference's load conventions (main.py:91-113): RGB
out, grayscale replicated to RGB, alpha dropped, float32 in [0, 1];
unreadable files (and formats other than 8-bit non-interlaced gray, gray
+alpha, RGB or RGBA PNG) give None so callers can skip them.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np

from underwater_image_enhancement_tpu_torch.utils.config import SUPPORTED_FORMATS

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
        raise ValueError(f"unsupported PNG (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    bpp = _CHANNELS[ctype]
    stride = W * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:H * (stride + 1)].reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out.reshape(H, W) if bpp == 1 else out.reshape(H, W, bpp)


def imread_u8(path: str) -> Optional[np.ndarray]:
    """Read an image as (H, W, 3) uint8 RGB; None if unreadable."""
    try:
        img = decode_png(Path(path).read_bytes())
    except (OSError, ValueError, zlib.error, struct.error):
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    elif img.shape[2] == 2:  # gray + alpha
        img = np.repeat(img[..., :1], 3, axis=2)
    else:
        img = img[..., :3]
    return np.ascontiguousarray(img)


def imread_unit(path: str) -> Optional[np.ndarray]:
    """Read an image as float32 RGB in [0, 1]; None if unreadable."""
    img = imread_u8(path)
    return None if img is None else img.astype(np.float32) / 255.0


def imwrite_unit(path: str, img: np.ndarray) -> None:
    """Write an RGB image as PNG: uint8 arrays as they are, float [0, 1]
    arrays as the reference's (clip * 255) truncated to uint8."""
    if Path(path).suffix.lower() != ".png":
        raise ValueError(f"only PNG output is supported: {path}")
    img = np.asarray(img)
    u8 = img if img.dtype == np.uint8 else (np.clip(img, 0, 1) * 255).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(u8))


def collect_images(folder: str, formats: Optional[List[str]] = None) -> List[Path]:
    """Glob by supported extension, case-insensitive (main.py:45-61,
    six_stadigy.py:360-364)."""
    fmts = formats or SUPPORTED_FORMATS
    return [p for p in sorted(Path(folder).iterdir()) if p.suffix.lower() in fmts]


class AsyncWriter:
    """Write-behind PNG encoder on a host thread pool (zlib releases the
    GIL), so the device does not wait for encodes.  In-flight writes are
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


def decode_iter(files, log=print):
    """Decode-ahead iterator: yields (path, float32 RGB [0, 1]) in order
    while a background thread decodes the next images (queue of 8).
    Unreadable files are logged and skipped."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=8)
    end = object()

    def producer():
        for path in files:
            q.put((path, imread_unit(str(path))))
        q.put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            break
        path, img = item
        if img is None:
            log(f"warning: unreadable {path.name}")
            continue
        yield path, img
    t.join()
