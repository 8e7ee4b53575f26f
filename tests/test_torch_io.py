"""The port's image reading (``utils/io.py`` with the numpy JPEG, BMP and
TIFF decoders) against the JAX package's, which is ``cv2.imread(path,
IMREAD_UNCHANGED)`` and its channel handling: bit for bit on JPEGs as
``cv2.imencode`` writes them (every sampling factor, two qualities, a
restart interval, gray, odd sizes, RGB components), on BMPs (as cv2
writes them, and 32-bit and top-down variants built here) and on 8-bit
TIFFs (as cv2 writes them in each of its compressions, as the port's
encoder writes them, and big-endian, tiled, multi-page, predictor and
alpha variants built here); files cv2 reads and the port does not come
back as None and are logged by name; a ``.tif`` in a ``cli six`` folder
is enhanced as its ``.png`` twin is."""

import csv
import struct
import zlib

import cv2
import numpy as np
import pytest

from tests import torch_frames
from underwater_image_enhancement_tpu import cli as jcli
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import jpeg as tjpeg
from underwater_image_enhancement_tpu_torch.utils import tiff as ttiff

SAMPLING = ["444", "422", "420", "440", "411"]


def _image(h, w, seed=0, channels=3):
    """Smooth gradients plus noise: every DCT frequency in use."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 3.1, xx * 2.3, (xx + yy) * 1.7 + 40], -1)[..., :channels]
    img = np.clip(base + 60 * np.sin(xx / 5.0)[..., None]
                  + rng.normal(0, 25, (h, w, channels)), 0, 255)
    return img.astype(np.uint8)


def _jpeg(img, quality, sampling=None, restart=None, progressive=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _assert_reads_as_jax(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    want = jio.imread_unit(str(path))  # cv2 and the JAX channel handling
    assert want is not None
    got = tio.imread_u8(str(path))
    assert got is not None and got.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, np.round(want * 255).astype(np.uint8))
    np.testing.assert_array_equal(tio.imread_unit(str(path)), want)


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", SAMPLING)
@pytest.mark.parametrize("shape", [(61, 83), (16, 32)])
def test_jpeg_sampling_matches_cv2(tmp_path, shape, sampling, quality):
    data = _jpeg(_image(*shape, seed=quality), quality, sampling)
    _assert_reads_as_jax(tmp_path, "a.jpg", data)


@pytest.mark.parametrize("sampling", ["420", "422", "411"])
@pytest.mark.parametrize("shape", [(5, 3), (3, 4), (1, 1), (9, 17)])
def test_jpeg_narrow_frames_match_cv2(tmp_path, shape, sampling):
    """Chroma at most 2 samples wide: libjpeg replicates there instead of
    its triangle filter; 1 and 3 rows: the vertical context at both
    edges."""
    data = _jpeg(_image(*shape, seed=3), 90, sampling)
    _assert_reads_as_jax(tmp_path, "n.jpg", data)


@pytest.mark.parametrize("sampling", ["420", "444"])
@pytest.mark.parametrize("restart", [1, 3])
def test_jpeg_restart_interval_matches_cv2(tmp_path, restart, sampling):
    data = _jpeg(_image(61, 83, seed=4), 80, sampling, restart=restart)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _assert_reads_as_jax(tmp_path, "r.jpg", data)


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("shape", [(61, 83), (8, 8)])
def test_jpeg_gray_matches_cv2(tmp_path, shape, quality):
    data = _jpeg(_image(*shape, seed=5, channels=1)[..., 0], quality)
    assert tjpeg.decode_jpeg(data).ndim == 2
    _assert_reads_as_jax(tmp_path, "g.jpg", data)


def _as_rgb_components(data: bytes) -> bytes:
    """The JPEG with its JFIF marker dropped and its component ids set to
    'R', 'G', 'B': libjpeg then takes the components as RGB."""
    assert data[2:4] == b"\xff\xe0"
    (n,) = struct.unpack(">H", data[4:6])
    out = bytearray(data[:2] + data[4 + n:])
    for marker, first in ((b"\xff\xc0", 10), (b"\xff\xda", 5)):
        p = out.index(marker)
        step = 3 if marker == b"\xff\xc0" else 2
        for k, cid in enumerate(b"RGB"):
            out[p + first + step * k] = cid
    return bytes(out)


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_jpeg_rgb_components_match_cv2(tmp_path, sampling):
    data = _as_rgb_components(_jpeg(_image(40, 56, seed=6), 85, sampling))
    _assert_reads_as_jax(tmp_path, "rgb.jpg", data)


def _bmp(img, bpp, top_down=False, palette=None):
    """A BITMAPINFOHEADER BMP of (H, W, 3) RGB (bpp 24 or 32) or of
    palette indices (bpp 8)."""
    h, w = img.shape[:2]
    if bpp == 8:
        px = img
        pal = np.zeros((256, 4), np.uint8)
        pal[:len(palette), :3] = palette[:, ::-1]
        extra = pal.tobytes()
    else:
        px = img[..., ::-1]
        if bpp == 32:
            px = np.concatenate([px, np.full((h, w, 1), 7, np.uint8)], -1)
        extra = b""
    stride = (w * bpp + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bpp // 8] = px.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    offset = 14 + 40 + len(extra)
    head = struct.pack("<2sIHHI", b"BM", offset + rows.size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                       0, rows.size, 0, 0, 0, 0)
    return head + info + extra + rows.tobytes()


def _bmp16(img):
    """A 16-bit (5-5-5) BI_RGB BMP of (H, W, 3) RGB, which cv2 reads."""
    h, w = img.shape[:2]
    v = ((img[..., 0].astype(np.uint16) >> 3) << 10
         | (img[..., 1].astype(np.uint16) >> 3) << 5 | img[..., 2] >> 3)
    stride = (w * 16 + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :2 * w] = v.astype("<u2").view(np.uint8).reshape(h, -1)
    head = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 16, 0, rows.size, 0, 0,
                       0, 0)
    return head + info + rows[::-1].tobytes()


@pytest.mark.parametrize("shape", [(61, 83), (5, 7)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_bmp_written_by_cv2_matches_cv2(tmp_path, channels, shape):
    img = _image(*shape, seed=7, channels=channels if channels != 4 else 3)
    if channels == 4:
        img = np.concatenate([img, img[..., :1]], -1)
    ok, buf = cv2.imencode(".bmp", img[..., 0] if channels == 1 else img)
    assert ok
    _assert_reads_as_jax(tmp_path, "c.bmp", buf.tobytes())


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("bpp", [8, 24, 32])
def test_bmp_built_by_hand_matches_cv2(tmp_path, bpp, top_down):
    rgb = _image(13, 21, seed=8)
    if bpp == 8:
        palette = np.random.default_rng(9).integers(0, 256, (200, 3), np.uint8)
        data = _bmp(rgb[..., 0] % 200, 8, top_down, palette)
    else:
        data = _bmp(rgb, bpp, top_down)
    _assert_reads_as_jax(tmp_path, "h.bmp", data)


# the truncation cases' files: 4:2:0 (ids "None" and "2", its restart
# interval), 4:4:4 and gray, with and without restart markers, all q95
TRUNCATED_FILES = {"None": ("420", None), "2": ("420", 2), "444": ("444", None),
                   "444-1": ("444", 1), "gray": (None, None),
                   "gray-3": (None, 3), "411": ("411", None),
                   "422-1": ("422", 1)}
# cuts in the headers (cv2 returns None): bytes 3, 30 and 200, and inside
# the last component's tables of the scan header
HEADER_CUTS = (3, 30, 200, "sos-4")
# cuts cv2 reads: in the scan header's Ss, Se and Ah/Al (which a
# sequential decoder ignores), at its end, one byte after it, halfway,
# 10 bytes before the end, right after a stuffed 0xFF, right after RSTn
DATA_CUTS = ("sos-3", "sos-1", "sos+0", "sos+1", 0.5, -10, "ff", "rst")
# cuts whose MCU in progress decodes to a run past the block's end or to
# samples out of range (the SIMD IDCT saturates where the C code wraps)
FOUND_CUTS = ((5630, "444"), (8902, "444"), (5012, "411"), (1722, "422-1"),
              (1787, "422-1"))


def _cut_at(data: bytes, cut) -> int:
    if not isinstance(cut, str):
        return int(len(data) * cut) if isinstance(cut, float) else cut % len(data)
    sos = data.index(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    if cut.startswith("sos"):
        return start + int(cut[3:])
    p = start
    while not (data[p] == 0xFF and (data[p + 1] == 0 if cut == "ff"
                                    else 0xD0 <= data[p + 1] <= 0xD7)):
        p += 1
    return p + 1 if cut == "ff" else p + 2


@pytest.mark.parametrize("cut,file", [
    pytest.param(cut, f, id=f"{cut}-{f}")
    for cut in HEADER_CUTS + DATA_CUTS for f, (_, restart) in
    list(TRUNCATED_FILES.items())[:6] if cut != "rst" or restart]
    + [pytest.param(cut, f, id=f"{cut}-{f}") for cut, f in FOUND_CUTS])
def test_truncated_jpeg_is_unreadable(tmp_path, cut, file):
    """A JPEG cut short in its headers raises ValueError in the decoder
    (no IndexError) and reads as unreadable, as cv2 returns None; one cut
    short in (or just before) its entropy-coded data reads as cv2 reads it:
    libjpeg pads the data with zero bits, so the MCU in progress decodes
    from them and every later one is grey, with no restart marker to
    clear that state."""
    sampling, restart = TRUNCATED_FILES[file]
    img = _image(61, 83, seed=11, channels=3 if sampling else 1)
    data = _jpeg(img if sampling else img[..., 0], 95, sampling, restart)
    n = _cut_at(data, cut)
    assert 0 < n < len(data)
    if cut not in HEADER_CUTS:
        _assert_reads_as_jax(tmp_path, "cut.jpg", data[:n])
        return
    assert n < data.index(b"\xff\xda") + 14
    with pytest.raises(ValueError) as e:
        tio.decode_image(data[:n])
    assert not isinstance(e.value, tjpeg.Unsupported)
    (tmp_path / "cut.jpg").write_bytes(data[:n])
    assert jio.imread_unit(str(tmp_path / "cut.jpg")) is None
    assert tio.read_u8(str(tmp_path / "cut.jpg")) == (None, None)


def test_formats_the_port_does_not_read_are_logged(tmp_path):
    img = _image(32, 48, seed=10)
    files = {
        "prog.jpg": _jpeg(img, 90, progressive=True),
        "tiff.tif": cv2.imencode(".tiff", img.astype(np.uint16) * 257)[1]
        .tobytes(),
        "555.bmp": _bmp16(img),
        "fine.jpg": _jpeg(img, 90),
        "junk.png": b"not an image",
    }
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    # cv2, and so the JAX package, reads all but the junk
    for name in files:
        assert (jio.imread_unit(str(tmp_path / name)) is None) == (
            name == "junk.png"), name
    assert tio.read_u8(str(tmp_path / "prog.jpg")) == (
        None, "progressive JPEG (SOF2)")
    assert tio.read_u8(str(tmp_path / "tiff.tif")) == (None, "16-bit TIFF")
    assert tio.read_u8(str(tmp_path / "junk.png")) == (None, None)
    logged = []
    got = [p.name for p, _ in tio.decode_iter(
        tio.collect_images(str(tmp_path)), log=logged.append)]
    assert got == ["fine.jpg"]
    assert sorted(logged) == sorted([
        "warning: 555.bmp unsupported by the port: 16-bit BMP",
        "warning: unreadable junk.png",
        "warning: prog.jpg unsupported by the port: progressive JPEG (SOF2)",
        "warning: tiff.tif unsupported by the port: 16-bit TIFF",
    ])


def _raw_as_rgb(img):
    """cv2's IMREAD_UNCHANGED array as (H, W, C): gray as one channel, BGR
    and BGRA as RGB and RGBA."""
    if img.ndim == 2:
        return img[..., None]
    return np.concatenate([img[..., 2::-1], img[..., 3:]], -1)


def _assert_tiff_reads_as_cv2(tmp_path, data):
    """``decode_tiff`` equals cv2's array, alpha included; ``read_u8`` and
    ``imread_unit`` equal the JAX package's reading."""
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert want is not None and want.dtype == np.uint8
    got = ttiff.decode_tiff(data)
    assert got.shape == _raw_as_rgb(want).shape
    np.testing.assert_array_equal(got, _raw_as_rgb(want))
    _assert_reads_as_jax(tmp_path, "t.tif", data)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 32946])
@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (2, 2000), (300, 7)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_tiff_written_by_cv2_matches_cv2(tmp_path, channels, shape,
                                         compression):
    img = _image(*shape, seed=12, channels=min(channels, 3))
    if channels == 4:
        img = np.concatenate([img, img[..., 1:2] ^ 0x5A], -1)
    ok, buf = cv2.imencode(".tiff", img[..., 0] if channels == 1 else img,
                           [cv2.IMWRITE_TIFF_COMPRESSION, compression])
    assert ok
    _assert_tiff_reads_as_cv2(tmp_path, buf.tobytes())


@pytest.mark.parametrize("shape", [(1, 1), (61, 83), (3, 3000)])
def test_tiff_of_the_port_encoder_matches_cv2(tmp_path, shape):
    data = ttiff.encode_tiff(_image(*shape, seed=13))
    _assert_tiff_reads_as_cv2(tmp_path, data)


def _packbits(raw: bytes) -> bytes:
    """PackBits: repeats of 3 to 128 bytes, literal runs of up to 128."""
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and j - i < 128 and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), raw[i]])
            i = j
            continue
        j = i + 1
        while j < len(raw) and j - i < 128 and not (
                j + 2 < len(raw) and raw[j] == raw[j + 1] == raw[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + raw[i:j]
        i = j
    return bytes(out)


def _coded(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return ttiff._lzw_encode(raw)
    if compression == 32773:
        return _packbits(raw)
    return zlib.compress(raw)


def _tiff(pages, order="<", tile=None, compression=1, predictor=1,
          photometric=None, planar=1, rows_per_strip=None, tags=None):
    """A TIFF built with ``struct``: one directory a page (an (H, W) or
    (H, W, C) uint8 or uint16 array), linked in order, after the pages'
    data, in ``order``'s byte order; strips of ``rows_per_strip`` rows
    (one strip where None) or (width, height) ``tile``s padded at the
    edges, each row differenced by ``predictor`` 2 and each strip or tile
    coded by ``compression``; ``tags`` adds or replaces entries (tag:
    (type, values))."""
    data, dirs = bytearray(8), []
    for img in pages:
        a = img if img.ndim == 3 else img[..., None]
        H, W, C = a.shape
        a = a.astype(a.dtype.newbyteorder(order))
        planes = [a] if planar == 1 else [a[..., c:c + 1] for c in range(C)]
        tw, th = tile or (W, rows_per_strip or H)
        offsets, counts = [], []
        for plane in planes:
            for y in range(0, H, th):
                for x in range(0, W, tw):
                    rows = th if tile else min(th, H - y)
                    blk = np.zeros((rows, tw, plane.shape[2]), plane.dtype)
                    part = plane[y:y + rows, x:x + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    flat = blk.reshape(rows, -1)
                    if predictor == 2:
                        n = plane.shape[2]
                        flat = flat.copy()
                        flat[:, n:] = flat[:, n:] - flat[:, :-n]
                    chunk = _coded(flat.tobytes(), compression)
                    offsets.append(len(data))
                    counts.append(len(chunk))
                    data += chunk + b"\0" * (len(chunk) & 1)
        entries = {256: (4, [W]), 257: (4, [H]),
                   258: (3, [a.dtype.itemsize * 8] * C),
                   259: (3, [compression]),
                   262: (3, [photometric if photometric is not None
                             else 1 if C == 1 else 2]),
                   277: (3, [C]), 284: (3, [planar]), 317: (3, [predictor])}
        if tile:
            entries.update({322: (3, [tw]), 323: (3, [th]),
                            324: (4, offsets), 325: (4, counts)})
        else:
            entries.update({273: (4, offsets), 278: (4, [th]),
                            279: (4, counts)})
        entries.update(tags or {})
        dirs.append(entries)
    links = []
    for entries in dirs:
        at = len(data)
        values_at = at + 2 + 12 * len(entries) + 4
        head, values = struct.pack(order + "H", len(entries)), b""
        for tag in sorted(entries):
            kind, vals = entries[tag]
            raw = struct.pack(order + ("H" if kind == 3 else "I") * len(vals),
                              *vals)
            if len(raw) <= 4:
                head += struct.pack(order + "HHI", tag, kind, len(vals))
                head += raw.ljust(4, b"\0")
            else:
                head += struct.pack(order + "HHII", tag, kind, len(vals),
                                    values_at + len(values))
                values += raw
        links.append(at + len(head))
        data += head + b"\0" * 4 + values
        data += b"\0" * (len(data) & 1)
        if len(links) == 1:
            data[:8] = (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(
                order + "I", at)
        else:
            data[links[-2]:links[-2] + 4] = struct.pack(order + "I", at)
    return bytes(data)


def _tiff_images():
    rgb = _image(37, 53, seed=14)
    gray = _image(29, 41, seed=15, channels=1)[..., 0]
    rgba = np.concatenate([rgb, _image(37, 53, seed=16, channels=1)], -1)
    return rgb, gray, rgba


TIFF_BUILT = {
    "big-endian rgb lzw predictor": lambda rgb, gray, rgba: _tiff(
        [rgb], ">", compression=5, predictor=2, rows_per_strip=8),
    "big-endian gray": lambda rgb, gray, rgba: _tiff([gray], ">"),
    "big-endian rgba deflate": lambda rgb, gray, rgba: _tiff(
        [rgba], ">", compression=8, predictor=2),
    "tiled rgb deflate predictor": lambda rgb, gray, rgba: _tiff(
        [rgb], tile=(16, 16), compression=32946, predictor=2),
    "tiled big-endian gray packbits": lambda rgb, gray, rgba: _tiff(
        [gray], ">", tile=(32, 16), compression=32773),
    "tiled rgba lzw": lambda rgb, gray, rgba: _tiff(
        [rgba], tile=(48, 32), compression=5),
    "two pages": lambda rgb, gray, rgba: _tiff([rgb, gray], compression=5),
    "two pages big-endian": lambda rgb, gray, rgba: _tiff([gray, rgba], ">"),
    "strips of 5 rows packbits": lambda rgb, gray, rgba: _tiff(
        [rgb], compression=32773, rows_per_strip=5),
    "predictor without compression": lambda rgb, gray, rgba: _tiff(
        [rgb], predictor=2),
    "predictor with packbits": lambda rgb, gray, rgba: _tiff(
        [rgb], compression=32773, predictor=2),
    "unspecified extra sample": lambda rgb, gray, rgba: _tiff(
        [rgba], tags={338: (3, [0])}),
    "associated alpha": lambda rgb, gray, rgba: _tiff(
        [rgba], tags={338: (3, [1])}),
    "unassociated alpha": lambda rgb, gray, rgba: _tiff(
        [rgba], compression=5, tags={338: (3, [2])}),
}


@pytest.mark.parametrize("name", sorted(TIFF_BUILT))
def test_tiff_built_by_hand_matches_cv2(tmp_path, name):
    _assert_tiff_reads_as_cv2(tmp_path, TIFF_BUILT[name](*_tiff_images()))


def test_tiff_unassociated_alpha_is_premultiplied():
    """cv2 reads colours under an unassociated alpha premultiplied by it
    (libtiff's RGBA reader), so the two alpha files differ."""
    _, _, rgba = _tiff_images()
    assoc = ttiff.decode_tiff(TIFF_BUILT["associated alpha"](*_tiff_images()))
    unassoc = ttiff.decode_tiff(
        TIFF_BUILT["unassociated alpha"](*_tiff_images()))
    np.testing.assert_array_equal(assoc, rgba)
    assert not np.array_equal(unassoc[..., :3], rgba[..., :3])


def _palette(rgb, gray, rgba):
    cmap = np.random.default_rng(17).integers(0, 65536, 768).tolist()
    return _tiff([gray], photometric=3, tags={320: (3, cmap)})


# variants cv2 reads and the port does not: (file, the name it logs)
TIFF_UNSUPPORTED = {
    "16-bit": (lambda rgb, gray, rgba: _tiff([rgb.astype(np.uint16) * 257]),
               "16-bit TIFF"),
    "palette": (_palette, "palette TIFF"),
    "cmyk": (lambda rgb, gray, rgba: _tiff([rgba], photometric=5),
             "CMYK TIFF"),
    "planar": (lambda rgb, gray, rgba: _tiff([rgb], planar=2),
               "planar TIFF"),
    "white is zero": (lambda rgb, gray, rgba: _tiff([gray], photometric=0),
                      "WhiteIsZero TIFF"),
    "orientation": (lambda rgb, gray, rgba: _tiff(
        [rgb], tags={274: (3, [3])}), "TIFF of orientation 3"),
    "gray and alpha": (lambda rgb, gray, rgba: _tiff(
        [rgba[..., :2]], photometric=1), "gray and alpha TIFF"),
}


@pytest.mark.parametrize("name", sorted(TIFF_UNSUPPORTED))
def test_tiff_variants_the_port_does_not_read_are_named(tmp_path, name):
    build, why = TIFF_UNSUPPORTED[name]
    path = tmp_path / "v.tif"
    path.write_bytes(build(*_tiff_images()))
    assert jio.imread_unit(str(path)) is not None  # cv2 reads it
    assert tio.read_u8(str(path)) == (None, why)


@pytest.mark.parametrize("compression,first,why", [
    (7, b"\xff\xd8", "JPEG TIFF"), (6, b"\xff\xd8", "old-style JPEG TIFF"),
    (5, b"\x00\x01", "old-style LZW TIFF")])
def test_tiff_compressions_the_port_does_not_read_are_named(compression,
                                                            first, why):
    """The compressions named from the tag (JPEG) or from the strip's
    first bytes (LZW's old LSB-first codes, which begin 0x00 0x01)."""
    rgb, _, _ = _tiff_images()
    data = bytearray(_tiff([rgb], compression=1))
    (at,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[at:at + 2])
    for k in range(n):
        e = at + 2 + 12 * k
        if struct.unpack("<H", data[e:e + 2])[0] == 259:
            data[e + 8:e + 10] = struct.pack("<H", compression)
    data[8:10] = first
    with pytest.raises(tjpeg.Unsupported, match=f"^{why}$"):
        ttiff.decode_tiff(bytes(data))


def test_cli_six_reads_a_tiff_as_its_png_twin(tmp_path):
    """One frame as ``f.png`` and as ``g.tif`` in a folder: the port's
    ``cli six --device cpu`` writes each strategy's output equal for the
    two, and equal to the JAX CLI's within the float tolerances of
    ``tests/test_torch_six.py``."""
    frame = (torch_frames.underwater_img() * 255).round().astype(np.uint8)
    src = tmp_path / "in"
    src.mkdir()
    (src / "f.png").write_bytes(tio.encode_png(frame))
    (src / "g.tif").write_bytes(ttiff.encode_tiff(frame))
    tcli.main(["six", "--input", str(src), "--output", str(tmp_path / "port"),
               "--device", "cpu"])
    jcli.main(["six", "--input", str(src), "--output", str(tmp_path / "jax")])
    with open(tmp_path / "port" / "processing_log.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert sorted({r["filename"] for r in rows}) == ["f.png", "g.tif"]
    assert all(r["status"] == "success" for r in rows)
    outs = sorted(p.name for p in (tmp_path / "port").glob("f_*.png"))
    assert len(outs) == 6
    for name in outs:
        twin = "g" + name[1:]
        port = (tmp_path / "port" / name).read_bytes()
        assert (tmp_path / "port" / twin).read_bytes() == port, name
        assert ((tmp_path / "jax" / twin).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
        a = tio.imread_u8(str(tmp_path / "port" / name)) / 255.0
        b = tio.imread_u8(str(tmp_path / "jax" / name)) / 255.0
        if "dehazing" in name:
            mse = np.mean((a - b) ** 2)
            assert mse == 0 or 10 * np.log10(1.0 / mse) >= 50.0, name
        else:
            assert np.abs(a - b).max() <= 1 / 255 + 1e-9, name
