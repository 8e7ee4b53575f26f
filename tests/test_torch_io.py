"""The port's image reading (``utils/io.py`` with the numpy JPEG and BMP
decoders) against the JAX package's, which is ``cv2.imread(path,
IMREAD_UNCHANGED)`` and its channel handling: bit for bit on JPEGs as
``cv2.imencode`` writes them (every sampling factor, two qualities, a
restart interval, gray, odd sizes, RGB components) and on BMPs (as cv2
writes them, and 32-bit and top-down variants built here); files cv2 reads
and the port does not come back as None and are logged by name."""

import struct

import cv2
import numpy as np
import pytest

from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import jpeg as tjpeg

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
        "tiff.tif": cv2.imencode(".tiff", img)[1].tobytes(),
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
    assert tio.read_u8(str(tmp_path / "tiff.tif")) == (None, "TIFF")
    assert tio.read_u8(str(tmp_path / "junk.png")) == (None, None)
    logged = []
    got = [p.name for p, _ in tio.decode_iter(
        tio.collect_images(str(tmp_path)), log=logged.append)]
    assert got == ["fine.jpg"]
    assert sorted(logged) == sorted([
        "warning: 555.bmp unsupported by the port: 16-bit BMP",
        "warning: unreadable junk.png",
        "warning: prog.jpg unsupported by the port: progressive JPEG (SOF2)",
        "warning: tiff.tif unsupported by the port: TIFF",
    ])
