"""The port's image reading (``utils/io.py`` with the numpy JPEG, BMP and
TIFF decoders) against the JAX package's, which is ``cv2.imread(path,
IMREAD_UNCHANGED)`` and its channel handling: bit for bit on JPEGs as
``cv2.imencode`` writes them (every sampling factor, two qualities, a
restart interval, gray, odd sizes, RGB components), on BMPs (as cv2
writes them, and 32-bit and top-down variants built here) and on 8-bit
TIFFs (as cv2 writes them in each of its compressions, as the port's
encoder writes them, and big-endian, tiled, multi-page, predictor and
alpha variants built here), and 16-bit TIFFs the same ways (their
samples through ``imread_unit`` up to 257, through ``imread_u8`` as
JAX's ``train/data._imread_rgb`` reads them); files cv2 reads and the
port does not come back as None and are logged by name; a ``.tif`` in a
``cli six`` folder is enhanced as its ``.png`` twin is."""

import csv
import struct
import zlib

import cv2
import numpy as np
import pytest

from tests import torch_frames
from tests import torch_jpeg_scans as jpeg_scans
from tests import torch_tiff
from underwater_image_enhancement_tpu import cli as jcli
from underwater_image_enhancement_tpu.train import data as jdata
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
    assert tio.read_image(str(tmp_path / "cut.jpg")) == (None, None)


def test_formats_the_port_does_not_read_are_logged(tmp_path):
    img = _image(32, 48, seed=10)
    files = {
        "lab.tif": _tiff([img], photometric=8),
        "signed.tif": _tiff([img.astype(np.int16) - 300]),
        "tiff.tif": cv2.imencode(".tiff", img.astype(np.uint16) * 257)[1]
        .tobytes(),
        "webp.bmp": cv2.imencode(".webp", img)[1].tobytes(),
        "avif.png": cv2.imencode(".avif", img)[1].tobytes(),
        "pfm.tif": cv2.imencode(".pfm", img)[1].tobytes(),
        "fine.jpg": _jpeg(img, 90),
        "junk.png": b"not an image",
        # OpenEXR's signature: this cv2 is built without OpenEXR
        "exr.png": b"v/1\x01" + bytes(60),
    }
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    # cv2 reads all but the junk and the OpenEXR file; the JAX package's
    # cvtColor raises on the signed samples
    for name in files:
        if name == "signed.tif":
            with pytest.raises(cv2.error):
                jio.imread_unit(str(tmp_path / name))
            continue
        assert (jio.imread_unit(str(tmp_path / name)) is None) == (
            name in ("junk.png", "exr.png")), name
    # the CIELab TIFF, which the port skipped before it read it
    np.testing.assert_array_equal(tio.imread_unit(str(tmp_path / "lab.tif")),
                                  jio.imread_unit(str(tmp_path / "lab.tif")))
    # the 16-bit TIFF, which the port skipped before it read them
    img, why = tio.read_image(str(tmp_path / "tiff.tif"), color=True)
    assert why is None
    np.testing.assert_array_equal(
        img, jdata._imread_rgb(str(tmp_path / "tiff.tif")))
    assert tio.read_image(str(tmp_path / "junk.png")) == (None, None)
    assert tio.read_image(str(tmp_path / "exr.png")) == (None, None)
    # the PFM, named by its signature, read as JAX reads it
    np.testing.assert_array_equal(tio.imread_unit(str(tmp_path / "pfm.tif")),
                                  jio.imread_unit(str(tmp_path / "pfm.tif")))
    logged = []
    got = [p.name for p, _ in tio.decode_iter(
        tio.collect_images(str(tmp_path)), log=logged.append)]
    assert got == ["fine.jpg", "lab.tif", "pfm.tif", "tiff.tif"]
    assert sorted(logged) == sorted([
        "warning: avif.png unsupported by the port: AVIF",
        "warning: webp.bmp unsupported by the port: WebP",
        "warning: unreadable junk.png",
        "warning: unreadable exr.png",
        "warning: signed.tif unsupported by the port: signed 16-bit TIFF, "
        "on which the JAX reader raises",
    ])


# ---------------------------------------------------------------------------
# Progressive JPEG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", SAMPLING + [None])
@pytest.mark.parametrize("shape", [(61, 83), (3, 40), (40, 1), (17, 3)])
def test_progressive_jpeg_of_cv2_matches_cv2(tmp_path, shape, sampling,
                                             quality):
    """cv2's progressive files (its 10-scan script, 6 for gray, EOB runs,
    Huffman tables optimised a scan) at every sampling, gray, two
    qualities, sides that are not multiples of 8 or 16 and frames 1 and 3
    pixels wide or high."""
    img = _image(*shape, seed=quality, channels=3 if sampling else 1)
    data = _jpeg(img if sampling else img[..., 0], quality, sampling,
                 progressive=True)
    assert data[:data.index(b"\xff\xda")].find(b"\xff\xc2") > 0
    _assert_reads_as_jax(tmp_path, "p.jpg", data)


@pytest.mark.parametrize("sampling", ["420", "444", None])
@pytest.mark.parametrize("restart", [1, 4])
def test_progressive_jpeg_restart_interval_matches_cv2(tmp_path, restart,
                                                       sampling):
    img = _image(37, 58, seed=restart, channels=3 if sampling else 1)
    data = _jpeg(img if sampling else img[..., 0], 85, sampling, restart,
                 progressive=True)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _assert_reads_as_jax(tmp_path, "pr.jpg", data)


@pytest.mark.parametrize("restart", [0, 1, 7])
@pytest.mark.parametrize("name", jpeg_scans.SCRIPTS)
@pytest.mark.parametrize("sampling", ["420", "422", None])
def test_transcoded_progressive_jpeg_matches_its_baseline_twin(
        tmp_path, sampling, name, restart):
    """The transcoder's scripts (cv2's, spectral selection only, the DC a
    component, successive approximation in three steps, one that stops at
    Al=1) with restart intervals of 1 and 7 MCUs: the decode equals cv2's
    and, where the script sends every bit, the baseline file's."""
    img = _image(45, 67, seed=7, channels=3 if sampling else 1)
    base = _jpeg(img if sampling else img[..., 0], 90, sampling)
    data = jpeg_scans.transcode(
        base, jpeg_scans.script(name, 3 if sampling else 1), restart)
    _assert_reads_as_jax(tmp_path, "t.jpg", data)
    got = tjpeg.decode_jpeg(data)
    if name == "stops_at_1":  # libjpeg smooths what it does not know
        assert not np.array_equal(got, tjpeg.decode_jpeg(base))
    else:
        np.testing.assert_array_equal(got, tjpeg.decode_jpeg(base))


def _scan_bounds(data: bytes):
    """(start, end) of each scan's entropy-coded data."""
    out, p = [], 2
    while data[p + 1] != 0xD9:
        (n,) = struct.unpack(">H", data[p + 2:p + 4])
        p += 2 + n
        if data[p - n - 1] != 0xDA:
            continue
        start = p
        while data[p] != 0xFF or data[p + 1] == 0 or 0xD0 <= data[p + 1] <= 0xD7:
            p += 1 if data[p] != 0xFF else 2
        out.append((start, p))
    return out


# (sampling, restart, scan, where in its data): cuts in cv2's files in the
# DC first scan, in AC first scans of Y and of the chroma, in Y's AC
# refine from Al 2 to 1, in the DC refine, in the chroma's and Y's last
# refine scans, at a scan's first byte, and between two scans
PROGRESSIVE_CUTS = (("444", None, 1, 0.5), ("420", None, 2, 0.3),
                    ("420", None, 3, 0.0), ("422", 2, 4, 0.6),
                    ("420", None, 6, 0.5), ("444", 1, 7, 0.4),
                    ("420", 3, 8, 0.7), ("420", None, 10, 0.5),
                    ("411", None, 10, 0.9), ("440", None, 5, 1.0),
                    (None, None, 4, 0.5), (None, 2, 6, 0.2))


@pytest.mark.parametrize("sampling,restart,scan,where", PROGRESSIVE_CUTS)
def test_truncated_progressive_jpeg_matches_cv2(tmp_path, sampling, restart,
                                                scan, where):
    """A progressive file cut short: the scans before the cut stand, the
    MCU in progress decodes from zero bits, the blocks after it keep what
    earlier scans put there, later scans are absent, and libjpeg-turbo's
    block smoothing (its coefficient bits latched a component, the bits
    before the last scan for the iMCU rows past the last good one)
    estimates what is not known."""
    img = _image(61, 83, seed=scan, channels=3 if sampling else 1)
    data = _jpeg(img if sampling else img[..., 0], 90, sampling, restart,
                 progressive=True)
    a, b = _scan_bounds(data)[scan - 1]
    _assert_reads_as_jax(tmp_path, "cut.jpg", data[:a + int((b - a) * where)])


@pytest.mark.parametrize("scans,why", [
    ([((0, 1, 2), 0, 0, 0, 0), ((0, 1), 1, 63, 0, 0)], None),
    ([((0, 1, 2), 0, 0, 0, 14)], None),
    ([((0, 1, 2), 0, 0, 0, 2), ((0, 1, 2), 0, 0, 2, 0)], None),
    ([((0, 1, 2), 0, 5, 0, 0)], None),
    ([((0,), 1, 63, 0, 0), ((0, 1, 2), 0, 0, 0, 0)], "AC before DC"),
    ([((0, 1), 0, 0, 0, 0), ((2,), 1, 63, 0, 0)], "no DC for Cr"),
    ([((0, 1, 2), 0, 0, 0, 1), ((0, 1, 2), 0, 0, 2, 1)], "Ah not Al"),
], ids=["ac-two-components", "al-14", "ah-al-gap", "dc-se-5",
        "ac-before-dc", "no-dc-for-cr", "refine-ah-mismatch"])
def test_bad_progressions_fail_where_cv2_fails(tmp_path, scans, why):
    """Progressions libjpeg refuses (an AC scan of two components, Al over
    13, a refine whose Al is not Ah - 1, a DC scan with Se > 0) raise
    ValueError, as cv2 returns None; those it only warns about decode as
    cv2 decodes them."""
    base = _jpeg(_image(24, 40, seed=1), 90, "420")
    rest = [((k,), 1, 63, 0, 0) for k in range(3)]
    data = jpeg_scans.transcode(base, scans + (rest if why is None else []))
    (tmp_path / "b.jpg").write_bytes(data)
    if why is None:
        assert jio.imread_unit(str(tmp_path / "b.jpg")) is None
        with pytest.raises(ValueError, match="bad progression") as e:
            tjpeg.decode_jpeg(data)
        assert not isinstance(e.value, tjpeg.Unsupported)
        assert tio.read_image(str(tmp_path / "b.jpg")) == (None, None)
    else:
        _assert_reads_as_jax(tmp_path, "b.jpg", data)


def test_cli_six_reads_a_progressive_jpeg_as_its_baseline_twin(tmp_path):
    """One frame as a baseline ``f.jpg`` and as ``g.jpg``, the same
    coefficients in cv2's progressive script: the port's ``cli six
    --device cpu`` writes each strategy's output equal for the two, and
    the JAX CLI does too."""
    frame = (torch_frames.underwater_img() * 255).round().astype(np.uint8)
    src = tmp_path / "in"
    src.mkdir()
    base = tjpeg.encode_jpeg(frame)
    (src / "f.jpg").write_bytes(base)
    (src / "g.jpg").write_bytes(
        jpeg_scans.transcode(base, jpeg_scans.script("cv2", 3)))
    _assert_cli_six_twins(tmp_path, src, "f.jpg", "g.jpg")


def _raw_as_rgb(img):
    """cv2's IMREAD_UNCHANGED array as (H, W, C): gray as one channel, BGR
    and BGRA as RGB and RGBA."""
    if img.ndim == 2:
        return img[..., None]
    return np.concatenate([img[..., 2::-1], img[..., 3:]], -1)


def _assert_tiff_reads_as_cv2(tmp_path, data):
    """``decode_tiff`` equals cv2's array (``cv2.imread(path,
    IMREAD_UNCHANGED)``, as the JAX package reads), alpha included, uint8
    or uint16; ``imread_unit`` equals the JAX package's bit for bit and
    ``imread_u8`` JAX's ``train/data._imread_rgb`` (``IMREAD_COLOR``).
    ``cv2.imdecode`` gives the same array, or None where libtiff reads
    from memory and refuses uncompressed tiles of a size not a multiple
    of 1024 bytes (the 8-bit path, and ``IMREAD_COLOR`` at 16 bits)."""
    path = tmp_path / "t.tif"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert want is not None
    from_memory = cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_UNCHANGED)
    if from_memory is not None:
        np.testing.assert_array_equal(from_memory, want)
    got = ttiff.decode_tiff(data)
    assert got.dtype == want.dtype and got.shape == _raw_as_rgb(want).shape
    np.testing.assert_array_equal(got, _raw_as_rgb(want))
    np.testing.assert_array_equal(tio.imread_unit(str(path)),
                                  jio.imread_unit(str(path)))
    np.testing.assert_array_equal(tio.imread_u8(str(path)),
                                  jdata._imread_rgb(str(path)))
    if want.dtype == np.uint8:
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


# the TIFF writer of the tests and chip_smoke.py
_tiff = torch_tiff.tiff


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
    # uncompressed tiles: cv2.imread reads them, cv2.imdecode only where
    # a tile's bytes are a multiple of 1024
    "tiled rgba uncompressed": lambda rgb, gray, rgba: _tiff(
        [rgba], tile=(16, 16)),
    "tiled gray uncompressed 1 KiB tiles": lambda rgb, gray, rgba: _tiff(
        [gray], ">", tile=(64, 16)),
    "tiled rgb uncompressed": lambda rgb, gray, rgba: _tiff(
        [rgb], tile=(16, 16)),
    "tiled gray uncompressed": lambda rgb, gray, rgba: _tiff(
        [gray], ">", tile=(48, 16)),
    # the variants TIFF_UNSUPPORTED named before the port read them
    "palette": lambda rgb, gray, rgba: _palette(rgb, gray, rgba),
    "cmyk": lambda rgb, gray, rgba: _tiff([rgba], photometric=5),
    "planar": lambda rgb, gray, rgba: _tiff([rgb], planar=2),
    "white is zero": lambda rgb, gray, rgba: _tiff([gray], photometric=0),
    "orientation 3": lambda rgb, gray, rgba: _tiff(
        [rgb], tags={274: (3, [3])}),
    "gray and alpha": lambda rgb, gray, rgba: _tiff(
        [rgba[..., :2]], photometric=1),
    # and the compression test's old-style LZW
    "old-style lzw": lambda rgb, gray, rgba: _tiff(
        [rgb], compression="lzw-old", rows_per_strip=9),
}


@pytest.mark.parametrize("name", sorted(TIFF_BUILT))
def test_tiff_built_by_hand_matches_cv2(tmp_path, name):
    _assert_tiff_reads_as_cv2(tmp_path, TIFF_BUILT[name](*_tiff_images()))


def _tiff16_images():
    """16-bit RGB, gray and RGBA of every sample value's range: the seeded
    8-bit images times 257 plus seeded low bytes."""
    rng = np.random.default_rng(18)
    return tuple((a.astype(np.uint16) * 257) ^ rng.integers(
        0, 256, a.shape).astype(np.uint16) for a in _tiff_images())


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 32946])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_tiff16_written_by_cv2_matches_cv2(tmp_path, channels, compression):
    rgb, gray, rgba = _tiff16_images()
    img = {1: gray, 3: rgb[..., ::-1], 4: rgba[..., [2, 1, 0, 3]]}[channels]
    ok, buf = cv2.imencode(".tiff", img,
                           [cv2.IMWRITE_TIFF_COMPRESSION, compression])
    assert ok
    _assert_tiff_reads_as_cv2(tmp_path, buf.tobytes())


TIFF16_BUILT = {
    "16-bit": lambda rgb, gray, rgba: _tiff([rgb]),
    "big-endian rgb lzw predictor": lambda rgb, gray, rgba: _tiff(
        [rgb], ">", compression=5, predictor=2, rows_per_strip=8),
    "big-endian gray deflate predictor": lambda rgb, gray, rgba: _tiff(
        [gray], ">", compression=8, predictor=2, rows_per_strip=7),
    "gray lzw predictor": lambda rgb, gray, rgba: _tiff(
        [gray], compression=5, predictor=2),
    "big-endian rgba deflate": lambda rgb, gray, rgba: _tiff(
        [rgba], ">", compression=32946, predictor=2),
    "strips of 5 rows packbits": lambda rgb, gray, rgba: _tiff(
        [rgb], compression=32773, rows_per_strip=5),
    "predictor with packbits": lambda rgb, gray, rgba: _tiff(
        [rgb], ">", compression=32773, predictor=2),
    "predictor without compression": lambda rgb, gray, rgba: _tiff(
        [gray], predictor=2),
    "tiled rgb lzw predictor": lambda rgb, gray, rgba: _tiff(
        [rgb], ">", tile=(16, 16), compression=5, predictor=2),
    "tiled rgba deflate": lambda rgb, gray, rgba: _tiff(
        [rgba], tile=(32, 16), compression=8),
    # gray tiles cut at the right edge: an even and an odd skew
    "tiled gray lzw": lambda rgb, gray, rgba: _tiff(
        [gray], tile=(16, 16), compression=5),
    "tiled big-endian gray packbits": lambda rgb, gray, rgba: _tiff(
        [gray], ">", tile=(32, 16), compression=32773),
    "tiled gray uncompressed 1 KiB tiles": lambda rgb, gray, rgba: _tiff(
        [gray], tile=(32, 16)),
    "tiled rgb uncompressed": lambda rgb, gray, rgba: _tiff(
        [rgb], tile=(16, 16)),
    "tiled gray uncompressed": lambda rgb, gray, rgba: _tiff(
        [gray], ">", tile=(16, 16)),
    "two pages": lambda rgb, gray, rgba: _tiff([gray, rgb], compression=5),
    "unspecified extra sample": lambda rgb, gray, rgba: _tiff(
        [rgba], compression=5, predictor=2, tags={338: (3, [0])}),
    "associated alpha": lambda rgb, gray, rgba: _tiff(
        [rgba], ">", tags={338: (3, [1])}),
    "unassociated alpha": lambda rgb, gray, rgba: _tiff(
        [rgba], compression=5, tags={338: (3, [2])}),
}


@pytest.mark.parametrize("name", sorted(TIFF16_BUILT))
def test_tiff16_built_by_hand_matches_cv2(tmp_path, name):
    """16-bit files in each layout and compression of the 8-bit ones: the
    predictor's sums mod 65536 in the file's byte order; ``IMREAD_COLOR``
    through libtiff's RGBA reader (gray's high byte, with its row step in
    a cut tile; RGB ``(v + 128) // 257``; an unassociated alpha
    premultiplied)."""
    _assert_tiff_reads_as_cv2(tmp_path, TIFF16_BUILT[name](*_tiff16_images()))


def test_tiff16_alpha_is_read_as_it_is():
    """At 16 bits cv2 reads every extra sample's colours unchanged, where
    the 8-bit reader premultiplies an unassociated alpha."""
    rgb, gray, rgba = _tiff16_images()
    for extra in (0, 1, 2):
        data = _tiff([rgba], tags={338: (3, [extra])})
        np.testing.assert_array_equal(ttiff.decode_tiff(data), rgba)


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


def _components_jpeg(blk, plane):
    """A JPEG strip of a block's own samples (one component a sample)."""
    return jpeg_scans.sequential([blk[..., c] for c in range(blk.shape[2])],
                                 app=())


# variants of ROADMAP Queue 1 item 11.9 that cv2 reads and the port named
# unread until it read them: the files of the test that named them
TIFF_ITEM_11_9 = {
    "cielab": lambda rgb, gray, rgba: _tiff([rgb], photometric=8),
    # RGB bytes read as YCbCr blocks of the default 2x2 subsampling
    "ycbcr": lambda rgb, gray, rgba: _tiff([rgb], photometric=6),
    "14-bit": lambda rgb, gray, rgba: _tiff(
        [gray[:, :40].reshape(gray.shape[0], 20, 2)], photometric=1,
        tags={256: (4, [22]), 258: (3, [14]), 277: (3, [1])}),
    "12-bit": lambda rgb, gray, rgba: _tiff(
        [gray[:, :40].reshape(gray.shape[0], 20, 2)], photometric=1,
        tags={256: (4, [26]), 258: (3, [12]), 277: (3, [1])}),
    "floating-point": lambda rgb, gray, rgba: _tiff(
        [(gray[:, :10] / np.float32(255)).astype("<f4").view(np.uint8)
         .reshape(gray.shape[0], 10, 4)], photometric=1,
        tags={256: (4, [10]), 258: (3, [32]), 277: (3, [1]),
              339: (3, [3])}),
    "bigtiff": lambda rgb, gray, rgba: _tiff([rgb], big=True),
    # the third part: no StripByteCounts, palette + ExtraSamples, JPEG in
    # planar RGB and in CMYK
    "no strip byte counts lzw": lambda rgb, gray, rgba: _tiff(
        [rgb], compression=5, predictor=2, tags={279: None}),
    "no strip byte counts planar": lambda rgb, gray, rgba: _tiff(
        [rgb], compression=5, planar=2, tags={279: None}),
    "palette and extra sample": lambda rgb, gray, rgba: _tiff(
        [np.stack([rgb[..., 0], rgba[..., 3]], -1)], photometric=3,
        tags={320: (3, (np.arange(768) * 85 % 65536).tolist()),
              338: (3, [2])}),
    "jpeg planar rgb": lambda rgb, gray, rgba: _tiff(
        [rgb], compression=7, photometric=2, planar=2,
        rows_per_strip=16, jpeg=_components_jpeg),
    "jpeg cmyk": lambda rgb, gray, rgba: _tiff(
        [np.concatenate([rgb, 255 - rgba[..., 3:]], -1)], compression=7,
        photometric=5, jpeg=_components_jpeg),
    # the second part: the CCITT and SGILog codecs
    "ccitt rle": lambda rgb, gray, rgba: _ccitt(gray, 2),
    "ccitt rlew": lambda rgb, gray, rgba: _ccitt(gray, 32771),
    "ccitt g3 1-d": lambda rgb, gray, rgba: _ccitt(gray, 3),
    "ccitt g3 2-d": lambda rgb, gray, rgba: _ccitt(gray, 3, 5),
    "ccitt g4": lambda rgb, gray, rgba: _ccitt(gray, 4),
    "sgilog logl": lambda rgb, gray, rgba: _sgilog(rgb, 34676, 32844),
    "sgilog logluv": lambda rgb, gray, rgba: _sgilog(rgb, 34676, 32845),
    "sgilog24 logluv": lambda rgb, gray, rgba: _sgilog(rgb, 34677, 32845),
}


def _ccitt(gray, compression, options=0):
    """The gray image's dark half as black bits, CCITT-coded in strips of
    8 rows (WhiteIsZero, as fax files are)."""
    bits = (gray < 128).astype(np.uint8)
    return _tiff([bits], compression=compression, bits=1, photometric=0,
                 rows_per_strip=8,
                 coder=lambda blk: torch_tiff.ccitt(blk, compression,
                                                    options),
                 tags={292: (4, [options])} if compression == 3 else None)


def _sgilog(rgb, compression, photometric):
    """The RGB image's X, Y, Z as SGILog codes in strips of 8 rows."""
    codes = torch_tiff.sgilog_codes(torch_tiff.frame_xyz(rgb), compression,
                                    photometric)
    return _tiff([torch_tiff.sgilog_page(codes, photometric)],
                 compression=compression, photometric=photometric,
                 rows_per_strip=8,
                 coder=torch_tiff.sgilog_coder(photometric, compression))


@pytest.mark.parametrize("name", sorted(TIFF_ITEM_11_9))
def test_tiff_variants_of_item_11_9_read_as_jax(tmp_path, name):
    """Each reads through ``imread_unit`` as JAX's ``imread_unit`` reads it
    (12- and 14-bit samples shifted to 16 bits, floats over 255, CCITT's
    bits as 0 and 255, LogLuv's floats) and through ``imread_u8`` as
    ``train/data._imread_rgb`` (None where ``IMREAD_COLOR`` refuses the
    sample size).  LogL's signed bytes, on which JAX's ``cvtColor``
    raises, the port names (``read_image``) and skips."""
    path = tmp_path / "v.tif"
    path.write_bytes(TIFF_ITEM_11_9[name](*_tiff_images()))
    img, why = tio.read_image(str(path))
    if name == "sgilog logl":
        assert img is None and why.startswith("signed 8-bit TIFF")
        with pytest.raises(cv2.error):
            jio.imread_unit(str(path))
    else:
        want = jio.imread_unit(str(path))
        assert want is not None  # cv2 reads it
        got = tio.imread_unit(str(path))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    u8 = jdata._imread_rgb(str(path))
    if u8 is None:
        assert tio.imread_u8(str(path)) is None
    else:
        np.testing.assert_array_equal(tio.imread_u8(str(path)), u8)


@pytest.mark.parametrize("compression,photometric,why", [
    (2, None, "CCITT RLE TIFF"), (3, None, "CCITT G3 TIFF"),
    (4, None, "CCITT G4 TIFF"), (34676, 32844, "SGILog LogL TIFF"),
    (34677, 32845, "SGILog24 LogLuv TIFF")])
def test_tiff_compressions_the_port_does_not_read_are_named(
        tmp_path, compression, photometric, why):
    """The compressions of item 11.9 that the port once named unread
    (CCITT, and SGILog under LogL or LogLuv), relabelled on an
    uncompressed RGB file whose strip starts 0x00 0x01: read now, each
    reads, or is refused (ValueError, never ``Unsupported``), as
    ``cv2.imread`` gives it in both modes (``why`` names the case as it
    was named)."""
    data = _relabelled(compression, photometric)
    path = tmp_path / "r.tif"
    path.write_bytes(data)
    for color, flag in ((False, cv2.IMREAD_UNCHANGED),
                        (True, cv2.IMREAD_COLOR)):
        want = cv2.imread(str(path), flag)
        if want is None:
            with pytest.raises(ValueError) as e:
                ttiff.decode_tiff(data, color)
            assert not isinstance(e.value, tjpeg.Unsupported), e.value
        else:
            got = ttiff.decode_tiff(data, color)
            assert got.dtype == want.dtype, (why, color)
            np.testing.assert_array_equal(got.view(np.uint8),
                                          _raw_as_rgb(want).view(np.uint8))


def _relabelled(compression, photometric):
    """An uncompressed RGB file of ``_tiff_images``' colour image, its
    compression tag set to ``compression``, its strip starting 0x00
    0x01."""
    rgb, _, _ = _tiff_images()
    data = bytearray(_tiff([rgb], compression=1, photometric=photometric))
    (at,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[at:at + 2])
    for k in range(n):
        e = at + 2 + 12 * k
        if struct.unpack("<H", data[e:e + 2])[0] == 259:
            data[e + 8:e + 10] = struct.pack("<H", compression)
    data[8:10] = b"\x00\x01"
    return bytes(data)


def test_no_tiff_the_tests_build_raises_unsupported():
    """Every TIFF this file builds decodes in both modes or raises
    ValueError: none is named unsupported by the port any more."""
    images = _tiff_images()
    files = [f(*images) for f in TIFF_BUILT.values()]
    files += [f(*_tiff16_images()) for f in TIFF16_BUILT.values()]
    files += [f(*images) for f in TIFF_ITEM_11_9.values()]
    files += [_relabelled(c, p) for c, p in (
        (2, None), (3, None), (4, None), (32771, None), (34676, 32844),
        (34676, 32845), (34677, 32845), (32809, None), (32766, None))]
    for data in files:
        for color in (False, True):
            try:
                ttiff.decode_tiff(data, color)
            except ValueError as e:
                assert not isinstance(e, tjpeg.Unsupported), e


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
    _assert_cli_six_twins(tmp_path, src, "f.png", "g.tif")


def _assert_cli_six_twins(tmp_path, src, f, g):
    """``cli six`` of the port and of JAX on a folder holding one frame
    as ``f`` and ``g``: the twins' outputs are equal in each, and the
    port's equal JAX's within the float tolerances of
    ``tests/test_torch_six.py``."""
    tcli.main(["six", "--input", str(src), "--output", str(tmp_path / "port"),
               "--device", "cpu"])
    jcli.main(["six", "--input", str(src), "--output", str(tmp_path / "jax")])
    with open(tmp_path / "port" / "processing_log.csv", newline="") as log:
        rows = list(csv.DictReader(log))
    assert sorted({r["filename"] for r in rows}) == [f, g]
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
