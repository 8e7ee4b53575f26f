"""The port's TIFF codecs beyond the byte-oriented ones: CCITT RLE, RLEW,
Group 3 (1-D and 2-D) and Group 4 (``utils/fax3.py``), SGILog's LogL
and LogLuv and SGILog24 (``utils/sgilog.py``) and 4-bit ThunderScan
(``utils/tiff._thunder_decode``).  Each file is built by
``tests/torch_tiff.py``'s coders (or written by PIL over libtiff and by
the system's libtiff through ``ctypes``, independent of those coders)
and read by the port in both modes: bit-equal and dtype-equal to
``cv2.imread`` in ``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``; through
``imread_unit`` and ``imread_u8`` equal to JAX's ``imread_unit`` and
``train/data._imread_rgb`` (LogL's signed bytes, on which JAX's
``cvtColor`` raises, named by ``read_image``).  Streams cut short or
corrupted read as cv2 reads them; the variants cv2 refuses give ``(None,
None)`` and are logged "unreadable"."""

import ctypes
import ctypes.util
import inspect
import io

import cv2
import numpy as np
import pytest

from tests import torch_tiff as T
from tests.test_torch_tiff_variants import assert_refused_as_cv2
from underwater_image_enhancement_tpu.train import data as jdata
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch.utils import fax3, sgilog
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import jpeg as tjpeg
from underwater_image_enhancement_tpu_torch.utils import tiff as ttiff

H, W = 37, 53
CODECS = {"rle": (2, 0), "rlew": (32771, 0), "g3-1d": (3, 0),
          "g3-2d": (3, 1), "g3-2d-fill": (3, 5), "g3-1d-fill": (3, 4),
          "g4": (4, 0)}


def _raw_as_rgb(img):
    if img.ndim == 2:
        return img[..., None]
    return np.concatenate([img[..., 2::-1], img[..., 3:]], -1)


def assert_as_cv2(tmp_path, data, name="c.tif", jax=True):
    """``decode_tiff`` in both modes equals ``cv2.imread``'s array, dtype,
    shape and bits (NaN payloads too); with ``jax``, ``imread_unit`` and
    ``imread_u8`` equal JAX's readers, or, where JAX's ``cvtColor``
    raises, the port's ``read_image`` names the file."""
    path = tmp_path / name
    path.write_bytes(data)
    for color, flag in ((False, cv2.IMREAD_UNCHANGED),
                        (True, cv2.IMREAD_COLOR)):
        want = cv2.imread(str(path), flag)
        assert want is not None, ("cv2 refuses the file", color)
        want = _raw_as_rgb(want)
        got = ttiff.decode_tiff(data, color)
        assert got.dtype == want.dtype and got.shape == want.shape, (
            color, got.dtype, got.shape, want.dtype, want.shape)
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
    if not jax:
        return
    _, why = tio.read_image(str(path))
    if why is not None:
        assert why.startswith("signed 8-bit TIFF"), why
        with pytest.raises(cv2.error):
            jio.imread_unit(str(path))
    else:
        a, b = tio.imread_unit(str(path)), jio.imread_unit(str(path))
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    a, b = tio.imread_u8(str(path)), jdata._imread_rgb(str(path))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _bits(h, w, seed, p=None):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < (rng.random() if p is None else p)).astype(
        np.uint8)


def _fax(bits, name, photometric=0, **kw):
    """A CCITT TIFF of ``bits`` (1 black) coded by ``CODECS[name]``."""
    compression, options = CODECS[name]
    coder_kw = {k: kw.pop(k) for k in ("first_eol", "rtc", "two_d_first",
                                        "align", "k", "used") if k in kw}
    tags = kw.pop("tags", {})
    if compression == 3:
        tags = {292: (4, [options]), **tags}
    return T.tiff([bits], compression=compression, bits=1,
                  photometric=photometric,
                  coder=lambda blk: T.ccitt(blk, compression, options,
                                            **coder_kw),
                  tags=tags, **kw)


# ---------------------------------------------------------------------------
# CCITT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CODECS))
def test_ccitt_every_run_length(tmp_path, name):
    """Rows of 2561 pixels, row k a white run of k and a black run of 2561
    - k: every terminating and make-up code of both colours, the shared
    make-ups to 2560 and a run past 2560 (2560 + 1); against cv2 only
    (the JAX readers' float copies of 6.6 million pixels are left to the
    smaller files)."""
    n = 2561
    k = np.arange(n + 1)[:, None]
    bits = (np.arange(n)[None, :] >= k).astype(np.uint8)
    data = _fax(bits, name, rows_per_strip=512)
    np.testing.assert_array_equal(ttiff.decode_tiff(data)[..., 0],
                                  np.where(bits, 0, 255))
    assert_as_cv2(tmp_path, data, jax=False)


def _mode_rows(seed):
    """Rows whose edges move by -3..3 from the row above, now and then
    with a new feature or one dropped: every 2-D mode."""
    rng = np.random.default_rng(seed)
    rows = [_bits(1, 120, seed)[0]]
    for _ in range(63):
        edges = T._changes(rows[-1])
        edges = np.clip(edges + rng.integers(-3, 4, len(edges)), 0, 119)
        row = np.zeros(120, np.uint8)
        for a, b in zip(edges[::2], list(edges[1::2]) + [120]):
            row[a:b] = 1
        if rng.random() < 0.3:
            a = int(rng.integers(0, 110))
            row[a:a + int(rng.integers(1, 10))] ^= 1
        rows.append(row)
    return np.stack(rows)


@pytest.mark.parametrize("name", ["g3-2d", "g3-2d-fill", "g4"])
def test_ccitt_every_2d_mode(tmp_path, name):
    used = set()
    bits = _mode_rows(3)
    data = _fax(bits, name, used=used, rows_per_strip=64)
    assert used == set(fax3.MODES) - {"extension"}, used
    np.testing.assert_array_equal(ttiff.decode_tiff(data)[..., 0] == 0,
                                  bits.astype(bool))
    assert_as_cv2(tmp_path, data)


@pytest.mark.parametrize("width", [1, 7, 8, 9, 1728])
@pytest.mark.parametrize("name", sorted(CODECS))
def test_ccitt_widths(tmp_path, name, width):
    bits = _bits(H if width < 1728 else 5, width, width)
    data = _fax(bits, name, rows_per_strip=5)
    np.testing.assert_array_equal(ttiff.decode_tiff(data)[..., 0] == 0,
                                  bits.astype(bool))
    assert_as_cv2(tmp_path, data)


@pytest.mark.parametrize("layout", ["strips-1", "strips-7", "one-strip",
                                    "tiles", "fill-order-2", "big-endian",
                                    "photometric-1"])
@pytest.mark.parametrize("name", sorted(CODECS))
def test_ccitt_layouts(tmp_path, name, layout):
    """Several strips, one, 16x16 tiles cut at the image's edges, fill
    order 2 (libtiff reverses a fax chunk's bits itself), a big-endian
    file, and MinIsBlack (the same bits, gray reversed)."""
    kw = {"strips-1": dict(rows_per_strip=1),
          "strips-7": dict(rows_per_strip=7), "one-strip": {},
          "tiles": dict(tile=(16, 16)),
          "fill-order-2": dict(rows_per_strip=9, fill_order=2),
          "big-endian": dict(order=">", rows_per_strip=9),
          "photometric-1": dict(photometric=1, rows_per_strip=9)}[layout]
    assert_as_cv2(tmp_path, _fax(_bits(H, W, 5), name, **kw))


@pytest.mark.parametrize("variant", ["no first EOL", "no RTC", "no EOLs",
                                     "2-D row first", "uncompressed option",
                                     "k 1"])
def test_ccitt_group3_variants(tmp_path, variant):
    """A Group 3 stream that starts without an EOL (libtiff skips to the
    first), ends without its RTC, has no EOL at all (libtiff from 4.6
    reads it again from the strip's start without EOLs), starts with a
    2-D row (against an all-white reference), sets T4Options' uncompressed
    bit (read as usual), or codes every row 1-D in 2-D mode."""
    bits = _bits(H, W, 6)
    if variant == "no EOLs":
        data = T.tiff([bits], compression=3, bits=1, photometric=0,
                      rows_per_strip=9, coder=lambda blk: T._bytes("".join(
                          T.mh_row(r) for r in blk[..., 0])))
    elif variant == "uncompressed option":
        data = _fax(bits, "g3-2d", rows_per_strip=9,
                    tags={292: (4, [3])})
    else:
        kw = {"no first EOL": dict(first_eol=False),
              "no RTC": dict(rtc=False), "2-D row first":
              dict(two_d_first=True), "k 1": dict(k=1)}[variant]
        data = _fax(bits, "g3-2d", rows_per_strip=9, **kw)
    assert_as_cv2(tmp_path, data)


def _corrupt(data: bytes, rng) -> bytes:
    c = bytearray(data)
    for _ in range(int(rng.integers(1, 3))):
        kind = rng.integers(4)
        if kind == 0 and len(c) > 1:
            c = c[:rng.integers(1, len(c))]
        elif kind == 1 and len(c):
            i = rng.integers(len(c))
            c[i] ^= 1 << int(rng.integers(8))
        elif kind == 2:
            i = rng.integers(len(c) + 1)
            c[i:i] = rng.integers(0, 256, rng.integers(1, 4)).astype(
                np.uint8).tobytes()
        elif len(c):
            i = rng.integers(len(c))
            c[i:i + rng.integers(1, 4)] = b""
    return bytes(c) or b"\0"


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", sorted(CODECS))
def test_ccitt_cut_and_corrupt_streams(tmp_path, name, seed):
    """Each strip cut short, bits flipped, bytes inserted or dropped:
    premature EOLs and EOFs, bad code words, rows too long, a lost EOL
    (the rest read without EOLs), RLEW rows out of their alignment."""
    rng = np.random.default_rng(100 + seed)
    compression, options = CODECS[name]
    bits = _bits(H, W, seed)
    data = T.tiff([bits], compression=compression, bits=1, photometric=0,
                  rows_per_strip=int(rng.integers(4, H)),
                  coder=lambda blk: _corrupt(T.ccitt(
                      blk, compression, options), rng),
                  tags={292: (4, [options])} if compression == 3 else None)
    assert_as_cv2(tmp_path, data)


def test_ccitt_rlew_as_libtiff_writes_it(tmp_path):
    """RLEW rows padded to 16 bits from the strip's start, as libtiff's
    writer pads them: its reader, which aligns the bits it holds, misreads
    some rows, and the port with it."""
    bits = _bits(H, W, 9)
    data = _fax(bits, "rlew", align="writer", rows_per_strip=H)
    assert not np.array_equal(ttiff.decode_tiff(data)[..., 0] == 0,
                              bits.astype(bool))
    assert_as_cv2(tmp_path, data)


@pytest.mark.parametrize("compression", ["group3", "group4", "tiff_ccitt",
                                         "tiff_raw_16"])
@pytest.mark.parametrize("shape", [(H, W), (120, 160), (3, 1728)])
def test_ccitt_written_by_pil_libtiff(tmp_path, compression, shape):
    """Files of PIL over libtiff, a writer independent of the tests'
    coders (its RLEW rows misread as libtiff's writer pads them)."""
    pil = pytest.importorskip("PIL.Image")
    features = pytest.importorskip("PIL.features")
    if not features.check("libtiff"):
        pytest.skip("PIL without libtiff")
    bits = _bits(*shape, 7).astype(bool)
    buf = io.BytesIO()
    pil.fromarray(~bits).save(buf, "TIFF", compression=compression)
    assert_as_cv2(tmp_path, buf.getvalue())


def test_ccitt_decodes_to_its_bits_in_both_photometrics():
    bits = _bits(H, W, 8)
    for name in CODECS:
        for ph, black in ((0, 0), (1, 255)):
            got = ttiff.decode_tiff(_fax(bits, name, photometric=ph,
                                         rows_per_strip=8))
            np.testing.assert_array_equal(got[..., 0] == black,
                                          bits.astype(bool))


REFUSED_CCITT = {
    "8-bit samples": lambda b: T.tiff([b * 200], compression=4,
                                      coder=lambda blk: T.ccitt(blk, 4)),
    "two samples chunky": lambda b: T.tiff(
        [np.stack([b, b], -1)], compression=4, bits=1,
        coder=lambda blk: T.ccitt(blk[..., :1], 4)),
    "two samples planar": lambda b: T.tiff(
        [np.stack([b, b], -1)], compression=3, bits=1, planar=2,
        coder=lambda blk: T.ccitt(blk, 3)),
    "rgb of one sample": lambda b: T.tiff(
        [b], compression=2, bits=1, photometric=2,
        coder=lambda blk: T.ccitt(blk, 2)),
    "empty strip": lambda b: T.tiff([b], compression=4, bits=1,
                                    coder=lambda blk: b""),
    "16-bit samples": lambda b: T.tiff([b.astype(np.uint16)], compression=3,
                                       coder=lambda blk: T.ccitt(blk, 3)),
}


@pytest.mark.parametrize("name", sorted(REFUSED_CCITT))
def test_ccitt_variants_cv2_refuses(tmp_path, name):
    assert_refused_as_cv2(tmp_path, REFUSED_CCITT[name](_bits(H, W, 10)))


# ---------------------------------------------------------------------------
# SGILog
# ---------------------------------------------------------------------------

SW = 160  # rows of 160 pixels, 104 of them hold 16384 codes


def _grid(codes: np.ndarray) -> np.ndarray:
    rows = -(-len(codes) // SW)
    out = np.zeros(rows * SW, codes.dtype)
    out[:len(codes)] = codes
    return out.reshape(rows, SW)


def _sgilog(codes, photometric, compression=34676, min_run=4, **kw):
    return T.tiff([T.sgilog_page(codes, photometric)],
                  compression=compression, photometric=photometric,
                  coder=T.sgilog_coder(photometric, compression, min_run),
                  **kw)


@pytest.mark.parametrize("quarter", range(4))
def test_logl_every_code(tmp_path, quarter):
    """Every 16-bit LogL code (both signs, zero), a quarter a file:
    ``L16toGry``'s bytes, int8 in IMREAD_UNCHANGED."""
    codes = np.arange(quarter << 14, (quarter + 1) << 14).astype(np.uint16)
    assert_as_cv2(tmp_path, _sgilog(_grid(codes), 32844, rows_per_strip=8))


@pytest.mark.parametrize("quarter", range(4))
def test_logluv32_every_luminance(tmp_path, quarter):
    """Every 16-bit luminance of LogLuv (u, v fixed): C's ``exp`` of each
    as the floats of IMREAD_UNCHANGED, ``XYZtoRGB24`` in IMREAD_COLOR."""
    lum = np.arange(quarter << 14, (quarter + 1) << 14).astype(np.uint32)
    codes = (lum << 16) | (97 << 8) | 182
    assert_as_cv2(tmp_path, _sgilog(_grid(codes), 32845, rows_per_strip=16))


@pytest.mark.parametrize("quarter", range(4))
def test_logluv32_every_uv_byte(tmp_path, quarter):
    uv = np.arange(quarter << 14, (quarter + 1) << 14).astype(np.uint32)
    codes = (np.uint32(0x3E80) << 16) | uv
    assert_as_cv2(tmp_path, _sgilog(_grid(codes), 32845, rows_per_strip=16))


@pytest.mark.parametrize("level", [1, 300, 640, 1023])
def test_logluv24_every_uv_code(tmp_path, level):
    """Every 14-bit (u, v) code at a luminance: the 16289 squares of
    ``uv_row`` and the 95 invalid codes past them (the neutral point)."""
    codes = (np.uint32(level) << 14) | np.arange(16384, dtype=np.uint32)
    assert_as_cv2(tmp_path, _sgilog(_grid(codes), 32845, 34677,
                                    rows_per_strip=16))


def test_logluv24_every_luminance(tmp_path):
    codes = (np.arange(1024, dtype=np.uint32) << 14) | 9000
    assert_as_cv2(tmp_path, _sgilog(_grid(codes), 32845, 34677))


def test_uv_table_is_libtiffs_shape():
    """``uv_row``'s 163 rows cover 16289 codes; each row's squares sit
    left to right from its ``ustart``; ``uv_decode`` of the first and last
    codes, and of the first invalid one."""
    assert len(sgilog._USTART) == len(sgilog._NUS) == 163
    assert sum(sgilog._NUS) == 16289
    uv = sgilog._uv_codes()
    np.testing.assert_array_equal(uv[16289:], [[sgilog._U_NEU,
                                                sgilog._V_NEU]] * 95)
    assert uv[0, 0] == float(np.float32(0.247663)) + 0.5 * float(
        np.float32(0.0035))


def _planes_stream(planes_per_row, rows):
    """Bytes of hand-made SGILog codes: a run of 129 that crosses the
    row's end, a literal that crosses into the next plane, a nul, a run
    of 2."""
    return bytes([255, 7, 3, 1, 2, 3, 0, 128, 9, 10, 5, 6, 7, 8, 9, 10, 11,
                  12, 13, 14]) * (planes_per_row * rows)


@pytest.mark.parametrize("photometric", [32844, 32845])
@pytest.mark.parametrize("width", [3, 10, 130])
def test_sgilog_runs_and_literals_cross_rows_and_planes(tmp_path,
                                                        photometric, width):
    """Runs and literals past a plane's end are cut there and their rest
    read as the next plane's codes, or the next row's."""
    planes = 2 if photometric == 32844 else 4
    data = T.tiff([np.zeros((5, width) + (() if photometric == 32844
                                          else (3,)), np.int16)],
                  compression=34676, photometric=photometric,
                  coder=lambda blk: _planes_stream(planes, 5))
    assert_as_cv2(tmp_path, data)


def _luv_images(seed):
    rng = np.random.default_rng(seed)
    xyz = rng.random((H, W, 3)) * rng.choice([0.01, 1, 40], (H, W, 1))
    xyz[0, :5] = 0
    return xyz


@pytest.mark.parametrize("layout", ["strips-1", "strips-7", "tiles",
                                    "fill-order-2", "big-endian",
                                    "orientation-2", "orientation-3",
                                    "orientation-4", "min-run-2"])
@pytest.mark.parametrize("kind", ["logl", "logluv", "logluv24"])
def test_sgilog_layouts(tmp_path, kind, layout):
    """LogL, LogLuv and SGILog24 of seeded X, Y, Z in strips, 16x16 tiles
    cut at the edges (the float path reads tiles too), fill order 2, a
    big-endian file, orientations 2-4 (cv2 flips the whole image of
    floats before it converts them; the RGBA reader flips each column of
    tiles), runs of two."""
    ph, comp = {"logl": (32844, 34676), "logluv": (32845, 34676),
                "logluv24": (32845, 34677)}[kind]
    codes = T.sgilog_codes(_luv_images(11), comp, ph)
    kw = {"strips-1": dict(rows_per_strip=1),
          "strips-7": dict(rows_per_strip=7), "tiles": dict(tile=(16, 16)),
          "fill-order-2": dict(rows_per_strip=9, fill_order=2),
          "big-endian": dict(order=">", rows_per_strip=9),
          "orientation-2": dict(tags={274: (3, [2])}, rows_per_strip=9),
          "orientation-3": dict(tags={274: (3, [3])}, tile=(16, 16)),
          "orientation-4": dict(tags={274: (3, [4])}, tile=(32, 16)),
          "min-run-2": dict(rows_per_strip=9, min_run=2)}[layout]
    assert_as_cv2(tmp_path, _sgilog(codes, ph, comp, **kw))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["logl", "logluv", "logluv24"])
def test_sgilog_cut_and_corrupt_streams(tmp_path, kind, seed):
    """Strips cut short or corrupted: through the RGBA reader the rows
    from the first that fails stay 0; cv2's own float reading of LogLuv
    refuses a strip that fails."""
    rng = np.random.default_rng(200 + seed)
    ph, comp = {"logl": (32844, 34676), "logluv": (32845, 34676),
                "logluv24": (32845, 34677)}[kind]
    codes = T.sgilog_codes(_luv_images(seed), comp, ph)
    coder = T.sgilog_coder(ph, comp)
    data = T.tiff([T.sgilog_page(codes, ph)], compression=comp,
                  photometric=ph, rows_per_strip=int(rng.integers(4, H)),
                  coder=lambda blk: _corrupt(coder(blk), rng))
    path = tmp_path / "c.tif"
    path.write_bytes(data)
    if cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None:
        # the float path refuses the file; the RGBA reader reads it
        with pytest.raises(ValueError):
            ttiff.decode_tiff(data)
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(ttiff.decode_tiff(data, True),
                                      want[..., ::-1])
        np.testing.assert_array_equal(tio.imread_u8(str(path)),
                                      jdata._imread_rgb(str(path)))
        assert tio.imread_unit(str(path)) is None
        assert jio.imread_unit(str(path)) is None
    else:
        assert_as_cv2(tmp_path, data)


def test_sgilog_samples_cv2_takes_for_logluv(tmp_path):
    """OpenCV takes LogLuv before it looks at the samples' size or
    format: 8-bit unsigned samples read as the 16-bit signed ones libtiff
    writes."""
    codes = T.sgilog_codes(_luv_images(12), 34676, 32845)
    page = T.sgilog_page(codes, 32845)
    data = T.tiff([page], compression=34676, photometric=32845,
                  coder=T.sgilog_coder(32845),
                  tags={258: (3, [8] * 3), 339: (3, [1] * 3)})
    assert_as_cv2(tmp_path, data)


def _libtiff():
    name = ctypes.util.find_library("tiff")
    if name is None:
        pytest.skip("no system libtiff")
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        pytest.skip("the system's libtiff does not load")
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFSetField.restype = ctypes.c_int
    lib.TIFFWriteScanline.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_uint32, ctypes.c_uint16]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("compression,photometric", [
    (34676, 32844), (34676, 32845), (34677, 32845)])
def test_sgilog_written_by_system_libtiff(tmp_path, compression,
                                          photometric):
    """Float X, Y, Z written through the system's libtiff (SGILOGDATAFMT
    float, libtiff's own encoder, no dither for SGILog and its random
    dither for SGILog24), a writer independent of the tests' coders."""
    lib = _libtiff()
    xyz = _luv_images(13).astype(np.float32)
    n = 1 if photometric == 32844 else 3
    path = tmp_path / "w.tif"
    tif = ctypes.c_void_p(lib.TIFFOpen(str(path).encode(), b"w"))
    assert tif.value
    for tag, value in ((256, W), (257, H), (277, n), (259, compression),
                       (262, photometric), (284, 1), (278, 8),
                       (65560, 0)):  # SGILOGDATAFMT_FLOAT
        assert lib.TIFFSetField(tif, ctypes.c_uint32(tag),
                                ctypes.c_int(value)), tag
    rows = np.ascontiguousarray(xyz[..., 1:2] if n == 1 else xyz)
    for y in range(H):
        row = np.ascontiguousarray(rows[y])
        assert lib.TIFFWriteScanline(tif, row.ctypes.data, y, 0) == 1
    lib.TIFFClose(tif)
    assert_as_cv2(tmp_path, path.read_bytes(), "w2.tif")


def _l16(h=6, w=10):
    return np.random.default_rng(14).integers(0x3000, 0x4400, (h, w)).astype(
        np.uint16)


def _c32(h=6, w=10):
    return (_l16(h, w).astype(np.uint32) << 16) | (90 << 8) | 180


REFUSED_SGILOG = {
    "logl in sgilog24": lambda: T.tiff(
        [T.sgilog_page(_l16(), 32844)], compression=34677, photometric=32844,
        coder=lambda blk: T.sgilog_coder(32845, 34677)(np.repeat(blk, 3, -1))),
    "logl of 3 samples": lambda: _sgilog(_c32(), 32845, tags={262: (3, [
        32844])}),
    "logluv of 1 sample": lambda: T.tiff(
        [T.sgilog_page(_l16(), 32844)], compression=34676, photometric=32845,
        coder=T.sgilog_coder(32844)),
    "logluv of 4 samples": lambda: T.tiff(
        [np.concatenate([T.sgilog_page(_c32(), 32845),
                         np.zeros((6, 10, 1), np.int16)], -1)],
        compression=34676, photometric=32845,
        coder=lambda blk: T.sgilog_coder(32845)(blk[..., :3])),
    "planar logluv": lambda: T.tiff(
        [T.sgilog_page(_c32(), 32845)], compression=34676, photometric=32845,
        planar=2, coder=T.sgilog_coder(32844)),
    "sgilog gray": lambda: T.tiff(
        [T.sgilog_page(_l16(), 32844)], compression=34676, photometric=1,
        coder=T.sgilog_coder(32844)),
    "sgilog rgb": lambda: _sgilog(_c32(), 32845, tags={262: (3, [2])}),
    "logl in lzw": lambda: T.tiff([T.sgilog_page(_l16(), 32844)],
                                  compression=5, photometric=32844),
    "logl of 4-bit samples": lambda: _sgilog(_l16(), 32844, tags={
        258: (3, [4])}),
    "logluv orientation 6": lambda: _sgilog(_c32(), 32845, tags={
        274: (3, [6])}),
    "logl empty strip": lambda: T.tiff(
        [T.sgilog_page(_l16(), 32844)], compression=34676,
        photometric=32844, coder=lambda blk: b""),
}


@pytest.mark.parametrize("name", sorted(REFUSED_SGILOG))
def test_sgilog_variants_cv2_refuses(tmp_path, name):
    assert_refused_as_cv2(tmp_path, REFUSED_SGILOG[name]())


@pytest.mark.parametrize("what", ["float samples", "extra sample",
                                  "12-bit samples"])
def test_logluv_color_refused_where_unchanged_reads(tmp_path, what):
    """cv2 reads these LogLuv files in IMREAD_UNCHANGED (its own floats)
    and refuses them in IMREAD_COLOR (``TIFFRGBAImageOK``)."""
    tags = {"float samples": {258: (3, [32] * 3), 339: (3, [3] * 3)},
            "extra sample": {338: (3, [0])},
            "12-bit samples": {258: (3, [12] * 3)}}[what]
    data = _sgilog(_c32(), 32845, tags=tags)
    path = tmp_path / "u.tif"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(ttiff.decode_tiff(data), want[..., ::-1])
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError):
        ttiff.decode_tiff(data, True)
    assert tio.imread_u8(str(path)) is None


def test_xyz_to_rgb_is_cv2s_float_conversion():
    """``sgilog.xyz_to_rgb`` equals ``cvtColor(..., COLOR_XYZ2BGR)`` bit
    for bit at every row width's 4-lane split, over signs, magnitudes
    and infinities."""
    rng = np.random.default_rng(15)
    for w in list(range(1, 19)) + [160, 161, 163]:
        x = (rng.random((3, w, 3)) * rng.choice([1e-3, 1, 1e3, -1],
                                                (3, w, 3))).astype(np.float32)
        x[0, 0] = [np.inf, 1, 0]
        want = cv2.cvtColor(x, cv2.COLOR_XYZ2BGR)[..., ::-1]
        np.testing.assert_array_equal(sgilog.xyz_to_rgb(x).view(np.uint32),
                                      want.view(np.uint32))


# ---------------------------------------------------------------------------
# ThunderScan, NeXT
# ---------------------------------------------------------------------------

def _thunder_stream(rng, n):
    kinds = rng.integers(0, 4, n)
    b = rng.integers(0, 64, n) | (kinds << 6)
    b = np.where((kinds == 0) & (rng.random(n) < 0.7), b & 7, b)
    return b.astype(np.uint8).tobytes()


@pytest.mark.parametrize("seed", range(6))
def test_thunderscan_palette(tmp_path, seed):
    """4-bit ThunderScan palette rows of seeded codes (runs, 2- and 3-bit
    deltas, raw pixels): rows that end early or run past their width
    zeroed from there, the strip ending with them."""
    rng = np.random.default_rng(300 + seed)
    h, w = int(rng.integers(1, 12)), int(rng.integers(1, 40))
    cmap = (np.arange(48) * 1361 % 65536).tolist()
    data = T.tiff([np.zeros((h, w), np.uint8)], compression=32809, bits=4,
                  photometric=3, rows_per_strip=int(rng.integers(1, h + 1)),
                  coder=lambda blk: _thunder_stream(
                      rng, int(rng.integers(1, 3 * w * blk.shape[0] + 4))),
                  tags={320: (3, cmap)})
    assert_as_cv2(tmp_path, data)


@pytest.mark.parametrize("shape,tile", [((20, 40), (16, 16)),
                                        ((16, 16), (16, 16)),
                                        ((33, 64), (32, 16))])
def test_thunderscan_tiles_read_as_zeros(tmp_path, shape, tile):
    """libtiff has no ThunderScan tile decoder: every tile reads as the
    RGBA reader's zeroed buffer, the colormap's first colour."""
    rng = np.random.default_rng(310)
    cmap = (np.arange(48) * 1361 % 65536).tolist()
    data = T.tiff([np.zeros(shape, np.uint8)], compression=32809, bits=4,
                  photometric=3, tile=tile, tags={320: (3, cmap)},
                  coder=lambda blk: _thunder_stream(rng, 3 * blk.size))
    assert_as_cv2(tmp_path, data)


@pytest.mark.parametrize("orientation", [2, 3, 4])
@pytest.mark.parametrize("tiled", [False, True])
def test_ccitt_orientation(tmp_path, orientation, tiled):
    kw = dict(tile=(16, 16)) if tiled else dict(rows_per_strip=8)
    assert_as_cv2(tmp_path, _fax(_bits(H, W, 17), "g4",
                                 tags={274: (3, [orientation])}, **kw))


@pytest.mark.parametrize("compression,bits", [(32809, 8), (32809, 1),
                                              (32766, 8), (32766, 1)])
def test_thunderscan_and_next_cv2_refuses(tmp_path, compression, bits):
    img = np.zeros((H, W), np.uint8)
    data = T.tiff([img], compression=compression, bits=bits, photometric=1,
                  coder=lambda blk: b"\xc1" * 64)
    assert_refused_as_cv2(tmp_path, data)


def test_tiff_decoder_names_nothing_unsupported():
    """No TIFF raises ``Unsupported``: the decoder no longer refers to it,
    and every codec above decodes or raises ValueError."""
    assert not hasattr(ttiff, "Unsupported")
    assert "Unsupported(" not in inspect.getsource(ttiff)
    bits = _bits(H, W, 16)
    files = [_fax(bits, name) for name in CODECS] + [
        _sgilog(_c32(), 32845), _sgilog(_l16(), 32844)]
    files += [f(bits) for f in REFUSED_CCITT.values()]
    files += [f() for f in REFUSED_SGILOG.values()]
    for data in files:
        for color in (False, True):
            try:
                ttiff.decode_tiff(data, color)
            except ValueError as e:
                assert not isinstance(e, tjpeg.Unsupported), e
