"""EXIF orientation in the port's reading (``utils/exif.py``) against the
JAX package's: ``train/data._imread_rgb`` (``cv2.imread(path)``,
``IMREAD_COLOR``, which turns the image as the Orientation says) through
``io.imread_u8``, and ``utils/io.imread_unit`` (``IMREAD_UNCHANGED``,
which turns nothing) through ``io.imread_unit``, bit for bit and shape
included.  cv2 5.0.0 is the witness: every file is built here
(``tests/torch_jpeg_scans.py``'s EXIF inserters), at orientations 0-9 in
both byte orders, in baseline and progressive JPEGs and 8- and 16-bit
PNGs, and in the malformed forms whose reading by cv2 these tests pin
(which APP1 counts, the IFD's offset, the tag's type and count, cuts,
entries cv2 reads a value of, eXIf chunks after the image data, twice,
with a CRC error).  The training loader's ``load_pair`` on an oriented
pair against JAX's."""

import struct

import cv2
import numpy as np
import pytest

from tests import torch_jpeg_scans as js
from tests import torch_png
from underwater_image_enhancement_tpu.train import data as jdata
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch.train import data as tdata
from underwater_image_enhancement_tpu_torch.utils import exif
from underwater_image_enhancement_tpu_torch.utils import io as tio


def _rgb(h=20, w=28, seed=0):
    """A frame whose every pixel differs, so that any turn shows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 9, xx * 7, (xx + 2 * yy) * 3], -1)
    return np.clip(base + rng.integers(0, 30, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _jpeg(progressive=False, gray=False):
    img = _rgb()
    params = [cv2.IMWRITE_JPEG_QUALITY, 92]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    ok, buf = cv2.imencode(".jpg", img[..., 0] if gray else img, params)
    assert ok
    return buf.tobytes()


def _png(depth=8):
    img = _rgb()
    if depth == 16:
        img = img.astype(np.uint16) * 257 + np.arange(3, dtype=np.uint16)
    return torch_png.encode(img, depth)


BASES = {"jpeg": lambda: _jpeg(), "progressive": lambda: _jpeg(True),
         "gray_jpeg": lambda: _jpeg(gray=True), "png8": lambda: _png(8),
         "png16": lambda: _png(16)}


def _oriented(kind, tiffs, after_idat=False):
    """The base file of ``kind`` with the EXIF TIFF structures ``tiffs``
    (an APP1 each, or an eXIf chunk each)."""
    data = BASES[kind]()
    if "png" in kind:
        return js.with_png_chunks(
            data, [torch_png.chunk(b"eXIf", t) for t in tiffs], after_idat)
    return js.with_app1(data, *(b"Exif\x00\x00" + t for t in tiffs))


def _assert_reads_as_jax(tmp_path, name, data, turned):
    """imread_u8 equals JAX's training loader, and is the file without its
    EXIF turned by the Orientation ``turned`` (1: not turned); imread_unit
    equals JAX's imread_unit, which turns nothing."""
    path = tmp_path / name
    path.write_bytes(data)
    want = jdata._imread_rgb(str(path))
    got = tio.imread_u8(str(path))
    assert want is not None and got is not None
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, exif.apply(tio.decode_image(_strip(data), color=True), turned))
    np.testing.assert_array_equal(tio.imread_unit(str(path)),
                                  jio.imread_unit(str(path)))


def _strip(data):
    """The file without its EXIF (APP1 segments or eXIf chunks)."""
    if data[:2] == b"\xff\xd8":
        out, p = [data[:2]], 2
        while data[p + 1] != 0xDA:
            (n,) = struct.unpack(">H", data[p + 2:p + 4])
            if data[p + 1] != 0xE1:
                out.append(data[p:p + 2 + n])
            p += 2 + n
        return b"".join(out) + data[p:]
    out, p = [data[:8]], 8
    while p < len(data):
        (n,) = struct.unpack(">I", data[p:p + 4])
        if data[p + 4:p + 8] != b"eXIf":
            out.append(data[p:p + 12 + n])
        p += 12 + n
    return b"".join(out)


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("kind", ["jpeg", "progressive", "png8", "png16"])
def test_orientation_matches_cv2(tmp_path, kind, orientation, order):
    """Orientations 1-8 turn the image as cv2's table says, in both byte
    orders, in baseline and progressive JPEGs and 8- and 16-bit PNGs;
    imread_unit turns nothing."""
    data = _oriented(kind, [js.exif_tiff(orientation, order)])
    ext = ".png" if "png" in kind else ".jpg"
    _assert_reads_as_jax(tmp_path, "o" + ext, data, orientation)
    if orientation >= 5:
        assert tio.imread_u8(str(tmp_path / ("o" + ext))).shape[:2] \
            == (28, 20)


@pytest.mark.parametrize("orientation", [0, 9, 10, 255])
@pytest.mark.parametrize("kind", ["jpeg", "gray_jpeg", "png8"])
def test_other_orientation_values_turn_nothing(tmp_path, kind,
                                               orientation):
    """Values outside 1-8 turn nothing; a gray JPEG turns as a colour
    one does."""
    data = _oriented(kind, [js.exif_tiff(orientation, "MM")])
    _assert_reads_as_jax(tmp_path, "v.png" if "png" in kind else "v.jpg",
                         data, 1)
    if kind == "gray_jpeg":
        turned = _oriented(kind, [js.exif_tiff(6)])
        _assert_reads_as_jax(tmp_path, "g6.jpg", turned, 6)


E = js.exif_tiff


def _entries(*ents, order="II"):
    return E(entries=list(ents), order=order)


def _with(tiff, offset=None, magic=None, prefix=None, count=None):
    """A TIFF structure with its first bytes, magic, IFD offset or entry
    count replaced."""
    b = bytearray(tiff)
    e = "<" if b[:2] == b"II" else ">"
    if prefix is not None:
        b[:2] = prefix
    if magic is not None:
        b[2:4] = magic
    if offset is not None:
        b[4:8] = struct.pack(e + "I", offset)
    if count is not None:
        b[8:10] = struct.pack(e + "H", count)
    return bytes(b)


ORIENT6 = (0x0112, 3, 1, 6)
# name -> (the TIFF structures of a JPEG's APP1 segments, the turn cv2
# applies)
JPEG_CASES = {
    "long II": ([E(entries=[(0x0112, 4, 1, 6)])], 6),
    "long MM": ([E(entries=[(0x0112, 4, 1, 6)], order="MM")], 1),
    "byte MM": ([E(entries=[(0x0112, 1, 1, 6)], order="MM")], 1),
    "count 0": ([E(entries=[(0x0112, 3, 0, 6)])], 6),
    "count 1000": ([E(entries=[(0x0112, 3, 1000, 6)], order="MM")], 6),
    "value 0x106": ([E(0x106)], 1),
    "ifd at 20": ([E(6, ifd=20)], 6),
    "ifd at 0": ([_with(E(6), offset=0)], 1),
    "ifd at 4": ([_with(E(6), offset=4)], 1),
    "ifd past the end": ([_with(E(6), offset=65536)], 1),
    "magic 43": ([_with(E(6), magic=b"\x2b\x00")], 1),
    "order XX read big-endian": ([_with(E(6, order="MM"), prefix=b"XX")], 6),
    "order IM": ([_with(E(6), prefix=b"IM")], 1),
    "no entries": ([_with(E(6), count=0)], 1),
    "entry count past the data": ([_with(E(6), count=0xFFFF)], 6),
    "no next-IFD offset": ([E(6)[:-4]], 6),
    "cut in the value": ([E(6)[:-7]], 1),
    "orientation after an unknown tag": (
        [_entries((0x9000, 7, 4, 0), (0x0100, 4, 1, 5), (0x0112, 3, 1, 5))],
        5),
    "two orientations, the first wins": (
        [_entries((0x0112, 3, 1, 7), (0x0112, 3, 1, 8))], 7),
    "make past the end before": ([_entries((0x010F, 2, 100, 10000),
                                           ORIENT6)], 1),
    "make past the end after": ([_entries(ORIENT6,
                                          (0x010F, 2, 100, 10000))], 6),
    "model past the end before": ([_entries((0x0110, 2, 9, 9000),
                                            ORIENT6)], 1),
    "short make inline": ([_entries((0x010F, 2, 4, 0), ORIENT6)], 6),
    "x resolution past the end": ([_entries((0x011A, 5, 1, 10000),
                                            ORIENT6)], 1),
    "y resolution past the end": ([_entries((0x011B, 5, 1, 10000),
                                            ORIENT6, order="MM")], 1),
    "white point past the end": ([_entries((0x013E, 5, 2, 9999),
                                           ORIENT6)], 1),
    "primaries past the end": ([_entries((0x013F, 5, 6, 9999),
                                         ORIENT6)], 1),
    "copyright past the end": ([_entries((0x8298, 2, 50, 9999),
                                         ORIENT6)], 1),
    "exif ifd pointer past the end": ([_entries((0x8769, 4, 1, 10000),
                                                ORIENT6)], 6),
    "gps ifd pointer past the end": ([_entries((0x8825, 4, 1, 10000),
                                               ORIENT6)], 6),
    "resolution unit": ([_entries((0x0128, 3, 1, 2), ORIENT6)], 6),
    "first segment without orientation": (
        [_entries((0x010F, 2, 4, 0)), E(8)], 8),
    "first segment cut, second read": ([E(6)[:-7], E(8)], 8),
    "first segment's orientation 9": ([E(9), E(6)], 1),
    "first segment's orientation 1": ([E(1), E(6)], 1),
    "two segments 6, 8": ([E(6), E(8)], 6),
}


def _app1_cases():
    """The APP1 cases not of the form b"Exif\\0\\0" + TIFF: (bodies, turn)."""
    return {
        "xmp first": ([b"http://ns.adobe.com/xap/1.0/\x00<x/>",
                       b"Exif\x00\x00" + E(5)], 5),
        "Exif\\0\\1 prefix": ([b"Exif\x00\x01" + E(6)], 1),
        "exif lower-case": ([b"exif\x00\x00" + E(6)], 1),
        "Exif only": ([b"Exif\x00\x00", b"Exif\x00\x00" + E(8)], 8),
    }


@pytest.mark.parametrize("name", sorted(JPEG_CASES) + sorted(_app1_cases()))
def test_malformed_jpeg_exif_matches_cv2(tmp_path, name):
    if name in JPEG_CASES:
        tiffs, turn = JPEG_CASES[name]
        data = _oriented("jpeg", tiffs)
    else:
        bodies, turn = _app1_cases()[name]
        data = js.with_app1(BASES["jpeg"](), *bodies)
    _assert_reads_as_jax(tmp_path, "m.jpg", data, turn)


def test_exif_after_the_first_scan_is_not_read(tmp_path):
    """An APP1 between a progressive file's scans: libjpeg saves it after
    cv2 read the header, so nothing turns."""
    data = BASES["progressive"]()
    p = data.index(b"\xff\xda", data.index(b"\xff\xda") + 2)
    seg = b"\xff\xe1" + struct.pack(">H", 8 + len(E(6))) + b"Exif\x00\x00" \
        + E(6)
    _assert_reads_as_jax(tmp_path, "late.jpg", data[:p] + seg + data[p:], 1)


def _bad_crc(body):
    c = bytearray(torch_png.chunk(b"eXIf", body))
    c[-1] ^= 1
    return bytes(c)


PNG_CASES = {
    "after the image data": (lambda: js.with_png_chunks(
        _png(), [torch_png.chunk(b"eXIf", E(6))], True), 6),
    "two, the first kept": (lambda: _oriented("png8", [E(6), E(8)]), 6),
    "before and after, the first kept": (lambda: js.with_png_chunks(
        _oriented("png8", [E(6)]), [torch_png.chunk(b"eXIf", E(8))], True),
        6),
    "CRC error, then a good one": (lambda: js.with_png_chunks(
        _png(), [_bad_crc(E(6)), torch_png.chunk(b"eXIf", E(8))]), 8),
    "invalid first bytes, then a good one": (lambda: js.with_png_chunks(
        _png(), [torch_png.chunk(b"eXIf", _with(E(6), prefix=b"IM")),
                 torch_png.chunk(b"eXIf", E(8))]), 8),
    "too short, then a good one": (lambda: js.with_png_chunks(
        _png(), [torch_png.chunk(b"eXIf", b"I"),
                 torch_png.chunk(b"eXIf", E(3))]), 3),
    "cut first, the second a duplicate": (
        lambda: _oriented("png8", [E(6)[:-10], E(6)]), 1),
    "orientation 9, then 6": (lambda: _oriented("png8", [E(9), E(6)]), 1),
    "Exif prefix": (lambda: js.with_png_chunks(
        _png(), [torch_png.chunk(b"eXIf", b"Exif\x00\x00" + E(6))]), 1),
    "long MM": (lambda: _oriented("png16", [E(entries=[(0x0112, 4, 1, 6)],
                                              order="MM")]), 1),
    "ifd at 20": (lambda: _oriented("png16", [E(7, ifd=20)]), 7),
}


@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_malformed_png_exif_matches_cv2(tmp_path, name):
    build, turn = PNG_CASES[name]
    _assert_reads_as_jax(tmp_path, "m.png", build(), turn)


def test_load_pair_turns_as_jax(tmp_path):
    """``PairedImageDataset.load_pair`` on a raw JPEG of orientation 6 and
    its reference PNG of orientation 8 (non-square, so that the turn
    shows through the resize) equals JAX's, with and without the
    augmenting flips; and equals its load of the pair turned by hand."""
    raw, ref = tmp_path / "raw", tmp_path / "ref"
    plain_raw, plain_ref = tmp_path / "plain_raw", tmp_path / "plain_ref"
    for d in (raw, ref, plain_raw, plain_ref):
        d.mkdir()
    raw_img, ref_img = _rgb(24, 40, 1), _rgb(24, 40, 2)
    jpg = js.with_app1(tio.encode_jpeg(raw_img), b"Exif\x00\x00" + E(6))
    (raw / "a.jpg").write_bytes(jpg)
    (ref / "a.jpg").write_bytes(js.with_png_chunks(
        tio.encode_png(ref_img), [torch_png.chunk(b"eXIf", E(8, "MM"))]))
    (plain_raw / "a.png").write_bytes(tio.encode_png(
        exif.apply(tio.decode_image(tio.encode_jpeg(raw_img), True), 6)))
    (plain_ref / "a.png").write_bytes(tio.encode_png(exif.apply(ref_img,
                                                                8)))
    for augment in (False, True):
        got = tdata.PairedImageDataset(str(raw), str(ref), 32, augment,
                                       seed=3).load_pair(0)
        want = jdata.PairedImageDataset(str(raw), str(ref), 32, augment,
                                        seed=3).load_pair(0)
        plain = tdata.PairedImageDataset(str(plain_raw), str(plain_ref), 32,
                                         augment, seed=3).load_pair(0)
        for g, w, p in zip(got, want, plain):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)
