"""The port's netpbm and PFM readers (``utils/pxm.py``) against cv2 5.0.0.

Each file is built here (``tests/torch_formats.py``, 64x96 or smaller)
and read by the port in both modes: bit-equal to ``cv2.imread`` in
``IMREAD_UNCHANGED`` and ``IMREAD_COLOR`` (dtype, shape, NaN and the sign
of zero included), and through ``imread_unit`` and ``imread_u8`` to
JAX's ``imread_unit`` and ``train/data._imread_rgb``.  Where JAX's
channel handling raises on what cv2 gives (a two-channel PAM) the port
names the file.  The files cv2 refuses are "unreadable", and so is a
gray PFM in ``IMREAD_COLOR``, which ``cv2.imread`` refuses (the writers
are in ``tests/test_torch_write.py``).  The divergence on purpose: cv2's
``IMREAD_COLOR`` converts only the first ``ceil(W / DEPTH)`` pixels of a
two- or four-channel PAM row; the port converts them all."""

import cv2
import numpy as np
import pytest

from tests import torch_formats as F
from underwater_image_enhancement_tpu.train import data as jdata
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import pxm

H, W = 37, 53
_RNG = np.random.default_rng(24)
RGB = _RNG.integers(0, 256, (H, W, 3), np.uint8)
V16 = _RNG.integers(0, 65536, (H, W, 3))
FLOATS = _RNG.normal(100, 120, (H, W, 3)).astype(np.float32)


def as_cv2(img: np.ndarray) -> np.ndarray:
    """The port's array in cv2's channel order: RGB(A) to BGR(A)."""
    if img.ndim == 3 and img.shape[2] >= 3:
        return np.concatenate([img[..., 2::-1], img[..., 3:]], -1)
    return img


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def assert_reads_as_cv2(tmp_path, data, decode, suffix=".img"):
    """``decode`` in both modes equals ``cv2.imread`` of the file; the
    port's ``imread_unit``/``imread_u8`` equal JAX's."""
    path = tmp_path / f"v{suffix}"
    path.write_bytes(data)
    for color, flag in ((False, cv2.IMREAD_UNCHANGED),
                        (True, cv2.IMREAD_COLOR)):
        want = cv2.imread(str(path), flag)
        assert want is not None, "cv2 refuses the file"
        assert_same(as_cv2(decode(data, color)), want)
    assert_same(tio.imread_unit(str(path)), jio.imread_unit(str(path)))
    assert_same(tio.imread_u8(str(path)), jdata._imread_rgb(str(path)))


def assert_refused(tmp_path, data, decode, suffix=".img"):
    """cv2 gives None (or raises, for a size it refuses) in both modes; the
    port raises ValueError and logs the file "unreadable"."""
    path = tmp_path / f"v{suffix}"
    path.write_bytes(data)
    for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        try:
            assert cv2.imread(str(path), flag) is None
        except cv2.error as e:
            assert "validateInputImageSize" in str(e)
    for color in (False, True):
        with pytest.raises(ValueError):
            decode(data, color)
        assert tio.read_image(str(path), color) == (None, None)
    logged = []
    assert list(tio.decode_iter([path], log=logged.append)) == []
    assert logged == [f"warning: unreadable {path.name}"]


GRAY = RGB[..., 1]
PNM = {
    "P1 spaced": lambda: F.pnm(1, GRAY > 127),
    "P1 packed digits": lambda: F.pnm(1, GRAY > 127, sep=b""),
    "P1 digits past 1 are set": lambda: F.pnm(1, GRAY % 3),
    "P2 maxval 255": lambda: F.pnm(2, GRAY),
    "P2 maxval 100 scales": lambda: F.pnm(2, GRAY % 101, 100),
    "P2 maxval 1000 is 16-bit": lambda: F.pnm(2, V16[..., 0] % 1001, 1000),
    "P2 samples past maxval clip": lambda: F.pnm(2, GRAY, 200),
    "P2 tabs and newlines": lambda: F.pnm(2, GRAY, sep=b"\t\n "),
    "P2 comments": lambda: F.pnm(2, GRAY, head=b"P%d\n# a\n%d # b\n%d\n#c\n%s"),
    "P3": lambda: F.pnm(3, RGB),
    "P3 16-bit": lambda: F.pnm(3, V16, 65535),
    "P4": lambda: F.pnm(4, GRAY > 127),
    "P4 width 8": lambda: F.pnm(4, (GRAY > 127)[:, :8]),
    "P4 width 9": lambda: F.pnm(4, (GRAY > 127)[:, :9]),
    "P5": lambda: F.pnm(5, GRAY),
    "P5 maxval 100 taken as is": lambda: F.pnm(5, GRAY, 100),
    "P5 maxval 1000": lambda: F.pnm(5, V16[..., 0] % 1001, 1000),
    "P5 CRLF header": lambda: F.pnm(5, GRAY, head=b"P%d\r\n%d %d\r\n%s"),
    "P5 samples from the byte after maxval": lambda: (
        b"P5\n%d %d\n255#c\n" % (W, H) + GRAY.tobytes()),
    "P6": lambda: F.pnm(6, RGB),
    "P6 16-bit": lambda: F.pnm(6, V16, 65535),
    "P6 maxval 300": lambda: F.pnm(6, V16 % 301, 300),
    "P6 trailing bytes": lambda: F.pnm(6, RGB) + b"junk",
}


@pytest.mark.parametrize("name", sorted(PNM))
def test_pnm_reads_as_cv2(tmp_path, name):
    assert_reads_as_cv2(tmp_path, PNM[name](), pxm.decode_pnm, ".pnm")


PNM_REFUSED = {
    "P0": lambda: b"P0\n3 2\n" + bytes(6),
    "a letter in the header": lambda: b"P5\n3 x2\n255\n" + bytes(6),
    "a sign in the header": lambda: b"P5\n+3 2\n255\n" + bytes(6),
    "maxval 0": lambda: b"P5\n3 2\n0\n" + bytes(6),
    "maxval 65536": lambda: b"P5\n3 2\n65536\n" + bytes(12),
    "width 0": lambda: b"P5\n0 2\n255\n",
    "binary cut short": lambda: F.pnm(6, RGB)[:-1],
    "ASCII cut short": lambda: F.pnm(2, GRAY)[:-6],
    "no byte after the last sample": lambda: F.pnm(2, GRAY)[:-1],
    "a letter among the samples": lambda: F.pnm(2, GRAY)[:-4] + b"x 1\n",
}


@pytest.mark.parametrize("name", sorted(PNM_REFUSED))
def test_pnm_cv2_refuses_is_unreadable(tmp_path, name):
    assert_refused(tmp_path, PNM_REFUSED[name](), pxm.decode_pnm, ".pnm")


def _ga():
    return np.stack([GRAY, RGB[..., 2]], -1)


PAM = {
    "RGB": lambda: F.pam(RGB),
    "RGB tupltype": lambda: F.pam(RGB, tupltype=b"RGB"),
    "RGB 16-bit": lambda: F.pam(V16, 65535, b"RGB"),
    "RGB maxval 1 reads bits": lambda: F.pam(RGB, 1),
    "GRAYSCALE": lambda: F.pam(GRAY[..., None]),
    "GRAYSCALE maxval 100 taken as is": lambda: F.pam(GRAY[..., None], 100),
    "GRAYSCALE 16-bit": lambda: F.pam(V16[..., :1] % 1001, 1000,
                                      b"GRAYSCALE"),
    "BLACKANDWHITE": lambda: F.pam(GRAY[..., None], 1, b"BLACKANDWHITE"),
    "BLACKANDWHITE of maxval 255": lambda: F.pam(GRAY[..., None], 255,
                                                 b"BLACKANDWHITE"),
    "header comments and blank lines": lambda: F.pam(
        RGB, lines=b"# a comment\n\n   \n"),
    "header spaces": lambda: F.pam(RGB, head=(
        b"P7\n  WIDTH   %d  \nHEIGHT %d\nDEPTH 3\nMAXVAL 255\nENDHDR\n"
        % (W, H))),
    "CRLF header": lambda: F.pam(RGB, head=(
        b"P7\r\nWIDTH %d\r\nHEIGHT %d\r\nDEPTH 3\r\nMAXVAL 255\r\nENDHDR\r\n"
        % (W, H))),
    "two tupltypes, the last wins": lambda: F.pam(
        RGB, lines=b"TUPLTYPE GRAYSCALE\nTUPLTYPE RGB\n"),
}


@pytest.mark.parametrize("name", sorted(PAM))
def test_pam_reads_as_cv2(tmp_path, name):
    assert_reads_as_cv2(tmp_path, PAM[name](), pxm.decode_pam, ".pam")


@pytest.mark.parametrize("maxval", [255, 1000])
def test_two_channel_pam_is_named_where_jax_raises(tmp_path, maxval):
    """cv2 reads GRAYSCALE_ALPHA as two channels, on which JAX's
    ``cvtColor(BGR2RGB)`` raises; the port names the file."""
    data = F.pam(_ga() * (maxval // 255), maxval, b"GRAYSCALE_ALPHA")
    path = tmp_path / "ga.pam"
    path.write_bytes(data)
    assert_same(pxm.decode_pam(data), cv2.imread(str(path),
                                                 cv2.IMREAD_UNCHANGED))
    with pytest.raises(cv2.error):
        jio.imread_unit(str(path))
    assert tio.read_image(str(path)) == (None, "two-channel PAM")
    logged = []
    assert list(tio.decode_iter([path], log=logged.append)) == []
    assert logged == ["warning: ga.pam unsupported by the port: "
                      "two-channel PAM"]


@pytest.mark.parametrize("depth,maxval", [(2, 255), (4, 255), (4, 65535)])
def test_pam_color_converts_every_pixel(tmp_path, depth, maxval):
    """cv2's ``IMREAD_COLOR`` of a two- or four-channel PAM converts the
    first ``ceil(W / DEPTH)`` pixels of each row and leaves the rest
    unwritten; the port agrees on those and converts the others too (gray
    replicated, or RGB)."""
    samples = (_ga() if depth == 2 else np.concatenate(
        [RGB, GRAY[..., None]], -1)).astype(np.int64) * (maxval // 255)
    data = F.pam(samples, maxval, b"GRAYSCALE_ALPHA" if depth == 2
                 else b"RGB_ALPHA")
    path = tmp_path / "v.pam"
    path.write_bytes(data)
    got = pxm.decode_pam(data, True)
    v = (samples >> 8 if maxval > 255 else samples).astype(np.uint8)
    want = np.repeat(v[..., :1], 3, 2) if depth == 2 else v[..., :3]
    assert_same(got, want)
    n = -(-W // depth)
    assert_same(as_cv2(got)[:, :n], cv2.imread(str(path))[:, :n])
    if depth == 4:
        assert_same(as_cv2(pxm.decode_pam(data)),
                    cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
        assert_same(tio.imread_unit(str(path)), jio.imread_unit(str(path)))


PAM_REFUSED = {
    "lower-case fields": lambda: F.pam(RGB, head=(
        b"P7\nwidth %d\nheight %d\ndepth 3\nmaxval 255\nendhdr\n" % (W, H))),
    "no MAXVAL": lambda: F.pam(RGB, head=(
        b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nENDHDR\n" % (W, H))),
    "WIDTH twice": lambda: F.pam(RGB, lines=b"WIDTH 3\n"),
    "an unknown field": lambda: F.pam(RGB, lines=b"FOO 4\n"),
    "an unknown field without a value": lambda: F.pam(RGB, lines=b"FOO\n"),
    "a comment after a value": lambda: F.pam(RGB, head=(
        b"P7\nWIDTH %d # w\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\nENDHDR\n"
        % (W, H))),
    "WIDTH 53x": lambda: F.pam(RGB, head=(
        b"P7\nWIDTH %dx\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\nENDHDR\n" % (W, H))),
    "an unknown tupltype": lambda: F.pam(RGB, tupltype=b"CMYK"),
    "a tupltype of other channels": lambda: F.pam(RGB, tupltype=b"GRAYSCALE"),
    "DEPTH 4 without a tupltype": lambda: F.pam(
        np.concatenate([RGB, RGB[..., :1]], -1)),
    "16-bit RGB without a tupltype": lambda: F.pam(V16, 65535),
    "DEPTH 5": lambda: F.pam(np.concatenate([RGB, RGB[..., :2]], -1),
                             tupltype=b"RGB"),
    "P7 and a space": lambda: b"P7 " + F.pam(RGB)[3:],
    "MAXVAL 65536": lambda: F.pam(V16, 65536, b"RGB"),
    "cut short": lambda: F.pam(RGB)[:-1],
}


@pytest.mark.parametrize("name", sorted(PAM_REFUSED))
def test_pam_cv2_refuses_is_unreadable(tmp_path, name):
    assert_refused(tmp_path, PAM_REFUSED[name](), pxm.decode_pam, ".pam")


def test_four_channel_bits_pam_reads_only_in_color(tmp_path):
    """MAXVAL 1 of DEPTH 4: cv2 refuses it in ``IMREAD_UNCHANGED`` and
    reads bits in ``IMREAD_COLOR``."""
    data = F.pam(np.concatenate([RGB, RGB[..., :1]], -1), 1, b"RGB_ALPHA")
    path = tmp_path / "v.pam"
    path.write_bytes(data)
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError):
        pxm.decode_pam(data)
    assert_same(as_cv2(pxm.decode_pam(data, True)), cv2.imread(str(path)))
    assert_same(tio.imread_u8(str(path)), jdata._imread_rgb(str(path)))


# samples on the rounding's edges, past [0, 255], NaN and the infinities
EDGES = np.array([0.5, 1.5, 12.5, 13.5, 254.5, 255.5, -0.0, -2.0, 300.0,
                  3e9, np.nan, np.inf, -np.inf, 0.49999997],
                 np.float32)


def _floats():
    f = FLOATS.copy()
    f.reshape(-1)[:EDGES.size] = EDGES
    return f


PFM = {
    "little-endian": lambda: F.pfm(_floats()),
    "big-endian": lambda: F.pfm(_floats(), b"1.0"),
    "scale 2 halves": lambda: F.pfm(_floats(), b"2.0"),
    "scale -3": lambda: F.pfm(_floats(), b"-3"),
    "scale -0.001": lambda: F.pfm(_floats(), b"-0.001"),
    "scale -1e0": lambda: F.pfm(_floats(), b"-1e0"),
    "scale 0x2": lambda: F.pfm(_floats(), b"0x2"),
    "scale -inf": lambda: F.pfm(_floats(), b"-inf"),
    "width 53x": lambda: F.pfm(_floats(), head=b"PF\n%dx %d\n-1\n" % (W, H)),
    "a second newline is a sample byte": lambda: F.pfm(
        _floats(), head=b"PF\n%d %d\n-1\n\n" % (W, H))[:-1],
    "u8 frame": lambda: F.pfm(RGB.astype(np.float32)),
    "trailing bytes": lambda: F.pfm(_floats()) + b"junk",
}


@pytest.mark.parametrize("name", sorted(PFM))
def test_pfm_reads_as_cv2(tmp_path, name):
    assert_reads_as_cv2(tmp_path, PFM[name](), pxm.decode_pfm, ".pfm")


def test_gray_pfm_reads_2d_and_is_unreadable_in_color(tmp_path):
    """A gray ``Pf``: ``imread_unit`` reads it as JAX does; in
    ``IMREAD_COLOR`` ``cv2.imdecode`` keeps it 2-D and ``cv2.imread`` of
    the file gives None (the decoder changed the matrix it was given), so
    JAX's training loader and the port's ``imread_u8`` skip it."""
    data = F.pfm(_floats()[..., 0])
    path = tmp_path / "g.pfm"
    path.write_bytes(data)
    assert_same(pxm.decode_pfm(data), cv2.imread(str(path),
                                                 cv2.IMREAD_UNCHANGED))
    assert_same(tio.imread_unit(str(path)), jio.imread_unit(str(path)))
    assert_same(pxm.decode_pfm(data, True), cv2.imdecode(
        np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    assert cv2.imread(str(path)) is None
    assert jdata._imread_rgb(str(path)) is None
    assert tio.read_image(str(path), True) == (None, None)


PFM_REFUSED = {
    "scale 0": lambda: F.pfm(FLOATS, b"0"),
    "scale nan": lambda: F.pfm(FLOATS, b"nan"),
    "scale abc": lambda: F.pfm(FLOATS, b"abc"),
    "CRLF header": lambda: F.pfm(FLOATS, head=b"PF\r\n%d %d\r\n-1\r\n"
                                 % (W, H)),
    "two spaces read height 0": lambda: F.pfm(
        FLOATS, head=b"PF\n%d  %d\n-1\n" % (W, H)),
    "a comment": lambda: F.pfm(FLOATS, head=b"PF\n# c\n%d %d\n-1\n" % (W, H)),
    "negative width": lambda: F.pfm(FLOATS, head=b"PF\n-%d %d\n-1\n" % (W, H)),
    "a byte past 127 in the header": lambda: F.pfm(
        FLOATS, head=b"PF\n%d %d\n-1\xa0" % (W, H)),
    "cut short": lambda: F.pfm(FLOATS)[:-1],
}


@pytest.mark.parametrize("name", sorted(PFM_REFUSED))
def test_pfm_cv2_refuses_is_unreadable(tmp_path, name):
    assert_refused(tmp_path, PFM_REFUSED[name](), pxm.decode_pfm, ".pfm")


@pytest.mark.parametrize("suffix", [".ppm", ".pnm", ".pam", ".pfm"])
def test_written_files_read_back_as_jax_reads_them(tmp_path, suffix):
    """The port's file of a u8 frame reads back, through ``imread_unit``,
    as JAX's u8 frame over 255, bit for bit (a PFM's samples are 0-255
    floats); ``imread_u8`` gives the frame."""
    path = tmp_path / f"f{suffix}"
    tio.imwrite_unit(str(path), RGB)
    np.testing.assert_array_equal(tio.imread_unit(str(path)),
                                  RGB.astype(np.float32) / 255.0)
    assert_same(tio.imread_unit(str(path)), jio.imread_unit(str(path)))
    assert_same(tio.imread_u8(str(path)), RGB)
