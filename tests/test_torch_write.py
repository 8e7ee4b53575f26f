"""The port's image writers against cv2 on the CPU.

``utils/io.imwrite_unit`` picks the encoder from the suffix, as
``cv2.imwrite`` does.  PNG and APNG (gray, RGB and RGBA; Sub-filtered
rows, ``Z_RLE`` at level 1, libpng's zlib header for small images, 8 KiB
IDAT chunks), JPEG (cv2's defaults: baseline, quality 95, 4:2:0), BMP
(24-bit) and TIFF (LZW with the horizontal predictor) are held to
``cv2.imencode``'s bytes, on noise and on the smooth ``underwater_img``
frame of ``tests/torch_frames.py``; the TIFF also to cv2's tag values and
to ``cv2.imread`` of the port's file.  ``cli enhance --output NAME.<fmt>``
writes the JAX CLI's bytes where the two u8 frames are equal (the test
asserts they are).  PPM, PNM, PAM, PFM, Sun raster and HDR: the port's
``imwrite_unit`` writes the bytes of JAX's (``cv2.imwrite``); for
``.pgm`` and ``.pbm`` of a colour frame cv2 writes nothing and the port
raises.  Suffixes that cv2 writes and the port does not, and suffixes
cv2 cannot write, raise.
"""

import struct

import cv2
import numpy as np
import pytest

from tests import torch_frames
from underwater_image_enhancement_tpu import cli as jcli
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils.bmp import (
    decode_bmp,
    encode_bmp,
)
from underwater_image_enhancement_tpu_torch.utils.jpeg import (
    decode_jpeg,
    encode_jpeg,
)
from underwater_image_enhancement_tpu_torch.utils.tiff import (
    decode_tiff,
    encode_tiff,
)

# libpng's zlib header rewrite (up to 16 KiB of filtered rows) and filter
# 0 on a frame one pixel wide; several IDAT chunks from 64x64 RGBA up
PNG_SHAPES = ((1, 1), (1, 2), (2, 1), (5, 7), (9, 9), (17, 5), (33, 17),
              (64, 64), (100, 100), (120, 160), (300, 1))
APNG_SHAPES = ((1, 1), (33, 17), (120, 160))
JPEG_SHAPES = ((1, 1), (7, 9), (8, 8), (16, 16), (17, 33), (37, 53),
               (120, 160))
BMP_SHAPES = ((1, 1), (3, 5), (37, 53))
# one strip; two strips (LONG byte counts); SHORT byte counts in the entry
# (two strips) and out of it (four); the 1080p strip shape (one row)
TIFF_SHAPES = ((1, 1), (37, 53), (20, 160), (2, 2000), (10, 700),
               (3, 1920))
CLI_SUFFIXES = (".png", ".jpg", ".JPEG", ".bmp", ".tif")
COLOUR_WRITERS = (".ppm", ".pnm", ".pam", ".pfm", ".sr", ".ras", ".hdr",
                  ".pic")
GRAY_ONLY = (".pgm", ".pbm")


def _frame(kind: str, shape) -> np.ndarray:
    """(H, W, 3) uint8 RGB: seeded noise, or a crop of the smooth
    ``underwater_img`` frame (120x160)."""
    h, w = shape
    if kind == "noise":
        return np.random.default_rng(h * 1000 + w).integers(
            0, 256, (h, w, 3), dtype=np.uint8)
    img = torch_frames.underwater_img()
    if h > img.shape[0] or w > img.shape[1]:
        img = np.tile(img, (-(-h // img.shape[0]), -(-w // img.shape[1]), 1))
    return (img[:h, :w] * 255.0).round().astype(np.uint8)


def _cv2_bytes(suffix: str, rgb: np.ndarray) -> bytes:
    """``cv2.imencode`` of an RGB or RGBA frame (as BGR or BGRA) or of a
    gray one."""
    if rgb.ndim == 3:
        rgb = rgb[..., [2, 1, 0, 3][:rgb.shape[2]]]
    ok, buf = cv2.imencode(suffix, np.ascontiguousarray(rgb))
    assert ok
    return buf.tobytes()


def _png_frame(kind: str, shape, channels: int) -> np.ndarray:
    """``_frame`` as gray (its red plane), RGB or RGBA (alpha the green
    plane of the other kind's frame)."""
    rgb = _frame(kind, shape)
    if channels == 1:
        return rgb[..., 0]
    if channels == 3:
        return rgb
    other = _frame("smooth" if kind == "noise" else "noise", shape)
    return np.concatenate([rgb, other[..., 1:2]], -1)


def _tiff_tags(data: bytes) -> dict:
    """tag -> (type, count, values) of a little-endian TIFF's first IFD."""
    (ifd,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        tag, kind, count, field = struct.unpack(
            "<HHI4s", data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        size = {3: 2, 4: 4}[kind] * count
        raw = field[:size] if size <= 4 else data[
            struct.unpack("<I", field)[0]:][:size]
        tags[tag] = (kind, count, struct.unpack(
            "<%d%s" % (count, "H" if kind == 3 else "I"), raw))
    return tags


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("shape", JPEG_SHAPES)
def test_jpeg_bytes_equal_cv2(kind, shape):
    rgb = _frame(kind, shape)
    data = encode_jpeg(rgb)
    assert data == _cv2_bytes(".jpg", rgb)
    # and the port's decoder reads it as cv2 does
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert np.array_equal(decode_jpeg(data), want[..., ::-1])


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("shape", PNG_SHAPES)
def test_png_bytes_equal_cv2(kind, shape, channels):
    img = _png_frame(kind, shape, channels)
    data = tio.encode_png(img)
    assert data == _cv2_bytes(".png", img)
    back = tio.decode_image(data)
    want = img[..., :3] if channels > 1 else np.repeat(img[..., None], 3, 2)
    assert np.array_equal(back, want)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_png_bytes_equal_cv2_at_1080p(kind):
    """The 1080p RGB frame: 1 MiB and up of IDAT chunks, no header
    rewrite."""
    rgb = _frame(kind, (1080, 1920))
    assert tio.encode_png(rgb) == _cv2_bytes(".png", rgb)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("shape", APNG_SHAPES)
def test_apng_bytes_equal_cv2(shape, channels):
    """cv2 writes a one-frame ``.apng`` as the PNG's bytes."""
    img = _png_frame("noise", shape, channels)
    assert tio.encoder_for("a.apng")(img) == _cv2_bytes(".apng", img)


@pytest.mark.parametrize("shape", BMP_SHAPES)
def test_bmp_bytes_equal_cv2(shape):
    rgb = _frame("noise", shape)
    data = encode_bmp(rgb)
    assert data == _cv2_bytes(".bmp", rgb)
    assert np.array_equal(decode_bmp(data), rgb)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("shape", TIFF_SHAPES)
def test_tiff_tags_and_read_back_equal_cv2(kind, shape):
    rgb = _frame(kind, shape)
    data = encode_tiff(rgb)
    want = _cv2_bytes(".tif", rgb)
    tags = _tiff_tags(data)
    assert tags == _tiff_tags(want)
    assert {k: v[2] for k, v in tags.items() if k in (259, 262, 277, 284,
                                                      317, 339)} == {
        259: (5,), 262: (2,), 277: (3,), 284: (1,), 317: (2,), 339: (1, 1, 1)}
    back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(back[..., ::-1], rgb)
    assert data == want


@pytest.mark.parametrize("shape", TIFF_SHAPES)
def test_tiff16_bytes_equal_cv2(shape):
    """16-bit RGB: cv2's 8 KiB strips of 6-byte pixels, the predictor on
    the samples' values mod 65536, written little-endian; read back by
    cv2 and by the port's decoder."""
    low = _frame("noise", shape).astype(np.uint16)
    rgb = _frame("smooth", shape).astype(np.uint16) * 257 ^ low
    data = encode_tiff(rgb)
    assert data == _cv2_bytes(".tif", rgb)
    back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert back.dtype == np.uint16 and np.array_equal(back[..., ::-1], rgb)
    assert np.array_equal(decode_tiff(data), rgb)


def test_tiff_lzw_ratio_clear_equals_cv2():
    """A strip of 24000 bytes, 12000 of zeros and then random 0/1 samples
    (after the predictor): at its second 10000-byte checkpoint the
    compression ratio has fallen, and libtiff clears the table while it is
    not yet full."""
    w = 8000
    diff = np.zeros(w * 3, np.uint8)
    diff[12000:] = np.random.default_rng(3).integers(0, 2, w * 3 - 12000)
    rgb = np.cumsum(diff.reshape(w, 3), axis=0, dtype=np.uint8)[None]
    assert encode_tiff(rgb) == _cv2_bytes(".tif", rgb)


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    """``cli enhance --input FILE --output out.<suffix>`` of both packages
    (the port's with ``--device cpu``) on the smooth frame -> the folder."""
    root = tmp_path_factory.mktemp("write_cli")
    tio.imwrite_unit(str(root / "in.png"), torch_frames.underwater_img())
    for suffix in CLI_SUFFIXES:
        jcli.main(["enhance", "--input", str(root / "in.png"), "--output",
                   str(root / f"jax{suffix}")])
        tcli.main(["enhance", "--input", str(root / "in.png"), "--output",
                   str(root / f"port{suffix}"), "--device", "cpu"])
    return root


@pytest.mark.parametrize("suffix", CLI_SUFFIXES)
def test_cli_enhance_writes_the_jax_clis_bytes(cli_outputs, suffix):
    jax_u8 = tio.imread_u8(str(cli_outputs / "jax.png"))
    port_u8 = tio.imread_u8(str(cli_outputs / "port.png"))
    assert np.array_equal(port_u8, jax_u8)
    data = (cli_outputs / f"port{suffix}").read_bytes()
    assert data == (cli_outputs / f"jax{suffix}").read_bytes()
    assert data == tio.encoder_for("out" + suffix)(port_u8)


def test_async_writer_writes_each_format(tmp_path):
    """Every suffix of ``WRITERS``: the colour frame's bytes, or (``.pgm``,
    ``.pbm``) an error reported by ``close()`` and no file."""
    rgb = _frame("smooth", (37, 53))
    with tio.AsyncWriter(workers=2) as writer:
        for suffix in tio.WRITERS:
            writer.write(str(tmp_path / f"a{suffix}"), rgb)
    assert sorted(p for p, _ in writer.close()) == sorted(
        str(tmp_path / f"a{s}") for s in GRAY_ONLY)
    for suffix in tio.WRITERS:
        if suffix in GRAY_ONLY:
            assert not (tmp_path / f"a{suffix}").exists()
            continue
        data = (tmp_path / f"a{suffix}").read_bytes()
        if suffix in (".sr", ".ras"):  # cv2 pads the odd last row from
            want = _cv2_bytes(suffix, rgb)  # past the image; the port: 0
            assert data[:-1] == want[:-1] and data[-1] == 0
        else:
            assert data == _cv2_bytes(suffix, rgb)


def test_writer_tables_match_cv2():
    """Every suffix of either table has a cv2 writer."""
    for suffix in tuple(tio.WRITERS) + tio.UNPORTED_WRITERS:
        assert cv2.haveImageWriter("x" + suffix), suffix


@pytest.mark.parametrize("suffix", COLOUR_WRITERS)
def test_simple_format_writes_jax_bytes(tmp_path, suffix):
    """JAX's ``imwrite_unit`` (``cv2.imwrite`` of the BGR frame) and the
    port's write the same bytes for the same seeded float frame, and the
    port's file reads back as JAX's does."""
    img = np.random.default_rng(24).random((64, 96, 3)).astype(np.float32)
    jio.imwrite_unit(str(tmp_path / f"jax{suffix}"), img)
    tio.imwrite_unit(str(tmp_path / f"port{suffix}"), img)
    data = (tmp_path / f"port{suffix}").read_bytes()
    assert data == (tmp_path / f"jax{suffix}").read_bytes()
    a = tio.imread_unit(str(tmp_path / f"port{suffix}"))
    b = jio.imread_unit(str(tmp_path / f"jax{suffix}"))
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("suffix", GRAY_ONLY)
def test_gray_only_suffix_refuses_colour(tmp_path, suffix):
    """cv2 refuses a colour frame for ``.pgm`` and ``.pbm``: JAX's
    ``imwrite_unit`` writes no file and raises nothing; the port raises
    ValueError and writes no file."""
    img = _frame("noise", (4, 4))
    jio.imwrite_unit(str(tmp_path / f"jax{suffix}"), img)
    assert not (tmp_path / f"jax{suffix}").exists()
    with pytest.raises(ValueError, match="one-channel images only"):
        tio.imwrite_unit(str(tmp_path / f"port{suffix}"), img)
    assert not (tmp_path / f"port{suffix}").exists()


@pytest.mark.parametrize("suffix", tio.UNPORTED_WRITERS)
def test_unported_suffix_raises(tmp_path, suffix):
    with pytest.raises(ValueError, match="the port does not"):
        tio.imwrite_unit(str(tmp_path / f"a{suffix}"), _frame("noise", (4, 4)))
    assert not (tmp_path / f"a{suffix}").exists()


@pytest.mark.parametrize("suffix", [".xyz", ".exr", ".jfif", ""])
def test_unknown_suffix_raises_as_cv2_does(tmp_path, suffix):
    rgb = _frame("noise", (4, 4))
    with pytest.raises(cv2.error, match="could not find a writer"):
        cv2.imwrite(str(tmp_path / f"c{suffix}"), rgb)
    with pytest.raises(ValueError, match="could not find a writer"):
        tio.imwrite_unit(str(tmp_path / f"p{suffix}"), rgb)


@pytest.mark.parametrize("suffix", [".jpg", ".bmp", ".tif", ".ppm", ".pam",
                                    ".pfm", ".sr", ".hdr"])
def test_non_rgb_arrays_raise(tmp_path, suffix):
    with pytest.raises(ValueError, match=r"\(H, W, 3\) uint8 RGB"):
        tio.imwrite_unit(str(tmp_path / f"g{suffix}"),
                         np.zeros((4, 4), np.uint8))
