"""The port's Sun raster reader and writer (``utils/sunras.py``) against
cv2 5.0.0.

Each file is built here (``tests/torch_formats.py``, 37x53 or smaller)
and read by the port in both modes, bit-equal to ``cv2.imread`` and,
through ``imread_unit`` and ``imread_u8``, to JAX's readers: RT_OLD and
RT_STANDARD, 1, 8, 24 and 32 bits, gray and colour colormaps (an index
past one black, a map whose length is not a multiple of 3), rows padded
to 16 bits.  A fault of the reference that the port follows: a 1- or
8-bit file without a colormap reads as zeros in ``IMREAD_UNCHANGED``.
cv2 refuses every RT_BYTE_ENCODED and RT_FORMAT_RGB file, so they are
"unreadable" here too.  The writer's bytes equal ``cv2.imencode``'s,
but for the pad byte after the last row of an odd-width image, which cv2
reads from past the image."""

import cv2
import numpy as np
import pytest

from tests import torch_formats as F
from tests.test_torch_pxm import assert_reads_as_cv2, assert_refused
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import sunras

H, W = 37, 53
_RNG = np.random.default_rng(25)
RGB = _RNG.integers(0, 256, (H, W, 3), np.uint8)
IDX = _RNG.integers(0, 256, (H, W))
BITS = IDX & 1
PAL = _RNG.integers(0, 256, (256, 3), np.uint8)
GRAY_PAL = np.repeat(_RNG.integers(0, 256, (256, 1), np.uint8), 3, 1)


def _file(samples, bits, w=W, **kw):
    return F.sunras(F.sunras_rows(samples, bits), w, H, bits, **kw)


READ = {
    "8-bit without a colormap (zeros unchanged)": lambda: _file(IDX, 8),
    "8-bit RT_OLD": lambda: _file(IDX, 8, kind=0),
    "8-bit gray colormap": lambda: _file(IDX, 8, cmap=GRAY_PAL),
    "8-bit colour colormap": lambda: _file(IDX, 8, cmap=PAL),
    "8-bit short colormap, indices past it black": lambda: _file(
        IDX, 8, cmap=PAL[:100]),
    "8-bit colormap of 4 bytes": lambda: F.sunras(
        F.sunras_rows(IDX, 8), W, H, 8, maptype=1)[:28]
    + b"\0\0\0\x04\x01\x02\x03\x04" + F.sunras_rows(IDX, 8),
    "8-bit even width": lambda: _file(IDX[:, :52], 8, w=52, cmap=PAL),
    "1-bit without a colormap": lambda: _file(BITS, 1),
    "1-bit colour colormap": lambda: _file(BITS, 1, cmap=PAL[:2]),
    "1-bit gray colormap": lambda: _file(BITS, 1, cmap=GRAY_PAL[:2]),
    "1-bit width 16": lambda: _file(BITS[:, :16], 1, w=16),
    "24-bit": lambda: _file(RGB, 24),
    "24-bit RT_OLD": lambda: _file(RGB, 24, kind=0),
    "24-bit even width": lambda: _file(RGB[:, :52], 24, w=52),
    "32-bit": lambda: _file(np.concatenate([IDX[..., None], RGB], -1), 32),
    "a length field of 0": lambda: _file(RGB, 24, length=0),
    "trailing bytes": lambda: _file(RGB, 24) + b"junk",
}


@pytest.mark.parametrize("name", sorted(READ))
def test_sunras_reads_as_cv2(tmp_path, name):
    assert_reads_as_cv2(tmp_path, READ[name](), sunras.decode_sunras, ".ras")


def test_gray_without_colormap_reads_zeros_as_jax_does(tmp_path):
    """The gray table cv2 reads a 1- or 8-bit file through in
    ``IMREAD_UNCHANGED`` is filled from a colormap only: without one the
    file reads as zeros there (in JAX's ``imread_unit`` too), and as its
    gray ramp in ``IMREAD_COLOR``."""
    path = tmp_path / "g.ras"
    path.write_bytes(_file(IDX, 8))
    assert not jio.imread_unit(str(path)).any()
    assert not tio.imread_unit(str(path)).any()
    np.testing.assert_array_equal(tio.imread_u8(str(path))[..., 0], IDX)


REFUSED = {
    "8-bit RT_BYTE_ENCODED": lambda: F.sunras(
        F.sunras_rle(IDX.astype(np.uint8).tobytes()), W, H, 8, kind=2),
    "8-bit RT_BYTE_ENCODED with a colormap": lambda: F.sunras(
        F.sunras_rle(IDX.astype(np.uint8).tobytes()), W, H, 8, kind=2,
        cmap=PAL),
    "1-bit RT_BYTE_ENCODED": lambda: F.sunras(
        F.sunras_rle(np.packbits(BITS, axis=1).tobytes()), W, H, 1, kind=2),
    "24-bit RT_FORMAT_RGB": lambda: _file(RGB, 24, kind=3),
    "32-bit RT_FORMAT_RGB": lambda: _file(
        np.concatenate([IDX[..., None], RGB], -1), 32, kind=3),
    "type 4": lambda: _file(IDX, 8, kind=4),
    "type 5": lambda: _file(IDX, 8, kind=5),
    "maptype 2": lambda: _file(IDX, 8, cmap=PAL, maptype=2),
    "4-bit": lambda: F.sunras(bytes(H * 28), W, H, 4),
    "a colormap past 2**bits": lambda: _file(BITS, 1, cmap=PAL[:3]),
    "24-bit with a colormap": lambda: _file(RGB, 24, cmap=PAL[:4]),
    "RMT_NONE with a map length": lambda: _file(IDX, 8, cmap=PAL,
                                                maptype=0),
    "cut short": lambda: _file(RGB, 24)[:-1],
    "width 0": lambda: F.sunras(b"", 0, H, 8),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_sunras_cv2_refuses_is_unreadable(tmp_path, name):
    assert_refused(tmp_path, REFUSED[name](), sunras.decode_sunras, ".ras")


@pytest.mark.parametrize("shape", [(1, 2), (3, 4), (37, 52), (1, 1),
                                   (37, 53), (2, 1), (5, 7)])
def test_sunras_writer_equals_cv2(shape):
    """cv2's bytes; after the last row of an odd row length cv2 pads with
    a byte read from past the image (the port writes 0), so that byte is
    left out of the comparison there."""
    img = RGB[:shape[0], :shape[1]]
    got = sunras.encode_sunras(img)
    want = cv2.imencode(".sr", np.ascontiguousarray(img[..., ::-1]))[
        1].tobytes()
    odd = shape[1] % 2
    assert len(got) == len(want)
    assert got[:len(got) - odd] == want[:len(want) - odd]
    assert not odd or got[-1] == 0
