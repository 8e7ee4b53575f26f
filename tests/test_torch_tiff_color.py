"""The port's TIFF decoder on the two colour spaces libtiff's RGBA reader
converts itself (``utils/tiff_color.py``): uncompressed YCbCr at every
subsampling libtiff takes (4x4, 4x2, 4x1, 2x2, 2x1, 1x2, 1x1; planar
1x1), on a width and height that are not multiples of the block, in
strips and tiles, with the YCbCrCoefficients, ReferenceBlackWhite and
YCbCrPositioning tags or their defaults; and CIE L*a*b* at 8 and 16 bits
over every a*/b* byte with L at a few levels, with the WhitePoint tag or
its D50 default.  Each file is built by ``tests/torch_tiff.py`` (64x96 or
smaller) and read in both modes bit-equal to ``cv2.imread``, and through
``imread_unit`` and ``imread_u8`` equal to JAX's readers
(``tests/test_torch_tiff_samples.assert_reads_as_cv2``); what libtiff
refuses gives ValueError."""

import cv2
import numpy as np
import pytest

from tests import torch_tiff as T
from tests.test_torch_tiff_samples import assert_reads_as_cv2
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import jpeg as tjpeg
from underwater_image_enhancement_tpu_torch.utils import tiff as ttiff
from underwater_image_enhancement_tpu_torch.utils import tiff_color

H, W = 37, 53  # not a multiple of any block; 16x16 tiles cut at the edges
SUBSAMPLINGS = [(4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)]


def _ycc():
    """Seeded Y, Cb, Cr over their whole ranges."""
    return np.random.default_rng(71).integers(0, 256, (H, W, 3)).astype(
        np.uint8)


YCC = _ycc()


def _ycbcr(sub, tags=None, **kw):
    return T.tiff([YCC], photometric=6, block=T.ycbcr_block(*sub),
                  tags={530: (3, list(sub)), **(tags or {})}, **kw)


def _rational(*values):
    """RATIONAL values of the tests' fractions: (numerator, denominator)
    pairs flattened."""
    return (5, [x for v in values for x in v])


# Rec. 709 luma, and a studio-range ReferenceBlackWhite
REC709 = {529: _rational((2126, 10000), (7152, 10000), (722, 10000))}
STUDIO = {532: _rational((16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                         (240, 1))}
ODD_RANGE = {532: _rational((3, 2), (250, 1), (120, 1), (255, 1),
                            (100, 3), (300, 1))}

YCBCR = {
    **{f"{h}x{v} one strip": (lambda s=(h, v): _ycbcr(s))
       for h, v in SUBSAMPLINGS},
    **{f"{h}x{v} strips lzw": (lambda s=(h, v): _ycbcr(
        s, rows_per_strip=8, compression=5)) for h, v in SUBSAMPLINGS},
    **{f"{h}x{v} tiles big-endian deflate": (lambda s=(h, v): _ycbcr(
        s, order=">", tile=(16, 16), compression=8))
       for h, v in SUBSAMPLINGS},
    **{f"{h}x{v} tiles 32x16 packbits": (lambda s=(h, v): _ycbcr(
        s, tile=(32, 16), compression=32773)) for h, v in SUBSAMPLINGS},
    "default subsampling": lambda: T.tiff(
        [YCC], photometric=6, block=T.ycbcr_block(2, 2)),
    "2x2 positioning 2": lambda: _ycbcr((2, 2), {531: (3, [2])}),
    "4x2 positioning 1 tiles": lambda: _ycbcr((4, 2), {531: (3, [1])},
                                              tile=(16, 16)),
    "2x2 rec709": lambda: _ycbcr((2, 2), REC709),
    "1x1 studio range": lambda: _ycbcr((1, 1), STUDIO),
    "4x4 rec709 studio range tiles": lambda: _ycbcr(
        (4, 4), {**REC709, **STUDIO}, tile=(16, 32), compression=5),
    "2x1 odd reference range": lambda: _ycbcr((2, 1), ODD_RANGE),
    "1x1 planar": lambda: T.tiff([YCC], photometric=6, planar=2,
                                 tags={530: (3, [1, 1])}),
    "1x1 planar tiles": lambda: T.tiff([YCC], photometric=6, planar=2,
                                       tile=(16, 16),
                                       tags={530: (3, [1, 1])}),
    # the predictor on the blocks' bytes in rows of a scanline's bytes;
    # where those rows are not whole pixels libtiff leaves the bytes
    **{f"{h}x{v} lzw predictor": (lambda s=(h, v): _ycbcr(
        s, compression=5, predictor=2)) for h, v in SUBSAMPLINGS},
    **{f"{h}x{v} deflate predictor width 48": (lambda s=(h, v): T.tiff(
        [YCC[:, :48]], photometric=6, block=T.ycbcr_block(*s),
        compression=8, predictor=2, rows_per_strip=8,
        tags={530: (3, list(s))})) for h, v in SUBSAMPLINGS},
    **{f"{h}x{v} tiles lzw predictor": (lambda s=(h, v): _ycbcr(
        s, tile=(16, 16), compression=5, predictor=2))
       for h, v in SUBSAMPLINGS},
    "2x2 orientation 3": lambda: _ycbcr((2, 2), {274: (3, [3])}),
    "4x2 tiles orientation 2": lambda: _ycbcr((4, 2), {274: (3, [2])},
                                              tile=(16, 16)),
    "2x2 jpeg 2000 zero-filled": lambda: _ycbcr((2, 2), {259: (3, [34712])}),
    "2x2 bigtiff": lambda: _ycbcr((2, 2), big=True),
}


@pytest.mark.parametrize("name", sorted(YCBCR))
def test_ycbcr_tiff_reads_as_cv2(tmp_path, name):
    assert assert_reads_as_cv2(tmp_path, YCBCR[name]())


def _lab8(L, part):
    """64x96 8-bit L*a*b* samples: L fixed, the (a*, b*) bytes
    ``part * 6144`` to ``(part + 1) * 6144`` of all 65536 (wrapping)."""
    k = (part * 6144 + np.arange(6144)) % 65536
    return np.stack([np.full(6144, L), k >> 8, k & 255], -1).astype(
        np.uint8).reshape(64, 96, 3)


def _lab16(L, part):
    """The same over 16-bit samples: every a*/b* high byte, seeded low
    bytes."""
    lab = _lab8(0, part).astype(np.uint16) << 8
    lab[..., 0] = L
    low = np.random.default_rng(72 + part).integers(0, 256, (64, 96, 2))
    lab[..., 1:] |= low.astype(np.uint16)
    return lab


# L levels: black, dark (below L* = 8.856, the formula's break), the
# break, midtones, white
LAB8_LEVELS = [0, 5, 22, 23, 128, 255]
LAB16_LEVELS = [0, 1000, 5800, 5805, 30000, 65535]
PARTS = 11  # 11 * 6144 >= 65536


@pytest.mark.parametrize("bits,L", [(8, v) for v in LAB8_LEVELS]
                         + [(16, v) for v in LAB16_LEVELS])
def test_cielab_every_ab_byte_reads_as_cv2(tmp_path, bits, L):
    make = _lab8 if bits == 8 else _lab16
    for part in range(PARTS):
        data = T.tiff([make(L, part)], photometric=8)
        path = tmp_path / "lab.tif"
        path.write_bytes(data)
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1]
        got = ttiff.decode_tiff(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _lab_image(bits):
    rng = np.random.default_rng(73)
    top = 256 if bits == 8 else 65536
    return rng.integers(0, top, (H, W, 3)).astype(
        np.uint8 if bits == 8 else np.uint16)


D65 = {318: _rational((3127, 10000), (3290, 10000))}

CIELAB = {
    "8-bit": lambda: T.tiff([_lab_image(8)], photometric=8),
    "16-bit": lambda: T.tiff([_lab_image(16)], photometric=8),
    "8-bit d65": lambda: T.tiff([_lab_image(8)], photometric=8, tags=D65),
    "16-bit d65 big-endian": lambda: T.tiff([_lab_image(16)], ">",
                                            photometric=8, tags=D65),
    "8-bit tiles lzw predictor": lambda: T.tiff(
        [_lab_image(8)], tile=(16, 16), compression=5, predictor=2,
        photometric=8),
    "16-bit tiles big-endian deflate predictor": lambda: T.tiff(
        [_lab_image(16)], ">", tile=(16, 16), compression=8, predictor=2,
        photometric=8),
    "8-bit strips packbits": lambda: T.tiff(
        [_lab_image(8)], rows_per_strip=5, compression=32773, photometric=8),
    "8-bit orientation 4": lambda: T.tiff([_lab_image(8)], photometric=8,
                                          tags={274: (3, [4])}),
    "16-bit orientation 2 tiles": lambda: T.tiff(
        [_lab_image(16)], tile=(16, 16), photometric=8,
        tags={274: (3, [2])}),
    "8-bit jpeg 2000 zero-filled": lambda: T.tiff(
        [_lab_image(8)], photometric=8, tags={259: (3, [34712])}),
}


@pytest.mark.parametrize("name", sorted(CIELAB))
def test_cielab_tiff_reads_as_cv2(tmp_path, name):
    assert assert_reads_as_cv2(tmp_path, CIELAB[name]())


# what libtiff's RGBA reader refuses: cv2 gives None in both modes
REFUSED = {
    **{f"ycbcr {h}x{v}": (lambda s=(h, v): _ycbcr(s))
       for h, v in ((1, 4), (2, 4), (3, 1), (4, 3))},
    "ycbcr 2x2 planar": lambda: T.tiff([YCC], photometric=6, planar=2,
                                       tags={530: (3, [2, 2])}),
    "ycbcr planar default subsampling": lambda: T.tiff(
        [YCC], photometric=6, planar=2),
    "ycbcr 16-bit": lambda: T.tiff([YCC.astype(np.uint16) * 257],
                                   photometric=6, tags={530: (3, [1, 1])}),
    "ycbcr of 4 samples": lambda: T.tiff(
        [np.concatenate([YCC, YCC[..., :1]], -1)], photometric=6,
        tags={530: (3, [1, 1])}),
    "ycbcr luma green 0": lambda: _ycbcr((1, 1), {529: _rational(
        (1, 2), (0, 1), (1, 2))}),
    "cielab planar": lambda: T.tiff([_lab_image(8)], planar=2,
                                    photometric=8),
    "cielab of 4 samples": lambda: T.tiff(
        [np.concatenate([_lab_image(8), _lab_image(8)[..., :1]], -1)],
        photometric=8),
    "cielab of 1 sample": lambda: T.tiff([_lab_image(8)[..., 0]],
                                         photometric=8),
    "cielab 32-bit": lambda: T.tiff(
        [_lab_image(16).astype(np.uint32)], photometric=8),
    "cielab white point y 0": lambda: T.tiff(
        [_lab_image(8)], photometric=8,
        tags={318: _rational((3127, 10000), (0, 1))}),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_colour_tiff_libtiff_refuses_is_unreadable(tmp_path, name):
    data = REFUSED[name]()
    path = tmp_path / "v.tif"
    path.write_bytes(data)
    for color, flag in ((False, cv2.IMREAD_UNCHANGED),
                        (True, cv2.IMREAD_COLOR)):
        assert cv2.imread(str(path), flag) is None
        with pytest.raises(ValueError) as e:
            ttiff.decode_tiff(data, color)
        assert not isinstance(e.value, tjpeg.Unsupported), e.value
        assert tio.read_image(str(path), color) == (None, None)


def test_ycbcr_tables_defaults():
    """The default tables: Y codes are their values, Cr 255 adds
    ``(D1 * 127 + 2**15) >> 16`` to red with ``D1 = FIX(2 - 2 * 0.299)``,
    and a gray pixel (Cb = Cr = 128) is its Y in each channel."""
    y, cr_r, cb_b, cr_g, cb_g = tiff_color.ycbcr_tables()
    np.testing.assert_array_equal(y, np.arange(256))
    d1 = int(float(np.float32(2) - np.float32(2) * np.float32(0.299))
             * 65536 + 0.5)
    assert cr_r[255] == (d1 * 127 + (1 << 15)) >> 16
    gray = np.stack([np.arange(256), np.full(256, 128), np.full(256, 128)],
                    -1).astype(np.uint8)
    np.testing.assert_array_equal(tiff_color.ycbcr_to_rgb(gray),
                                  np.repeat(np.arange(256)[:, None], 3, 1))
