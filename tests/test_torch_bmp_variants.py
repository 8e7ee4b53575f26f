"""The port's BMP decoder (``utils/bmp.py``) on the variants beyond 8-,
24- and 32-bit BI_RGB: OS/2 headers, 1- and 4-bit palettes, 16-bit
5-5-5 and 5-6-5, 32-bit bit fields, RLE8 and RLE4 with their escapes.
Each file is built here (``tests/torch_bmp.py``), 64x96 or smaller, and
read by the port in both modes: bit-equal to ``cv2.imread`` in
``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``, and through ``imread_unit``
and ``imread_u8`` to JAX's ``imread_unit`` and ``train/data._imread_rgb``,
shapes included.  The files cv2 refuses give ``(None, None)`` and are
logged "unreadable"; seeded random RLE streams (runs past their row,
deltas, early ends, streams cut short) decode as cv2 decodes them or fail
where it fails."""

import numpy as np
import pytest

import cv2
from tests import torch_bmp as B
from tests.test_torch_tiff_variants import _raw_as_rgb
from underwater_image_enhancement_tpu.train import data as jdata
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch.utils import bmp as tbmp
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import jpeg as tjpeg

H, W = 37, 53


def _inputs():
    rng = np.random.default_rng(51)
    yy, xx = np.mgrid[0:H, 0:W]
    rgb = np.clip(np.stack([yy * 5.3, xx * 4.1, (xx + yy) * 2.2], -1)
                  + rng.normal(0, 25, (H, W, 3)), 0, 255).astype(np.uint8)
    # palette indices in runs (so that RLE has runs to code) and noise
    runs = (xx // 7 + yy // 5) % 16
    idx8 = np.where(rng.random((H, W)) < 0.3,
                    rng.integers(0, 256, (H, W)), runs * 13).astype(np.int64)
    idx4 = np.where(rng.random((H, W)) < 0.3, rng.integers(0, 16, (H, W)),
                    runs).astype(np.int64)
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    gray = np.repeat(rng.integers(0, 256, (256, 1), np.uint8), 3, 1)
    v16 = rng.integers(0, 65536, (H, W))
    v32 = rng.integers(0, 1 << 32, (H, W), dtype=np.uint64)
    return dict(rgb=rgb, idx8=idx8, idx4=idx4, idx1=idx4 & 1, pal=pal,
                gray=gray, v16=v16, v32=v32)


IN = _inputs()


def assert_reads_as_cv2(tmp_path, data):
    path = tmp_path / "v.bmp"
    path.write_bytes(data)
    for color, flag in ((False, cv2.IMREAD_UNCHANGED),
                        (True, cv2.IMREAD_COLOR)):
        want = cv2.imread(str(path), flag)
        assert want is not None, "cv2 refuses the file"
        got = tbmp.decode_bmp(data, color)
        want = _raw_as_rgb(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (
            color, got.shape, want.shape)
        np.testing.assert_array_equal(got, want)
    a, b = tio.imread_unit(str(path)), jio.imread_unit(str(path))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    a, b = tio.imread_u8(str(path)), jdata._imread_rgb(str(path))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _palette_file(bpp, header=40, palette="pal", n=None, top_down=False):
    idx = IN["idx1" if bpp == 1 else "idx4" if bpp == 4 else "idx8"]
    pal = IN[palette][:n or 1 << bpp]
    return B.bmp(B.pack(idx if top_down else idx[::-1], bpp), W, H, bpp,
                 palette=pal, header=header, top_down=top_down)


def _bits32(masks, header):
    return B.bmp(B.pack(IN["v32"][::-1], 32), W, H, 32, B.BI_BITFIELDS,
                 masks=masks, header=header)


def _rle8(**kw):
    return B.bmp(B.rle(IN["idx8"], 8), W, H, 8, B.BI_RLE8,
                 palette=IN["pal"][:200], **kw)


def _rle4(**kw):
    return B.bmp(B.rle(IN["idx4"], 4), W, H, 4, B.BI_RLE4,
                 palette=IN["pal"][:16], **kw)


def _codes(bits, *parts, w=7, h=4, palette="pal"):
    return B.bmp(B.codes(*parts), w, h, bits,
                 B.BI_RLE8 if bits == 8 else B.BI_RLE4,
                 palette=IN[palette][:1 << bits])


READ = {
    # OS/2 BITMAPCOREHEADER: one channel (gray by OpenCV's weights) in
    # IMREAD_UNCHANGED, whatever the palette
    **{f"os2 {bpp}-bit": (lambda bpp=bpp: _palette_file(bpp, header=12))
       for bpp in (1, 4, 8)},
    "os2 24-bit": lambda: B.bmp(B.pack(
        IN["rgb"][::-1, :, ::-1].reshape(H, -1), 8), W, H, 24, header=12),
    "os2 32-bit": lambda: B.bmp(B.pack(IN["v32"][::-1], 32), W, H, 32,
                                header=12),
    # 1- and 4-bit palettes, most significant bits first
    "1-bit": lambda: _palette_file(1),
    "1-bit top-down v5 header": lambda: _palette_file(1, 124, top_down=True),
    "4-bit": lambda: _palette_file(4),
    "4-bit gray palette": lambda: _palette_file(4, palette="gray"),
    "4-bit short palette": lambda: _palette_file(4, n=9),
    "8-bit gray palette": lambda: _palette_file(8, palette="gray"),
    "8-bit short palette": lambda: _palette_file(8, n=100),
    # 16 bits: 5-5-5 (BI_RGB or bit fields), 5-6-5 bit fields
    "16-bit": lambda: B.bmp(B.pack(IN["v16"][::-1], 16), W, H, 16),
    "16-bit 5-5-5 bit fields top-down": lambda: B.bmp(
        B.pack(IN["v16"], 16), W, H, 16, B.BI_BITFIELDS,
        masks=(0x7C00, 0x3E0, 0x1F), top_down=True),
    "16-bit 5-6-5 bit fields": lambda: B.bmp(
        B.pack(IN["v16"][::-1], 16), W, H, 16, B.BI_BITFIELDS,
        masks=(0xF800, 0x7E0, 0x1F)),
    # 32-bit bit fields: the masks of a V4/V5 header, scaled to 8 bits;
    # after a 40-byte header they are not read
    "32-bit standard masks v4": lambda: _bits32(
        (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 108),
    "32-bit swapped masks v5": lambda: _bits32((0xFF, 0xFF00, 0xFF0000, 0),
                                               124),
    "32-bit 10-bit masks": lambda: _bits32((0x3FF00000, 0xFFC00, 0x3FF, 0),
                                           108),
    "32-bit 5-bit masks and alpha": lambda: _bits32(
        (0x7C00, 0x3E0, 0x1F, 0x8000), 108),
    "32-bit gapped masks": lambda: _bits32(
        (0x0F0F0000, 0xF0F0, 0x3F, 0), 108),
    "32-bit a zero mask": lambda: _bits32((0, 0xFF00, 0xFF, 0), 108),
    "32-bit masks after a 40-byte header": lambda: _bits32(
        (0x3FF00000, 0xFFC00, 0x3FF), 40),
    # RLE: every row coded, ended by an end of line, an end of bitmap
    "rle8": lambda: _rle8(),
    "rle8 gray palette": lambda: B.bmp(B.rle(IN["idx8"], 8), W, H, 8,
                                       B.BI_RLE8, palette=IN["gray"]),
    "rle8 index past the palette": lambda: B.bmp(
        B.rle(IN["idx8"], 8), W, H, 8, B.BI_RLE8, palette=IN["pal"][:50]),
    "rle8 v5 header": lambda: _rle8(header=124),
    "rle4": lambda: _rle4(),
    "rle4 gray palette": lambda: B.bmp(B.rle(IN["idx4"], 4), W, H, 4,
                                       B.BI_RLE4, palette=IN["gray"][:16]),
    # escapes: a delta fills what it skips with entry 0 (RLE8 over rows,
    # RLE4 by dx alone); an end of bitmap fills the rest (RLE4: the row);
    # an RLE8 run that ends a row takes its end of line with it
    "rle8 delta": lambda: _codes(8, ("run", 3, 9), ("delta", 2, 1),
                                 ("run", 2, 40), ("abs", [5, 6, 7]),
                                 ("eol",), ("run", 7, 3), ("eob",)),
    "rle8 delta past the image": lambda: _codes(
        8, ("run", 2, 9), ("delta", 3, 9), ("run", 1, 1), ("eob",)),
    "rle8 early end": lambda: _codes(8, ("run", 4, 9), ("eob",)),
    "rle8 full rows and their ends of line": lambda: _codes(
        8, ("run", 7, 9), ("eol",), ("abs", [1, 2, 3, 4, 5, 6, 7]),
        ("eol",), ("run", 7, 30), ("run", 7, 31), ("eol",), ("eob",)),
    "rle8 odd absolute runs": lambda: _codes(
        8, ("abs", [1, 2, 3]), ("abs", [4, 5, 6, 7]), ("eol",),
        ("abs", [8, 9, 10, 11, 12]), ("eob",)),
    "rle4 delta": lambda: _codes(4, ("run", 3, 0x9A), ("delta", 2, 1),
                                 ("run", 2, 0x40), ("eol",),
                                 ("abs", 3, [0x56, 0x70]), ("delta", 6, 3),
                                 ("eol",), ("eol",)),
    "rle4 end of bitmap ends a row": lambda: _codes(
        4, ("run", 5, 0x12), ("eob",), ("run", 7, 0x34), ("eob",),
        ("eob",), ("eob",)),
}


@pytest.mark.parametrize("name", sorted(READ))
def test_bmp_variant_reads_as_cv2(tmp_path, name):
    assert_reads_as_cv2(tmp_path, READ[name]())


REFUSED = {
    "16-bit other masks": lambda: B.bmp(
        B.pack(IN["v16"], 16), W, H, 16, B.BI_BITFIELDS,
        masks=(0xF00, 0xF0, 0xF)),
    "16-bit masks in a v4 header": lambda: B.bmp(
        B.pack(IN["v16"], 16), W, H, 16, B.BI_BITFIELDS,
        masks=(0xF800, 0x7E0, 0x1F, 0), header=108),
    "os2 16-bit": lambda: B.bmp(B.pack(IN["v16"], 16), W, H, 16, header=12),
    "2-bit": lambda: B.bmp(B.pack(IN["idx4"] & 3, 2), W, H, 2,
                           palette=IN["pal"][:4]),
    "rle8 on 4 bits": lambda: B.bmp(B.rle(IN["idx4"], 8), W, H, 4,
                                    B.BI_RLE8, palette=IN["pal"][:16]),
    "rle4 on 8 bits": lambda: B.bmp(B.rle(IN["idx4"], 4), W, H, 8,
                                    B.BI_RLE4, palette=IN["pal"][:16]),
    "jpeg compression": lambda: B.bmp(tjpeg.encode_jpeg(IN["rgb"]), W, H,
                                      24, 4),
    "more than 256 colours": lambda: B.bmp(
        B.pack(IN["idx8"], 8), W, H, 8, palette=IN["pal"], clr_used=300),
    "a 16-byte header": lambda: B.bmp(B.pack(IN["idx8"], 8), W, H, 8,
                                      palette=IN["pal"])[:14]
    + b"\x10\0\0\0" + B.bmp(B.pack(IN["idx8"], 8), W, H, 8,
                            palette=IN["pal"])[18:],
    "rle8 run past its row": lambda: _codes(8, ("run", 8, 1), ("eob",)),
    "rle8 absolute run past its row": lambda: _codes(
        8, ("run", 2, 1), ("abs", [1, 2, 3, 4, 5, 6]), ("eob",)),
    "rle4 run past its row": lambda: _codes(4, ("run", 8, 0x12), ("eob",)),
    "rle4 end of bitmap before the last row": lambda: _codes(
        4, ("run", 2, 0x12), ("eob",)),
    "rle8 without an end": lambda: _codes(8, ("run", 7, 1), ("eol",)),
    "rle8 cut short": lambda: _rle8()[:-40],
    "24-bit cut short": lambda: B.bmp(B.pack(
        IN["rgb"].reshape(H, -1), 8), W, H, 24)[:-7],
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_bmp_variant_cv2_refuses_is_unreadable(tmp_path, name):
    path = tmp_path / "v.bmp"
    data = REFUSED[name]()
    path.write_bytes(data)
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
    assert jio.imread_unit(str(path)) is None
    assert jdata._imread_rgb(str(path)) is None
    for color in (False, True):
        with pytest.raises(ValueError) as e:
            tbmp.decode_bmp(data, color)
        assert not isinstance(e.value, tjpeg.Unsupported)
        assert tio.read_image(str(path), color) == (None, None)
    logged = []
    assert list(tio.decode_iter([path], log=logged.append)) == []
    assert logged == ["warning: unreadable v.bmp"]


def _random_stream(rng, bits, w, h):
    """RLE parts of every kind at random, runs past their row and streams
    without their end among them."""
    parts = []
    for _ in range(int(rng.integers(1, 14))):
        r = rng.random()
        if r < 0.35:
            parts.append(("run", int(rng.integers(1, w + 2)),
                          int(rng.integers(0, 256))))
        elif r < 0.6:
            n = int(rng.integers(3, w + 3))
            parts.append(("abs", rng.integers(0, 256, n).tolist())
                         if bits == 8 else
                         ("abs", n, rng.integers(0, 256,
                                                 (n + 1) // 2).tolist()))
        elif r < 0.8:
            parts.append(("eol",))
        elif r < 0.9:
            parts.append(("delta", int(rng.integers(0, w + 1)),
                          int(rng.integers(0, 3))))
        else:
            parts.append(("eob",))
    if rng.random() < 0.7:
        parts.append(("eob",))
    return B.codes(*parts)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_rle_streams_decode_as_cv2(tmp_path, seed, bits):
    """100 seeded streams a case on frames of 1-8 x 1-5 pixels, top-down
    in some: the port's pixels equal cv2's in both modes, or both give
    None."""
    rng = np.random.default_rng(1000 * seed + bits)
    path = tmp_path / "r.bmp"
    read = 0
    for _ in range(100):
        w, h = int(rng.integers(1, 9)), int(rng.integers(1, 6))
        data = B.bmp(_random_stream(rng, bits, w, h), w, h, bits,
                     B.BI_RLE8 if bits == 8 else B.BI_RLE4,
                     palette=IN["pal"][:20 if bits == 8 else 9],
                     top_down=rng.random() < 0.15)
        path.write_bytes(data)
        for color, flag in ((False, cv2.IMREAD_UNCHANGED),
                            (True, cv2.IMREAD_COLOR)):
            want = cv2.imread(str(path), flag)
            try:
                got = tbmp.decode_bmp(data, color)
            except ValueError:
                got = None
            assert (want is None) == (got is None), (data, color)
            if want is not None:
                read += 1
                np.testing.assert_array_equal(got, _raw_as_rgb(want))
    assert read >= 20  # the streams read are no rarity


@pytest.mark.parametrize("fmt", ["bmp", "tiff"])
def test_sizes_past_cv2s_limits_are_unreadable(tmp_path, fmt):
    """A header past cv2's limits (2**20 a side, 2**30 pixels) makes
    ``cv2.imread`` raise before it reads a byte; the port gives
    ``(None, None)`` without allocating the frame."""
    from tests import torch_tiff as T

    if fmt == "bmp":
        data = B.bmp(B.codes(("eob",)), 40000, 40000, 8, B.BI_RLE8,
                     palette=IN["pal"])
    else:
        data = T.tiff([IN["rgb"]], tags={256: (4, [1 << 21])})
    path = tmp_path / f"big.{fmt}"
    path.write_bytes(data)
    with pytest.raises(cv2.error, match="validateInputImageSize"):
        cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert tio.read_image(str(path)) == (None, None)
