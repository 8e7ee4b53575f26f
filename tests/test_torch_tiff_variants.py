"""The port's TIFF decoder (``utils/tiff.py``) on the variants beyond
8- and 16-bit chunky gray and RGB: the Orientation tag, WhiteIsZero,
palette (with extra samples too), gray + alpha, CMYK, planar files, 1-
and 4-bit samples, fill order 2, old-style LZW, JPEG-in-TIFF (chunky and
planar, every photometric interpretation), files without
StripByteCounts or with counts libtiff doubts, and strips that decode
short.  Each file is built here
(``tests/torch_tiff.py``, or ``cv2.imencode`` where cv2 writes the
variant), 64x96 or smaller, and read by the port in both modes: bit-equal
to ``cv2.imread`` in ``IMREAD_UNCHANGED`` and in ``IMREAD_COLOR``, and
through ``imread_unit`` and ``imread_u8`` to JAX's ``imread_unit`` and
``train/data._imread_rgb``, shapes included.  The variants cv2 refuses
give ``(None, None)`` and are logged "unreadable" by ``decode_iter``."""

import numpy as np
import pytest

import cv2
from tests import torch_jpeg_scans as js
from tests import torch_tiff as T
from underwater_image_enhancement_tpu.train import data as jdata
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import jpeg as tjpeg
from underwater_image_enhancement_tpu_torch.utils import tiff as ttiff

H, W = 37, 53  # 16x16 tiles are cut at the right and bottom edges


def _images():
    """Seeded gradients plus noise: RGB, gray, RGBA (alpha over its whole
    range), CMYK, and their 16-bit forms (times 257, low bytes seeded)."""
    rng = np.random.default_rng(31)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([yy * 5.1, xx * 3.7, (xx + yy) * 2.3 + 20, xx * yy / 8],
                    -1)
    img = np.clip(base + rng.normal(0, 30, (H, W, 4)), 0, 255).astype(
        np.uint8)
    rgb, gray, rgba = img[..., :3], img[..., 0], img
    cmyk = img[..., [1, 2, 0, 3]]
    wide = {k: (v.astype(np.uint16) * 257) ^ rng.integers(
        0, 256, v.shape).astype(np.uint16)
            for k, v in (("rgb", rgb), ("gray", gray), ("rgba", rgba))}
    return dict(rgb=rgb, gray=gray, rgba=rgba, cmyk=cmyk, ga=img[..., :2],
                rgb16=wide["rgb"], gray16=wide["gray"], rgba16=wide["rgba"],
                ga16=wide["rgba"][..., :2])


IMG = _images()


def _raw_as_rgb(img):
    """cv2's array as (H, W, C): gray as one channel, BGR and BGRA as RGB
    and RGBA."""
    if img.ndim == 2:
        return img[..., None]
    return np.concatenate([img[..., 2::-1], img[..., 3:]], -1)


def assert_reads_as_cv2(tmp_path, data):
    """``decode_tiff`` in both modes equals cv2's array there, dtype and
    shape included; the port's ``imread_unit`` and ``imread_u8`` equal
    JAX's ``imread_unit`` and ``_imread_rgb``."""
    path = tmp_path / "v.tif"
    path.write_bytes(data)
    for color, flag in ((False, cv2.IMREAD_UNCHANGED),
                        (True, cv2.IMREAD_COLOR)):
        want = cv2.imread(str(path), flag)
        assert want is not None, "cv2 refuses the file"
        got = ttiff.decode_tiff(data, color)
        want = _raw_as_rgb(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (
            color, got.dtype, got.shape, want.dtype, want.shape)
        np.testing.assert_array_equal(got, want)
    a, b = tio.imread_unit(str(path)), jio.imread_unit(str(path))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    a, b = tio.imread_u8(str(path)), jdata._imread_rgb(str(path))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def assert_refused_as_cv2(tmp_path, data, name="v.tif"):
    """cv2 gives None in both modes, so JAX reads None; the port gives
    ``(None, None)`` (a ValueError, not ``Unsupported``) and
    ``decode_iter`` logs the file "unreadable"."""
    path = tmp_path / name
    path.write_bytes(data)
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
    assert jio.imread_unit(str(path)) is None
    assert jdata._imread_rgb(str(path)) is None
    for color in (False, True):
        with pytest.raises(ValueError) as e:
            ttiff.decode_tiff(data, color)
        assert not isinstance(e.value, tjpeg.Unsupported), e.value
        assert tio.read_image(str(path), color) == (None, None)
    logged = []
    assert list(tio.decode_iter([path], log=logged.append)) == []
    assert logged == [f"warning: unreadable {name}"]


def _cmap(bits, wide=True, seed=0):
    top = 65536 if wide else 256
    return np.random.default_rng(40 + seed).integers(
        0, top, 3 << bits).tolist()


def _index(bits):
    return (IMG["gray"].astype(np.int64) * 7 % (1 << bits)).astype(np.uint8)


def _orient(o):
    return {274: (3, [o])}


def _ycc_jpeg(tables):
    """A JPEG strip or tile of an RGB block as the port's encoder writes
    it (YCbCr 4:2:0, Annex K tables), its tables moved to ``tables``."""
    def code(blk, plane):
        head, chunk = T.jpeg_split(tjpeg.encode_jpeg(np.ascontiguousarray(
            blk)))
        tables[:] = [head]
        return chunk
    return code


def _raw_jpeg(blk, plane):
    """A JPEG strip or tile of a block's own samples, one component a
    sample, no colour conversion."""
    return js.sequential([blk[..., c] for c in range(blk.shape[2])], app=())


def _split_jpeg(tables):
    """``_raw_jpeg`` with its quantisation tables (the same in every chunk;
    the Huffman tables are each chunk's own) moved to ``tables``."""
    def code(blk, plane):
        head, chunk = T.jpeg_split(_raw_jpeg(blk, plane), (0xDB,))
        tables[:] = [head]
        return chunk
    return code


def _jpeg12(blk, plane):
    """``_raw_jpeg`` as a 12-bit extended-sequential frame (SOF1, the same
    coefficients): a valid 12-bit JPEG."""
    data = bytearray(_raw_jpeg(blk, plane))
    at = data.index(b"\xff\xc0")
    data[at + 1], data[at + 4] = 0xC1, 12
    return bytes(data)


def _no_counts(**kw):
    """A file without StripByteCounts (or TileByteCounts)."""
    tile = kw.get("tile")
    return T.tiff([kw.pop("img", IMG["rgb"])], tags={
        325 if tile else 279: None, **kw.pop("tags", {})}, **kw)


def _counts(counts, **kw):
    """A file of strips whose StripByteCounts are ``counts(true counts)``."""
    true = ttiff._directory(T.tiff([IMG["rgb"]], **kw))[279]
    return T.tiff([IMG["rgb"]], tags={279: (4, counts(list(true)))}, **kw)


def _palette_extra(bits=8, extra=(2,), samples=2, **kw):
    """A palette file of ``samples`` samples a pixel: the index, then the
    alpha and the other planes; tag 338 ``extra`` (None: no tag)."""
    planes = [_index(bits)] + [IMG["rgba"][..., 3 - k] >> (8 - bits)
                               for k in range(samples - 1)]
    tags = {320: (3, _cmap(bits)), **kw.pop("tags", {})}
    if extra is not None:
        tags[338] = (3, list(extra))
    return T.tiff([np.stack(planes, -1)], bits=bits, photometric=3,
                  tags=tags, **kw)


def _jpeg_tiff(img, photometric, tags=None, **kw):
    if photometric == 6:
        tables = []
        T.tiff([img], compression=7, photometric=6, jpeg=_ycc_jpeg(tables),
               **kw)
        return T.tiff([img], compression=7, photometric=6,
                      jpeg=_ycc_jpeg([]), tags={347: (7, tables[0]),
                                                530: (3, [2, 2]),
                                                **(tags or {})}, **kw)
    return T.tiff([img], compression=7, photometric=photometric,
                  jpeg=lambda blk, p: js.sequential(
                      [blk[..., c] for c in range(blk.shape[2])], app=()),
                  **kw)


# the variants the port reads: name -> file
READ = {
    # Orientation 2-4: the image flipped, in both modes, at 8 and 16 bits
    **{f"orientation {o} rgb strips": (lambda o=o: T.tiff(
        [IMG["rgb"]], rows_per_strip=8, compression=5, tags=_orient(o)))
       for o in (2, 3, 4)},
    **{f"orientation {o} rgb tiles big-endian": (lambda o=o: T.tiff(
        [IMG["rgb"]], ">", tile=(16, 16), tags=_orient(o)))
       for o in (2, 3, 4)},
    **{f"orientation {o} gray tiles": (lambda o=o: T.tiff(
        [IMG["gray"]], tile=(32, 16), compression=8, tags=_orient(o)))
       for o in (2, 3, 4)},
    **{f"orientation {o} rgb16 strips big-endian": (lambda o=o: T.tiff(
        [IMG["rgb16"]], ">", rows_per_strip=5, tags=_orient(o)))
       for o in (2, 3, 4)},
    **{f"orientation {o} rgba16 tiles": (lambda o=o: T.tiff(
        [IMG["rgba16"]], tile=(16, 32), compression=5, predictor=2,
        tags={**_orient(o), 338: (3, [2])})) for o in (2, 3, 4)},
    **{f"orientation {o} gray16 tiles": (lambda o=o: T.tiff(
        [IMG["gray16"]], tile=(16, 16), tags=_orient(o)))
       for o in (2, 3, 4)},
    "orientation 3 rgba unassociated": lambda: T.tiff(
        [IMG["rgba"]], tags={**_orient(3), 338: (3, [2])}),
    # values outside 1-8: libtiff refuses the tag and reads top-left
    "orientation 0": lambda: T.tiff([IMG["rgb"]], tags=_orient(0)),
    "orientation 9": lambda: T.tiff([IMG["gray16"]], tags=_orient(9)),
    # WhiteIsZero: 255 - v; at 16 bits the samples as they are in
    # IMREAD_UNCHANGED, 255 - (v >> 8) in IMREAD_COLOR
    "white is zero": lambda: T.tiff([IMG["gray"]], photometric=0),
    "white is zero tiles big-endian lzw": lambda: T.tiff(
        [IMG["gray"]], ">", tile=(16, 16), compression=5, photometric=0),
    "white is zero 16": lambda: T.tiff([IMG["gray16"]], photometric=0),
    "white is zero 16 tiles": lambda: T.tiff(
        [IMG["gray16"]], ">", tile=(16, 16), photometric=0),
    "white is zero and alpha": lambda: T.tiff(
        [IMG["ga"]], photometric=0, tags={338: (3, [2])}),
    # palette: cvtcmap's high bytes, checkcmap's 8-bit colormap
    "palette": lambda: T.tiff([_index(8)], photometric=3,
                              tags={320: (3, _cmap(8))}),
    "palette 8-bit colormap": lambda: T.tiff(
        [_index(8)], photometric=3, tags={320: (3, _cmap(8, False))}),
    "palette tiles big-endian lzw": lambda: T.tiff(
        [_index(8)], ">", tile=(16, 16), compression=5, photometric=3,
        tags={320: (3, _cmap(8, seed=1))}),
    "palette 4-bit": lambda: T.tiff([_index(4)], bits=4, photometric=3,
                                    tags={320: (3, _cmap(4))}),
    "palette 4-bit tiles packbits": lambda: T.tiff(
        [_index(4)], tile=(16, 16), bits=4, compression=32773,
        photometric=3, tags={320: (3, _cmap(4, False))}),
    "palette 1-bit": lambda: T.tiff([_index(1)], bits=1, photometric=3,
                                    tags={320: (3, _cmap(1))}),
    "palette 1-bit 8-bit colormap tiles": lambda: T.tiff(
        [_index(1)], ">", tile=(32, 16), bits=1, photometric=3,
        tags={320: (3, _cmap(1, False))}),
    # gray + alpha: the gray alone, nothing premultiplied (chunky)
    "gray and alpha": lambda: T.tiff([IMG["ga"]]),
    **{f"gray and alpha extra {e}": (lambda e=e: T.tiff(
        [IMG["ga"]], tags={338: (3, [e])})) for e in (0, 1, 2)},
    "gray and alpha tiles": lambda: T.tiff(
        [IMG["ga"]], tile=(16, 16), tags={338: (3, [2])}),
    "gray and alpha 16": lambda: T.tiff([IMG["ga16"]],
                                        tags={338: (3, [2])}),
    "gray and alpha 16 tiles": lambda: T.tiff(
        [IMG["ga16"]], ">", tile=(16, 16), compression=8,
        tags={338: (3, [1])}),
    "gray and alpha planar unassociated": lambda: T.tiff(
        [IMG["ga"]], planar=2, tags={338: (3, [2])}),
    "gray and alpha planar associated": lambda: T.tiff(
        [IMG["ga"]], planar=2, rows_per_strip=8, tags={338: (3, [1])}),
    "gray and alpha 16 planar": lambda: T.tiff(
        [IMG["ga16"]], planar=2, tile=(16, 16), tags={338: (3, [2])}),
    "white is zero and alpha planar": lambda: T.tiff(
        [IMG["ga"]], photometric=0, planar=2, tags={338: (3, [2])}),
    "gray of 3 samples tiles": lambda: T.tiff(
        [IMG["rgb"]], photometric=1, tile=(16, 16)),
    # CMYK: (255 - c) * (255 - k) / 255, alpha 255
    "cmyk": lambda: T.tiff([IMG["cmyk"]], photometric=5),
    "cmyk tiles big-endian lzw predictor": lambda: T.tiff(
        [IMG["cmyk"]], ">", tile=(16, 16), compression=5, predictor=2,
        photometric=5),
    "cmyk planar": lambda: T.tiff([IMG["cmyk"]], planar=2, photometric=5,
                                  rows_per_strip=6),
    # planar: each sample's plane in strips or tiles of its own
    "planar rgb": lambda: T.tiff([IMG["rgb"]], planar=2),
    "planar rgb tiles big-endian": lambda: T.tiff(
        [IMG["rgb"]], ">", planar=2, tile=(16, 16)),
    "planar rgb lzw predictor strips": lambda: T.tiff(
        [IMG["rgb"]], planar=2, compression=5, predictor=2,
        rows_per_strip=8),
    "planar rgba unassociated": lambda: T.tiff(
        [IMG["rgba"]], planar=2, compression=8, tags={338: (3, [2])}),
    # 1-bit gray: v * 255, one channel; 4-bit gray is refused below
    "1-bit black is zero": lambda: T.tiff([_index(1)], bits=1),
    "1-bit white is zero tiles": lambda: T.tiff(
        [_index(1)], tile=(16, 16), bits=1, photometric=0),
    "1-bit strips of 5 rows packbits": lambda: T.tiff(
        [_index(1)], ">", bits=1, rows_per_strip=5, compression=32773),
    # fill order 2: each strip's bits reversed before the codec
    **{f"fill order 2 compression {c}": (lambda c=c: T.tiff(
        [IMG["rgb"]], compression=c, fill_order=2, rows_per_strip=9))
       for c in (1, 5, 8, 32773)},
    "fill order 2 16-bit lzw predictor": lambda: T.tiff(
        [IMG["rgb16"]], ">", compression=5, predictor=2, fill_order=2),
    "fill order 2 1-bit tiles": lambda: T.tiff(
        [_index(1)], tile=(16, 16), bits=1, fill_order=2, compression=5),
    # old-style LZW: LSB-first codes, one code later to widen
    "old-style lzw": lambda: T.tiff([IMG["rgb"]], compression="lzw-old"),
    "old-style lzw predictor strips": lambda: T.tiff(
        [IMG["rgb"]], compression="lzw-old", predictor=2,
        rows_per_strip=5),
    "old-style lzw 16 big-endian": lambda: T.tiff(
        [IMG["rgb16"]], ">", compression="lzw-old"),
    "old-style lzw gray tiles": lambda: T.tiff(
        [IMG["gray"]], tile=(16, 16), compression="lzw-old"),
    # JPEG (compression 7): gray and RGB chunks whole, YCbCr with their
    # tables in JPEGTables
    "jpeg gray of cv2": lambda: cv2.imencode(
        ".tif", IMG["gray"], [cv2.IMWRITE_TIFF_COMPRESSION, 7])[1].tobytes(),
    "jpeg gray tiles": lambda: _jpeg_tiff(IMG["gray"], 1, tile=(16, 16)),
    "jpeg rgb strips": lambda: _jpeg_tiff(IMG["rgb"], 2, rows_per_strip=16),
    "jpeg ycbcr strips": lambda: _jpeg_tiff(IMG["rgb"], 6,
                                            rows_per_strip=16),
    "jpeg ycbcr one strip big-endian": lambda: _jpeg_tiff(
        IMG["rgb"], 6, order=">"),
    "jpeg ycbcr tiles": lambda: _jpeg_tiff(IMG["rgb"], 6, tile=(16, 16)),
    "jpeg ycbcr orientation 2": lambda: _jpeg_tiff(
        IMG["rgb"], 6, tags=_orient(2), rows_per_strip=8),
    # JPEG of any photometric interpretation, chunky or planar: libtiff
    # has libjpeg decode each chunk's own components (one a chunk when
    # planar), then its RGBA reader takes them as it takes uncompressed
    # samples
    "jpeg planar rgb": lambda: T.tiff([IMG["rgb"]], compression=7,
                                      photometric=2, planar=2,
                                      jpeg=_raw_jpeg),
    "jpeg planar rgb strips big-endian": lambda: T.tiff(
        [IMG["rgb"]], ">", compression=7, photometric=2, planar=2,
        rows_per_strip=16, jpeg=_raw_jpeg),
    "jpeg planar rgb tiles": lambda: T.tiff(
        [IMG["rgb"]], compression=7, photometric=2, planar=2,
        tile=(16, 16), jpeg=_raw_jpeg),
    "jpeg planar rgb tables": lambda: _jpeg_tables(planar=2,
                                                   rows_per_strip=16),
    "jpeg planar rgba": lambda: T.tiff(
        [IMG["rgba"]], compression=7, photometric=2, planar=2,
        jpeg=_raw_jpeg, tags={338: (3, [2])}),
    "jpeg planar ycbcr 1x1": lambda: T.tiff(
        [IMG["rgb"]], compression=7, photometric=6, planar=2,
        tile=(16, 16), jpeg=_raw_jpeg, tags={530: (3, [1, 1])}),
    "jpeg cmyk": lambda: T.tiff([IMG["cmyk"]], compression=7,
                                photometric=5, jpeg=_raw_jpeg),
    "jpeg cmyk strips tables": lambda: _jpeg_tables(
        img=IMG["cmyk"], photometric=5, rows_per_strip=16),
    "jpeg cmyk planar": lambda: T.tiff([IMG["cmyk"]], compression=7,
                                       photometric=5, planar=2,
                                       jpeg=_raw_jpeg),
    # libtiff asks libjpeg for no conversion: Adobe's YCCK transform flag
    # changes nothing
    "jpeg cmyk adobe ycck": lambda: T.tiff(
        [IMG["cmyk"]], compression=7, photometric=5,
        jpeg=lambda blk, p: js.sequential(
            [blk[..., c] for c in range(4)], app=(js.adobe(2),))),
    "jpeg gray and alpha": lambda: T.tiff(
        [IMG["ga"]], compression=7, jpeg=_raw_jpeg, tags={338: (3, [2])}),
    "jpeg gray of 3 samples planar": lambda: T.tiff(
        [IMG["rgb"]], compression=7, photometric=1, planar=2,
        jpeg=_raw_jpeg),
    "jpeg white is zero": lambda: T.tiff([IMG["gray"]], compression=7,
                                         photometric=0, jpeg=_raw_jpeg),
    "jpeg palette": lambda: T.tiff([_index(8)], compression=7,
                                   photometric=3, jpeg=_raw_jpeg,
                                   tags={320: (3, _cmap(8))}),
    "jpeg cielab": lambda: T.tiff([IMG["rgb"]], compression=7,
                                  photometric=8, jpeg=_raw_jpeg),
    # a Colormap of another count than 3 * 2**bits is ignored, and a
    # palette file of 8 bits and up without one reads as gray
    **{f"palette colormap of {n} values": (lambda n=n: T.tiff(
        [_index(8)], photometric=3, tags={320: (3, _cmap(8)[:n])}))
       for n in (0, 763)},
    "palette colormap of 771 values": lambda: T.tiff(
        [_index(8)], photometric=3,
        tags={320: (3, _cmap(8) + [1, 2, 3])}),
    "palette without colormap 16": lambda: T.tiff([IMG["gray16"]],
                                                  photometric=3),
    "palette without colormap and extra": lambda: T.tiff(
        [IMG["ga"]], photometric=3, tags={338: (3, [2])}),
    # palette + extra samples: the index mapped, the rest ignored (8-bit
    # chunky only); libtiff takes samples past the first as extra where
    # tag 338 is missing; tiles cut at the right edge with
    # put8bitcmaptile's row step
    **{f"palette and extra {e}": (lambda e=e: _palette_extra(extra=(e,)))
       for e in (0, 1, 2)},
    "palette and extra sample untagged": lambda: _palette_extra(extra=None),
    "palette and 2 extra samples": lambda: _palette_extra(extra=(2, 0),
                                                          samples=3),
    "palette and 3 extra samples": lambda: _palette_extra(
        extra=(1, 0, 0), samples=4),
    "palette and extra tiles lzw": lambda: _palette_extra(
        tile=(16, 16), compression=5),
    "palette and extra tiles big-endian": lambda: _palette_extra(
        extra=(1,), order=">", tile=(32, 16)),
    "palette and extra orientation 3": lambda: _palette_extra(
        tags=_orient(3)),
    # no StripByteCounts: one strip (or one a plane, or one tile), its
    # count estimated as libtiff's EstimateStripByteCounts does: the
    # strip's rows uncompressed, else the file less its directory (over
    # the planes, which cuts the planes that coded longer: their tails
    # read as zeros)
    **{f"no byte counts compression {c}": (lambda c=c: _no_counts(
        compression=c)) for c in (1, 5, 8, 32773)},
    "no byte counts lzw predictor gray": lambda: _no_counts(
        img=IMG["gray"], compression=5, predictor=2),
    "no byte counts deflate 16": lambda: _no_counts(
        img=IMG["rgb16"], compression=8, predictor=2),
    "no byte counts big-endian packbits": lambda: _no_counts(
        order=">", compression=32773),
    "no byte counts bigtiff lzw": lambda: _no_counts(compression=5,
                                                     big=True),
    **{f"no byte counts planar compression {c}": (lambda c=c: _no_counts(
        planar=2, compression=c)) for c in (1, 5, 8, 32773)},
    "no byte counts planar bigtiff deflate": lambda: _no_counts(
        planar=2, compression=8, big=True),
    "no byte counts one tile lzw": lambda: _no_counts(tile=(64, 48),
                                                      compression=5),
    "no byte counts one tile a plane": lambda: _no_counts(
        img=IMG["rgb"][:32, :48], planar=2, tile=(48, 32)),
    "no byte counts jpeg cmyk": lambda: _no_counts(
        img=IMG["cmyk"], compression=7, photometric=5, jpeg=_raw_jpeg),
    # uncompressed 2x2 YCbCr of an odd height: the estimate (a scanline a
    # row) falls short of the strip, which reads as zeros
    "no byte counts ycbcr odd height": lambda: _no_counts(photometric=6),
    # ByteCountLooksBad: one strip's count of 0, or, uncompressed, past
    # the file's end or short of its rows, is estimated anew
    "count 0 one strip lzw": lambda: _counts(lambda c: [0], compression=5),
    "count 0 one strip": lambda: _counts(lambda c: [0]),
    "count short one strip": lambda: _counts(lambda c: [c[0] // 2]),
    "count past the end one strip": lambda: _counts(
        lambda c: [c[0] + 10 ** 6]),
    # a strip that decodes short: the RGBA reader goes on with zeros where
    # LZW, Deflate and PackBits stop, and a whole strip of zeros
    # uncompressed
    **{f"second strip cut compression {c}": (lambda c=c: _counts(
        lambda n: [n[0], n[1] * 2 // 3], compression=c, rows_per_strip=20))
       for c in (1, 5, 8, 32773)},
}


def _jpeg_tables(img=None, photometric=2, **kw):
    """A JPEG file of raw-component chunks, their quantisation tables in
    JPEGTables."""
    img = IMG["rgb"] if img is None else img
    tables = []
    T.tiff([img], compression=7, photometric=photometric,
           jpeg=_split_jpeg(tables), **kw)
    return T.tiff([img], compression=7, photometric=photometric,
                  jpeg=_split_jpeg([]), tags={347: (7, tables[0])}, **kw)


@pytest.mark.parametrize("name", sorted(READ))
def test_tiff_variant_reads_as_cv2(tmp_path, name):
    assert_reads_as_cv2(tmp_path, READ[name]())


# the variants cv2 refuses (imread gives None in both modes)
REFUSED = {
    **{f"orientation {o}": (lambda o=o: T.tiff(
        [IMG["rgb"]], tags=_orient(o))) for o in (5, 6, 7, 8)},
    "orientation 6 rgb16 tiles": lambda: T.tiff(
        [IMG["rgb16"]], tile=(16, 16), tags=_orient(6)),
    "orientation 7 gray16": lambda: T.tiff([IMG["gray16"]],
                                           tags=_orient(7)),
    "orientation 8 palette": lambda: T.tiff(
        [_index(8)], photometric=3, tags={320: (3, _cmap(8)),
                                          **_orient(8)}),
    "palette 16-bit": lambda: T.tiff(
        [IMG["gray16"]], photometric=3,
        tags={320: (3, (np.arange(3 << 16) % 65536).tolist())}),
    "palette 2-bit": lambda: T.tiff([_index(2)], bits=2, photometric=3,
                                    tags={320: (3, _cmap(2))}),
    "gray 2-bit": lambda: T.tiff([_index(2)], bits=2),
    "gray 4-bit": lambda: T.tiff([_index(4)], bits=4),
    "cmyk 16": lambda: T.tiff([IMG["rgba16"]], photometric=5),
    "cmyk 5 samples": lambda: T.tiff(
        [np.concatenate([IMG["cmyk"], IMG["ga"][..., 1:]], -1)],
        photometric=5, tags={338: (3, [2])}),
    "cmyk 3 samples": lambda: T.tiff([IMG["rgb"]], photometric=5),
    "rgb 1-bit": lambda: T.tiff([IMG["rgb"] >> 7], bits=1),
    "rgb of 2 samples": lambda: T.tiff([IMG["ga"]], photometric=2),
    "rgb of 5 samples": lambda: T.tiff(
        [np.concatenate([IMG["rgba"], IMG["ga"][..., :1]], -1)]),
    "bits differ": lambda: T.tiff([IMG["rgb"]], tags={258: (3, [8, 8, 16])}),
    "24-bit gray": lambda: T.tiff([IMG["rgb"]], photometric=1, tags={
        258: (3, [24]), 277: (3, [1])}),
    "predictor 3 on integers": lambda: T.tiff([IMG["rgb"]], compression=5,
                                              predictor=3),
    "predictor 2 on 1-bit": lambda: T.tiff([_index(1)], bits=1,
                                           compression=5, predictor=2),
    "jpeg without its tables": lambda: T.tiff(
        [IMG["rgb"]], compression=7, photometric=6, jpeg=_ycc_jpeg([])),
    "old-style jpeg": lambda: T.tiff(
        [IMG["rgb"]], compression=6, photometric=6,
        jpeg=lambda blk, p: tjpeg.encode_jpeg(np.ascontiguousarray(blk))),
    **{f"compression {c}": (lambda c=c: T.tiff([IMG["rgb"]],
                                               tags={259: (3, [c])}))
       for c in (34925, 50000, 50001)},
    **{f"photometric {p}": (lambda p=p: T.tiff([IMG["rgb"]], photometric=p))
       for p in (9, 10)},
    "transparency mask": lambda: T.tiff([_index(1)], bits=1, photometric=4),
    "logl without sgilog": lambda: T.tiff([IMG["gray"]], photometric=32844),
    # no PhotometricInterpretation: OpenCV's readHeader fails
    **{f"no photometric {k}": (lambda k=k: T.tiff([IMG[k]],
                                                   tags={262: None}))
       for k in ("gray", "rgb", "gray16", "rgb16")},
    # predictors libtiff does not set up
    **{f"predictor {p}": (lambda p=p: T.tiff([IMG["rgb"]], compression=5,
                                             tags={317: (3, [p])}))
       for p in (4, 34892, 34893, 34894, 34895)},
    # codecs cv2's libtiff is built without
    **{f"compression {c}": (lambda c=c: T.tiff([IMG["rgb"]],
                                               tags={259: (3, [c])}))
       for c in (32909, 34661, 34887)},
    "jpeg 12-bit": lambda: T.tiff([IMG["gray"]], bits=12, compression=7,
                                  jpeg=_jpeg12),
    "jpeg 12-bit rgb": lambda: T.tiff([IMG["rgb"]], bits=12, compression=7,
                                      photometric=2, jpeg=_jpeg12),
    "jpeg planar ycbcr 2x2": lambda: T.tiff(
        [IMG["rgb"]], compression=7, photometric=6, planar=2,
        jpeg=_raw_jpeg),
    "jpeg planar cielab": lambda: T.tiff([IMG["rgb"]], compression=7,
                                         photometric=8, planar=2,
                                         jpeg=_raw_jpeg),
    # a palette file without its colormap: under 8 bits, or of 3 samples
    # (read as RGB of one colour channel)
    "palette 4-bit without colormap": lambda: T.tiff(
        [_index(4)], bits=4, photometric=3),
    "palette without colormap of 3 samples": lambda: T.tiff(
        [IMG["rgb"]], photometric=3),
    # palette + extra samples, planar or under 8 bits
    "palette and extra planar": lambda: _palette_extra(planar=2),
    **{f"palette {b}-bit and extra": (lambda b=b: _palette_extra(bits=b))
       for b in (1, 4)},
    # no StripByteCounts and more than one strip a plane, or tiles
    **{f"no byte counts strips compression {c}": (lambda c=c: _no_counts(
        compression=c, rows_per_strip=8)) for c in (1, 5)},
    "no byte counts planar strips": lambda: _no_counts(
        planar=2, compression=8, rows_per_strip=8),
    "no byte counts tiles": lambda: _no_counts(tile=(16, 16),
                                               compression=5),
    # a strip libtiff cannot fill: no bytes, or past the file's end
    "count past the end lzw": lambda: _counts(
        lambda c: [c[0] + 10 ** 6], compression=5),
    "count 0 second strip": lambda: _counts(lambda c: [c[0], 0],
                                            rows_per_strip=20),
    "count 0 planar": lambda: _counts(lambda c: [0, 0, 0], planar=2),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_tiff_variant_cv2_refuses_is_unreadable(tmp_path, name):
    assert_refused_as_cv2(tmp_path, REFUSED[name]())


def test_tiff16_planar_reads_its_samples(tmp_path):
    """cv2's own 16-bit path reads a planar file as chunky: the first
    plane's samples fill the image's first rows and the rest is memory it
    never wrote, which differs from call to call.  The port reads the
    samples in IMREAD_UNCHANGED, and equals cv2 in IMREAD_COLOR (libtiff's
    RGBA reader, which reads planes)."""
    rgb = IMG["rgb16"]
    data = T.tiff([rgb], planar=2)
    path = tmp_path / "p.tif"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    rows = (H * W) // (3 * W)
    np.testing.assert_array_equal(
        want[..., ::-1][:rows].reshape(-1),
        rgb[..., 0].reshape(-1)[:rows * W * 3])
    np.testing.assert_array_equal(ttiff.decode_tiff(data), rgb)
    np.testing.assert_array_equal(
        ttiff.decode_tiff(data, True),
        cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1])


def test_tiff16_palette_without_colormap_of_3_samples(tmp_path):
    """libtiff reads a 16-bit palette file of 3 samples without its
    colormap as RGB of one colour channel: cv2's own path reads the
    samples in IMREAD_UNCHANGED, the RGBA reader refuses it in
    IMREAD_COLOR."""
    data = T.tiff([IMG["rgb16"]], photometric=3)
    path = tmp_path / "p.tif"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(ttiff.decode_tiff(data), want[..., ::-1])
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="without its colormap"):
        ttiff.decode_tiff(data, True)


def test_old_style_lzw_widens_a_code_later():
    """The old style's codes are read least significant bit first and
    widen once the table holds 2**bits entries: a run long enough to pass
    512 and 1024 entries decodes, and the new style's decoder reading the
    old style's stream would not give it."""
    raw = np.random.default_rng(5).integers(0, 256, 6000, np.uint8).tobytes()
    old = T.lzw_old(raw)
    assert old[0] == 0 and old[1] & 1
    assert ttiff._lzw_decode(old, len(raw)) == raw
    assert ttiff._lzw_decode(ttiff._lzw_encode(raw), len(raw)) == raw
