"""The port's TIFF decoder (``utils/tiff.py``) on the sample types that
cv2 reads through its own path and the RGBA reader's: float32 and
float64 (predictors 1, 2 and 3), signed 8- and 16-bit, 10-, 12- and
14-bit, 32- and 64-bit integers, 16-bit gray with 2 or 3 extra samples,
BigTIFF, and compressions libtiff does not know (JPEG 2000 among them),
which read as zero samples.  Each file is built by ``tests/torch_tiff.py``
at 37x53 or smaller and read by the port in both modes: bit-equal and
dtype-equal to ``cv2.imread`` in ``IMREAD_UNCHANGED`` and
``IMREAD_COLOR`` (and to ``cv2.imdecode`` where it reads the file), or
refused with ValueError where cv2 gives None; through ``imread_unit``
and ``imread_u8`` equal to JAX's ``imread_unit`` and
``train/data._imread_rgb``, or, where JAX's ``cvtColor`` raises, named
by ``read_image`` and logged "unsupported by the port" by
``decode_iter``."""

import cv2
import numpy as np
import pytest

from tests import torch_tiff as T
from underwater_image_enhancement_tpu.train import data as jdata
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import jpeg as tjpeg
from underwater_image_enhancement_tpu_torch.utils import tiff as ttiff

H, W = 37, 53  # 16x16 tiles are cut at the right and bottom edges


def _images():
    """Seeded samples of every type: floats over -20..300 (and the u8
    frame's 0-255), signed and unsigned integers over their whole
    ranges, 10-, 12- and 14-bit values."""
    rng = np.random.default_rng(61)
    f = (rng.random((H, W, 4)) * 320 - 20).astype(np.float32)
    out = {"f32": f, "f64": f.astype(np.float64) / 3,
           "u8": rng.integers(0, 256, (H, W, 4)).astype(np.uint8)}
    for name, dt in (("i8", np.int8), ("i16", np.int16), ("u16", np.uint16),
                     ("u32", np.uint32), ("i32", np.int32),
                     ("u64", np.uint64), ("i64", np.int64)):
        info = np.iinfo(dt)
        out[name] = rng.integers(info.min, info.max, (H, W, 4),
                                 dtype=dt, endpoint=True)
    for bits in (10, 12, 14):
        out[f"u{bits}"] = rng.integers(0, 1 << bits, (H, W, 4)).astype(
            np.uint16)
    return out


IMG = _images()


def _c(name, c):
    """``name``'s first ``c`` samples, (H, W) for one."""
    a = IMG[name]
    return a[..., 0] if c == 1 else a[..., :c]


def _raw_as_rgb(img):
    if img.ndim == 2:
        return img[..., None]
    return np.concatenate([img[..., 2::-1], img[..., 3:]], -1)


def _jax_raises(path) -> bool:
    try:
        jio.imread_unit(str(path))
    except cv2.error:
        return True
    return False


def assert_reads_as_cv2(tmp_path, data, name="v.tif"):
    """``decode_tiff`` in both modes equals ``cv2.imread`` there (and
    ``cv2.imdecode`` where it reads the file), dtype and shape included,
    or raises ValueError (not ``Unsupported``) where cv2 gives None; the
    port's ``imread_unit`` and ``imread_u8`` equal JAX's, or the port
    names the file where JAX's channel handling raises.  Returns cv2's
    modes cv2 reads the file in."""
    path = tmp_path / name
    path.write_bytes(data)
    read = []
    for color, flag in ((False, cv2.IMREAD_UNCHANGED),
                        (True, cv2.IMREAD_COLOR)):
        want = cv2.imread(str(path), flag)
        mem = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        if want is None:
            with pytest.raises(ValueError) as e:
                ttiff.decode_tiff(data, color)
            assert not isinstance(e.value, tjpeg.Unsupported), e.value
            continue
        want = _raw_as_rgb(want)
        read.append(flag)
        got = ttiff.decode_tiff(data, color)
        assert got.dtype == want.dtype and got.shape == want.shape, (
            color, got.dtype, got.shape, want.dtype, want.shape)
        np.testing.assert_array_equal(got, want)
        if mem is not None:
            np.testing.assert_array_equal(_raw_as_rgb(mem), want)
    if _jax_raises(path):
        why = tio.read_image(str(path))[1]
        assert why.endswith("TIFF, on which the JAX reader raises"), why
        logged = []
        assert list(tio.decode_iter([path], log=logged.append)) == []
        assert logged == [f"warning: {name} unsupported by the port: {why}"]
    else:
        a, b = tio.imread_unit(str(path)), jio.imread_unit(str(path))
        assert (a is None) == (b is None)
        if b is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    a, b = tio.imread_u8(str(path)), jdata._imread_rgb(str(path))
    assert (a is None) == (b is None)
    if b is not None:
        np.testing.assert_array_equal(a, b)
    return read


def _orient(o):
    return {274: (3, [o])}


# files read by cv2's own path in IMREAD_UNCHANGED (and refused, or read
# by libtiff's RGBA reader, in IMREAD_COLOR): name -> file
FLOAT = {
    "f32 gray": lambda: T.tiff([_c("f32", 1)]),
    "f32 rgb": lambda: T.tiff([_c("f32", 3)]),
    "f32 rgba": lambda: T.tiff([_c("f32", 4)], tags={338: (3, [2])}),
    "f32 gray of 3 samples": lambda: T.tiff([_c("f32", 3)], photometric=1),
    "f32 rgb big-endian lzw": lambda: T.tiff([_c("f32", 3)], ">",
                                             compression=5),
    "f32 rgb deflate predictor 3 strips": lambda: T.tiff(
        [_c("f32", 3)], compression=8, predictor=3, rows_per_strip=5),
    "f32 gray lzw predictor 3 big-endian": lambda: T.tiff(
        [_c("f32", 1)], ">", compression=5, predictor=3, rows_per_strip=7),
    "f32 rgba adobe deflate predictor 3 tiles": lambda: T.tiff(
        [_c("f32", 4)], tile=(16, 16), compression=32946, predictor=3),
    "f32 rgb lzw predictor 3 tiles big-endian": lambda: T.tiff(
        [_c("f32", 3)], ">", tile=(32, 16), compression=5, predictor=3),
    "f32 rgb lzw predictor 2": lambda: T.tiff([_c("f32", 3)],
                                              compression=5, predictor=2),
    "f32 gray deflate predictor 2 tiles big-endian": lambda: T.tiff(
        [_c("f32", 1)], ">", tile=(16, 16), compression=8, predictor=2),
    "f32 rgb packbits tiles": lambda: T.tiff([_c("f32", 3)], tile=(16, 32),
                                             compression=32773),
    "f32 gray fill order 2 lzw": lambda: T.tiff(
        [_c("f32", 1)], compression=5, fill_order=2),
    **{f"f32 rgb orientation {o}": (lambda o=o: T.tiff(
        [_c("f32", 3)], rows_per_strip=8, tags=_orient(o)))
       for o in (2, 3, 4)},
    **{f"f32 gray tiles orientation {o}": (lambda o=o: T.tiff(
        [_c("f32", 1)], tile=(16, 16), compression=8, predictor=3,
        tags=_orient(o))) for o in (2, 3, 4)},
    "f64 gray deflate predictor 3": lambda: T.tiff(
        [_c("f64", 1)], compression=8, predictor=3),
    "f64 rgb big-endian": lambda: T.tiff([_c("f64", 3)], ">"),
    "f64 rgba tiles lzw predictor 2": lambda: T.tiff(
        [_c("f64", 4)], tile=(16, 16), compression=5, predictor=2),
    "f64 rgb lzw predictor 3 big-endian strips": lambda: T.tiff(
        [_c("f64", 3)], ">", compression=5, predictor=3, rows_per_strip=4),
    # the u8 frame's samples as floats: imread_unit reads them as the PNG
    "f32 of a u8 frame": lambda: T.tiff(
        [_c("u8", 3).astype(np.float32)], compression=8, predictor=3),
}

INTEGER = {
    **{f"{t} {k}": (lambda t=t, c=c: T.tiff([_c(t, c)],
                                            tags={338: (3, [2])} if c in (2, 4)
                                            else None))
       for t in ("i8", "i16", "u32", "i32", "u64", "i64")
       for k, c in (("gray", 1), ("gray and alpha", 2), ("rgb", 3),
                    ("rgba", 4)) if c != 2 or t in ("i8", "i16")},
    "i8 rgb tiles lzw predictor 2": lambda: T.tiff(
        [_c("i8", 3)], tile=(16, 16), compression=5, predictor=2),
    "i8 gray orientation 3": lambda: T.tiff([_c("i8", 1)],
                                            tags=_orient(3)),
    "i8 gray white is zero": lambda: T.tiff([_c("i8", 1)], photometric=0),
    "i16 rgb big-endian tiles lzw predictor 2": lambda: T.tiff(
        [_c("i16", 3)], ">", tile=(16, 16), compression=5, predictor=2),
    "i16 gray tiles deflate": lambda: T.tiff([_c("i16", 1)], tile=(16, 16),
                                             compression=8),
    "i16 gray of 3 samples": lambda: T.tiff([_c("i16", 3)], photometric=1),
    "i16 rgb orientation 2": lambda: T.tiff([_c("i16", 3)],
                                            tags=_orient(2)),
    "i16 gray and alpha planar": lambda: T.tiff(
        [_c("i16", 2)], planar=2, tags={338: (3, [2])}),
    "u32 rgb big-endian lzw predictor 2": lambda: T.tiff(
        [_c("u32", 3)], ">", compression=5, predictor=2),
    "i32 gray tiles deflate": lambda: T.tiff([_c("i32", 1)], tile=(16, 16),
                                             compression=8),
    "u64 gray big-endian predictor 2": lambda: T.tiff(
        [_c("u64", 1)], ">", compression=8, predictor=2),
}

PACKED = {
    **{f"{bits}-bit {k}": (lambda bits=bits, c=c: T.tiff(
        [_c(f"u{bits}", c)], bits=bits, photometric=1 if c == 1 else 2))
       for bits in (10, 12, 14) for k, c in (("gray", 1), ("rgb", 3),
                                             ("rgba", 4))},
    **{f"{bits}-bit rgb tiles big-endian lzw": (lambda bits=bits: T.tiff(
        [_c(f"u{bits}", 3)], ">", bits=bits, tile=(16, 16), compression=5))
       for bits in (10, 12, 14)},
    **{f"{bits}-bit gray strips deflate": (lambda bits=bits: T.tiff(
        [_c(f"u{bits}", 1)], bits=bits, rows_per_strip=6, compression=8))
       for bits in (10, 12, 14)},
    "12-bit orientation 3": lambda: T.tiff([_c("u12", 3)], bits=12,
                                           tags=_orient(3)),
    "12-bit white is zero packbits": lambda: T.tiff(
        [_c("u12", 1)], bits=12, photometric=0, compression=32773),
    **{f"{bits}-bit signed {k}": (lambda bits=bits, c=c: T.tiff(
        [_c(f"u{bits}", c)], bits=bits, photometric=1 if c == 1 else 2,
        tags={339: (3, [2] * c)})) for bits in (10, 12, 14)
       for k, c in (("gray", 1), ("rgb", 3))},
}

EXTRA = {
    "u16 gray of 3 samples": lambda: T.tiff([_c("u16", 3)], photometric=1),
    "u16 gray of 4 samples": lambda: T.tiff([_c("u16", 4)], photometric=1),
    "u16 gray of 3 samples unassociated alpha": lambda: T.tiff(
        [_c("u16", 3)], photometric=1, tags={338: (3, [0, 2])}),
    "u16 gray of 4 samples tiles big-endian lzw predictor": lambda: T.tiff(
        [_c("u16", 4)], ">", tile=(16, 16), compression=5, predictor=2,
        photometric=1),
    "u16 white is zero of 3 samples strips": lambda: T.tiff(
        [_c("u16", 3)], photometric=0, rows_per_strip=5, compression=8),
    "u16 gray of 3 samples orientation 4": lambda: T.tiff(
        [_c("u16", 3)], photometric=1, tags=_orient(4)),
    "12-bit gray of 3 samples": lambda: T.tiff([_c("u12", 3)], bits=12,
                                               photometric=1),
}

BIG = {
    "bigtiff rgb": lambda: T.tiff([_c("u8", 3)], big=True),
    "bigtiff rgb big-endian lzw predictor": lambda: T.tiff(
        [_c("u8", 3)], ">", big=True, compression=5, predictor=2,
        rows_per_strip=8),
    "bigtiff gray tiles": lambda: T.tiff([_c("u8", 1)], big=True,
                                         tile=(16, 16), compression=8),
    "bigtiff rgba16 big-endian tiles": lambda: T.tiff(
        [_c("u16", 4)], ">", big=True, tile=(16, 16)),
    "bigtiff f32 predictor 3": lambda: T.tiff(
        [_c("f32", 3)], big=True, compression=8, predictor=3),
    "bigtiff two pages": lambda: T.tiff([_c("u8", 1), _c("u8", 3)],
                                        big=True),
    "bigtiff palette": lambda: T.tiff(
        [_c("u8", 1)], big=True, photometric=3,
        tags={320: (3, np.random.default_rng(62).integers(
            0, 65536, 768).tolist())}),
    "bigtiff orientation 3": lambda: T.tiff([_c("u8", 3)], big=True,
                                            tags=_orient(3)),
}


def _zero(img, compression, **kw):
    tags = {**kw.pop("tags", {}), 259: (3, [compression])}
    return T.tiff([img], tags=tags, **kw)


# compressions libtiff does not know: the RGBA reader's buffer stays zero
# (cv2's own path reads nothing: refused)
ZERO = {
    **{f"{c} gray": (lambda c=c: _zero(_c("u8", 1), c))
       for c in (34712, 5555, 50002, 0)},
    "34712 rgb": lambda: _zero(_c("u8", 3), 34712),
    # a strip that begins as a JPEG 2000 codestream does
    "34712 rgb of a codestream's first bytes": lambda: _zero(
        np.concatenate([[[[0xFF, 0x4F, 0xFF]]], _c("u8", 3)[:1, 1:]], 1)
        .astype(np.uint8).repeat(5, 0), 34712),
    "34712 rgba unassociated": lambda: _zero(_c("u8", 4), 34712,
                                             tags={338: (3, [2])}),
    "34712 gray and alpha": lambda: _zero(_c("u8", 2), 34712),
    "34712 white is zero tiles": lambda: _zero(_c("u8", 1), 34712,
                                               tile=(16, 16), photometric=0),
    "34712 palette": lambda: _zero(_c("u8", 1), 34712, photometric=3,
                                   tags={320: (3, list(range(3000, 3768)))}),
    "34712 cmyk big-endian": lambda: _zero(_c("u8", 4), 34712, order=">",
                                           photometric=5),
    "34712 rgb16": lambda: _zero(_c("u16", 3), 34712),
    "34712 gray16 orientation 2": lambda: _zero(_c("u16", 1), 34712,
                                                tags=_orient(2)),
    "34712 gray16 of 2 samples": lambda: _zero(_c("u16", 2), 34712),
    "34712 i8 rgb": lambda: _zero(_c("i8", 3), 34712),
    "34712 bigtiff": lambda: _zero(_c("u8", 3), 34712, big=True),
}

# files cv2 refuses in both modes
REFUSED = {
    "f16 rgb": lambda: T.tiff([_c("f32", 3).astype(np.float16)]),
    "f16 gray predictor 3": lambda: T.tiff(
        [_c("f32", 1).astype(np.float16)], compression=8, predictor=3),
    "f32 gray and alpha": lambda: T.tiff([_c("f32", 2)]),
    "f32 cmyk": lambda: T.tiff([_c("f32", 4)], photometric=5),
    "predictor 3 on i32": lambda: T.tiff([_c("i32", 3)], compression=8,
                                         predictor=3),
    "predictor 3 on u16": lambda: T.tiff([_c("u16", 3)], compression=5,
                                         predictor=3),
    "predictor 2 on 12-bit": lambda: T.tiff([_c("u12", 3)], bits=12,
                                            compression=5, predictor=2),
    **{f"sample format {f}": (lambda f=f: T.tiff(
        [_c("u8", 3)], tags={339: (3, [f] * 3)})) for f in (4, 5, 6)},
    "sample format 4 at 32 bits": lambda: T.tiff(
        [_c("u32", 1)], tags={339: (3, [4])}),
    "sample formats differ": lambda: T.tiff(
        [_c("u8", 3)], tags={339: (3, [1, 2, 1])}),
    "12-bit gray and alpha": lambda: T.tiff([_c("u12", 2)], bits=12),
    **{f"{t} gray and alpha": (lambda t=t: T.tiff([_c(t, 2)]))
       for t in ("u32", "i32", "u64", "i64", "f64")},
    "34712 f32": lambda: _zero(_c("f32", 3), 34712),
    "10-bit palette": lambda: T.tiff(
        [_c("u10", 1)], bits=10, photometric=3,
        tags={320: (3, list(range(3 << 10)))}),
    "24-bit float": lambda: T.tiff([_c("u8", 3)], tags={
        258: (3, [24] * 3), 339: (3, [3] * 3)}),
}

CASES = {**FLOAT, **INTEGER, **PACKED, **EXTRA, **BIG, **ZERO}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiff_sample_type_reads_as_cv2(tmp_path, name):
    assert assert_reads_as_cv2(tmp_path, CASES[name]())


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_tiff_sample_type_cv2_refuses_is_unreadable(tmp_path, name):
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


def test_float_tiff_of_a_frame_reads_as_its_png(tmp_path):
    """A float32 TIFF holding a u8 frame's samples 0-255 (predictor 3)
    reads through ``imread_unit`` as JAX's PNG of the frame, bit for bit:
    ``/ 255`` of the same values."""
    frame = _c("u8", 3)
    (tmp_path / "f.png").write_bytes(tio.encode_png(frame))
    (tmp_path / "f.tif").write_bytes(FLOAT["f32 of a u8 frame"]())
    want = jio.imread_unit(str(tmp_path / "f.png"))
    np.testing.assert_array_equal(tio.imread_unit(str(tmp_path / "f.tif")),
                                  want)
    assert tio.imread_u8(str(tmp_path / "f.tif")) is None  # as cv2.imread


# planar files of cv2's own path: (image, bits, photometric)
PLANAR = {"f32 rgb": ("f32", None, 2), "f64 rgb": ("f64", None, 2),
          "u16 gray of 3 samples": ("u16", None, 1),
          "12-bit rgb": ("u12", 12, 2)}


@pytest.mark.parametrize("name", sorted(PLANAR))
def test_tiff_sample_type_planar_reads_its_samples(tmp_path, name):
    """cv2's own path reads a planar file as chunky: the first plane's
    samples fill the image's first rows (packed rows pad at other places)
    and the rest is memory it never wrote.  The port reads the samples,
    as it reads the chunky twin (ROADMAP Queue 3)."""
    image, bits, ph = PLANAR[name]
    src = _c(image, 3)
    data = T.tiff([src], planar=2, photometric=ph, bits=bits)
    chunky = T.tiff([src], photometric=ph, bits=bits)
    path = tmp_path / "p.tif"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    got = ttiff.decode_tiff(data)
    np.testing.assert_array_equal(got, ttiff.decode_tiff(chunky))
    if ph == 2 and bits is None:
        rows = H // 3
        np.testing.assert_array_equal(want[..., ::-1][:rows].reshape(-1),
                                      src[..., 0].reshape(-1)[:rows * W * 3])
    assert not np.array_equal(_raw_as_rgb(want), got)


def test_gray16_extra_samples_weights():
    """cv2's gray of a 16-bit gray of 3 or 4 samples: ``(4899 s0 + 9617 s1
    + 1868 s2 + 8192) >> 14`` (OpenCV's BGR-to-gray weights of 14 bits
    after its swap of red and blue), the fourth sample unused."""
    for c in (3, 4):
        s = _c("u16", c).astype(np.int64)
        want = (s[..., 0] * 4899 + s[..., 1] * 9617 + s[..., 2] * 1868
                + 8192) >> 14
        got = ttiff.decode_tiff(T.tiff([_c("u16", c)], photometric=1))
        np.testing.assert_array_equal(got[..., 0], want)


def test_packed_samples_are_shifted_to_16_bits():
    """10-, 12- and 14-bit samples read as ``v << (16 - bits)``, as
    OpenCV's ``_unpack*To16`` give them, on a width whose rows end inside
    a packet of 4 samples."""
    for bits in (10, 12, 14):
        v = _c(f"u{bits}", 3)[:5, :7]
        got = ttiff.decode_tiff(T.tiff([v], bits=bits))
        np.testing.assert_array_equal(got, v << (16 - bits))


def test_fp_predictor_round_trip():
    """``torch_tiff.fp_predict`` and ``tiff._fp_unpredict`` are inverses on
    random rows of 1, 3 and 4 samples of 4 and 8 bytes."""
    rng = np.random.default_rng(63)
    for n in (1, 3, 4):
        for size in (4, 8):
            a = rng.integers(0, 256, (5, 7 * n * size), dtype=np.uint8)
            coded = T.fp_predict(a.tobytes(), 7 * n, size, n)
            back = ttiff._fp_unpredict(coded, 5, 7, n, size)
            want = a.reshape(5, 7 * n, size).view(f"<u{size}")
            np.testing.assert_array_equal(back.reshape(5, -1),
                                          want.reshape(5, -1))


# BigTIFF files and their classic twins
TWINS = {"rgb": {},
         "rgba16 big-endian tiles": dict(order=">", tile=(16, 16)),
         "f32 predictor 3": dict(compression=8, predictor=3)}
TWIN_IMAGES = {"rgb": ("u8", 3), "rgba16 big-endian tiles": ("u16", 4),
               "f32 predictor 3": ("f32", 3)}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_bigtiff_reads_as_its_classic_twin(name):
    img = _c(*TWIN_IMAGES[name])
    big = T.tiff([img], big=True, **TWINS[name])
    classic = T.tiff([img], **TWINS[name])
    assert big[2:4] in (b"+\x00", b"\x00+")
    for color in (False, True):
        try:
            want = ttiff.decode_tiff(classic, color)
        except ValueError:
            with pytest.raises(ValueError):
                ttiff.decode_tiff(big, color)
            continue
        np.testing.assert_array_equal(ttiff.decode_tiff(big, color), want)
