"""The JPEG variants of ``utils/jpeg.py`` beyond Huffman DCT files of 1 or
3 components, against cv2 5.0.0 through the JAX package: four components
(CMYK and YCCK, baseline and progressive, any sampling, restarts),
lossless files (SOF3: predictors 1-7, point transforms, restarts,
sampling, precisions 2-8, the colour-space rules of libjpeg-turbo's
lossless mode, files cut short) and arithmetic coding (SOF9 and SOF10:
the conditioning of a DAC segment, restarts, every scan script of the
progressive tests, files cut short).  Each file is built here
(``tests/torch_jpeg_scans.py``; cv2 writes none of them) and read through
``imread_unit`` against JAX's (``IMREAD_UNCHANGED``) and ``imread_u8``
against JAX's training loader (``IMREAD_COLOR``), bit for bit.  The
variants cv2 refuses (12 bits, hierarchical and arithmetic lossless
frames, a DNL height, fractional sampling, two components, a lossless
file of 9-16 bits, in YCbCr or YCCK, or gray in ``IMREAD_COLOR``, bad
lossless scans, a bad DAC value) raise ValueError and read as unreadable,
as JAX skips them.  ``cli six`` on a CMYK and a lossless RGB file against
the JAX CLI, at the gates of ``tests/test_torch_read16.py``."""

import struct

import numpy as np
import pytest

from chip_smoke import cmyk_formula
from tests import torch_frames
from tests import torch_jpeg_scans as js
from tests.test_torch_io import _image
from tests.test_torch_read16 import SIX, _psnr, _run, _u8
from underwater_image_enhancement_tpu import cli as jcli
from underwater_image_enhancement_tpu.train import data as jdata
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import jpeg as tjpeg


def _planes(n=4, h=40, w=56, seed=0):
    """``n`` full-size u8 planes: gradients, a ripple and noise."""
    img = _image(h, w, seed=seed)
    extra = _image(h, w, seed=seed + 1)
    return [img[..., 0], img[..., 1], img[..., 2], extra[..., 1]][:n]


def _assert_reads_as_cv2(tmp_path, data, name="v.jpg"):
    """imread_unit equals JAX's (``IMREAD_UNCHANGED``), imread_u8 JAX's
    training loader (``IMREAD_COLOR``)."""
    path = tmp_path / name
    path.write_bytes(data)
    want = jio.imread_unit(str(path))
    assert want is not None
    got = tio.imread_unit(str(path))
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    want8 = jdata._imread_rgb(str(path))
    assert want8 is not None
    np.testing.assert_array_equal(tio.imread_u8(str(path)), want8)


# ---------------------------------------------------------------------------
# CMYK and YCCK
# ---------------------------------------------------------------------------

CMYK_MARKERS = {"adobe 0 (CMYK)": (js.adobe(0),), "no marker (CMYK)": (),
                "JFIF (CMYK)": (js.JFIF,), "adobe 2 (YCCK)": (js.adobe(2),),
                "adobe 1 (taken as YCCK)": (js.adobe(1),)}


@pytest.mark.parametrize("marker", sorted(CMYK_MARKERS))
def test_four_components_match_cv2(tmp_path, marker):
    """CMYK (an Adobe transform 0 or no Adobe marker) through OpenCV's
    ``k - ((255 - c) * k >> 8)``; YCCK (any other transform) first to CMYK
    as ``jdcolor.c`` ycck_cmyk_convert does."""
    _assert_reads_as_cv2(tmp_path, js.sequential(
        _planes(), app=CMYK_MARKERS[marker]))


@pytest.mark.parametrize("space", ["cmyk", "ycck"])
@pytest.mark.parametrize("factors", [
    ((2, 2), (1, 1), (1, 1), (2, 2)), ((2, 1), (1, 1), (1, 1), (2, 1)),
    ((1, 2), (1, 1), (2, 1), (1, 1)), ((4, 1), (2, 1), (1, 1), (1, 1))],
    ids=["2x2-1-1-2x2", "2x1-1-1-2x1", "1x2-1-2x1-1", "4x1-2x1-1-1"])
def test_four_components_sampling_and_restarts_match_cv2(tmp_path, factors,
                                                         space):
    app = (js.adobe(0 if space == "cmyk" else 2),)
    _assert_reads_as_cv2(tmp_path, js.sequential(
        _planes(h=37, w=61), factors=list(factors), app=app, restart=3))


@pytest.mark.parametrize("script,restart", [("cv2", 0), ("three_step", 2),
                                            ("stops_at_1", 0),
                                            ("spectral", 5)])
@pytest.mark.parametrize("space", ["cmyk", "ycck"])
def test_progressive_four_components_match_cv2(tmp_path, space, script,
                                               restart):
    """The transcoder's scripts over four components (cv2's all-purpose
    one for them), block smoothing where the script stops at Al=1."""
    base = js.sequential(_planes(), factors=[(2, 2), (1, 1), (1, 1), (2, 2)],
                         app=(js.adobe(0 if space == "cmyk" else 2),))
    data = js.transcode(base, js.script(script, 4), restart)
    _assert_reads_as_cv2(tmp_path, data)
    if script != "stops_at_1":
        np.testing.assert_array_equal(tjpeg.decode_jpeg(data),
                                      tjpeg.decode_jpeg(base))


def test_cmyk_formula_on_known_planes():
    """A CMYK file whose components are a JPEG's own (``recomponent``):
    its decode is the formula on the planes the RGB-marked twin decodes
    to, and the YCCK twin's the formula on 255 less the YCbCr decode
    (``chip_smoke.py``'s ``[jpeg_variants]`` check, here on the CPU)."""
    base = tjpeg.encode_jpeg(_image(40, 56, seed=9))
    planes = tjpeg.decode_jpeg(js.recomponent(base, (0, 1, 2),
                                              (js.adobe(0),)))
    p = [planes[..., k] for k in range(3)]
    cmyk = tjpeg.decode_jpeg(js.recomponent(base, (0, 1, 2, 0),
                                            (js.adobe(0),)))
    np.testing.assert_array_equal(cmyk, cmyk_formula(*p, p[0]))
    ycck = tjpeg.decode_jpeg(js.recomponent(base, (0, 1, 2, 0),
                                            (js.adobe(2),)))
    rgb = tjpeg.decode_jpeg(base)
    np.testing.assert_array_equal(ycck, cmyk_formula(
        *(255 - rgb[..., k] for k in range(3)), p[0]))


# ---------------------------------------------------------------------------
# Lossless (SOF3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pt", [0, 3])
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_gray_matches_cv2(tmp_path, psv, pt):
    """A gray lossless file at every predictor, with and without a point
    transform and restarts: ``IMREAD_UNCHANGED`` reads the samples
    written (their low Pt bits dropped), ``IMREAD_COLOR`` refuses it
    (libjpeg-turbo converts no colour in lossless mode)."""
    g = _planes(1, 37, 61, seed=psv)[0]
    data = js.lossless([g], psv, pt, restart_rows=2 if pt else 0)
    path = tmp_path / "g.jpg"
    path.write_bytes(data)
    want = jio.imread_unit(str(path))
    np.testing.assert_array_equal(tio.imread_unit(str(path)), want)
    np.testing.assert_array_equal(tio.read_image(str(path))[0][..., 0],
                                  (g >> pt) << pt)
    assert jdata._imread_rgb(str(path)) is None
    assert tio.read_image(str(path), color=True) == (None, None)


@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_rgb_matches_cv2(tmp_path, psv):
    """Three components at every predictor, a point transform, restarts
    of whole MCU rows and the sampling of the predictor's case."""
    factors = [None, [(2, 2), (1, 1), (1, 1)], [(1, 1), (2, 1), (1, 1)],
               [(1, 2), (2, 1), (1, 1)]][psv % 4]
    data = js.lossless(_planes(3, 37, 61, seed=psv), psv, psv % 3,
                       factors=factors, restart_rows=psv % 3,
                       ids=[82, 71, 66])
    _assert_reads_as_cv2(tmp_path, data)


@pytest.mark.parametrize("precision", [2, 4, 6, 7])
def test_lossless_precisions_match_cv2(tmp_path, precision):
    """Samples of 2-7 bits read as they are (no scaling to 8 bits)."""
    planes = [(p.astype(np.int64) >> (8 - precision)) for p in _planes(3)]
    data = js.lossless(planes, 7, 1, precision, app=(js.adobe(0),))
    _assert_reads_as_cv2(tmp_path, data)
    np.testing.assert_array_equal(tjpeg.decode_jpeg(data),
                                  np.stack(planes, -1) >> 1 << 1)


LOSSLESS_RGB = {"ids R G B": {"ids": [82, 71, 66]},
                "adobe 0": {"app": (js.adobe(0),)},
                "ids 1 2 3, no marker": {},
                "ids 5 6 7, no marker": {"ids": [5, 6, 7]},
                "four components (CMYK)": {"n": 4}}


@pytest.mark.parametrize("name", sorted(LOSSLESS_RGB))
def test_lossless_colour_spaces_cv2_reads(tmp_path, name):
    """libjpeg-turbo 3 takes a lossless file's three components as RGB
    but for a JFIF marker or an Adobe transform other than 0 (which it
    refuses: ``LOSSLESS_REFUSED``), and four as CMYK."""
    kw = dict(LOSSLESS_RGB[name])
    n = kw.pop("n", 3)
    data = js.lossless(_planes(n), 4, **kw)
    _assert_reads_as_cv2(tmp_path, data)
    if n == 3:
        np.testing.assert_array_equal(tjpeg.decode_jpeg(data),
                                      np.stack(_planes(3), -1))


@pytest.mark.parametrize("cut", [0.3, 0.7, "rst", -3])
def test_truncated_lossless_matches_cv2(tmp_path, cut):
    """A lossless file cut short: the MCU row in progress reads zero bits,
    later rows zero differences from reset predictors, until a restart
    marker that is present."""
    data = js.lossless(_planes(3, 37, 61), 6, 1, restart_rows=3,
                       factors=[(2, 2), (1, 1), (1, 1)])
    if cut == "rst":
        n = max(data.rfind(bytes([0xFF, m])) for m in range(0xD0, 0xD8))
    else:
        n = int(len(data) * cut) if isinstance(cut, float) else len(data) + cut
    _assert_reads_as_cv2(tmp_path, data[:n])


# ---------------------------------------------------------------------------
# Arithmetic coding (SOF9, SOF10)
# ---------------------------------------------------------------------------

def _base(sampling, seed=3):
    """A baseline file of the port's encoder (4:2:0) or of
    ``js.sequential`` at other sampling (None: gray)."""
    if sampling == "420":
        return tjpeg.encode_jpeg(_image(45, 67, seed=seed))
    factors = {"444": [(1, 1)] * 3, "422": [(2, 1), (1, 1), (1, 1)],
               "cmyk": [(2, 2), (1, 1), (1, 1), (2, 2)], None: None}[sampling]
    n = 1 if sampling is None else 4 if sampling == "cmyk" else 3
    app = (js.adobe(0),) if sampling == "cmyk" else (js.JFIF,)
    return js.sequential(_planes(n, 45, 67, seed), factors=factors, app=app)


# DAC: DC tables' L and U (U << 4 | L), AC tables' Kx
DAC = [(0, 0, 0x52), (0, 1, 0x30), (1, 0, 10), (1, 1, 1)]


@pytest.mark.parametrize("sampling,restart,dac", [
    ("420", 0, ()), ("420", 2, DAC), ("444", 0, DAC), ("422", 5, ()),
    (None, 0, ()), (None, 7, DAC), ("cmyk", 3, ())],
    ids=["420", "420-rst2-dac", "444-dac", "422-rst5", "gray",
         "gray-rst7-dac", "cmyk-rst3"])
def test_arithmetic_sequential_matches_cv2(tmp_path, sampling, restart, dac):
    """SOF9: the QM decoder (T.81 Annex D as ``jdarith.c`` runs it), DC
    contexts from L and U, the AC magnitude bins split at Kx, statistics
    a table shared by its components and reset at each restart; the
    decode equals the Huffman file's with the same coefficients."""
    base = _base(sampling)
    data = js.arithmetic(base, restart=restart, dac=dac)
    assert b"\xff\xc9" in data
    _assert_reads_as_cv2(tmp_path, data)
    np.testing.assert_array_equal(tjpeg.decode_jpeg(data),
                                  tjpeg.decode_jpeg(base))


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("name", js.SCRIPTS)
def test_arithmetic_progressive_matches_cv2(tmp_path, name, restart):
    """SOF10 under every script of the progressive tests: the four scan
    kinds of ``jdarith.c``, block smoothing where the script stops at
    Al=1 (arithmetic decoding never flags missing data)."""
    base = _base("420")
    data = js.arithmetic(base, js.script(name, 3), restart, DAC[:2])
    assert b"\xff\xca" in data
    _assert_reads_as_cv2(tmp_path, data)
    if name != "stops_at_1":
        np.testing.assert_array_equal(tjpeg.decode_jpeg(data),
                                      tjpeg.decode_jpeg(base))


@pytest.mark.parametrize("sampling", [None, "cmyk"])
def test_arithmetic_progressive_gray_and_cmyk_match_cv2(tmp_path, sampling):
    base = _base(sampling)
    nc = 1 if sampling is None else 4
    _assert_reads_as_cv2(tmp_path, js.arithmetic(base, js.script("cv2", nc),
                                                 4))


@pytest.mark.parametrize("scan,where", [(1, 0.5), (3, 0.2), (6, 0.7),
                                        (None, 0.6)])
def test_truncated_arithmetic_matches_cv2(tmp_path, scan, where):
    """A file cut short: the QM decoder reads zero bytes past the end (and
    past a restart marker that never came) to the end of every scan
    present; later scans are absent."""
    base = _base("420")
    if scan is None:
        data = js.arithmetic(base, restart=4)
        a, b = data.index(b"\xff\xda"), len(data)
    else:
        data = js.arithmetic(base, js.script("cv2", 3), 2)
        starts = [i for i in range(len(data) - 1)
                  if data[i:i + 2] == b"\xff\xda"]
        a = starts[scan - 1]
        b = starts[scan] if scan < len(starts) else len(data)
    _assert_reads_as_cv2(tmp_path, data[:a + int((b - a) * where)])


# ---------------------------------------------------------------------------
# What cv2 refuses
# ---------------------------------------------------------------------------

def _patch_sof(data, marker=None, precision=None, height=None):
    """The file with its SOF marker, precision or height replaced."""
    b = bytearray(data)
    p = next(i for i in range(2, len(b) - 1)
             if b[i] == 0xFF and 0xC0 <= b[i + 1] <= 0xCF
             and b[i + 1] not in (0xC4, 0xC8, 0xCC))
    if marker is not None:
        b[p + 1] = marker
    if precision is not None:
        b[p + 4] = precision
    if height is not None:
        b[p + 5:p + 7] = struct.pack(">H", height)
    return bytes(b)


def _patch(data, old: bytes, new: bytes):
    assert data.count(old) == 1
    return data.replace(old, new)


def _dnl():
    base = js.sequential(_planes(3))
    return (_patch_sof(base, height=0)[:-2]
            + b"\xff\xdc\x00\x04" + struct.pack(">H", 40) + b"\xff\xd9")


def _gray_lossless(**kw):
    return js.lossless(_planes(1), 1, **kw)


def _sos(data, psv: int, pt: int):
    """A one-component lossless file with its scan's predictor and point
    transform replaced."""
    return _patch(data, b"\x01\x01\x00\x01\x00\x00",
                  bytes([1, 1, 0, psv, 0, pt]))


REFUSED = {
    "12-bit SOF0": lambda: _patch_sof(js.sequential(_planes(3)),
                                      precision=12),
    "12-bit SOF1": lambda: _patch_sof(js.sequential(_planes(3)), 0xC1, 12),
    "12-bit SOF2": lambda: _patch_sof(js.transcode(
        js.sequential(_planes(3)), js.script("cv2", 3)), precision=12),
    "12-bit SOF9": lambda: _patch_sof(js.arithmetic(
        js.sequential(_planes(3))), precision=12),
    **{f"SOF{m - 0xC0}": (lambda m=m: _patch_sof(js.sequential(_planes(3)),
                                                 marker=m))
       for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)},
    "SOF11 (arithmetic lossless)": lambda: _patch_sof(_gray_lossless(),
                                                      marker=0xCB),
    "DNL height": _dnl,
    "fractional h": lambda: js.sequential(
        _planes(3), factors=[(3, 1), (2, 1), (1, 1)]),
    "fractional v": lambda: js.sequential(
        _planes(3), factors=[(1, 3), (1, 2), (1, 1)]),
    "2 components": lambda: js.sequential(_planes(2)),
    "lossless 1-bit": lambda: js.lossless([_planes(1)[0] >> 7], 1,
                                          precision=1),
    "lossless 9-bit": lambda: js.lossless(
        [p.astype(np.int64) << 1 for p in _planes(3)], 1, precision=9),
    "lossless 12-bit": lambda: js.lossless(
        [_planes(1)[0].astype(np.int64) << 4], 2, precision=12),
    "lossless 16-bit": lambda: js.lossless(
        [_planes(1)[0].astype(np.int64) * 257], 7, precision=16),
    "lossless JFIF (YCbCr)": lambda: js.lossless(_planes(3), 1,
                                                 app=(js.JFIF,)),
    "lossless adobe 1 (YCbCr)": lambda: js.lossless(_planes(3), 1,
                                                    app=(js.adobe(1),)),
    "lossless adobe 2 (YCCK)": lambda: js.lossless(_planes(4), 1,
                                                   app=(js.adobe(2),)),
    "lossless predictor 0": lambda: _sos(_gray_lossless(), 0, 0),
    "lossless predictor 8": lambda: _sos(_gray_lossless(), 8, 0),
    "lossless Pt past the precision": lambda: _sos(_gray_lossless(), 1, 8),
    "lossless restart of part of a row": lambda: _patch(
        _gray_lossless(restart_rows=1), b"\xff\xdd\x00\x04\x00\x38",
        b"\xff\xdd\x00\x04\x00\x1c"),
    "DAC L over U": lambda: js.arithmetic(js.sequential(_planes(3)),
                                          dac=[(0, 0, 0x25)]),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_variants_cv2_refuses_are_unreadable(tmp_path, name):
    """cv2 gives None in both modes; the port raises ValueError (not
    ``Unsupported``) and ``read_image`` gives (None, None)."""
    data = REFUSED[name]()
    path = tmp_path / "r.jpg"
    path.write_bytes(data)
    assert jio.imread_unit(str(path)) is None
    assert jdata._imread_rgb(str(path)) is None
    for color in (False, True):
        with pytest.raises(ValueError) as e:
            tio.decode_image(data, color)
        assert not isinstance(e.value, tjpeg.Unsupported)
        assert tio.read_image(str(path), color) == (None, None)


def test_refused_variants_are_logged_unreadable(tmp_path):
    """A folder of every refused variant and one readable file of each
    ported kind: ``decode_iter`` yields the readable ones and logs
    "warning: unreadable <name>" for the rest, as JAX's skips them."""
    names = {}
    for k, name in enumerate(sorted(REFUSED)):
        names[f"r{k:02d}.jpg"] = REFUSED[name]()
    ok = {"cmyk.jpg": js.sequential(_planes(), app=(js.adobe(0),)),
          "lossless.jpg": js.lossless(_planes(3), 5, ids=[82, 71, 66]),
          "arith.jpg": js.arithmetic(_base("420"), js.script("cv2", 3))}
    for name, data in {**names, **ok}.items():
        (tmp_path / name).write_bytes(data)
    logged = []
    got = [p.name for p, _ in tio.decode_iter(
        tio.collect_images(str(tmp_path)), log=logged.append)]
    assert got == sorted(ok)
    assert sorted(logged) == sorted(f"warning: unreadable {n}"
                                    for n in names)
    want = [jio.imread_unit(str(tmp_path / n)) is None for n in sorted(names)]
    assert all(want)


# ---------------------------------------------------------------------------
# cli six on the variants
# ---------------------------------------------------------------------------

def test_cli_six_on_cmyk_and_lossless_matches_jax(tmp_path):
    """A 48x64 frame as a CMYK file (C, M, Y the R, G, B planes, K 255)
    and as a lossless RGB file: the port's ``cli six --device cpu``
    against the JAX CLI at tests/test_torch_read16.py's exact-tier gates
    (dehazing >= 50 dB, the rest within one level)."""
    frame = (torch_frames.underwater_img()[36:84, 48:112] * 255).round() \
        .astype(np.uint8)
    src = tmp_path / "in"
    src.mkdir()
    planes = [frame[..., k] for k in range(3)]
    (src / "c.jpg").write_bytes(js.sequential(
        planes + [np.full_like(planes[0], 255)], app=(js.adobe(0),)))
    (src / "l.jpg").write_bytes(js.lossless(planes, 4, ids=[82, 71, 66]))
    np.testing.assert_array_equal(tio.imread_u8(str(src / "l.jpg")), frame)
    _run(tcli.main, ["six", "--input", str(src), "--output",
                     str(tmp_path / "port"), "--device", "cpu"])
    _run(jcli.main, ["six", "--input", str(src), "--output",
                     str(tmp_path / "jax")])
    for stem in ("c", "l"):
        for name in SIX:
            png = f"{stem}_{name}.png"
            a, b = _u8(tmp_path / "port" / png), _u8(tmp_path / "jax" / png)
            assert a.shape == b.shape == (48, 64, 3)
            if "dehazing" in name:
                assert _psnr(a, b) >= 50.0, png
            else:
                assert np.abs(a - b).max() <= 1, png
