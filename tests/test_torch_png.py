"""The port's PNG reader (``utils/io.decode_png``) against cv2 and the
JAX package, on files written by ``tests/torch_png.py``: every colour type
at every depth (gray at 1, 2, 4, 8 and 16 bits, palette at 1, 2, 4 and
8), with and without tRNS, plain and Adam7-interlaced, a filter type drawn
for each row; palettes longer than the depth allows, indices past the
palette and tRNS chunks cv2 drops; ancillary chunks that change no
sample; and files cut short, with bad CRCs, split or broken image data.

Each file is held three ways: ``decode_png`` to ``cv2.imdecode(...,
IMREAD_UNCHANGED)`` bit for bit (alpha included), the port's
``imread_unit`` to the JAX package's (``/ 255`` of cv2's samples, up to
257 at 16 bits) bit for bit, and the port's ``imread_u8`` to JAX's
``train/data._imread_rgb`` (``IMREAD_COLOR``: a 16-bit sample's high
byte).  A file cv2 refuses is None in all three."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from tests import torch_png as P
from underwater_image_enhancement_tpu.train import data as jdata
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch.utils import io as tio


def _as_cv2(img):
    """``decode_png``'s array in cv2's layout: gray as it is, gray + alpha
    as BGRA, RGB(A) as BGR(A)."""
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        return np.concatenate([img[..., :1]] * 3 + [img[..., 1:]], -1)
    return np.concatenate([img[..., 2::-1], img[..., 3:]], -1)


def _assert_reads_as_cv2(tmp_path, data, name="p.png"):
    """The three holds of the module docstring; returns cv2's array (None
    where cv2 refuses the file)."""
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    path = tmp_path / name
    path.write_bytes(data)
    if want is None:
        with pytest.raises((ValueError, zlib.error)):
            tio.decode_png(data)
        assert tio.read_image(str(path)) == (None, None)
        assert jio.imread_unit(str(path)) is None
        assert jdata._imread_rgb(str(path)) is None
        assert tio.imread_u8(str(path)) is None
        return None
    got = _as_cv2(tio.decode_png(data))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    unit = tio.imread_unit(str(path))
    jax_unit = jio.imread_unit(str(path))
    assert unit.dtype == jax_unit.dtype == np.float32
    np.testing.assert_array_equal(unit, jax_unit)
    np.testing.assert_array_equal(tio.imread_u8(str(path)),
                                  jdata._imread_rgb(str(path)))
    return want


def _samples(h, w, ctype, depth, seed, n_palette=None):
    rng = np.random.default_rng(seed)
    hi = 1 << depth if n_palette is None else n_palette
    return rng.integers(0, hi, (h, w, P.CHANNELS[ctype]))


def _palette(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 3))


def _filters(seed):
    """A filter type drawn for each row."""
    draws = np.random.default_rng(seed).integers(0, 5, 4096)
    return lambda y: int(draws[y])


def _trns(ctype, samples, n_palette, seed):
    rng = np.random.default_rng(seed)
    if ctype == 3:
        return rng.integers(0, 256, max(1, n_palette - 1)).tolist()
    return [int(v) for v in samples[0, 0]]  # the first pixel's colour


# (colour type, depth, tRNS): tRNS only where there is no alpha channel
KINDS = [(ctype, depth, trns) for ctype in (0, 2, 3, 4, 6)
         for depth in P.DEPTHS[ctype]
         for trns in ((False, True) if ctype in (0, 2, 3) else (False,))]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth,trns", KINDS, ids=[
    f"type{c}-{d}bit" + ("-trns" if t else "") for c, d, t in KINDS])
def test_png_matches_cv2(tmp_path, ctype, depth, trns, interlace):
    """Gray at 1-4 bits reads scaled to 8 (libpng's 0x55 and 0x11
    multipliers), a tRNS colour gives RGB an alpha and gray none, a
    palette's tRNS an alpha; 16-bit samples reach 257 through
    ``imread_unit``."""
    seed = 100 * ctype + depth
    n_palette = min(1 << depth, 200) if ctype == 3 else None
    s = _samples(23, 29, ctype, depth, seed, n_palette)
    pal = _palette(n_palette, seed) if ctype == 3 else None
    t = _trns(ctype, s, n_palette, seed) if trns else None
    data = P.encode(s, depth, ctype, palette=pal, trns=t, interlace=interlace,
                    filters=_filters(seed))
    want = _assert_reads_as_cv2(tmp_path, data)
    assert want.dtype == (np.uint16 if depth == 16 else np.uint8)
    if depth == 16:
        assert tio.imread_unit(str(tmp_path / "p.png")).max() > 250.0


@pytest.mark.parametrize("shape", [(1, 1), (2, 9), (5, 1), (1, 6), (8, 8),
                                   (9, 17)])
@pytest.mark.parametrize("ctype,depth", [(0, 1), (3, 4), (2, 16), (6, 8)])
def test_adam7_small_images_match_cv2(tmp_path, shape, ctype, depth):
    """Adam7 on images small enough that passes are empty: an empty pass
    carries no filter byte."""
    n_palette = 16 if ctype == 3 else None
    s = _samples(*shape, ctype, depth, 7, n_palette)
    data = P.encode(s, depth, ctype, interlace=True, filters=_filters(7),
                    palette=_palette(16, 7) if ctype == 3 else None)
    _assert_reads_as_cv2(tmp_path, data)


@pytest.mark.parametrize("case", [
    "long palette 1-bit", "long palette 4-bit", "index past palette",
    "short trns", "trns longer than palette", "rgb trns past 8 bits",
    "gray trns past 8 bits"])
def test_palette_and_trns_edges_match_cv2(tmp_path, case):
    """libpng cuts a palette to the depth's 2**depth entries and then
    drops a tRNS longer than what is left; an index past the palette reads
    black (and opaque); a short tRNS leaves the later entries opaque; an
    8-bit tRNS colour is compared on its low byte."""
    rng = np.random.default_rng(len(case))
    if case.startswith("long palette"):
        depth = 1 if "1-bit" in case else 4
        s = rng.integers(0, 1 << depth, (13, 17, 1))
        data = P.encode(s, depth, 3, palette=_palette(40, 1),
                        trns=rng.integers(0, 256, 3 if depth == 1 else 12)
                        .tolist())
    elif case == "index past palette":
        s = rng.integers(0, 256, (13, 17, 1))
        data = P.encode(s, 8, 3, palette=_palette(100, 2),
                        trns=rng.integers(0, 256, 50).tolist())
    elif case in ("short trns", "trns longer than palette"):
        s = rng.integers(0, 16, (13, 17, 1))
        n = 3 if case == "short trns" else 17
        data = P.encode(s, 4, 3, palette=_palette(16, 3),
                        trns=rng.integers(0, 256, n).tolist())
    elif case == "rgb trns past 8 bits":
        s = rng.integers(0, 256, (13, 17, 3))
        data = P.encode(s, 8, 2, trns=[int(v) + 256 for v in s[2, 3]])
    else:
        s = rng.integers(0, 16, (13, 17, 1))
        data = P.encode(s, 4, 0, trns=[int(s[0, 0, 0]) + 16])
    _assert_reads_as_cv2(tmp_path, data)


ANCILLARY = {
    "gAMA": struct.pack(">I", 45455), "gAMA-1": struct.pack(">I", 100000),
    "sBIT": bytes([5, 6, 5]), "sRGB": b"\x00", "tEXt": b"key\x00value",
    "cHRM": struct.pack(">8I", 31270, 32900, 64000, 33000, 30000, 60000,
                        15000, 6000),
    "bKGD": struct.pack(">3H", 1, 2, 3), "pHYs": struct.pack(">IIB", 1, 1, 0),
    "iCCP": b"p\x00\x00" + zlib.compress(b"not a profile"),
    "prVt": b"an unknown ancillary chunk",
}


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("name", sorted(ANCILLARY))
def test_ancillary_chunks_change_no_sample(tmp_path, name, depth):
    """cv2 sets no gamma, shift or background transform: gAMA, sBIT, bKGD
    and the rest leave the samples as they are."""
    s = _samples(9, 12, 2, depth, 11)
    tag = name.split("-")[0].encode()
    body = bytes([11, 12, 13]) if tag == b"sBIT" and depth == 16 else \
        ANCILLARY[name]
    want = _assert_reads_as_cv2(
        tmp_path, P.encode(s, depth, 2, chunks=[(tag, body)]))
    np.testing.assert_array_equal(want, s[..., ::-1])


def _chunks(data):
    """[(offset, length, tag)] of a PNG's chunks."""
    out, pos = [], 8
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((pos, n, tag))
        pos += 12 + n
    return out


def _flip_crc(data, k):
    """The file with chunk k's CRC broken."""
    pos, n, _ = _chunks(data)[k]
    b = bytearray(data)
    b[pos + 8 + n] ^= 1
    return bytes(b)


def _rgb_file(raw=None, z=None, between=b"", after=b"", ctype=2, head=None):
    """A 12x9 8-bit file of the seeded samples with its parts replaced:
    ``raw`` the uncompressed data, ``z`` the stream, ``between`` chunks
    after the IDAT, ``after`` bytes after IEND, ``head`` the IHDR body."""
    s = _samples(9, 12, 2, 8, 21)
    raw = P.raw_data(s, 8) if raw is None else raw
    z = zlib.compress(raw) if z is None else z
    head = head or struct.pack(">IIBBBBB", 12, 9, 8, ctype, 0, 0, 0)
    return (P.SIGNATURE + P.chunk(b"IHDR", head) + P.chunk(b"IDAT", z)
            + between + P.chunk(b"IEND", b"") + after)


def _palette_file(*order):
    """A palette file with PLTE, tRNS and IDAT in ``order`` (names)."""
    s = _samples(9, 12, 3, 8, 22, 6)
    parts = {"PLTE": P.chunk(b"PLTE", _palette(6, 22).astype(np.uint8)
                             .tobytes()),
             "bad PLTE": P.chunk(b"PLTE", bytes(7)),
             "tRNS": P.chunk(b"tRNS", bytes([0, 90, 180])),
             "long tRNS": P.chunk(b"tRNS", bytes(7)),
             "empty tRNS": P.chunk(b"tRNS", b""),
             "IDAT": P.chunk(b"IDAT", zlib.compress(P.raw_data(s, 8)))}
    parts["crc tRNS"] = _flip_crc(P.SIGNATURE + parts["tRNS"], 0)[8:]
    parts["crc PLTE"] = _flip_crc(P.SIGNATURE + parts["PLTE"], 0)[8:]
    return (P.SIGNATURE + P.chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 12, 9, 8, 3, 0, 0, 0))
        + b"".join(parts[k] for k in order) + P.chunk(b"IEND", b""))


def _after_ihdr(data, chunk):
    """The file with ``chunk`` inserted after IHDR."""
    return data[:33] + chunk + data[33:]


Z = zlib.compress(P.raw_data(_samples(9, 12, 2, 8, 21), 8))
RAW = P.raw_data(_samples(9, 12, 2, 8, 21), 8)
TEXT = P.chunk(b"tEXt", b"a\x00b")
FAULTS = {
    # cut short: cv2 needs every chunk whole and IEND present
    "cut in the signature": lambda: _rgb_file()[:5],
    "cut in IHDR": lambda: _rgb_file()[:20],
    "cut in IDAT": lambda: _rgb_file()[:_chunks(_rgb_file())[1][0] + 40],
    "cut in IDAT's CRC": lambda: _rgb_file()[:_chunks(_rgb_file())[2][0] - 2],
    "cut in IEND": lambda: _rgb_file()[:-3],
    "no IEND": lambda: _rgb_file()[:-12],
    "junk after IEND": lambda: _rgb_file(after=b"junk"),
    "a chunk after IEND": lambda: _rgb_file(after=TEXT),
    # CRCs: critical chunks fail, ancillary ones and IEND are dropped
    "crc IHDR": lambda: _flip_crc(_rgb_file(), 0),
    "crc IDAT": lambda: _flip_crc(_rgb_file(), 1),
    "crc IEND": lambda: _flip_crc(_rgb_file(), 2),
    "crc tEXt": lambda: _flip_crc(_rgb_file(between=TEXT), 2),
    "crc rgb tRNS": lambda: _flip_crc(P.encode(
        _samples(9, 12, 2, 8, 21), 8, trns=[1, 2, 3]), 1),
    # the image data
    "many IDATs": lambda: P.encode(_samples(9, 12, 2, 8, 21), 8,
                                   idat_parts=7),
    "an IDAT a byte": lambda: P.encode(_samples(9, 12, 2, 8, 21), 8,
                                       idat_parts=len(Z)),
    "empty IDAT first": lambda: (P.SIGNATURE + P.chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 12, 9, 8, 2, 0, 0, 0)) + P.chunk(b"IDAT", b"")
        + P.chunk(b"IDAT", Z) + P.chunk(b"IEND", b"")),
    "too few rows": lambda: _rgb_file(raw=RAW[:-37]),
    "a byte short": lambda: _rgb_file(raw=RAW[:-1]),
    "rows past the image": lambda: _rgb_file(raw=RAW + bytes(74)),
    "a byte long": lambda: _rgb_file(raw=RAW + b"\x01"),
    "stream cut short": lambda: _rgb_file(z=Z[:-10]),
    "stream without its checksum": lambda: _rgb_file(z=Z[:-4]),
    "bad checksum": lambda: _rgb_file(z=Z[:-1] + bytes([Z[-1] ^ 1])),
    "bytes after the stream": lambda: _rgb_file(z=Z + b"junk"),
    "IDAT of junk after the stream": lambda: _rgb_file(
        between=P.chunk(b"IDAT", b"xyz")),
    "IDAT split by tEXt": lambda: (P.SIGNATURE + P.chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 12, 9, 8, 2, 0, 0, 0)) + P.chunk(b"IDAT", Z[:20]) + TEXT
        + P.chunk(b"IDAT", Z[20:]) + P.chunk(b"IEND", b"")),
    "IDAT after tEXt after the stream": lambda: _rgb_file(
        between=TEXT + P.chunk(b"IDAT", b"junk")),
    "no IDAT": lambda: (P.SIGNATURE + P.chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 12, 9, 8, 2, 0, 0, 0)) + P.chunk(b"IEND", b"")),
    "bad filter type": lambda: _rgb_file(raw=bytes([5]) + RAW[1:]),
    # the header and the chunk order
    "tEXt before IHDR": lambda: (P.SIGNATURE + TEXT + _rgb_file()[8:]),
    "two IHDR": lambda: _rgb_file()[:33] + _rgb_file()[8:],
    "bad depth for the type": lambda: _rgb_file(head=struct.pack(
        ">IIBBBBB", 12, 9, 4, 2, 0, 0, 0)),
    "interlace method 2": lambda: _rgb_file(head=struct.pack(
        ">IIBBBBB", 12, 9, 8, 2, 0, 0, 2)),
    "width 0": lambda: _rgb_file(head=struct.pack(
        ">IIBBBBB", 0, 9, 8, 2, 0, 0, 0)),
    "width at libpng's limit": lambda: _rgb_file(
        raw=bytes(1_000_001), head=struct.pack(">IIBBBBB", 1_000_000, 1, 8,
                                               0, 0, 0, 0)),
    "width past libpng's limit": lambda: _rgb_file(
        raw=bytes(1_000_002), head=struct.pack(">IIBBBBB", 1_000_001, 1, 8,
                                               0, 0, 0, 0)),
    "unknown critical chunk": lambda: _rgb_file(between=P.chunk(b"XXXX",
                                                                b"x")),
    "IEND with a body": lambda: _rgb_file()[:-12] + P.chunk(b"IEND", b"xx"),
    # palette and tRNS chunks
    "palette": lambda: _palette_file("PLTE", "tRNS", "IDAT"),
    "palette without PLTE": lambda: _palette_file("IDAT"),
    "PLTE after IDAT": lambda: _palette_file("IDAT", "PLTE"),
    "two PLTE": lambda: _palette_file("PLTE", "PLTE", "IDAT"),
    "PLTE of 7 bytes": lambda: _palette_file("bad PLTE", "IDAT"),
    "crc PLTE": lambda: _palette_file("crc PLTE", "IDAT"),
    "crc palette tRNS": lambda: _palette_file("PLTE", "crc tRNS", "IDAT"),
    "tRNS before PLTE": lambda: _palette_file("tRNS", "PLTE", "IDAT"),
    "tRNS after IDAT": lambda: _palette_file("PLTE", "IDAT", "tRNS"),
    "two tRNS": lambda: _palette_file("PLTE", "tRNS", "long tRNS", "IDAT"),
    "bad tRNS then a good one": lambda: _palette_file(
        "PLTE", "long tRNS", "tRNS", "IDAT"),
    "empty tRNS": lambda: _palette_file("PLTE", "empty tRNS", "IDAT"),
    "PLTE of 7 bytes on RGB": lambda: _after_ihdr(
        _rgb_file(), P.chunk(b"PLTE", bytes(7))),
    "PLTE on gray": lambda: _after_ihdr(
        P.encode(_samples(5, 6, 0, 8, 3), 8, 0),
        P.chunk(b"PLTE", bytes(6))),
    "tRNS on RGBA": lambda: _after_ihdr(
        P.encode(_samples(5, 6, 6, 8, 3), 8, 6), P.chunk(b"tRNS", bytes(6))),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_png_faults_read_as_cv2(tmp_path, name):
    """Each fault gives what ``cv2.imdecode`` gives: an image (libpng warns
    and reads on) or None (libpng or cv2 stops)."""
    _assert_reads_as_cv2(tmp_path, FAULTS[name]())


def test_unfilter_every_filter_type_at_every_depth(tmp_path):
    """The filters work on bytes with bpp the bytes of a pixel (1 below 8
    bits): a file of each filter type alone, 16-bit RGBA and 2-bit gray."""
    for ft in range(5):
        for ctype, depth in ((6, 16), (0, 2)):
            s = _samples(7, 11, ctype, depth, ft)
            _assert_reads_as_cv2(tmp_path, P.encode(s, depth, ctype,
                                                   filters=ft))
