"""The port's tensor ops of the six exact tier against the JAX package:
percentiles, box and guided filters, Canny, the prefix sums and the exact
quadtree airlight; and the numpy PNG codec against cv2."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu.ops import airlight as jair
from underwater_image_enhancement_tpu.ops import boxfilter as jbox
from underwater_image_enhancement_tpu.ops import edges as jedges
from underwater_image_enhancement_tpu.ops import guided as jguided
from underwater_image_enhancement_tpu.ops import stretch as jstretch
from underwater_image_enhancement_tpu.pipeline import cast as jcast
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch.ops import airlight as tair
from underwater_image_enhancement_tpu_torch.ops import boxfilter as tbox
from underwater_image_enhancement_tpu_torch.ops import edges as tedges
from underwater_image_enhancement_tpu_torch.ops import guided as tguided
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops import stretch as tstretch
from underwater_image_enhancement_tpu_torch.pipeline import cast as tcast
from underwater_image_enhancement_tpu_torch.utils import io as tio

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def underwater_img():
    """conftest's underwater_img, drawn without the session rng
    (tests/torch_frames.py)."""
    return torch_frames.underwater_img()


PAIRS = [(5.0, 98.0), (15.0, 95.0), (20.0, 85.0), (2.0, 98.0), (10.0, 90.0)]


def _planes(seed, shape=(96, 128), grid=False):
    rng = np.random.default_rng(seed)
    p = rng.random((3,) + shape).astype(np.float32)
    if grid:
        p = (np.floor(p * 255) / 255).astype(np.float32)
    return p


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("lo,hi", PAIRS)
def test_percentiles_bit_equal(lo, hi, grid):
    p = _planes(int(lo), grid=grid)
    got = tstretch.percentiles_planes(
        tuple(torch.from_numpy(x) for x in p), (lo, hi)).numpy()
    radix = jstretch.percentiles_radix_planes(
        tuple(jnp.asarray(x) for x in p), (lo, hi))
    for c in range(3):
        srt = jstretch._perc_pair_sort(jnp.asarray(p[c]), lo, hi)
        np.testing.assert_array_equal(got[c], np.asarray(srt))
        np.testing.assert_array_equal(got[c], np.asarray(radix[c]))


@pytest.mark.parametrize("r", [10, 15, 20])
def test_box_filter_bit_equal(r):
    x = _planes(r)
    got = tbox.box_filter(torch.from_numpy(x), r).numpy()
    want = np.asarray(jbox.box_filter(jnp.asarray(x), r))
    assert np.abs(got - want).max() <= 1e-6
    np.testing.assert_array_equal(got, want)  # observed: bit-equal


@pytest.mark.parametrize("r,eps", [(20, 0.5), (15, 0.5), (10, 0.1)])
def test_guided_filter_within_1e6(r, eps):
    p = _planes(r + 1, grid=True)
    got = tguided.guided_filter(torch.from_numpy(p[0]), torch.from_numpy(p[1]),
                                r, eps).numpy()
    want = np.asarray(jguided.guided_filter(jnp.asarray(p[0]),
                                            jnp.asarray(p[1]), r, eps))
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("shape", [(96, 128), (37, 50), (16, 16)])
def test_cumsum_association_bit_equal(shape):
    """xla_cumsum reproduces the f32 association of jnp.cumsum on XLA:CPU."""
    x = _planes(sum(shape), shape)
    for axis in (-1, -2):
        got = kernels.xla_cumsum(torch.from_numpy(x), axis).numpy()
        want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=axis))(x))
        np.testing.assert_array_equal(got, want)


def _gray(seed, shape):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = 128 + 90 * np.sin(xx / 6.0) * np.cos(yy / 9.0)
    return np.clip(base + rng.normal(0, 25, shape), 0, 255).astype(np.int32)


@pytest.mark.parametrize("shape", [(96, 128), (61, 83)])
def test_canny_bit_equal(shape):
    g = _gray(1, shape)
    got = tedges.canny_u8(torch.from_numpy(g)).numpy()
    want = np.asarray(jedges.canny_u8(jnp.asarray(g)))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_canny_valid_hw_batched_bit_equal():
    """Four replicate-padded crops in one batched call, as the airlight
    descent issues them, each equal to JAX's valid_hw Canny."""
    g = _gray(2, (60, 80))
    hws = [(60, 80), (59, 80), (60, 79), (33, 47)]
    bufs = []
    for h, w in hws:
        b = g.copy()
        b[h:] = b[h - 1]
        b[:, w:] = b[:, w - 1:w]
        bufs.append(b)
    got = tedges.canny_u8(torch.from_numpy(np.stack(bufs)),
                          valid_hw=([h for h, _ in hws], [w for _, w in hws]))
    for k, (h, w) in enumerate(hws):
        want = np.asarray(jedges.canny_u8(jnp.asarray(bufs[k]),
                                          valid_hw=(h, w)))
        np.testing.assert_array_equal(got[k].numpy(), want)


def _seeded_frame(seed):
    rng = np.random.default_rng(seed)
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([0.2 + 0.15 * np.cos(xx / 13.0 + seed),
                     0.5 + 0.2 * np.sin(yy / 19.0) * np.cos(xx / 29.0),
                     0.6 + 0.1 * (yy / h)], -1)
    img = np.clip(base + rng.normal(0, 0.05, (h, w, 3)), 0, 1)
    return (np.floor(img.astype(np.float32) * 255) / 255).astype(np.float32)


def _jax_airlight_and_box(planes):
    """The JAX descent's A and final box: a copy of its exact airlight
    function whose globals map _brightest_pixel to a version that also
    returns the box (the module and its jit caches stay untouched)."""
    import types

    def with_box(p, r0, c0, h, w):
        return jair._brightest_pixel(p, r0, c0, h, w), jnp.stack([r0, c0, h, w])

    fn = jair.quadtree_airlight_exact_planes.__wrapped__
    env = dict(fn.__globals__, _brightest_pixel=with_box)
    clone = types.FunctionType(fn.__code__, env, fn.__name__,
                               fn.__defaults__, fn.__closure__)
    A, box = jax.jit(clone)(planes)
    return np.asarray(A), tuple(int(v) for v in np.asarray(box))


# seeds 13 and 36 flip the descent under a plain f32 torch.cumsum
# (test_plain_cumsum_flips_the_descent); kernels.sat_rows in XLA:CPU's
# order keeps them equal to JAX
@pytest.mark.parametrize("which", ["underwater_img", 11, 12, 13, 36])
def test_airlight_exact_bit_equal(which, underwater_img):
    img = underwater_img if which == "underwater_img" else _seeded_frame(which)
    img = np.asarray(jcast.detect_and_correct(jnp.asarray(img))[0])
    planes = [np.ascontiguousarray(img[..., c]) for c in range(3)]
    want_A, want_box = _jax_airlight_and_box(
        tuple(jnp.asarray(p) for p in planes))
    np.testing.assert_array_equal(
        want_A, np.asarray(jair.quadtree_airlight_exact_planes(
            tuple(jnp.asarray(p) for p in planes))))
    A, box = tair.quadtree_airlight_exact_planes(
        tuple(torch.from_numpy(p) for p in planes), return_box=True)
    assert box == want_box
    np.testing.assert_array_equal(A.numpy(), want_A)


@pytest.mark.parametrize("seed", [13, 36])
def test_plain_cumsum_flips_the_descent(seed, monkeypatch):
    """Why the prefix sums keep XLA:CPU's association: with a plain f32
    (or f64) torch.cumsum in place of kernels.sat_rows the descent of these
    frames ends in another box than with XLA:CPU's order, which
    test_airlight_exact_bit_equal holds equal to JAX."""
    img, _ = tcast.detect_and_correct(torch.from_numpy(_seeded_frame(seed)))
    planes = tuple(img[..., c].contiguous() for c in range(3))
    A, box = tair.quadtree_airlight_exact_planes(planes, return_box=True)
    for dtype in (torch.float32, torch.float64):
        def plain_cumsum(x, dim=-2, dt=dtype):
            c = torch.cumsum(x.to(dt), dim).to(x.dtype)
            pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [1, 0]
            return torch.nn.functional.pad(c, pad)

        # the descent's prefix sums: the row table and the corner strips
        monkeypatch.setattr(kernels, "sat_rows", plain_cumsum)
        A2, box2 = tair.quadtree_airlight_exact_planes(planes,
                                                        return_box=True)
        assert box2 != box and not torch.equal(A2, A)


def test_cast_matches_jax(underwater_img):
    for img in (underwater_img, _seeded_frame(11), _seeded_frame(12)):
        want_img, want_code = jcast.detect_and_correct(jnp.asarray(img))
        got_img, got_code = tcast.detect_and_correct(torch.from_numpy(img))
        assert int(got_code) == int(want_code)
        np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_roundtrip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (23, 31) if channels == 1 else (23, 31, channels)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(tio.decode_png(tio.encode_png(a)), a)
    path = tmp_path / "x.png"
    path.write_bytes(tio.encode_png(a))
    rgb = tio.imread_u8(str(path))
    want = np.repeat(a[..., None], 3, 2) if channels == 1 else a[..., :3]
    np.testing.assert_array_equal(rgb, want)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "gray_alpha"])
@pytest.mark.parametrize("level", [0, 3, 9])
def test_png_decodes_cv2_output(tmp_path, kind, level):
    """cv2/libpng choose per-row filters (Sub, Up, Average, Paeth), so
    natural-looking content exercises all five."""
    yy, xx = np.mgrid[0:40, 0:57]
    rng = np.random.default_rng(level)
    base = (np.stack([xx * 4, yy * 6, (xx + yy) * 3, xx * yy % 256], -1)
            + rng.integers(0, 9, (40, 57, 4))) % 256
    bgra = base.astype(np.uint8)
    img = {"rgb": bgra[..., :3], "rgba": bgra, "gray": bgra[..., 0],
           "gray_alpha": bgra[..., :2]}[kind]
    path = tmp_path / "cv.png"
    if kind == "gray_alpha":  # cv2 writes no gray+alpha: encode it here
        path.write_bytes(_gray_alpha_png(img))
        want = np.repeat(img[..., :1], 3, 2)
    else:
        assert cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        want = jio.imread_unit(str(path))
        want = np.round(want * 255).astype(np.uint8)
    np.testing.assert_array_equal(tio.imread_u8(str(path)), want)
    if kind != "gray_alpha":
        np.testing.assert_array_equal(tio.imread_unit(str(path)),
                                      jio.imread_unit(str(path)))


def _gray_alpha_png(ga):
    """A gray+alpha PNG (colour type 4) with every row Paeth-filtered."""
    import struct
    import zlib

    H, W, _ = ga.shape
    flat = ga.reshape(H, W * 2).astype(np.int64)
    rows = []
    for y in range(H):
        prev = flat[y - 1] if y else np.zeros(W * 2, np.int64)
        out = []
        for x in range(W * 2):
            a = flat[y, x - 2] if x >= 2 else 0
            b = prev[x]
            c = prev[x - 2] if x >= 2 else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out.append((flat[y, x] - pred) & 255)
        rows.append(bytes([4] + out))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 4, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_reads_and_writes_like_the_jax_io(tmp_path, underwater_img):
    """What the JAX package's utils/io writes, the port reads to the same
    floats; what the port writes, the JAX package reads back the same."""
    jio.imwrite_unit(str(tmp_path / "j.png"), underwater_img)
    tio.imwrite_unit(str(tmp_path / "t.png"), underwater_img)
    for name in ("j.png", "t.png"):
        got = tio.imread_unit(str(tmp_path / name))
        np.testing.assert_array_equal(got, jio.imread_unit(str(tmp_path / name)))
        np.testing.assert_array_equal(got, underwater_img)


def test_png_rejects_what_it_cannot_read(tmp_path):
    bad = tmp_path / "junk.png"
    bad.write_bytes(b"not an image")
    assert tio.imread_unit(str(bad)) is None
    deep = tmp_path / "deep.png"
    assert cv2.imwrite(str(deep), np.full((4, 4, 3), 65535, np.uint16))
    # a 16-bit PNG reads as the JAX package reads it: cv2's samples / 255
    np.testing.assert_array_equal(tio.imread_unit(str(deep)),
                                  np.full((4, 4, 3), 257.0, np.float32))
    # a format cv2 writes and the port does not (JPEG is written since
    # F1's repair: tests/test_torch_write.py)
    with pytest.raises(ValueError):
        tio.imwrite_unit(str(tmp_path / "x.webp"), np.zeros((2, 2, 3)))
