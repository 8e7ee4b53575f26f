"""The port's GIF reader (``utils/gif.py``) against cv2 5.0.0.

Each file is built here (``tests/torch_formats.py``, 64x96 or smaller)
and read by the port in both modes, bit-equal to ``cv2.imread`` and,
through ``imread_unit`` and ``imread_u8``, to JAX's readers: the first
image of GIF87a and GIF89a files with global and local tables (an index
past the local table read from the global one), no table at all, every
interlaced height, an image smaller than and offset inside the logical
screen (the background colour around it), transparency (four channels
where the file's last graphic control extension sets it, the background
colour with alpha 0 on the transparent pixels), more frames and
extensions, and LZW streams with and without the first clear code and
the end code, clear codes inside, a full table kept, minimum code sizes
2-11.  What cv2 refuses is "unreadable"."""

import cv2
import numpy as np
import pytest

from tests import torch_formats as F
from tests.test_torch_pxm import assert_reads_as_cv2, assert_refused
from underwater_image_enhancement_tpu_torch.utils import gif

H, W = 37, 53
_RNG = np.random.default_rng(27)
PAL = _RNG.integers(0, 256, (256, 3), np.uint8)
yy, xx = np.mgrid[0:H, 0:W]
IDX = ((xx // 5 + yy // 4) * 7 % 256).astype(np.int64)
NOISE = _RNG.integers(0, 256, (H, W))
IDX16 = IDX % 16


def _one(idx=IDX, gct=PAL, blocks=(), sw=W, sh=H, **kw):
    return F.gif(sw, sh, list(blocks) + [F.gif_image(idx, **kw)], gct=gct)


READ = {
    "global table": lambda: _one(),
    "noise": lambda: _one(NOISE),
    "GIF87a": lambda: F.gif(W, H, [F.gif_image(IDX)], PAL, version=b"87a"),
    "local table": lambda: _one(gct=None, lct=PAL),
    "local table over a global one": lambda: _one(IDX16, gct=PAL[:16],
                                                  lct=PAL[100:116]),
    "short local table falls to the global": lambda: _one(
        IDX16, gct=PAL[:16], lct=PAL[100:108]),
    "no table": lambda: _one(gct=None),
    "interlaced": lambda: _one(interlace=True),
    "offset image, background colour": lambda: F.gif(
        W + 9, H + 4, [F.gif_image(IDX, left=5, top=3)], PAL, bg=17),
    "offset image without a global table": lambda: F.gif(
        W + 9, H + 4, [F.gif_image(IDX, left=5, top=3, lct=PAL)], None),
    "transparent index": lambda: _one(IDX16, PAL[:16],
                                      [F.gce(transparent=3)]),
    "transparent background index": lambda: F.gif(
        W + 2, H, [F.gce(transparent=5), F.gif_image(IDX16, left=1)],
        PAL[:16], bg=5),
    "transparent, no global table": lambda: _one(
        IDX16, None, [F.gce(transparent=3)], lct=PAL[:16]),
    "transparent index past the tables": lambda: _one(
        IDX16 | (IDX16 == 3) * 16, PAL[:16], [F.gce(transparent=19)]),
    "two graphic controls, the last wins": lambda: _one(
        IDX16, PAL[:16], [F.gce(transparent=3), F.gce(transparent=4)]),
    "transparency cleared by a later frame": lambda: F.gif(
        W, H, [F.gce(transparent=3), F.gif_image(IDX16), F.gce(disposal=1),
               F.gif_image(IDX16[::-1])], PAL[:16]),
    "transparency set by a later frame": lambda: F.gif(
        W, H, [F.gif_image(IDX16), F.gce(transparent=2),
               F.gif_image(IDX16[::-1])], PAL[:16]),
    "extensions": lambda: _one(blocks=[
        b"\x21\xfe\x05hello\x00",
        b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00",
        b"\x21\x01\x0c" + bytes(12) + b"\x02ab\x00",
        b"\x21\x55\x02ab\x00"]),
    "trailing bytes": lambda: _one() + b"junk",
    "no first clear code": lambda: _one(clear_first=False),
    "no end code": lambda: _one(NOISE, end=False),
    "a full table kept": lambda: _one(NOISE, defer_clear=True),
    "min code size 11": lambda: _one(IDX16, PAL[:16], min_size=11),
    "min code size 2": lambda: _one(IDX & 3, PAL[:4]),
    "clear codes inside": lambda: _one(stream=F.pack_codes(
        F.lzw_codes(IDX[:H // 2], 8)[:-1]
        + F.lzw_codes(IDX[H // 2:], 8))),
}
for _h in (1, 2, 3, 5, 9, 17):
    READ[f"interlaced, {_h} rows"] = (
        lambda h=_h: _one(IDX[:h], sh=h, interlace=True))


@pytest.mark.parametrize("name", sorted(READ))
def test_gif_reads_as_cv2(tmp_path, name):
    assert_reads_as_cv2(tmp_path, READ[name](), gif.decode_gif, ".gif")


def test_transparent_pixels_take_the_background_with_alpha_0():
    data = F.gif(W, H, [F.gce(transparent=3), F.gif_image(IDX16)],
                 PAL[:16], bg=9)
    img = gif.decode_gif(data)
    assert img.shape == (H, W, 4)
    hole = IDX16 == 3
    np.testing.assert_array_equal(img[hole], np.append(PAL[9], 0)[None]
                                  .repeat(hole.sum(), 0))
    np.testing.assert_array_equal(img[~hole][:, :3], PAL[IDX16[~hole]])
    assert (img[~hole][:, 3] == 255).all()
    assert gif.decode_gif(data, True).shape == (H, W, 3)


REFUSED = {
    "GIF88a": lambda: b"GIF88a" + _one()[6:],
    "an empty screen": lambda: _one()[:6] + b"\0\0" + _one()[8:],
    "background past the global table": lambda: F.gif(
        W, H, [F.gif_image(IDX16)], PAL[:16], bg=20),
    "an index past the global table": lambda: _one(IDX, PAL[:16]),
    "an index past the local table": lambda: _one(gct=None, lct=PAL[:16]),
    "an index past both tables": lambda: _one(IDX, PAL[:16], lct=PAL[:32]),
    "image outside the screen": lambda: F.gif(
        W, H, [F.gif_image(IDX, left=1)], PAL),
    "min code size 1": lambda: _one(IDX & 1, PAL[:2], min_size=1),
    "min code size 12": lambda: _one(IDX16, PAL[:16], min_size=12),
    "graphic control of 5 bytes": lambda: _one(
        blocks=[b"\x21\xf9\x05\x01\0\0\x03\0\0"]),
    "no image": lambda: F.gif(W, H, [], PAL),
    "an unknown block": lambda: _one()[:-1] + b"\x99\x3b",
    "no trailer": lambda: _one()[:-1],
    "cut short": lambda: _one()[:-40],
    "more pixels": lambda: _one(NOISE, stream=F.pack_codes(F.lzw_codes(
        np.append(NOISE, [1, 2, 3]), 8))),
    "fewer pixels": lambda: _one(NOISE, stream=F.pack_codes(F.lzw_codes(
        NOISE.reshape(-1)[:-3], 8))),
    "a code past the table": lambda: _one(NOISE, stream=F.pack_codes(
        F.lzw_codes(NOISE, 8)[:5] + [(400, 9)] + F.lzw_codes(NOISE, 8)[5:])),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_gif_cv2_refuses_is_unreadable(tmp_path, name):
    assert_refused(tmp_path, REFUSED[name](), gif.decode_gif, ".gif")
