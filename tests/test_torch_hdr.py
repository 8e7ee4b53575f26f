"""The port's Radiance HDR reader and writer (``utils/hdr.py``) against
cv2 5.0.0.

Each file is built here (``tests/torch_formats.py`` or cv2's writer,
64x96 or smaller) and read by the port in both modes, bit-equal to
``cv2.imread`` (float32 in ``IMREAD_UNCHANGED``, ``saturate_cast(v *
255)`` in ``IMREAD_COLOR``) and, through ``imread_unit`` and
``imread_u8``, to JAX's readers: header lines around ``FORMAT``, both
signatures, ``sscanf``'s spacing of the size line, flat files (under 8
pixels wide, and scanlines that do not start ``2 2``), new-style RLE of
literals and runs, cv2's own RLE, a scanline that falls back to flat
reading, old-style ``1 1 1 n`` repeats (read as pixels, as cv2 reads
them), exponents of 0 and 255.  What cv2 refuses is "unreadable".  The
writer's bytes equal ``cv2.imencode(".hdr")`` on noise, smooth and flat
frames, with runs past 127 and at every row width around 8."""

import cv2
import numpy as np
import pytest

from tests import torch_formats as F
from tests.test_torch_pxm import assert_reads_as_cv2, assert_refused
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu_torch.utils import hdr
from underwater_image_enhancement_tpu_torch.utils import io as tio

H, W = 37, 53
_RNG = np.random.default_rng(26)


def _quads(h=H, w=W):
    """RGBE quads: mantissas of every kind, exponents around 128, and
    runs for RLE to code; a few exponents of 0, 1 and 255."""
    q = _RNG.integers(0, 256, (h, w, 4)).astype(np.uint8)
    q[..., 3] = _RNG.integers(120, 140, (h, w))
    q[:, w // 3:w // 2] = q[:, w // 3:w // 3 + 1]
    q.reshape(-1, 4)[:3, 3] = (0, 1, 255)
    return q


Q = _quads()


def _head(lines=b"", size=b"-Y %d +X %d" % (H, W), sig=b"#?RADIANCE"):
    return sig + b"\n" + lines + b"FORMAT=32-bit_rle_rgbe\n\n" + size + b"\n"


READ = {
    "flat": lambda: F.hdr(Q),
    "RLE literals": lambda: F.hdr(Q, "literals"),
    "RLE runs": lambda: F.hdr(Q, "runs"),
    "#?RGBE": lambda: F.hdr(Q, head=_head(sig=b"#?RGBE")),
    "header lines": lambda: F.hdr(Q, "runs", head=_head(
        b"# made here\nEXPOSURE=2.0\nSOFTWARE=x\n")),
    "a line after FORMAT": lambda: F.hdr(Q, head=(
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nGAMMA=2.2\n\n-Y %d +X %d\n"
        % (H, W))),
    "size without spaces": lambda: F.hdr(Q, head=_head(
        size=b"-Y%d+X%d" % (H, W))),
    "size with extra spaces": lambda: F.hdr(Q, head=_head(
        size=b"-Y  %d \t+X  %d " % (H, W))),
    "7 wide is flat": lambda: F.hdr(Q[:, :7]),
    "8 wide RLE": lambda: F.hdr(Q[:, :8], "runs"),
    "RLE then a flat scanline": lambda: (
        _head(size=b"-Y 3 +X %d" % W) + F.hdr(Q[:1], "runs", head=b"")
        + Q[1:3].tobytes()),
    "old-style RLE read as pixels": lambda: F.hdr_old_rle(Q, W)[0],
    "cv2's writer, noise": lambda: cv2.imencode(
        ".hdr", _RNG.integers(0, 256, (H, W, 3), np.uint8))[1].tobytes(),
    "trailing bytes": lambda: F.hdr(Q) + b"junk",
}


@pytest.mark.parametrize("name", sorted(READ))
def test_hdr_reads_as_cv2(tmp_path, name):
    assert_reads_as_cv2(tmp_path, READ[name](), hdr.decode_hdr, ".hdr")


def test_old_style_rle_reads_as_its_quads():
    """Old-style repeats are not expanded: the file reads as its quads,
    ``rgbe_float`` of each."""
    data, flat = F.hdr_old_rle(Q, W)
    assert (flat[..., :3] == 1).all(-1).any()
    np.testing.assert_array_equal(hdr.decode_hdr(data), F.rgbe_float(flat))


REFUSED = {
    "no blank line after FORMAT": lambda: F.hdr(Q, head=(
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n-Y %d +X %d\n" % (H, W))),
    "XYZE": lambda: F.hdr(Q, head=_head().replace(b"rgbe", b"xyze")),
    "no FORMAT": lambda: F.hdr(Q, head=b"#?RADIANCE\n\n-Y %d +X %d\n"
                               % (H, W)),
    "CRLF lines": lambda: F.hdr(Q, head=_head().replace(b"\n", b"\r\n")),
    "+Y": lambda: F.hdr(Q, head=_head(size=b"+Y %d +X %d" % (H, W))),
    "-X": lambda: F.hdr(Q, head=_head(size=b"-Y %d -X %d" % (H, W))),
    "+X first": lambda: F.hdr(Q, head=_head(size=b"+X %d -Y %d" % (W, H))),
    "height 0": lambda: F.hdr(Q, head=_head(size=b"-Y 0 +X %d" % W)),
    "flat cut short": lambda: F.hdr(Q)[:-1],
    "RLE cut short": lambda: F.hdr(Q, "runs")[:-1],
    "a run of 0": lambda: _head() + bytes([2, 2, 0, W, 128, 7]),
    "a literal of 0": lambda: _head() + bytes([2, 2, 0, W, 0, 7]),
    "a run past the scanline": lambda: _head() + bytes([2, 2, 0, W,
                                                        128 + W + 1, 7]),
    "a scanline of another width": lambda: F.hdr(Q, "runs").replace(
        bytes([2, 2, 0, W]), bytes([2, 2, 0, W + 1]), 1),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_hdr_cv2_refuses_is_unreadable(tmp_path, name):
    assert_refused(tmp_path, REFUSED[name](), hdr.decode_hdr, ".hdr")


def _frame(kind, h, w):
    if kind == "noise":
        return _RNG.integers(0, 256, (h, w, 3), np.uint8)
    if kind == "flat":
        return np.full((h, w, 3), 77, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 3 % 256, yy * 5 % 256, (xx // 9 * 40) % 256],
                    -1).astype(np.uint8)


@pytest.mark.parametrize("kind", ["noise", "smooth", "flat"])
@pytest.mark.parametrize("shape", [(2, 3), (3, 7), (3, 8), (5, 9), (4, 300),
                                   (64, 96)])
def test_hdr_writer_equals_cv2(kind, shape):
    img = _frame(kind, *shape)
    data = hdr.encode_hdr(img)
    assert data == cv2.imencode(".hdr", img[..., ::-1])[1].tobytes()


def test_hdr_of_u8_reads_back_as_jax_reads_it(tmp_path):
    """``.hdr`` and ``.pic`` of a u8 frame: JAX's and the port's readers
    agree bit for bit on the port's file (the samples are ``u8 / 255``
    quantised to RGBE)."""
    img = _frame("noise", 37, 53)
    for suffix in (".hdr", ".pic"):
        path = tmp_path / f"f{suffix}"
        tio.imwrite_unit(str(path), img)
        np.testing.assert_array_equal(tio.imread_unit(str(path)),
                                      jio.imread_unit(str(path)))
        assert np.abs(tio.imread_unit(str(path)) * 255 - img / 255).max() < 0.02


@pytest.mark.parametrize("suffix", [".hdr", ".pfm"])
def test_cli_enhance_float_file_writes_the_jax_clis_bytes(tmp_path, suffix):
    """``enhance --input in<suffix> --output out<suffix>`` of the JAX CLI
    and of the port's (``--device cpu``) on a 64x96 crop of the smooth
    frame written as HDR or PFM: the float samples in, the same bytes
    out."""
    from tests import torch_frames
    from underwater_image_enhancement_tpu import cli as jcli
    from underwater_image_enhancement_tpu_torch import cli as tcli

    src = tmp_path / f"in{suffix}"
    tio.imwrite_unit(str(src), torch_frames.underwater_img()[:64, :96])
    jcli.main(["enhance", "--input", str(src), "--output",
               str(tmp_path / f"jax{suffix}")])
    tcli.main(["enhance", "--input", str(src), "--output",
               str(tmp_path / f"port{suffix}"), "--device", "cpu"])
    data = (tmp_path / f"port{suffix}").read_bytes()
    assert data == (tmp_path / f"jax{suffix}").read_bytes()
