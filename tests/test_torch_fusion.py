"""The Ancuti fusion of the port (``ops/pyramid``, ``pipeline/fusion``,
``cli fusion``) against the JAX package, cv2 and the float64 oracle
(``testing/golden_fusion``).

The JAX ``ancuti_fusion`` is jitted; its gray-world planes are quantised to
u8 by the CLAHE leg, so the port repeats the jitted program's means
(XLA:CPU's summation order, times the reciprocal of the count) and its
literal divisions (reciprocal multiplies), and the gray-world planes are
bit-equal.  The rest differs from JAX only in the last bits of the
saliency's Lab (``pow`` and ``cbrt``, the sRGB curve's divisions, and its
means, one ``torch.mean`` an image): on the fixture frame the fused output
is within 2.4e-7 of JAX's (about 150 dB); the gate here is 1e-6 and 50 dB.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.ops import pyramid as jpyr
from underwater_image_enhancement_tpu.pipeline import fusion as jfusion
from underwater_image_enhancement_tpu.testing import golden_fusion as gf
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops import pyramid as tpyr
from underwater_image_enhancement_tpu_torch.pipeline import fusion as tfusion
from underwater_image_enhancement_tpu_torch.utils import io as tio

from tests import torch_frames

torch.set_num_threads(2)

FUSION_MAX_ABS = 1e-6  # port against JAX (observed 2.4e-7 on the fixture)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _plane(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _other(img):
    """The JAX batch test's second frame: flipped, dimmed, on the u8 grid."""
    return (np.floor(np.clip(img[::-1] * 0.8 + 0.05, 0, 1) * 255) / 255
            ).astype(np.float32)


@pytest.fixture(scope="module")
def underwater_img():
    return torch_frames.underwater_img()


@pytest.fixture(scope="module")
def jax_fused(underwater_img):
    return {name: np.asarray(jfusion.ancuti_fusion(jnp.asarray(im)))
            for name, im in (("fixture", underwater_img),
                             ("other", _other(underwater_img)))}


@pytest.mark.parametrize("which", ["down", "up"])
def test_pyr_down_up_match_cv2_and_jax(which):
    """cv2's pyramid filters within 1e-5 (the JAX suite's gate), and the
    JAX functions (jitted) bit for bit: the taps sum in its order."""
    if which == "down":
        x = _plane((128, 192), 3)
        got = tpyr.pyr_down(torch.from_numpy(x)).numpy()
        want_cv = cv2.pyrDown(x)
        want_jax = np.asarray(jax.jit(jpyr.pyr_down)(x))
        shape = (64, 96)
    else:
        x = _plane((64, 96), 4)
        got = tpyr.pyr_up(torch.from_numpy(x), (128, 192)).numpy()
        want_cv = cv2.pyrUp(x)
        want_jax = np.asarray(jax.jit(lambda v: jpyr.pyr_up(v, (128, 192)))(x))
        shape = (128, 192)
    assert got.shape == want_cv.shape == shape
    assert np.abs(got - want_cv).max() < 1e-5
    np.testing.assert_array_equal(got, want_jax)


@pytest.mark.parametrize("shape", [(128, 192), (101, 147)])
def test_laplacian_pyramid_reconstructs(shape):
    """reconstruct(laplacian_pyramid(x)) == x within 1e-5, odd sizes too;
    each level bit-equal to the JAX pyramid's."""
    x = _plane(shape, 5)
    lap = tpyr.laplacian_pyramid(torch.from_numpy(x), 4)
    want = jax.jit(lambda v: jpyr.laplacian_pyramid(v, 4))(x)
    for got_l, want_l in zip(lap, want):
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    back = tpyr.reconstruct(lap).numpy()
    assert np.abs(back - x).max() < 1e-5


def test_gray_world_wb_bit_equal_to_jax(underwater_img):
    """The gray-world planes equal the jitted JAX program's bit for bit
    (its means in XLA:CPU's order), one image and a batch of two."""
    batch = np.stack([underwater_img, _other(underwater_img)])
    want = np.asarray(jax.jit(jax.vmap(jfusion.gray_world_wb))(batch))
    got = tfusion.gray_world_wb(torch.from_numpy(batch)).numpy()
    np.testing.assert_array_equal(got, want)
    single = np.asarray(jax.jit(jfusion.gray_world_wb)(underwater_img))
    np.testing.assert_array_equal(
        tfusion.gray_world_wb(torch.from_numpy(underwater_img)).numpy(), single)
    # the oracle's gate (tests/test_fusion.py)
    assert _psnr(got[0], gf.gray_world_wb(underwater_img.astype(np.float64))) > 55


@pytest.mark.parametrize("which", ["fixture", "other"])
def test_ancuti_fusion_matches_jax_and_oracle(underwater_img, jax_fused, which):
    img = underwater_img if which == "fixture" else _other(underwater_img)
    before = dict(kernels.launches)
    got = tfusion.ancuti_fusion(torch.from_numpy(img)).numpy()
    assert kernels.launches == before  # CPU tensors: the plain versions
    assert got.shape == img.shape and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    want = jax_fused[which]
    assert np.abs(got - want).max() <= FUSION_MAX_ABS
    assert _psnr(got, want) >= 50.0
    assert _psnr(got, gf.ancuti_fusion(img.astype(np.float64))) >= 50.0


def test_ancuti_fusion_batch_equals_single(underwater_img):
    batch = np.stack([underwater_img, _other(underwater_img)])
    got = tfusion.ancuti_fusion(torch.from_numpy(batch)).numpy()
    for i in range(2):
        single = tfusion.ancuti_fusion(torch.from_numpy(batch[i])).numpy()
        np.testing.assert_array_equal(got[i], single)


def test_cli_fusion_cpu(tmp_path, underwater_img, jax_fused, capsys):
    """``cli fusion --device cpu`` on a two-file folder: one
    ``<stem>_fusion.png`` a file, the JAX output quantised as the JAX CLI
    writes it (clip * 255, truncated) within one level, and the JAX CLI's
    closing line."""
    src, out = tmp_path / "in", tmp_path / "out"
    frames = {"a": underwater_img, "b": _other(underwater_img)}
    for stem, im in frames.items():
        tio.imwrite_unit(str(src / f"{stem}.png"), im)
    tcli.main(["fusion", "--input", str(src), "--output", str(out),
               "--device", "cpu"])
    assert f"fused 2 images -> {out}" in capsys.readouterr().out
    assert sorted(p.name for p in out.iterdir()) == ["a_fusion.png",
                                                     "b_fusion.png"]
    for stem, which in (("a", "fixture"), ("b", "other")):
        got = tio.imread_u8(str(out / f"{stem}_fusion.png")).astype(np.int32)
        want = (np.clip(jax_fused[which], 0, 1) * 255).astype(np.uint8)
        assert np.abs(got - want.astype(np.int32)).max() <= 1


def test_fusion_levels_and_weights_match_jax(underwater_img):
    """The level count, and one input's weight maps within 1e-6 of the
    jitted JAX ``_weight_maps`` (the saliency's pow and cbrt differ in
    their last bits)."""
    for hw in ((120, 160), (31, 40), (1080, 1920), (16, 16)):
        assert tfusion._fusion_levels(*hw) == jfusion._fusion_levels(*hw)
    planes = tuple(np.ascontiguousarray(underwater_img[..., c])
                   for c in range(3))
    want = np.asarray(jax.jit(jfusion._weight_maps)(planes))
    got = tfusion._weight_maps_all(
        [tuple(torch.from_numpy(p) for p in planes)])[0]
    assert np.abs(got.numpy() - want).max() <= 1e-6
