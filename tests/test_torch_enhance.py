"""The port's fixed-parameter enhance (``pipeline.enhance.enhance`` and
``enhance_batch``, ``models.diff_enhance``) and ``cli enhance`` on the CPU
against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu.models import diff_enhance as jdiff
from underwater_image_enhancement_tpu.ops import stretch as jstretch
from underwater_image_enhancement_tpu.pipeline import enhance as jenh
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.models import diff_enhance as tdiff
from underwater_image_enhancement_tpu_torch.ops import stretch as tstretch
from underwater_image_enhancement_tpu_torch.pipeline import enhance as tenh
from underwater_image_enhancement_tpu_torch.utils import io as tio

torch.set_num_threads(2)

GRID = np.arange(256, dtype=np.float32) / np.float32(255)


@pytest.fixture(scope="module")
def underwater_img():
    """conftest's underwater_img, drawn without the session rng
    (tests/torch_frames.py)."""
    return torch_frames.underwater_img()


@pytest.fixture(scope="module")
def batch(underwater_img):
    rng = np.random.default_rng(3)
    other = GRID[rng.integers(0, 256, underwater_img.shape)]
    return np.stack([underwater_img, underwater_img[::-1], other]).astype(
        np.float32)


PCTS = [(10.0, 90.0), (5.0, 95.0), (2.5, 99.5), (0.0, 100.0), (33.3, 66.7)]


@pytest.mark.parametrize("lo,hi", PCTS)
def test_index_u8_percentiles_bit_equal(lo, hi, batch):
    """The histogram order statistic under jit, where XLA folds the traced
    pct/100*n into pct * (0.01 * n)."""
    for img in batch:
        c = np.ascontiguousarray(img[..., 1])
        want = jax.jit(jstretch._perc_pair_index_u8)(c, jnp.float32(lo),
                                                     jnp.float32(hi))
        got = tstretch._perc_pair_index_u8(torch.from_numpy(c), lo, hi)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["index", "index-u8"])
def test_color_stretch_batch_bit_equal(mode, batch):
    lo = np.array([10.0, 5.0, 20.0], np.float32)
    hi = np.array([90.0, 95.0, 80.0], np.float32)
    want = jax.jit(lambda x, a, b: jdiff.color_stretch_batch(x, a, b, mode))(
        batch, lo, hi)
    got = tdiff.color_stretch_batch(torch.from_numpy(batch), lo, hi, mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dehaze_batch_bit_equal(batch):
    om = np.array([0.6, 0.3, 0.9], np.float32)
    want = jax.jit(jdiff.dehaze_batch)(batch, om)
    got = tdiff.dehaze_batch(torch.from_numpy(batch), om)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["hist", "index"])
def test_enhance_batch_within_1e6(mode, batch):
    """Against the JAX enhance_batch: the final pow may differ in the last
    ulp, so 1e-6."""
    args = (np.array([10.0, 5.0, 15.0], np.float32), 90.0, 0.6,
            np.array([1.2, 1.5, 0.8], np.float32))
    want = np.asarray(jenh.enhance_batch(jnp.asarray(batch), *args,
                                         stretch_mode=mode))
    got = tenh.enhance_batch(batch, *args, stretch_mode=mode, device="cpu")
    assert got.shape == batch.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("params", [None, {"omega": 0.8, "L_low": 2.0}])
def test_enhance_within_1e6(params, underwater_img):
    want = np.asarray(jenh.enhance(jnp.asarray(underwater_img), params))
    got = tenh.enhance(underwater_img, params, device="cpu").numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert tenh.DEFAULT_PARAMS == jenh.DEFAULT_PARAMS


def test_enhance_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenh.enhance(img)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenh.enhance_batch(img[None], 10.0, 90.0, 0.6, 1.2)


def _u8_diff(a_path, b_path):
    a = tio.imread_u8(str(a_path)).astype(np.int64)
    b = tio.imread_u8(str(b_path)).astype(np.int64)
    assert a.shape == b.shape
    return int(np.abs(a - b).max())


def test_cli_enhance_file_and_folder_match_jax_cli(tmp_path, batch):
    """The port's PNGs against the JAX CLI's: equal, or within 1 u8 LSB
    where a last-ulp difference of the pow crosses a truncation step."""
    from underwater_image_enhancement_tpu.cli import main as jax_main

    src = tmp_path / "in"
    src.mkdir()
    for i, img in enumerate(batch):
        tio.imwrite_unit(str(src / f"f{i}.png"), img)
    tio.imwrite_unit(str(src / "small.png"), batch[0][:40, :48].copy())
    (src / "junk.png").write_bytes(b"not a png")
    opts = ["--omega", "0.7", "--gamma", "1.3", "--l-low", "5",
            "--l-high", "95", "--batch-size", "2"]
    tcli.main(["enhance", "--input", str(src), "--output",
               str(tmp_path / "t"), "--device", "cpu"] + opts)
    jax_main(["enhance", "--input", str(src), "--output",
              str(tmp_path / "j"), "--devices", "1"] + opts)
    names = sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "t").glob("*.png"))
    assert names == ["f0_enhanced.png", "f1_enhanced.png", "f2_enhanced.png",
                     "small_enhanced.png"]
    diffs = {n: _u8_diff(tmp_path / "t" / n, tmp_path / "j" / n)
             for n in names}
    one = src / "f0.png"
    tcli.main(["enhance", "--input", str(one), "--output",
               str(tmp_path / "t1.png"), "--device", "cpu"] + opts)
    jax_main(["enhance", "--input", str(one), "--output",
              str(tmp_path / "j1.png")] + opts)
    diffs["file"] = _u8_diff(tmp_path / "t1.png", tmp_path / "j1.png")
    print("cli enhance, max |port - JAX| in u8 levels:", diffs)
    assert max(diffs.values()) <= 1


@pytest.mark.parametrize("flag", [["--model", "m.npz", "--arch", "resnet",
                                   "--devices", "2"],
                                  ["--devices", "64", "--device", "cuda"]])
def test_cli_enhance_rejects_what_is_not_ported(tmp_path, flag):
    """--devices is rejected where it cannot run: with a predictor of the
    zoo (the predictors run on one device) and beyond the visible cards
    (naming both counts)."""
    with pytest.raises(SystemExit, match="--devices") as e:
        tcli.main(["enhance", "--input", str(tmp_path), "--output",
                   str(tmp_path / "o"), "--device", "cpu"] + flag)
    assert e.value.code != 0
