"""Phase-1 labeling end to end on the CPU: the port's label_batch,
auto_enhance_batch, ``cli auto`` and ``cli build-dataset [--fast]``
against the JAX package's _label_batch, auto_enhance_batch and CLI (run
with ``--devices 1``, so that it compiles no 8-device program).

Tolerances: exact-tier scores within 1e-2 and features within 1e-4
relative or 1e-5 absolute (LBP 2.5/n).  The metrics themselves agree
within 1e-3 on the same planes (tests/test_torch_quality.py), but the
CLAHE strategy's output lies 1 ulp off JAX's on many pixels (jitted XLA
computes the inverse LAB's /255 as a multiply by 1/255; the TPU kernel and
the port divide), and its 20-85 stretch puts many of them on exact u8
boundaries, where the metrics' truncation moves them by one level (64 of
4800 pixels of frame 0; 2.0e-3 on its total).  Fast-tier scores within 0.5 and
features within 1 % or 0.02 (the JAX suite's fast-versus-exact bars; JAX
on the CPU also converts the fast CLAHE leg exactly where the port runs K8
``_approx``).  Labels follow from the scores: JAX's winner must be the
port's wherever JAX's top-two gap is at least 1e-2 (exact) or 0.5 (fast);
below that, the port's pick must score within that gap of JAX's best."""

import csv
import pickle
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu.pipeline.enhance import (
    auto_enhance_batch as jax_auto,
)
from underwater_image_enhancement_tpu.select.system import (
    DatasetItem as JaxDatasetItem,
    _label_batch as jax_label_batch,
)
from underwater_image_enhancement_tpu.utils import config as jconfig
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
    CONFIG_ORDER,
    auto_enhance_batch,
)
from underwater_image_enhancement_tpu_torch.pipeline.strategies import (
    DEHAZE,
    LABEL_ORDER,
    STRATEGY_DISPLAY,
)
from underwater_image_enhancement_tpu_torch.select.system import (
    SelfSupervisedSystem,
    label_batch,
)
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils.config import (
    DEFAULT_QUALITY_WEIGHTS,
    Config,
)

torch.set_num_threads(2)

WEIGHTS = tuple(sorted(jconfig.DEFAULT_QUALITY_WEIGHTS.items()))
SCORE_TOL = {False: 1e-2, True: 0.5}
GAP = {False: 1e-2, True: 0.5}


def _frames():
    """Three 60x80 frames on the u8 grid (one batch for every program)."""
    uw = torch_frames.underwater_img()
    rng = np.random.default_rng(11)
    noisy = np.clip(uw[::2, ::2] * 0.8 + rng.normal(0, 0.05, (60, 80, 3)),
                    0, 1)
    return np.stack([
        uw[::2, ::2], uw[1::2, 1::2][::-1],
        (np.floor(noisy * 255) / 255).astype(np.float32)]).astype(np.float32)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.fixture(scope="module")
def jax_label():
    imgs = _frames()
    out = {}
    for fast in (False, True):
        for return_all in (False, True):
            out[fast, return_all] = [np.asarray(x) for x in jax_label_batch(
                jnp.asarray(imgs), WEIGHTS, return_all, fast=fast)]
    return imgs, out


def _check_winners(got_best, got_scores, want_best, want_scores, fast):
    """JAX's winner is the port's unless JAX's top two lie within GAP;
    then the port's pick scores (by JAX) within GAP of JAX's best."""
    for j in range(len(want_best)):
        s = np.sort(want_scores[j])[::-1]
        if s[0] - s[1] >= GAP[fast]:
            assert int(got_best[j]) == int(want_best[j]), (j, want_scores[j])
        else:
            assert want_scores[j, int(got_best[j])] >= s[0] - GAP[fast]
    assert np.abs(np.asarray(got_scores, np.float64)
                  - want_scores).max() <= SCORE_TOL[fast]


def _check_features(got, want, fast, n_pixels):
    err = np.abs(np.asarray(got, np.float64) - want)
    if fast:
        ok = (err < 0.01 * np.maximum(np.abs(want), 1e-6)) | (err < 0.02)
    else:
        ok = (err <= 1e-4 * np.abs(want)) | (err <= 1e-5)
        ok[..., 35:45] = err[..., 35:45] <= 2.5 / n_pixels
    assert ok.all(), np.argwhere(~ok)


def _check_image(got, want, name, fast):
    if name in DEHAZE:
        assert _psnr(got, want) >= 50.0, name
    elif fast and name == "clahe_enhancement":
        assert _psnr(got, want) >= 25.0, name
    else:
        assert np.abs(np.asarray(got, np.float64) - want).max() <= 1e-6, name


@pytest.mark.parametrize("return_all", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_label_batch_matches_jax(jax_label, fast, return_all):
    imgs, ref = jax_label
    w_feats, w_scores, w_best, w_images = ref[fast, return_all]
    kernels.reset_launches()
    feats, scores, best, images = label_batch(
        torch.from_numpy(imgs), dict(WEIGHTS), return_all, fast)
    assert sum(kernels.launches.values()) == 0
    assert feats.shape == (3, 79) and scores.shape == (3, 5)
    assert best.shape == (3,) and images.shape == w_images.shape
    _check_winners(best.numpy(), scores.numpy(), w_best, w_scores, fast)
    _check_features(feats.numpy(), w_feats, fast, imgs[0].size // 3)
    for j in range(3):
        if return_all:
            for k, name in enumerate(LABEL_ORDER):
                _check_image(images[j, k].numpy(), w_images[j, k], name, fast)
        elif int(best[j]) == int(w_best[j]):
            _check_image(images[j].numpy(), w_images[j],
                         LABEL_ORDER[int(best[j])], fast)


def test_label_batch_winner_is_its_strategy_output(jax_label):
    """return_all=False picks, on the device, the argmax's output of the
    stack return_all=True gives."""
    imgs, _ = jax_label
    x = torch.from_numpy(imgs)
    _, s1, b1, winners = label_batch(x, DEFAULT_QUALITY_WEIGHTS)
    _, s2, b2, stack = label_batch(x, DEFAULT_QUALITY_WEIGHTS, True)
    assert torch.equal(s1, s2) and torch.equal(b1, b2)
    assert torch.equal(b1, torch.argmax(s1, 1))
    for j in range(3):
        assert torch.equal(winners[j], stack[j, int(b1[j])])


@pytest.fixture(scope="module")
def jax_auto_out(jax_label):
    imgs, _ = jax_label
    return [np.asarray(x) for x in jax_auto(jnp.asarray(imgs))]


def test_auto_enhance_batch_matches_jax(jax_label, jax_auto_out):
    imgs, _ = jax_label
    w_imgs, w_best, w_scores = jax_auto_out
    kernels.reset_launches()
    b_imgs, best, scores = auto_enhance_batch(imgs, device="cpu")
    assert sum(kernels.launches.values()) == 0
    assert b_imgs.shape == imgs.shape and best.dtype == torch.int64
    _check_winners(best.numpy(), scores.numpy(), w_best, w_scores, False)
    for j in range(3):
        if int(best[j]) == int(w_best[j]):
            _check_image(b_imgs[j].numpy(), w_imgs[j],
                         CONFIG_ORDER[int(best[j])], False)


def test_auto_and_build_dataset_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        auto_enhance_batch(_frames())
    with pytest.raises(RuntimeError, match="CUDA"):
        SelfSupervisedSystem(Config())._label_batch_np(_frames())
    for cmd in ("auto", "build-dataset"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main([cmd, "--input", ".", "--output", "unused"])


@pytest.mark.parametrize("cmd", ["auto", "build-dataset"])
def test_cli_rejects_devices(cmd):
    """More cards than are visible end the run before any frame."""
    with pytest.raises(SystemExit, match="--devices 64: 64 CUDA devices"):
        tcli.main([cmd, "--input", ".", "--output", "unused", "--devices",
                   "64", "--device", "cuda"])


def _write_folder(folder):
    folder.mkdir()
    for i, img in enumerate(_frames()):
        tio.imwrite_unit(str(folder / f"f{i}.png"), img)
    tio.imwrite_unit(str(folder / "tiny.png"), _frames()[0][:8, :8].copy())
    (folder / "broken.png").write_bytes(b"not a png")


def _auto_lines(text):
    return {m.group(1): (m.group(2), float(m.group(3))) for m in re.finditer(
        r"^(\S+\.png): (\w+) \(([-0-9.]+)\)$", text, re.M)}


def test_cli_auto_matches_jax_cli(tmp_path, capsys, jax_auto_out):
    from underwater_image_enhancement_tpu.cli import main as jax_main

    src = tmp_path / "in"
    _write_folder(src)
    (src / "tiny.png").unlink()  # auto has no size floor
    tcli.main(["auto", "--input", str(src), "--output",
               str(tmp_path / "torch"), "--device", "cpu"])
    got = _auto_lines(capsys.readouterr().out)
    jax_main(["auto", "--input", str(src), "--output", str(tmp_path / "jax"),
              "--devices", "1"])
    want = _auto_lines(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == ["f0.png", "f1.png", "f2.png"]
    w_best = np.array([CONFIG_ORDER.index(want[f][0]) for f in sorted(want)])
    _check_winners(np.array([CONFIG_ORDER.index(got[f][0])
                             for f in sorted(got)]),
                   jax_auto_out[2], w_best, jax_auto_out[2], False)
    for f in sorted(want):
        assert abs(got[f][1] - want[f][1]) <= 0.011, (f, got[f], want[f])
        name = got[f][0]
        png = f"{Path(f).stem}_{name}.png"
        assert (tmp_path / "torch" / png).exists()
        if name == want[f][0]:
            a = tio.imread_u8(str(tmp_path / "torch" / png)) / 255.0
            b = tio.imread_u8(str(tmp_path / "jax" / png)) / 255.0
            if name in DEHAZE:
                assert _psnr(a, b) >= 50.0, png
            else:
                assert np.abs(a - b).max() <= 1 / 255 + 1e-9, png
    assert len(list((tmp_path / "torch").glob("*.png"))) == 3


@pytest.mark.parametrize("fast", [False, True])
def test_cli_build_dataset_matches_jax_cli(tmp_path, capsys, jax_label, fast):
    from underwater_image_enhancement_tpu.cli import main as jax_main

    src = tmp_path / "in"
    _write_folder(src)
    extra = ["--fast"] if fast else []
    tcli.main(["build-dataset", "--input", str(src), "--output",
               str(tmp_path / "torch"), "--device", "cpu"] + extra)
    out = capsys.readouterr().out
    assert "labeled 3 images" in out and "tiny.png too small" in out
    jax_main(["build-dataset", "--input", str(src), "--output",
              str(tmp_path / "jax"), "--devices", "1"] + extra)
    capsys.readouterr()
    rows = {}
    for side in ("torch", "jax"):
        with open(tmp_path / side / "reports" / "dataset_building.csv",
                  newline="") as f:
            reader = csv.DictReader(f)
            rows[side] = (reader.fieldnames, list(reader))
    names = [STRATEGY_DISPLAY[k] for k in LABEL_ORDER]
    assert rows["torch"][0] == rows["jax"][0] == [
        "filename", "best_strategy", "best_score"] + names
    assert [r["filename"] for r in rows["torch"][1]] == ["f0.png", "f1.png",
                                                          "f2.png"]
    assert ([r["filename"] for r in rows["torch"][1]]
            == [r["filename"] for r in rows["jax"][1]])
    sc = {side: np.array([[float(r[n]) for n in names] for r in rows[side][1]])
          for side in rows}
    best = {side: np.array([names.index(r["best_strategy"])
                            for r in rows[side][1]]) for side in rows}
    _check_winners(best["torch"], sc["torch"], best["jax"], sc["jax"], fast)
    for r in rows["torch"][1]:
        assert float(r["best_score"]) == float(r[r["best_strategy"]])
        png = f"{Path(r['filename']).stem}_{r['best_strategy']}.png"
        assert (tmp_path / "torch" / "strategy_results" / png).exists()
    assert len(list((tmp_path / "torch" / "strategy_results").glob("*.png"))) == 3
    # dataset.pkl: the JAX package's DatasetItem reads the port's file
    with open(tmp_path / "torch" / "trained_models" / "dataset.pkl", "rb") as f:
        items = [JaxDatasetItem(**d) for d in pickle.load(f)]
    with open(tmp_path / "jax" / "trained_models" / "dataset.pkl", "rb") as f:
        want = [JaxDatasetItem(**d) for d in pickle.load(f)]
    assert [i.filename for i in items] == [i.filename for i in want]
    for it, r in zip(items, rows["torch"][1]):
        assert it.features.shape == (79,) and it.features.dtype == np.float32
        assert it.best_strategy == r["best_strategy"]
        assert set(it.all_scores) == set(names)
    _check_features(np.stack([i.features for i in items]),
                    np.stack([i.features for i in want]), fast,
                    jax_label[0][0].size // 3)


def test_build_dataset_save_all_and_label_image(tmp_path):
    src = tmp_path / "in"
    _write_folder(src)
    system = SelfSupervisedSystem(
        Config(image_folder=str(src), output_folder=str(tmp_path / "o"),
               save_all_enhanced=True, batch_size=2), device="cpu")
    rows = system.build_dataset(log=lambda m: None)
    assert [r["filename"] for r in rows] == ["f0.png", "f1.png", "f2.png"]
    pngs = sorted(p.name for p in
                  (tmp_path / "o" / "strategy_results").glob("*.png"))
    names = [STRATEGY_DISPLAY[k] for k in LABEL_ORDER]
    assert pngs == sorted(f"f{i}_{n}.png" for i in range(3) for n in names)
    report = system.dataset_report()
    assert sum(v["count"] for v in report.values()) == 3
    winner, item = system.label_image(_frames()[0])
    assert winner.shape == (60, 80, 3) and winner.dtype == np.float32
    assert item.best_strategy == rows[0]["best_strategy"]
    np.testing.assert_array_equal(item.features, system.dataset[0].features)
