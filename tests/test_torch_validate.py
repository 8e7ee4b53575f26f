"""``validate`` on the CPU: the port's float64 oracles (``utils/oracles``)
against the JAX package's ``testing/golden``, and ``validate_folder`` /
``cli validate`` against JAX's on the procedural underwater fixture
(``tests/test_validate.py``'s folder: ``synth_underwater_set(seed=3, n=6,
h=64, w=96)``, 2 oracle samples, batches of 3).

Held: the same report structure and ``n_images``; the same winner counts
unless an image's top two JAX scores lie within the near-tie gap (1e-2
exact, 0.5 fast; ``tests/test_torch_label.py``); quality means within
2e-3; each PSNR min and mean within 1 dB of JAX's, and, in the exact tier,
above JAX's 45 dB floor.  The PSNRs are against the float64 oracles, so
the dehazing strategies' 50 dB agreement with JAX shows as noise there,
not as a gap (measured: the two reports' largest PSNR gap is printed with
``-s``).  The fast tier differs from the exact oracles by design (20-33 dB
on this folder in both packages).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.select.system import (
    _label_batch as jax_label_batch,
)
from underwater_image_enhancement_tpu.testing import golden
from underwater_image_enhancement_tpu.testing.underwater import (
    synth_underwater_set,
)
from underwater_image_enhancement_tpu.utils import config as jconfig
from underwater_image_enhancement_tpu.validate import (
    validate_folder as jax_validate,
)
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import oracles
from underwater_image_enhancement_tpu_torch.validate import validate_folder

torch.set_num_threads(2)

WEIGHTS = tuple(sorted(jconfig.DEFAULT_QUALITY_WEIGHTS.items()))
GAP = {False: 1e-2, True: 0.5}
CONFIG = ("strong_dehazing", "medium_dehazing", "clahe_enhancement",
          "light_enhancement", "histogram_equalization")
SIX = ("strong_dehazing", "medium_dehazing", "light_dehazing",
       "clahe_enhancement", "white_balance", "histogram_eq")


@pytest.fixture(scope="module")
def uw():
    frames, names = synth_underwater_set(seed=3, n=6, h=64, w=96)
    return np.asarray(frames, np.float32), names


@pytest.fixture(scope="module")
def uw_folder(tmp_path_factory, uw):
    src = tmp_path_factory.mktemp("uw")
    for i, (f, t) in enumerate(zip(*uw)):
        tio.imwrite_unit(str(src / f"{t}_{i}.png"), f)
    return src


@pytest.mark.parametrize("flavor,name", [("config", n) for n in CONFIG]
                         + [("six", n) for n in SIX])
def test_oracles_equal_jax_golden(uw, flavor, name):
    for img in uw[0][:3]:
        if flavor == "config":
            got, want = (oracles.strategy_config(img, name),
                         golden.strategy_config(img, name))
        else:
            got, want = (oracles.strategy_six(img, name),
                         golden.strategy_six(img, name))
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def reports(uw_folder, tmp_path_factory):
    """JAX's and the port's reports of the folder, each tier, and JAX's
    scores of each image (the batches validate runs: 3 and 3)."""
    out = {}
    for fast in (False, True):
        d = tmp_path_factory.mktemp(f"val{int(fast)}")
        want = jax_validate(str(uw_folder), str(d / "jax"), 2, fast, None, 3,
                            log=lambda m: None)
        got = validate_folder(str(uw_folder), str(d / "port"), 2, fast, None,
                              3, log=lambda m: None, device="cpu")
        frames = np.stack([tio.imread_unit(str(p))
                           for p in tio.collect_images(str(uw_folder))])
        scores = np.concatenate([np.asarray(jax_label_batch(
            jnp.asarray(frames[k:k + 3]), WEIGHTS, False, fast=fast)[1])
            for k in (0, 3)])
        out[fast] = (want, got, scores, d)
    return out


@pytest.mark.parametrize("fast", [False, True])
def test_validate_folder_matches_jax(reports, fast):
    want, got, scores, d = reports[fast]
    assert json.loads((d / "port" / "validation_report.json").read_text()) \
        == json.loads(json.dumps(got))
    md = (d / "port" / "validation_report.md").read_text()
    assert "Strategy parity" in md and "UIQM" in md
    assert set(got) == set(want)
    assert got["n_images"] == want["n_images"] == 6
    assert got["label_tier"] == want["label_tier"]
    # winner counts: equal, but for images whose top two lie within GAP
    ties = sum(1 for s in scores if np.diff(np.sort(s)[-2:])[0] < GAP[fast])
    counts = {k: v["count"] for k, v in got["winner_distribution"].items()}
    wcounts = {k: v["count"] for k, v in want["winner_distribution"].items()}
    assert sum(counts.values()) == 6
    for k in set(counts) | set(wcounts):
        assert abs(counts.get(k, 0) - wcounts.get(k, 0)) <= ties, (counts,
                                                                   wcounts)
    for k, v in want["quality"].items():
        assert abs(got["quality"][k] - v) <= 2e-3, k
    gaps = {}
    for flavor in ("config", "six"):
        assert list(got["oracle_psnr"][flavor]) \
            == list(want["oracle_psnr"][flavor])
        for name, w in want["oracle_psnr"][flavor].items():
            for stat in ("psnr_db_min", "psnr_db_mean"):
                g = got["oracle_psnr"][flavor][name][stat]
                gaps[f"{flavor}/{name}/{stat}"] = abs(g - w[stat])
                assert abs(g - w[stat]) <= 1.0, (flavor, name, stat, g, w)
                if not fast:
                    assert g > 45.0 and w[stat] > 45.0
    worst = max(gaps, key=gaps.get)
    print(f"validate fast={fast}: largest PSNR gap to JAX {gaps[worst]} dB "
          f"({worst}); near ties {ties}")


def test_cli_validate_writes_the_report(uw_folder, tmp_path, capsys):
    out = tmp_path / "val"
    tcli.main(["validate", "--input", str(uw_folder), "--output", str(out),
               "--oracle-samples", "1", "--batch-size", "3", "--device",
               "cpu"])
    report = json.loads((out / "validation_report.json").read_text())
    assert report["n_images"] == 6 and report["label_tier"] == "exact"
    assert len(report["oracle_psnr"]["config"]) == 5
    assert len(report["oracle_psnr"]["six"]) == 6
    assert json.loads(capsys.readouterr().out.split("report -> ")[1]
                      .split("\n", 1)[1]) == report


def test_empty_oracle_sample_raises_in_both(uw_folder, tmp_path):
    """oracle_samples=0 raises in min([]), as JAX's does (ROADMAP Queue 3,
    "Empty oracle sample")."""
    with pytest.raises(ValueError, match="empty"):
        jax_validate(str(uw_folder), str(tmp_path / "j"), 0,
                     batch_size=3, log=lambda m: None)
    with pytest.raises(ValueError, match="empty"):
        validate_folder(str(uw_folder), str(tmp_path / "t"), 0,
                        batch_size=3, log=lambda m: None, device="cpu")


def test_validate_with_a_trained_selector(uw_folder, tmp_path):
    """--model: a selector the port trains on the folder; its accuracy in
    the report is accuracy_score on the same labels and features."""
    from sklearn.metrics import accuracy_score

    from underwater_image_enhancement_tpu_torch.select.system import (
        SelfSupervisedSystem,
    )
    from underwater_image_enhancement_tpu_torch.utils.config import Config

    system = SelfSupervisedSystem(Config(image_folder=str(uw_folder),
                                         output_folder=str(tmp_path / "sys"),
                                         batch_size=3), device="cpu")
    system.build_dataset(log=lambda m: None)
    system.train_classifier(log=lambda m: None)
    pkl = tmp_path / "sys" / "trained_models" / "trained_model.pkl"
    report = validate_folder(str(uw_folder), str(tmp_path / "val"), 1,
                             model=str(pkl), batch_size=3,
                             log=lambda m: None, device="cpu")
    X = system.scaler.transform(np.stack([d.features for d in system.dataset]))
    labels = [d.best_strategy for d in system.dataset]
    want = round(float(accuracy_score(labels, system.classifier.predict(X))),
                 3)
    assert report["classifier"] == {"model": str(pkl),
                                    "accuracy_vs_phase1": want}
