"""Every reading path of the port on a 16-bit frame, against the JAX
package.  cv2 reads a 16-bit PNG or TIFF as uint16 and the JAX package's
``imread_unit`` divides it by 255, so the frame reaches the pipelines with
values up to 257 (ROADMAP's parity traps): the kernels' plain versions
clip and truncate them, cast correction and the ``hist``/``index-u8``
stretch work on them, and the oracles cast them as numpy does.

One 48x64 frame (``frame16``: dark enough that a quarter of its samples
lie under 1, the rest up to 73) is written as a 16-bit PNG
(``tests/torch_png.py``) and held through ``cli six`` (exact and
``--fast``), ``enhance`` (a file in index mode, a folder in the ``hist``
mode), ``auto``, ``build-dataset``, ``assess``, ``fusion``,
``predict``, the VGG and ResNet predictors' ``process_single_image``,
``waternet`` and ``validate``, each at the tolerance that the function's
own test asserts (named at each test).  The JAX results are computed once
a module."""

import csv
import io
import json
import pickle
import re
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import seeded_tree
from tests import torch_frames
from tests import torch_png
from tests.test_torch_io import _tiff
from tests.test_torch_label import SCORE_TOL, _check_winners
from underwater_image_enhancement_tpu import cli as jcli
from underwater_image_enhancement_tpu.features.full import (
    extract_all_features as jax_features,
)
from underwater_image_enhancement_tpu.models import predictor as jpred
from underwater_image_enhancement_tpu.select import system as jsys
from underwater_image_enhancement_tpu.train.data import _imread_rgb
from underwater_image_enhancement_tpu.train.trainer import save_checkpoint
from underwater_image_enhancement_tpu.utils import config as jconfig
from underwater_image_enhancement_tpu.utils import io as jio
from underwater_image_enhancement_tpu.validate import (
    validate_folder as jax_validate,
)
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.models import bridge
from underwater_image_enhancement_tpu_torch.models import predictor as tpred
from underwater_image_enhancement_tpu_torch.models import waternet as twn
from underwater_image_enhancement_tpu_torch.models import zoo as tzoo
from underwater_image_enhancement_tpu_torch.pipeline.strategies import DEHAZE
from underwater_image_enhancement_tpu_torch.select import system as tsys
from underwater_image_enhancement_tpu_torch.utils import config as tconfig
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.validate import validate_folder

torch.set_num_threads(2)

SIX = ("strong_dehazing", "medium_dehazing", "light_dehazing",
       "clahe_enhancement", "white_balance", "histogram_eq")


def frame16() -> np.ndarray:
    """(48, 64, 3) uint16: a crop of the fixture frame cubed, over the
    16-bit range, with seeded low bits."""
    u = torch_frames.underwater_img()[36:84, 48:112].astype(np.float64)
    rng = np.random.default_rng(16)
    v = np.round(u ** 3 * 65535) + rng.integers(-128, 128, u.shape)
    return np.clip(v, 0, 65535).astype(np.uint16)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """A folder holding the frame as a 16-bit PNG."""
    d = tmp_path_factory.mktemp("in16")
    (d / "f16.png").write_bytes(torch_png.encode(frame16(), 16))
    return d


def _run(main, argv):
    """``main(argv)``'s standard output."""
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _u8(path):
    return tio.imread_u8(str(path)).astype(np.int64)


def _psnr(a, b):
    mse = np.mean((a / 255.0 - b / 255.0) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


def test_the_frame_reads_above_one(src, tmp_path):
    """The PNG and its 16-bit TIFF twin read as JAX reads them, past 1;
    ``imread_u8`` as JAX's training loader reads them (the high byte for
    the PNG, ``(v + 128) // 257`` for the TIFF)."""
    (tmp_path / "t16.tif").write_bytes(_tiff([frame16()], compression=5,
                                             predictor=2))
    for path in (src / "f16.png", tmp_path / "t16.tif"):
        got = tio.imread_unit(str(path))
        np.testing.assert_array_equal(got, jio.imread_unit(str(path)))
        np.testing.assert_array_equal(got, frame16() / np.float32(255))
        assert 70 < got.max() < 257 and 0.2 < (got <= 1).mean() < 0.3
        np.testing.assert_array_equal(tio.imread_u8(str(path)),
                                      _imread_rgb(str(path)))
    np.testing.assert_array_equal(tio.imread_u8(str(src / "f16.png")),
                                  frame16() >> 8)


@pytest.fixture(scope="module")
def jax_cli(src, tmp_path_factory):
    """The JAX CLI's outputs on the folder, once: six (both tiers),
    enhance (folder and file), auto, build-dataset, assess, fusion."""
    out = tmp_path_factory.mktemp("jax16")
    f = str(src / "f16.png")
    text = {}
    for key, argv in (
            ("six", ["six", "--input", str(src), "--output",
                     str(out / "six")]),
            ("six_fast", ["six", "--input", str(src), "--output",
                          str(out / "six_fast"), "--fast"]),
            ("enhance", ["enhance", "--input", str(src), "--output",
                         str(out / "enhance"), "--devices", "1"]),
            ("enhance_file", ["enhance", "--input", f, "--output",
                              str(out / "enhance_file.png")]),
            ("auto", ["auto", "--input", str(src), "--output",
                      str(out / "auto"), "--devices", "1"]),
            ("build", ["build-dataset", "--input", str(src), "--output",
                       str(out / "build"), "--devices", "1"]),
            ("assess", ["assess", "--input", str(src)]),
            ("fusion", ["fusion", "--input", str(src), "--output",
                        str(out / "fusion")])):
        text[key] = _run(jcli.main, argv)
    return out, text


def _port(argv):
    return _run(tcli.main, argv + ["--device", "cpu"])


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_cli_six_matches_jax(src, jax_cli, tmp_path, fast):
    """tests/test_torch_six.py's gates for the exact tier (dehazing >= 50
    dB, the rest within one level), tests/test_torch_fast.py's for
    ``--fast`` (light dehazing >= 50 dB, the rest >= 25 dB: JAX on the CPU
    converts exactly where the port runs K8 _approx's plain version)."""
    key = "six_fast" if fast else "six"
    _port(["six", "--input", str(src), "--output", str(tmp_path / key)]
          + (["--fast"] if fast else []))
    for name in SIX:
        png = f"f16_{name}.png"
        a, b = _u8(tmp_path / key / png), _u8(jax_cli[0] / key / png)
        assert a.shape == b.shape == (48, 64, 3)
        if fast:
            assert _psnr(a, b) >= (50.0 if name == "light_dehazing"
                                   else 25.0), name
        elif "dehazing" in name:
            assert _psnr(a, b) >= 50.0, name
        else:
            assert np.abs(a - b).max() <= 1, name


def test_cli_enhance_matches_jax(src, jax_cli, tmp_path):
    """A file (the index percentiles) and a folder (the ``hist`` mode's
    ``index-u8`` percentiles, which round off-grid values and clip those
    over 1): tests/test_torch_enhance.py's one level."""
    _port(["enhance", "--input", str(src), "--output",
           str(tmp_path / "enhance")])
    _port(["enhance", "--input", str(src / "f16.png"), "--output",
           str(tmp_path / "enhance_file.png")])
    out = jax_cli[0]
    assert np.abs(_u8(tmp_path / "enhance" / "f16_enhanced.png")
                  - _u8(out / "enhance" / "f16_enhanced.png")).max() <= 1
    assert np.abs(_u8(tmp_path / "enhance_file.png")
                  - _u8(out / "enhance_file.png")).max() <= 1


def test_cli_auto_matches_jax(src, jax_cli, tmp_path):
    """tests/test_torch_label.py's gates: the same winner, its score
    within 0.011, its PNG within one level (50 dB for a dehazing one)."""
    got = _port(["auto", "--input", str(src), "--output",
                 str(tmp_path / "auto")])
    pat = r"^f16\.png: (\w+) \(([-0-9.]+)\)$"
    (name, score), = re.findall(pat, got, re.M)
    (wname, wscore), = re.findall(pat, jax_cli[1]["auto"], re.M)
    assert name == wname and abs(float(score) - float(wscore)) <= 0.011
    a = _u8(tmp_path / "auto" / f"f16_{name}.png")
    b = _u8(jax_cli[0] / "auto" / f"f16_{name}.png")
    if name in DEHAZE:
        assert _psnr(a, b) >= 50.0
    else:
        assert np.abs(a - b).max() <= 1


def test_cli_build_dataset_matches_jax(src, jax_cli, tmp_path):
    """tests/test_torch_label.py's gates on the exact tier: the winner
    (unless JAX's top two lie within the near-tie gap) and every score
    within ``SCORE_TOL``."""
    _port(["build-dataset", "--input", str(src), "--output",
           str(tmp_path / "build")])
    rows = {}
    for side, root in (("port", tmp_path), ("jax", jax_cli[0])):
        with open(root / "build" / "reports" / "dataset_building.csv",
                  newline="") as f:
            reader = csv.reader(f)
            head = next(reader)
            rows[side] = list(reader)
    names = head[3:]
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]] == [
        "f16.png"]
    scores = {s: np.array([[float(v) for v in r[3:]] for r in rows[s]])
              for s in rows}
    best = {s: np.array([names.index(r[1]) for r in rows[s]]) for s in rows}
    _check_winners(best["port"], scores["port"], best["jax"], scores["jax"],
                   False)
    assert np.abs(scores["port"] - scores["jax"]).max() <= SCORE_TOL[False]


def test_cli_assess_matches_jax(src, jax_cli, tmp_path):
    """tests/test_torch_uiqm.py's gate: every number within one unit of
    its last printed digit."""
    got = _port(["assess", "--input", str(src)]).splitlines()
    want = jax_cli[1]["assess"].splitlines()
    assert got[0] == want[0]
    row = [float(v) for v in got[1].split()[1:]]
    wrow = [float(v) for v in want[1].split()[1:]]
    tol = np.array([0.01, 0.001, 0.001] + [0.01] * 8) + 1e-9
    assert np.all(np.abs(np.array(row) - wrow) <= tol), (row, wrow)


def test_cli_fusion_matches_jax(src, jax_cli, tmp_path):
    """tests/test_torch_fusion.py's gate: within one level of JAX's."""
    _port(["fusion", "--input", str(src), "--output",
           str(tmp_path / "fusion")])
    assert np.abs(_u8(tmp_path / "fusion" / "f16_fusion.png")
                  - _u8(jax_cli[0] / "fusion" / "f16_fusion.png")
                  ).max() <= 1


def test_predict_matches_jax(src, tmp_path):
    """tests/test_torch_selector.py's gates: a classifier saved as JAX's
    ``train_classifier`` saves it (a random forest and its scaler, fitted
    on 40 items around the frame's features), loaded by both systems; the
    same label and each probability within 1e-3."""
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.preprocessing import StandardScaler

    base = np.asarray(jax_features(jnp.asarray(
        jio.imread_unit(str(src / "f16.png")))))
    rng = np.random.default_rng(3)
    X = (base * (1 + 0.05 * rng.normal(0, 1, (40, 79)))).astype(np.float32)
    y = np.array(["StrongDehazing", "MediumDehazing", "CLAHEEnhancement",
                  "LightEnhancement"])[
        (X[:, 0] > base[0]).astype(int) + 2 * (X[:, 12] > base[12])]
    scaler = StandardScaler().fit(X)
    clf = RandomForestClassifier(n_estimators=20, random_state=0).fit(
        scaler.transform(X), y)
    with open(tmp_path / "model.pkl", "wb") as f:
        pickle.dump({"classifier": clf, "scaler": scaler, "results": {},
                     "classes": sorted(set(y)), "best_name": "rf"}, f)
    j = jsys.SelfSupervisedSystem(jconfig.Config(
        output_folder=str(tmp_path / "jax")))
    t = tsys.SelfSupervisedSystem(tconfig.Config(
        output_folder=str(tmp_path / "port")), device="cpu")
    for system in (j, t):
        system.load_model(str(tmp_path / "model.pkl"))
    jl, jp = j.predict(str(src / "f16.png"))
    tl, tp = t.predict(str(src / "f16.png"))
    assert tl == jl and tp.keys() == jp.keys()
    assert all(abs(tp[k] - jp[k]) <= 1e-3 for k in jp), (tp, jp)


def _vgg_pair():
    """A JAX VGG predictor (hidden 32) with tests/test_torch_predictor.py's
    unsaturated tree, and the port's holding it."""
    from tests.test_torch_predictor import HIDDEN, _numpy, _unsaturated

    j = jpred.EnhancementPredictor(hidden_dim=HIDDEN, pretrained_vgg=None)
    j.variables = jax.tree_util.tree_map(jnp.asarray,
                                         _unsaturated(j.variables))
    t = tpred.EnhancementPredictor(hidden_dim=HIDDEN, pretrained_vgg=None,
                                   device="cpu")
    bridge.load_flax(t.model, _numpy(j.variables))
    return j, t


def _resnet_pair():
    """tests/test_torch_zoo.py's ResNet ZooPredictor pair at input 32."""
    from tests.test_torch_zoo import ZOO_SIZE, _calibrated_tree

    tree = _calibrated_tree(tzoo.CNNParameterPredictor(), ZOO_SIZE, seed=21)
    j = jpred.ZooPredictor(model_type="resnet", input_size=ZOO_SIZE)
    j.variables = jax.tree_util.tree_map(jnp.asarray, tree)
    t = tpred.ZooPredictor(model_type="resnet", input_size=ZOO_SIZE,
                           device="cpu")
    bridge.load_flax(t.model, tree)
    return j, t


@pytest.mark.parametrize("make", [_vgg_pair, _resnet_pair],
                         ids=["vgg", "resnet"])
def test_process_single_image_matches_jax(src, tmp_path, make):
    """tests/test_torch_predictor.py's and tests/test_torch_zoo.py's
    gates: each parameter within 1e-4; the written frame within one level
    (``enhance_image`` within 1e-6 truncates to u8)."""
    j, t = make()
    jp = j.process_single_image(str(src / "f16.png"), str(tmp_path / "j"),
                                log=lambda *_: None)
    tp = t.process_single_image(str(src / "f16.png"), str(tmp_path / "t"),
                                log=lambda *_: None)
    assert tp.keys() == jp.keys()
    assert max(abs(tp[k] - jp[k]) for k in jp) <= 1e-4, (tp, jp)
    assert np.abs(_u8(tmp_path / "t" / "f16_enhanced.png")
                  - _u8(tmp_path / "j" / "f16_enhanced.png")).max() <= 1


def test_cli_waternet_matches_jax(src, tmp_path):
    """tests/test_torch_waternet.py's gate: a seeded full-width WaterNet
    saved with orbax and converted; the two CLIs' PNGs within one
    level."""
    import importlib.util

    tree = seeded_tree(bridge, twn.WaterNet(), 3)
    save_checkpoint(str(tmp_path / "ckpt"), tree)
    path = Path(__file__).resolve().parents[1] / "tools" / "jax_ckpt_to_npz.py"
    spec = importlib.util.spec_from_file_location("jax_ckpt_to_npz", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.convert(str(tmp_path / "ckpt"), str(tmp_path / "w.npz"),
                arch="waternet")
    _port(["waternet", "--input", str(src), "--output", str(tmp_path / "t"),
           "--checkpoint", str(tmp_path / "w.npz")])
    _run(jcli.main, ["waternet", "--input", str(src), "--output",
                     str(tmp_path / "j"), "--checkpoint",
                     str(tmp_path / "ckpt")])
    assert np.abs(_u8(tmp_path / "t" / "f16_waternet.png")
                  - _u8(tmp_path / "j" / "f16_waternet.png")).max() <= 1


def test_validate_matches_jax(src, tmp_path):
    """tests/test_torch_validate.py's gates on the exact tier: the same
    report structure, winner counts (the frame's top two are apart),
    quality means within 2e-3, each PSNR min and mean within 1 dB of
    JAX's.  The oracles cast ``img * 255`` to uint8 as numpy does, out of
    range here in both packages."""
    want = jax_validate(str(src), str(tmp_path / "jax"), 1, False, None, 1,
                        log=lambda m: None)
    got = validate_folder(str(src), str(tmp_path / "port"), 1, False, None,
                          1, log=lambda m: None, device="cpu")
    assert json.loads((tmp_path / "port" / "validation_report.json")
                      .read_text()) == json.loads(json.dumps(got))
    assert set(got) == set(want) and got["n_images"] == want["n_images"] == 1
    assert {k: v["count"] for k, v in got["winner_distribution"].items()} \
        == {k: v["count"] for k, v in want["winner_distribution"].items()}
    for k, v in want["quality"].items():
        assert abs(got["quality"][k] - v) <= 2e-3, k
    for flavor in ("config", "six"):
        assert list(got["oracle_psnr"][flavor]) \
            == list(want["oracle_psnr"][flavor])
        for name, w in want["oracle_psnr"][flavor].items():
            for stat in ("psnr_db_min", "psnr_db_mean"):
                g = got["oracle_psnr"][flavor][name][stat]
                assert abs(g - w[stat]) <= 1.0, (flavor, name, stat, g, w)
