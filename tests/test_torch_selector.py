"""Phase 2 of the port's selector (select/mlp_classifier, select/system's
train_classifier, load_model, predict and reports, utils/config's Phase-2
fields) and ``cli train-selector``, ``run`` and ``predict`` on the CPU,
against the JAX package.

Tolerances: one Adam step from equal parameters within 1e-6 of optax's
(the two order the same arithmetic differently); a 100-epoch fit from
equal parameters within 1e-4 in ``predict_proba`` (the step's rounding
compounds); equal trained parameters within 1e-6; ``predict`` on frames
within 1e-3 in the probabilities (the port's features differ from JAX's
by up to 1e-4 relative, tests/test_torch_features.py).  sklearn sees
equal arrays in both packages, so ``train_classifier``'s results and the
report's text are equal exactly.
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu.features.full import (
    extract_all_features as jax_features,
)
from underwater_image_enhancement_tpu.select import mlp_classifier as jmlp
from underwater_image_enhancement_tpu.select import system as jsys
from underwater_image_enhancement_tpu.utils import config as jconfig
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.models import bridge
from underwater_image_enhancement_tpu_torch.select import mlp_classifier as tmlp
from underwater_image_enhancement_tpu_torch.select import system as tsys
from underwater_image_enhancement_tpu_torch.utils import config as tconfig
from underwater_image_enhancement_tpu_torch.utils import io as tio

torch.set_num_threads(2)

NAMES = ("StrongDehazing", "MediumDehazing", "CLAHEEnhancement",
         "LightEnhancement", "HistogramEqualization")


def _gate_data():
    """tests/test_train.py's classifier data, from a generator of its
    own."""
    X = np.random.default_rng(5).normal(0, 1, (80, 79)).astype(np.float32)
    return X, np.where(X[:, 0] > 0, "a", "b")


def _flax_init(X, n_classes, hidden=32, seed=0):
    clf = jmlp.FlaxMLPClassifier(hidden_dim=hidden, seed=seed)
    tree = clf._model(n_classes).init(jax.random.PRNGKey(seed),
                                      jnp.asarray(X[:1]))
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_mlp(X, n_classes, epochs, hidden=32):
    clf = tmlp.FlaxMLPClassifier(hidden_dim=hidden, epochs=epochs,
                                 device="cpu")
    clf._init_params = _flax_init(X, n_classes, hidden)
    return clf


def test_config_phase2_fields_equal_jax():
    assert tconfig.DEFAULT_CLASSIFIERS == jconfig.DEFAULT_CLASSIFIERS
    t, j = tconfig.Config(), jconfig.Config()
    for f in ("test_size", "random_seed", "cv_folds", "classifiers"):
        assert getattr(t, f) == getattr(j, f), f
    t.classifiers["svm"]["C"] = 2.0  # a copy per config
    assert tconfig.DEFAULT_CLASSIFIERS["svm"]["C"] == 1.0


def test_one_adam_step_equals_optax():
    X, y = _gate_data()
    clf = jmlp.FlaxMLPClassifier(hidden_dim=32, epochs=1).fit(X, y)
    port = _port_mlp(X, 2, 1).fit(X, y)
    got, want = bridge.flatten(port._params), bridge.flatten(clf._params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_adam_update_rule_equals_optax():
    """torch.optim.Adam against optax.adam over ten steps on one tensor."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(0, 1, (7, 5)).astype(np.float32)
    grads = rng.normal(0, 1, (10, 7, 5)).astype(np.float32)
    tx = optax.adam(1e-3)
    p, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    t = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([t], lr=1e-3)
    for g in grads:
        up, st = tx.update(jnp.asarray(g), st)
        p = optax.apply_updates(p, up)
        t.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(p), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def fitted():
    X, y = _gate_data()
    jclf = jmlp.FlaxMLPClassifier(hidden_dim=32, epochs=100).fit(X, y)
    return X, y, jclf, _port_mlp(X, 2, 100).fit(X, y)


def test_mlp_gate_behaviour(fitted):
    """tests/test_train.py::test_flax_mlp_classifier against the port."""
    X, y, _, clf = fitted
    assert (clf.predict(X) == y).mean() > 0.9
    proba = clf.predict_proba(X[:5])
    assert proba.shape == (5, 2) and proba.dtype == np.float32
    np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-5)
    clf2 = pickle.loads(pickle.dumps(clf))
    assert (clf2.predict(X) == clf.predict(X)).all()
    leaves = bridge.flatten(clf2._params)
    assert all(type(v) is np.ndarray for v in leaves.values())


def test_mlp_seeded_fit_reaches_the_gate():
    """From the port's own seeded draw, no Flax init."""
    X, y = _gate_data()
    clf = tmlp.FlaxMLPClassifier(hidden_dim=32, epochs=100, device="cpu")
    assert (clf.fit(X, y).predict(X) == y).mean() > 0.9
    again = tmlp.FlaxMLPClassifier(hidden_dim=32, epochs=100, device="cpu")
    np.testing.assert_array_equal(again.fit(X, y).predict_proba(X),
                                  clf.predict_proba(X))


def test_mlp_fit_from_equal_init_matches_jax(fitted):
    X, _, jclf, clf = fitted
    np.testing.assert_array_equal(clf.classes_, jclf.classes_)
    np.testing.assert_allclose(clf.predict_proba(X), jclf.predict_proba(X),
                               rtol=0, atol=1e-4)


def test_mlp_carried_trained_params_match_jax(fitted):
    X, _, jclf, _ = fitted
    clf = tmlp.FlaxMLPClassifier(hidden_dim=32, device="cpu")
    clf.classes_, clf._params = jclf.classes_, jclf._params
    np.testing.assert_allclose(clf.predict_proba(X), jclf.predict_proba(X),
                               rtol=0, atol=1e-6)


def test_mlp_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    X, y = _gate_data()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmlp.FlaxMLPClassifier(hidden_dim=8, epochs=1).fit(X, y)


# ---- train_classifier, reports, predict, load_model -----------------------

@pytest.fixture(scope="module")
def frames():
    return [torch_frames.underwater_img(), torch_frames.img_unit()]


@pytest.fixture(scope="module")
def items(frames):
    """40 DatasetItems around the two frames' JAX features, labelled by
    a rule on two of them and the index (four classes, 7 to 13 items
    each)."""
    base = [np.asarray(jax_features(jnp.asarray(f))) for f in frames]
    rng = np.random.default_rng(3)
    out = []
    for i in range(40):
        f = (base[i % 2] * (1 + 0.05 * rng.normal(0, 1, 79))).astype(
            np.float32)
        k = (int(f[0] > base[i % 2][0]) + 2 * int(f[12] > base[i % 2][12])
             + (i % 7 == 0)) % 5
        out.append(dict(filename=f"f{i}.png", features=f,
                        best_strategy=NAMES[k], best_score=float(k),
                        all_scores={n: 0.0 for n in NAMES}))
    return out


@pytest.fixture(scope="module")
def trained(items, tmp_path_factory):
    base = tmp_path_factory.mktemp("phase2")
    systems = {}
    for key, mod, cfgmod, kw in (("jax", jsys, jconfig, {}),
                                 ("port", tsys, tconfig, {"device": "cpu"})):
        cfg = cfgmod.Config(output_folder=str(base / key))
        s = mod.SelfSupervisedSystem(cfg, **kw)
        s.dataset = [mod.DatasetItem(**d) for d in items]
        s.train_classifier(log=lambda *_: None)
        systems[key] = s
    return systems


def test_train_classifier_matches_jax(trained):
    j, t = trained["jax"], trained["port"]
    assert t.results.keys() == j.results.keys()
    for name in j.results:
        for k, v in j.results[name].items():
            assert t.results[name][k] == v or (np.isnan(v) and np.isnan(
                t.results[name][k])), (name, k)
    assert type(t.classifier) is type(j.classifier)
    assert t.classes_ == j.classes_


def test_classification_report_text_equal(trained):
    j, t = trained["jax"], trained["port"]
    assert t.classification_report() == j.classification_report()
    assert (Path(t.config.report_folder) / "confusion_matrix.png").exists()
    assert (Path(t.config.report_folder)
            / "classification_report.txt").read_text() == \
        (Path(j.config.report_folder)
         / "classification_report.txt").read_text()


def test_predict_matches_jax(trained, frames, tmp_path):
    for i, f in enumerate(frames):
        path = str(tmp_path / f"f{i}.png")
        tio.imwrite_unit(path, f)
        jl, jp = trained["jax"].predict(path)
        tl, tp = trained["port"].predict(path)
        assert tl == jl and tp.keys() == jp.keys()
        assert all(abs(tp[k] - jp[k]) <= 1e-3 for k in jp), (tp, jp)


def test_load_model_reads_a_jax_sklearn_pickle(trained, frames, tmp_path):
    j = trained["jax"]
    s = tsys.SelfSupervisedSystem(tconfig.Config(), device="cpu")
    s.load_model(str(j.config.model_folder) + "/trained_model.pkl")
    assert type(s.classifier) is type(j.classifier)
    assert s.classes_ == j.classes_ and s.results == j.results
    path = str(tmp_path / "f.png")
    tio.imwrite_unit(path, frames[0])
    assert s.predict(path)[0] == j.predict(path)[0]


def test_load_model_maps_the_jax_mlp(fitted, tmp_path):
    """A JAX pickle of the Flax MLP (numpy parameters) loads as the port's
    classifier, on the system's device, with JAX's probabilities."""
    X, _, jclf, _ = fitted
    from sklearn.preprocessing import StandardScaler

    blob = {"classifier": jclf, "scaler": StandardScaler().fit(X),
            "results": {}, "classes": ["a", "b"], "best_name": "mlp"}
    path = tmp_path / "trained_model.pkl"
    path.write_bytes(pickle.dumps(blob))
    s = tsys.SelfSupervisedSystem(tconfig.Config(), device="cpu")
    s.load_model(str(path))
    assert isinstance(s.classifier, tmlp.FlaxMLPClassifier)
    assert s.classifier.device == "cpu" and s.classifier.hidden_dim == 32
    np.testing.assert_allclose(s.classifier.predict_proba(X),
                               jclf.predict_proba(X), rtol=0, atol=1e-6)


@pytest.mark.parametrize("what", ["dataset_item", "jax_array_params"])
def test_load_model_refuses_what_it_cannot_map(fitted, tmp_path, what):
    X, _, jclf, _ = fitted
    if what == "dataset_item":
        classifier = jsys.DatasetItem("x", X[0], "a", 0.0, {})
        match = "underwater_image_enhancement_tpu.select.system.DatasetItem"
    else:
        classifier = jmlp.FlaxMLPClassifier(hidden_dim=32)
        classifier.classes_ = jclf.classes_
        classifier._params = jax.tree_util.tree_map(jnp.asarray,
                                                    jclf._params)
        match = "jax"
    path = tmp_path / "trained_model.pkl"
    path.write_bytes(pickle.dumps({"classifier": classifier, "scaler": None}))
    s = tsys.SelfSupervisedSystem(tconfig.Config(), device="cpu")
    with pytest.raises(pickle.UnpicklingError, match=match):
        s.load_model(str(path))


def test_train_classifier_with_the_mlp(items, tmp_path):
    cfg = tconfig.Config(output_folder=str(tmp_path))
    s = tsys.SelfSupervisedSystem(cfg, device="cpu")
    s.dataset = [tsys.DatasetItem(**d) for d in items]
    res = s.train_classifier(log=lambda *_: None, include_mlp=True)
    assert set(res) == {"random_forest", "gradient_boosting", "svm", "mlp"}
    assert 0.0 <= res["mlp"]["test_accuracy"] <= 1.0
    assert np.isnan(res["mlp"]["cv_mean"])


# ---- the CLI on --device cpu (tests/test_cli.py:49-92) --------------------

@pytest.fixture()
def img_folder(tmp_path):
    rng = np.random.default_rng(3)
    src = tmp_path / "in"
    for i in range(2):
        img = np.clip(rng.random((40, 48, 3)) * 0.7 + 0.1, 0, 1)
        tio.imwrite_unit(str(src / f"p{i}.png"), img.astype(np.float32))
    rng = np.random.default_rng(9)
    for i in range(4):
        img = np.clip(rng.random((40, 48, 3)) * (0.2 + 0.2 * i), 0, 1)
        tio.imwrite_unit(str(src / f"x{i}.png"), img.astype(np.float32))
    return src


def test_cli_build_dataset_train_selector_predict(img_folder, tmp_path,
                                                  capsys):
    out = tmp_path / "sys"
    tcli.main(["build-dataset", "--input", str(img_folder), "--output",
               str(out), "--device", "cpu"])
    assert (out / "reports" / "dataset_building.csv").exists()
    tcli.main(["train-selector", "--output", str(out)])
    model = out / "trained_models" / "trained_model.pkl"
    assert model.exists()
    text = capsys.readouterr().out
    assert "labeled 6 images" in text and "random_forest" in text
    tcli.main(["predict", "--input", str(img_folder / "p0.png"), "--model",
               str(model), "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.startswith("best strategy: ")
    assert text.split(": ")[1].split()[0] in NAMES


def test_cli_run_full_flow(img_folder, tmp_path, capsys):
    out = tmp_path / "sys"
    tcli.main(["run", "--input", str(img_folder), "--output", str(out),
               "--device", "cpu"])
    assert (out / "reports" / "dataset_building.csv").exists()
    assert (out / "trained_models" / "trained_model.pkl").exists()
    text = capsys.readouterr().out
    assert "labeled 6 images" in text and f"output folder: {out}" in text


def test_cli_run_rejects_devices(img_folder, tmp_path):
    """More cards than are visible end the run, naming both counts."""
    with pytest.raises(SystemExit, match="--devices 64: 64 CUDA devices "
                       "asked, [0-9]+ visible"):
        tcli.main(["run", "--input", str(img_folder), "--output",
                   str(tmp_path), "--device", "cuda", "--devices", "64"])
