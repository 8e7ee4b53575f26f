"""The port's VGG parameter predictor (models/vgg, models/predictor), its
parameter bridge (models/bridge), ``utils/weights``, ``cli enhance
--model``, ``cli convert-vgg`` and the JAX-checkpoint converter
(``tools/jax_ckpt_to_npz.py``) on the CPU, against the JAX package with
its parameters carried across by the bridge.

Tolerances: the VGG trunk within 1e-4 of its largest activation (ten f32
convs, summed in another order by XLA and by PyTorch); the network's
heads within 1e-5 on equal inputs; ``_preprocess`` bit-equal to the
jitted JAX function; ``predict_parameters`` within 1e-4 a parameter (the
79 features enter the fusion MLP unnormalised and differ from JAX's by up
to 1e-4 relative, tests/test_torch_features.py; measured with ``-s``: 0
on every parameter of both fixture frames, at hidden 32 and at 256);
``enhance_image`` with equal parameters within 1e-6.  The random trees scale the fusion layer's rows for the 79
features by 1e-4, so that the heads' sigmoids do not saturate (features
reach 2e5) and the comparison sees every parameter move.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu.models import predictor as jpred
from underwater_image_enhancement_tpu.models import vgg as jvgg
from underwater_image_enhancement_tpu.train.trainer import save_checkpoint
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.models import bridge
from underwater_image_enhancement_tpu_torch.models import predictor as tpred
from underwater_image_enhancement_tpu_torch.models import vgg as tvgg
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.utils import io as tio
from underwater_image_enhancement_tpu_torch.utils import weights as tweights

torch.set_num_threads(2)

HIDDEN = 32
PLAN = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512]


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _unsaturated(variables):
    """A copy of a predictor tree whose fusion rows for the 79 features
    are scaled by 1e-4, and whose BatchNorm statistics are not the
    identity."""
    v = _numpy(variables)
    v["params"]["Dense_0"]["kernel"][1024:] *= 1e-4
    rng = np.random.default_rng(7)
    for bn in v["batch_stats"].values():
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def underwater_img():
    return torch_frames.underwater_img()


@pytest.fixture(scope="module")
def jax_pred():
    """A JAX predictor (hidden 32, input 224) with an unsaturated tree."""
    p = jpred.EnhancementPredictor(hidden_dim=HIDDEN, pretrained_vgg=None)
    p.variables = jax.tree_util.tree_map(jnp.asarray,
                                         _unsaturated(p.variables))
    return p


@pytest.fixture(scope="module")
def port_pred(jax_pred):
    p = tpred.EnhancementPredictor(hidden_dim=HIDDEN, pretrained_vgg=None,
                                   device="cpu")
    bridge.load_flax(p.model, _numpy(jax_pred.variables))
    return p


@pytest.fixture(scope="module")
def jax_params(jax_pred, underwater_img):
    return jax_pred.predict_parameters(jnp.asarray(underwater_img))


# ---- the bridge ----------------------------------------------------------

def test_bridge_round_trip_and_npz(tmp_path):
    net = tvgg.ImprovedVGGParameterNet(hidden_dim=HIDDEN)
    bridge.flax_default_init(net, torch.Generator().manual_seed(3))
    with torch.no_grad():
        net.BatchNorm_0.running_var.uniform_(0.5, 2.0)
    tree = bridge.to_flax(net)
    assert set(tree) == {"params", "batch_stats"}
    assert tree["params"]["vgg"]["conv0"]["kernel"].shape == (3, 3, 3, 64)
    assert tree["params"]["Dense_1"]["kernel"].shape == (2 * HIDDEN, HIDDEN)
    bridge.save_npz(str(tmp_path / "p.npz"), tree)
    with np.load(tmp_path / "p.npz") as z:
        assert "params/vgg/conv0/kernel" in z.files
        assert "batch_stats/BatchNorm_0/mean" in z.files
    other = tvgg.ImprovedVGGParameterNet(hidden_dim=HIDDEN)
    bridge.load_flax(other, bridge.load_npz(str(tmp_path / "p.npz")))
    for (ka, a), (kb, b) in zip(net.state_dict().items(),
                                other.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka


def test_bridge_matches_flax_tree_exactly(jax_pred):
    """Every leaf of a Flax init, carried across and back, bit for bit."""
    tree = _numpy(jax_pred.variables)
    net = bridge.load_flax(tvgg.ImprovedVGGParameterNet(hidden_dim=HIDDEN),
                           tree)
    back = bridge.flatten(bridge.to_flax(net))
    want = bridge.flatten(tree)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_refuses_partial_loads(jax_pred, fault):
    flat = bridge.flatten(_numpy(jax_pred.variables))
    if fault == "missing":
        del flat["batch_stats/BatchNorm_1/var"]
    elif fault == "extra":
        flat["params/Dense_9/kernel"] = np.zeros((2, 2), np.float32)
    else:
        flat["params/head_gamma_1/kernel"] = np.zeros((HIDDEN // 2, 2),
                                                      np.float32)
    net = tvgg.ImprovedVGGParameterNet(hidden_dim=HIDDEN)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with pytest.raises(ValueError, match=fault if fault != "shape"
                       else "wrong shape"):
        bridge.load_flax(net, bridge.unflatten(flat))
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())


# ---- the network ---------------------------------------------------------

@pytest.mark.parametrize("depth", [10, 7])
def test_vgg_features_match_flax(depth):
    model = jvgg.VGGFeatures(depth=depth)
    x = np.random.default_rng(depth).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    variables = model.init(jax.random.PRNGKey(depth), jnp.zeros_like(x))
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    net = bridge.load_flax(tvgg.VGGFeatures(depth=depth), _numpy(variables))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8 if depth == 10 else 16,
                                       8 if depth == 10 else 16,
                                       512 if depth == 10 else 256)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (err, np.abs(want).max())


def test_parameter_net_heads_match_flax(jax_pred, port_pred):
    rng = np.random.default_rng(11)
    img = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    feats = rng.normal(0, 1, (2, 79)).astype(np.float32) * np.float32(50)
    want = jax_pred.model.apply(jax_pred.variables, jnp.asarray(img),
                                jnp.asarray(feats), train=False)
    with torch.no_grad():
        got = port_pred.model(torch.from_numpy(img), torch.from_numpy(feats))
    assert set(got) == set(want) == set(tvgg.PARAM_RANGES)
    for k, (lo, hi) in tvgg.PARAM_RANGES.items():
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (2, 1) and g.dtype == np.float32
        assert ((g > lo) & (g < hi)).all(), (k, g)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)


def test_model_constants_equal_jax():
    assert tvgg.VGG_PLAN == jvgg.VGG_PLAN
    assert tvgg.TORCH_CONV_IDX == jvgg.TORCH_CONV_IDX
    assert tvgg.PARAM_RANGES == jvgg.PARAM_RANGES
    np.testing.assert_array_equal(tvgg.IMAGENET_MEAN, jvgg.IMAGENET_MEAN)
    np.testing.assert_array_equal(tvgg.IMAGENET_STD, jvgg.IMAGENET_STD)
    assert tpred.CLAMPS == jpred.CLAMPS


# ---- the predictor -------------------------------------------------------

def _frames():
    rng = np.random.default_rng(5)
    return {"underwater": torch_frames.underwater_img(),
            "img_unit": torch_frames.img_unit(),
            # off the u8 grid: img * 255 truncates, it does not round
            "off_grid": rng.random((97, 131, 3)).astype(np.float32),
            # exact multiples of 1/255, the truncation's edge
            "grid": (np.arange(224 * 224 * 3).reshape(224, 224, 3) % 256
                     ).astype(np.float32) / np.float32(255)}


@pytest.mark.parametrize("which", list(_frames()))
def test_preprocess_bit_equal_to_jitted_jax(jax_pred, port_pred, which):
    img = _frames()[which]
    want = np.asarray(jax_pred._prep(jnp.asarray(img)))
    got = port_pred._preprocess(torch.from_numpy(img)).numpy()
    assert got.shape == (224, 224, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_predict_parameters_match_jax(port_pred, jax_params, underwater_img):
    kernels.reset_launches()
    got = port_pred.predict_parameters(underwater_img)
    assert sum(kernels.launches.values()) == 0  # CPU: plain versions only
    assert set(got) == set(jax_params) == set(tpred.CLAMPS)
    for k, (lo, hi) in tpred.CLAMPS.items():
        assert lo <= got[k] <= hi, k
        assert abs(got[k] - jax_params[k]) <= 1e-4, (k, got[k], jax_params[k])
    # the network's four parameters lie inside their clamps, not on them
    assert all(tpred.CLAMPS[k][0] < got[k] < tpred.CLAMPS[k][1]
               for k in tvgg.PARAM_RANGES)


def test_enhance_image_matches_jax(jax_pred, port_pred, jax_params,
                                   underwater_img):
    want = jax_pred.enhance_image(jnp.asarray(underwater_img), jax_params)
    got = port_pred.enhance_image(underwater_img, jax_params)
    assert got.shape == underwater_img.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_predictor_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpred.EnhancementPredictor(hidden_dim=HIDDEN, pretrained_vgg=None)


def test_load_refuses_an_orbax_directory(tmp_path, port_pred):
    with pytest.raises(ValueError, match="jax_ckpt_to_npz"):
        port_pred.load(str(tmp_path))


def test_process_single_image_and_folder(tmp_path, port_pred, jax_params,
                                         underwater_img):
    src = tmp_path / "in"
    tio.imwrite_unit(str(src / "a.png"), underwater_img)
    tio.imwrite_unit(str(src / "b.png"), underwater_img[::-1].copy())
    (src / "junk.png").write_bytes(b"not an image")
    params = port_pred.process_single_image(str(src / "a.png"),
                                            str(tmp_path / "one"),
                                            log=lambda *_: None)
    assert abs(params["L_high"] - jax_params["L_high"]) <= 1e-4
    assert (tmp_path / "one" / "a_enhanced.png").exists()
    failed = []
    n = port_pred.process_folder(str(src), str(tmp_path / "out"),
                                 log=failed.append)
    assert n == 2 and len(failed) == 1 and "junk.png" in failed[0]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "a_enhanced.png", "b_enhanced.png"]


def test_process_single_image_writes_jpeg(tmp_path, port_pred,
                                         underwater_img):
    """``output_path=NAME.jpg`` writes cv2's JPEG of the frame that the
    PNG output holds."""
    tio.imwrite_unit(str(tmp_path / "a.png"), underwater_img)
    for name in ("o.png", "o.jpg"):
        port_pred.process_single_image(str(tmp_path / "a.png"),
                                       str(tmp_path / name),
                                       log=lambda *_: None)
    u8 = tio.imread_u8(str(tmp_path / "o.png"))
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(u8[..., ::-1]))
    assert ok and (tmp_path / "o.jpg").read_bytes() == buf.tobytes()


# ---- weights, the torchvision loaders, convert-vgg -----------------------

def _torch_state(prefix=""):
    gen = np.random.default_rng(0)
    state, in_ch = {}, 3
    for ti, out_ch in zip(tvgg.TORCH_CONV_IDX, PLAN):
        state[f"{prefix}{ti}.weight"] = gen.normal(
            0, 0.05, (out_ch, in_ch, 3, 3)).astype(np.float32)
        state[f"{prefix}{ti}.bias"] = gen.normal(
            0, 0.05, (out_ch,)).astype(np.float32)
        in_ch = out_ch
    return state


def test_torch_vgg_weight_import():
    """tests/test_train.py:381 against the port: the torchvision state
    lands in the trunk as it is (OIHW), and equals JAX's HWIO tree."""
    state = _torch_state()
    net = tvgg.load_torch_vgg_features(tvgg.VGGFeatures(depth=10), state,
                                       prefix="")
    np.testing.assert_array_equal(net.conv0.weight.detach().numpy(),
                                  state["0.weight"])
    model = jvgg.VGGFeatures(depth=10)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    new = jvgg.load_torch_vgg_features(dict(params["params"]), state,
                                       prefix="")
    got = bridge.flatten(bridge.to_flax(net)["params"])
    for k, v in bridge.flatten(_numpy(new)).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with torch.no_grad():
        out = net(torch.zeros(1, 64, 64, 3))
    assert torch.isfinite(out).all()
    bad = dict(state, **{"2.weight": state["2.weight"][:, :3]})
    with pytest.raises(ValueError, match="2.weight"):
        tvgg.load_torch_vgg_features(tvgg.VGGFeatures(depth=10), bad,
                                     prefix="")


def test_cli_convert_vgg_and_loaders(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py's convert-vgg test against the port: a full vgg16
    state_dict -> .npz -> the perceptual trunk and the predictor's
    backbone, each equal to JAX's loaders; ``pretrained_vgg="auto"``
    finds the artifact through UIE_TPU_WEIGHTS."""
    state = {k: torch.from_numpy(v)
             for k, v in _torch_state("features.").items()}
    ckpt, npz = tmp_path / "vgg16.pth", tmp_path / "vgg16.npz"
    torch.save(state, str(ckpt))
    tcli.main(["convert-vgg", "--torch-ckpt", str(ckpt), "--out", str(npz)])
    assert "exported 10 conv layers" in capsys.readouterr().out
    vars7 = jvgg.load_perceptual_npz(str(npz))
    net7 = tvgg.load_perceptual_npz(str(npz))
    assert isinstance(net7, tvgg.VGGFeatures) and net7.depth == 7
    got = bridge.flatten(bridge.to_flax(net7))
    for k, v in bridge.flatten(_numpy(vars7)).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    monkeypatch.setenv("UIE_TPU_WEIGHTS", str(tmp_path))
    assert tweights.find_vgg16_npz() == str(npz)
    pred = tpred.EnhancementPredictor(hidden_dim=HIDDEN, device="cpu")
    np.testing.assert_array_equal(
        pred.model.vgg.conv9.weight.detach().numpy(),
        state["features.21.weight"].numpy())
    net = tvgg.load_backbone_npz(
        tvgg.ImprovedVGGParameterNet(hidden_dim=HIDDEN), str(npz))
    assert torch.equal(net.vgg.conv0.bias, state["features.0.bias"])


def test_weights_discovery_equals_jax(tmp_path, monkeypatch):
    from underwater_image_enhancement_tpu.utils import weights as jweights

    monkeypatch.setenv("UIE_TPU_WEIGHTS", str(tmp_path))
    (tmp_path / "resnet18.npz").write_bytes(b"")
    for mod in (jweights, tweights):
        assert mod.weights_dir() == tmp_path
        assert mod.find_resnet18_npz() == str(tmp_path / "resnet18.npz")
        assert mod.find_weights("nothing") is None
    for args in (("resnet",), ("efficientnet", "b3"), ("vit",)):
        assert tweights.zoo_artifact_name(*args) == \
            jweights.zoo_artifact_name(*args)
    with pytest.raises(ValueError):
        tweights.zoo_artifact_name("vgg")


# ---- the converter and cli enhance --model --------------------------------

def _convert(ckpt, out, hidden):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "jax_ckpt_to_npz.py"
    spec = importlib.util.spec_from_file_location("jax_ckpt_to_npz", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.convert(str(ckpt), str(out), hidden_dim=hidden)


def test_converter_raw_checkpoint(tmp_path, jax_pred, jax_params,
                                  underwater_img):
    """A JAX predictor's {params, batch_stats} saved with save_checkpoint,
    converted, loaded by the port: equal predict_parameters."""
    save_checkpoint(str(tmp_path / "ckpt"),
                    {"params": jax_pred.variables["params"],
                     "batch_stats": jax_pred.variables["batch_stats"]})
    n = _convert(tmp_path / "ckpt", tmp_path / "p.npz", HIDDEN)
    assert n == len(bridge.flatten(_numpy(jax_pred.variables)))
    pred = tpred.EnhancementPredictor(str(tmp_path / "p.npz"),
                                      hidden_dim=HIDDEN, pretrained_vgg=None,
                                      device="cpu")
    got = pred.predict_parameters(underwater_img)
    for k in jax_params:
        assert abs(got[k] - jax_params[k]) <= 1e-4, k


def test_converter_trainer_checkpoint(tmp_path):
    """A VGGTrainer checkpoint (optimizer state and history beside the
    parameters), the predictor's second dialect."""
    import warnings

    from underwater_image_enhancement_tpu.train.trainer import VGGTrainer

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = VGGTrainer(hidden_dim=16, image_size=32, epochs=1,
                       pretrained_vgg=None)
    t.train_losses, t.val_losses = [0.5], [0.6]  # orbax saves no empty array
    t.save(str(tmp_path / "ckpt"))
    _convert(tmp_path / "ckpt", tmp_path / "p.npz", 16)
    tree = bridge.load_npz(str(tmp_path / "p.npz"))
    want = bridge.flatten({"params": _numpy(t.params),
                           "batch_stats": _numpy(t.batch_stats)})
    got = bridge.flatten(tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    """A full-width JAX predictor (hidden 256, input 224) with an
    unsaturated tree, its orbax checkpoint and the port's conversion."""
    base = tmp_path_factory.mktemp("full")
    j = jpred.EnhancementPredictor(pretrained_vgg=None)
    tree = _unsaturated(j.variables)
    j.variables = jax.tree_util.tree_map(jnp.asarray, tree)
    save_checkpoint(str(base / "ckpt"), tree)
    _convert(base / "ckpt", base / "p.npz", 256)
    return j, base / "ckpt", base / "p.npz"


@pytest.mark.parametrize("which", ["underwater", "img_unit"])
def test_predict_parameters_full_width_match_jax(full_width, which):
    j, _, npz = full_width
    img = _frames()[which]
    want = j.predict_parameters(jnp.asarray(img))
    got = tpred.EnhancementPredictor(str(npz), pretrained_vgg=None,
                                     device="cpu").predict_parameters(img)
    diffs = {k: abs(got[k] - want[k]) for k in want}
    print(which, "hidden 256, |port - JAX| per parameter:", diffs)
    assert max(diffs.values()) <= 1e-4, diffs


def test_cli_enhance_model_matches_jax_cli(tmp_path, underwater_img,
                                           full_width, capsys):
    """cli enhance --model at full width (hidden 256, input 224) on a
    folder and on a file, on --device cpu, against the JAX CLI on the
    orbax checkpoint it was converted from."""
    from underwater_image_enhancement_tpu.cli import main as jax_main

    _, ckpt, npz = full_width
    src = tmp_path / "in"
    tio.imwrite_unit(str(src / "a.png"), underwater_img)
    tio.imwrite_unit(str(src / "b.png"), torch_frames.img_unit())
    capsys.readouterr()
    tcli.main(["enhance", "--input", str(src), "--output",
               str(tmp_path / "t"), "--model", str(npz), "--device", "cpu"])
    tcli.main(["enhance", "--input", str(src / "a.png"), "--output",
               str(tmp_path / "t1.png"), "--model", str(npz),
               "--arch", "vgg", "--device", "cpu"])
    text = capsys.readouterr().out
    assert f"enhanced 2 images -> {tmp_path / 't'}" in text
    jax_main(["enhance", "--input", str(src), "--output",
              str(tmp_path / "j"), "--model", str(ckpt)])
    jax_main(["enhance", "--input", str(src / "a.png"), "--output",
              str(tmp_path / "j1.png"), "--model", str(ckpt)])
    jtext = capsys.readouterr().out

    def printed(t):
        line = next(ln for ln in t.splitlines() if "predicted params" in ln)
        return json.loads(line.split(":", 1)[1].strip().replace("'", '"'))

    got, want = printed(text), printed(jtext)
    assert set(got) == set(want)
    assert all(abs(got[k] - want[k]) <= 2e-4 for k in want), (got, want)
    for t, j_ in [(tmp_path / "t" / f"{s}_enhanced.png",
                   tmp_path / "j" / f"{s}_enhanced.png") for s in "ab"] + [
            (tmp_path / "t1.png", tmp_path / "j1.png")]:
        a, b = tio.imread_u8(str(t)), tio.imread_u8(str(j_))
        assert a.shape == b.shape
        # equal parameters within 1e-4 move a truncated u8 by at most 1
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, t.name


@pytest.mark.parametrize("argv,item", [
    pytest.param(["--arch", "resnet", "--devices", "2"], "one device",
                 id="argv0-item 9"),
    pytest.param(["--arch", "vit", "--devices", "2"], "one device",
                 id="argv1-item 9"),
    pytest.param(["--devices", "2"], "one device", id="argv2-item 9")])
def test_cli_enhance_rejects_zoo_and_devices(tmp_path, argv, item):
    """--devices over more than one position is rejected with --model for
    every arch: the predictors run on one device."""
    with pytest.raises(SystemExit, match=item):
        tcli.main(["enhance", "--input", str(tmp_path), "--output",
                   str(tmp_path / "o"), "--model", "m.npz",
                   "--device", "cpu"] + argv)
