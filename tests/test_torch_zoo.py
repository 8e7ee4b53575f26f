"""The port's zoo predictors (models/zoo, models/mlp, models/layers, the
bridge's attention, LayerNorm and bare leaves), ``diff_enhance.enhance_zoo``,
``ZooPredictor``, ``cli enhance --arch`` and the zoo dialect of the
JAX-checkpoint converter, on the CPU, against the JAX package with its
parameters carried across by the bridge.

The trees are seeded numpy values in the port's layout
(``chip_smoke.seeded_tree``, BatchNorm statistics those of 32 seeded
images: ``chip_smoke.calibrate_batch_norm``), held to the shapes of the
JAX modules' ``eval_shape``, and given to both sides; each net's heads
move with the input and sit off their bounds.  Tolerances: each net's six heads
within 1e-5 of their range of JAX's on equal inputs (ResNet18 at 32^2,
EfficientNet b0 and b3 at 64^2, the ViT at dim 64, depth 2, 4 heads at 32^2, at 40^2 and at 33^2,
where Flax's SAME pad of the patch conv is 4 + 4 and 7 + 8); the
ParameterPredictor's four within 1e-5; the torchvision loaders leaf-equal
to JAX's; ``_preprocess`` bit-equal to the jitted JAX function for both
``imagenet_normalize``; ``predict_parameters`` within 1e-4 a parameter;
``enhance_image`` and ``enhance_zoo`` within 1e-6.  Measured with ``-s``:
the largest difference of each comparison is printed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import calibrate_batch_norm, seeded_tree
from tests import torch_frames
from underwater_image_enhancement_tpu.models import diff_enhance as jde
from underwater_image_enhancement_tpu.models import mlp as jmlp
from underwater_image_enhancement_tpu.models import predictor as jpred
from underwater_image_enhancement_tpu.models import zoo as jzoo
from underwater_image_enhancement_tpu.train.trainer import save_checkpoint
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.models import bridge
from underwater_image_enhancement_tpu_torch.models import diff_enhance as tde
from underwater_image_enhancement_tpu_torch.models import layers
from underwater_image_enhancement_tpu_torch.models import mlp as tmlp
from underwater_image_enhancement_tpu_torch.models import predictor as tpred
from underwater_image_enhancement_tpu_torch.models import zoo as tzoo
from underwater_image_enhancement_tpu_torch.utils import io as tio

torch.set_num_threads(2)

VIT = {"dim": 64, "depth": 2, "heads": 4}
# name -> (JAX module, port module factory, input side)
NETS = {
    "resnet": (jzoo.CNNParameterPredictor(), tzoo.CNNParameterPredictor, 32),
    # at 64^2 the last stages see 2x2 maps (at 32^2 1x1, where the heads
    # of a random b3 saturate)
    "efficientnet_b0": (jzoo.EfficientNetParameterPredictor("b0"),
                        lambda: tzoo.EfficientNetParameterPredictor("b0"),
                        64),
    "efficientnet_b3": (jzoo.EfficientNetParameterPredictor("b3"),
                        lambda: tzoo.EfficientNetParameterPredictor("b3"),
                        64),
    **{f"vit_{s}": (jzoo.ViTParameterPredictor(**VIT),
                    lambda s=s: tzoo.ViTParameterPredictor(**VIT,
                                                           image_size=s), s)
       for s in (32, 40, 33)},
}


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _calibrated_tree(net, size, seed):
    """seeded_tree of ``net`` with its BatchNorm statistics calibrated on
    32 seeded normal images; ``net`` holds it after."""
    bridge.load_flax(net, seeded_tree(bridge, net, seed))
    x = np.random.default_rng(100 + seed).normal(0, 1, (32, size, size, 3))
    calibrate_batch_norm(torch, net, torch.from_numpy(x.astype(np.float32)))
    return bridge.to_flax(net)


def _jax_shapes(model, size):
    v = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, size, size, 3)))
    return {k: tuple(a.shape) for k, a in bridge.flatten(v).items()}


@pytest.fixture(scope="module")
def nets():
    """name -> (JAX module, seeded tree, port module holding it, side),
    built once a name."""
    cache = {}

    def get(name):
        if name not in cache:
            jm, make, size = NETS[name]
            tm = make()
            tree = _calibrated_tree(tm, size, seed=list(NETS).index(name))
            assert {k: v.shape for k, v in bridge.flatten(tree).items()} \
                == _jax_shapes(jm, size), name
            cache[name] = (jm, tree, tm, size)
        return cache[name]

    return get


# ---- the bridge and the layers -------------------------------------------

def test_flax_default_init_round_trips_bias_free_convs():
    """A CNNParameterPredictor (each of its convs bias-free) initialised
    from a generator, carried to a Flax tree and back."""
    net = tzoo.CNNParameterPredictor()
    bridge.flax_default_init(net, torch.Generator().manual_seed(0))
    assert net.Conv_0.bias is None
    std = float(net.ResNetBlock_2.Conv_0.weight.detach().std())
    assert abs(std - 1 / math.sqrt(64 * 9)) < 0.1 / math.sqrt(64 * 9)
    other = bridge.load_flax(tzoo.CNNParameterPredictor(), bridge.to_flax(net))
    for (ka, a), (kb, b) in zip(net.state_dict().items(),
                                other.state_dict().items()):
        assert ka == kb
        if "num_batches" not in ka:
            assert torch.equal(a, b), ka


def test_flax_default_init_of_the_vit():
    net = tzoo.ViTParameterPredictor(**VIT, image_size=32)
    bridge.flax_default_init(net, torch.Generator().manual_seed(0))
    assert torch.equal(net.cls, torch.zeros(1, 1, 64))
    assert net.pos.shape == (1, 5, 64)
    assert 0.015 < float(net.pos.detach().std()) < 0.025
    assert torch.equal(net.LayerNorm_3.weight, torch.ones(64))
    q = net.MultiHeadDotProductAttention_1.query
    assert abs(float(q.weight.detach().std()) * 8 - 1) < 0.1
    assert not q.bias.any()


def test_bridge_vit_tree_exactly(nets):
    """Attention projections, LayerNorms and the bare cls/pos leaves of a
    Flax-layout tree, carried across and back bit for bit."""
    _, tree, net, _ = nets("vit_32")
    assert isinstance(net.MultiHeadDotProductAttention_0.out,
                      layers.HeadsLinear)
    back, want = bridge.flatten(bridge.to_flax(net)), bridge.flatten(tree)
    assert set(back) == set(want)
    assert want["params/MultiHeadDotProductAttention_0/query/kernel"].shape \
        == (64, 4, 16)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_heads_linear_is_flax_dense_general():
    """A query projection and the out projection as Flax computes them:
    einsum over the (heads, hd) kernels."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    q = layers.HeadsLinear(64, 4, "out")
    o = layers.HeadsLinear(64, 4, "in")
    kq = rng.normal(0, 0.1, (64, 4, 16)).astype(np.float32)
    bq = rng.normal(0, 0.1, (4, 16)).astype(np.float32)
    ko = rng.normal(0, 0.1, (4, 16, 64)).astype(np.float32)
    bo = rng.normal(0, 0.1, (64,)).astype(np.float32)
    bridge.load_flax(q, {"params": {"kernel": kq, "bias": bq}})
    bridge.load_flax(o, {"params": {"kernel": ko, "bias": bo}})
    with torch.no_grad():
        got_q = q(torch.from_numpy(x)).numpy().reshape(2, 5, 4, 16)
        got_o = o(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_q, np.einsum("bld,dhk->blhk", x, kq) + bq,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got_o, np.einsum("blhk,hkd->bld", x.reshape(2, 5, 4, 16), ko) + bo,
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,k,s", [(32, 3, 2), (31, 3, 2), (40, 16, 16),
                                   (33, 16, 16), (20, 7, 1)])
def test_same_pads_are_xla_s(n, k, s):
    """layers.same_pads against XLA's own SAME pads (the odd pad high)."""
    want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert layers.same_pads(n, k, s) == tuple(want)
    out = -(-n // s)
    x = torch.zeros(1, 1, n, n)
    y = layers.conv2d_same(x, torch.zeros(1, 1, k, k), None, s)
    assert y.shape[-2:] == (out, out)


# ---- the networks --------------------------------------------------------

@pytest.mark.parametrize("name", list(NETS))
def test_zoo_net_heads_match_flax(nets, name):
    jm, tree, net, size = nets(name)
    x = np.random.default_rng(11).normal(0, 1, (2, size, size, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, im: jm.apply(v, im, train=False))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert set(got) == set(want) == set(tzoo.SIX_PARAM_RANGES)
    diffs, moves = {}, {}
    for k, (lo, hi) in tzoo.SIX_PARAM_RANGES.items():
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (2, 1) and g.dtype == np.float32
        margin = 1e-3 * (hi - lo)
        assert ((g > lo + margin) & (g < hi - margin)).all(), (k, g)
        diffs[k] = float(np.abs(g - w).max())
        moves[k] = float(abs(g[0, 0] - g[1, 0])) / (hi - lo)
        # the sigmoid within 1e-5: the head within 1e-5 of its range
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * (hi - lo),
                                   err_msg=k)
    assert max(moves.values()) > 1e-3, moves  # the heads see the image
    print(name, "heads |port - JAX|:", diffs)


@pytest.mark.parametrize("normalize", [True, False])
def test_parameter_predictor_matches_flax(normalize):
    jm = jmlp.ParameterPredictor(normalize_inputs=normalize)
    tm = tmlp.ParameterPredictor(normalize_inputs=normalize)
    tree = seeded_tree(bridge, tm, seed=5)
    want_shapes = {k: tuple(a.shape) for k, a in bridge.flatten(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 79)))).items()}
    assert {k: v.shape for k, v in bridge.flatten(tree).items()} \
        == want_shapes
    bridge.load_flax(tm, tree).eval()
    feats = np.random.default_rng(2).normal(0, 1, (4, 79)).astype(np.float32)
    feats *= np.float32(30.0 if normalize else 0.2)
    want = jm.apply(tree, jnp.asarray(feats), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats))
    assert set(got) == set(want) == set(tmlp.PARAM_RANGES)
    for k in tmlp.PARAM_RANGES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert tmlp.PARAM_RANGES == jmlp.PARAM_RANGES
    assert isinstance(tzoo.create_model("mlp"), tmlp.ParameterPredictor)


def test_model_constants_equal_jax():
    assert tzoo.SIX_PARAM_RANGES == jzoo.SIX_PARAM_RANGES
    assert tzoo._EFFNET_STAGES == jzoo._EFFNET_STAGES
    assert tzoo._EFFNET_MULTS == jzoo._EFFNET_MULTS
    for v in ("b0", "b3"):
        assert tzoo._effnet_blocks(v) == jzoo._effnet_blocks(v)
    for v in (3.0, 8.0, 19.2, 38.4, 100.0, 134.4, 230.4):
        assert tzoo._make_divisible(v) == jzoo._make_divisible(v)
    with pytest.raises(ValueError, match="unknown"):
        tzoo.create_model("nope")


# ---- the torchvision loaders ---------------------------------------------

def _bn(st, key, n, rng):
    st[f"{key}.weight"] = rng.uniform(0.5, 1.5, n)
    st[f"{key}.bias"] = rng.normal(0, 0.1, n)
    st[f"{key}.running_mean"] = rng.normal(0, 0.1, n)
    st[f"{key}.running_var"] = rng.uniform(0.5, 2.0, n)
    st[f"{key}.num_batches_tracked"] = np.array(3)


def _w(rng, *shape):
    return rng.normal(0, 0.05, shape)


def _resnet18_state(rng):
    st = {"conv1.weight": _w(rng, 64, 3, 7, 7), "fc.weight": _w(rng, 10, 512)}
    _bn(st, "bn1", 64, rng)
    cin = 64
    for layer, f in enumerate((64, 128, 256, 512), 1):
        for b in range(2):
            t = f"layer{layer}.{b}"
            st[f"{t}.conv1.weight"] = _w(rng, f, cin if b == 0 else f, 3, 3)
            _bn(st, f"{t}.bn1", f, rng)
            st[f"{t}.conv2.weight"] = _w(rng, f, f, 3, 3)
            _bn(st, f"{t}.bn2", f, rng)
            if b == 0 and cin != f:
                st[f"{t}.downsample.0.weight"] = _w(rng, f, cin, 1, 1)
                _bn(st, f"{t}.downsample.1", f, rng)
        cin = f
    return st


def _efficientnet_state(rng, variant):
    width, depth = jzoo._EFFNET_MULTS[variant]
    stem, _, head = jzoo._effnet_blocks(variant)
    st = {"features.0.0.weight": _w(rng, stem, 3, 3, 3),
          "classifier.1.weight": _w(rng, 10, head)}
    _bn(st, "features.0.1", stem, rng)
    cin = stem
    for si, (expand, k, _s, out, repeats) in enumerate(jzoo._EFFNET_STAGES,
                                                       1):
        out = jzoo._make_divisible(out * width)
        for b in range(int(math.ceil(repeats * depth))):
            t, exp, sq = f"features.{si}.{b}.block", cin * expand, max(
                1, cin // 4)
            j = 0
            if expand != 1:
                st[f"{t}.0.0.weight"] = _w(rng, exp, cin, 1, 1)
                _bn(st, f"{t}.0.1", exp, rng)
                j = 1
            st[f"{t}.{j}.0.weight"] = _w(rng, exp, 1, k, k)
            _bn(st, f"{t}.{j}.1", exp, rng)
            st[f"{t}.{j + 1}.fc1.weight"] = _w(rng, sq, exp, 1, 1)
            st[f"{t}.{j + 1}.fc1.bias"] = _w(rng, sq)
            st[f"{t}.{j + 1}.fc2.weight"] = _w(rng, exp, sq, 1, 1)
            st[f"{t}.{j + 1}.fc2.bias"] = _w(rng, exp)
            st[f"{t}.{j + 2}.0.weight"] = _w(rng, out, exp, 1, 1)
            _bn(st, f"{t}.{j + 2}.1", out, rng)
            cin = out
    st[f"features.{len(jzoo._EFFNET_STAGES) + 1}.0.weight"] = _w(
        rng, head, cin, 1, 1)
    _bn(st, f"features.{len(jzoo._EFFNET_STAGES) + 1}.1", head, rng)
    return st


def _vit_state(rng, tokens, old_mlp_names=False):
    d = VIT["dim"]
    st = {"conv_proj.weight": _w(rng, d, 3, 16, 16),
          "conv_proj.bias": _w(rng, d), "class_token": _w(rng, 1, 1, d),
          "encoder.pos_embedding": _w(rng, 1, tokens, d),
          "encoder.ln.weight": rng.uniform(0.5, 1.5, d),
          "encoder.ln.bias": _w(rng, d), "heads.head.weight": _w(rng, 10, d)}
    mlp = ("linear_1", "linear_2") if old_mlp_names else ("0", "3")
    for i in range(VIT["depth"]):
        t = f"encoder.layers.encoder_layer_{i}"
        for ln in ("ln_1", "ln_2"):
            st[f"{t}.{ln}.weight"] = rng.uniform(0.5, 1.5, d)
            st[f"{t}.{ln}.bias"] = _w(rng, d)
        st[f"{t}.self_attention.in_proj_weight"] = _w(rng, 3 * d, d)
        st[f"{t}.self_attention.in_proj_bias"] = _w(rng, 3 * d)
        st[f"{t}.self_attention.out_proj.weight"] = _w(rng, d, d)
        st[f"{t}.self_attention.out_proj.bias"] = _w(rng, d)
        st[f"{t}.mlp.{mlp[0]}.weight"] = _w(rng, 4 * d, d)
        st[f"{t}.mlp.{mlp[0]}.bias"] = _w(rng, 4 * d)
        st[f"{t}.mlp.{mlp[1]}.weight"] = _w(rng, d, 4 * d)
        st[f"{t}.mlp.{mlp[1]}.bias"] = _w(rng, d)
    return st


LOADERS = {
    "resnet": (lambda rng: _resnet18_state(rng), "resnet",
               jzoo.load_torch_resnet18, tzoo.load_torch_resnet18,
               tzoo.load_resnet18_npz, ()),
    "efficientnet_b0": (lambda rng: _efficientnet_state(rng, "b0"),
                        "efficientnet_b0", jzoo.load_torch_efficientnet,
                        tzoo.load_torch_efficientnet,
                        tzoo.load_efficientnet_npz, ("b0",)),
    "efficientnet_b3": (lambda rng: _efficientnet_state(rng, "b3"),
                        "efficientnet_b3", jzoo.load_torch_efficientnet,
                        tzoo.load_torch_efficientnet,
                        tzoo.load_efficientnet_npz, ("b3",)),
    "vit": (lambda rng: _vit_state(rng, 5), "vit_32", jzoo.load_torch_vit,
            tzoo.load_torch_vit, tzoo.load_vit_npz, ()),
    "vit_old_names": (lambda rng: _vit_state(rng, 5, True), "vit_32",
                      jzoo.load_torch_vit, tzoo.load_torch_vit,
                      tzoo.load_vit_npz, ()),
}


@pytest.mark.parametrize("which", list(LOADERS))
def test_torchvision_loader_equals_jax(nets, which, tmp_path):
    """One seeded torchvision-layout state_dict (torch tensors) through
    JAX's loader and the port's: every leaf equal, the heads untouched;
    the .npz form equal to the dict form."""
    make_state, net_name, jload, tload, tload_npz, extra = LOADERS[which]
    _, tree, _, _ = nets(net_name)
    make = NETS[net_name][1]
    state = {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in make_state(np.random.default_rng(9)).items()}
    want = bridge.flatten(_numpy(jload(tree, state, *extra)))
    net = tload(bridge.load_flax(make(), tree), state, *extra)
    got = bridge.flatten(bridge.to_flax(net))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["params/head_omega/kernel"],
                                  bridge.flatten(tree)
                                  ["params/head_omega/kernel"])
    np.savez(tmp_path / "state.npz",
             **{k: v.numpy() for k, v in state.items()})
    from_npz = tload_npz(bridge.load_flax(make(), tree),
                         str(tmp_path / "state.npz"), *extra)
    for k, v in bridge.flatten(bridge.to_flax(from_npz)).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)


def test_vit_loader_refuses_another_image_size(nets):
    _, tree, _, _ = nets("vit_40")
    net = bridge.load_flax(NETS["vit_40"][1](), tree)
    with pytest.raises(ValueError, match="pos embedding"):
        tzoo.load_torch_vit(net, _vit_state(np.random.default_rng(0), 5))
    bad = _resnet18_state(np.random.default_rng(0))
    bad["layer2.0.conv1.weight"] = bad["layer2.0.conv1.weight"][:, :3]
    with pytest.raises(ValueError, match="layer2.0.conv1.weight"):
        tzoo.load_torch_resnet18(tzoo.CNNParameterPredictor(), bad)


# ---- enhance_zoo and ZooPredictor ----------------------------------------

@pytest.fixture(scope="module")
def underwater_img():
    return torch_frames.underwater_img()


@pytest.mark.parametrize("mode", ["index", "index-u8"])
def test_enhance_zoo_matches_jax(underwater_img, mode):
    imgs = np.stack([underwater_img, underwater_img[::-1]])
    params = {"omega": [0.35, 0.62], "gamma": [1.1, 1.45],
              "L_low": [6.5, 17.0], "L_high": [88.0, 97.0],
              "use_gamma": [0.3, 0.85], "guided_radius": [12.0, 20.0]}
    want = np.asarray(jde.enhance_zoo(
        jnp.asarray(imgs), {k: jnp.asarray(v, jnp.float32)
                            for k, v in params.items()}, stretch_mode=mode))
    got = tde.enhance_zoo(torch.from_numpy(imgs), params, mode).numpy()
    assert got.shape == imgs.shape and got.dtype == np.float32
    print(mode, "enhance_zoo |port - JAX|:", float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


ZOO_SIZE = 32


@pytest.fixture(scope="module")
def zoo_tree():
    return _calibrated_tree(tzoo.CNNParameterPredictor(), ZOO_SIZE, seed=21)


@pytest.fixture(scope="module")
def jax_zoo(zoo_tree):
    """A JAX ResNet ZooPredictor at input 32 holding the seeded tree."""
    p = jpred.ZooPredictor(model_type="resnet", input_size=ZOO_SIZE)
    p.variables = jax.tree_util.tree_map(jnp.asarray, zoo_tree)
    return p


@pytest.fixture(scope="module")
def port_zoo(zoo_tree):
    p = tpred.ZooPredictor(model_type="resnet", input_size=ZOO_SIZE,
                           device="cpu")
    bridge.load_flax(p.model, zoo_tree)
    return p


@pytest.fixture(scope="module")
def jax_zoo_params(jax_zoo, underwater_img):
    return jax_zoo.predict_parameters(jnp.asarray(underwater_img))


def _frames():
    rng = np.random.default_rng(5)
    return {"underwater": torch_frames.underwater_img(),
            "img_unit": torch_frames.img_unit(),
            "off_grid": rng.random((97, 131, 3)).astype(np.float32),
            "grid": (np.arange(64 * 64 * 3).reshape(64, 64, 3) % 256
                     ).astype(np.float32) / np.float32(255)}


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("which", list(_frames()))
def test_zoo_preprocess_bit_equal_to_jitted_jax(jax_zoo, port_zoo, which,
                                                normalize):
    img = _frames()[which]
    jax_zoo.imagenet_normalize = port_zoo.imagenet_normalize = normalize
    try:
        # a fresh function, so that jit traces this flag's branch
        want = np.asarray(jax.jit(lambda x: jax_zoo._preprocess(x))(
            jnp.asarray(img)))
        got = port_zoo._preprocess(torch.from_numpy(img)).numpy()
    finally:
        jax_zoo.imagenet_normalize = port_zoo.imagenet_normalize = True
    assert got.shape == (ZOO_SIZE, ZOO_SIZE, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got.min() < 0) == normalize


def test_zoo_predict_parameters_match_jax(port_zoo, jax_zoo_params,
                                          underwater_img):
    got = port_zoo.predict_parameters(underwater_img)
    assert set(got) == set(jax_zoo_params) == set(tpred.CLAMPS)
    diffs = {k: abs(got[k] - jax_zoo_params[k]) for k in got}
    print("ZooPredictor |port - JAX| per parameter:", diffs)
    assert max(diffs.values()) <= 1e-4, diffs
    # the heads' ranges lie inside the clamps: no parameter sits on one
    assert all(tpred.CLAMPS[k][0] < got[k] < tpred.CLAMPS[k][1] for k in got)


def test_zoo_enhance_image_matches_jax(jax_zoo, port_zoo, jax_zoo_params,
                                       underwater_img):
    want = jax_zoo.enhance_image(jnp.asarray(underwater_img), jax_zoo_params)
    got = port_zoo.enhance_image(underwater_img, jax_zoo_params)
    assert got.shape == underwater_img.shape and got.dtype == np.float32
    print("ZooPredictor.enhance_image |port - JAX|:",
          float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_zoo_predictor_refuses_orbax_and_needs_a_card(tmp_path, port_zoo):
    with pytest.raises(ValueError, match="jax_ckpt_to_npz.py --arch resnet"):
        port_zoo.load(str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpred.ZooPredictor(model_type="resnet", input_size=ZOO_SIZE)


def test_zoo_process_folder(tmp_path, port_zoo, underwater_img):
    src = tmp_path / "in"
    tio.imwrite_unit(str(src / "a.png"), underwater_img)
    (src / "junk.png").write_bytes(b"not an image")
    failed = []
    n = port_zoo.process_folder(str(src), str(tmp_path / "out"),
                                log=failed.append)
    assert n == 1 and len(failed) == 1 and "junk.png" in failed[0]
    written = tio.imread_u8(str(tmp_path / "out" / "a_enhanced.png"))
    want = port_zoo.enhance_image(tio.imread_unit(str(src / "a.png")))
    np.testing.assert_array_equal(written, (want * 255).astype(np.uint8))


def _convert(ckpt, out, **kw):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "jax_ckpt_to_npz.py"
    spec = importlib.util.spec_from_file_location("jax_ckpt_to_npz", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.convert(str(ckpt), str(out), **kw)


def test_converter_zoo_checkpoint(tmp_path, zoo_tree, jax_zoo_params,
                                  underwater_img, capsys):
    """A raw {params, batch_stats} orbax checkpoint of the JAX ResNet
    predictor, converted with --arch resnet: the port's ZooPredictor and
    ``cli enhance --arch resnet`` on it give JAX's parameters."""
    save_checkpoint(str(tmp_path / "ckpt"), zoo_tree)
    n = _convert(tmp_path / "ckpt", tmp_path / "z.npz", arch="resnet",
                 input_size=ZOO_SIZE)
    assert n == len(bridge.flatten(zoo_tree))
    pred = tpred.ZooPredictor(str(tmp_path / "z.npz"), model_type="resnet",
                              input_size=ZOO_SIZE, device="cpu")
    got = pred.predict_parameters(underwater_img)
    assert max(abs(got[k] - jax_zoo_params[k]) for k in got) <= 1e-4
    tio.imwrite_unit(str(tmp_path / "a.png"), underwater_img)
    capsys.readouterr()
    tcli.main(["enhance", "--input", str(tmp_path / "a.png"), "--output",
               str(tmp_path / "o.png"), "--model", str(tmp_path / "z.npz"),
               "--arch", "resnet", "--input-size", str(ZOO_SIZE),
               "--device", "cpu"])
    assert "predicted params:" in capsys.readouterr().out
    np.testing.assert_array_equal(
        tio.imread_u8(str(tmp_path / "o.png")),
        (pred.enhance_image(underwater_img, got) * 255).astype(np.uint8))


def test_cli_enhance_vit_end_to_end(tmp_path, capsys, underwater_img):
    """``cli enhance --arch vit`` (ViT-B/16: dim 768, depth 12, 12 heads)
    at --input-size 32 from a seeded .npz on a folder, on --device cpu:
    the PNGs are ZooPredictor.enhance_image's (a file's form:
    test_converter_zoo_checkpoint)."""
    net = tzoo.ViTParameterPredictor(image_size=32)
    bridge.save_npz(str(tmp_path / "vit.npz"), seeded_tree(bridge, net, 4))
    del net
    src = tmp_path / "in"
    tio.imwrite_unit(str(src / "a.png"), underwater_img)
    tio.imwrite_unit(str(src / "b.png"), torch_frames.img_unit())
    argv = ["--model", str(tmp_path / "vit.npz"), "--arch", "vit",
            "--input-size", "32", "--device", "cpu"]
    capsys.readouterr()
    tcli.main(["enhance", "--input", str(src), "--output",
               str(tmp_path / "out")] + argv)
    assert f"enhanced 2 images -> {tmp_path / 'out'}" in \
        capsys.readouterr().out
    pred = tpred.ZooPredictor(str(tmp_path / "vit.npz"), model_type="vit",
                              input_size=32, device="cpu")
    for png, frame in (("out/a_enhanced.png", underwater_img),
                       ("out/b_enhanced.png", torch_frames.img_unit())):
        np.testing.assert_array_equal(
            tio.imread_u8(str(tmp_path / png)),
            (pred.enhance_image(frame) * 255).astype(np.uint8), err_msg=png)
