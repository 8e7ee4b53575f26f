"""The port's Water-Net and UNet enhancers (models/waternet), their
preprocessing views, ``cli waternet`` and the WaterNet dialect of the
JAX-checkpoint converter, on the CPU, against the JAX package (its
parameters carried across by the bridge) and the float64 NumPy oracle
``testing/golden_cnn``.

The trees are seeded numpy values in the port's layout
(``chip_smoke.seeded_tree``), held to the shapes of the JAX modules'
``eval_shape``.  Tolerances: WaterNet and the UNet within 2e-5 of JAX and
of the oracle (the JAX suite's bound, tests/test_waternet.py), the UNet
also through ``unet_enhance`` at 18x22, which it pads to 20x24 (Flax's
SAME pad of its stride-2 convs is (0, 1)); the views: ``wb`` bit-equal,
``he`` within 1 ulp (JAX's jitted ``/255`` is a reciprocal multiply, the
port's an IEEE division), ``gc`` within 1e-5; a batch within 1e-6 of
its frames one by one; bf16 within 0.05 of f32 (the JAX suite's bound).
Measured with ``-s``: the largest difference of each comparison is
printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import seeded_tree
from tests import torch_frames
from underwater_image_enhancement_tpu.models import waternet as jwn
from underwater_image_enhancement_tpu.testing import golden_cnn
from underwater_image_enhancement_tpu.train.trainer import save_checkpoint
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.models import bridge
from underwater_image_enhancement_tpu_torch.models import waternet as twn
from underwater_image_enhancement_tpu_torch.utils import io as tio

torch.set_num_threads(2)


def _tree(port_net, jax_net, *jax_inputs, seed=0):
    """seeded_tree of ``port_net`` (which then holds it), checked against
    the shapes of the JAX module's init on ``jax_inputs``."""
    tree = seeded_tree(bridge, port_net, seed)
    want = jax.eval_shape(jax_net.init, jax.random.PRNGKey(0), *jax_inputs)
    assert {k: v.shape for k, v in bridge.flatten(tree).items()} == {
        k: tuple(a.shape) for k, a in bridge.flatten(want).items()}
    bridge.load_flax(port_net, tree).eval()
    return tree


@pytest.fixture(scope="module")
def small_waternet():
    """WaterNet(16, 8) on both sides, holding one seeded tree."""
    jm = jwn.WaterNet(features=16, ftu_features=8)
    tm = twn.WaterNet(features=16, ftu_features=8)
    z = jnp.zeros((1, 16, 16, 3))
    return jm, _tree(tm, jm, z, z, z, z, seed=1), tm


@pytest.fixture(scope="module")
def frames():
    img = torch_frames.underwater_img()
    return np.stack([img, img[::-1, ::-1]])


def test_waternet_forward_matches_flax_and_oracle(small_waternet):
    jm, tree, tm = small_waternet
    rng = np.random.default_rng(7)
    raw, wb, he, gc = (rng.random((2, 20, 24, 3)).astype(np.float32)
                       for _ in range(4))
    want = np.asarray(jm.apply(tree, raw, wb, he, gc))
    oracle = golden_cnn.waternet_forward(tree, raw, wb, he, gc)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (raw, wb, he, gc))).numpy()
    assert got.shape == raw.shape and got.dtype == np.float32
    print("WaterNet |port - JAX|", float(np.abs(got - want).max()),
          "|port - oracle|", float(np.abs(got - oracle).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def small_unet():
    jm, tm = jwn.UNetEnhancer(features=8), twn.UNetEnhancer(features=8)
    return jm, _tree(tm, jm, jnp.zeros((1, 20, 24, 3)), seed=2), tm


def test_unet_forward_matches_flax_and_oracle(small_unet):
    jm, tree, tm = small_unet
    x = np.random.default_rng(8).random((2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jm.apply(tree, jnp.asarray(x)))
    oracle = golden_cnn.unet_forward(tree, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    print("UNet |port - JAX|", float(np.abs(got - want).max()),
          "|port - oracle|", float(np.abs(got - oracle).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-5)


def test_unet_enhance_pads_and_crops_as_jax(small_unet):
    """18x22 frames, edge-padded to 20x24: both stride-2 convs see even
    sides, where Flax pads (0, 1)."""
    jm, tree, tm = small_unet
    x = np.random.default_rng(9).random((2, 18, 22, 3)).astype(np.float32)
    want = np.asarray(jwn.unet_enhance(tree, jnp.asarray(x), jm))
    padded = np.pad(x, ((0, 0), (0, 2), (0, 2), (0, 0)), mode="edge")
    oracle = golden_cnn.unet_forward(tree, padded)[:, :18, :22]
    got = twn.unet_enhance(tm, torch.from_numpy(x)).numpy()
    single = twn.unet_enhance(tm, x[1]).numpy()
    assert got.shape == x.shape and single.shape == x[1].shape
    print("unet_enhance |port - JAX|", float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-5)
    np.testing.assert_allclose(single, got[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("batched", [True, False])
def test_preprocess_views_match_jax(frames, batched):
    imgs = frames if batched else frames[0]
    want = [np.asarray(v) for v in jax.jit(jwn.preprocess_views)(
        jnp.asarray(imgs))]
    got = [v.numpy() for v in twn.preprocess_views(torch.from_numpy(imgs))]
    for g, w in zip(got, want):
        assert g.shape == w.shape == imgs.shape and g.dtype == np.float32
    wb, he, gc = got
    np.testing.assert_array_equal(wb, want[0])
    np.testing.assert_array_max_ulp(he, want[1], maxulp=1)
    print("views: he ulps off", int((he != want[1]).sum()), "of", he.size,
          "gc |port - JAX|", float(np.abs(gc - want[2]).max()))
    np.testing.assert_allclose(gc, want[2], rtol=0, atol=1e-5)


def test_waternet_enhance_matches_jax(small_waternet, frames):
    jm, tree, tm = small_waternet
    want = np.asarray(jwn.waternet_enhance(tree, jnp.asarray(frames), jm))
    got = twn.waternet_enhance(tm, torch.from_numpy(frames)).numpy()
    single = twn.waternet_enhance(tm, frames[1]).numpy()
    assert got.shape == frames.shape and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    print("waternet_enhance |port - JAX|", float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(single, got[1], rtol=0, atol=1e-6)


def test_waternet_bf16_deployment_dtype(small_waternet, frames):
    """The bf16 WaterNet run with the f32 one's parameters (as JAX's
    ``model.apply(variables, ...)``) stays within 0.05 of f32."""
    _, _, tm = small_waternet
    bf16 = twn.WaterNet(features=16, ftu_features=8, dtype=torch.bfloat16)
    a = twn.waternet_enhance(tm, frames[:1]).numpy()
    b = twn.waternet_enhance(tm, frames[:1], bf16).numpy()
    assert b.dtype == np.float32 and 0 < np.abs(a - b).max() < 0.05
    print("bf16 |bf16 - f32|", float(np.abs(a - b).max()))
    assert all(p.dtype == torch.float32 for p in bf16.parameters())


def test_init_waternet_defaults():
    net = twn.init_waternet(torch.Generator().manual_seed(0))
    assert isinstance(net, twn.WaterNet) and not net.training
    assert (net.features, net.ftu_features, net.dtype) == (
        128, 32, torch.float32)
    assert net.Conv_0.weight.shape == (128, 12, 7, 7)
    assert not net.ftu_gc.Conv_2.bias.any()
    tree = bridge.to_flax(net)
    want = jax.eval_shape(lambda: jwn.init_waternet(jax.random.PRNGKey(0)))
    assert {k: v.shape for k, v in bridge.flatten(tree).items()} == {
        k: tuple(a.shape) for k, a in bridge.flatten(want).items()}


def test_cli_waternet_checkpoint_matches_jax_cli(tmp_path, capsys):
    """A full-width WaterNet (128, 32) checkpoint saved with orbax,
    converted with --arch waternet: ``cli waternet --checkpoint`` on a
    folder gives the JAX CLI's PNGs (within one level: outputs within
    2e-5 truncate to u8), and without --checkpoint the random-init
    notice; --bf16 runs."""
    import importlib.util
    from pathlib import Path

    from underwater_image_enhancement_tpu.cli import main as jax_main

    tree = seeded_tree(bridge, twn.WaterNet(), 3)
    save_checkpoint(str(tmp_path / "ckpt"), tree)
    path = Path(__file__).resolve().parents[1] / "tools" / "jax_ckpt_to_npz.py"
    spec = importlib.util.spec_from_file_location("jax_ckpt_to_npz", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    n = mod.convert(str(tmp_path / "ckpt"), str(tmp_path / "w.npz"),
                    arch="waternet")
    assert n == len(bridge.flatten(tree)) == 32
    img = torch_frames.underwater_img()
    src = tmp_path / "in"
    tio.imwrite_unit(str(src / "a.png"), img[:40, :48])
    tio.imwrite_unit(str(src / "b.png"), img[40:80, 50:98])
    (src / "junk.png").write_bytes(b"not an image")
    capsys.readouterr()
    tcli.main(["waternet", "--input", str(src), "--output",
               str(tmp_path / "t"), "--checkpoint", str(tmp_path / "w.npz"),
               "--device", "cpu"])
    jax_main(["waternet", "--input", str(src), "--output",
              str(tmp_path / "j"), "--checkpoint", str(tmp_path / "ckpt")])
    text = capsys.readouterr().out
    assert f"waternet-enhanced 2 images -> {tmp_path / 't'}" in text
    assert "junk.png" in text
    for s in "ab":
        a = tio.imread_u8(str(tmp_path / "t" / f"{s}_waternet.png"))
        b = tio.imread_u8(str(tmp_path / "j" / f"{s}_waternet.png"))
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, s
    for extra in ([], ["--bf16"]):
        tcli.main(["waternet", "--input", str(src / "a.png"), "--output",
                   str(tmp_path / "r"), "--device", "cpu"] + extra)
        assert "random-init" in capsys.readouterr().out
        assert tio.imread_u8(str(tmp_path / "r" / "a_waternet.png")).shape \
            == (40, 48, 3)


def test_cli_waternet_refuses_orbax_and_needs_a_card(tmp_path):
    with pytest.raises(ValueError, match="jax_ckpt_to_npz.py --arch waternet"):
        tcli.main(["waternet", "--input", str(tmp_path), "--output",
                   str(tmp_path / "o"), "--checkpoint", str(tmp_path),
                   "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["waternet", "--input", str(tmp_path), "--output",
                       str(tmp_path / "o")])
