"""Data parallelism over a mesh on the CPU: the port's ``parallel/mesh``,
``enhance_batch_dp``, ``label_batch_dp`` and ``--devices`` on ``cli
enhance``, ``auto``, ``build-dataset`` and ``run``.

The port's mesh positions may repeat a device, so N CPU positions stand in
for N devices.  Every program on the mesh is per-image, so each result on
2, 3 and 4 positions is held bit-equal to the single call, and the CLI's
PNGs and CSV byte-equal between ``--devices 1`` and ``--devices 4`` (the
JAX suite's ``tests/test_cli_dp.py``).  Against JAX: the port's dp calls
against JAX's ``enhance_batch_dp``/``label_batch_dp`` on JAX's 8 virtual
CPU devices, within the single-device tests' tolerances
(``tests/test_torch_enhance.py``: 1e-6; ``tests/test_torch_label.py``).

The port calls the program once per position (JAX: once on the padded
global batch), so ``run_data_parallel``'s ``fn`` sees ``[2, 2, 2, 2]`` for
a batch of 5 on 4 positions where JAX's sees ``[8]``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_label import _check_features, _check_winners
from underwater_image_enhancement_tpu.parallel import mesh as jmesh
from underwater_image_enhancement_tpu.pipeline.enhance import (
    enhance_batch_dp as jax_enhance_dp,
)
from underwater_image_enhancement_tpu.select.system import (
    label_batch_dp as jax_label_dp,
)
from underwater_image_enhancement_tpu.utils import config as jconfig
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.parallel import mesh
from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
    enhance_batch,
    enhance_batch_dp,
)
from underwater_image_enhancement_tpu_torch.select.system import (
    label_batch,
    label_batch_dp,
)
from underwater_image_enhancement_tpu_torch.utils import io as tio

torch.set_num_threads(2)

WEIGHTS = tuple(sorted(jconfig.DEFAULT_QUALITY_WEIGHTS.items()))
PARAMS = (10.0, 90.0, 0.6, 1.2)


def _frames(n, h=40, w=48, seed=5):
    """n seeded frames on the u8 grid, darker to brighter."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        base = np.stack([0.1 + 0.2 * (xx / w), 0.5 + 0.2 * np.sin(yy / 7.0),
                         0.4 + 0.2 * np.cos((xx - yy) / 13.0)], -1)
        img = np.clip(base * (0.6 + 0.08 * i)
                      + rng.normal(0, 0.05, (h, w, 3)), 0, 1)
        out.append(np.floor(img.astype(np.float32) * 255) / 255)
    return np.stack(out).astype(np.float32)


def test_mesh_positions_and_placements():
    m = mesh.make_mesh(3, "cpu")
    assert m.size == 3 and m.axis_names == ("data",)
    assert m.shape == {"data": 3} and m.devices == (torch.device("cpu"),) * 3
    assert mesh.maybe_mesh(None) is None and mesh.maybe_mesh(m) is m
    assert mesh.maybe_mesh(2, "cpu").size == 2
    assert mesh.default_mesh(None, "cpu") is None
    assert mesh.default_mesh(1, "cpu") is None
    assert mesh.default_mesh(4, "cpu").size == 4
    if torch.cuda.device_count() == 0:
        assert mesh.default_mesh(None, "cuda") is None
    with pytest.raises(ValueError, match="CUDA devices asked"):
        mesh.make_mesh(torch.cuda.device_count() + 1, "cuda")
    x = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    place = mesh.data_parallel_sharding(m)(x)
    assert [s for _, s in place] == [slice(0, 2), slice(2, 4), slice(4, 6)]
    assert mesh.data_parallel_sharding(None)(x) is None
    shards = mesh.shard_batch({"x": x, "y": (x[:, 0],)}, m)
    assert len(shards) == 3
    for i, s in enumerate(shards):
        assert torch.equal(s["x"], torch.from_numpy(x[2 * i:2 * i + 2]))
        assert torch.equal(s["y"][0], torch.from_numpy(x[2 * i:2 * i + 2, 0]))
    assert mesh.shard_batch(x, None) is x
    reps = mesh.replicate((x,), m)
    assert len(reps) == 3 and all(torch.equal(r[0], torch.from_numpy(x))
                                  for r in reps)
    back = mesh.gather_shards([s["x"] for s in shards], m)
    assert torch.equal(back, torch.from_numpy(x))
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch(x[:5], m)


def test_run_data_parallel_pads_and_crops():
    """B=5 on 4 positions: padded to 8 with the last frame, one call of 2
    rows a position, every output leaf cropped back to 5; B=3 (below the
    mesh): one plain call of 3."""
    m = mesh.make_mesh(4, "cpu")
    x = np.arange(5 * 4 * 4 * 3, dtype=np.float32).reshape(5, 4, 4, 3)
    seen = []

    def fn(b):
        seen.append((int(b.shape[0]), b.device.type))
        return {"mean": b.mean(dim=(1, 2, 3)), "parts": (b * 2.0, b[:, 0])}

    out = mesh.run_data_parallel(fn, x, m)
    assert seen == [(2, "cpu")] * 4
    assert out["mean"].shape == (5,) and out["parts"][0].shape == x.shape
    np.testing.assert_allclose(out["mean"].numpy(), x.mean(axis=(1, 2, 3)),
                               rtol=1e-6)
    np.testing.assert_array_equal(out["parts"][0].numpy(), x * 2.0)
    np.testing.assert_array_equal(out["parts"][1].numpy(), x[:, 0])

    seen.clear()
    small = mesh.run_data_parallel(fn, x[:3], m)
    assert seen == [(3, "cpu")] and small["mean"].shape == (3,)
    seen.clear()
    mesh.run_data_parallel(fn, x, None)
    assert seen == [(5, "cpu")]


@pytest.fixture(scope="module")
def jax_mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the suite's 8 virtual CPU devices")
    return jmesh.make_mesh(8)


@pytest.fixture(scope="module")
def jax_dp(jax_mesh8):
    """JAX's dp programs on its 8-device mesh, 8 frames."""
    imgs = _frames(8)
    enh = np.asarray(jax_enhance_dp(jnp.asarray(imgs), *PARAMS, jax_mesh8))
    lab = [np.asarray(v) for v in jax_label_dp(jnp.asarray(imgs), WEIGHTS,
                                               jax_mesh8)]
    return imgs, enh, lab


@pytest.mark.parametrize("n", [2, 3, 4])
def test_enhance_batch_dp_equals_single_call(n):
    imgs = _frames(12)
    lows = np.linspace(5.0, 16.0, 12).astype(np.float32)
    single = enhance_batch(imgs, lows, 90.0, 0.6, 1.2, device="cpu")
    got = enhance_batch_dp(imgs, lows, 90.0, 0.6, 1.2, mesh.make_mesh(n, "cpu"))
    assert torch.equal(got, single)
    with pytest.raises(ValueError, match="does not divide"):
        enhance_batch_dp(imgs[:n + 1], *PARAMS, mesh.make_mesh(n, "cpu"))


def test_enhance_batch_dp_matches_jax(jax_dp):
    imgs, want, _ = jax_dp
    for n in (2, 4):
        got = enhance_batch_dp(imgs, *PARAMS, mesh.make_mesh(n, "cpu"))
        assert np.abs(got.numpy() - want).max() <= 1e-6


@pytest.fixture(scope="module")
def port_label(jax_dp):
    imgs = jax_dp[0]
    kernels.reset_launches()
    single = label_batch(torch.from_numpy(imgs), dict(WEIGHTS))
    assert sum(kernels.launches.values()) == 0
    return single


@pytest.mark.parametrize("n", [2, 3, 4])
def test_label_batch_dp_equals_single_call(jax_dp, port_label, n):
    imgs = jax_dp[0][:6] if n == 3 else jax_dp[0]
    want = [v[:len(imgs)] for v in port_label]
    got = label_batch_dp(imgs, dict(WEIGHTS), mesh.make_mesh(n, "cpu"))
    assert all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))
    with pytest.raises(ValueError, match="does not divide"):
        label_batch_dp(imgs[:n + 1], dict(WEIGHTS), mesh.make_mesh(n, "cpu"))


def test_label_batch_dp_matches_jax(jax_dp, port_label):
    """The port on 4 positions against JAX on 8 devices: the winners and
    scores, features and winning frames within test_torch_label's bars."""
    imgs, _, (w_feats, w_scores, w_best, w_imgs) = jax_dp
    feats, scores, best, winners = label_batch_dp(
        imgs, dict(WEIGHTS), mesh.make_mesh(4, "cpu"))
    _check_winners(best.numpy(), scores.numpy(), w_best, w_scores, False)
    _check_features(feats.numpy(), w_feats, False, imgs[0].size // 3)
    for j in range(len(imgs)):
        if int(best[j]) == int(w_best[j]):
            d = np.abs(winners[j].numpy().astype(np.float64) - w_imgs[j])
            mse = float((d ** 2).mean())
            assert d.max() <= 1e-6 or 10 * np.log10(1.0 / mse) >= 50.0


@pytest.fixture(scope="module")
def dp_folder(tmp_path_factory):
    """Five same-shape frames (one batch padded to 8 on 4 positions) and
    one odd-shape frame (a plain call below the mesh)."""
    src = tmp_path_factory.mktemp("dp_in")
    for i, img in enumerate(_frames(5, seed=21)):
        tio.imwrite_unit(str(src / f"a{i}.png"), img)
    tio.imwrite_unit(str(src / "odd.png"), _frames(1, 32, 56, seed=22)[0])
    return src


def _pngs(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix == ".png"}


@pytest.mark.parametrize("cmd", ["enhance", "auto", "build-dataset", "run"])
def test_cli_devices_gives_the_same_bytes(dp_folder, tmp_path, cmd, capsys):
    outs = {}
    for n in ("1", "4"):
        out = tmp_path / f"d{n}"
        tcli.main([cmd, "--input", str(dp_folder), "--output", str(out),
                   "--device", "cpu", "--devices", n, "--batch-size", "5"])
        outs[n] = out
    one, four = outs["1"], outs["4"]
    if cmd in ("build-dataset", "run"):
        csv = "reports/dataset_building.csv"
        assert (one / csv).read_text() == (four / csv).read_text()
        one, four = one / "strategy_results", four / "strategy_results"
    a, b = _pngs(one), _pngs(four)
    assert len(a) == 6 and a == b
