"""Row sharding of one frame on the CPU: the port's ``parallel/spatial``
(the halo exchange and the five sharded functions), ``canny_u8(valid_rows=)``
and ``_canny_sharded``, and ``models/waternet.enhance_sharded``, against
the JAX package on its 8 virtual CPU devices (``make_mesh(8)``,
``make_mesh(4)``) and against the port's single-device ops.

The port's positions are CPU positions of one process
(``make_mesh(n, "cpu")``).  Gates, each at JAX's own or tighter: the halo
exchange equal to slices of the padded frame and to JAX's, in both edge
modes, over one hop and several; Canny with ``valid_rows`` and the
halo'd Canny bit-equal; ``clahe_spatial`` bit-identical to JAX's and to
``histeq.clahe_u8``; the box filter, stretch, enhance and guided filter
within 1e-6 of JAX's (JAX's own gates: cv2 at 80 dB, 40 dB, 35 dB, the
single device at 2e-5); ``enhance_sharded`` within 1e-5 of JAX's in both
modes and of ``waternet_enhance`` on the whole batch or frame.  ``-s``
prints each measured gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from chip_smoke import seeded_tree
from underwater_image_enhancement_tpu.models import waternet as jwn
from underwater_image_enhancement_tpu.ops import edges as jedges
from underwater_image_enhancement_tpu.ops import histeq as jhisteq
from underwater_image_enhancement_tpu.parallel import spatial as jsp
from underwater_image_enhancement_tpu.parallel.mesh import (
    make_mesh as jax_mesh,
)
from underwater_image_enhancement_tpu.parallel.six_spatial import (
    _canny_sharded as jax_canny_sharded,
)
from underwater_image_enhancement_tpu_torch.models import bridge
from underwater_image_enhancement_tpu_torch.models import waternet as twn
from underwater_image_enhancement_tpu_torch.ops import edges, histeq
from underwater_image_enhancement_tpu_torch.ops.guided import guided_filter
from underwater_image_enhancement_tpu_torch.parallel import spatial
from underwater_image_enhancement_tpu_torch.parallel.mesh import make_mesh
from underwater_image_enhancement_tpu_torch.parallel.six_spatial import (
    _canny_sharded,
)

torch.set_num_threads(2)


def _rng(seed):
    return np.random.default_rng(seed)


def _gap(name, got, want):
    d = float(np.abs(np.asarray(got, np.float64)
                     - np.asarray(want, np.float64)).max())
    print(f"{name}: max |port - reference| {d:.3e}")
    return d


@pytest.fixture(scope="module")
def jmesh8():
    return jax_mesh(8)


# ---------------------------------------------------------------------------
# the halo exchange
# ---------------------------------------------------------------------------

HALO_CASES = [
    # (H, positions, halo, edge): one hop, then several (halo > block)
    (64, 8, 3, "reflect101"), (64, 8, 3, "edge"),
    (64, 8, 20, "reflect101"), (64, 8, 20, "edge"),
    (48, 4, 30, "reflect101"), (24, 8, 13, "edge"),
]


@pytest.mark.parametrize("H,n,halo,edge", HALO_CASES)
def test_exchange_halo_equals_padded_frame(H, n, halo, edge, jmesh8):
    frame = _rng(1).random((H, 5)).astype(np.float32)
    blocks = spatial._shard(frame, make_mesh(n, "cpu"))
    got = spatial._exchange_halo(blocks, halo, edge)
    padded = np.pad(frame, ((halo, halo), (0, 0)),
                    mode="reflect" if edge == "reflect101" else "edge")
    hl = H // n
    for i, ext in enumerate(got):
        assert ext.shape == (hl + 2 * halo, 5)
        np.testing.assert_array_equal(ext.numpy(),
                                      padded[i * hl:i * hl + hl + 2 * halo])
    # and JAX's, ring-wrapped neighbours and all
    mesh = jax_mesh(n)
    want = shard_map(lambda b: jsp._exchange_halo(b, halo, "data", edge),
                     mesh=mesh, in_specs=P("data", None),
                     out_specs=P("data", None), check_rep=False)(
        jnp.asarray(frame))
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))


def test_exchange_halo_keeps_devices_and_rejects_edge():
    blocks = spatial._shard(np.zeros((8, 3, 2), np.float32),
                            make_mesh(2, "cpu"))
    ext = spatial._exchange_halo(blocks, 5)
    assert [e.shape for e in ext] == [(14, 3, 2)] * 2
    assert all(e.device.type == "cpu" for e in ext)
    with pytest.raises(ValueError, match="unknown edge"):
        spatial._exchange_halo(blocks, 1, "wrap")
    with pytest.raises(ValueError, match="do not divide"):
        spatial._shard(np.zeros((9, 3)), make_mesh(2, "cpu"))


def test_collectives_in_mesh_order():
    parts = [torch.tensor([1e8], dtype=torch.float32),
             torch.tensor([1.0]), torch.tensor([-1e8]), torch.tensor([1.0])]
    # ((1e8 + 1) + -1e8) + 1 = 1 in f32 (1e8 + 1 rounds to 1e8)
    assert [float(s) for s in spatial._psum(parts)] == [1.0] * 4
    assert float(spatial._psum_host([p.numpy() for p in parts])[0]) == 1.0
    assert [float(s) for s in spatial._pmax(parts)] == [1e8] * 4
    assert [float(s) for s in spatial._pmin(parts)] == [-1e8] * 4
    g = spatial._all_gather(parts)
    assert len(g) == 4 and all(torch.equal(x, torch.cat(parts)) for x in g)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_psum_order_equals_jax(n):
    """``_psum`` adds in the order ``lax.psum`` adds over JAX's CPU
    devices (left to right in mesh order), bit for bit on f32 values
    spread over 40 binades, where the right fold and the pairwise tree
    give other sums on 4 and 8 positions."""
    rng = _rng(7)
    x = (rng.standard_normal((n, 4000))
         * np.exp(rng.uniform(-20, 20, (n, 4000)))).astype(np.float32)
    want = np.array(shard_map(
        lambda b: jax.lax.psum(b, "data"), mesh=jax_mesh(n),
        in_specs=P("data", None), out_specs=P(None, None),
        check_rep=False)(jnp.asarray(x)))[0]
    got = spatial._psum([torch.from_numpy(r) for r in x])
    assert all(torch.equal(g, torch.from_numpy(want)) for g in got)
    np.testing.assert_array_equal(spatial._psum_host(list(x)), want)
    right = x[-1]
    for r in x[-2::-1]:
        right = right + r
    differ = int((right != want).sum())
    print(f"psum over {n}: the right fold differs on {differ} of 4000")
    assert n == 2 or differ > 0


# ---------------------------------------------------------------------------
# Canny on row bands and on row blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [(0, 40), (3, 37), (7, 20)])
def test_canny_valid_rows_bit_equal(rows):
    gray = _rng(2).integers(0, 256, (40, 56)).astype(np.int32)
    got = edges.canny_u8(torch.from_numpy(gray), 50, 150,
                         hysteresis_iters=6, valid_rows=rows)
    want = jedges.canny_u8(jnp.asarray(gray), 50, 150, hysteresis_iters=6,
                           use_pallas=False, valid_rows=rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:rows[0]].sum() == 0 and got[rows[1]:].sum() == 0


@pytest.mark.parametrize("n,iters,valid_to", [(8, 16, None), (4, 4, None),
                                              (8, 4, 60)])
def test_canny_sharded_bit_equal(n, iters, valid_to, jmesh8):
    """The halo'd Canny equals the whole plane's bounded propagation at
    every row, the frame's first and last included, and JAX's halo'd
    Canny; with ``valid_to`` (a padded frame's true height) JAX's, whose
    Sobel reads the pad rows below it."""
    gray = _rng(3).integers(0, 256, (64, 128)).astype(np.int32)
    got = torch.cat(_canny_sharded(
        spatial._shard(gray, make_mesh(n, "cpu")), iters, valid_to))
    if valid_to is None:
        whole = edges.canny_u8(torch.from_numpy(gray), 50, 150,
                               hysteresis_iters=iters)
        np.testing.assert_array_equal(got.numpy(), whole.numpy())
    else:
        assert got[valid_to:].sum() == 0
    want = shard_map(lambda g: jax_canny_sharded(g, iters, valid_to),
                     mesh=jax_mesh(n), in_specs=P("data", None),
                     out_specs=P("data", None), check_rep=False)(
        jnp.asarray(gray))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the five sharded functions against JAX's on the same mesh size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planes():
    rng = _rng(4)
    return {"x": rng.random((128, 96)).astype(np.float32),
            "img": rng.random((128, 64, 3)).astype(np.float32),
            "small": rng.random((64, 48, 3)).astype(np.float32),
            "guide": rng.random((128, 96)).astype(np.float32),
            "src": rng.random((128, 96)).astype(np.float32),
            "gray": rng.integers(0, 256, (128, 96)).astype(np.int32),
            "gray4": rng.integers(0, 256, (160, 160)).astype(np.int32)}


ENHANCE_PARAMS = {"L_low": 8.0, "L_high": 92.0, "omega": 0.6, "gamma": 1.2}


@pytest.fixture(scope="module")
def jax_results(planes, jmesh8):
    """JAX's sharded functions, each jitted whole (as one program; run
    eagerly, their shard_maps take minutes on the CPU)."""
    a = {k: jnp.asarray(v) for k, v in planes.items()}
    m = jmesh8
    return {
        "box": jax.jit(lambda x: jsp.box_filter_spatial(x, 9, m))(a["x"]),
        "stretch": jax.jit(lambda x: jsp.stretch_spatial(x, 10.0, 90.0, m))(
            a["img"]),
        "enhance": jax.jit(lambda x: jsp.enhance_spatial(
            x, ENHANCE_PARAMS, m))(a["small"]),
        "guided": jax.jit(lambda g, p: jsp.guided_filter_spatial(
            g, p, 7, 0.01, m))(a["guide"], a["src"]),
        "clahe": jax.jit(lambda g: jsp.clahe_spatial(g, 3.0, m))(a["gray"]),
    }


def test_box_filter_spatial(planes, jax_results):
    got = spatial.box_filter_spatial(planes["x"], 9, make_mesh(8, "cpu"))
    assert got.shape == (128, 96)
    assert _gap("box_filter_spatial", got, jax_results["box"]) <= 1e-6


def test_stretch_spatial(planes, jax_results):
    got = spatial.stretch_spatial(planes["img"], 10.0, 90.0,
                                  make_mesh(8, "cpu"))
    assert got.shape == (128, 64, 3)
    assert _gap("stretch_spatial", got, jax_results["stretch"]) <= 1e-6


def test_enhance_spatial(planes, jax_results):
    got = spatial.enhance_spatial(planes["small"], ENHANCE_PARAMS,
                                  make_mesh(8, "cpu"))
    assert _gap("enhance_spatial", got, jax_results["enhance"]) <= 1e-6


def test_guided_filter_spatial(planes, jax_results):
    got = spatial.guided_filter_spatial(planes["guide"], planes["src"], 7,
                                        0.01, make_mesh(8, "cpu"))
    assert _gap("guided_filter_spatial", got, jax_results["guided"]) <= 1e-6
    single = guided_filter(torch.from_numpy(planes["guide"]),
                           torch.from_numpy(planes["src"]), 7, 0.01)
    assert _gap("guided_filter_spatial vs single device", got, single) <= 2e-5


@pytest.mark.parametrize("name,n,clip", [("gray", 8, 1.5), ("gray", 8, 3.0),
                                         ("gray4", 4, 2.0)])
def test_clahe_spatial_bit_identical(planes, jax_results, name, n, clip):
    """Equal to the single-device CLAHE of the port and of JAX (which
    tests/test_parallel.py holds equal to JAX's ``clahe_spatial`` at
    these shapes), and to JAX's ``clahe_spatial`` at 8 positions."""
    gray = planes[name]
    got = spatial.clahe_spatial(gray, clip, make_mesh(n, "cpu"))
    np.testing.assert_array_equal(
        got.numpy(), histeq.clahe_u8(torch.from_numpy(gray), clip).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jhisteq.clahe_u8(jnp.asarray(gray), clip)))
    if (name, n, clip) == ("gray", 8, 3.0):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_results["clahe"]))


def test_clahe_spatial_needs_tile_rows():
    with pytest.raises(AssertionError, match="tile-aligned"):
        spatial.clahe_spatial(np.zeros((60, 64), np.int32), 2.0,
                              make_mesh(8, "cpu"))


# ---------------------------------------------------------------------------
# WaterNet over the mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def waternets():
    """WaterNet(8, 4) on both sides, one seeded tree."""
    jm = jwn.WaterNet(features=8, ftu_features=4)
    tm = twn.WaterNet(features=8, ftu_features=4)
    tree = seeded_tree(bridge, tm, 5)
    bridge.load_flax(tm, tree).eval()
    return jm, jax.tree.map(jnp.asarray, tree), tm


@pytest.fixture(scope="module")
def wn_inputs():
    rng = _rng(6)
    return {"batch": rng.random((8, 16, 16, 3)).astype(np.float32),
            "frame": rng.random((1, 96, 32, 3)).astype(np.float32),
            "tall": rng.random((1, 64, 32, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def wn_jax(waternets, wn_inputs, jmesh8):
    jm, jv, _ = waternets
    return {
        "batch": np.asarray(jwn.enhance_sharded(jv, wn_inputs["batch"],
                                                jmesh8, jm)),
        "frame": np.asarray(jwn.enhance_sharded(
            jv, wn_inputs["frame"], jmesh8, jm, shard_rows=True)),
        "tall": np.asarray(jwn.enhance_sharded(
            jv, wn_inputs["tall"], jmesh8, jm, shard_rows=True)),
    }


@pytest.mark.parametrize("key", ["batch", "frame", "tall"])
def test_enhance_sharded(key, waternets, wn_inputs, wn_jax):
    """The batch over 8 positions, and one frame's rows over 8 positions:
    12 rows a block (the 10-row halo from one neighbour) and 8 rows a
    block (from two)."""
    _, _, tm = waternets
    got = twn.enhance_sharded(tm, wn_inputs[key], make_mesh(8, "cpu"),
                              shard_rows=key != "batch")
    assert got.shape == wn_inputs[key].shape
    assert _gap(f"enhance_sharded {key} vs JAX", got, wn_jax[key]) <= 1e-5
    whole = twn.waternet_enhance(tm, wn_inputs[key])
    assert _gap(f"enhance_sharded {key} vs whole", got, whole) <= 1e-5


def test_enhance_sharded_single_frame_and_model(waternets, wn_inputs):
    """An (H, W, 3) frame stays unbatched; ``model`` runs the parameters
    of ``variables`` (here a second module of the same layout)."""
    _, _, tm = waternets
    other = twn.WaterNet(features=8, ftu_features=4).eval()
    frame = wn_inputs["frame"][0]
    got = twn.enhance_sharded(tm, frame, make_mesh(4, "cpu"), model=other,
                              shard_rows=True)
    assert got.shape == frame.shape
    assert _gap("enhance_sharded (H, W, 3)", got,
                twn.waternet_enhance(tm, frame)) <= 1e-5


@pytest.mark.parametrize("shape,n,rows,match", [
    ((1, 60, 16, 3), 8, True, r"image rows \(60\) must divide the mesh "
                              r"'data' axis size \(8\)"),
    ((1, 56, 16, 3), 8, True, r"7 rows/shard is below the 7-pixel conv "
                              r"halo; use more rows or fewer devices"),
    ((3, 16, 16, 3), 2, False, r"batch size \(3\) must divide the mesh "
                               r"'data' axis size \(2\); pad the batch or "
                               r"use shard_rows=True"),
])
def test_enhance_sharded_errors(waternets, shape, n, rows, match):
    _, _, tm = waternets
    with pytest.raises(ValueError, match=match):
        twn.enhance_sharded(tm, np.zeros(shape, np.float32),
                            make_mesh(n, "cpu"), shard_rows=rows)
