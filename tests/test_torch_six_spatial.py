"""The six strategies and the Ancuti fusion of one frame sharded on rows,
on the CPU: the port's ``parallel/six_spatial`` and
``parallel/fusion_spatial`` against the JAX package's on its virtual CPU
devices, and against themselves on one position.

Shapes: 64x128 on 8 positions (8-row blocks on the percentile grid; the
guided filter's halo spans several blocks), 72x96 on 4 (18-row blocks:
the masked percentile rows and the strip guided filter), 66x96 on 8
(padded to 72).  Gates: the cast code equal, the airlight A of the run
(``chip_smoke.airlight_recorded``) bit-equal to JAX's sharded airlight,
and so all six strategies within 1e-5, the three dehazing ones also at
JAX's own gate (tests/test_six_spatial.py: >= 55 dB, >= 50 padded).
The port at 2, 4 and 8 positions against one position: bit-equal where
the descent reaches the same A and box.  Fusion at 64x128 and 58x96
(padded) on 4 positions: >= 55 dB (50 padded), the two rows at each edge
within 1e-4, and within 1e-5 of JAX's everywhere; on 1 and 2 positions
within 1e-5 of the single-device fusion.  Against the port's own
single-device fast tier only the fast tier's 25 dB: its CLAHE legs
convert through the approximate LAB, the sharded program through the
exact one (ROADMAP's traps).  ``-s`` prints each measured gap.
"""

import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from chip_smoke import airlight_recorded, synthetic_frame
from underwater_image_enhancement_tpu.ops import histeq as jhisteq
from underwater_image_enhancement_tpu.parallel import six_spatial as jss
from underwater_image_enhancement_tpu.parallel.fusion_spatial import (
    ancuti_fusion_spatial as jax_fusion_spatial,
)
from underwater_image_enhancement_tpu.parallel.mesh import (
    make_mesh as jax_mesh,
)
from underwater_image_enhancement_tpu.pipeline.cast import (
    detect_and_correct as jax_cast,
)
from underwater_image_enhancement_tpu_torch.ops import colorspace as cs
from underwater_image_enhancement_tpu_torch.ops import histeq
from underwater_image_enhancement_tpu_torch.parallel import six_spatial as tss
from underwater_image_enhancement_tpu_torch.parallel.fusion_spatial import (
    ancuti_fusion_spatial,
)
from underwater_image_enhancement_tpu_torch.parallel.mesh import make_mesh
from underwater_image_enhancement_tpu_torch.parallel.spatial import (
    _gather,
    _shard,
)
from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
    SIX_ORDER,
    six_strategy_tuple,
)
from underwater_image_enhancement_tpu_torch.pipeline.fusion import (
    ancuti_fusion,
    gray_world_wb_planes,
)

torch.set_num_threads(2)

SIX_CASES = {"aligned": (64, 128, 8), "strip": (72, 96, 4),
             "padded": (66, 96, 8)}
FUSION_CASES = {"aligned": (64, 128, 4), "padded": (58, 96, 4)}
EXACT = ("clahe_enhancement", "white_balance", "histogram_eq")


def _frame(H, W, seed, lo=0.05):
    rng = np.random.default_rng(seed)
    return (np.floor((rng.random((H, W, 3)) * 0.9 + lo) * 255.0)
            / 255.0).astype(np.float32)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 99.0 if mse < 1e-12 else 10.0 * np.log10(1.0 / mse)


def _padded(img, n):
    """The frame as JAX's six_strategy_spatial pads it, and its true
    height (None where it is not padded)."""
    H = img.shape[0]
    align = math.lcm(n, 8)
    Hp = -(-H // align) * align
    if Hp == H:
        return img, None
    return np.concatenate([img, img[H - 1 - (Hp - H):H - 1][::-1]]), H


def _port_six(img, n):
    """The port's six_strategy_spatial on n CPU positions with the
    airlight of that run -> (outs, code, A, box)."""
    with airlight_recorded(tss) as air:
        outs, code = tss.six_strategy_spatial(img, make_mesh(n, "cpu"))
    assert len(air) == 1
    return outs.numpy(), int(code), air[0]["A"].numpy(), air[0]["box"]


@pytest.fixture(scope="module")
def six_frames():
    return {k: _frame(H, W, 10 + i)
            for i, (k, (H, W, _)) in enumerate(SIX_CASES.items())}


@pytest.fixture(scope="module")
def jax_six(six_frames):
    """JAX's six_strategy_spatial and its sharded airlight A of the
    cast-corrected frame, on the case's mesh."""
    out = {}
    for k, (H, W, n) in SIX_CASES.items():
        img = six_frames[k]
        mesh = jax_mesh(n)
        outs, code = jss.six_strategy_spatial(jnp.asarray(img), mesh)
        corrected, _ = jax_cast(jnp.asarray(img))
        pimg, valid = _padded(np.asarray(corrected), n)
        A = jax.jit(shard_map(
            lambda b, valid=valid: jss._airlight_sharded(
                tuple(b[..., c] for c in range(3)), H, W, valid_to=valid),
            mesh=mesh, in_specs=P("data", None, None), out_specs=P(),
            check_rep=False))(jnp.asarray(pimg))
        out[k] = (np.asarray(outs), int(code), np.asarray(A))
    return out


@pytest.fixture(scope="module")
def port_six(six_frames):
    """The port at the case's positions and at 1, with the airlight."""
    return {k: {m: _port_six(six_frames[k], m) for m in (n, 1)}
            for k, (_, _, n) in SIX_CASES.items()}


@pytest.mark.parametrize("case", list(SIX_CASES))
def test_six_spatial_against_jax(case, jax_six, port_six):
    H, W, n = SIX_CASES[case]
    want, code_w, A_w = jax_six[case]
    got, code, A, box = port_six[case][n]
    assert got.shape == (6, H, W, 3) and np.isfinite(got).all()
    assert code == code_w
    np.testing.assert_array_equal(A, A_w)
    gate = 50.0 if case == "padded" else 55.0
    for k, name in enumerate(SIX_ORDER):
        d = float(np.abs(got[k] - want[k]).max())
        p = _psnr(got[k], want[k])
        print(f"six_spatial {case} {name}: max |port - JAX| {d:.3e}, "
              f"{p:.1f} dB")
        assert d <= 1e-5, name
        if name not in EXACT:
            assert p >= gate, name
    print(f"six_spatial {case}: A {A.tolist()}, box {box}")


@pytest.mark.parametrize("positions", [2, 4, 8])
@pytest.mark.parametrize("case", list(SIX_CASES))
def test_six_spatial_against_one_position(case, positions, six_frames,
                                          port_six):
    """Bit-equal to the program on one position where the airlight's
    descent reaches the same box (the corners' f32 sums are added over
    other blocks); otherwise the non-dehazing strategies bit-equal and
    the dehazing ones at >= 55 dB."""
    one, code1, A1, box1 = port_six[case][1]
    got, code, A, box = _port_six(six_frames[case], positions)
    assert code == code1
    print(f"six_spatial {case} on {positions}: box {box} (one position "
          f"{box1}), A equal {np.array_equal(A, A1)}")
    if box == box1 and np.array_equal(A, A1):
        np.testing.assert_array_equal(got, one)
        return
    for k, name in enumerate(SIX_ORDER):
        if name in EXACT:
            np.testing.assert_array_equal(got[k], one[k])
        else:
            assert _psnr(got[k], one[k]) >= 55.0, name


def test_six_spatial_against_single_device_fast_tier(six_frames, port_six):
    """The single-device fast tier converts its CLAHE legs through the
    approximate LAB (K8 ``_approx``); the sharded program exactly: only
    the fast tier's 25 dB gate holds between them."""
    img = six_frames["aligned"]
    got, code, _, _ = port_six["aligned"][8]
    want, code_w = six_strategy_tuple(img, fast=True, device="cpu")
    assert code == int(code_w)
    for k, name in enumerate(SIX_ORDER):
        p = _psnr(got[k], want[k].numpy())
        print(f"six_spatial vs six --fast {name}: {p:.1f} dB")
        assert p >= 25.0, name


def test_six_spatial_shape_rule():
    with pytest.raises(AssertionError, match="whole CLAHE tile rows"):
        tss.six_strategy_spatial(np.zeros((64, 100, 3), np.float32),
                                 make_mesh(4, "cpu"))
    with pytest.raises(AssertionError, match="whole CLAHE tile rows"):
        tss.six_strategy_spatial(np.zeros((64, 96, 3), np.float32),
                                 make_mesh(3, "cpu"))


# ---------------------------------------------------------------------------
# the Ancuti fusion
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fusion_frames():
    return {k: _frame(H, W, 20 + i, lo=0.0)
            for i, (k, (H, W, _)) in enumerate(FUSION_CASES.items())}


@pytest.fixture(scope="module")
def jax_fusion(fusion_frames):
    return {k: np.asarray(jax_fusion_spatial(jnp.asarray(fusion_frames[k]),
                                             jax_mesh(n)))
            for k, (_, _, n) in FUSION_CASES.items()}


@pytest.mark.parametrize("case", list(FUSION_CASES))
def test_fusion_spatial_against_jax(case, fusion_frames, jax_fusion):
    H, W, n = FUSION_CASES[case]
    got = ancuti_fusion_spatial(fusion_frames[case],
                                make_mesh(n, "cpu")).numpy()
    want = jax_fusion[case]
    assert got.shape == want.shape == (H, W, 3)
    err = np.abs(got - want)
    p = _psnr(got, want)
    print(f"fusion_spatial {case}: max |port - JAX| {err.max():.3e} (edge "
          f"rows {err[:2].max():.3e}, {err[-2:].max():.3e}), {p:.1f} dB")
    assert p > (50.0 if case == "padded" else 55.0)
    assert err[:2].max() <= 1e-4 and err[-2:].max() <= 1e-4
    assert err.max() <= 1e-5


@pytest.mark.parametrize("positions", [1, 2])
def test_fusion_spatial_against_single_device(positions, fusion_frames):
    """The port's sharded fusion against its single-device
    ``ancuti_fusion``: within 1e-5, and at the JAX suite's gate, 55 dB."""
    img = fusion_frames["aligned"]
    got = ancuti_fusion_spatial(img, make_mesh(positions, "cpu")).numpy()
    want = ancuti_fusion(img).numpy()
    d, p = float(np.abs(got - want).max()), _psnr(got, want)
    print(f"fusion_spatial on {positions} vs ancuti_fusion: {d:.3e}, "
          f"{p:.1f} dB")
    assert d <= 1e-5 and p > 55.0


def test_sharded_clahe_equals_cv2_and_jax():
    """Fusion's CLAHE leg at 128x96 (16x12-pixel tiles) on the seeded
    ``synthetic_frame(3)``: the port's sharded CLAHE of the exact LAB L
    on 4 positions equals its single-device ``clahe_u8``, JAX's
    ``clahe_u8`` and cv2 bit for bit."""
    img = synthetic_frame(3, 128, 96)
    wb = gray_world_wb_planes(tuple(torch.from_numpy(img[..., c].copy())
                                    for c in range(3)))
    L = cs.rgb_to_lab_u8_exact_planes(*(cs.quantize_u8(c) for c in wb))[0]
    want = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(
        L.numpy().astype(np.uint8))
    blocks = _shard(L, make_mesh(4, "cpu"))
    got = _gather(tss._clahe_rows_sharded(blocks, 2.0, 8, 128, 96))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(histeq.clahe_u8(L, 2.0, 8, 8).numpy(),
                                  want)
    np.testing.assert_array_equal(
        np.asarray(jhisteq.clahe_u8(jnp.asarray(L.numpy()), 2.0, 8, 8)),
        want)
