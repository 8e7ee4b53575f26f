"""The port's six --fast tier on the CPU against the JAX package: the plain
versions of kernels K8 _approx (forward LAB), K7 (hysteresis) and K6 (prefix
sums in XLA:CPU's order) against the Pallas kernels in interpret mode or
their XLA twins, the hist-fast percentiles, the non-square box filter, the
fast guided filter, the banded-SAT airlight, each CLAHE leg, and the tier
as a whole."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_frames
from tests.test_torch_ops import _gray, _seeded_frame
from underwater_image_enhancement_tpu.ops import airlight as jair
from underwater_image_enhancement_tpu.ops import boxfilter as jbox
from underwater_image_enhancement_tpu.ops import colorspace as jcs
from underwater_image_enhancement_tpu.ops import edges as jedges
from underwater_image_enhancement_tpu.ops import guided as jguided
from underwater_image_enhancement_tpu.ops import histeq as jhisteq
from underwater_image_enhancement_tpu.ops import pallas_kernels as pk
from underwater_image_enhancement_tpu.ops import stretch as jstretch
from underwater_image_enhancement_tpu.pipeline import cast as jcast
from underwater_image_enhancement_tpu.pipeline.enhance import (
    six_strategy_tuple as jax_six,
)
from underwater_image_enhancement_tpu_torch.ops import airlight as tair
from underwater_image_enhancement_tpu_torch.ops import boxfilter as tbox
from underwater_image_enhancement_tpu_torch.ops import edges as tedges
from underwater_image_enhancement_tpu_torch.ops import guided as tguided
from underwater_image_enhancement_tpu_torch.ops import histeq as thisteq
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops import reduce as treduce
from underwater_image_enhancement_tpu_torch.ops import stretch as tstretch
from underwater_image_enhancement_tpu_torch.pipeline import cast as tcast
from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
    SIX_ORDER,
    six_strategy_tuple,
)

torch.set_num_threads(2)

GRID = np.arange(256, dtype=np.float32) / np.float32(255)


@pytest.fixture(scope="module")
def underwater_img():
    """conftest's underwater_img, drawn without the session rng
    (tests/torch_frames.py)."""
    return torch_frames.underwater_img()


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


# --- K8 _approx ------------------------------------------------------------

def _unit_planes(seed, shape=(64, 96)):
    """u8-grid planes over every grey level, plus off-grid and out-of-range
    values."""
    rng = np.random.default_rng(seed)
    p = GRID[rng.integers(0, 256, (3,) + shape)]
    p[:, :8] = rng.uniform(-0.1, 1.1, (3, 8, shape[1]))
    p[:, 8, :] = np.resize(GRID, (3, shape[1]))
    return p.astype(np.float32)


@pytest.fixture(scope="module")
def approx_lab():
    out = {}
    for seed in (0, 1):
        p = _unit_planes(seed)
        got = pk.lab_forward_planes_unit_approx(*(jnp.asarray(x) for x in p))
        out[seed] = (p, [np.asarray(x) for x in got])
    return out


def test_cbrt_surrogate_bit_equal_to_jax():
    idx = np.arange(3072, dtype=np.int32)
    got = kernels.cbrt_tab_approx(torch.from_numpy(idx)).numpy()
    want = np.asarray(pk._cbrt_tab_surrogate(jnp.asarray(idx), steps=2))
    np.testing.assert_array_equal(got, want)
    # the surrogate's own contract: within 1 of the exact table, not equal
    d = got.astype(np.int64) - kernels.lt.CBRT_TAB
    assert np.abs(d).max() == 1 and (d != 0).sum() > 100


@pytest.mark.parametrize("seed", [0, 1])
def test_lab_forward_approx_bit_equal_to_pallas(approx_lab, seed):
    p, want = approx_lab[seed]
    before = dict(kernels.launches)
    got = kernels.lab_forward_unit_approx(*(torch.from_numpy(x) for x in p))
    assert kernels.launches == before  # CPU tensors: the plain version
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", [0, 1])
def test_lab_forward_approx_within_one_of_exact(approx_lab, seed):
    """K8 _approx against the exact conversion: its own +-1 u8 LSB
    contract (tests/test_tpu_hw.py), not bit-equality."""
    p, _ = approx_lab[seed]
    t = [torch.from_numpy(x) for x in p]
    approx = kernels.lab_forward_unit_approx_plain(*t)
    exact = kernels.lab_forward_unit_plain(*t)
    diffs = [int((a - e).abs().max()) for a, e in zip(approx, exact)]
    assert max(diffs) == 1


# --- K7 --------------------------------------------------------------------

def _strong_weak(seed, shape):
    """Sparse strong seeds in a dense weak field: chains that take many
    rounds to fill, some cut off at the plane's edge."""
    rng = np.random.default_rng(seed)
    u = rng.random(shape)
    strong = (u < 0.004).astype(np.int32)
    weak = ((u >= 0.004) & (u < 0.5)).astype(np.int32)
    return torch.from_numpy(strong)[None], torch.from_numpy(weak)[None]


@pytest.mark.parametrize("iters", [4, 64])
@pytest.mark.parametrize("shape", [(96, 128), (61, 83)])
def test_hysteresis_bit_equal_to_pallas(iters, shape):
    strong, weak = _strong_weak(3, shape)
    got = kernels.hysteresis_propagate(strong, weak, iters)
    want = np.asarray(pk.hysteresis_propagate(
        jnp.asarray(strong[0].numpy()), jnp.asarray(weak[0].numpy()),
        iters=iters))
    assert got.dtype == torch.int32 and got.shape == strong.shape
    np.testing.assert_array_equal(got[0].numpy(), want)
    # the chains still grow after iters // 4 rounds
    assert not torch.equal(
        kernels.hysteresis_propagate(strong, weak, iters // 4), got)


@pytest.mark.parametrize("iters", [4, 64])
def test_canny_iters_bit_equal(iters):
    g = _gray(4, (96, 128))
    got = tedges.canny_u8(torch.from_numpy(g), hysteresis_iters=iters).numpy()
    want = np.asarray(jedges.canny_u8(jnp.asarray(g), hysteresis_iters=iters))
    np.testing.assert_array_equal(got, want)


# --- K6 --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 120, 160), (7, 15, 160), (2, 17, 33)])
def test_sat_rows_bit_equal_to_xla_cumsum(shape):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    got = kernels.sat_rows(torch.from_numpy(x))
    assert got.shape == (shape[0], shape[1] + 1, shape[2])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jair._sat_rows(x)))


def test_sat_rows_along_the_last_axis_bit_equal():
    """The exact descent's corner strips: (P, 3, W) scanned along W."""
    x = np.random.default_rng(5).random((6, 3, 160)).astype(np.float32)
    got = kernels.sat_rows(torch.from_numpy(x), -1).numpy()
    want = jax.jit(lambda v: jnp.pad(jnp.cumsum(v, axis=-1),
                                     ((0, 0), (0, 0), (1, 0))))(x)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("integer", [False, True])
def test_sat_rows_against_the_pallas_kernel(integer):
    """The Pallas kernel's Hillis-Steele association differs in the last
    bits: test_pallas.py's tolerance, and exact on integer inputs."""
    rng = np.random.default_rng(7)
    x = rng.random((3, 120, 160)).astype(np.float32)
    if integer:
        x = np.floor(x * 255).astype(np.float32)
    got = kernels.sat_rows(torch.from_numpy(x)).numpy()
    want = np.asarray(pk.sat_rows(jnp.asarray(x)))
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=3e-6, atol=1e-4)


def test_new_wrappers_check_inputs():
    s = torch.zeros((2, 4, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.hysteresis_propagate(s.float(), s, 4)
    with pytest.raises(ValueError):
        kernels.hysteresis_propagate(s[0], s[0], 4)
    with pytest.raises(ValueError):
        kernels.hysteresis_propagate(s, s, -1)
    with pytest.raises(TypeError):
        kernels.sat_rows(s)
    with pytest.raises(ValueError):
        kernels.sat_rows(torch.zeros((4, 6)).t())
    with pytest.raises(TypeError):
        kernels.lab_forward_unit_approx(s[0], s[0], s[0])


# --- hist-fast percentiles, box and guided filters --------------------------

PAIRS = [(5.0, 98.0), (15.0, 95.0), (20.0, 85.0), (2.0, 98.0), (10.0, 90.0),
         (3.0, 97.0)]


@pytest.mark.parametrize("subsample", [1, 8])
@pytest.mark.parametrize("lo,hi", PAIRS)
def test_perc_pair_hist_bit_equal_under_jit(lo, hi, subsample):
    rng = np.random.default_rng(int(lo * 10 + subsample))
    for c in (rng.random((120, 160)), GRID[rng.integers(0, 256, (97, 131))]):
        c = c.astype(np.float32)
        want = jax.jit(lambda v: jstretch._perc_pair_hist(
            v, lo, hi, subsample=subsample))(c)
        got = tstretch._perc_pair_hist(torch.from_numpy(c), lo, hi,
                                       subsample=subsample)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hist_fast_stretch_bit_equal(underwater_img):
    planes = [np.ascontiguousarray(underwater_img[..., c]) for c in range(3)]
    want = jax.jit(lambda *p: jstretch.white_balance_planes(
        p, 2.0, method="hist-fast"))(*planes)
    got = tstretch.white_balance_planes(
        tuple(torch.from_numpy(p) for p in planes), 2.0, method="hist-fast")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # "radix" is the exact tier's name for the sort; an unknown method raises
    with pytest.raises(ValueError):
        tstretch.white_balance_planes(got, 2.0, method="quantile")


@pytest.mark.parametrize("r,rx", [(5, 20), (3, 15), (2, 10), (7, 7)])
def test_box_filter_non_square_bit_equal(r, rx):
    x = np.random.default_rng(r * rx).random((4, 30, 160)).astype(np.float32)
    got = tbox.box_filter(torch.from_numpy(x), r, rx=rx).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbox.box_filter(x, r, rx=rx)))


@pytest.mark.parametrize("r,eps", [(20, 0.5), (15, 0.5), (10, 0.1)])
def test_guided_filter_fast_within_1e6(r, eps):
    rng = np.random.default_rng(r)
    I = GRID[rng.integers(0, 256, (120, 160))]
    p = rng.random((120, 160)).astype(np.float32)
    got = tguided.guided_filter_fast(torch.from_numpy(I), torch.from_numpy(p),
                                     r, eps).numpy()
    want = np.asarray(jguided.guided_filter_fast(jnp.asarray(I),
                                                 jnp.asarray(p), r, eps))
    assert got.shape == I.shape
    assert np.abs(got - want).max() <= 1e-6


# --- the banded-SAT airlight ------------------------------------------------

@pytest.fixture(scope="module")
def jax_fast_airlight():
    """The JAX banded-SAT descent's A and final box: a copy of its function
    whose globals map _brightest_pixel to a version that also returns the
    box (the module and its jit caches stay untouched), jitted once."""
    def with_box(p, r0, c0, h, w):
        return jair._brightest_pixel(p, r0, c0, h, w), jnp.stack([r0, c0, h, w])

    fn = jair.quadtree_airlight_planes.__wrapped__
    env = dict(fn.__globals__, _brightest_pixel=with_box)
    clone = types.FunctionType(fn.__code__, env, fn.__name__,
                               fn.__defaults__, fn.__closure__)
    jitted = jax.jit(lambda p: clone(p, edge_iters=4))

    def run(planes):
        A, box = jitted(tuple(jnp.asarray(p) for p in planes))
        return np.asarray(A), tuple(int(v) for v in np.asarray(box))

    return run


def _corrected_planes(img):
    img = np.asarray(jcast.detect_and_correct(jnp.asarray(img))[0])
    return [np.ascontiguousarray(img[..., c]) for c in range(3)]


@pytest.mark.parametrize("seeds", [("fixture",)] + [
    tuple(range(s, min(s + 7, 41))) for s in range(0, 41, 7)])
def test_fast_airlight_equal(seeds, jax_fast_airlight, underwater_img):
    """A and the final box equal the JAX descent's on the fixture and on
    seeds 0-40 of _seeded_frame (a seed that flips is a fault, ROADMAP
    Queue 3)."""
    for s in seeds:
        img = underwater_img if s == "fixture" else _seeded_frame(s)
        planes = _corrected_planes(img)
        want_A, want_box = jax_fast_airlight(planes)
        A, box = tair.quadtree_airlight_planes(
            tuple(torch.from_numpy(p) for p in planes), edge_iters=4,
            return_box=True)
        assert box == want_box, s
        np.testing.assert_array_equal(A.numpy(), want_A)


def test_xla_row_sum_association():
    """The corners' column sums in XLA:CPU's tree-reduction order, which a
    sequential or a pairwise sum does not give."""
    rng = np.random.default_rng(9)
    for W in (37, 160, 1920):
        x = (rng.random((7, 3, 3, W)) * 100).astype(np.float32)
        want = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=-1))(x))
        np.testing.assert_array_equal(treduce.xla_sum(x, 1), want)
        if W > 37:
            assert not np.array_equal(treduce.seq_sum(x, -1), want)


# --- the CLAHE legs and the tier --------------------------------------------

LEGS = [(3.0, 1.5), (2.0, None), (4.0, None), (1.5, 1.2), (3.5, 1.4)]


@pytest.mark.parametrize("clip,gamma", LEGS)
def test_clahe_leg_fast_equals_the_tpu_program(clip, gamma, underwater_img):
    """lab_fast=True against the TPU program's leg: K8 _approx (interpret),
    clahe_u8, then the inverse; 1 ulp (the jitted inverse multiplies by
    1/255, the port divides; the gamma LUTs' pow may differ in the last
    ulp)."""
    planes = [np.ascontiguousarray(x) for x in np.moveaxis(
        np.asarray(jstretch.enhance_contrast(jnp.asarray(underwater_img),
                                             5.0, 98.0, method="hist-fast")),
        -1, 0)]
    L, a, b = pk.lab_forward_planes_unit_approx(*(jnp.asarray(p) for p in planes))
    L = jhisteq.clahe_u8(L, clip, impl="pallas")
    if gamma is None:
        want = jcs.lab_to_rgb_unit_planes(L, a, b, impl="pallas")
    else:
        want = jcs.lab_to_rgb_unit_gamma_planes(L, a, b, gamma, impl="pallas")
    got = thisteq.clahe_enhancement_planes(
        tuple(torch.from_numpy(p) for p in planes), clip, gamma=gamma,
        lab_fast=True)
    for g, w in zip(got, want):
        assert _ulps(g.numpy(), np.asarray(w)) <= 1


@pytest.fixture(scope="module")
def jax_fast_frame(underwater_img):
    outs, code = jax_six(jnp.asarray(underwater_img), fast=True)
    return [np.asarray(o) for o in outs], int(code)


def test_six_fast_matches_jax(jax_fast_frame, underwater_img,
                              jax_fast_airlight):
    """The fast tier end to end against JAX's on the CPU: cast code and A
    equal, recipe 3 at >= 50 dB, the CLAHE recipes at the JAX suite's
    fast-tier gate of 25 dB (JAX on the CPU converts exactly where the TPU
    program, and the port, use K8 _approx)."""
    want, want_code = jax_fast_frame
    kernels.reset_launches()
    outs, code = six_strategy_tuple(underwater_img, fast=True, device="cpu")
    assert sum(kernels.launches.values()) == 0
    assert int(code) == want_code
    corr, _ = tcast.detect_and_correct(torch.from_numpy(underwater_img))
    A = tair.quadtree_airlight_planes(
        tuple(corr[..., c].contiguous() for c in range(3)), edge_iters=4)
    np.testing.assert_array_equal(
        A.numpy(), jax_fast_airlight(_corrected_planes(underwater_img))[0])
    psnrs = {}
    for k, name in enumerate(SIX_ORDER):
        got = outs[k].numpy()
        assert got.shape == underwater_img.shape and np.isfinite(got).all()
        psnrs[name] = _psnr(got, want[k])
        assert psnrs[name] >= (50.0 if name == "light_dehazing" else 25.0)
    print("fast tier, port vs JAX on the CPU, dB:", psnrs)
