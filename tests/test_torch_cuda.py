"""Kernel tests that need an NVIDIA GPU (marker ``gpu``): each CUDA
kernel against its plain PyTorch version on the card (and the fused
kernels against the kernels they fuse), and the six exact and fast tiers,
the Phase-1 label program, UIQM/UCIQE, the VGG and zoo predictors,
WaterNet and the UNet, the selector's MLP classifier, and the trainers'
eval-mode gradients and train steps on the card against the CPU path.  They skip where
``torch.cuda.is_available()`` is False.  On a GPU machine without JAX:

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    CLAHE_SHAPES,
    MLP_PROBA_MAX_ABS,
    WATERNET_BATCH_MAX_ABS,
    WATERNET_BF16_MAX_ABS,
    WATERNET_MAX_ABS,
    ZOO_NETS,
    ZOO_PARAM_MAX_REL,
    calibrate_batch_norm,
    head_rel,
    seeded_tree,
    PREDICTOR_FRAME_MAX_ABS,
    PREDICTOR_PARAM_MAX_ABS,
    TRAIN_LOSS_MAX_REL,
    grad_rel,
    INV_WRAPPERS,
    K7_SHAPES,
    LAB_OFFSETS,
    LAB_SHAPES,
    LAB_WRAPPERS,
    SCAN_LENGTHS,
    SCAN_WIDTHS,
    clahe_cases,
    cuda_kernel_names,
    lab_planes,
    predictor_tree,
    serpentine,
    synthetic_frame,
    tf32,
)
from underwater_image_enhancement_tpu_torch.ops import (
    airlight,
    colorspace,
    histeq,
    kernels,
)
from underwater_image_enhancement_tpu_torch.pipeline import cast as cast_mod
from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
    six_strategy_tuple,
)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SHAPES = [(1080, 1920), (97, 131), (1, 1)]


@pytest.mark.parametrize("shape", SHAPES)
def test_lab_forward_kernel_equals_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(1)
    p = [torch.rand(shape, generator=g, device=cuda) * 1.2 - 0.1
         for _ in range(3)]
    before = kernels.launches["lab_forward_unit"]
    got = kernels.lab_forward_unit(*p)
    assert kernels.launches["lab_forward_unit"] == before + 1
    for a, b in zip(got, kernels.lab_forward_unit_plain(*p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_lab_inverse_kernels_equal_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = [torch.randint(0, 256, shape, generator=g, device=cuda,
                       dtype=torch.int32) for _ in range(3)]
    for a, b in zip(kernels.lab_inverse_unit(*q),
                    kernels.lab_inverse_unit_plain(*q)):
        assert torch.equal(a, b)
    for a, b in zip(kernels.lab_inverse_unit_gamma(*q, 1.4),
                    kernels.lab_inverse_unit_gamma_plain(*q, 1.4)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("clip", [1.5, 4.0])
def test_clahe_apply_kernel_equals_plain(cuda, shape, clip):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randint(0, 256, shape, generator=g, device=cuda,
                      dtype=torch.int32)
    luts, ya, xa, geo = histeq.clahe_prep(x, clip, 8, 8)
    assert torch.equal(kernels.clahe_apply(x, luts, ya, xa, *geo),
                       kernels.clahe_apply_plain(x, luts, ya, xa, *geo))


def test_wrapper_rejects_mixed_devices(cuda):
    p = [torch.zeros((4, 4), device=cuda) for _ in range(3)]
    p[1] = p[1].cpu()
    with pytest.raises(ValueError):
        kernels.lab_forward_unit(*p)


def _frame():
    rng = np.random.default_rng(5)
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([0.15 + 0.1 * np.sin(xx / 17.0), 0.45 + 0.2 * np.cos(yy / 23.0),
                     0.55 + 0.15 * np.sin((xx + yy) / 31.0)], -1)
    img = np.clip(base + rng.normal(0, 0.03, (h, w, 3)), 0, 1).astype(np.float32)
    return (np.floor(img * 255) / 255).astype(np.float32)


def _card_matches_cpu(on_card, on_cpu):
    for k, (a, b) in enumerate(zip(on_card, on_cpu)):
        assert a.device.type == "cuda"
        d = (a.cpu().double() - b.double())
        if k >= 3:
            assert float(d.abs().max()) <= 1e-6
        else:
            mse = float((d ** 2).mean())
            assert mse == 0 or 10 * np.log10(1 / mse) >= 50


def test_six_on_card_matches_cpu(cuda):
    img = _frame()
    kernels.reset_launches()
    on_card, code_g = six_strategy_tuple(img)  # the default device: cuda
    n = dict(kernels.launches)
    # K7 once per descent level, K6 for the row table and each level's strip
    assert n.pop("hysteresis_propagate") >= 1
    assert n.pop("sat_rows") == 1 + kernels.launches["hysteresis_propagate"]
    assert n == {"lab_forward_unit": 5, "lab_forward_unit_approx": 0,
                 "lab_forward_u8": 0, "lab_forward_l_u8": 0,
                 "lab_forward_unit_fast": 0, "surrogate_corrections": 0,
                 "clahe_apply": 5, "clahe_lab_apply": 0,
                 "lab_inverse_unit": 2, "lab_inverse_unit_gamma": 3,
                 "lab_inverse_u8": 0}
    on_cpu, code_c = six_strategy_tuple(img, device="cpu")
    assert int(code_g) == int(code_c)
    _card_matches_cpu(on_card, on_cpu)


def test_six_fast_on_card_matches_cpu(cuda):
    img = _frame()
    kernels.reset_launches()
    on_card, code_g = six_strategy_tuple(img, fast=True)
    assert dict(kernels.launches) == {
        "lab_forward_unit": 0, "lab_forward_unit_approx": 5,
        "lab_forward_u8": 0, "lab_forward_l_u8": 0,
        "lab_forward_unit_fast": 0, "surrogate_corrections": 0,
        "clahe_apply": 5, "clahe_lab_apply": 0, "lab_inverse_unit": 2,
        "lab_inverse_unit_gamma": 3, "lab_inverse_u8": 0,
        "hysteresis_propagate": 1, "sat_rows": 1}
    on_cpu, code_c = six_strategy_tuple(img, fast=True, device="cpu")
    assert int(code_g) == int(code_c)
    corr = cast_mod.detect_and_correct(torch.from_numpy(img))[0]
    planes = [corr[..., c].contiguous() for c in range(3)]
    A_c, box_c = airlight.quadtree_airlight_planes(planes, edge_iters=4,
                                                   return_box=True)
    A_g, box_g = airlight.quadtree_airlight_planes(
        [p.to(cuda) for p in planes], edge_iters=4, return_box=True)
    assert box_g == box_c and torch.equal(A_g.cpu(), A_c)
    _card_matches_cpu(on_card, on_cpu)


@pytest.mark.parametrize("shape", SHAPES)
def test_lab_forward_approx_kernel_equals_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(4)
    p = [torch.rand(shape, generator=g, device=cuda) * 1.2 - 0.1
         for _ in range(3)]
    before = kernels.launches["lab_forward_unit_approx"]
    got = kernels.lab_forward_unit_approx(*p)
    assert kernels.launches["lab_forward_unit_approx"] == before + 1
    for a, b in zip(got, kernels.lab_forward_unit_approx_plain(*p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,iters", [((1, 1080, 1920), 4),
                                         ((1, 1080, 1920), 64),
                                         ((4, 97, 131), 64), ((3, 61, 83), 0),
                                         ((2, 1, 1), 4), ((1, 300, 40), 123)])
def test_hysteresis_kernel_equals_plain(cuda, shape, iters):
    g = torch.Generator(device=cuda).manual_seed(5)
    u = torch.rand(shape, generator=g, device=cuda)
    strong = (u < 0.004).to(torch.int32)
    weak = ((u >= 0.004) & (u < 0.5)).to(torch.int32)
    got = kernels.hysteresis_propagate(strong, weak, iters)
    assert torch.equal(got, kernels.hysteresis_propagate_plain(strong, weak,
                                                               iters))


@pytest.mark.parametrize("shape,dim", [((6, 1080, 1920), -2),
                                       ((7, 135, 1920), -2), ((18, 1920), -1),
                                       ((3, 5, 7), 0), ((2, 16, 3), 1),
                                       ((2, 17, 3), 1), ((1, 5000, 2), 1),
                                       ((3, 16 ** 3 + 1), -1)])
def test_sat_rows_kernel_equals_plain(cuda, shape, dim):
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.rand(shape, generator=g, device=cuda)
    assert torch.equal(kernels.sat_rows(x, dim), kernels.sat_rows_plain(x, dim))


def test_kernel_limits_raise(cuda):
    # a plane wider than one block's region: tiles with an `iters` halo
    s = torch.zeros((1, 8, 2048), dtype=torch.int32, device=cuda)
    assert kernels.hysteresis_tile(K7_MAX_ITERS, 8, 2048) is not None
    with pytest.raises(ValueError):
        kernels.hysteresis_propagate(s, s, K7_MAX_ITERS + 1)
    with pytest.raises(ValueError):
        kernels.sat_rows(torch.zeros((2, kernels.SCAN_MAX_LENGTH + 1),
                                     device=cuda), -1)
    with pytest.raises(ValueError):
        kernels.sat_rows(torch.zeros((2, 0, 3), device=cuda))
    with pytest.raises(ValueError):
        kernels.sat_rows(torch.zeros((), device=cuda))


K7_MAX_ITERS = 298  # the most rounds a tiled plan fits (hysteresis_tile)


@pytest.mark.parametrize("L", SCAN_LENGTHS)
def test_sat_rows_one_launch_equal_plain_sweep(cuda, L):
    """K6 on (L, M) along dim 0, (2, L, M) along dim 1 and (M, L) along
    the last dim, for every M of the sweep, with and without the leading
    zero: bit-equal (signs of zeros too) and one CUDA launch a call."""
    from underwater_image_enhancement_tpu_torch.utils import cuda_build

    ext = cuda_build.extension()
    g = torch.Generator(device=cuda).manual_seed(L)
    cases = []
    for M in SCAN_WIDTHS:
        base = torch.randn((2, L, M), generator=g, device=cuda)
        base[0, 0, 0] = -0.0
        for x, dim in ((base[0], 0), (base, 1),
                       (base[0].t().contiguous(), 1)):
            got = kernels.sat_rows(x, dim)
            want = kernels.sat_rows_plain(x, dim)
            assert torch.equal(got, want)
            assert torch.equal(torch.signbit(got), torch.signbit(want))
            bare = ext.sat_rows(x, dim, False)
            assert torch.equal(bare, kernels.xla_cumsum(x, dim))
            assert torch.equal(torch.signbit(bare),
                               torch.signbit(kernels.xla_cumsum(x, dim)))
            cases.append((x, dim))
    before = kernels.launches["sat_rows"]
    names = cuda_kernel_names(
        torch, lambda: [kernels.sat_rows(x, d) for x, d in cases],
        expect=len(cases))
    # one count a call (the session runs again where a capture was short)
    assert (kernels.launches["sat_rows"] - before) % len(cases) == 0
    assert len(names) == len(cases)
    assert all("prefix_scan_kernel" in n for n in names)


@pytest.mark.parametrize("iters", [0, 1, 4, 63, 64, K7_MAX_ITERS])
def test_hysteresis_sweep_equals_plain(cuda, iters):
    """K7 on planes smaller than a tile, whole planes in one block, widths
    that are not a multiple of 32 and N from 1 to 8, in a percolation
    field (long chains), and along a serpentine longer than ``iters``
    across tile borders: exactly ``iters`` steps of it are lit."""
    for k, shape in enumerate(K7_SHAPES):
        g = torch.Generator(device=cuda).manual_seed(k)
        u = torch.rand(shape, generator=g, device=cuda)
        strong = (u < 0.004).to(torch.int32)
        weak = ((u >= 0.004) & (u < 0.5)).to(torch.int32)
        got = kernels.hysteresis_propagate(strong, weak, iters)
        assert torch.equal(got, kernels.hysteresis_propagate_plain(
            strong, weak, iters)), shape
    for H, W in ((400, 1000), (1080, 1920)):
        for t in (False, True):  # along rows, and along columns
            strong, weak = (p.transpose(1, 2).contiguous() if t else p
                            for p in serpentine(torch, H, W, cuda))
            got = kernels.hysteresis_propagate(strong, weak, iters)
            assert torch.equal(got, kernels.hysteresis_propagate_plain(
                strong, weak, iters)), (H, W, t)
            assert int(got.sum()) == iters + 1


@pytest.mark.parametrize("shape", SHAPES)
def test_lab_forward_u8_kernels_equal_plain(cuda, shape):
    """K1b and K4 on int32 planes that reach past both ends of [0, 255]."""
    g = torch.Generator(device=cuda).manual_seed(7)
    p = [torch.randint(-20, 280, shape, generator=g, device=cuda,
                       dtype=torch.int32) for _ in range(3)]
    before = dict(kernels.launches)
    lab = kernels.lab_forward_u8(*p)
    L = kernels.lab_forward_l_u8(*p)
    assert kernels.launches["lab_forward_u8"] == before["lab_forward_u8"] + 1
    assert kernels.launches["lab_forward_l_u8"] == before["lab_forward_l_u8"] + 1
    for a, b in zip(lab, kernels.lab_forward_u8_plain(*p)):
        assert torch.equal(a, b)
    assert torch.equal(L, kernels.lab_forward_l_u8_plain(*p))
    assert torch.equal(L, lab[0])


@pytest.mark.parametrize("shape", LAB_SHAPES)
def test_lab_forward_sweep_equals_plain(cuda, shape):
    """The five forward-LAB kernels on planes whose pixel count leaves each
    residue mod 4 (the vector path's scalar tail) and on views 0-3
    elements into their buffers (misaligned planes take the scalar loop):
    bit-equal to the plain versions, one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(10)
    kernels.surrogate_corrections("cbrt", cuda)  # K8 _fast's probe, first
    cases = []
    for offsets in LAB_OFFSETS:
        for kname in LAB_WRAPPERS:
            args = lab_planes(torch, kname, shape, offsets, g, cuda)
            before = kernels.launches[kname]
            got = getattr(kernels, kname)(*args)
            assert kernels.launches[kname] == before + 1
            want = getattr(kernels, kname + "_plain")(*args)
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (kname, offsets)
            cases.append((getattr(kernels, kname), args))
    names = cuda_kernel_names(
        torch, lambda: [fn(*args) for fn, args in cases], expect=len(cases))
    assert len(names) == len(cases)
    assert all("lab_forward_kernel" in n for n in names)


@pytest.mark.parametrize("kname", LAB_WRAPPERS)
def test_lab_forward_repeats_equal_plain(cuda, kname):
    """Each forward-LAB kernel, called again and again on 4096x4096 planes
    (25 tiles a block, so each stage of a block's ring is refilled about
    eight times), gives its plain version's bits every time."""
    g = torch.Generator(device=cuda).manual_seed(11)
    kernels.surrogate_corrections("cbrt", cuda)
    args = lab_planes(torch, kname, (4096, 4096), (0, 0, 0), g, cuda)
    want = getattr(kernels, kname + "_plain")(*args)
    want = (want,) if isinstance(want, torch.Tensor) else want
    for _ in range(12):
        got = getattr(kernels, kname)(*args)
        got = (got,) if isinstance(got, torch.Tensor) else got
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_lab_l_hwc_launches_k4_for_every_impl(cuda, impl):
    """The HWC ``rgb_to_lab_l_u8_exact`` launches K4 once on a CUDA tensor
    whichever of JAX's ``impl`` values it is given, and equals the CPU's
    plain version."""
    g = torch.Generator(device=cuda).manual_seed(8)
    rgb = torch.randint(0, 256, (2, 45, 67, 3), generator=g, device=cuda,
                        dtype=torch.int32)
    before = kernels.launches["lab_forward_l_u8"]
    L = colorspace.rgb_to_lab_l_u8_exact(rgb, impl=impl)
    assert kernels.launches["lab_forward_l_u8"] == before + 1
    assert L.shape == (2, 45, 67) and L.dtype == torch.int32
    assert torch.equal(L.cpu(),
                       colorspace.rgb_to_lab_l_u8_exact(rgb.cpu(), impl=impl))


@pytest.mark.parametrize("fast", [False, True])
def test_label_batch_on_card_matches_cpu(cuda, fast):
    from underwater_image_enhancement_tpu_torch.select.system import label_batch
    from underwater_image_enhancement_tpu_torch.utils.config import (
        DEFAULT_QUALITY_WEIGHTS,
    )

    imgs = torch.from_numpy(np.stack([_frame(), _frame()[::-1].copy()]))
    kernels.reset_launches()
    feats, scores, best, win = label_batch(imgs.to(cuda),
                                           DEFAULT_QUALITY_WEIGHTS, fast=fast)
    n = dict(kernels.launches)
    assert n["lab_forward_l_u8"] == (0 if fast else 10)
    assert n["lab_forward_u8"] == (0 if fast else 2)
    c_feats, c_scores, c_best, c_win = label_batch(
        imgs, DEFAULT_QUALITY_WEIGHTS, fast=fast)
    assert float((scores.cpu() - c_scores).abs().max()) <= 1e-3
    assert torch.equal(best.cpu(), c_best)
    err = (feats.cpu().double() - c_feats.double()).abs()
    assert bool(((err <= 1e-4 * c_feats.double().abs()) | (err <= 1e-5)).all())
    assert win.shape == c_win.shape


@pytest.mark.parametrize("shape", SHAPES)
def test_lab_inverse_u8_kernel_equals_plain(cuda, shape):
    """K3b against its plain version, and K3 = K3b / 255."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q = [torch.randint(0, 256, shape, generator=g, device=cuda,
                       dtype=torch.int32) for _ in range(3)]
    before = kernels.launches["lab_inverse_u8"]
    got = kernels.lab_inverse_u8(*q)
    assert kernels.launches["lab_inverse_u8"] == before + 1
    for a, b, u in zip(got, kernels.lab_inverse_u8_plain(*q),
                       kernels.lab_inverse_unit(*q)):
        assert a.dtype == torch.int32 and torch.equal(a, b)
        assert torch.equal(u, colorspace.u8_to_unit(a))


@pytest.mark.parametrize("shape", SHAPES[:2] + [(1079, 1917)])
@pytest.mark.parametrize("clip", [1.5, 4.0])
def test_clahe_lab_apply_kernel_equals_plain_and_split(cuda, shape, clip):
    """K5 against its plain version and against K2 then K3b."""
    g = torch.Generator(device=cuda).manual_seed(9)
    L, a, b = (torch.randint(0, 256, shape, generator=g, device=cuda,
                             dtype=torch.int32) for _ in range(3))
    luts, ya, xa, geo = histeq.clahe_prep(L, clip, 8, 8)
    before = kernels.launches["clahe_lab_apply"]
    got = kernels.clahe_lab_apply(L, a, b, luts, ya, xa, *geo)
    assert kernels.launches["clahe_lab_apply"] == before + 1
    plain = kernels.clahe_lab_apply_plain(L, a, b, luts, ya, xa, *geo)
    split = kernels.lab_inverse_u8(kernels.clahe_apply(L, luts, ya, xa, *geo),
                                   a, b)
    for x, p, s in zip(got, plain, split):
        assert torch.equal(x, p) and torch.equal(x, s)


@pytest.mark.parametrize("gamma", [None, 1.4])
def test_fused_clahe_roundtrip_equals_split_on_card(cuda, gamma):
    planes = tuple(torch.from_numpy(_frame()[..., c].copy()).to(cuda)
                   for c in range(3))
    kernels.reset_launches()
    fused = histeq.clahe_enhancement_planes(planes, 3.0, gamma=gamma,
                                            impl="fused")
    assert kernels.launches["clahe_lab_apply"] == 1
    assert kernels.launches["clahe_apply"] == 0
    split = histeq.clahe_enhancement_planes(planes, 3.0, gamma=gamma)
    for f, s in zip(fused, split):
        assert torch.equal(f, s)


@pytest.mark.parametrize("name", ["cbrt", "inv_gamma"])
def test_probe_on_card_equals_plain_probe(cuda, name):
    """K9 against its plain version on the card and on the CPU; the card's
    corrections are the CPU's, and the cube root's are not None."""
    before = kernels.launches["surrogate_corrections"]
    got = kernels.surrogate_values(name, cuda)
    assert kernels.launches["surrogate_corrections"] == before + 1
    assert torch.equal(got, kernels.surrogate_values_plain(name, cuda))
    assert torch.equal(got.cpu(), kernels.surrogate_values_plain(name, "cpu"))
    corr = kernels.surrogate_corrections(name, cuda)
    assert corr == kernels.surrogate_corrections_plain(name, "cpu")
    assert corr is not None


@pytest.mark.parametrize("shape", SHAPES)
def test_lab_forward_fast_kernel_equals_plain_and_exact(cuda, shape):
    """K8 _fast against its plain version and against K1."""
    g = torch.Generator(device=cuda).manual_seed(10)
    p = [torch.rand(shape, generator=g, device=cuda) * 1.2 - 0.1
         for _ in range(3)]
    kernels.surrogate_corrections("cbrt", cuda)
    before = kernels.launches["lab_forward_unit_fast"]
    got = kernels.lab_forward_unit_fast(*p)
    assert kernels.launches["lab_forward_unit_fast"] == before + 1
    for a, b, e in zip(got, kernels.lab_forward_unit_fast_plain(*p),
                       kernels.lab_forward_unit(*p)):
        assert torch.equal(a, b) and torch.equal(a, e)


def test_uiqm_uciqe_on_card_match_cpu(cuda):
    from underwater_image_enhancement_tpu_torch.metrics import uiqm

    img = torch.from_numpy(_frame())
    kernels.reset_launches()
    u_g, c_g = uiqm.uiqm(img.to(cuda)), uiqm.uciqe(img.to(cuda))
    assert kernels.launches["lab_forward_u8"] == 1
    for got, want in ((u_g, uiqm.uiqm(img)), (c_g, uiqm.uciqe(img))):
        assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


@pytest.mark.parametrize("shape", LAB_SHAPES)
def test_lab_inverse_sweep_equals_plain(cuda, shape):
    """K3, K3g and K3b on planes whose pixel count leaves each residue mod 4
    (the vector path's scalar tail) and on views 0-3 elements into their
    buffers (misaligned planes take the scalar loop): bit-equal to the
    plain versions, one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(12)
    cases = []
    for offsets in LAB_OFFSETS:
        for kname in INV_WRAPPERS:
            args = lab_planes(torch, kname, shape, offsets, g, cuda)
            before = kernels.launches[kname]
            got = getattr(kernels, kname)(*args)
            assert kernels.launches[kname] == before + 1
            for a, b in zip(got, getattr(kernels, kname + "_plain")(*args)):
                assert torch.equal(a, b), (kname, offsets)
            cases.append((getattr(kernels, kname), args))
    names = cuda_kernel_names(
        torch, lambda: [fn(*args) for fn, args in cases], expect=len(cases))
    assert len(names) == len(cases)
    assert all("lab_inverse_kernel" in n for n in names)


@pytest.mark.parametrize("shape", CLAHE_SHAPES)
def test_clahe_apply_sweep_equals_plain(cuda, shape):
    """K2 for clip limits 1.5 and 4.0 and tilings 8x8 and 4x6, on planes at
    offsets 0 and 1 into their buffers with values past both ends of
    [0, 255], and with LUTs outside 0..255: bit-equal to the plain version,
    one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(13)
    cases = clahe_cases(torch, histeq, shape, g, cuda)
    for args in cases:
        before = kernels.launches["clahe_apply"]
        got = kernels.clahe_apply(*args)
        assert kernels.launches["clahe_apply"] == before + 1
        assert torch.equal(got, kernels.clahe_apply_plain(*args)), args[4:]
    names = cuda_kernel_names(
        torch, lambda: [kernels.clahe_apply(*args) for args in cases],
        expect=len(cases))
    assert len(names) == len(cases)
    assert all("clahe_apply_kernel" in n for n in names)


@pytest.mark.parametrize("kname", INV_WRAPPERS + ("clahe_apply",))
def test_inverse_and_clahe_repeats_equal_plain(cuda, kname):
    """Each inverse-LAB kernel and CLAHE apply, called again and again on
    4096x4096 planes (each stage of a block's ring is refilled many
    times), gives its plain version's bits every time."""
    g = torch.Generator(device=cuda).manual_seed(14)
    if kname == "clahe_apply":
        args = clahe_cases(torch, histeq, (4096, 4096), g, cuda)[0]
    else:
        args = lab_planes(torch, kname, (4096, 4096), (0, 0, 0), g, cuda)
    want = getattr(kernels, kname + "_plain")(*args)
    want = (want,) if isinstance(want, torch.Tensor) else want
    for _ in range(12):
        got = getattr(kernels, kname)(*args)
        got = (got,) if isinstance(got, torch.Tensor) else got
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("shape,tiles", [((1080, 1920), (8, 8)),
                                         ((1079, 1917), (4, 6)),
                                         ((2, 7), (8, 8))])
def test_clahe_apply_info_matches_plan(cuda, shape, tiles):
    """The strips csrc/clahe_apply.cu launches are clahe_strip_rows' for
    its resident blocks, and its grid is clahe_apply_plan's."""
    from underwater_image_enhancement_tpu_torch.utils import cuda_build

    geo = histeq._geometry(*shape, *tiles)
    regs, local, per_sm, gx, gy, rows, threads = (
        cuda_build.extension().clahe_apply_info(geo.th, *tiles))
    resident = per_sm * torch.cuda.get_device_properties(
        0).multi_processor_count
    assert local == 0 and threads == 256
    assert rows == kernels.clahe_strip_rows(geo.th, *tiles, resident)
    plan = kernels.clahe_apply_plan(*shape, *geo, rows)
    assert len(plan) == gx * gy == (tiles[0] + 1) * (tiles[1] + 1) * gy


def test_ancuti_fusion_on_card_matches_cpu(cuda):
    """Fusion of a 1079x1917 frame (odd sizes, 5 levels) on the card
    against the port's CPU path: K1, K2 and K3 launched, the gray-world
    planes and the CLAHE leg bit-equal, the output within 1e-5 and 50 dB;
    a batch of two equal to the single calls."""
    from underwater_image_enhancement_tpu_torch.pipeline import fusion

    img = torch.from_numpy(np.ascontiguousarray(
        synthetic_frame(3)[:1079, :1917]))
    kernels.reset_launches()
    got = fusion.ancuti_fusion(img.to(cuda))
    assert (kernels.launches["lab_forward_unit"],
            kernels.launches["clahe_apply"],
            kernels.launches["lab_inverse_unit"]) == (1, 1, 1)
    want = fusion.ancuti_fusion(img)
    d = (got.cpu().double() - want.double()).abs()
    mse = float((d ** 2).mean())
    assert float(d.max()) <= 1e-5 and (mse == 0 or 10 * np.log10(1 / mse) >= 50)
    planes = tuple(img[..., c].contiguous() for c in range(3))
    wb_c = fusion.gray_world_wb_planes(planes)
    wb_g = fusion.gray_world_wb_planes(tuple(p.to(cuda) for p in planes))
    for a, b in zip(wb_g, wb_c):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(histeq.clahe_enhancement_planes(wb_g, 2.0),
                    histeq.clahe_enhancement_planes(wb_c, 2.0)):
        assert torch.equal(a.cpu(), b)
    batch = torch.stack([img, img.flip(0)]).to(cuda)
    both = fusion.ancuti_fusion(batch)
    assert torch.equal(both[0], got)
    assert torch.equal(both[1], fusion.ancuti_fusion(batch[1]))


def test_clahe_u8_batch_on_card_equals_per_image(cuda):
    """clahe_u8_batch with per-image limits: K2 once an image, each image
    equal to clahe_u8 of it and to the CPU path."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randint(0, 256, (3, 1079, 1917), generator=g, device=cuda,
                      dtype=torch.int32)
    clips = (3.0, 2.0, 4.0)
    before = kernels.launches["clahe_apply"]
    got = histeq.clahe_u8_batch(x, clips)
    assert kernels.launches["clahe_apply"] == before + 3
    assert torch.equal(got.cpu(), histeq.clahe_u8_batch(x.cpu(), clips))
    for i, clip in enumerate(clips):
        assert torch.equal(got[i], histeq.clahe_u8(x[i], clip))


def test_predictor_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The full-width VGG predictor (hidden 256, input 224) on a 1080p
    frame under PyTorch's default of TF32 cuDNN convs: one K1b and one K7
    launch a frame (the features), the parameters within
    PREDICTOR_PARAM_MAX_ABS of the CPU path (the predictor's own guard
    keeps its convs in full f32, and leaves cuDNN's setting as it found
    it), the frame within PREDICTOR_FRAME_MAX_ABS under equal parameters.
    The control: with the guard taken away, TF32 convs move the parameters
    past the gate."""
    import contextlib

    from underwater_image_enhancement_tpu_torch.models import (
        bridge,
        layers,
        vgg,
    )
    from underwater_image_enhancement_tpu_torch.models.predictor import (
        EnhancementPredictor,
    )

    npz = str(tmp_path / "p.npz")
    bridge.save_npz(npz, predictor_tree(bridge, vgg, seed=1))
    img = synthetic_frame(4)
    gpu = EnhancementPredictor(npz, pretrained_vgg=None, device=cuda)
    cpu = EnhancementPredictor(npz, pretrained_vgg=None, device="cpu")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    kernels.reset_launches()
    p_g = gpu.predict_parameters(img)
    assert torch.backends.cudnn.allow_tf32
    assert kernels.launches["lab_forward_u8"] == 1
    assert kernels.launches["hysteresis_propagate"] == 1
    assert sum(kernels.launches.values()) == 2
    p_c = cpu.predict_parameters(img)
    assert all(abs(p_g[k] - p_c[k]) <= PREDICTOR_PARAM_MAX_ABS for k in p_c)
    d = np.abs(gpu.enhance_image(img, p_c).astype(np.float64)
               - cpu.enhance_image(img, p_c))
    assert float(d.max()) <= PREDICTOR_FRAME_MAX_ABS
    monkeypatch.setattr(layers, "no_tf32", contextlib.nullcontext)
    p_t = gpu.predict_parameters(img)
    assert max(abs(p_t[k] - p_c[k]) for k in p_c) > PREDICTOR_PARAM_MAX_ABS


def test_mlp_classifier_on_card_matches_cpu(cuda):
    """The selector's MLP fitted on the card and on the CPU from equal
    parameters: one step within 1e-6, 200 steps within MLP_PROBA_MAX_ABS
    in predict_proba; the control, 200 steps in TF32 matmuls, lands past
    that gate."""
    from underwater_image_enhancement_tpu_torch.select.mlp_classifier import (
        FlaxMLPClassifier,
    )

    rng = np.random.default_rng(2)
    y = rng.integers(0, 5, 500)
    X = (rng.normal(0, 1, (5, 79))[y] + rng.normal(0, 1.5, (500, 79))
         ).astype(np.float32)
    for epochs, tol in ((1, 1e-6), (200, MLP_PROBA_MAX_ABS)):
        a = FlaxMLPClassifier(epochs=epochs, device=cuda).fit(X, y)
        b = FlaxMLPClassifier(epochs=epochs, device="cpu").fit(X, y)
        assert np.abs(a.predict_proba(X) - b.predict_proba(X)).max() <= tol
    with tf32(torch, matmul=True):
        a = FlaxMLPClassifier(device=cuda).fit(X, y)
    d = np.abs(a.predict_proba(X) - b.predict_proba(X)).max()
    assert d > MLP_PROBA_MAX_ABS


@pytest.mark.parametrize("label,arch,variant", ZOO_NETS)
def test_zoo_predictor_on_card_matches_cpu(cuda, tmp_path, monkeypatch,
                                           label, arch, variant):
    """Each zoo net at full width (224^2) on a 1080p frame under both of
    PyTorch's TF32 flags: the heads within ZOO_PARAM_MAX_REL of their
    range of the CPU path's (the nets' guard keeps them in full f32 and
    leaves the flags as it found them); the control, the guard taken away,
    lands past the gate."""
    import contextlib

    from underwater_image_enhancement_tpu_torch.models import bridge, layers
    from underwater_image_enhancement_tpu_torch.models.predictor import (
        ZooPredictor,
    )

    img = synthetic_frame(5)
    cpu = ZooPredictor(model_type=arch, variant=variant, device="cpu")
    bridge.load_flax(cpu.model, seeded_tree(bridge, cpu.model, seed=2))
    calibrate_batch_norm(torch, cpu.model, torch.stack(
        [cpu._preprocess(torch.from_numpy(f.copy()))
         for f in (img, img[::-1], img[:, ::-1], synthetic_frame(6))]))
    npz = str(tmp_path / f"{label}.npz")
    bridge.save_npz(npz, bridge.to_flax(cpu.model))
    gpu = ZooPredictor(npz, model_type=arch, variant=variant, device=cuda)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    kernels.reset_launches()
    p_g = gpu.predict_parameters(img)
    assert sum(kernels.launches.values()) == 0
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    p_c = cpu.predict_parameters(img)
    assert head_rel(p_g, p_c) <= ZOO_PARAM_MAX_REL
    monkeypatch.setattr(layers, "no_tf32", contextlib.nullcontext)
    assert head_rel(gpu.predict_parameters(img), p_c) > ZOO_PARAM_MAX_REL


def test_waternet_on_card_matches_cpu(cuda, monkeypatch):
    """The full-width WaterNet (128, 32) on two 270x480 crops under
    PyTorch's TF32 flags: the batch within WATERNET_BATCH_MAX_ABS of its
    frames, frame 0 and the UNet (on 266x478, padded) within
    WATERNET_MAX_ABS of the CPU path, bf16 within WATERNET_BF16_MAX_ABS
    of f32; the control, the guard taken away, lands past the gate."""
    import contextlib

    from underwater_image_enhancement_tpu_torch.models import bridge, layers
    from underwater_image_enhancement_tpu_torch.models import waternet as wn

    frames = np.stack([synthetic_frame(s)[:270, :480] for s in (7, 8)])
    tree = seeded_tree(bridge, wn.WaterNet(), seed=3)
    cpu = bridge.load_flax(wn.WaterNet(), tree).eval()
    gpu = bridge.load_flax(wn.WaterNet(), tree).eval().to(cuda)
    un_tree = seeded_tree(bridge, wn.UNetEnhancer(), seed=4)
    un_cpu = bridge.load_flax(wn.UNetEnhancer(), un_tree).eval()
    un_gpu = bridge.load_flax(wn.UNetEnhancer(), un_tree).eval().to(cuda)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x = torch.from_numpy(frames).to(cuda)
    kernels.reset_launches()
    out = wn.waternet_enhance(gpu, x)
    assert sum(kernels.launches.values()) == 0
    assert float((out[1] - wn.waternet_enhance(gpu, x[1])).abs().max()) \
        <= WATERNET_BATCH_MAX_ABS
    want = wn.waternet_enhance(cpu, frames[0])
    assert float((out[0].cpu() - want).abs().max()) <= WATERNET_MAX_ABS
    bf16 = wn.WaterNet(dtype=torch.bfloat16).to(cuda)
    d = float((wn.waternet_enhance(gpu, x, bf16) - out).abs().max())
    assert 0 < d <= WATERNET_BF16_MAX_ABS
    crop = frames[0][:266, :478]
    un_want = wn.unet_enhance(un_cpu, crop)
    assert float((wn.unet_enhance(un_gpu, crop).cpu() - un_want).abs().max()) \
        <= WATERNET_MAX_ABS
    monkeypatch.setattr(layers, "no_tf32", contextlib.nullcontext)
    assert float((wn.waternet_enhance(gpu, x[0]).cpu() - want).abs().max()) \
        > WATERNET_MAX_ABS


def _small_trainer(label, device):
    """The trainers at test size: the MLP at hidden 32 with one block,
    the VGG predictor at hidden 16 (f32), ResNet18, all at 32^2 inputs."""
    import warnings

    from underwater_image_enhancement_tpu_torch.train import trainer as tr

    if label == "mlp":
        return tr.MLPTrainer(hidden_dim=32, num_blocks=1, device=device)
    if label == "vgg":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return tr.VGGTrainer(hidden_dim=16, image_size=32,
                                 compute_dtype="float32",
                                 pretrained_vgg=None, device=device)
    return tr.ZooTrainer("resnet", image_size=32, pretrained=None,
                         device=device)


def _train_batch(seed=5):
    rng = np.random.default_rng(seed)
    imgs = np.floor(rng.random((4, 32, 32, 3)) * 200 + 20) / 255.0
    refs = np.floor(np.clip(imgs ** 0.7, 0, 1) * 255.0) / 255.0
    return (torch.from_numpy(imgs.astype(np.float32)),
            torch.from_numpy(refs.astype(np.float32)))


def _eval_grads(trainer, label, imgs, refs, feats):
    from underwater_image_enhancement_tpu_torch.models import layers

    with layers.no_tf32():
        trainer.model.eval()
        kw = {} if label == "resnet" else {"feats": feats}
        loss = trainer._loss_fn(None, imgs, refs, False, **kw)
        grads = torch.autograd.grad(loss, trainer.trainable,
                                    allow_unused=True)
    return float(loss.detach()), [np.zeros(0) if g is None else
                                  g.double().cpu().numpy() for g in grads]


# the gates at these sizes, between the f32 reading and the TF32 control
# (my chip call 3 of PR 13, "NVIDIA H100 80GB HBM3, 700.00 W"): MLP
# 1.9e-7 / 2.3e-3, VGG 5.2e-6 / 1.1e-4, ResNet18 8.0e-7 / 2.2e-2
TRAIN_GRAD_SMALL_MAX_REL = {"mlp": 1e-5, "vgg": 2e-5, "resnet": 1e-4}


@pytest.mark.parametrize("label", ["mlp", "vgg", "resnet"])
def test_trainer_eval_gradient_on_card_matches_cpu(cuda, monkeypatch, label):
    """The eval-mode loss and its gradient from equal parameters and
    batch: the card within the trainer's TRAIN_GRAD_SMALL_MAX_REL of the
    largest CPU gradient and TRAIN_LOSS_MAX_REL of its loss under both
    TF32 flags on (the trainers' guard keeps f32); the control, the guard
    taken away, lands past the gate."""
    import contextlib

    from underwater_image_enhancement_tpu_torch.features.basic import (
        extract_basic_batch,
    )
    from underwater_image_enhancement_tpu_torch.features.full import (
        extract_batch,
    )
    from underwater_image_enhancement_tpu_torch.models import layers

    imgs, refs = _train_batch()
    feats = (extract_batch(imgs) if label == "mlp" else
             extract_basic_batch(imgs) if label == "vgg" else None)
    cpu, gpu = _small_trainer(label, "cpu"), _small_trainer(label, cuda)
    on = [t.to(cuda) if t is not None else None for t in (imgs, refs, feats)]
    l_c, g_c = _eval_grads(cpu, label, imgs, refs, feats)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    l_g, g_g = _eval_grads(gpu, label, *on)
    monkeypatch.setattr(layers, "no_tf32", contextlib.nullcontext)
    _, g_t = _eval_grads(gpu, label, *on)
    gate = TRAIN_GRAD_SMALL_MAX_REL[label]
    print(f"{label}: loss rel {abs(l_g / l_c - 1):.3g}, grad rel "
          f"{grad_rel(g_g, g_c):.3g}, TF32 {grad_rel(g_t, g_c):.3g}, "
          f"gate {gate}")
    assert abs(l_g / l_c - 1) <= TRAIN_LOSS_MAX_REL
    assert grad_rel(g_g, g_c) <= gate < grad_rel(g_t, g_c)


@pytest.mark.parametrize("label", ["mlp", "vgg", "resnet"])
def test_train_steps_on_card(cuda, monkeypatch, label):
    """Ten steps on one batch on the card: finite losses, the batch's
    training loss without dropout falls, the VGG's frozen convs stay bit
    for bit, BatchNorm's running statistics move, and no kernel of the
    package launches."""
    from underwater_image_enhancement_tpu_torch.models import bridge, layers

    imgs, refs = (t.to(cuda) for t in _train_batch(6))
    t = _small_trainer(label, cuda)
    idx = None
    if label == "mlp":
        t._feature_cache = t._features(imgs)
        idx = np.arange(4)

    def batch_loss():
        with monkeypatch.context() as m:
            m.setattr(layers, "dropout", lambda x, *a, **k: x)
            with torch.no_grad(), layers.no_tf32():
                t.model.train()
                return float(t._loss_fn(idx, imgs, refs, True))

    first = batch_loss()
    before = {k: v.copy() for k, v in
              bridge.flatten(bridge.to_flax(t.model)).items()}
    kernels.reset_launches()
    losses = [float(t._step(idx, imgs, refs)) for _ in range(10)]
    assert sum(kernels.launches.values()) == 0
    after = bridge.flatten(bridge.to_flax(t.model))
    assert np.isfinite(losses).all() and batch_loss() < first
    if label == "vgg":
        assert all(np.array_equal(after[k], before[k]) for k in before
                   if k.startswith("params/vgg/conv")
                   and int(k.split("/")[2][4:]) < 8)
    stats = [k for k in before if k.startswith("batch_stats/")]
    assert not stats or any(not np.array_equal(after[k], before[k])
                            for k in stats)


@pytest.mark.parametrize("cmd", ["enhance", "auto", "build-dataset", "run"])
def test_cli_devices_above_card_count_raises(cuda, tmp_path, cmd):
    from underwater_image_enhancement_tpu_torch import cli

    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit, match=f"--devices {n}: {n} CUDA devices "
                       f"asked, {n - 1} visible"):
        cli.main([cmd, "--input", str(tmp_path), "--output",
                  str(tmp_path / "out"), "--devices", str(n)])


def test_dp_on_card_equals_single_call(cuda):
    """Two and three mesh positions on one card against the single call:
    label_batch_dp (the winner; features within 1e-4 relative or 1e-5;
    the winning frames bit-equal where the winner agrees) and
    enhance_batch_dp within 1e-6; the differing values printed."""
    from underwater_image_enhancement_tpu_torch.parallel.mesh import Mesh
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        enhance_batch,
        enhance_batch_dp,
    )
    from underwater_image_enhancement_tpu_torch.select.system import (
        label_batch,
        label_batch_dp,
    )
    from underwater_image_enhancement_tpu_torch.utils.config import (
        DEFAULT_QUALITY_WEIGHTS as W,
    )

    imgs = torch.from_numpy(np.stack(
        [synthetic_frame(s, 90, 120) for s in range(6)])).to(cuda)
    f1, s1, b1, w1 = label_batch(imgs, W)
    e1 = enhance_batch(imgs, 10.0, 90.0, 0.6, 1.2, device=cuda)
    for n in (2, 3):
        m = Mesh((cuda,) * n)
        f, s, b, w = label_batch_dp(imgs, W, m)
        e = enhance_batch_dp(imgs, 10.0, 90.0, 0.6, 1.2, m)
        print(f"{n} positions: features {int((f != f1).sum())}, scores "
              f"{int((s != s1).sum())}, winners {int((w != w1).sum())}, "
              f"enhance {int((e != e1).sum())} values differ")
        err = (f.double() - f1.double()).abs()
        assert bool(((err <= 1e-4 * f1.double().abs()) | (err <= 1e-5)).all())
        for j in range(6):
            top = torch.sort(s1[j], descending=True).values
            if float(top[0] - top[1]) >= 1e-2:
                assert int(b[j]) == int(b1[j])
            if int(b[j]) == int(b1[j]):
                assert torch.equal(w[j], w1[j])
        assert float((e - e1).abs().max()) <= 1e-6


def test_six_spatial_on_card_matches_cpu(cuda):
    """six_strategy_spatial of a 120x160 frame over two mesh positions of
    the card against two CPU positions: the cast code, and the airlight A
    and its box of each run (``airlight_recorded``), equal; so all six
    strategies within 1e-5 (chip_smoke's ``[spatial]`` gate); and the
    card's two positions against one bit-equal."""
    from chip_smoke import SPATIAL_EXACT_MAX_ABS, airlight_recorded
    from underwater_image_enhancement_tpu_torch.parallel import (
        six_spatial as tss,
    )
    from underwater_image_enhancement_tpu_torch.parallel.mesh import Mesh

    img = synthetic_frame(5, 120, 160)

    def six(mesh):
        with airlight_recorded(tss) as air:
            outs, code = tss.six_strategy_spatial(img, mesh)
        assert len(air) == 1
        return outs, int(code), air[0]["A"], air[0]["box"]

    g, g_code, gA, gbox = six(Mesh((cuda,) * 2))
    c, c_code, cA, cbox = six(Mesh((torch.device("cpu"),) * 2))
    one, _, _, _ = six(Mesh((cuda,)))
    assert g_code == c_code and gbox == cbox and torch.equal(gA, cA)
    assert torch.equal(g, one)
    g = g.cpu()
    for k in range(6):
        d = float((g[k].double() - c[k].double()).abs().max())
        print(f"six_spatial card vs CPU {k}: max |d| {d:.3e}")
        assert d <= SPATIAL_EXACT_MAX_ABS
