"""Kernel tests that need an NVIDIA GPU (marker ``gpu``): each CUDA
kernel against its plain PyTorch version on the card, and the six exact
tier on the card against the CPU path.  They skip where
``torch.cuda.is_available()`` is False.  On a GPU machine without JAX:

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu_torch.ops import histeq, kernels
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


def test_six_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([0.15 + 0.1 * np.sin(xx / 17.0), 0.45 + 0.2 * np.cos(yy / 23.0),
                     0.55 + 0.15 * np.sin((xx + yy) / 31.0)], -1)
    img = np.clip(base + rng.normal(0, 0.03, (h, w, 3)), 0, 1).astype(np.float32)
    img = (np.floor(img * 255) / 255).astype(np.float32)
    kernels.reset_launches()
    on_card, code_g = six_strategy_tuple(img)  # the default device: cuda
    assert dict(kernels.launches) == {
        "lab_forward_unit": 5, "clahe_apply": 5, "lab_inverse_unit": 2,
        "lab_inverse_unit_gamma": 3}
    on_cpu, code_c = six_strategy_tuple(img, device="cpu")
    assert int(code_g) == int(code_c)
    for k, (a, b) in enumerate(zip(on_card, on_cpu)):
        assert a.device.type == "cuda"
        d = (a.cpu().double() - b.double())
        if k >= 3:
            assert float(d.abs().max()) <= 1e-6
        else:
            mse = float((d ** 2).mean())
            assert mse == 0 or 10 * np.log10(1 / mse) >= 50
