"""UIQM and UCIQE (``metrics/uiqm``) and ``cli assess`` on the CPU against
the JAX package's jitted metrics and its ``assess`` command.  Each term is
compared on its own (within 1e-4 relative), so that a miss names it: the
sums are taken in other orders, the rest is the same f32 arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.metrics import uiqm as juiqm
from underwater_image_enhancement_tpu.ops import colorspace as jcs
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.metrics import uiqm as tuiqm
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.utils import io as tio

from tests import torch_frames

torch.set_num_threads(2)

REL = 1e-4


def _seeded_frame():
    """A 96x128 frame of smooth colour fields and noise on the u8 grid."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    base = np.stack([0.3 + 0.25 * np.sin(xx / 9.0), 0.5 + 0.2 * np.cos(yy / 7.0),
                     0.4 + 0.3 * np.sin((xx - yy) / 13.0)], -1)
    img = np.clip(base + rng.normal(0, 0.08, base.shape), 0, 1)
    return (np.floor(img * 255) / 255).astype(np.float32)


FRAMES = {"fixture": torch_frames.underwater_img, "seeded": _seeded_frame}


@jax.jit
def _jax_uciqe_terms(img):
    """juiqm.uciqe's three terms, in its own arithmetic."""
    u8 = jcs.quantize_u8(img)
    lab = jcs.rgb_to_lab_u8_exact(u8).astype(jnp.float32)
    L = lab[..., 0] * (100.0 / 255.0)
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    sigma_c = jnp.std(jnp.sqrt(a * a + b * b)) / 100.0
    con_l = (jnp.percentile(L, 99.0) - jnp.percentile(L, 1.0)) / 100.0
    mu_s = jnp.mean(jcs.rgb_to_hsv_u8(u8)[..., 1].astype(jnp.float32) / 255.0)
    return sigma_c, con_l, mu_s


@pytest.fixture(scope="module")
def jax_scores():
    out = {}
    for name, make in FRAMES.items():
        x = jnp.asarray(make())
        terms = {t: float(jax.jit(getattr(juiqm, t))(x))
                 for t in ("uicm", "uism", "uiconm")}
        terms.update(zip(("sigma_c", "con_l", "mu_s"),
                         (float(v) for v in _jax_uciqe_terms(x))))
        terms["uiqm"] = float(juiqm.uiqm(x))
        terms["uciqe"] = float(juiqm.uciqe(x))
        out[name] = terms
    return out


def _close(got, want):
    assert abs(got - want) <= REL * abs(want), (got, want)


@pytest.mark.parametrize("term", ["uicm", "uism", "uiconm"])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_uiqm_terms_match_jax(jax_scores, frame, term):
    got = float(getattr(tuiqm, term)(torch.from_numpy(FRAMES[frame]())))
    _close(got, jax_scores[frame][term])


@pytest.mark.parametrize("frame", list(FRAMES))
def test_uciqe_terms_match_jax(jax_scores, frame):
    terms = tuiqm.uciqe_terms(torch.from_numpy(FRAMES[frame]()))
    for name, got in zip(("sigma_c", "con_l", "mu_s"), terms):
        _close(float(got), jax_scores[frame][name])


@pytest.mark.parametrize("metric", ["uiqm", "uciqe"])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_metric_matches_jax(jax_scores, frame, metric):
    before = dict(kernels.launches)
    got = getattr(tuiqm, metric)(torch.from_numpy(FRAMES[frame]()))
    assert kernels.launches == before  # CPU: the plain versions
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(float(got), jax_scores[frame][metric])


def test_jax_uciqe_terms_compose_to_its_uciqe(jax_scores):
    """The test's replica of the JAX terms is the JAX metric's."""
    t = jax_scores["fixture"]
    k1, k2, k3 = juiqm.UCIQE_C
    _close(k1 * t["sigma_c"] + k2 * t["con_l"] + k3 * t["mu_s"], t["uciqe"])


def test_batches_match_single_frames():
    imgs = torch.from_numpy(np.stack([_seeded_frame(),
                                      _seeded_frame()[::-1].copy()]))
    for batch, single in ((tuiqm.uiqm_batch, tuiqm.uiqm),
                          (tuiqm.uciqe_batch, tuiqm.uciqe)):
        got = batch(imgs)
        assert got.shape == (2,)
        for i in range(2):
            assert torch.equal(got[i], single(imgs[i]))
    want = np.asarray(juiqm.uciqe_batch(jnp.asarray(imgs.numpy())))
    np.testing.assert_allclose(tuiqm.uciqe_batch(imgs).numpy(), want, rtol=REL)


def _table(text):
    lines = [ln for ln in text.splitlines() if ln.strip()]
    head = lines[0].split()
    rows = {ln.split()[0]: [float(v) for v in ln.split()[1:]]
            for ln in lines[1:]}
    return head, rows


def test_cli_assess_matches_jax_cli(tmp_path, capsys):
    """Same header, files and columns; the numbers within one unit of the
    last printed digit (0.01, UIQM and UCIQE 0.001)."""
    from underwater_image_enhancement_tpu.cli import main as jax_main

    src = tmp_path / "in"
    src.mkdir()
    for name, make in FRAMES.items():
        tio.imwrite_unit(str(src / f"{name}.png"), make())
    tcli.main(["assess", "--input", str(src), "--device", "cpu"])
    head_t, rows_t = _table(capsys.readouterr().out)
    jax_main(["assess", "--input", str(src)])
    head_j, rows_j = _table(capsys.readouterr().out)
    assert head_t == head_j and len(head_t) == 12
    assert sorted(rows_t) == sorted(rows_j) == ["fixture.png", "seeded.png"]
    for f in rows_j:
        tol = np.array([0.01, 0.001, 0.001] + [0.01] * 8) + 1e-9
        assert np.all(np.abs(np.array(rows_t[f]) - rows_j[f]) <= tol), f


def test_cli_assess_one_file(tmp_path, capsys):
    path = tmp_path / "one.png"
    tio.imwrite_unit(str(path), _seeded_frame())
    tcli.main(["assess", "--input", str(path), "--device", "cpu"])
    head, rows = _table(capsys.readouterr().out)
    assert list(rows) == ["one.png"] and len(rows["one.png"]) == 11
    u = float(tuiqm.uiqm(torch.from_numpy(tio.imread_unit(str(path)))))
    assert abs(rows["one.png"][1] - u) <= 5e-4
