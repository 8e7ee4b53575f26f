"""The ported six exact tier, end to end on the CPU, against the JAX
package's six_strategy_tuple and CLI; the package's import rules and its
device contract."""

import ast
import csv
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu.ops import airlight as jair
from underwater_image_enhancement_tpu.pipeline import cast as jcast
from underwater_image_enhancement_tpu.pipeline.enhance import (
    six_strategy_tuple as jax_six,
)
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.ops import kernels
from underwater_image_enhancement_tpu_torch.ops.airlight import (
    quadtree_airlight_exact_planes,
)
from underwater_image_enhancement_tpu_torch.ops.layout import split_planes
from underwater_image_enhancement_tpu_torch.pipeline import cast as tcast
from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
    SIX_ORDER,
    six_strategy_tuple,
)
from underwater_image_enhancement_tpu_torch.utils import io as tio

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def underwater_img():
    """conftest's underwater_img, drawn without the session rng
    (tests/torch_frames.py)."""
    return torch_frames.underwater_img()


PACKAGE = Path(__file__).resolve().parents[1] / "underwater_image_enhancement_tpu_torch"


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


def _seeded_frame():
    rng = np.random.default_rng(2024)
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([0.1 + 0.2 * (xx / w),
                     0.6 + 0.15 * np.sin(yy / 11.0),
                     0.4 + 0.2 * np.cos((xx - yy) / 23.0)], -1)
    img = np.clip(base + rng.normal(0, 0.04, (h, w, 3)), 0, 1)
    return (np.floor(img.astype(np.float32) * 255) / 255).astype(np.float32)


@pytest.fixture(scope="module")
def frames(underwater_img):
    out = {}
    for name, img in (("underwater_img", underwater_img),
                      ("seeded", _seeded_frame())):
        outs, code = jax_six(jnp.asarray(img), fast=False)
        out[name] = (img, [np.asarray(o) for o in outs], int(code))
    return out


@pytest.mark.parametrize("which", ["underwater_img", "seeded"])
def test_six_matches_jax(frames, which):
    img, want, want_code = frames[which]
    kernels.reset_launches()
    outs, code = six_strategy_tuple(img, device="cpu")
    assert sum(kernels.launches.values()) == 0  # CPU: plain versions only
    assert int(code) == want_code
    diffs = {}
    for k, name in enumerate(SIX_ORDER):
        got = outs[k].numpy()
        assert got.shape == img.shape and got.dtype == np.float32
        d = float(np.abs(got.astype(np.float64) - want[k]).max())
        diffs[name] = d
        if k >= 3:
            assert d <= 1e-6, (name, d)
        else:
            assert _psnr(got, want[k]) >= 50.0, (name, _psnr(got, want[k]))
    print(which, "max |port - JAX| per strategy:", diffs)


@pytest.mark.parametrize("which", ["underwater_img", "seeded"])
def test_six_shared_airlight_equal(frames, which):
    img = frames[which][0]
    corr = np.asarray(jcast.detect_and_correct(jnp.asarray(img))[0])
    want = np.asarray(jair.quadtree_airlight_exact_planes(
        tuple(jnp.asarray(np.ascontiguousarray(corr[..., c]))
              for c in range(3))))
    got_corr, _ = tcast.detect_and_correct(torch.from_numpy(img))
    A = quadtree_airlight_exact_planes(split_planes(got_corr))
    np.testing.assert_array_equal(A.numpy(), want)


def _write_folder(folder, img):
    folder.mkdir()
    tio.imwrite_unit(str(folder / "p0.png"), img)
    tio.imwrite_unit(str(folder / "p1.png"), img[::-1].copy())


def test_cli_six_cpu_matches_jax_cli(tmp_path, frames):
    from underwater_image_enhancement_tpu.cli import main as jax_main

    src = tmp_path / "in"
    _write_folder(src, frames["underwater_img"][0])
    tcli.main(["six", "--input", str(src), "--output",
               str(tmp_path / "torch"), "--device", "cpu"])
    jax_main(["six", "--input", str(src), "--output", str(tmp_path / "jax")])
    logs = {}
    for side in ("torch", "jax"):
        out = tmp_path / side
        pngs = sorted(p.name for p in out.glob("*.png"))
        assert pngs == sorted(f"p{i}_{n}.png" for i in range(2)
                              for n in SIX_ORDER)
        with open(out / "processing_log.csv", newline="") as f:
            reader = csv.DictReader(f)
            logs[side] = (reader.fieldnames, list(reader))
    assert logs["torch"][0] == logs["jax"][0]
    assert len(logs["torch"][1]) == len(logs["jax"][1]) == 12
    for rt, rj in zip(logs["torch"][1], logs["jax"][1]):
        for key in ("filename", "image_type", "strategy", "status"):
            assert rt[key] == rj[key]
        assert Path(rt["output_path"]).name == Path(rj["output_path"]).name
        assert rt["processing_time"].endswith("s")
    # the PNGs themselves, under the float tolerances: float ulps can cross
    # a truncation boundary (<= 1 level), and in the dehaze recipes a
    # crossing before the CLAHE leg's u8 quantize moves a pixel further
    for name in sorted(p.name for p in (tmp_path / "jax").glob("*.png")):
        a = tio.imread_u8(str(tmp_path / "torch" / name)) / 255.0
        b = tio.imread_u8(str(tmp_path / "jax" / name)) / 255.0
        if "dehazing" in name:
            assert _psnr(a, b) >= 50.0, name
        else:
            assert np.abs(a - b).max() <= 1 / 255 + 1e-9, name


def test_cli_six_rejects_fast(tmp_path):
    with pytest.raises(SystemExit, match="not yet ported"):
        tcli.main(["six", "--input", str(tmp_path), "--output",
                   str(tmp_path / "o"), "--device", "cpu", "--fast"])
    assert not (tmp_path / "o").exists()


def test_cli_six_batches_and_skips_unreadable(tmp_path, frames):
    src = tmp_path / "in"
    _write_folder(src, frames["seeded"][0][:48, :64].copy())
    (src / "broken.png").write_bytes(b"not a png")
    out = tmp_path / "o"
    tcli.main(["six", "--input", str(src), "--output", str(out),
               "--device", "cpu", "--batch-size", "2"])
    with open(out / "processing_log.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["filename"] for r in rows] == ["p0.png"] * 6 + ["p1.png"] * 6
    assert all(r["status"] == "success" for r in rows)


@pytest.mark.parametrize("error", [ValueError, RuntimeError,
                                   torch.AcceleratorError])
def test_cli_six_failed_frame_row_or_device_fault(tmp_path, frames,
                                                  monkeypatch, error):
    """A frame that fails becomes 'failed' rows; a RuntimeError (a failed
    build or kernel launch, a sticky CUDA error) ends the run."""
    from underwater_image_enhancement_tpu_torch.pipeline import enhance

    def broken(img, device):
        raise error("broken frame")

    monkeypatch.setattr(enhance, "six_strategy_tuple", broken)
    src, out = tmp_path / "in", tmp_path / "o"
    _write_folder(src, frames["seeded"][0][:16, :16].copy())
    argv = ["six", "--input", str(src), "--output", str(out), "--device", "cpu"]
    if issubclass(error, RuntimeError):
        with pytest.raises(error):
            tcli.main(argv)
        return
    tcli.main(argv)
    with open(out / "processing_log.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 12 and all(r["status"] == "failed" for r in rows)


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        six_strategy_tuple(img)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["six", "--input", ".", "--output", "unused"])


def test_port_runs_without_jax_in_subprocess(tmp_path):
    code = (
        "import sys, numpy as np\n"
        "import underwater_image_enhancement_tpu_torch\n"
        "from underwater_image_enhancement_tpu_torch.pipeline.enhance "
        "import six_strategy_tuple\n"
        "from underwater_image_enhancement_tpu_torch import cli\n"
        "rng = np.random.default_rng(0)\n"
        "img = rng.random((40, 48, 3)).astype(np.float32)\n"
        "outs, code = six_strategy_tuple(img, device='cpu')\n"
        "assert len(outs) == 6\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'underwater_image_enhancement_tpu'"
        " or m.startswith('underwater_image_enhancement_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = PACKAGE.parent
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "2",
                              **{k: os.environ[k] for k in ("HOME", "TMPDIR")
                                 if k in os.environ}},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_source_imports_neither_jax_nor_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py")) + [PACKAGE.parent / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
            # the port's own name starts with the JAX package's
            assert top != "underwater_image_enhancement_tpu", (path, mod)


def test_six_strategy_single_stacks_the_tuple():
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        six_strategy_single,
    )

    img = _seeded_frame()[:40, :48].copy()
    stack, code = six_strategy_single(img, device="cpu")
    outs, code_t = six_strategy_tuple(img, device="cpu")
    assert stack.shape == (6, 40, 48, 3) and int(code) == int(code_t)
    assert torch.equal(stack, torch.stack(outs))
