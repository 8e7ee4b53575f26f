"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``underwater_image_enhancement_tpu_torch`` (never JAX) through the
``six`` exact tier at 1920x1080.  Phases (each prints one line; a failed
check raises and the script exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile ``csrc/`` into the package's PyTorch extension
   (``utils/cuda_build.py``) and time it;
3. kernels: each CUDA kernel bit-equal to its plain PyTorch version on the
   card: forward LAB over all 2**24 u8 RGB triples, inverse LAB (and its
   gamma variant for each recipe gamma) over all 2**24 (L, a, b) triples,
   CLAHE apply at 1080x1920 and 1079x1917 for the five clip limits;
4. slice: three seeded synthetic 1920x1080 underwater frames, written with
   the port's PNG codec, through ``cli six`` in-process on ``cuda``; 18
   outputs and the CSV log; the kernel launch counts of that run (counts
   set to 0 just before it, read just after); every kernel call of that
   run replayed on its own inputs against the plain version, bit-equal;
   frame 0 on the card against the port's CPU path (cast code, airlight
   A and final box equal; recipes 4-6 within 1e-6, 1-3 at >= 50 dB);
5. timing (CUDA events, medians after warm-up): ms per frame of
   ``six_strategy_tuple`` with its spread, each stage alone, the airlight's
   prefix sums, one ``torch.profiler`` frame (device busy and idle share),
   and each kernel on the main path's inputs beside its bound and its
   plain version.

The second-to-last line is the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it prints no
result and exits 2.
"""

from __future__ import annotations

import csv
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
H, W = 1080, 1920
CLIPS = (3.0, 2.0, 4.0, 1.5, 3.5)  # the five CLAHE legs' clip limits
GAMMAS = (1.5, 1.2, 1.4)           # recipes 1, 5 and 6
FRAME_RUNS = 12
STAGE_RUNS = 9
# wrapper -> (CUDA source, TPU kernel it replaces, int/f32 ops per pixel,
# plain version)
KERNELS = {
    "lab_forward_unit": (
        "underwater_image_enhancement_tpu_torch/csrc/lab_forward.cu",
        "underwater_image_enhancement_tpu/ops/pallas_kernels.py:906", 45,
        "lab_forward_unit_plain"),
    "clahe_apply": (
        "underwater_image_enhancement_tpu_torch/csrc/clahe_apply.cu",
        "underwater_image_enhancement_tpu/ops/pallas_kernels.py:186", 30,
        "clahe_apply_plain"),
    "lab_inverse_unit": (
        "underwater_image_enhancement_tpu_torch/csrc/lab_inverse.cu",
        "underwater_image_enhancement_tpu/ops/pallas_kernels.py:941", 60,
        "lab_inverse_unit_plain"),
    "lab_inverse_unit_gamma": (
        "underwater_image_enhancement_tpu_torch/csrc/lab_inverse.cu",
        "underwater_image_enhancement_tpu/ops/pallas_kernels.py:948", 60,
        "lab_inverse_unit_gamma_plain"),
}
EXPECTED_LAUNCHES = {"lab_forward_unit": 15, "clahe_apply": 15,
                     "lab_inverse_unit": 6, "lab_inverse_unit_gamma": 9}
F32_PEAK = 67e12  # H100 SXM f32 outside the tensor cores, ops per second


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(cond, msg) -> None:
    """A failed check ends the run (not an assert: those vanish under -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def hbm_bytes_per_s(name: str) -> float:
    """Published device-memory rate of the H100 variant the card names."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM, 80 GB HBM3


def synthetic_frame(seed: int) -> np.ndarray:
    """The test suite's underwater fixture (tests/conftest.py) at
    1920x1080: blue-green cast, haze gradients, noise, on the u8 grid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    s = 160.0 / W
    base = np.stack([
        0.15 + 0.1 * np.sin(xx * s / 17.0) + 0.05 * (yy / H),
        0.45 + 0.2 * np.cos(yy * s / 23.0) + 0.1 * (xx / W),
        0.55 + 0.15 * np.sin((xx + yy) * s / 31.0),
    ], axis=-1)
    noise = rng.normal(0, 0.03, (H, W, 3)).astype(np.float32)
    img = np.clip(base + noise, 0.0, 1.0).astype(np.float32)
    return (np.floor(img * 255.0) / 255.0).astype(np.float32)


def event_ms(torch, fn, runs: int, warmup: int = 1, flush=None) -> list:
    """Device ms of each of ``runs`` calls of fn (CUDA events around the
    call, then a synchronise), after ``warmup`` calls.  ``flush`` (a
    tensor) is zeroed before each call so that it starts with a cold L2."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def capture_calls(torch, kernels):
    """Wrap each kernel wrapper of ``kernels`` so that its arguments are
    kept (tensors cloned) while it runs as before.  The pipeline looks the
    wrappers up on the module at each call, so it goes through these.
    Returns (calls by wrapper name, a function that restores the module)."""
    calls = {name: [] for name in KERNELS}
    originals = {name: getattr(kernels, name) for name in KERNELS}

    def keep(name):
        def wrapper(*args):
            calls[name].append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args))
            return originals[name](*args)
        return wrapper

    for name in KERNELS:
        setattr(kernels, name, keep(name))

    def restore():
        for name, fn in originals.items():
            setattr(kernels, name, fn)

    return calls, restore


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from underwater_image_enhancement_tpu_torch import cli
    from underwater_image_enhancement_tpu_torch.ops import airlight
    from underwater_image_enhancement_tpu_torch.ops import histeq, kernels
    from underwater_image_enhancement_tpu_torch.ops.layout import split_planes
    from underwater_image_enhancement_tpu_torch.ops.stretch import U8_GRID
    from underwater_image_enhancement_tpu_torch.pipeline import cast as cast_mod
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        SIX_ORDER,
        six_strategy_tuple,
    )
    from underwater_image_enhancement_tpu_torch.pipeline.six import run_strategy
    from underwater_image_enhancement_tpu_torch.utils import cuda_build
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. card -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    bw = hbm_bytes_per_s(name)
    log("card", name=repr(name), torch=torch.__version__,
        cuda=torch.version.cuda, hbm_bytes_per_s=bw)

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    ext = cuda_build.extension()
    log("build", seconds=f"{time.perf_counter() - t0:.1f}",
        extension=Path(ext.__file__).name)

    # 3. kernels against their plain versions, exhaustively ---------------
    err = {k: 0.0 for k in KERNELS}
    checked = {k: 0 for k in KERNELS}

    def expect_equal(kname, got, want, what):
        for g_, w_ in zip(got, want):
            e = float((g_.double() - w_.double()).abs().max())
            err[kname] = max(err[kname], e)
            check(torch.equal(g_, w_), f"{kname} differs from its plain "
                  f"version on {what}: max |d| = {e}")
        checked[kname] += 1

    def replay(kname, args, what):
        """The kernel and its plain version on the same arguments."""
        got = getattr(kernels, kname)(*args)
        want = getattr(kernels, KERNELS[kname][3])(*args)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        expect_equal(kname, got, want, what)

    grid = torch.as_tensor(U8_GRID, device=dev)
    idx = torch.arange(1 << 24, device=dev, dtype=torch.int32).reshape(4096, 4096)
    trip = tuple(((idx >> s) & 255).contiguous() for s in (16, 8, 0))
    replay("lab_forward_unit", tuple(grid[t.long()] for t in trip),
           "all 2^24 u8 RGB triples")
    replay("lab_inverse_unit", trip, "all 2^24 (L, a, b) triples")
    expect_equal("lab_inverse_unit",
                 [torch.round(g_ * 255.0).to(torch.int32)
                  for g_ in kernels.lab_inverse_unit(*trip)],
                 kernels.lab_inverse_u8_plain(*trip),
                 "all 2^24 (L, a, b) triples, u8 values")
    for g in GAMMAS:
        replay("lab_inverse_unit_gamma", trip + (g,),
               f"all 2^24 (L, a, b) triples, gamma {g}")
    del idx, trip
    rng = torch.Generator(device=dev).manual_seed(0)
    for hh, ww in ((H, W), (1079, 1917)):
        yy = torch.arange(hh, device=dev)[:, None]
        xx = torch.arange(ww, device=dev)[None, :]
        smooth = (yy * 255 // hh + xx * 64 // ww) % 256
        noise = torch.randint(-20, 21, (hh, ww), generator=rng, device=dev)
        plane = torch.clamp(smooth + noise, 0, 255).to(torch.int32)
        for clip in CLIPS:
            luts, ya, xa, geo = histeq.clahe_prep(plane, clip, 8, 8)
            replay("clahe_apply", (plane, luts, ya, xa, *geo),
                   f"{hh}x{ww} clip {clip}")
    torch.cuda.synchronize()
    log("kernels", result="bit-equal", checks=json.dumps(checked),
        max_abs_err=json.dumps(err, separators=(",", ":")))

    # 4. the slice through the CLI ----------------------------------------
    shutil.rmtree(WORK, ignore_errors=True)
    src, out = WORK / "in", WORK / "out"
    src.mkdir(parents=True)
    frames = [synthetic_frame(seed) for seed in (0, 1, 2)]
    for i, f in enumerate(frames):
        uio.imwrite_unit(str(src / f"frame{i}.png"), f)
    calls, restore = capture_calls(torch, kernels)
    t0 = time.perf_counter()
    try:
        kernels.reset_launches()
        cli.main(["six", "--input", str(src), "--output", str(out)])
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
    finally:
        restore()
    cli_s = time.perf_counter() - t0
    pngs = sorted(p.name for p in out.glob("*.png"))
    with open(out / "processing_log.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    want = sorted(f"frame{i}_{n}.png" for i in range(3) for n in SIX_ORDER)
    check(pngs == want, f"outputs {pngs}")
    check(len(rows) == 18 and all(r["status"] == "success" for r in rows),
          f"log rows {rows}")
    for p in pngs:
        img = uio.imread_u8(str(out / p))
        check(img is not None and img.shape == (H, W, 3), f"bad PNG {p}")
    check(launches == EXPECTED_LAUNCHES, f"launches {launches}")
    check({k: len(v) for k, v in calls.items()} == EXPECTED_LAUNCHES,
          f"captured calls {[len(v) for v in calls.values()]}")
    log("slice", frames=3, outputs=len(pngs), csv_rows=len(rows),
        seconds=f"{cli_s:.2f}",
        launches=json.dumps(launches, separators=(",", ":")))

    # every kernel call of that run, replayed on its own inputs
    for kname, arglists in calls.items():
        for k, args in enumerate(arglists):
            replay(kname, args, f"main-path call {k} ({H}x{W})")
    torch.cuda.synchronize()
    log("main_path_inputs", result="bit-equal",
        calls=json.dumps({k: len(v) for k, v in calls.items()}),
        shape=f"{H}x{W}")

    # frame 0: the card against the port's CPU path
    img0 = frames[0]
    outs_gpu, code_gpu = six_strategy_tuple(img0, device="cuda")
    outs_cpu, code_cpu = six_strategy_tuple(img0, device="cpu")
    check(int(code_gpu) == int(code_cpu),
          f"cast code card {int(code_gpu)} vs CPU {int(code_cpu)}")
    corr_g, _ = cast_mod.detect_and_correct(torch.from_numpy(img0).to(dev))
    corr_c, _ = cast_mod.detect_and_correct(torch.from_numpy(img0))
    A_g, box_g = airlight.quadtree_airlight_exact_planes(
        split_planes(corr_g), return_box=True)
    A_c, box_c = airlight.quadtree_airlight_exact_planes(
        split_planes(corr_c), return_box=True)
    check(box_g == box_c and torch.equal(A_g.cpu(), A_c),
          f"airlight card {A_g.tolist()} {box_g} vs CPU {A_c.tolist()} {box_c}")
    diffs = {}
    for k, n in enumerate(SIX_ORDER):
        a = outs_gpu[k].cpu().double()
        b = outs_cpu[k].double()
        check(a.shape == (H, W, 3) and bool(torch.isfinite(a).all()),
              f"{n}: shape {tuple(a.shape)} or non-finite values")
        d = float((a - b).abs().max())
        mse = float(((a - b) ** 2).mean())
        psnr = float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)
        diffs[n] = d
        if k >= 3:
            check(d <= 1e-6, f"{n}: card vs CPU max |d| {d} > 1e-6")
        else:
            check(psnr >= 50.0, f"{n}: card vs CPU {psnr:.1f} dB < 50")
    log("card_vs_cpu", code=int(code_cpu), A=A_c.tolist(), box=box_c,
        max_abs=json.dumps(diffs))

    # 5. timing -----------------------------------------------------------
    imgs = [torch.from_numpy(f).to(dev) for f in frames]
    runs = iter(range(10 ** 6))
    frame_ms = event_ms(
        torch, lambda: six_strategy_tuple(imgs[next(runs) % 3]), FRAME_RUNS,
        warmup=3)
    q1, med, q3 = statistics.quantiles(frame_ms, n=4)
    log("frame", six_exact_ms_median=f"{med:.3f}", quartiles=f"{q1:.3f},{q3:.3f}",
        min_max=f"{min(frame_ms):.3f},{max(frame_ms):.3f}",
        runs=",".join(f"{t:.3f}" for t in frame_ms))

    img = imgs[0]
    corrected, _ = cast_mod.detect_and_correct(img)
    planes = split_planes(corrected)
    A = airlight.quadtree_airlight_exact_planes(planes)
    stage_fns = {
        "cast": lambda: cast_mod.detect_and_correct(img),
        "airlight": lambda: airlight.quadtree_airlight_exact_planes(planes),
    }
    for n in SIX_ORDER:
        stage_fns[n] = lambda n=n: run_strategy(n, corrected, A)
    stages = {k: event_ms(torch, fn, STAGE_RUNS) for k, fn in stage_fns.items()}
    log("stages", **{k: f"{statistics.median(v):.3f}" for k, v in stages.items()})
    log("stages_min", **{k: f"{min(v):.3f}" for k, v in stages.items()})

    def launches_of(fn) -> int:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in prof.events())

    stack = torch.stack([planes[0], planes[1], planes[2], planes[0] ** 2,
                         planes[1] ** 2, planes[2] ** 2])
    sats = airlight._sat_rows(stack)
    levels = len(airlight._level_plan(H, W, 1))
    prefix = {
        "sat_rows": lambda: airlight._sat_rows(stack),
        "corner_grid": lambda: airlight._corner_grid(
            sats, (0, H // 2, H), (0, W // 2, W)),
        "torch_cumsum_rows": lambda: torch.cumsum(stack, -2),
    }
    ps = {k: (statistics.median(event_ms(torch, fn, STAGE_RUNS)),
              launches_of(fn)) for k, fn in prefix.items()}
    log("prefix_sums", levels=levels,
        per_frame_ms=f"{ps['sat_rows'][0] + levels * ps['corner_grid'][0]:.3f}",
        per_frame_launches=ps["sat_rows"][1] + levels * ps["corner_grid"][1],
        **{f"{k}_ms": f"{v[0]:.3f}" for k, v in ps.items()},
        **{f"{k}_launches": v[1] for k, v in ps.items()})

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        six_strategy_tuple(img)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    ours = {}
    for e in dev_events:
        for key in ("lab_forward_unit_kernel", "clahe_apply_kernel",
                    "lab_inverse_unit_kernel<false>",
                    "lab_inverse_unit_kernel<true>"):
            if key in e.name:
                ours[key] = ours.get(key, 0) + 1
    log("profile", wall_ms=f"{wall_ms:.3f}",
        device_busy_ms=f"{busy_ms:.3f}" if dev_events else "not measured",
        device_idle_share=(f"{1 - busy_ms / wall_ms:.3f}" if dev_events
                           else "not measured"),
        device_launches=len(dev_events),
        package_kernels=json.dumps(ours, separators=(",", ":")))

    # each kernel on the main path's first call of it (frame 0); its bytes:
    # the planes and tables it reads once and the planes it writes once
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    table_bytes = {
        "lab_forward_unit": kernels._table("fwd", dev).numel() * 4,
        "clahe_apply": 0,  # its LUTs and fractions are arguments
        "lab_inverse_unit": kernels._table("inv", dev).numel() * 4,
        "lab_inverse_unit_gamma": kernels._table("inv", dev).numel() * 4
        + 256 * 4,
    }
    records = []
    for kname, (source, replaces, ops_px, plain) in KERNELS.items():
        args = calls[kname][0]
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        outs = getattr(kernels, kname)(*args)
        outs = (outs,) if isinstance(outs, torch.Tensor) else outs
        nbytes = table_bytes[kname] + sum(
            t.numel() * t.element_size() for t in tensors + list(outs))
        px = args[0].numel()
        ms = statistics.median(event_ms(
            torch, lambda: getattr(kernels, kname)(*args), 30, 3, flush))
        plain_ms = statistics.median(event_ms(
            torch, lambda: getattr(kernels, plain)(*args), 10, 1, flush))
        t_bytes = nbytes / bw * 1e3
        t_ops = ops_px * px / F32_PEAK * 1e3
        records.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": err[kname], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bytes": nbytes, "shape": list(args[0].shape),
        })
        log("timing", kernel=kname, us=f"{ms * 1e3:.2f}",
            plain_us=f"{plain_ms * 1e3:.2f}",
            bound_us=f"{max(t_bytes, t_ops) * 1e3:.2f}", bytes=nbytes)
    shutil.rmtree(WORK, ignore_errors=True)

    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
