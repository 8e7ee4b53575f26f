"""Time the PyTorch port's host-bound paths at 1080p for one checkout: a
``six`` exact frame, a Phase-1 label frame (exact tier), the single-image
CLAHE leg split and fused, and (where the checkout has it) an Ancuti
``fusion`` frame.

    python3 tools/torch_frame_times.py [--root DIR] [--rounds N] \
        [--paths six_exact,label_exact,...]

Imports ``underwater_image_enhancement_tpu_torch`` and ``chip_smoke`` from
DIR (default: this checkout), builds its kernels, and runs N rounds
(default 3) of: 12 ``six_strategy_tuple`` exact frames over the three
``chip_smoke.synthetic_frame`` frames after 6 warm-up frames, 6
``label_batch`` exact frames (scores and features, one frame a call), 18
CLAHE legs of frame 0 (clip 3.0, gamma 1.5) split then 18 fused, and 6
fusion frames (``--paths`` picks some of them).  Each call is timed with
CUDA events around it, as ``chip_smoke.py`` times its frames (the paths
are host-bound, so this is the host's time to issue the call), and its
host time with ``time.perf_counter`` up to the synchronise.  Then 3 calls
of each path run under ``torch.profiler``: the device busy ms of each (the
sum of the durations of its kernels and copies on the card, as
``chip_smoke.py`` reads a profiled frame) and its launches.  Prints one
JSON line: the checkout, the card's name and power limit, and for each
path the median, quartiles and every run in ms, and the profiled busy ms
and launches.

To compare two checkouts on one card, run it for each in turns (A, B, B,
A) within one command, the parent unpacked with ``git archive`` into a
directory that git ignores::

    for r in build/parent . . build/parent; do
        python3 tools/torch_frame_times.py --root $r; done

Needs a CUDA device and ``nvcc``."""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--paths", default=None,
                    help="comma-separated paths to time (default: all)")
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from underwater_image_enhancement_tpu_torch.ops import histeq
    from underwater_image_enhancement_tpu_torch.ops.layout import split_planes
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        six_strategy_tuple,
    )
    from underwater_image_enhancement_tpu_torch.select.system import (
        label_batch,
    )
    from underwater_image_enhancement_tpu_torch.utils import cuda_build
    from underwater_image_enhancement_tpu_torch.utils.config import (
        DEFAULT_QUALITY_WEIGHTS,
    )
    try:
        from underwater_image_enhancement_tpu_torch.pipeline.fusion import (
            ancuti_fusion,
        )
    except ImportError:
        ancuti_fusion = None

    cuda_build.extension()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    imgs = [torch.from_numpy(chip_smoke.synthetic_frame(s)).to(dev)
            for s in range(3)]
    planes = split_planes(imgs[0])

    def timed(fn, runs, warmup):
        """(event ms, host ms) of each of ``runs`` calls after ``warmup``."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ev, host = [], []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            end.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ev.append(start.elapsed_time(end))
        return ev, host

    paths = {
        "six_exact": (lambda i: six_strategy_tuple(imgs[i % 3], fast=False),
                      12, 6),
        "label_exact": (lambda i: label_batch(
            imgs[i % 3][None], DEFAULT_QUALITY_WEIGHTS, False, False), 6, 2),
        "clahe_leg_split": (lambda i: histeq.clahe_enhancement_planes(
            planes, 3.0, gamma=1.5, impl="split"), 18, 3),
        "clahe_leg_fused": (lambda i: histeq.clahe_enhancement_planes(
            planes, 3.0, gamma=1.5, impl="fused"), 18, 3),
    }
    if ancuti_fusion is not None:
        paths["fusion"] = (lambda i: ancuti_fusion(imgs[i % 3][None]), 6, 2)
    if opts.paths:
        paths = {k: paths[k] for k in opts.paths.split(",")}
    ms = {k: [] for k in paths}
    host = {k: [] for k in paths}
    for r in range(opts.rounds):
        for key, (fn, runs, warmup) in paths.items():
            it = iter(range(10 ** 6))
            e, h = timed(lambda: fn(next(it)), runs, warmup if r == 0 else 1)
            ms[key] += e
            host[key] += h

    def profiled(fn):
        """(device busy ms, launches) of one call of fn."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        return sum(e.time_range.elapsed_us() for e in ev) / 1e3, len(ev)

    busy = {k: [profiled(lambda: fn(i)) for i in range(3)]
            for k, (fn, _, _) in paths.items()}

    def summary(v):
        q1, med, q3 = statistics.quantiles(v, n=4)
        return {"median": round(med, 3), "quartiles": [round(q1, 3),
                                                       round(q3, 3)],
                "runs": [round(t, 3) for t in v]}

    print(json.dumps({"root": str(opts.root), "card": smi,
                      "ms": {k: summary(v) for k, v in ms.items()},
                      "host_ms": {k: summary(v) for k, v in host.items()},
                      "busy_ms": {k: [round(b, 3) for b, _ in v]
                                  for k, v in busy.items()},
                      "launches": {k: [n for _, n in v]
                                   for k, v in busy.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
