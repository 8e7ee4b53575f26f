"""Time the PyTorch port's prefix-sum (K6) and hysteresis (K7) kernels on
the calls a 1080p frame makes, for one checkout of the repository.

    python3 tools/torch_k6_k7_times.py [--root DIR] [--kernel NAME]

Imports ``underwater_image_enhancement_tpu_torch`` and ``chip_smoke`` from
DIR (default: this checkout), builds its kernels, runs the exact and fast
airlight descents and the quality metrics on ``chip_smoke.synthetic_frame(0)``
on the card while capturing every ``kernels.sat_rows`` and
``kernels.hysteresis_propagate`` call, then times the first call of each
shape (CUDA events, median of 30; ``--kernel sat_rows`` or
``--kernel hysteresis_propagate`` times that one alone) and prints one
JSON line per call: "us"
with the L2 flushed before each call by zeroing 256 MB, as
``chip_smoke.py`` times its kernels (this leaves the L2 full of dirty
lines, which a kernel that reads much then writes back), and "us_clean"
with it flushed by reading 256 MB (clean lines).  Run it for two checkouts in one session on
one card, in turns (A, B, B, A), to compare two designs of the kernels.
Needs a CUDA device."""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--kernel", choices=("sat_rows", "hysteresis_propagate"))
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from underwater_image_enhancement_tpu_torch.metrics.quality import (
        comprehensive_assessment,
    )
    from underwater_image_enhancement_tpu_torch.ops import airlight, kernels
    from underwater_image_enhancement_tpu_torch.ops.layout import split_planes
    from underwater_image_enhancement_tpu_torch.pipeline import cast
    from underwater_image_enhancement_tpu_torch.utils import cuda_build

    cuda_build.extension()
    dev = torch.device("cuda")
    names = ("sat_rows", "hysteresis_propagate")
    calls = {k: [] for k in names}
    originals = {k: getattr(kernels, k) for k in names}

    def keep(name):
        def wrapper(*args):
            calls[name].append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args))
            return originals[name](*args)
        return wrapper

    for k in names:
        setattr(kernels, k, keep(k))
    img = torch.from_numpy(chip_smoke.synthetic_frame(0)).to(dev)
    planes = split_planes(cast.detect_and_correct(img)[0])
    airlight.quadtree_airlight_exact_planes(planes)
    airlight.quadtree_airlight_planes(planes, edge_iters=4)
    comprehensive_assessment(img)
    for k in names:
        setattr(kernels, k, originals[k])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    seen = set()
    for k in (opts.kernel,) if opts.kernel else names:
        fn = originals[k]
        for args in calls[k]:
            key = (k, tuple(args[0].shape), args[-1])
            if key in seen:
                continue
            seen.add(key)
            times = chip_smoke.event_ms(torch, lambda: fn(*args), 30, 3, flush)
            clean = []
            for _ in range(30):
                flush.sum()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                clean.append(start.elapsed_time(end))
            print(json.dumps({
                "root": root.name, "card": smi, "kernel": k,
                "shape": "x".join(map(str, args[0].shape)),
                "arg": args[-1], "calls_a_frame": sum(
                    tuple(a[0].shape) == key[1] and a[-1] == key[2]
                    for a in calls[k]),
                "us": round(statistics.median(times) * 1e3, 2),
                "us_clean": round(statistics.median(clean) * 1e3, 2)}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
