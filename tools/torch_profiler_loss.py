"""How often ``torch.profiler`` misses a kernel launch at the edges of a
short session, on one card.

    python3 tools/torch_profiler_loss.py [--tries N]

Builds the PyTorch port's kernels and profiles one call of the prefix-sum
kernel K6 (``kernels.sat_rows`` on a (6, 1080, 1920) table, one launch)
``--tries`` times in each of several set-ups: alone; after a spin kernel
(``torch.cuda._sleep``); before one; between two; and after a host pause
of 10 ms inside the session.  Each set-up runs first in a fresh process
state and again after a profiled session of 3000 small launches, as a
profiled frame leaves it.  Prints one JSON line per set-up and phase: how
many sessions recorded the K6 launch, and how many spin kernels they
recorded.  Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tries", type=int, default=20)
    tries = ap.parse_args().tries
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from underwater_image_enhancement_tpu_torch.ops import kernels
    from underwater_image_enhancement_tpu_torch.utils import cuda_build

    cuda_build.extension()
    dev = torch.device("cuda")
    x = torch.rand((6, 1080, 1920), device=dev)
    kernels.sat_rows(x, -2)
    torch.cuda.synchronize()

    def spin():
        torch.cuda._sleep(20000)

    setups = {
        "alone": lambda: kernels.sat_rows(x, -2),
        "spin_before": lambda: (spin(), kernels.sat_rows(x, -2)),
        "spin_after": lambda: (kernels.sat_rows(x, -2), spin()),
        "spin_both": lambda: (spin(), kernels.sat_rows(x, -2), spin()),
        "host_pause_before": lambda: (time.sleep(0.01),
                                      kernels.sat_rows(x, -2)),
    }

    def session(fn):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    y = torch.zeros(1024, device=dev)
    for phase in ("fresh", "after_3000_launch_session"):
        if phase != "fresh":
            session(lambda: [y.add_(1.0) for _ in range(3000)])
        for name, fn in setups.items():
            seen, spins = 0, 0
            for _ in range(tries):
                names = session(fn)
                seen += any("prefix_scan_kernel" in n for n in names)
                spins += sum("spin_kernel" in n for n in names)
            print(json.dumps({"card": smi, "phase": phase, "setup": name,
                              "sessions": tries, "k6_recorded": seen,
                              "spin_kernels_recorded": spins}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
