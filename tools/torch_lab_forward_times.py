"""Time the PyTorch port's five forward-LAB kernels (K1, K8 ``_approx``,
K8 ``_fast``, K1b, K4: ``csrc/lab_forward.cu``) at the main path's 1080p
shapes for one checkout, and read each one's registers, spills and
occupancy.

    python3 tools/torch_lab_forward_times.py [--root DIR]

Imports ``underwater_image_enhancement_tpu_torch`` and ``chip_smoke`` from
DIR (default: this checkout), builds its kernels, and calls each wrapper
on the planes of ``chip_smoke.synthetic_frame(0)``: f32 unit planes for
K1 and the two K8, their u8-valued int32 planes for K1b and K4.  Prints
one JSON line a kernel:

- "us": median of 30 calls (CUDA events) with the L2 flushed before each
  by zeroing 256 MB, as ``chip_smoke.py`` times its kernels; "us_clean"
  with it flushed by reading 256 MB (no dirty lines to write back);
- "gb_s": the planes' bytes (inputs read once, outputs written once; the
  table, at most 13 KB, left out so that checkouts compare) over "us";
- "regs", "spill_stores", "spill_loads", "stack": ``nvcc -Xptxas -v`` of
  DIR's ``csrc/lab_forward.cu`` with the package's nvcc flags, into a
  cubin;
- "threads", "blocks_per_sm": the kernel's ``__launch_bounds__`` and
  ``cuOccupancyMaxActiveBlocksPerMultiprocessor`` for it, on that cubin;
- "grid", "block": what one call launched (``torch.profiler``'s trace).

Two PyTorch calls that move the same bytes and do no other work are timed
the same way beside them, as the floor this timing can show:
``torch.stack`` of the three f32 planes (3 planes in, 3 out, as K1, K8
and K1b) and ``torch.addcmul`` of the three int32 planes (3 in, 1 out, as
K4).

To compare two checkouts on one card, run it for each in turns (A, B,
B, A) within one command, the parent unpacked with ``git archive`` into a
directory that git ignores::

    for r in build/parent . . build/parent; do
        python3 tools/torch_lab_forward_times.py --root $r; done

Needs a CUDA device and ``nvcc``."""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

# wrapper -> (template arguments of lab_forward_kernel, f32 input)
WRAPPERS = {
    "lab_forward_unit": ("float, 0, false", True),
    "lab_forward_unit_approx": ("float, 1, false", True),
    "lab_forward_unit_fast": ("float, 2, false", True),
    "lab_forward_u8": ("int, 0, false", False),
    "lab_forward_l_u8": ("int, 0, true", False),
}
NVCC = "/usr/local/cuda/bin/nvcc"


def ptxas_report(src: Path, flags, cubin: Path) -> dict:
    """{template arguments: (mangled name, regs, stack bytes, spill
    stores, spill loads)} of each lab_forward_kernel in ``src``."""
    out = subprocess.run(
        [NVCC, *flags, "-std=c++17", "-cubin", "-Xptxas", "-v", "-o",
         str(cubin), str(src)], check=True, capture_output=True,
        text=True).stderr
    entries, entry = {}, None
    lines = out.splitlines()
    for k, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = entries.setdefault(m.group(1), {})
        m = re.search(r"Function properties for (\S+)", line)
        if m and k + 1 < len(lines):
            entries.setdefault(m.group(1), {})["props"] = [
                int(v) for v in re.findall(r"(\d+) bytes", lines[k + 1])[:3]]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            entry["regs"] = int(m.group(1))
    report = {}
    for name, e in entries.items():
        # lab_forward_kernel<float|int, policy, false|true>, mangled
        m = re.search(r"lab_forward_kernelI([fi])Li(\d+)ELb([01])EE", name)
        if m:
            args = "{}, {}, {}".format("float" if m.group(1) == "f" else "int",
                                       m.group(2), "true" if m.group(3) == "1"
                                       else "false")
            report[args] = (name, e["regs"], *e["props"])
    return report


def occupancy(cubin: Path, names) -> dict:
    """{mangled name: (max threads a block, resident blocks a SM)} from
    the driver API on the primary context torch made current."""
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUDA driver error {rc}")

    ctx = ctypes.c_void_p()
    ok(cu.cuInit(0), "cuInit")
    ok(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), 0), "primary context")
    ok(cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    mod = ctypes.c_void_p()
    ok(cu.cuModuleLoad(ctypes.byref(mod), str(cubin).encode()), "cuModuleLoad")
    res = {}
    for name in names:
        fn = ctypes.c_void_p()
        ok(cu.cuModuleGetFunction(ctypes.byref(fn), mod, name.encode()), name)
        threads, blocks = ctypes.c_int(), ctypes.c_int()
        ok(cu.cuFuncGetAttribute(ctypes.byref(threads), 0, fn), "max threads")
        ok(cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
            ctypes.byref(blocks), fn, threads, ctypes.c_size_t(0)), "occupancy")
        res[name] = (threads.value, blocks.value)
    cu.cuModuleUnload(mod)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from underwater_image_enhancement_tpu_torch.ops import kernels
    from underwater_image_enhancement_tpu_torch.ops.layout import split_planes
    from underwater_image_enhancement_tpu_torch.utils import cuda_build

    cuda_build.extension()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    work = root / "build" / "lab_forward_times"
    work.mkdir(parents=True, exist_ok=True)
    cubin = work / "lab_forward.cubin"
    report = ptxas_report(cuda_build.CSRC_DIR / "lab_forward.cu",
                          cuda_build.NVCC_FLAGS, cubin)
    occ = occupancy(cubin, [v[0] for v in report.values()])

    img = torch.from_numpy(chip_smoke.synthetic_frame(0)).to(dev)
    unit = split_planes(img)
    u8 = tuple(kernels.quantize_u8(p) for p in unit)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)

    def times_of(fn):
        """Median µs of 30 calls after a zeroing flush, and after a
        reading one."""
        dirty = chip_smoke.event_ms(torch, fn, 30, 3, flush)
        clean = []
        for _ in range(30):
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            clean.append(start.elapsed_time(end))
        return (statistics.median(dirty) * 1e3,
                statistics.median(clean) * 1e3)

    for name, fn, nbytes in (
            ("torch.stack", lambda: torch.stack(unit), 6 * unit[0].nbytes),
            ("torch.addcmul", lambda: torch.addcmul(*u8), 4 * u8[0].nbytes)):
        us, us_clean = times_of(fn)
        print(json.dumps({
            "root": root.name, "card": smi, "kernel": name,
            "shape": "x".join(map(str, unit[0].shape)), "us": round(us, 2),
            "us_clean": round(us_clean, 2), "bytes": nbytes,
            "gb_s": round(nbytes / us / 1e3, 1)}), flush=True)
    for wname, (targs, f32) in WRAPPERS.items():
        fn = getattr(kernels, wname)
        args = unit if f32 else u8
        outs = fn(*args)
        outs = (outs,) if isinstance(outs, torch.Tensor) else outs
        nbytes = sum(t.numel() * t.element_size() for t in args + tuple(outs))
        us, us_clean = times_of(lambda: fn(*args))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
            fn(*args)
            torch.cuda.synchronize()
        trace = work / "trace.json"
        prof.export_chrome_trace(str(trace))
        launched = [e.get("args", {}) for e in json.loads(
            trace.read_text()).get("traceEvents", [])
            if e.get("cat") == "kernel"
            and "lab_forward_kernel" in e.get("name", "")]
        name, regs, stack, spill_st, spill_ld = report[targs]
        threads, blocks = occ[name]
        print(json.dumps({
            "root": root.name, "card": smi, "kernel": wname,
            "shape": "x".join(map(str, args[0].shape)),
            "us": round(us, 2), "us_clean": round(us_clean, 2),
            "bytes": nbytes, "gb_s": round(nbytes / us / 1e3, 1),
            "regs": regs, "spill_stores": spill_st, "spill_loads": spill_ld,
            "stack": stack, "threads": threads, "blocks_per_sm": blocks,
            "grid": launched[0].get("grid") if launched else "not measured",
            "block": launched[0].get("block") if launched else "not measured",
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
