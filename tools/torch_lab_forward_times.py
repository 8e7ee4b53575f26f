"""Time the PyTorch port's per-pixel kernels at the main path's 1080p
shapes for one checkout, and read each one's registers, spills and
occupancy: the five forward-LAB kernels (K1, K8 ``_approx``, K8
``_fast``, K1b, K4: ``csrc/lab_forward.cu``), and with ``--kernels`` also
the three inverse-LAB kernels (K3, K3g, K3b: ``csrc/lab_inverse.cu``),
CLAHE apply (K2: ``csrc/clahe_apply.cu``) and the fused CLAHE + inverse
LAB (K5: ``csrc/clahe_lab_apply.cu``).

    python3 tools/torch_lab_forward_times.py [--root DIR] [--kernels LIST]

LIST is ``forward`` (the default), ``all``, or wrapper names separated by
commas (``lab_inverse_unit,lab_inverse_unit_gamma,lab_inverse_u8,
clahe_apply,clahe_lab_apply``).  Imports ``underwater_image_enhancement_tpu_torch`` and
``chip_smoke`` from DIR (default: this checkout), builds its kernels, and
calls each wrapper on the planes of ``chip_smoke.synthetic_frame(0)``:
f32 unit planes for K1 and the two K8, their u8-valued int32 planes for
K1b and K4, their LAB planes (K1b) for K3, K3g (gamma 1.5) and K3b, for
K2 the L plane with its CLAHE LUTs and fractions (clip 3.0, 8x8 tiles,
``histeq.clahe_prep``), and for K5 the LAB planes with those.  Prints one JSON line a kernel:

- "us": median of 30 calls (CUDA events) with the L2 flushed before each
  by zeroing 256 MB, as ``chip_smoke.py`` times its kernels; "us_clean"
  with it flushed by reading 256 MB (no dirty lines to write back);
- "gb_s": the planes' bytes (inputs read once, outputs written once; the
  tables, LUTs and fractions, at most 64 KB, left out so that checkouts
  compare) over "us";
- "regs", "spill_stores", "spill_loads", "stack": ``nvcc -Xptxas -v`` of
  DIR's source of the kernel with the package's nvcc flags, into a cubin;
- "threads", "blocks_per_sm": the kernel's ``__launch_bounds__`` and
  ``cuOccupancyMaxActiveBlocksPerMultiprocessor`` for it, on that cubin;
- "grid", "block": what one call launched (``torch.profiler``'s trace).

PyTorch calls that move the same bytes and do no other work are timed the
same way beside them, as the floor this timing can show: ``torch.stack``
of the three f32 planes (3 planes in, 3 out, as K1, K8 and K1b),
``torch.addcmul`` of the three int32 planes (3 in, 1 out, as K4),
``torch.stack`` of the three int32 LAB planes (as K3, K3g, K3b and K5)
and ``torch.clone`` of the int32 L plane (1 in, 1 out, as K2).

To compare two checkouts on one card, run it for each in turns (A, B,
B, A) within one command, the parent unpacked with ``git archive`` into a
directory that git ignores::

    for r in build/parent . . build/parent; do
        python3 tools/torch_lab_forward_times.py --root $r --kernels all; done

Needs a CUDA device and ``nvcc``."""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

# wrapper -> (CUDA source, pattern of its kernel's mangled name in this
# design or the parent's, inputs); the inverse kernels' template was
# <Out, epilogue number> before it became <Out, table epilogue>
WRAPPERS = {
    "lab_forward_unit": ("lab_forward.cu", r"lab_forward_kernelIfLi0ELb0EE",
                         "unit"),
    "lab_forward_unit_approx": ("lab_forward.cu",
                                r"lab_forward_kernelIfLi1ELb0EE", "unit"),
    "lab_forward_unit_fast": ("lab_forward.cu",
                              r"lab_forward_kernelIfLi2ELb0EE", "unit"),
    "lab_forward_u8": ("lab_forward.cu", r"lab_forward_kernelIiLi0ELb0EE",
                       "u8"),
    "lab_forward_l_u8": ("lab_forward.cu", r"lab_forward_kernelIiLi0ELb1EE",
                         "u8"),
    "lab_inverse_unit": ("lab_inverse.cu",
                         r"lab_inverse_kernelIfL(i1|b1)EE", "lab"),
    "lab_inverse_unit_gamma": ("lab_inverse.cu",
                               r"lab_inverse_kernelIfL(i2|b1)EE", "lab_gamma"),
    "lab_inverse_u8": ("lab_inverse.cu", r"lab_inverse_kernelIiL(i0|b0)EE",
                       "lab"),
    "clahe_apply": ("clahe_apply.cu", r"clahe_apply_kernel", "clahe"),
    "clahe_lab_apply": ("clahe_lab_apply.cu", r"clahe_lab_apply_kernel",
                        "clahe_lab"),
}
FORWARD = tuple(k for k in WRAPPERS if k.startswith("lab_forward"))
NVCC = "/usr/local/cuda/bin/nvcc"


def ptxas_report(src: Path, flags, cubin: Path) -> dict:
    """{mangled name: (regs, stack bytes, spill stores, spill loads)} of
    each kernel in ``src``."""
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
    return {name: (e["regs"], *e["props"]) for name, e in entries.items()
            if "regs" in e}


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
    ap.add_argument("--kernels", default="forward",
                    help="forward, all, or wrapper names separated by commas")
    opts = ap.parse_args()
    names = {"forward": FORWARD, "all": tuple(WRAPPERS)}.get(
        opts.kernels, tuple(opts.kernels.split(",")))
    unknown = [k for k in names if k not in WRAPPERS]
    if unknown:
        ap.error(f"unknown kernels {unknown}; known: {list(WRAPPERS)}")
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from underwater_image_enhancement_tpu_torch.ops import histeq, kernels
    from underwater_image_enhancement_tpu_torch.ops.layout import split_planes
    from underwater_image_enhancement_tpu_torch.utils import cuda_build

    cuda_build.extension()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    work = root / "build" / "lab_forward_times"
    work.mkdir(parents=True, exist_ok=True)
    # {source: ({mangled name: ptxas numbers}, {mangled name: occupancy})}
    built = {}
    for src in sorted({WRAPPERS[k][0] for k in names}):
        cubin = work / (Path(src).stem + ".cubin")
        report = ptxas_report(cuda_build.CSRC_DIR / src,
                              cuda_build.NVCC_FLAGS, cubin)
        built[src] = (report, occupancy(cubin, list(report)))

    img = torch.from_numpy(chip_smoke.synthetic_frame(0)).to(dev)
    unit = split_planes(img)
    u8 = tuple(kernels.quantize_u8(p) for p in unit)
    lab = kernels.lab_forward_u8(*u8)
    luts, ya, xa, geo = histeq.clahe_prep(lab[0], 3.0, 8, 8)
    inputs = {"unit": unit, "u8": u8, "lab": lab, "lab_gamma": lab + (1.5,),
              "clahe": (lab[0], luts, ya, xa, *geo),
              "clahe_lab": (*lab, luts, ya, xa, *geo)}
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
            ("torch.addcmul", lambda: torch.addcmul(*u8), 4 * u8[0].nbytes),
            ("torch.stack_int32", lambda: torch.stack(lab),
             6 * lab[0].nbytes),
            ("torch.clone", lambda: torch.clone(lab[0]), 2 * lab[0].nbytes)):
        us, us_clean = times_of(fn)
        print(json.dumps({
            "root": root.name, "card": smi, "kernel": name,
            "shape": "x".join(map(str, unit[0].shape)), "us": round(us, 2),
            "us_clean": round(us_clean, 2), "bytes": nbytes,
            "gb_s": round(nbytes / us / 1e3, 1)}), flush=True)
    for wname in names:
        src, pattern, key = WRAPPERS[wname]
        fn = getattr(kernels, wname)
        args = inputs[key]
        outs = fn(*args)
        outs = (outs,) if isinstance(outs, torch.Tensor) else outs
        # the planes: the LUTs and fractions of K2 are left out
        planes = [t for t in args if isinstance(t, torch.Tensor)
                  and t.shape == args[0].shape]
        nbytes = sum(t.numel() * t.element_size()
                     for t in planes + list(outs))
        us, us_clean = times_of(lambda: fn(*args))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
            fn(*args)
            torch.cuda.synchronize()
        trace = work / "trace.json"
        prof.export_chrome_trace(str(trace))
        kname = pattern.split("I")[0].split("(")[0]
        launched = [e.get("args", {}) for e in json.loads(
            trace.read_text()).get("traceEvents", [])
            if e.get("cat") == "kernel" and kname in e.get("name", "")]
        report, occ = built[src]
        name = next(m for m in report if re.search(pattern, m))
        regs, stack, spill_st, spill_ld = report[name]
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
