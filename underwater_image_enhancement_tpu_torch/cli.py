"""Command-line interface of the port.

    python -m underwater_image_enhancement_tpu_torch.cli six --input DIR --output DIR

Commands (reference counterparts):
  six   six_stadigy.py __main__: all six strategies per image + CSV log

Runs on the CUDA device by default (``--device cuda``); ``--device cpu``
runs the plain PyTorch path.  On CUDA the kernels are built before the
frame loop, and a ``RuntimeError`` from the build or from a kernel launch
ends the run with a non-zero exit; other per-image errors become "failed"
rows of ``processing_log.csv``, as in the JAX CLI.  ``--fast`` is not
ported yet and is rejected.  Other subcommands of the JAX package's CLI
are not ported yet.
"""

from __future__ import annotations

import argparse
import csv
import time
import traceback
from pathlib import Path

LOG_FIELDS = ["filename", "image_type", "strategy", "status", "output_path",
              "processing_time"]


def _cmd_six(args) -> None:
    import torch

    from underwater_image_enhancement_tpu_torch.pipeline import cast as cast_mod
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        SIX_ORDER,
        resolve_device,
        six_strategy_tuple,
    )
    from underwater_image_enhancement_tpu_torch.utils import cuda_build
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    if args.fast:
        raise SystemExit("six --fast is not yet ported to the PyTorch/CUDA "
                         "package; run the exact tier (no --fast)")
    device = resolve_device(args.device)
    if device.type == "cuda":
        cuda_build.extension()  # a failed build ends the run here
    files = uio.collect_images(args.input)
    if not files:
        print(f"no images found in {args.input}")
        return
    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    rows_by_path: dict = {}
    order = []
    t_start = time.time()
    n_total = len(files)
    done = 0
    writer = uio.AsyncWriter()

    def process_chunk(chunk):
        # frames of a chunk run one by one; the chunk shares one timing
        nonlocal done
        t0 = time.time()
        results = []
        try:
            for _, img in chunk:
                outs, code = six_strategy_tuple(img, device=device)
                # quantize on the device: (clip * 255) truncated, as the
                # reference's imwrite; only uint8 frames cross to the host
                u8 = [(torch.clamp(o, 0, 1) * 255).to(torch.uint8).cpu().numpy()
                      for o in outs]
                results.append((u8, int(code)))
        except RuntimeError:
            # a failed kernel launch or device fault (torch.AcceleratorError
            # is a RuntimeError) is no per-image failure: end the run
            raise
        except Exception as e:  # noqa: BLE001 - failed rows, six_stadigy.py:463-478
            traceback.print_exc()
            msg = str(e)[:50]
            for p, _ in chunk:
                print(f"  failed: {p.name} - {msg}")
                rows_by_path[p] = [{
                    "filename": p.name, "image_type": "unknown",
                    "strategy": name, "status": "failed",
                    "output_path": f"Error: {msg}", "processing_time": "N/A",
                } for name in SIX_ORDER]
            done += len(chunk)
            return
        dt = time.time() - t0
        for (p, _), (u8, code) in zip(chunk, results):
            cast_name = cast_mod.CAST_NAMES[code]
            img_rows = []
            for k, name in enumerate(SIX_ORDER):
                dst = outdir / f"{p.stem}_{name}.png"
                writer.write(str(dst), u8[k])
                img_rows.append({
                    "filename": p.name, "image_type": cast_name,
                    "strategy": name, "status": "success",
                    "output_path": str(dst),
                    "processing_time": f"{dt / len(chunk):.2f}s",
                })
            rows_by_path[p] = img_rows
            done += 1
            eta = (time.time() - t_start) / done * (n_total - done)
            print(f"[{done}/{n_total}] {p.name} ({cast_name}) "
                  f"eta {eta / 60:.1f}m")

    def _log_unreadable(msg):
        nonlocal n_total
        print(f"  {msg.replace('warning: ', '')}")
        n_total -= 1

    bs = max(1, int(args.batch_size))
    chunk = []
    for p, img in uio.decode_iter(files, log=_log_unreadable):
        order.append(p)
        chunk.append((p, img))
        if len(chunk) == bs:
            process_chunk(chunk)
            chunk = []
    if chunk:
        process_chunk(chunk)

    # join write-behind IO; mark failed writes before the CSV
    for path, err in writer.close():
        name = Path(path).name
        for img_rows in rows_by_path.values():
            for r in img_rows:
                if r["status"] == "success" and Path(r["output_path"]).name == name:
                    r["status"] = "failed"
                    r["output_path"] = f"Error: {err[:50]}"
                    print(f"  write failed: {name} - {err[:50]}")

    # log rows in folder order (reference order)
    rows = [r for p in order for r in rows_by_path.get(p, [])]
    tally = {}
    for r in rows:
        if r["status"] == "success":
            tally[r["image_type"]] = tally.get(r["image_type"], 0) + 1
    n_strat = len(SIX_ORDER)
    print("image types: " + ", ".join(
        f"{k} {v // n_strat}" for k, v in sorted(tally.items())))
    log_path = outdir / "processing_log.csv"
    with open(log_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=LOG_FIELDS)
        w.writeheader()
        w.writerows(rows)
    if not rows:
        print("no images processed")
    print(f"log -> {log_path}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="underwater_image_enhancement_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("six", help="run all six strategies per image")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--fast", action="store_true",
                   help="the histogram-percentile tier: not yet ported, "
                        "rejected")
    p.add_argument("--batch-size", type=int, default=1,
                   help="frames per chunk; a chunk's frames run one by one "
                        "and share one processing_time")
    p.set_defaults(fn=_cmd_six)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
