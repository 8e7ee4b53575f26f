"""Time the PyTorch port's numpy JPEG decoder on a 1920x1080 frame.

    python tools/torch_jpeg_decode_time.py [--progressive]

Encodes ``chip_smoke.synthetic_frame(0)`` with cv2 (quality 95 and 75,
4:2:0 and 4:4:4), decodes it with
``underwater_image_enhancement_tpu_torch.utils.jpeg.decode_jpeg`` and with
``cv2.imdecode``, checks that the two agree bit for bit, and prints one
JSON line per file: the bytes, the median ms of three decodes of each,
and the ms of one decode spent building the Huffman lookahead tables
(``lut_ms``: the most that keeping built tables across files could save).
``--progressive`` also writes each file as progressive ones with
``tests/torch_jpeg_scans.py`` (each of its scripts but the one that stops
early, and cv2's with a restart every 7 MCUs) and cv2's own progressive
encoding of the frame, and prints a line for each of those.  It needs
cv2, so it runs where the JAX package's tests run, not on the GPU
machine."""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import cv2
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from tests import torch_jpeg_scans  # noqa: E402
from underwater_image_enhancement_tpu_torch.utils import jpeg  # noqa: E402
from underwater_image_enhancement_tpu_torch.utils.jpeg import decode_jpeg  # noqa: E402


def median_ms(fn, runs=3):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def lut_ms(data: bytes) -> float:
    """The ms of one decode of ``data`` spent in ``jpeg._huffman_lut``."""
    build, spent = jpeg._huffman_lut, []

    def timed(*args):
        t0 = time.perf_counter()
        out = build(*args)
        spent.append(time.perf_counter() - t0)
        return out

    jpeg._huffman_lut = timed
    try:
        decode_jpeg(data)
    finally:
        jpeg._huffman_lut = build
    return sum(spent) * 1e3


def report(data: bytes, **what) -> None:
    buf = np.frombuffer(data, np.uint8)
    got = decode_jpeg(data)
    want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)[..., ::-1]
    print(json.dumps({
        "frame": "1080x1920", **what, "bytes": len(data),
        "bit_equal_to_cv2": bool(np.array_equal(got, want)),
        "numpy_ms": round(median_ms(lambda: decode_jpeg(data)), 1),
        "lut_ms": round(lut_ms(data), 1),
        "cv2_ms": round(median_ms(
            lambda: cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)), 2),
    }), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--progressive", action="store_true",
                    help="also time progressive versions of each file")
    args = ap.parse_args(argv)
    rgb = (chip_smoke.synthetic_frame(0) * 255).astype(np.uint8)
    for quality in (95, 75):
        for sampling in ("420", "444"):
            params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                      getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)]
            data = cv2.imencode(".jpg", rgb[..., ::-1], params)[1].tobytes()
            report(data, quality=quality, sampling=sampling)
            if not args.progressive:
                continue
            for name, restart in [(n, 0) for n in torch_jpeg_scans.SCRIPTS
                                  if n != "stops_at_1"] + [("cv2", 7)]:
                prog = torch_jpeg_scans.transcode(
                    data, torch_jpeg_scans.script(name, 3), restart)
                report(prog, quality=quality, sampling=sampling,
                       script=name, restart=restart)
            own = cv2.imencode(".jpg", rgb[..., ::-1], params + [
                cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
            report(own, quality=quality, sampling=sampling,
                   script="cv2's own encoder")


if __name__ == "__main__":
    main()
