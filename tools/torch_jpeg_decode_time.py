"""Time the PyTorch port's numpy JPEG decoder on a 1920x1080 frame.

    python tools/torch_jpeg_decode_time.py

Encodes ``chip_smoke.synthetic_frame(0)`` with cv2 (quality 95 and 75,
4:2:0 and 4:4:4), decodes it with
``underwater_image_enhancement_tpu_torch.utils.jpeg.decode_jpeg`` and with
``cv2.imdecode``, checks that the two agree bit for bit, and prints one
JSON line per file: the bytes and the median ms of three decodes of each.
It needs cv2, so it runs where the JAX package's tests run, not on the GPU
machine."""

import json
import statistics
import sys
import time
from pathlib import Path

import cv2
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from underwater_image_enhancement_tpu_torch.utils.jpeg import decode_jpeg  # noqa: E402


def median_ms(fn, runs=3):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main():
    rgb = (chip_smoke.synthetic_frame(0) * 255).astype(np.uint8)
    for quality in (95, 75):
        for sampling in ("420", "444"):
            flag = getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)
            _, buf = cv2.imencode(".jpg", rgb[..., ::-1], [
                cv2.IMWRITE_JPEG_QUALITY, quality,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
            data = buf.tobytes()
            got = decode_jpeg(data)
            want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)[..., ::-1]
            print(json.dumps({
                "frame": "1080x1920", "quality": quality,
                "sampling": sampling, "bytes": len(data),
                "bit_equal_to_cv2": bool(np.array_equal(got, want)),
                "numpy_ms": round(median_ms(lambda: decode_jpeg(data)), 1),
                "cv2_ms": round(median_ms(
                    lambda: cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)), 2),
            }), flush=True)


if __name__ == "__main__":
    main()
