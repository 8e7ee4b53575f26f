"""Print ``chip_smoke.TIFF_CODEC_SHA256``: the SHA-256 of each file of
``chip_smoke.tiff_codec_files`` (1080p frame 0 as CCITT and SGILog TIFFs)
and of ``cv2.imread``'s array of it in IMREAD_UNCHANGED and IMREAD_COLOR
(RGB order, as ``chip_smoke.tiff_codec_sha256`` takes them), with the
port's decode of each held to cv2's first.  Needs cv2 (5.0.0: the
hashes are its libtiff 4.7.1's readings); the card's host has none.

    python tools/tiff_codec_hashes.py

Writes its files under build/tiff_codec_hashes/ (ignored by git)."""

import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from underwater_image_enhancement_tpu_torch.utils import io as uio  # noqa: E402
from underwater_image_enhancement_tpu_torch.utils.tiff import decode_tiff  # noqa: E402


def cv2_rgb(img: np.ndarray) -> np.ndarray:
    """cv2's array as the port lays it out: (H, W, C), RGB order."""
    if img.ndim == 2:
        return img[..., None]
    return np.ascontiguousarray(img[..., ::-1])


def main() -> int:
    out = ROOT / "build" / "tiff_codec_hashes"
    out.mkdir(parents=True, exist_ok=True)
    uio.imwrite_unit(str(out / "frame0.png"), cs.synthetic_frame(0))
    u8 = uio.imread_u8(str(out / "frame0.png"))
    lines = ["TIFF_CODEC_SHA256 = {"]
    for name, write in cs.tiff_codec_files(u8).items():
        data = write()
        path = out / name
        path.write_bytes(data)
        shas = [cs.hashlib.sha256(data).hexdigest()]
        for color, flag in ((False, cv2.IMREAD_UNCHANGED),
                            (True, cv2.IMREAD_COLOR)):
            want = cv2_rgb(cv2.imread(str(path), flag))
            got = decode_tiff(data, color)
            if got.dtype != want.dtype or not np.array_equal(
                    got.view(np.uint8), want.view(np.uint8)):
                print(f"{name}: the port's decode differs from cv2's",
                      file=sys.stderr)
                return 1
            shas.append(cs.tiff_codec_sha256(want))
        lines.append(f'    "{name}": (')
        lines += [f'        "{h}",' for h in shas[:-1]]
        lines.append(f'        "{shas[-1]}"),')
    lines.append("}")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
