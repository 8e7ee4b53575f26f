"""Parity report of a folder: ``cli validate`` (the JAX package's
``validate.py``).

One command over an image folder writes ``validation_report.json`` and
``validation_report.md``:

- each strategy's PSNR against the float64 oracles (``utils/oracles``)
  on the first ``oracle_samples`` images: the five config-flavour
  strategies (enhancement_strategies.py:349-508) and the six recipes
  (six_stadigy.py:230-285), each run on the device, the oracle on the host
  (cv2);
- UIQM and UCIQE before and after the Phase-1 winner over the whole folder
  (quality_assessment.py:215-286), on the device, in the same pass as the
  labels (spread over the system's data mesh);
- the Phase-1 winner distribution (main.py:198-218);
- with ``model``: a Phase-2 classifier's accuracy against the Phase-1
  labels (sklearn, main.py:225-335).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse < 1e-12 else 10.0 * np.log10(1.0 / mse)


def _oracle_psnrs(imgs: List[np.ndarray], fast: bool,
                  device: Union[str, torch.device] = "cuda") -> Dict[str, Dict]:
    """Each strategy's PSNR against the float64 oracles on the sample
    images: the strategy on ``device``, the oracle on the host.  An empty
    sample raises in ``min``, as in the JAX package."""
    from underwater_image_enhancement_tpu_torch.pipeline.six import (
        SIX_STRATEGIES,
        SIX_STRATEGIES_FAST,
    )
    from underwater_image_enhancement_tpu_torch.pipeline.strategies import (
        STRATEGY_FNS,
        STRATEGY_FNS_FAST,
    )
    from underwater_image_enhancement_tpu_torch.utils import oracles

    cfg_fns = STRATEGY_FNS_FAST if fast else STRATEGY_FNS
    six_fns = SIX_STRATEGIES_FAST if fast else SIX_STRATEGIES
    xs = [torch.from_numpy(np.ascontiguousarray(im, np.float32)).to(device)
          for im in imgs]

    def row(vals):
        return {"psnr_db_min": round(min(vals), 1),
                "psnr_db_mean": round(float(np.mean(vals)), 1)}

    out: Dict[str, Dict] = {"config": {}, "six": {}}
    for name, fn in cfg_fns.items():
        out["config"][name] = row([
            _psnr(fn(x[None])[0].cpu().numpy(),
                  oracles.strategy_config(im, name))
            for im, x in zip(imgs, xs)])
    for name, fn in six_fns.items():
        out["six"][name] = row([
            _psnr(fn(x).cpu().numpy(), oracles.strategy_six(im, name))
            for im, x in zip(imgs, xs)])
    return out


def validate_folder(input_folder: str, output_folder: str,
                    oracle_samples: int = 3, fast: bool = False,
                    model: Optional[str] = None, batch_size: int = 8,
                    log=print,
                    device: Union[str, torch.device] = "cuda") -> Dict:
    """The whole report of ``input_folder`` (``fast``: the throughput
    labeling tier) -> its dict, also written to
    ``output_folder/validation_report.{json,md}``."""
    from underwater_image_enhancement_tpu_torch.metrics.uiqm import (
        uciqe_batch,
        uiqm_batch,
    )
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        resolve_device,
    )
    from underwater_image_enhancement_tpu_torch.pipeline.strategies import (
        LABEL_ORDER,
        STRATEGY_DISPLAY,
    )
    from underwater_image_enhancement_tpu_torch.select.system import (
        SelfSupervisedSystem,
        label_batch,
    )
    from underwater_image_enhancement_tpu_torch.utils import io as uio
    from underwater_image_enhancement_tpu_torch.utils.config import Config

    dev = resolve_device(device)
    files = uio.collect_images(input_folder)
    if not files:
        raise ValueError(f"no images found in {input_folder}")
    outdir = Path(output_folder)
    outdir.mkdir(parents=True, exist_ok=True)

    sys_ = SelfSupervisedSystem(Config(fast_label=fast), device=dev)
    weights = sys_.config.quality_weights
    names = [STRATEGY_DISPLAY[k] for k in LABEL_ORDER]

    def shard(x):
        # a shard's labels and its quality before and after, on its device
        feats, scores, best, winners = label_batch(x, weights, False, fast)
        return (feats, best, uiqm_batch(x), uiqm_batch(winners),
                uciqe_batch(x), uciqe_batch(winners))

    # Phase-1 labeling and the quality before and after over the whole
    # folder, in same-shape batches (the build_dataset pattern)
    winners: Dict[str, int] = {}
    quality: List[np.ndarray] = []
    feats_all: List[np.ndarray] = []
    labels_all: List[str] = []
    samples: List[np.ndarray] = []
    pending: Dict[tuple, List[np.ndarray]] = {}

    def flush(batch_list):
        feats, best, *q = sys_._run_data_parallel(shard,
                                                  np.stack(batch_list))
        # one read of the numbers a batch
        head = torch.cat([feats, best[:, None].to(feats.dtype),
                          torch.stack(q, 1)], 1).cpu().numpy()
        quality.append(head[:, -4:])
        for j in range(len(batch_list)):
            lab = names[int(head[j, -5])]
            winners[lab] = winners.get(lab, 0) + 1
            labels_all.append(lab)
            feats_all.append(head[j, :-5])

    for _, img in uio.decode_iter(files, log=lambda m: log(f"  {m}")):
        if len(samples) < oracle_samples:
            samples.append(img)
        buf = pending.setdefault(img.shape, [])
        buf.append(img)
        if len(buf) == max(1, batch_size):
            flush(buf)
            buf.clear()
    for buf in pending.values():
        if buf:
            flush(buf)

    n = len(labels_all)
    log(f"labeled {n} images; running {len(samples)} float64 oracle samples")
    q = np.concatenate(quality).astype(np.float64)
    report: Dict = {
        "n_images": n,
        "label_tier": "fast" if fast else "exact",
        "oracle_psnr": _oracle_psnrs(samples, fast, dev),
        "quality": {
            "uiqm_raw_mean": round(float(np.mean(q[:, 0])), 3),
            "uiqm_enhanced_mean": round(float(np.mean(q[:, 1])), 3),
            "uciqe_raw_mean": round(float(np.mean(q[:, 2])), 3),
            "uciqe_enhanced_mean": round(float(np.mean(q[:, 3])), 3),
        },
        "winner_distribution": {
            k: {"count": v, "fraction": round(v / n, 3)}
            for k, v in sorted(winners.items())
        },
    }

    if model:
        from sklearn.metrics import accuracy_score

        sys_.load_model(model)
        X = sys_.scaler.transform(np.stack(feats_all))
        pred = sys_.classifier.predict(X)
        report["classifier"] = {
            "model": str(model),
            "accuracy_vs_phase1": round(
                float(accuracy_score(labels_all, pred)), 3),
        }

    (outdir / "validation_report.json").write_text(
        json.dumps(report, indent=2))
    (outdir / "validation_report.md").write_text(_to_markdown(report))
    log(f"report -> {outdir / 'validation_report.json'}")
    return report


def _to_markdown(r: Dict) -> str:
    lines = [f"# Validation report ({r['n_images']} images, "
             f"{r['label_tier']} tier)", ""]
    lines += ["## Strategy parity vs float64 golden oracles", "",
              "| flavor | strategy | PSNR min (dB) | PSNR mean (dB) |",
              "|---|---|---|---|"]
    for flavor in ("config", "six"):
        for name, v in r["oracle_psnr"][flavor].items():
            lines.append(f"| {flavor} | {name} | {v['psnr_db_min']} "
                         f"| {v['psnr_db_mean']} |")
    q = r["quality"]
    lines += ["", "## Quality before/after Phase-1 winner", "",
              "| metric | raw | enhanced |", "|---|---|---|",
              f"| UIQM | {q['uiqm_raw_mean']} | {q['uiqm_enhanced_mean']} |",
              f"| UCIQE | {q['uciqe_raw_mean']} "
              f"| {q['uciqe_enhanced_mean']} |"]
    lines += ["", "## Phase-1 winner distribution", "",
              "| strategy | count | fraction |", "|---|---|---|"]
    for k, v in r["winner_distribution"].items():
        lines.append(f"| {k} | {v['count']} | {v['fraction']} |")
    if "classifier" in r:
        c = r["classifier"]
        lines += ["", f"Classifier `{c['model']}` accuracy vs Phase-1 "
                  f"labels: **{c['accuracy_vs_phase1']}**"]
    return "\n".join(lines) + "\n"
