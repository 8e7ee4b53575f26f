"""Command-line interface of the port.

    python -m underwater_image_enhancement_tpu_torch.cli six --input DIR --output DIR [--fast]
    python -m underwater_image_enhancement_tpu_torch.cli enhance --input PATH --output PATH [--model NPZ [--arch A]]
    python -m underwater_image_enhancement_tpu_torch.cli auto --input DIR --output DIR
    python -m underwater_image_enhancement_tpu_torch.cli build-dataset --input DIR --output DIR [--fast]
    python -m underwater_image_enhancement_tpu_torch.cli assess --input PATH
    python -m underwater_image_enhancement_tpu_torch.cli fusion --input PATH --output DIR
    python -m underwater_image_enhancement_tpu_torch.cli waternet --input PATH --output DIR [--checkpoint NPZ] [--bf16]
    python -m underwater_image_enhancement_tpu_torch.cli train-selector --output DIR
    python -m underwater_image_enhancement_tpu_torch.cli run --input DIR --output DIR
    python -m underwater_image_enhancement_tpu_torch.cli predict --input FILE --model PKL
    python -m underwater_image_enhancement_tpu_torch.cli convert-vgg --torch-ckpt PTH --out NPZ
    python -m underwater_image_enhancement_tpu_torch.cli train-mlp --input DIR --reference DIR --output DIR
    python -m underwater_image_enhancement_tpu_torch.cli train-vgg --input DIR --reference DIR --output DIR [--fp32]
    python -m underwater_image_enhancement_tpu_torch.cli train-zoo --input DIR --reference DIR --output DIR [--model M]
    python -m underwater_image_enhancement_tpu_torch.cli validate --input DIR --output DIR [--fast] [--model PKL]

Commands (reference counterparts):
  six            six_stadigy.py __main__: all six strategies per image +
                 CSV log (``--fast``: the histogram-percentile tier)
  enhance        use_trained_model.py __main__: with ``--model`` (a
                 predictor checkpoint in the port's ``.npz``) the
                 parameter predictor of ``--arch`` per image (vgg, or the
                 zoo's resnet, efficientnet ``--variant b0|b3`` and vit
                 at ``--input-size``); without, the fixed-parameter
                 enhance of one file, or of a folder in same-shape
                 batches (``*_enhanced.png``)
  auto           main.py's Phase-1 choice per image: the best of the five
                 config-flavour strategies by the weighted quality score
                 (``{stem}_{strategy}.png``, ``name: strategy (score)``)
  build-dataset  main.py Phase 1: label each image, save the winner, the
                 CSV report and ``dataset.pkl`` (``--fast``: the
                 throughput tier)
  assess         quality_assessment on an image or a folder: the weighted
                 total, UIQM, UCIQE and the eight metrics, one row a file
  fusion         Ancuti multi-scale fusion of an image or a folder, in
                 same-shape batches (``<stem>_fusion.png``)
  waternet       the Water-Net CNN (the WB/HE/gamma views and the gated
                 fusion net) on an image or a folder, in same-shape
                 batches (``<stem>_waternet.png``; ``--bf16``: the
                 deployment dtype; without ``--checkpoint``, random
                 weights from seed 0)
  train-selector main.py Phase 2: the classifiers on ``dataset.pkl``
                 (sklearn, which the port imports only here)
  run            Phase 1 + Phase 2 in one command
  predict        main.py predict: the best strategy for an image from
                 a ``trained_model.pkl``
  convert-vgg    a torch vgg16 checkpoint -> the ``.npz`` trunk weights
  train-mlp      deep_learning_parameters.py's end-to-end trainer: the
                 feature MLP on the 79 cached features (``--resume``)
  train-vgg      vgg_16_UIE.py's trainer: the VGG predictor, bf16 unless
                 ``--fp32`` (``--pretrained-vgg``, ``--resume``)
  train-zoo      the resnet, efficientnet (``--variant``) and vit
                 predictors (``--pretrained``, ``--resume``); each trainer
                 writes ``best_model.npz``, ``final_model.npz`` (what
                 ``enhance --model [--arch]`` reads) and
                 ``training_history.json``
  validate       parity report of a folder: each strategy's PSNR against
                 the float64 oracles on a few images (cv2, on the host),
                 UIQM and UCIQE before and after the Phase-1 winner, the
                 winner distribution, with ``--model`` the classifier's
                 accuracy against the Phase-1 labels

Runs on the CUDA device by default (``--device cuda``); ``--device cpu``
runs the plain PyTorch path.  On CUDA the kernels are built before the
frame loop, and a ``RuntimeError`` from the build or from a kernel launch
ends the run with a non-zero exit; other per-image errors of ``six``
become "failed" rows of ``processing_log.csv``, as in the JAX CLI.
``--devices N`` (``enhance``, ``auto``, ``build-dataset``, ``run``) spreads
each batch over a data mesh (``parallel/mesh``): on ``cuda`` the cards
0..N-1 (more than are visible ends the run), on ``cpu`` N positions;
unset, every visible card.  Outputs are the same bytes for any N.
"""

from __future__ import annotations

import argparse
import csv
import json
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch

DEVICES_HELP = ("data-parallel device count: on cuda the cards 0..N-1, on "
                "cpu N positions (default: every visible card; 1 disables "
                "sharding)")
LOG_FIELDS = ["filename", "image_type", "strategy", "status", "output_path",
              "processing_time"]


def _start(device_name: str):
    """The command's device; on CUDA the kernels are built here, before
    any frame (a failed build ends the run)."""
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        resolve_device,
    )
    from underwater_image_enhancement_tpu_torch.utils import cuda_build

    device = resolve_device(device_name)
    if device.type == "cuda":
        cuda_build.extension()
    return device


def _stream_shape_batches(files, batch_size: int, log=print):
    """Same-shape [(path, img), ...] chunks of <= batch_size, decoded
    streaming: per-shape buffers flush as soon as a batch is full (the JAX
    CLI's helper of the same name)."""
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    bs = max(1, int(batch_size))
    pending: dict = {}
    for p, img in uio.decode_iter(files, log=log):
        buf = pending.setdefault(img.shape, [])
        buf.append((p, img))
        if len(buf) == bs:
            yield list(buf)
            buf.clear()
    for buf in pending.values():
        if buf:
            yield buf


def _to_host(img) -> np.ndarray:
    return img.detach().cpu().numpy()


def _mesh(args):
    """The data mesh of ``--devices`` on ``--device``'s type (None: one
    plain call); a count the machine cannot give ends the run."""
    from underwater_image_enhancement_tpu_torch.parallel.mesh import (
        default_mesh,
    )

    try:
        return default_mesh(args.devices, device=args.device)
    except ValueError as e:
        raise SystemExit(f"{args.cmd} --devices {args.devices}: {e}") from None


def _cmd_enhance(args) -> None:
    from underwater_image_enhancement_tpu_torch.parallel.mesh import (
        run_data_parallel,
    )
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        enhance,
        enhance_batch,
    )
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    mesh = _mesh(args)
    if args.model and mesh is not None:
        raise SystemExit(f"enhance --model --devices {args.devices}: the "
                         "predictors run on one device (--device); "
                         "--devices spreads the fixed-parameter enhance")
    device = _start(args.device)
    inp = Path(args.input)
    if args.model:
        from underwater_image_enhancement_tpu_torch.models.predictor import (
            EnhancementPredictor,
            ZooPredictor,
        )

        if args.arch == "vgg":
            pred = EnhancementPredictor(checkpoint_path=args.model,
                                        device=device)
        else:  # a zoo checkpoint (train-zoo's, converted)
            pred = ZooPredictor(checkpoint_path=args.model,
                                model_type=args.arch, variant=args.variant,
                                input_size=args.input_size, device=device)
        if inp.is_dir():
            n = pred.process_folder(args.input, args.output)
            print(f"enhanced {n} images -> {args.output}")
        else:
            params = pred.process_single_image(args.input, args.output)
            print("predicted params:",
                  {k: round(v, 4) for k, v in params.items()})
        return
    if not inp.is_dir():
        img = uio.imread_unit(str(inp))
        if img is None:
            print(f"skip unreadable image: {inp}")
            return
        params = {"omega": args.omega, "gamma": args.gamma,
                  "L_low": args.l_low, "L_high": args.l_high}
        uio.imwrite_unit(str(args.output),
                         _to_host(enhance(img, params, device=device)))
        print(f"done -> {args.output}")
        return

    files = uio.collect_images(args.input)
    outdir = Path(args.output)
    n = 0
    with uio.AsyncWriter() as writer:
        for chunk in _stream_shape_batches(
                files, args.batch_size,
                log=lambda m: print(f"skip {m.replace('warning: ', '')}")):
            # 'hist' equals the sorted-index mode on the u8 grid every
            # decoded image lies on
            batch = torch.from_numpy(np.stack([im for _, im in chunk]))
            outs = _to_host(run_data_parallel(
                lambda x: enhance_batch(x, args.l_low, args.l_high,
                                        args.omega, args.gamma,
                                        stretch_mode="hist", device=x.device),
                batch if mesh else batch.to(device), mesh))
            for j, (p, _) in enumerate(chunk):
                writer.write(str(outdir / f"{p.stem}_enhanced.png"), outs[j])
                n += 1
    for path, err in writer.close():
        n -= 1
        print(f"  write failed: {Path(path).name} - {err[:50]}")
    print(f"done ({n} images) -> {args.output}")


def _cmd_auto(args) -> None:
    from underwater_image_enhancement_tpu_torch.parallel.mesh import (
        run_data_parallel,
    )
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        CONFIG_ORDER,
        auto_enhance_batch,
    )
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    def shard(x):
        best_imgs, best, scores = auto_enhance_batch(x, device=x.device)
        # quantized on the device, as the reference's imwrite
        return (best_imgs.clamp(0, 1) * 255).to(torch.uint8), best, scores

    mesh = _mesh(args)
    device = _start(args.device)
    files = uio.collect_images(args.input)
    outdir = Path(args.output)
    with uio.AsyncWriter() as writer:
        for chunk in _stream_shape_batches(files, args.batch_size,
                                           log=lambda m: None):
            batch = torch.from_numpy(np.stack([im for _, im in chunk]))
            u8, best, scores = run_data_parallel(
                shard, batch if mesh else batch.to(device), mesh)
            # one read of the images and one of the numbers a chunk
            u8 = _to_host(u8)
            best, scores = _to_host(best), _to_host(scores)
            for j, (p, _) in enumerate(chunk):
                k = int(best[j])
                name = CONFIG_ORDER[k]
                writer.write(str(outdir / f"{p.stem}_{name}.png"), u8[j])
                print(f"{p.name}: {name} ({float(scores[j, k]):.2f})")
    for path, err in writer.close():
        print(f"  write failed: {Path(path).name} - {err[:50]}")


def _cmd_build_dataset(args) -> None:
    from underwater_image_enhancement_tpu_torch.select.system import (
        SelfSupervisedSystem,
    )
    from underwater_image_enhancement_tpu_torch.utils.config import Config

    _mesh(args)  # a --devices the machine cannot give ends the run here
    device = _start(args.device)
    cfg = Config(image_folder=args.input, output_folder=args.output,
                 fast_label=bool(args.fast),
                 batch_size=int(args.batch_size or 8),
                 n_devices=args.devices)
    system = SelfSupervisedSystem(cfg, device=device)
    rows = system.build_dataset()
    print(f"labeled {len(rows)} images")
    for k, v in system.dataset_report().items():
        print(f"  {k:<24} {v['count']:>4} ({v['fraction'] * 100:.1f}%) "
              f"score {v['mean_score']:.2f}±{v['std_score']:.2f}")


def _load_dataset(system) -> None:
    from underwater_image_enhancement_tpu_torch.select.system import (
        DatasetItem,
    )

    with open(Path(system.config.model_folder) / "dataset.pkl", "rb") as f:
        system.dataset = [DatasetItem(**d) for d in pickle.load(f)]


def _cmd_train_selector(args) -> None:
    """main.py Phase 2 on ``<output>/trained_models/dataset.pkl`` (the
    JAX CLI's ``train-selector``); sklearn on the host."""
    from underwater_image_enhancement_tpu_torch.select.system import (
        SelfSupervisedSystem,
    )
    from underwater_image_enhancement_tpu_torch.utils.config import Config

    cfg = Config(image_folder=args.input or ".", output_folder=args.output)
    system = SelfSupervisedSystem(cfg)
    _load_dataset(system)
    print(json.dumps(system.train_classifier(), indent=2))


def _cmd_run(args) -> None:
    """Phase 1 + Phase 2 in one command (main.py:436-456)."""
    from underwater_image_enhancement_tpu_torch.select.system import (
        SelfSupervisedSystem,
    )
    from underwater_image_enhancement_tpu_torch.utils.config import Config

    _mesh(args)  # a --devices the machine cannot give ends the run here
    device = _start(args.device)
    cfg = Config(image_folder=args.input, output_folder=args.output,
                 fast_label=bool(args.fast),
                 batch_size=int(args.batch_size or 8),
                 n_devices=args.devices)
    system = SelfSupervisedSystem(cfg, device=device)
    rows = system.build_dataset()
    if not rows:
        print("error: could not build dataset (no readable images)")
        return
    print(f"labeled {len(rows)} images")
    print(json.dumps(system.train_classifier(), indent=2))
    print(f"output folder: {cfg.output_folder}")


def _cmd_predict(args) -> None:
    """The best strategy for an image (main.py predict): its features on
    the device, the classifier from ``--model``."""
    from underwater_image_enhancement_tpu_torch.select.system import (
        SelfSupervisedSystem,
    )
    from underwater_image_enhancement_tpu_torch.utils.config import Config

    device = _start(args.device)
    system = SelfSupervisedSystem(Config(output_folder=args.output or "."),
                                  device=device)
    system.load_model(args.model)
    label, probs = system.predict(args.input)
    print(f"best strategy: {label}")
    for k, v in sorted(probs.items(), key=lambda kv: -kv[1]):
        print(f"  {k:<24} {v:.3f}")


def _cmd_validate(args) -> None:
    """The parity report of a folder (the JAX CLI's ``validate``):
    labeling and the quality metrics on the device, the float64 oracles
    on the host."""
    from underwater_image_enhancement_tpu_torch.validate import (
        validate_folder,
    )

    device = _start(args.device)
    report = validate_folder(args.input, args.output,
                             oracle_samples=args.oracle_samples,
                             fast=args.fast, model=args.model,
                             batch_size=args.batch_size, device=device)
    print(json.dumps(report, indent=2))


def _cmd_convert_vgg(args) -> None:
    from underwater_image_enhancement_tpu_torch.models.vgg import (
        convert_torch_vgg_to_npz,
    )

    n = convert_torch_vgg_to_npz(args.torch_ckpt, args.out)
    print(f"exported {n} conv layers -> {args.out}")


def _fit(trainer, ds, tr_idx, va_idx, args, device,
         with_indices: bool = False) -> None:
    """Resume if asked, then fit with the batches prefetched to the
    device (the shuffle reseeded by the epoch, as the JAX CLI does)."""
    from underwater_image_enhancement_tpu_torch.train.data import (
        prefetch_to_device,
    )

    trainer.fit(
        lambda: prefetch_to_device(ds.batches(
            tr_idx, args.batch_size, seed=len(trainer.train_losses),
            with_indices=with_indices), device=device),
        lambda: prefetch_to_device(ds.batches(
            va_idx, args.batch_size, shuffle=False,
            with_indices=with_indices), device=device),
        epochs=args.epochs, output_folder=args.output,
    )


def _cmd_train_mlp(args) -> None:
    from underwater_image_enhancement_tpu_torch.train.data import (
        PairedImageDataset,
    )
    from underwater_image_enhancement_tpu_torch.train.trainer import (
        MLPTrainer,
    )

    device = _start(args.device)
    # no augmentation: the reference's EnhancementDataset has none
    # (deep_learning_parameters.py:199-246)
    ds = PairedImageDataset(args.input, args.reference, target_size=256,
                            augment=False)
    tr_idx, va_idx = ds.split(0.8)
    trainer = MLPTrainer(device=device)
    if args.resume:
        trainer.load(args.resume)
    # one 79-feature extraction pass, reused by every epoch
    trainer.cache_features(ds)
    _fit(trainer, ds, tr_idx, va_idx, args, device, with_indices=True)


def _cmd_train_vgg(args) -> None:
    from underwater_image_enhancement_tpu_torch.train.data import (
        PairedImageDataset,
    )
    from underwater_image_enhancement_tpu_torch.train.trainer import (
        VGGTrainer,
    )

    device = _start(args.device)
    ds = PairedImageDataset(args.input, args.reference, target_size=224)
    tr_idx, va_idx = ds.split(0.85)
    pv = None if args.pretrained_vgg == "none" else args.pretrained_vgg
    trainer = VGGTrainer(epochs=args.epochs,
                         compute_dtype="float32" if args.fp32 else "bfloat16",
                         pretrained_vgg=pv, device=device)
    if args.resume:
        trainer.load(args.resume)
    _fit(trainer, ds, tr_idx, va_idx, args, device)


def _cmd_train_zoo(args) -> None:
    """End-to-end training of the model_architectures.py backbones
    (resnet18, efficientnet b0/b3, vit_b_16)."""
    from underwater_image_enhancement_tpu_torch.train.data import (
        PairedImageDataset,
    )
    from underwater_image_enhancement_tpu_torch.train.trainer import (
        ZooTrainer,
    )

    device = _start(args.device)
    ds = PairedImageDataset(args.input, args.reference,
                            target_size=args.image_size)
    tr_idx, va_idx = ds.split(0.8)
    pretrained = None if args.pretrained == "none" else args.pretrained
    trainer = ZooTrainer(model_type=args.model, variant=args.variant,
                         image_size=args.image_size, pretrained=pretrained,
                         device=device)
    if args.resume:
        trainer.load(args.resume)
    _fit(trainer, ds, tr_idx, va_idx, args, device)


def _cmd_assess(args) -> None:
    from underwater_image_enhancement_tpu_torch.metrics.quality import (
        METRIC_NAMES,
        comprehensive_assessment,
    )
    from underwater_image_enhancement_tpu_torch.metrics.uiqm import uciqe, uiqm
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    device = _start(args.device)
    inp = Path(args.input)
    files = uio.collect_images(args.input) if inp.is_dir() else [inp]
    print(f"{'file':<28}{'total':>8}{'uiqm':>8}{'uciqe':>8}  " +
          "".join(f"{m[:7]:>9}" for m in METRIC_NAMES))
    for p in files:
        img = uio.imread_unit(str(p))
        if img is None:
            continue
        x = torch.from_numpy(img).to(device)
        total, scores = comprehensive_assessment(x)
        # one read of the frame's numbers
        v = _to_host(torch.stack([total, uiqm(x), uciqe(x)]
                                 + [scores[m] for m in METRIC_NAMES]))
        print(f"{p.name:<28}{v[0]:>8.2f}{v[1]:>8.3f}{v[2]:>8.3f}  " +
              "".join(f"{s:>9.2f}" for s in v[3:]))


def _cmd_fusion(args) -> None:
    """Ancuti multi-scale fusion (the JAX CLI's ``fusion``): same-shape
    batches decoded ahead, written behind."""
    from underwater_image_enhancement_tpu_torch.pipeline.fusion import (
        ancuti_fusion,
    )
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    device = _start(args.device)
    inp = Path(args.input)
    files = uio.collect_images(args.input) if inp.is_dir() else [inp]
    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    done = 0
    with uio.AsyncWriter() as writer:
        for chunk in _stream_shape_batches(
                files, args.batch_size,
                log=lambda m: print(f"  {m.replace('warning: ', '')}")):
            batch = torch.from_numpy(np.stack([im for _, im in chunk]))
            outs = _to_host(ancuti_fusion(batch.to(device)))
            for j, (p, _) in enumerate(chunk):
                writer.write(str(outdir / f"{p.stem}_fusion.png"), outs[j])
                done += 1
    for path, err in writer.close():
        done -= 1
        print(f"  write failed: {Path(path).name} - {err[:50]}")
    print(f"fused {done} images -> {args.output}")


def _cmd_waternet(args) -> None:
    """Water-Net inference (the JAX CLI's ``waternet``): the WB/HE/gamma
    views and the CNN a batch, same-shape batches decoded ahead, written
    behind."""
    from underwater_image_enhancement_tpu_torch.models import bridge
    from underwater_image_enhancement_tpu_torch.models import waternet as wn
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    device = _start(args.device)
    model = wn.WaterNet(dtype=torch.bfloat16 if args.bf16 else torch.float32)
    if args.checkpoint:
        # a tree that does not fit the WaterNet raises here, before any
        # frame
        bridge.load_flax(model, bridge.load_checkpoint(
            args.checkpoint, "waternet")).eval()
    else:
        print("no --checkpoint: using random-init weights (smoke/demo mode)")
        wn.init_waternet(torch.Generator().manual_seed(0), 64, model)
    model.to(device)

    inp = Path(args.input)
    files = uio.collect_images(args.input) if inp.is_dir() else [inp]
    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    done = 0
    with uio.AsyncWriter() as writer:
        for chunk in _stream_shape_batches(
                files, args.batch_size,
                log=lambda m: print(f"  {m.replace('warning: ', '')}")):
            batch = torch.from_numpy(np.stack([im for _, im in chunk]))
            outs = _to_host(wn.waternet_enhance(model, batch.to(device)))
            for j, (p, _) in enumerate(chunk):
                writer.write(str(outdir / f"{p.stem}_waternet.png"), outs[j])
                done += 1
    for path, err in writer.close():
        done -= 1
        print(f"  write failed: {Path(path).name} - {err[:50]}")
    print(f"waternet-enhanced {done} images -> {args.output}")


def _cmd_six(args) -> None:
    from underwater_image_enhancement_tpu_torch.pipeline import cast as cast_mod
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        SIX_ORDER,
        six_strategy_tuple,
    )
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    device = _start(args.device)
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
                outs, code = six_strategy_tuple(img, fast=args.fast,
                                                device=device)
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

    p = sub.add_parser("enhance", help="enhance image(s)")
    p.add_argument("--input", required=True, help="an image or a folder")
    p.add_argument("--output", required=True,
                   help="the output image, or a folder for a folder input")
    p.add_argument("--model", default=None,
                   help="predictor checkpoint: the port's .npz "
                        "(tools/jax_ckpt_to_npz.py converts a JAX one)")
    p.add_argument("--arch", default="vgg",
                   choices=("vgg", "resnet", "efficientnet", "vit"),
                   help="the predictor the checkpoint belongs to")
    p.add_argument("--variant", default="b0", choices=("b0", "b3"),
                   help="efficientnet width/depth scale (with --arch "
                        "efficientnet)")
    p.add_argument("--input-size", type=int, default=224,
                   help="parameter-prediction resolution (zoo archs; the "
                        "VGG predictor works at 224)")
    p.add_argument("--omega", type=float, default=0.6)
    p.add_argument("--gamma", type=float, default=1.2)
    p.add_argument("--l-low", type=float, default=10.0)
    p.add_argument("--l-high", type=float, default=90.0)
    p.add_argument("--batch-size", type=int, default=8,
                   help="frames per call (same-shape groups)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    p.add_argument("--devices", type=int, default=None,
                   help=DEVICES_HELP)
    p.set_defaults(fn=_cmd_enhance)

    p = sub.add_parser("six", help="run all six strategies per image")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--fast", action="store_true",
                   help="the histogram-percentile tier (banded-SAT airlight, "
                        "fast guided filter, approximate forward LAB)")
    p.add_argument("--batch-size", type=int, default=1,
                   help="frames per chunk; a chunk's frames run one by one "
                        "and share one processing_time")
    p.set_defaults(fn=_cmd_six)

    device_help = ("torch device (default cuda; cpu runs the plain PyTorch "
                   "versions of the kernels)")
    p = sub.add_parser("auto", help="best-of-5-strategies per image")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--batch-size", type=int, default=4,
                   help="frames per call (same-shape groups)")
    p.add_argument("--device", default="cuda", help=device_help)
    p.add_argument("--devices", type=int, default=None, help=DEVICES_HELP)
    p.set_defaults(fn=_cmd_auto)

    p = sub.add_parser("build-dataset", help="Phase 1 self-supervised labeling")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--fast", action="store_true",
                   help="throughput-tier strategies (banded airlight, fast "
                        "guided filter, histogram percentiles, arithmetic "
                        "LAB); near-tie winners may flip")
    p.add_argument("--batch-size", type=int, default=8,
                   help="frames per labeling call (same-shape groups)")
    p.add_argument("--device", default="cuda", help=device_help)
    p.add_argument("--devices", type=int, default=None, help=DEVICES_HELP)
    p.set_defaults(fn=_cmd_build_dataset)

    p = sub.add_parser("assess", help="quality scores for image(s)")
    p.add_argument("--input", required=True, help="an image or a folder")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_assess)

    p = sub.add_parser("fusion", help="Ancuti multi-scale fusion enhancement")
    p.add_argument("--input", required=True, help="an image or a folder")
    p.add_argument("--output", required=True)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_fusion)

    p = sub.add_parser("waternet", help="Water-Net CNN enhancer (the "
                       "WB/HE/gamma views and the CNN a batch)")
    p.add_argument("--input", required=True, help="an image or a folder")
    p.add_argument("--output", default="waternet_results")
    p.add_argument("--checkpoint", default=None,
                   help="WaterNet parameters: the port's .npz "
                        "(tools/jax_ckpt_to_npz.py --arch waternet converts "
                        "a JAX one)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (deployment dtype)")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_waternet)

    p = sub.add_parser("train-selector", help="Phase 2 classifier training")
    p.add_argument("--input", default=None)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=_cmd_train_selector)

    p = sub.add_parser("run", help="Phase 1 + Phase 2 in one command")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--fast", action="store_true",
                   help="throughput-tier Phase-1 labeling (see build-dataset)")
    p.add_argument("--batch-size", type=int, default=8,
                   help="frames per labeling call (same-shape groups)")
    p.add_argument("--device", default="cuda", help=device_help)
    p.add_argument("--devices", type=int, default=None, help=DEVICES_HELP)
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("convert-vgg",
                       help="torch vgg16 checkpoint -> .npz weights")
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=_cmd_convert_vgg)

    p = sub.add_parser("train-mlp", help="end-to-end MLP predictor training")
    p.add_argument("--input", required=True)
    p.add_argument("--reference", required=True)
    p.add_argument("--output", default="./output")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--resume", default=None,
                   help="a checkpoint .npz of this trainer to continue")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_train_mlp)

    p = sub.add_parser("train-vgg", help="VGG predictor training")
    p.add_argument("--input", required=True)
    p.add_argument("--reference", required=True)
    p.add_argument("--output", default="./output")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--fp32", action="store_true",
                   help="full-f32 compute (default is bfloat16, the AMP "
                        "analog the reference trains under)")
    p.add_argument("--resume", default=None,
                   help="a checkpoint .npz of this trainer to continue")
    p.add_argument("--pretrained-vgg", default="auto",
                   help=".npz from convert-vgg: ImageNet VGG16 backbone and "
                        "perceptual-loss trunk (vgg_16_UIE.py:149,257); "
                        "'auto' searches $UIE_TPU_WEIGHTS then "
                        "~/.cache/uie_tpu; 'none' forces the seeded init")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_train_vgg)

    p = sub.add_parser("train-zoo",
                       help="train a resnet/efficientnet/vit predictor")
    p.add_argument("--input", required=True)
    p.add_argument("--reference", required=True)
    p.add_argument("--output", default="./output")
    p.add_argument("--model", default="resnet",
                   choices=("resnet", "efficientnet", "vit"))
    p.add_argument("--variant", default="b0", choices=("b0", "b3"),
                   help="efficientnet width/depth scale")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--resume", default=None,
                   help="a checkpoint .npz of this trainer to continue")
    p.add_argument("--pretrained", default="auto",
                   help="torchvision .npz of the trunk (ImageNet); 'auto' "
                        "searches $UIE_TPU_WEIGHTS then ~/.cache/uie_tpu; "
                        "'none' forces the seeded init")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_train_zoo)

    p = sub.add_parser("predict", help="predict best strategy for an image")
    p.add_argument("--input", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_predict)

    p = sub.add_parser("validate",
                       help="parity report: oracle PSNR, UIQM/UCIQE "
                            "before/after, winner distribution")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--oracle-samples", type=int, default=3,
                   help="images run through the float64 oracles (cv2, on "
                        "the host)")
    p.add_argument("--fast", action="store_true",
                   help="validate the throughput labeling tier instead of "
                        "the exact one")
    p.add_argument("--model", default=None,
                   help="trained_model.pkl: adds the classifier's accuracy "
                        "against the Phase-1 labels (sklearn)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_validate)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
