"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``underwater_image_enhancement_tpu_torch`` (never JAX) through the
``six`` exact tier, the ``six --fast`` tier, ``enhance``, the Phase-1
labeling path (``auto``, ``build-dataset``, ``build-dataset --fast``),
``assess``, the colour and CLAHE entry points (the fused CLAHE legs, the
u8 LAB round trip, the probe-corrected forward LAB), the Ancuti ``fusion``,
the batch forms of CLAHE, the VGG parameter predictor (``enhance
--model``), the selector's MLP classifier, the zoo predictors (``enhance
--model --arch resnet|efficientnet|vit``) and Water-Net (``waternet``,
f32 and ``--bf16``) at 1920x1080, and the three trainers (``train-mlp``,
``train-vgg``, ``train-zoo``) at full width on 640x480 pairs.  Phases
(each prints one line or more; a failed check raises and the script exits
non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile ``csrc/`` into the package's PyTorch extension
   (``utils/cuda_build.py``) and time it;
3. kernels: each CUDA kernel bit-equal to its plain PyTorch version on the
   card: forward LAB, exact and approximate on f32 planes and exact on
   int32 planes (K1b, and K4's L alone), over all 2**24 u8 RGB triples (K4
   equal to K1b's L, K1b to K1 on the u8 grid, and both on int32 values
   outside [0, 255]), the surrogate probe K9 for both tables against the
   CPU's (its corrections printed; None fails), the probe-corrected
   forward LAB K8 ``_fast`` over all 2**24 u8 RGB triples (its mismatches
   against K1 printed), inverse LAB (u8 K3b, unit K3 = K3b / 255, and the
   gamma variant for each recipe gamma) over all 2**24 (L, a, b) triples,
   CLAHE apply and the fused CLAHE + inverse K5 (also against K2 then K3b)
   at 1080x1920 and 1079x1917 for the five clip limits, hysteresis at
   1080x1920 for 4 and 64 rounds, prefix sums on (6, 1080, 1920) rows,
   (7, 135, 1920) rows and (18, 1920) along the last axis (each kernel
   again below on the main path's own buffers); then the five forward-LAB
   kernels on ``LAB_SHAPES`` (pixel counts of every residue mod 4, below 4,
   1079x1917 and 1080x1920) with planes that are views 0-3 elements into
   their buffers (``LAB_OFFSETS``), one launch a call, and each one's
   registers, local bytes, resident blocks a SM and 1080p grid; the three
   inverse-LAB kernels over the same sweep, and CLAHE apply over
   ``CLAHE_SHAPES`` (every residue of H and W mod 8, planes smaller than a
   tile, 1079x1917, 1080x1920) for clip limits 1.5 and 4.0, tilings 8x8
   and 4x6, planes at offsets 0 and 1, values past both ends of [0, 255]
   and LUTs outside 0..255, one launch a call; K3, K3g, K3b and K2 twelve
   times each on 4096x4096 planes; their registers, blocks a SM, grid and
   K2's strips at 1080p (checked against ``kernels.clahe_strip_rows``);
   hysteresis for 0, 1, 4, 63, 64 and the most rounds a tiled plan fits on planes
   from 1x1 to 1080x1920, N from 1 to 8, and along a serpentine weak path
   longer than the rounds (exactly rounds + 1 cells lit), and the prefix
   sums over every axis length of ``SCAN_LENGTHS`` and width of
   ``SCAN_WIDTHS``, along the first, middle and last axis, with and without
   the leading zero, one launch a call (counted with ``torch.profiler``);
4. slice: three seeded synthetic 1920x1080 underwater frames, written with
   the port's PNG codec, through ``cli six``, ``cli six --fast``, ``cli
   enhance``, ``cli auto``, ``cli build-dataset``, ``cli build-dataset
   --fast`` and ``cli assess`` in-process on ``cuda``, ``[write]``
   (``write_slice``): ``cli enhance --device cuda --input frame0.png
   --output`` with ``.png``, ``.apng``, ``.jpg``, ``.bmp`` and ``.tif``,
   each file equal to the port's host encoder of the PNG output's u8
   frame (the ``.apng`` to the ``.png``), the BMP and the TIFF
   (``tiff.decode_tiff``) read back equal to it, the JPEG's PSNR and each
   encoder's host ms a 1080p frame printed, the host's zlib, the PNG's
   IDAT chunks and zlib header, and four seeded frames' PNGs held to
   cv2's SHA-256 (``PNG_SHA256``), ``[jpeg_prog]``
   (``jpeg_prog_slice``): that ``frame0.jpg`` transcoded losslessly into
   progressive files (``tests/torch_jpeg_scans.py``: cv2's script, and
   three-step successive approximation with restarts), each decoding
   bit-equal to it (host decode ms printed), ``cli six --device cuda`` on
   the first writing PNGs byte-equal to those of the baseline file with
   six exact's launches of one frame, ``[png16]`` (``png16_slice``):
   frame 0 as a 16-bit PNG with every filter type, the 16-bit TIFF
   cv2 writes, an 8-bit palette PNG and an 8-bit Adam7 PNG, each decoding
   equal to the array written (host ms printed), ``cli six --device
   cuda`` on the 16-bit PNG (values to 257) with each kernel call replayed
   bit-equal to its plain version, ``cli enhance --device cuda`` on it,
   and on a 270x480 crop of it ``six_strategy_tuple`` in each tier and
   ``enhance_batch`` card against CPU at the frame-0 gates,
   ``[jpeg_variants]`` (``jpeg_variants_slice``): from ``[write]``'s
   ``frame0.jpg``, a CMYK and a YCCK file (its own components, K a copy
   of Y) each decoding to OpenCV's CMYK formula on the planes written,
   lossless gray and RGB files (predictors 1 and 7, restarts) of the
   270x480 crop each decoding to the samples written, and arithmetic-coded
   sequential and progressive files each decoding equal to the Huffman
   file (at 1080p unless the sequential one took the host over 30 s;
   host ms printed), ``cli six --device cuda`` on the CMYK file with six
   exact's launches of one frame and each kernel call replayed bit-equal,
   ``[exif]`` (``exif_slice``): four 640x480 pairs with an EXIF
   Orientation (JPEGs of 6, PNGs of 8 in ``eXIf``) loaded by
   ``PairedImageDataset`` equal to their twins turned by ``np.rot90``, and
   one ``cli train-mlp --device cuda`` epoch on them launching K1b and K7
   once a cached image (each call replayed bit-equal),
   ``[tiff_variants]`` (``tiff_variants_slice``): frame 0 at 1080p as an
   orientation-3, a palette, a planar, a CMYK, a WhiteIsZero, an
   old-style LZW, a fill-order-2 and a JPEG-in-TIFF file
   (``tests/torch_tiff.py``), each decoding to the array it encodes as
   cv2 converts it (host ms printed), ``cli six --device cuda`` on the
   orientation-3 file with six exact's launches of one frame, each call
   replayed bit-equal, its PNGs byte-equal to six's on the frame's PNG,
   ``[tiff_layouts]`` (``tiff_layouts_slice``): frame 0 at 1080p as an
   LZW and a planar TIFF without StripByteCounts, a palette + alpha TIFF
   and a planar RGB and a CMYK JPEG-in-TIFF, each decoding to its closed
   form, ``cli six --device cuda`` on the LZW file as on the
   orientation-3 one (``six_twin``, which runs six on the frame's PNG
   once for every phase), ``[tiff_codecs]`` (``tiff_codecs_slice``):
   frame 0 at 1080p as CCITT RLE, RLEW, Group 3 1-D and 2-D and Group 4
   TIFFs of its bits and as LogL, LogLuv and SGILog24 LogLuv TIFFs of its
   X, Y, Z, each file and its decode in both modes held to the SHA-256 of
   cv2's reading (``TIFF_CODEC_SHA256``, host ms printed), ``cli six
   --device cuda`` on the Group 4 file as on the LZW one, against six on
   the same bits as a PNG, ``[bmp_variants]`` (``bmp_variants_slice``):
   frame 0 as an RLE8, a 4-bit and a 16-bit BMP (``tests/torch_bmp.py``),
   each decoding to its colours (host ms printed), ``[other_formats]``
   (``other_formats_slice``): frame 0 as PPM, PAM, PFM, Sun raster and
   HDR from the port's writers and as an ASCII P2, a 16-bit P6, a
   colormap Sun raster, an old-style RLE HDR and an interlaced GIF
   (``tests/torch_formats.py``), each decoding to its array (host ms
   printed), an RLE Sun raster refused as cv2 refuses it, ``cli six
   --device cuda`` on the PFM with six exact's launches of one frame,
   each call replayed bit-equal, its PNGs byte-equal to six's on the
   frame's PNG, and ``cli enhance`` HDR in and out on the card and the
   CPU within 1e-6, ``[tiff_samples]`` (``tiff_samples_slice``): frame 0
   as a float32 (predictor 3), a 12-bit, a signed 16-bit, a BigTIFF, a
   2x2 YCbCr, an 8-bit CIELab and a JPEG 2000-tagged TIFF
   (``tests/torch_tiff.py``), each decoding to its closed form (the
   YCbCr and CIELab files to their shape and dtype; host ms printed),
   ``cli six --device cuda`` on the float file with six exact's launches
   of one frame, each call replayed bit-equal, its PNGs byte-equal to
   six's on the frame's PNG, then the five
   CLAHE
   legs of each frame fused (``impl="fused"``, K5) against split, and each
   frame's u8 LAB (K1b; and through K8 ``_fast`` from the unit planes, the
   probe run anew) back to RGB (K3b), then ``cli fusion`` on the three
   frames as one batch (K1 and K3 once, K2 once a frame; the batch equal
   to three single-frame calls, the PNGs to the batch, frame 0 on the card
   within ``FUSION_MAX_ABS`` and ``FUSION_PSNR_DB`` of the CPU path), and
   the batch forms of CLAHE (``clahe_u8_batch`` with per-image limits,
   ``clahe_enhancement_planes_multi`` over the five recipe limits of the
   three frames, ``_clahe_lab_fused_batched``), each image bit-equal to
   the single-plane calls, then ``[predictor]``: ``cli enhance --model``
   at full width (VGG16 to conv4_3, hidden 256, input 224) on the three
   frames from an ``.npz`` written through ``models/bridge`` from seeded
   numpy parameters (``predictor_tree``), K1b and K7 once a frame, the
   PNGs equal to ``EnhancementPredictor.enhance_image`` on the card, each
   frame's parameters on the card within ``PREDICTOR_PARAM_MAX_ABS`` of
   the CPU path and its frame under equal parameters within
   ``PREDICTOR_FRAME_MAX_ABS`` (the phase runs under PyTorch's default of
   TF32 cuDNN convs, which the predictor turns off itself; a control with
   that guard taken away must move the parameters past the gate), and
   ``[selector_mlp]``: the MLP classifier fitted on the card and on the
   CPU from equal parameters on 2000 seeded rows of 79 features in five
   classes, ``predict_proba`` within ``MLP_PROBA_MAX_ABS`` (a control fit
   with TF32 matmuls must land past it), and both fit times, then
   ``[zoo]``: ``cli enhance --model X.npz --arch`` for ResNet18,
   EfficientNet b0 and b3 and ViT-B/16 at 224^2 (``ZOO_NETS``) from
   seeded trees (``seeded_tree``, BatchNorm statistics calibrated on the
   frames' inputs: ``calibrate_batch_norm``), no kernel launched, the PNGs
   equal to ``ZooPredictor.enhance_image``, each frame's heads on the card
   within ``ZOO_PARAM_MAX_REL`` of their range of the CPU path's and
   ``enhance_zoo`` within ``PREDICTOR_FRAME_MAX_ABS`` under PyTorch's TF32
   flags both on (a control with the nets' guard taken away must land past
   the gate), and ``[waternet]``: ``cli waternet`` on the three frames as
   one batch, f32 and ``--bf16``, from a seeded full-width tree (features
   128, FTU 32), the PNGs equal to ``waternet_enhance``, the batch within
   ``WATERNET_BATCH_MAX_ABS`` of single frames, bf16 within
   ``WATERNET_BF16_MAX_ABS`` of f32, frame 0 and the UNet on a 1078x1918
   crop within ``WATERNET_MAX_ABS`` of the CPU path (its seconds printed;
   a TF32 control must land past the gate), ``[dp]`` (``dp_slice``):
   data parallelism over a mesh rehearsed as 2 and 3 positions on the one
   card, ``run_data_parallel`` of ``auto_enhance_batch`` and of the label
   program on the three frames (2 positions pad them to 4),
   ``label_batch_dp`` and ``enhance_batch_dp``, each against its single
   call (``DP_*`` gates: features 1e-4 relative, scores 1e-3, the same
   winner unless the top two lie within 1e-2, the u8 winners equal,
   enhance 1e-6; the differing values printed), the launches a frame
   those of the single-device CLI runs, ``cli build-dataset`` and ``cli
   enhance --devices 1`` byte-equal to their runs without it,
   ``examples.main("all")`` and a ``profiling.trace`` of one frame on
   the card (``validate`` is not driven: no cv2 there), ``[spatial]``
   (``spatial_slice``): one seeded 2160x3840 frame's rows sharded over
   1, 2 and 8 mesh positions of the one card through
   ``six_strategy_spatial`` (cast code, airlight A and box equal at every
   count, the six outputs bit-equal to one position's; K1b and K3b 5 a
   block, K7 and K6 1 a block; ms a frame and peak memory at each count),
   ``ancuti_fusion_spatial`` on 2 and 8 against ``ancuti_fusion`` (1e-5
   and 55 dB), WaterNet's ``enhance_sharded`` at full width (rows on 2
   positions within ``WATERNET_MAX_ABS`` of the whole frame, a TF32
   control past it; the batch mode on two 1080p frames), and a 270x480
   frame on 2 positions card against CPU (all six within 1e-5), and
   ``[train]``
   (``train_slice``): ``cli train-mlp`` (79 -> 256, 3 blocks, 256^2),
   ``train-vgg`` in bf16 and ``--fp32`` (VGG16 to conv4_3, hidden 256,
   224^2, the seeded perceptual trunk) and ``train-zoo`` (ResNet18 for
   ``TRAIN_EPOCHS`` epochs, EfficientNet b0 and b3 and ViT-B/16 for one,
   224^2) on ``TRAIN_PAIRS`` seeded 640x480 pairs, batch 4, each writing
   ``best_model.npz``, ``final_model.npz`` and ``training_history.json``
   with finite losses; train-mlp's feature cache launches K1b and K7 once
   an image (replayed below), no other run launches a kernel; the cached
   features card against CPU within 1e-4 relative (plus 1e-5); each
   ``final_model.npz`` read back by ``EnhancementPredictor`` or
   ``ZooPredictor`` on the card with the trainer's ``load`` of it: the
   same leaves, the same heads (f32 runs: within
   ``PREDICTOR_PARAM_MAX_ABS`` or ``ZOO_PARAM_MAX_REL`` of a head's
   range); each f32 trainer's eval-mode loss and gradient on the card
   against the CPU's from equal parameters and batch within its
   ``TRAIN_GRAD_MAX_REL`` (a TF32 control must land past it), and
   ``[train_mesh]`` (``train_mesh_slice``): ``MLPTrainer``,
   ``ZooTrainer("vit")``, the f32 ``VGGTrainer`` and ``ZooTrainer``
   ResNet18 and EfficientNet b0 at published widths on the first 4 pairs,
   3 steps from one seed with dropout on, for mesh None (twice), one
   position and two positions of the one card: one position bit-equal to
   mesh None (step-1 loss, gradients and running statistics, the step
   losses, the parameters), two positions within the ``MESH_*`` gates of
   it (a control dropping the last position's sums and gradients, and for
   the BatchNorm nets one taking each position's statistics from its own
   rows, must fail the loss and gradient gates), the MLP's feature cache
   K1b and K7 once a pair, and ms a step for mesh None against two
   positions (``[train_mesh_timing]``, in turns); their
   outputs (18 + 18 + 3 PNGs and the CSV logs; 3 winners; the dataset
   CSV with 5 scores a row and ``dataset.pkl`` with three finite 79-value
   vectors; the assess table);
   the kernel launch counts of each run (counts set to 0 just before it,
   read just after; every kernel launched at least once); every kernel
   call of the runs but ``enhance`` replayed on its own inputs against the
   plain version, bit-equal; UIQM and UCIQE of each frame on the card
   within 1e-4 relative of the CPU path; frame 0 on the card against
   the port's CPU path: ``six`` in each tier (cast code, airlight A and
   final box equal; recipes 4-6 within 1e-6, 1-3 at >= 50 dB),
   ``enhance_batch`` within 1e-6, and the label program in each tier (the
   five strategies within 1e-6 or, dehazing, >= 50 dB; scores within 1e-3;
   the same winner unless the CPU's top two lie within 1e-2; the features
   within 1e-4 relative or 1e-5 absolute);
5. timing (CUDA events, medians after warm-up): ms per frame of
   ``six_strategy_tuple`` for each tier with its spread (the tiers timed
   in turns, twice each), each stage alone, the exact airlight's prefix
   sums, ms per frame of ``auto_enhance_batch`` and of the label program
   (strategies, scores and features; each part alone too) in each tier,
   one ``torch.profiler``
   frame of each of these (device busy and idle share, launches), ms per
   frame of ``ancuti_fusion`` (one frame a call, and the batch of three)
   with one profiled frame, ms per frame of the predictor
   (``enhance_image`` with its parameters predicted) and of its parts
   (the features, the preprocess, the VGG and MLP at 224^2, the 1080p
   enhance) with one profiled frame, ms per frame of each zoo predictor
   (``predict_parameters`` alone and ``enhance_image``) with one profiled
   frame, WaterNet's ms per frame in f32 and bf16 (a batch of three a
   call, one frame a call), one profiled batch and its peak device
   memory, each trainer's step (``train_timing``: ``TRAIN_STEPS`` steps
   on one batch: ms a step, images a second, peak memory, one profiled
   step; the batch's loss falls, the frozen convs stay, BatchNorm's
   statistics move) and the MLP's feature cache an image, a CLAHE
   leg fused against split (in turns), ms per frame of UIQM, UCIQE and the
   assess command's work (one profiled frame), and each kernel on the main
   path's inputs beside its bound, its plain version, a PyTorch copy of
   its planes (``copy_us``: ``torch.stack``, ``torch.addcmul`` or
   ``torch.clone``, ``COPY_FLOORS``) and, for the prefix sums,
   ``torch.cumsum``; hysteresis and the prefix sums also on their other
   main-path shapes; and ``[dp_timing]``: ms a frame of the label and auto
   programs on the three frames for mesh None against 3 positions on the
   one card, in turns.

The second-to-last line is the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it prints no
result and exits 2.
"""

from __future__ import annotations

import contextlib
import csv
import hashlib
import io
import json
import pickle
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
H, W = 1080, 1920
CLIPS = (3.0, 2.0, 4.0, 1.5, 3.5)  # the five CLAHE legs' clip limits
GAMMAS = (1.5, 1.2, 1.4)           # recipes 1, 5 and 6
FRAME_RUNS = 12
FRAME_WARMUP = 6
STAGE_RUNS = 9
PK = "underwater_image_enhancement_tpu/ops/pallas_kernels.py"
SRC = "underwater_image_enhancement_tpu_torch/csrc/"
# wrapper -> (CUDA source, TPU kernel it replaces, operations per element
# of its first input, plain version)
KERNELS = {
    "lab_forward_unit": (SRC + "lab_forward.cu", PK + ":906", 45,
                         "lab_forward_unit_plain"),
    "lab_forward_unit_approx": (SRC + "lab_forward.cu", PK + ":920", 105,
                                "lab_forward_unit_approx_plain"),
    "lab_forward_u8": (SRC + "lab_forward.cu", PK + ":889", 40,
                       "lab_forward_u8_plain"),
    "lab_forward_l_u8": (SRC + "lab_forward.cu", PK + ":898", 20,
                         "lab_forward_l_u8_plain"),
    "clahe_apply": (SRC + "clahe_apply.cu", PK + ":186", 30,
                    "clahe_apply_plain"),
    "lab_inverse_unit": (SRC + "lab_inverse.cu", PK + ":941", 60,
                         "lab_inverse_unit_plain"),
    "lab_inverse_unit_gamma": (SRC + "lab_inverse.cu", PK + ":948", 60,
                               "lab_inverse_unit_gamma_plain"),
    # one pass over the 3x3 neighbourhood a pixel: the least work of a
    # propagation (the rounds are this data's, not a bound)
    "hysteresis_propagate": (SRC + "hysteresis.cu", PK + ":75", 10,
                             "hysteresis_propagate_plain"),
    "sat_rows": (SRC + "scan.cu", PK + ":267", 1, "sat_rows_plain"),
    "lab_inverse_u8": (SRC + "lab_inverse.cu", PK + ":929", 60,
                       "lab_inverse_u8_plain"),
    # the blend (~30) and the inverse (~60)
    "clahe_lab_apply": (SRC + "clahe_lab_apply.cu", PK + ":344", 90,
                        "clahe_lab_apply_plain"),
    # K1's work plus three 4-step surrogates (~35 ops each) and fix-ups
    "lab_forward_unit_fast": (SRC + "lab_forward.cu", PK + ":912", 150,
                              "lab_forward_unit_fast_plain"),
    # timed as the cube-root probe it launches: ~50 f32 ops an index
    "surrogate_corrections": (SRC + "probe.cu", PK + ":529", 50,
                              "surrogate_corrections_plain"),
}
# the copy that moves a kernel's planes and computes nothing, timed beside
# it as the floor of its timing: ``torch.stack`` of its three input planes
# (3 in, 3 out), ``torch.addcmul`` of them (3 in, 1 out: K4) or
# ``torch.clone`` of its first (1 in, 1 out: K2)
COPY_FLOORS = {
    **dict.fromkeys(("lab_forward_unit", "lab_forward_unit_approx",
                     "lab_forward_unit_fast", "lab_forward_u8",
                     "lab_inverse_unit", "lab_inverse_unit_gamma",
                     "lab_inverse_u8", "clahe_lab_apply"), "stack"),
    "lab_forward_l_u8": "addcmul", "clahe_apply": "clone"}
# the wrapper whose calls are captured and replayed: all but the probe's,
# whose result is cached (its kernel launches on a device's first call)
CAPTURED = tuple(k for k in KERNELS if k != "surrogate_corrections")
NEW = ("lab_inverse_u8", "clahe_lab_apply", "lab_forward_unit_fast",
       "surrogate_corrections")
COMMON = {"clahe_apply": 15, "lab_inverse_unit": 6,
          "lab_inverse_unit_gamma": 9, **dict.fromkeys(NEW, 0)}
EXPECTED_FAST = {**COMMON, "lab_forward_unit": 0,
                 "lab_forward_unit_approx": 15, "lab_forward_u8": 0,
                 "lab_forward_l_u8": 0, "hysteresis_propagate": 3,
                 "sat_rows": 3}
# the label runs on three frames: the shared launches (the exact tier's K7
# and K6 add one call a descent level, checked apart)
LABEL_COMMON = {"lab_forward_unit_approx": 0, "clahe_apply": 3,
                "lab_inverse_unit": 3, "lab_inverse_unit_gamma": 0,
                **dict.fromkeys(NEW, 0)}
EXPECTED_LABEL = {
    # 5 brightness L planes (K4) and 5 metric Cannys (K7) a frame
    "auto": {**LABEL_COMMON, "lab_forward_unit": 3, "lab_forward_l_u8": 15,
             "lab_forward_u8": 0},
    # the features add one K1b and one Canny a frame
    "build": {**LABEL_COMMON, "lab_forward_unit": 3, "lab_forward_l_u8": 15,
              "lab_forward_u8": 3},
    "build_fast": {**LABEL_COMMON, "lab_forward_unit": 0,
                   "lab_forward_unit_approx": 3, "lab_forward_u8": 0,
                   "lab_forward_l_u8": 0, "hysteresis_propagate": 21,
                   "sat_rows": 3},
}
# this slice's runs on three frames: cli assess (K4 for the brightness,
# K7 for the edge density, K1b for UCIQE), the five CLAHE legs fused (K5
# once a leg), and the u8 LAB round trip with the probe-corrected forward
# LAB (K9 once: the first call on the card probes)
NONE = dict.fromkeys(KERNELS, 0)
EXPECTED_SLICE = {
    "assess": {**NONE, "lab_forward_l_u8": 3, "hysteresis_propagate": 3,
               "lab_forward_u8": 3},
    "clahe_fused": {**NONE, "lab_forward_unit": 15, "clahe_lab_apply": 15},
    "lab_u8": {**NONE, "lab_forward_u8": 3, "lab_forward_unit_fast": 3,
               "surrogate_corrections": 1, "lab_inverse_u8": 3},
    # cli fusion on the three frames, one batch: the forward and inverse
    # LAB fold the batch into rows (one launch each), CLAHE apply runs
    # once a frame
    "fusion": {**NONE, "lab_forward_unit": 1, "clahe_apply": 3,
               "lab_inverse_unit": 1},
    # the batch forms of CLAHE: clahe_u8_batch of the three L planes, the
    # five recipe limits of the three frames through
    # clahe_enhancement_planes_multi (15 legs), and the fused batch (K5)
    "clahe_u8_batch": {**NONE, "clahe_apply": 3},
    "clahe_multi": {**NONE, "lab_forward_unit": 1, "clahe_apply": 15,
                    "lab_inverse_unit": 1},
    "clahe_fused_batch": {**NONE, "clahe_lab_apply": 3},
    # cli enhance --model on the three frames: the 79 features' LAB (K1b)
    # and Canny (K7) once a frame; the VGG, the fusion MLP and the enhance
    # launch none of the package's kernels
    "predictor": {**NONE, "lab_forward_u8": 3, "hysteresis_propagate": 3},
}
# [train]: TRAIN_PAIRS seeded 640x480 pairs; cli train-mlp's feature cache
# launches K1b and K7 once a cached image, its steps none; the VGG and zoo
# trainers launch none of the package's kernels
TRAIN_PAIRS = 16
TRAIN_H, TRAIN_W = 480, 640
TRAIN_BATCH = 4
TRAIN_EPOCHS = 3
TRAIN_STEPS = 10
EXPECTED_SLICE["train_mlp"] = {**NONE, "lab_forward_u8": TRAIN_PAIRS,
                               "hysteresis_propagate": TRAIN_PAIRS}
# (label, cli flags, epochs) of the trainers driven through the CLI at
# full width: the MLP (79 -> 256, 3 blocks, 256^2), the VGG predictor
# (VGG16 to conv4_3, hidden 256, 224^2) in bf16 and f32, the zoo at 224^2
TRAIN_RUNS = (
    ("mlp", ["train-mlp"], TRAIN_EPOCHS),
    ("vgg_bf16", ["train-vgg", "--pretrained-vgg", "none"], TRAIN_EPOCHS),
    ("vgg_f32", ["train-vgg", "--pretrained-vgg", "none", "--fp32"],
     TRAIN_EPOCHS),
    ("resnet", ["train-zoo", "--model", "resnet", "--pretrained", "none"],
     TRAIN_EPOCHS),
    ("efficientnet_b0", ["train-zoo", "--model", "efficientnet",
                         "--variant", "b0", "--pretrained", "none"], 1),
    ("efficientnet_b3", ["train-zoo", "--model", "efficientnet",
                         "--variant", "b3", "--pretrained", "none"], 1),
    ("vit", ["train-zoo", "--model", "vit", "--pretrained", "none"], 1),
)
# the eval-mode loss's gradient on the card against the CPU's from equal
# parameters and batch, the largest difference over the largest gradient;
# each gate lies between the card's f32 reading and a TF32 control (the
# trainers' guard taken away, both TF32 flags on) that must fail it.  My
# chip call 4 of PR 13 ("NVIDIA H100 80GB HBM3, 700.00 W"), f32 / TF32:
# MLP 4.4e-7 / 1.0, VGG 6.0e-5 / 0.30, ResNet18 1.4e-3 / 6.3e-2,
# EfficientNet b0 9.2e-6 / 3.1e-2, b3 7.6e-6 / 2.5e-2, ViT 7.9e-7 /
# 1.3e-2
TRAIN_GRAD_MAX_REL = {"mlp": 1e-5, "vgg_f32": 1e-3, "resnet": 1e-2,
                      "efficientnet_b0": 5e-4, "efficientnet_b3": 5e-4,
                      "vit": 1e-5}
TRAIN_LOSS_MAX_REL = 1e-6
# the cached features, card against CPU (the label gate): relative, with
# an absolute floor for features near 0
TRAIN_FEATURE_REL, TRAIN_FEATURE_ABS = 1e-4, 1e-5
# the predictor's card against its CPU path: the parameters (the VGG in
# full f32 on both) and, under equal parameters, the enhanced frames.  The
# parameter gate lies between the card's f32 reading (max |d| 0.0 on the
# three frames on an H100) and what TF32 convs move there (4.58e-5 to
# 5.34e-5), so it fails the lower precision
PREDICTOR_PARAM_MAX_ABS = 1e-6
PREDICTOR_FRAME_MAX_ABS = 1e-5
PREDICTOR_HIDDEN = 256  # ImprovedVGGParameterNet's published width
# the selector MLP on the card against the CPU from equal parameters:
# 2000 rows of 79 features, five classes, the class's defaults (hidden
# 128, 200 full-batch Adam steps); cuBLAS and the CPU's BLAS sum in other
# orders and the steps compound it.  The gate lies between the card's f32
# reading (2.15e-6 on an H100) and what TF32 matmuls move there
# (5.42e-5), so it fails the lower precision
MLP_ROWS, MLP_CLASSES = 2000, 5
MLP_PROBA_MAX_ABS = 1e-5
# the zoo predictors at full width, 224^2: (label, --arch, --variant)
ZOO_NETS = (("resnet", "resnet", "b0"),
            ("efficientnet_b0", "efficientnet", "b0"),
            ("efficientnet_b3", "efficientnet", "b3"),
            ("vit", "vit", "b0"))
# their heads on the card against the CPU path, as a share of each head's
# range (``head_rel``); the gate lies between the card's f32 reading and
# what TF32 convs and matmuls move there
ZOO_PARAM_MAX_REL = 1e-5
# WaterNet (frame 0 at 1080p) and the UNet (1078x1918) on the card
# against the CPU path, between the f32 reading and the TF32 control;
# bf16 against f32 (the JAX suite's bound, tests/test_waternet.py:98); a
# batch against its frames one by one
WATERNET_MAX_ABS = 1e-5
WATERNET_BF16_MAX_ABS = 0.05
WATERNET_BATCH_MAX_ABS = 1e-6
# card against CPU gate of the fused frame (the JAX suite's 50 dB)
FUSION_PSNR_DB = 50.0
FUSION_MAX_ABS = 1e-5
# (clip limit, gamma) of the six recipes' five CLAHE legs
CLAHE_LEGS = ((3.0, 1.5), (2.0, None), (4.0, None), (1.5, 1.2), (3.5, 1.4))
# K7 calls beyond one a descent level: the metric (and feature) Cannys
EXTRA_CANNY = {"auto": 15, "build": 18}
F32_PEAK = 67e12  # H100 SXM f32 outside the tensor cores, ops per second
SPIN_CYCLES = 1_000_000  # a spin kernel around a counted call, about 0.5 ms
# the package's CUDA kernels by function name (instances counted apart)
OUR_KERNELS = ("lab_forward_kernel", "clahe_apply_kernel",
               "clahe_lab_apply_kernel", "lab_inverse_kernel",
               "surrogate_probe_kernel", "hysteresis_pack_kernel",
               "hysteresis_flood_kernel", "prefix_scan_kernel")
# K6's sweep (also the gpu tests'): every axis length up to the kernel's
# 2**16 and the widths around a slab's, each scanned along the first,
# middle and last axis
SCAN_LENGTHS = (1, 15, 16, 17, 255, 256, 257, 1080, 1920, 4097, 65536)
SCAN_WIDTHS = (1, 3, 31, 33, 1920)
# K7's sweep (also the gpu tests'): planes smaller than a tile, whole
# planes in one block, widths that are not a multiple of 32, N from 1 to 8
K7_SHAPES = ((1, 1080, 1920), (4, 540, 960), (8, 97, 131), (3, 61, 83),
             (2, 1, 1), (5, 20, 30), (1, 700, 1000), (4, 270, 480),
             (6, 33, 2000), (7, 135, 240))


# the forward-LAB kernels' sweep (also the gpu tests'): pixel counts of
# every residue mod 4 and below 4 (the vector path's scalar tail), and
# planes that are views starting 0-3 elements into their buffers, at equal
# and at unequal offsets (misaligned planes take the scalar loop)
LAB_WRAPPERS = ("lab_forward_unit", "lab_forward_unit_approx",
                "lab_forward_unit_fast", "lab_forward_u8", "lab_forward_l_u8")
LAB_SHAPES = ((1, 1), (1, 2), (1, 3), (1, 4), (2, 7), (3, 5), (33, 65),
              (97, 131), (1079, 1917), (1080, 1920))
LAB_OFFSETS = ((0, 0, 0), (1, 1, 1), (2, 2, 2), (3, 3, 3), (0, 1, 2),
               (3, 0, 1), (0, 0, 2))


# the inverse-LAB kernels' sweep (also the gpu tests'): the same shapes
# and offsets; K3g with gamma 1.4
INV_WRAPPERS = ("lab_inverse_unit", "lab_inverse_unit_gamma",
                "lab_inverse_u8")
# CLAHE apply's sweep (also the gpu tests'): every residue of H and W mod 8,
# planes smaller than a tile, 1079x1917 and 1080x1920, for each clip limit
# and (tiles_x, tiles_y); planes at offsets 0 and 1 elements into their
# buffers (offset 1 takes the scalar path), values past both ends of
# [0, 255], and LUTs with entries outside 0..255 (read from global memory)
CLAHE_SHAPES = tuple((64 + rh, 96 + rw) for rh in range(8)
                     for rw in range(8)) + ((1, 1), (2, 7), (7, 2), (3, 5),
                                            (1079, 1917), (1080, 1920))
CLAHE_CLIPS = (1.5, 4.0)
CLAHE_TILES = ((8, 8), (4, 6))
CLAHE_OFFSETS = (0, 1)


def lab_planes(torch, kname: str, shape, offsets, gen, dev):
    """Three planes of ``shape`` for LAB wrapper ``kname``, each a
    contiguous view ``offsets[k]`` elements into a buffer of its own: f32
    values in [-0.1, 1.1) for the forward unit-plane kernels, int32 in
    [-300, 600) for the forward u8 ones (both clipped by the kernels),
    int32 (L, a, b) in [-64, 320) for the inverse ones, with K3g's gamma
    after them."""
    n = shape[0] * shape[1]
    lo, hi = (-64, 320) if kname.startswith("lab_inverse") else (-300, 600)
    planes = []
    for off in offsets:
        if kname.startswith("lab_forward_unit"):
            buf = torch.rand(n + 3, generator=gen, device=dev) * 1.2 - 0.1
        else:
            buf = torch.randint(lo, hi, (n + 3,), generator=gen, device=dev,
                                dtype=torch.int32)
        planes.append(buf[off:off + n].view(shape))
    return tuple(planes) + ((1.4,) if kname == "lab_inverse_unit_gamma" else ())


def clahe_cases(torch, histeq, shape, gen, dev):
    """CLAHE apply's arguments on a plane of ``shape``: for each clip limit,
    tiling and offset, a smooth plane with noise whose LUTs come from its
    values clipped to [0, 255] while the kernel gets values in [-20, 280),
    and once a tiling the same with LUTs spread outside 0..255."""
    hh, ww = shape
    yy = torch.arange(hh, device=dev)[:, None]
    xx = torch.arange(ww, device=dev)[None, :]
    smooth = (yy * 255 // hh + xx * 64 // ww) % 256
    cases = []
    for off in CLAHE_OFFSETS:
        noise = torch.randint(-20, 21, (hh, ww), generator=gen, device=dev)
        buf = torch.empty(hh * ww + 1, dtype=torch.int32, device=dev)
        plane = buf[off:off + hh * ww].view(hh, ww)
        plane.copy_(smooth + noise)
        u8 = torch.clamp(plane, 0, 255)
        for tx, ty in CLAHE_TILES:
            for clip in CLAHE_CLIPS:
                luts, ya, xa, geo = histeq.clahe_prep(u8, clip, tx, ty)
                cases.append((plane, luts, ya, xa, *geo))
            cases.append((plane, (luts * 3 - 200).contiguous(), ya, xa, *geo))
    return cases


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(cond, msg) -> None:
    """A failed check ends the run (not an assert: those vanish under -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def hbm_bytes_per_s(name: str) -> float:
    """Published device-memory rate of the H100 variant the card names."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM, 80 GB HBM3


def synthetic_frame(seed: int, h: int = H, w: int = W) -> np.ndarray:
    """The test suite's underwater fixture (tests/conftest.py) at h x w
    (1080x1920 by default): blue-green cast, haze gradients, noise, on the
    u8 grid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    s = 160.0 / w
    base = np.stack([
        0.15 + 0.1 * np.sin(xx * s / 17.0) + 0.05 * (yy / h),
        0.45 + 0.2 * np.cos(yy * s / 23.0) + 0.1 * (xx / w),
        0.55 + 0.15 * np.sin((xx + yy) * s / 31.0),
    ], axis=-1)
    noise = rng.normal(0, 0.03, (h, w, 3)).astype(np.float32)
    img = np.clip(base + noise, 0.0, 1.0).astype(np.float32)
    return (np.floor(img * 255.0) / 255.0).astype(np.float32)


def seeded_tree(bridge, net, seed: int = 0) -> dict:
    """Seeded numpy parameters of the port's module ``net`` as a Flax
    variable tree: kernels normal of variance 1/fan_in (an attention
    projection's fan-in is its input width), biases and BatchNorm means
    normal(0, 0.01), the ViT's class token and position table
    normal(0, 0.02), scales and variances uniform in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in bridge.expected_shapes(net).items():
        *path, leaf = key.split("/")
        if leaf == "kernel":
            qkv = path[-1] in ("query", "key", "value")
            fan_in = shape[0] if qkv else np.prod(shape[:-1])
            v = rng.normal(0, np.sqrt(1.0 / fan_in), shape)
        elif leaf in ("bias", "mean"):
            v = rng.normal(0, 0.01, shape)
        elif leaf in ("cls", "pos"):
            v = rng.normal(0, 0.02, shape)
        else:
            v = rng.uniform(0.5, 1.5, shape)
        flat[key] = v.astype(np.float32)
    return bridge.unflatten(flat)


def calibrate_batch_norm(torch, net, x) -> None:
    """Each BatchNorm's running statistics set to those of its input in
    one forward of ``net`` on ``x``, as a trained net's are to its data:
    with random statistics a deep net's activations shrink block by block
    (EfficientNet's by 1e-6 over its 16 blocks) and its heads stop
    seeing the image.  ``net`` is left in eval mode."""
    bns = [m for m in net.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    if bns:
        momenta = [m.momentum for m in bns]
        for m in bns:
            m.momentum = 1.0
        net.train()
        with torch.no_grad():
            net(x)
        for m, mom in zip(bns, momenta):
            m.momentum = mom
    net.eval()


def head_rel(a: dict, b: dict) -> float:
    """The largest difference of two zoo parameter dicts, each head's as
    a share of its range."""
    from underwater_image_enhancement_tpu_torch.models.zoo import (
        SIX_PARAM_RANGES,
    )

    return max(abs(a[k] - b[k]) / (hi - lo)
               for k, (lo, hi) in SIX_PARAM_RANGES.items())


def predictor_tree(bridge, vgg, seed: int = 0) -> dict:
    """``seeded_tree`` of the full-width ImprovedVGGParameterNet (VGG16
    to conv4_3, hidden 256), its fusion layer's rows for the 79 features
    scaled by 1e-4, so that the heads do not saturate on features of up
    to 2e5 and every parameter moves."""
    tree = seeded_tree(
        bridge, vgg.ImprovedVGGParameterNet(hidden_dim=PREDICTOR_HIDDEN),
        seed)
    tree["params"]["Dense_0"]["kernel"][1024:] *= np.float32(1e-4)
    return tree


@contextlib.contextmanager
def tf32(torch, cudnn=None, matmul=None):
    """cuDNN's and cuBLAS's TF32 flags set for the block (None: left as
    found), and the values found before it restored after it."""
    found = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = found[0] if cudnn is None else cudnn
    torch.backends.cuda.matmul.allow_tf32 = (found[1] if matmul is None
                                             else matmul)
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = found


def event_ms(torch, fn, runs: int, warmup: int = 1, flush=None) -> list:
    """Device ms of each of ``runs`` calls of fn (CUDA events around the
    call, then a synchronise), after ``warmup`` calls.  ``flush`` (a
    tensor) is zeroed before each call so that it starts with a cold L2."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def spread(times) -> dict:
    q1, med, q3 = statistics.quantiles(times, n=4)
    return {"median": f"{med:.3f}", "quartiles": f"{q1:.3f},{q3:.3f}",
            "min_max": f"{min(times):.3f},{max(times):.3f}"}


def cuda_kernel_names(torch, fn, expect: int = 1, tries: int = 5) -> list:
    """Names of the CUDA kernels that one call of fn launches.  The
    profiler now and then misses the first kernel of a session
    (``tools/torch_profiler_loss.py``), so fn runs between two spin
    kernels (``torch.cuda._sleep``), which are not counted.  It never
    records more kernels than ran; a capture of fewer than ``expect`` is
    taken again, up to ``tries`` times."""
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            fn()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" not in e.name]
        if len(names) >= expect:
            break
    return names


def serpentine(torch, hh: int, ww: int, dev, gap: int = 2):
    """(strong, weak) (1, hh, ww) int32 planes: one strong seed at the head
    of a weak path that snakes over every `gap`-th row, joined at
    alternate ends.  Its cells lie one step apart along the path and
    farther apart across rows, so ``r`` rounds light exactly r + 1 of them
    while the path is longer than r."""
    s = torch.zeros((1, hh, ww), dtype=torch.int32)
    w = torch.zeros((1, hh, ww), dtype=torch.int32)
    y, right = 1, True
    while y + gap < hh - 1:
        w[0, y, 1:ww - 1] = 1
        w[0, y + 1:y + gap + 1, ww - 2 if right else 1] = 1
        y, right = y + gap, not right
    s[0, 1, 1] = 1
    return s.to(dev), w.to(dev)


def capture_calls(torch, kernels):
    """Wrap each kernel wrapper of ``kernels`` so that its arguments are
    kept (tensors cloned) while it runs as before.  The pipeline looks the
    wrappers up on the module at each call, so it goes through these.
    Returns (calls by wrapper name, a function that restores the module)."""
    calls = {name: [] for name in CAPTURED}
    originals = {name: getattr(kernels, name) for name in CAPTURED}

    def keep(name):
        def wrapper(*args):
            calls[name].append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args))
            return originals[name](*args)
        return wrapper

    for name in CAPTURED:
        setattr(kernels, name, keep(name))

    def restore():
        for name, fn in originals.items():
            setattr(kernels, name, fn)

    return calls, restore


def train_pairs(root: Path) -> tuple:
    """TRAIN_PAIRS seeded pairs at TRAIN_H x TRAIN_W written with the
    port's PNG codec: each reference a seeded clean frame, each raw frame
    that reference gamma-darkened (tests/test_train.py's recipe) under the
    synthetic underwater cast and haze.  Returns (raw, ref) folders."""
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    raw, ref = root / "train_raw", root / "train_ref"
    for i in range(TRAIN_PAIRS):
        rng = np.random.default_rng(1000 + i)
        yy, xx = np.mgrid[0:TRAIN_H, 0:TRAIN_W].astype(np.float32)
        clean = np.stack([0.5 + 0.3 * np.sin(xx / (20.0 + c * 7) + i)
                          * np.cos(yy / (30.0 + c * 5)) for c in range(3)],
                         axis=-1)
        clean = np.clip(clean + rng.normal(0, 0.05, clean.shape), 0.05, 0.95)
        cast = synthetic_frame(i, TRAIN_H, TRAIN_W)
        hazy = np.clip(0.6 * clean ** 1.4 + 0.4 * cast, 0, 1)
        uio.imwrite_unit(str(ref / f"pair{i:02d}.png"),
                         clean.astype(np.float32))
        uio.imwrite_unit(str(raw / f"pair{i:02d}.png"),
                         hazy.astype(np.float32))
    return raw, ref


def train_trainer(torch, label: str, device, seed: int = 0):
    """The trainer of a TRAIN_RUNS label as its CLI command builds it
    (full width, the seeded init), on ``device``."""
    import warnings

    from underwater_image_enhancement_tpu_torch.train import trainer as tr

    if label == "mlp":
        return tr.MLPTrainer(seed=seed, device=device)
    if label.startswith("vgg"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the seeded perceptual trunk
            return tr.VGGTrainer(
                compute_dtype="bfloat16" if label == "vgg_bf16"
                else "float32", pretrained_vgg=None, seed=seed, device=device)
    arch, _, variant = label.partition("_")
    return tr.ZooTrainer(arch, pretrained=None, variant=variant or "b0",
                         seed=seed, device=device)


def train_size(label: str) -> int:
    return 256 if label == "mlp" else 224


def train_batch(torch, label: str, ds, device, feats=None):
    """(idx, imgs, refs, feats) of the first TRAIN_BATCH pairs on
    ``device``: the MLP's 79 features or the VGG's basic ones as given
    (computed once, so that card and CPU see the same), else None."""
    pairs = [ds.load_pair(i) for i in range(TRAIN_BATCH)]
    imgs = torch.from_numpy(np.stack([p[0] for p in pairs])).to(device)
    refs = torch.from_numpy(np.stack([p[1] for p in pairs])).to(device)
    f = None if feats is None else feats.to(device)
    return np.arange(TRAIN_BATCH), imgs, refs, f


def train_loss(trainer, label, batch, train: bool):
    """The trainer's loss on a batch (its ``_loss_fn``; the features given
    where the trainer takes them)."""
    idx, imgs, refs, feats = batch
    if label == "mlp" or label.startswith("vgg"):
        return trainer._loss_fn(idx, imgs, refs, train, feats=feats)
    return trainer._loss_fn(idx, imgs, refs, train)


def eval_gradient(torch, tlayers, trainer, label, batch):
    """The eval-mode loss and its gradient with respect to the trainable
    parameters (``_eval``'s function under autograd), under the trainers'
    TF32 guard: (loss, [f64 numpy arrays])."""
    with tlayers.no_tf32():
        trainer.model.eval()
        loss = train_loss(trainer, label, batch, False)
        grads = torch.autograd.grad(loss, trainer.trainable,
                                    allow_unused=True)
    return float(loss.detach()), [np.zeros(0) if g is None else
                         g.detach().double().cpu().numpy() for g in grads]


def grad_rel(a: list, b: list) -> float:
    """The largest |a - b| over the largest |b|, over all leaves."""
    d = max(float(np.abs(x - y).max()) for x, y in zip(a, b) if y.size)
    return d / max(float(np.abs(y).max()) for y in b if y.size)


def train_slice(torch, dev, run_cli, captured_match, runs,
                device_args=()) -> dict:
    """[train]: cli train-mlp, train-vgg (bf16, and --fp32) and train-zoo
    (resnet for TRAIN_EPOCHS epochs, efficientnet b0 and b3 and vit for
    one) at full width on TRAIN_PAIRS seeded 640x480 pairs, in-process;
    train-mlp's run goes into ``runs`` (its K1b and K7 calls are replayed
    against their plain versions).  Then the gates: the cached features
    card against CPU, each final_model.npz through its predictor, each
    f32 trainer's eval-mode gradient card against CPU beside a TF32
    control.  ``device_args`` are added to each command (none: the card).
    Returns the datasets by image size."""
    from underwater_image_enhancement_tpu_torch.features.basic import (
        extract_basic_batch,
    )
    from underwater_image_enhancement_tpu_torch.features.full import (
        extract_all_features,
        extract_batch,
    )
    from underwater_image_enhancement_tpu_torch.models import bridge
    from underwater_image_enhancement_tpu_torch.models import layers as tlayers
    from underwater_image_enhancement_tpu_torch.models.predictor import (
        EnhancementPredictor,
        ZooPredictor,
    )
    from underwater_image_enhancement_tpu_torch.models.zoo import (
        SIX_PARAM_RANGES,
    )
    from underwater_image_enhancement_tpu_torch.train.data import (
        PairedImageDataset,
    )

    t_raw, t_ref = train_pairs(WORK)
    train_ds = {size: PairedImageDataset(str(t_raw), str(t_ref),
                                         target_size=size, augment=False)
                for size in (224, 256)}
    for label, argv, epochs in TRAIN_RUNS:
        out = WORK / f"train_{label}"
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            calls, launches, secs = run_cli(argv + [
                "--input", str(t_raw), "--reference", str(t_ref),
                "--output", str(out), "--epochs", str(epochs),
                "--batch-size", str(TRAIN_BATCH)] + list(device_args), True)
        text = printed.getvalue()
        files = {p.name for p in out.iterdir()}
        hist = json.loads((out / "training_history.json").read_text())
        check({"best_model.npz", "final_model.npz",
               "training_history.json"} <= files
              and len(hist["train_loss"]) == epochs
              and bool(np.isfinite(hist["train_loss"] + hist["val_loss"])
                       .all())
              and f"epoch {epochs}/{epochs}" in text,
              f"{' '.join(argv)}: files {files}, history {hist}, printed "
              f"{text!r}")
        if label == "mlp":
            check(captured_match(calls, launches)
                  and launches == EXPECTED_SLICE["train_mlp"],
                  f"train-mlp: launches {launches}")
            runs["train_mlp"] = (calls, launches, None)
        else:
            check(launches == NONE and not any(calls.values()),
                  f"{' '.join(argv)} launched kernels: {launches}")
        log("train", command=repr(" ".join(argv)), run=label, epochs=epochs,
            pairs=TRAIN_PAIRS, batch=TRAIN_BATCH, seconds=f"{secs:.2f}",
            train_loss=",".join(f"{v:.6f}" for v in hist["train_loss"]),
            val_loss=",".join(f"{v:.6f}" for v in hist["val_loss"]),
            launches=json.dumps({k: v for k, v in launches.items() if v},
                                separators=(",", ":")))
    # the cached features, card against CPU (the label gate)
    imgs256 = torch.from_numpy(np.stack([
        train_ds[256].load_pair(i)[0] for i in range(TRAIN_PAIRS)]))
    f_cpu = extract_batch(imgs256)
    f_card = extract_batch(imgs256.to(dev)).cpu()
    d_feat = (f_card - f_cpu).abs()
    check(bool((d_feat <= TRAIN_FEATURE_REL * f_cpu.abs()
                + TRAIN_FEATURE_ABS).all()),
          f"train-mlp's features: card vs CPU max |d| {float(d_feat.max())}")
    log("train", check="feature cache card vs CPU", images=TRAIN_PAIRS,
        max_abs=float(d_feat.max()),
        max_rel=float((d_feat / f_cpu.abs().clamp_min(1e-30)).max()),
        gate=f"<= {TRAIN_FEATURE_REL} rel + {TRAIN_FEATURE_ABS}")
    # final_model.npz through the predictors on the card: the same leaves
    # as the trainer's load of it, and (f32) the same heads
    x224 = torch.from_numpy(train_ds[224].load_pair(0)[0]).to(dev)
    for label, _, _ in TRAIN_RUNS[1:]:
        npz = str(WORK / f"train_{label}" / "final_model.npz")
        trainer = train_trainer(torch, label, dev)
        trainer.load(npz)
        if label.startswith("vgg"):
            pred = EnhancementPredictor(npz, pretrained_vgg=None, device=dev)
        else:
            arch, _, variant = label.partition("_")
            pred = ZooPredictor(npz, model_type=arch,
                                variant=variant or "b0", device=dev)
        a = bridge.flatten(bridge.to_flax(pred.model))
        b = bridge.flatten(bridge.to_flax(trainer.model))
        check(a.keys() == b.keys()
              and all(np.array_equal(a[k], b[k]) for k in a),
              f"{label}: final_model.npz reads back other leaves")
        # the predictor's preprocess (a u8 resize, then x * f32(1/255))
        # lies within an ulp of training's (x / 255 on the host); the heads
        # are compared on one input
        prep = trainer._backbone_input(x224)
        check(bool(torch.allclose(pred._preprocess(x224), prep, atol=1e-6)),
              f"{label}: the predictor's preprocess differs from training's")
        with torch.no_grad(), tlayers.no_tf32():
            if label.startswith("vgg"):
                feats = extract_all_features(x224)[None]
                raw = pred.model(prep[None], feats)
                mine = trainer.predict_params(x224[None], feats)
                d = max(float((raw[k] - mine[k]).abs().max()) for k in raw)
                gate = PREDICTOR_PARAM_MAX_ABS
            else:
                raw = pred.model(prep[None])
                mine = trainer.predict_params(x224[None])
                d = max(float((raw[k] - mine[k]).abs().max()) / (hi - lo)
                        for k, (lo, hi) in SIX_PARAM_RANGES.items())
                gate = ZOO_PARAM_MAX_REL
        # a bf16 trainer predicts in bf16, the predictor in f32: read only
        check(label == "vgg_bf16" or d <= gate,
              f"{label}: the predictor's heads differ from predict_params "
              f"by {d}")
        log("train", check="final_model.npz through the predictor",
            run=label, leaves=len(a), heads_max=d,
            gate="leaves equal" if label == "vgg_bf16" else f"<= {gate}")
    del trainer, pred
    # the eval-mode loss and its gradient, card against CPU from equal
    # parameters and batch, in f32 under the trainers' guard; the control
    # takes the guard away with both TF32 flags on and must fail the gate
    failed = []
    for label, _, _ in TRAIN_RUNS:
        if label == "vgg_bf16":
            continue
        gate = TRAIN_GRAD_MAX_REL[label]
        ds = train_ds[train_size(label)]
        imgs = torch.from_numpy(np.stack([ds.load_pair(i)[0]
                                          for i in range(TRAIN_BATCH)]))
        feats = (extract_batch(imgs) if label == "mlp" else
                 extract_basic_batch(imgs) if label.startswith("vgg")
                 else None)
        t_gpu = train_trainer(torch, label, dev)
        t_cpu = train_trainer(torch, label, "cpu")
        b_gpu = train_batch(torch, label, ds, dev, feats)
        b_cpu = train_batch(torch, label, ds, "cpu", feats)
        # BatchNorm's running statistics set to the batch's (one train
        # forward with momentum 1 on the CPU, carried to the card): fresh
        # statistics shrink EfficientNet's activations until its heads
        # no longer see the image
        bns = [m for m in t_cpu.model.modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
        if bns:
            for m in bns:
                m.momentum = 1.0
            with torch.no_grad():
                t_cpu.model.train()
                train_loss(t_cpu, label, b_cpu, True)
            for m in bns:
                m.momentum = 0.01
            bridge.load_flax(t_gpu.model, bridge.to_flax(t_cpu.model))
        l_g, g_g = eval_gradient(torch, tlayers, t_gpu, label, b_gpu)
        t0 = time.perf_counter()
        l_c, g_c = eval_gradient(torch, tlayers, t_cpu, label, b_cpu)
        cpu_s = time.perf_counter() - t0
        d, dl = grad_rel(g_g, g_c), abs(l_g / l_c - 1)
        guard = tlayers.no_tf32
        tlayers.no_tf32 = contextlib.nullcontext
        try:
            with tf32(torch, cudnn=True, matmul=True):
                _, g_t = eval_gradient(torch, tlayers, t_gpu, label, b_gpu)
        finally:
            tlayers.no_tf32 = guard
        d_t = grad_rel(g_t, g_c)
        log("train", check="eval gradient card vs CPU", run=label,
            loss=l_g, loss_rel=dl, grad_rel=d, tf32_grad_rel=d_t,
            gate=f"<= {gate}, loss <= {TRAIN_LOSS_MAX_REL}",
            params=sum(g.size for g in g_c), cpu_s=f"{cpu_s:.2f}")
        if not (d <= gate and dl <= TRAIN_LOSS_MAX_REL):
            failed.append(f"{label}: eval gradient card vs CPU {d} of the "
                          f"largest, loss {dl}")
        if not d_t > gate:
            failed.append(f"{label}: TF32 moved the gradient by {d_t} of "
                          f"the largest, within the gate {gate}: it cannot "
                          "tell TF32 from f32")
        del t_gpu, t_cpu
    check(not failed, "; ".join(failed))
    check(torch.backends.cudnn.allow_tf32 is False
          and torch.backends.cuda.matmul.allow_tf32 is False,
          "train: the TF32 settings were not restored")
    return train_ds


def train_timing(torch, dev, train_ds, profile_frame, smi: str) -> None:
    """Each trainer: TRAIN_STEPS steps on one repeated batch of
    TRAIN_BATCH (CUDA events a step; the median and quartiles of the steps
    after the first), images a second, the peak device memory above what
    was live before them, one profiled step (device busy, idle share,
    launches, none of the package's kernels); the batch's training loss
    without dropout before and after the steps must fall, the frozen VGG
    convs stay bit for bit, BatchNorm's running statistics move; the
    MLP's feature cache in ms an image."""
    from underwater_image_enhancement_tpu_torch.models import bridge
    from underwater_image_enhancement_tpu_torch.models import layers as tlayers

    for label, _, _ in TRAIN_RUNS:
        trainer = train_trainer(torch, label, dev)
        ds = train_ds[train_size(label)]
        extra = {}
        if label == "mlp":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.cache_features(ds, log=lambda *_: None)
            torch.cuda.synchronize()
            extra["cache_features_ms_per_image"] = (
                f"{(time.perf_counter() - t0) * 1e3 / TRAIN_PAIRS:.3f}")
        idx, imgs, refs, _ = train_batch(torch, label, ds, dev)
        before = {k: v.copy() for k, v in
                  bridge.flatten(bridge.to_flax(trainer.model)).items()}

        def batch_loss():
            """The batch's training loss (batch statistics) without
            dropout, the objective the steps descend."""
            drop, tlayers.dropout = tlayers.dropout, lambda x, *a, **k: x
            try:
                with torch.no_grad(), tlayers.no_tf32():
                    trainer.model.train()
                    return float(train_loss(trainer, label,
                                            (idx, imgs, refs, None), True))
            finally:
                tlayers.dropout = drop

        loss0 = batch_loss()
        bridge.load_flax(trainer.model, bridge.unflatten(before))
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        marks, losses = [], []
        for _ in range(TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(trainer._step(idx, imgs, refs))
            end.record()
            marks.append((start, end))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - live
        ms = [a.elapsed_time(b) for a, b in marks]
        losses = torch.stack(losses).tolist()
        after = bridge.flatten(bridge.to_flax(trainer.model))
        loss1 = batch_loss()
        stats = [k for k in before if k.startswith("batch_stats/")]
        wall, busy, ev, ours = profile_frame(
            lambda: trainer._step(idx, imgs, refs))
        steady = ms[1:]
        med = statistics.median(steady)
        log("train_step", run=label, batch=TRAIN_BATCH,
            size=train_size(label),
            **{f"ms_{k}": v for k, v in spread(steady).items()},
            first_ms=f"{ms[0]:.3f}", images_per_s=f"{TRAIN_BATCH * 1e3 / med:.1f}",
            peak_gb=f"{peak / 1e9:.3f}", live_gb=f"{live / 1e9:.3f}",
            profiled_wall_ms=f"{wall:.3f}",
            device_busy_ms=f"{busy:.3f}" if ev else "not measured",
            device_idle_share=(f"{1 - busy / wall:.3f}" if ev
                               else "not measured"),
            device_launches=len(ev), batch_loss=f"{loss0:.6f}->{loss1:.6f}",
            step_losses=",".join(f"{v:.5f}" for v in losses),
            bn_leaves=len(stats), **extra, card=repr(smi))
        check(bool(np.isfinite(losses).all()) and loss1 < loss0,
              f"{label}: the batch's training loss {loss0} -> {loss1}, "
              f"steps {losses}")
        if label.startswith("vgg"):
            check(all(np.array_equal(after[k], before[k]) for k in before
                      if k.startswith("params/vgg/conv")
                      and int(k.split("/")[2][4:]) < 8),
                  f"{label}: a frozen conv moved")
        check(not stats or any(not np.array_equal(after[k], before[k])
                               for k in stats),
              f"{label}: BatchNorm's running statistics did not move")
        check(not ours, f"{label}: a step launched {ours}")
        del trainer


# [write]: cli enhance --output NAME.<suffix> for the writers but PNG's
WRITE_SUFFIXES = (".apng", ".jpg", ".bmp", ".tif")
WRITE_ENCODE_RUNS = 3
# the SHA-256 of cv2.imencode(".png") (OpenCV 5.0.0, libpng 1.6.58) of
# each of png_probe_frames(): the card's host has no cv2, and its zlib
# must give cv2's bytes
PNG_SHA256 = {
    "rgb1080_smooth":
        "b596b3fbbccbf7e7b5c667dcbd62159547b302f830209fead7600a75be9fbf93",
    "rgb1080_random":
        "a9c3332f7c7a59147e26db6b961f25e507b97c03eaf595ee359acd258267c91a",
    "gray5x7_smooth":
        "d3126060d770368b6f2015d6dbef2037ec5bad3a8f35a1fbcec7c1e4619ba5e6",
    "gray5x7_random":
        "9add509e886100fc12fa7cad1428bbbc67c2dd2a7d82fdc284e908691a18be84",
}


def png_probe_frames() -> dict:
    """1080p RGB and 5x7 gray frames, smooth (integer ramps) and random
    (a 64-bit mix of each byte's index, seeded), made on the host in
    integer arithmetic that every numpy computes alike."""
    frames = {}
    for name, (h, w, c) in (("rgb1080", (H, W, 3)), ("gray5x7", (5, 7, 1))):
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = np.stack([(xx * 7 + yy * (3 + k)) // 5 for k in range(c)],
                          -1) % 256
        x = np.arange(h * w * c, dtype=np.uint64) + np.uint64(26)
        x *= np.uint64(0x9E3779B97F4A7C15)
        x ^= x >> np.uint64(31)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(29)
        for kind, a in (("smooth", smooth),
                        ("random", (x >> np.uint64(56)).reshape(h, w, c))):
            a = a.astype(np.uint8)
            frames[f"{name}_{kind}"] = a[..., 0] if c == 1 else a
    return frames


def png_idat(data: bytes) -> tuple:
    """(IDAT chunk sizes, the zlib stream's first two bytes) of a PNG."""
    sizes, head, at = [], b"", 8
    while at < len(data):
        n = int.from_bytes(data[at:at + 4], "big")
        if data[at + 4:at + 8] == b"IDAT":
            sizes.append(n)
            head = head or data[at + 8:at + 10]
        at += 12 + n
    return sizes, head


def write_slice(torch, run_cli, src: Path, smi: str) -> None:
    """[write]: ``cli enhance --device cuda --input frame0.png --output``
    with ``.png``, then each of ``WRITE_SUFFIXES``: each file's bytes equal
    the port's host encoder applied to the u8 frame of the ``.png``
    output, the ``.apng`` file the ``.png`` file's; the BMP and the TIFF
    read back by the port's decoders equal that frame (the host ms of the
    decode printed), the JPEG's PSNR against it is printed; the host ms to
    encode the 1080p frame (the median of ``WRITE_ENCODE_RUNS``).  The
    host's zlib version, the PNG's IDAT chunk sizes (8192 bytes but the
    last) and zlib header; ``png_probe_frames`` encoded to cv2's bytes
    (``PNG_SHA256``)."""
    import hashlib
    import zlib

    from underwater_image_enhancement_tpu_torch.utils import io as uio
    from underwater_image_enhancement_tpu_torch.utils.bmp import decode_bmp
    from underwater_image_enhancement_tpu_torch.utils.jpeg import (
        decode_jpeg,
    )
    from underwater_image_enhancement_tpu_torch.utils.tiff import (
        decode_tiff,
    )

    out = WORK / "write"
    for suffix in (".png",) + WRITE_SUFFIXES:
        _, launches, secs = run_cli(
            ["enhance", "--device", "cuda", "--input",
             str(src / "frame0.png"), "--output",
             str(out / f"frame0{suffix}")], False)
        check(not any(launches.values()),
              f"enhance --output {suffix} launched kernels: {launches}")
    u8 = uio.imread_u8(str(out / "frame0.png"))
    check(u8 is not None and u8.shape == (H, W, 3), "write: the PNG output")
    for suffix in (".png",) + WRITE_SUFFIXES:
        data = (out / f"frame0{suffix}").read_bytes()
        encode = uio.encoder_for(str(out / f"frame0{suffix}"))
        ms = []
        for _ in range(WRITE_ENCODE_RUNS):
            t0 = time.perf_counter()
            want = encode(u8)
            ms.append((time.perf_counter() - t0) * 1e3)
        check(data == want, f"write: the {suffix} file is not the port's "
              f"encoding of the PNG output's frame ({len(data)} bytes vs "
              f"{len(want)})")
        extra = {}
        if suffix in (".bmp", ".tif"):
            decode = decode_bmp if suffix == ".bmp" else decode_tiff
            t0 = time.perf_counter()
            back = decode(data)
            extra["decode_host_ms"] = f"{(time.perf_counter() - t0) * 1e3:.1f}"
            check(np.array_equal(back, u8),
                  f"write: the {suffix} file reads back other pixels")
            extra["reads_back"] = "equal"
        elif suffix == ".jpg":
            back = torch.from_numpy(decode_jpeg(data)) / 255.0
            extra["psnr_db"] = f"{psnr_db(back, torch.from_numpy(u8) / 255.0):.3f}"
        elif suffix == ".apng":
            check(data == (out / "frame0.png").read_bytes(),
                  "write: the .apng file is not the .png file's bytes")
            extra["equal_to"] = "frame0.png"
        log("write", command=f"'enhance --output frame0{suffix}'",
            bytes=len(data), equal_to_host_encoder=True,
            encode_host_ms=f"{statistics.median(ms):.1f}",
            frame=f"{W}x{H}", **extra, card=repr(smi))
    sizes, head = png_idat((out / "frame0.png").read_bytes())
    check(sizes and all(n == 8192 for n in sizes[:-1]) and sizes[-1] <= 8192,
          f"write: frame0.png's IDAT chunks {sizes}")
    check(head == b"\x78\x01", f"write: frame0.png's zlib header {head!r}")
    log("write", zlib_runtime=zlib.ZLIB_RUNTIME_VERSION,
        zlib_built=zlib.ZLIB_VERSION, idat_chunks=len(sizes),
        idat_sizes=f"{sizes[0]}x{len(sizes) - 1}+{sizes[-1]}",
        zlib_header=head.hex())
    for name, frame in png_probe_frames().items():
        t0 = time.perf_counter()
        data = uio.encode_png(frame)
        ms = (time.perf_counter() - t0) * 1e3
        digest = hashlib.sha256(data).hexdigest()
        check(digest == PNG_SHA256[name],
              f"write: {name} encodes to other bytes than cv2's ({digest})")
        log("write", png_probe=name, shape="x".join(map(str, frame.shape)),
            bytes=len(data), sha256_equal_to_cv2=True,
            encode_host_ms=f"{ms:.1f}", card=repr(smi))


# [jpeg_prog]: [write]'s frame0.jpg as progressive files (the tests'
# lossless transcoder), each decoding bit-equal to the baseline file, and
# cli six on one reading as it does on the baseline file
JPEG_PROG_SCRIPTS = (("cv2", 0), ("three_step", 7))
# six exact's launches on one frame (a third of the three frames'), the
# descent's d levels apart: K7 d times, K6 d + 1 times
SIX_ONE_FRAME = {**{k: v // 3 for k, v in COMMON.items()},
                 "lab_forward_unit": 5, "lab_forward_unit_approx": 0,
                 "lab_forward_u8": 0, "lab_forward_l_u8": 0}


def jpeg_prog_slice(torch, run_cli, smi: str) -> None:
    """[jpeg_prog]: ``tests/torch_jpeg_scans.transcode`` writes
    ``[write]``'s 1080p ``frame0.jpg`` (the port's baseline encoder) as
    progressive files, one for each of ``JPEG_PROG_SCRIPTS`` (cv2's script;
    successive approximation in three steps with a restart every 7
    MCUs).  Each decodes bit-equal to the baseline file (the host ms of
    each decode printed).  ``cli six --device cuda`` on the first writes
    PNGs byte-equal to those it writes for the baseline file, with six
    exact's launches on one frame (``SIX_ONE_FRAME``, K7 d and K6 d + 1
    times, the same d for both)."""
    from tests import torch_jpeg_scans
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        SIX_ORDER,
    )
    from underwater_image_enhancement_tpu_torch.utils.jpeg import (
        decode_jpeg,
    )

    t_phase = time.perf_counter()
    base = (WORK / "write" / "frame0.jpg").read_bytes()
    t0 = time.perf_counter()
    want = decode_jpeg(base)
    log("jpeg_prog", file="baseline", bytes=len(base),
        decode_host_ms=f"{(time.perf_counter() - t0) * 1e3:.1f}",
        frame=f"{W}x{H}", card=repr(smi))
    check(want.shape == (H, W, 3), f"jpeg_prog: baseline {want.shape}")
    progs = {}
    for name, restart in JPEG_PROG_SCRIPTS:
        t0 = time.perf_counter()
        data = torch_jpeg_scans.transcode(
            base, torch_jpeg_scans.script(name, 3), restart)
        t_code = time.perf_counter() - t0
        check(data[:data.index(b"\xff\xda")].find(b"\xff\xc2") > 0,
              f"jpeg_prog: {name} is not a progressive file")
        t0 = time.perf_counter()
        got = decode_jpeg(data)
        ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(got, want),
              f"jpeg_prog: {name} (restart {restart}) decodes to other "
              f"pixels than the baseline file")
        progs[name] = data
        log("jpeg_prog", file=name, restart=restart, bytes=len(data),
            scans=data.count(b"\xff\xda"), decode_host_ms=f"{ms:.1f}",
            transcode_host_s=f"{t_code:.2f}", equal_to_baseline=True,
            card=repr(smi))
    outs = {}
    for label, data in (("baseline", base), ("progressive", progs["cv2"])):
        src = WORK / "jpeg_prog" / label
        src.mkdir(parents=True, exist_ok=True)
        (src / "frame0.jpg").write_bytes(data)
        out = WORK / "jpeg_prog" / f"six_{label}"
        _, launches, secs = run_cli(["six", "--device", "cuda", "--input",
                                     str(src), "--output", str(out)], False)
        d = launches["hysteresis_propagate"]
        check(all(launches[k] == v for k, v in SIX_ONE_FRAME.items())
              and d >= 1 and launches["sat_rows"] == d + 1,
              f"jpeg_prog: six on the {label} file launched {launches}")
        pngs = {p.name: p.read_bytes() for p in sorted(out.glob("*.png"))}
        check(sorted(pngs) == sorted(f"frame0_{n}.png" for n in SIX_ORDER),
              f"jpeg_prog: six outputs {sorted(pngs)}")
        outs[label] = (pngs, launches)
        log("jpeg_prog", command=f"'six --device cuda' ({label})",
            seconds=f"{secs:.2f}",
            launches=json.dumps(launches, separators=(",", ":")))
    check(outs["progressive"] == outs["baseline"],
          "jpeg_prog: six writes other PNGs (or launches) for the "
          "progressive file than for the baseline file")
    log("jpeg_prog", six_outputs="byte-equal", launches="equal",
        seconds=f"{time.perf_counter() - t_phase:.1f}")


# [png16]: 16-bit PNG and TIFF input, and palette and Adam7 PNG, from
# frame 0; six and enhance on the 16-bit file, card against CPU on a crop
PNG16_CROP = (270, 480)


def sixteen_bit(u8: np.ndarray, seed: int) -> np.ndarray:
    """A 16-bit frame of a u8 one, the recipe of
    ``tests/test_torch_read16.frame16``: the samples cubed over the 16-bit
    range with seeded low bits, so that a part of the frame reads under 1
    and the rest over it (to 257)."""
    u = u8.astype(np.float64) / 255.0
    v = (np.round(u ** 3 * 65535)
         + np.random.default_rng(seed).integers(-128, 128, u.shape))
    return np.clip(v, 0, 65535).astype(np.uint16)


def palette_332(u8: np.ndarray) -> tuple:
    """(indices, palette): the frame quantised to 3-3-2 bits of R, G, B,
    and the 256 colours of those indices."""
    idx = (u8[..., 0] >> 5 << 5) | (u8[..., 1] >> 5 << 2) | (u8[..., 2] >> 6)
    i = np.arange(256)
    pal = np.stack([(i >> 5) * 255 // 7, (i >> 2 & 7) * 255 // 7,
                    (i & 3) * 85], -1).astype(np.uint8)
    return idx, pal


def png16_slice(torch, run_cli, captured_match, replay, smi: str) -> None:
    """[png16]: from 1080p frame 0, a 16-bit RGB PNG whose rows cycle
    through the five filter types (``tests/torch_png.py``), the 16-bit
    LZW + predictor TIFF ``cv2.imwrite`` writes (``tiff.encode_tiff``), an
    8-bit palette PNG and an 8-bit Adam7 PNG; each decodes equal to the
    array written (host ms of each write and decode printed).  ``cli six
    --device cuda`` on the 16-bit PNG (values to 257) with six exact's
    launches of one frame (``SIX_ONE_FRAME``), each kernel call captured
    and replayed bit-equal to its plain version; ``cli enhance --device
    cuda`` on it (the ``hist`` stretch, which rounds the off-grid values
    and clips those over 1).  On a ``PNG16_CROP`` crop of the 16-bit
    frame, ``six_strategy_tuple`` in each tier and ``enhance_batch`` on
    the card against the port's CPU path at the gates of the frame-0
    check (cast code, airlight A and box equal; recipes 4-6 and enhance
    within 1e-6, 1-3 at >= 50 dB)."""
    from tests import torch_png
    from underwater_image_enhancement_tpu_torch.ops import airlight
    from underwater_image_enhancement_tpu_torch.ops.layout import split_planes
    from underwater_image_enhancement_tpu_torch.pipeline import (
        cast as cast_mod,
    )
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        SIX_ORDER,
        enhance_batch,
        six_strategy_tuple,
    )
    from underwater_image_enhancement_tpu_torch.utils import io as uio
    from underwater_image_enhancement_tpu_torch.utils.tiff import (
        decode_tiff,
        encode_tiff,
    )

    t_phase = time.perf_counter()
    out = WORK / "png16"
    (out / "in").mkdir(parents=True, exist_ok=True)
    u8 = uio.imread_u8(str(WORK / "in" / "frame0.png"))
    v16 = sixteen_bit(u8, 16)
    idx, pal = palette_332(u8)
    files = (
        ("rgb16.png", lambda: torch_png.encode(
            v16, 16, filters=lambda y: y % 5), v16, uio.decode_png),
        ("rgb16.tif", lambda: encode_tiff(v16), v16, decode_tiff),
        ("palette8.png", lambda: torch_png.encode(idx, 8, 3, palette=pal),
         pal[idx], uio.decode_png),
        ("adam7.png", lambda: torch_png.encode(u8, 8, interlace=True), u8,
         uio.decode_png))
    for name, write, want, decode in files:
        t0 = time.perf_counter()
        data = write()
        t_write = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got = decode(data)
        t_read = (time.perf_counter() - t0) * 1e3
        check(got.dtype == want.dtype and np.array_equal(got, want),
              f"png16: {name} decodes to other samples than were written")
        (out / name).write_bytes(data)
        log("png16", file=name, bytes=len(data), frame=f"{W}x{H}",
            dtype=str(want.dtype), write_host_ms=f"{t_write:.1f}",
            decode_host_ms=f"{t_read:.1f}", equal_to_written=True,
            card=repr(smi))
    unit = uio.imread_unit(str(out / "rgb16.png"))
    check(np.array_equal(unit, v16 / np.float32(255))
          and 1.0 < float(unit.max()) <= 257.0,
          f"png16: imread_unit of the 16-bit PNG, max {float(unit.max())}")
    (out / "in" / "frame0_16.png").write_bytes((out / "rgb16.png")
                                               .read_bytes())
    calls, launches, secs = run_cli(
        ["six", "--device", "cuda", "--input", str(out / "in"), "--output",
         str(out / "six")], True)
    d = launches["hysteresis_propagate"]
    check(all(launches[k] == v for k, v in SIX_ONE_FRAME.items())
          and d >= 1 and launches["sat_rows"] == d + 1,
          f"png16: six on the 16-bit file launched {launches}")
    check(captured_match(calls, launches),
          f"png16: captured calls {[len(v) for v in calls.values()]} vs "
          f"launches {launches}")
    pngs = sorted(p.name for p in (out / "six").glob("*.png"))
    check(pngs == sorted(f"frame0_16_{n}.png" for n in SIX_ORDER),
          f"png16: six outputs {pngs}")
    replayed = {}
    for kname, arglists in calls.items():
        for k, args in enumerate(arglists):
            replay(kname, args, f"png16 six call {k} (values to 257)")
        if arglists:
            replayed[kname] = len(arglists)
    torch.cuda.synchronize()
    log("png16", command="'six --device cuda' (16-bit PNG)",
        seconds=f"{secs:.2f}",
        launches=json.dumps(nonzero(launches), separators=(",", ":")),
        replayed_bit_equal=json.dumps(replayed, separators=(",", ":")))
    _, launches, secs = run_cli(
        ["enhance", "--device", "cuda", "--input", str(out / "in"),
         "--output", str(out / "enhance")], False)
    img = uio.imread_u8(str(out / "enhance" / "frame0_16_enhanced.png"))
    check(img is not None and img.shape == (H, W, 3)
          and not any(launches.values()),
          f"png16: enhance on the 16-bit file: {launches}")
    log("png16", command="'enhance --device cuda' (16-bit PNG, hist)",
        seconds=f"{secs:.2f}")
    h, w = PNG16_CROP
    crop = np.ascontiguousarray(unit[:h, :w])
    check(float(crop.max()) > 1.0 and float(crop.min()) < 1.0,
          "png16: the crop holds no values past 1 (or none under it)")
    for tier, fast in (("exact", False), ("fast", True)):
        outs_g, code_g = six_strategy_tuple(crop, fast=fast, device="cuda")
        outs_c, code_c = six_strategy_tuple(crop, fast=fast, device="cpu")
        check(int(code_g) == int(code_c),
              f"png16 {tier}: cast code card {int(code_g)} vs CPU "
              f"{int(code_c)}")
        desc = (airlight.quadtree_airlight_planes if fast
                else airlight.quadtree_airlight_exact_planes)
        kw = {"edge_iters": 4} if fast else {}
        air = []
        for dev in ("cuda", "cpu"):
            corr, _ = cast_mod.detect_and_correct(
                torch.from_numpy(crop).to(dev))
            air.append(desc(split_planes(corr), return_box=True, **kw))
        (A_g, box_g), (A_c, box_c) = air
        check(box_g == box_c and torch.equal(A_g.cpu(), A_c),
              f"png16 {tier}: airlight card {A_g.tolist()} {box_g} vs CPU "
              f"{A_c.tolist()} {box_c}")
        diffs = {}
        for k, n in enumerate(SIX_ORDER):
            a, b = outs_g[k].cpu().double(), outs_c[k].double()
            check(a.shape == (h, w, 3) and bool(torch.isfinite(a).all()),
                  f"png16 {tier} {n}: shape {tuple(a.shape)} or non-finite")
            diffs[n] = float((a - b).abs().max())
            if k >= 3:
                check(diffs[n] <= 1e-6,
                      f"png16 {tier} {n}: card vs CPU {diffs[n]} > 1e-6")
            else:
                check(psnr_db(a, b) >= 50.0,
                      f"png16 {tier} {n}: card vs CPU "
                      f"{psnr_db(a, b):.1f} dB < 50")
        log("png16", card_vs_cpu=tier, crop=f"{w}x{h}", code=int(code_c),
            A=A_c.tolist(), box=box_c,
            max_abs=json.dumps(diffs, separators=(",", ":")))
    e_g = enhance_batch(crop[None], 10.0, 90.0, 0.6, 1.2, device="cuda")
    e_c = enhance_batch(crop[None], 10.0, 90.0, 0.6, 1.2, device="cpu")
    d_e = float((e_g.cpu().double() - e_c.double()).abs().max())
    check(d_e <= 1e-6, f"png16: enhance_batch card vs CPU {d_e} > 1e-6")
    log("png16", function="enhance_batch (hist)", crop=f"{w}x{h}",
        max_abs=d_e, seconds=f"{time.perf_counter() - t_phase:.1f}",
        card=repr(smi))


# [jpeg_variants]: [write]'s frame0.jpg as the JPEG variants beyond
# Huffman DCT files of 1 or 3 components (CMYK, YCCK, lossless,
# arithmetic coding), each decoding to an array known without cv2; six
# on the CMYK file
LOSSLESS_RESTART_ROWS = 5
# the arithmetic files go to the crop where the 1080p sequential one took
# the host this long to write and decode
ARITH_HOST_LIMIT_S = 30.0
ARITH_DAC = ((0, 0, 0x52), (0, 1, 0x30), (1, 0, 10), (1, 1, 1))


def cmyk_formula(c, m, y, k) -> np.ndarray:
    """OpenCV's CMYK to BGR conversion in RGB order, on u8 planes: each of
    C, M and Y becomes ``k - ((255 - v) * k >> 8)``."""
    k = k.astype(np.int32)
    return np.stack([k - (((255 - v.astype(np.int32)) * k) >> 8)
                     for v in (c, m, y)], -1).astype(np.uint8)


def jpeg_variants_slice(torch, run_cli, captured_match, replay,
                        smi: str) -> None:
    """[jpeg_variants]: from ``[write]``'s 1080p ``frame0.jpg`` (the port's
    4:2:0 encoder), ``tests/torch_jpeg_scans.py`` writes
    - a CMYK and a YCCK file whose components are frame0.jpg's Y, Cb, Cr
      and Y again (``recomponent``): each must decode to OpenCV's CMYK
      formula (``cmyk_formula``) on the planes written, which the
      components' RGB-marked twin decodes to (for YCCK, first 255 less
      frame0.jpg's own YCbCr decode, as ``jdcolor.c`` converts YCCK);
    - lossless gray and RGB files of predictors 1 and 7 with a restart
      every ``LOSSLESS_RESTART_ROWS`` MCU rows on the ``PNG16_CROP`` crop
      of frame 0: each must decode to the samples written;
    - arithmetic-coded sequential (SOF9, DAC conditioning) and progressive
      (SOF10, cv2's script, restarts) files of frame0.jpg's coefficients
      at 1080p (on the crop's baseline file where the sequential one took
      over ``ARITH_HOST_LIMIT_S`` to write and decode): each must decode
      equal to the Huffman file.
    The host ms of each write and decode printed beside the card.  ``cli
    six --device cuda`` on the CMYK file: six exact's launches of one
    frame (``SIX_ONE_FRAME``, K7 d and K6 d + 1 times), each captured call
    replayed bit-equal to its plain version."""
    from tests import torch_jpeg_scans as js
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        SIX_ORDER,
    )
    from underwater_image_enhancement_tpu_torch.utils import io as uio
    from underwater_image_enhancement_tpu_torch.utils.jpeg import (
        decode_jpeg,
        encode_jpeg,
    )

    t_phase = time.perf_counter()
    out = WORK / "jpeg_variants"
    (out / "in").mkdir(parents=True, exist_ok=True)
    base = (WORK / "write" / "frame0.jpg").read_bytes()
    rgb = decode_jpeg(base)
    planes = decode_jpeg(js.recomponent(base, (0, 1, 2), (js.adobe(0),)))
    y, cb, cr = (planes[..., k] for k in range(3))
    h, w = PNG16_CROP
    crop = np.ascontiguousarray(
        uio.imread_u8(str(WORK / "in" / "frame0.png"))[:h, :w])
    crop_base = encode_jpeg(crop)

    def timed(fn):
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3

    def held(name, write, want, **extra):
        data, ms_w = timed(write)
        got, ms_r = timed(lambda: decode_jpeg(data))
        check(got.shape == want.shape and np.array_equal(got, want),
              f"jpeg_variants: {name} decodes to other samples than "
              f"{extra.get('equal_to', 'written')}")
        (out / name).write_bytes(data)
        log("jpeg_variants", file=name, bytes=len(data),
            frame=f"{want.shape[1]}x{want.shape[0]}",
            write_host_ms=f"{ms_w:.1f}", decode_host_ms=f"{ms_r:.1f}",
            **extra, card=repr(smi))
        return data, ms_w + ms_r

    held("cmyk.jpg", lambda: js.recomponent(base, (0, 1, 2, 0),
                                            (js.adobe(0),)),
         cmyk_formula(y, cb, cr, y), equal_to="the CMYK formula")
    held("ycck.jpg", lambda: js.recomponent(base, (0, 1, 2, 0),
                                            (js.adobe(2),)),
         cmyk_formula(*(255 - rgb[..., k] for k in range(3)), y),
         equal_to="the CMYK formula after YCC")
    for psv in (1, 7):
        held(f"lossless_gray_p{psv}.jpg", lambda: js.lossless(
            [crop[..., 0]], psv, restart_rows=LOSSLESS_RESTART_ROWS),
            crop[..., 0], equal_to="written")
        held(f"lossless_rgb_p{psv}.jpg", lambda: js.lossless(
            [crop[..., k] for k in range(3)], psv, ids=[82, 71, 66],
            restart_rows=LOSSLESS_RESTART_ROWS), crop, equal_to="written")
    _, secs = held("arith_seq.jpg", lambda: js.arithmetic(
        base, dac=ARITH_DAC), rgb, equal_to="the Huffman file")
    at_full = secs / 1e3 < ARITH_HOST_LIMIT_S
    src, want = (base, rgb) if at_full else (crop_base, decode_jpeg(crop_base))
    held("arith_prog.jpg", lambda: js.arithmetic(
        src, js.script("cv2", 3), 7, ARITH_DAC[:2]), want,
        equal_to="the Huffman file", seq_host_s=f"{secs / 1e3:.1f}")
    (out / "in" / "frame0_cmyk.jpg").write_bytes(
        (out / "cmyk.jpg").read_bytes())
    calls, launches, secs = run_cli(
        ["six", "--device", "cuda", "--input", str(out / "in"), "--output",
         str(out / "six")], True)
    d = launches["hysteresis_propagate"]
    check(all(launches[k] == v for k, v in SIX_ONE_FRAME.items())
          and d >= 1 and launches["sat_rows"] == d + 1,
          f"jpeg_variants: six on the CMYK file launched {launches}")
    check(captured_match(calls, launches),
          f"jpeg_variants: captured calls {[len(v) for v in calls.values()]}"
          f" vs launches {launches}")
    pngs = sorted(p.name for p in (out / "six").glob("*.png"))
    check(pngs == sorted(f"frame0_cmyk_{n}.png" for n in SIX_ORDER),
          f"jpeg_variants: six outputs {pngs}")
    replayed = {}
    for kname, arglists in calls.items():
        for k, args in enumerate(arglists):
            replay(kname, args, f"jpeg_variants six call {k} (CMYK)")
        if arglists:
            replayed[kname] = len(arglists)
    torch.cuda.synchronize()
    log("jpeg_variants", command="'six --device cuda' (CMYK file)",
        seconds=f"{secs:.2f}",
        launches=json.dumps(nonzero(launches), separators=(",", ":")),
        replayed_bit_equal=json.dumps(replayed, separators=(",", ":")),
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}",
        card=repr(smi))


# [exif]: EXIF_PAIRS [train]-style pairs with an EXIF Orientation, the
# first half JPEGs of orientation 6, the rest PNGs of orientation 8
# (eXIf); the training loader turns each as cv2.imread(path) does, and
# cli train-mlp's feature cache launches K1b and K7 once a cached image
EXIF_PAIRS = 4
EXIF_TURNS = {6: -1, 8: 1}  # orientation -> np.rot90's k


def exif_slice(torch, run_cli, captured_match, replay, smi: str) -> None:
    """[exif]: ``EXIF_PAIRS`` pairs at TRAIN_H x TRAIN_W (raw: a seeded
    underwater frame, reference: a brighter twin), the first half written
    as JPEGs (the port's encoder) with an APP1 Exif segment of orientation
    6, the rest as PNGs with an ``eXIf`` chunk of orientation 8
    (big-endian); beside them the same pairs turned by ``np.rot90`` into
    plain PNGs.  ``PairedImageDataset.load_pair`` must give each oriented
    pair equal to its turned twin (and ``imread_u8`` a 640x480 frame), and
    one epoch of ``cli train-mlp --device cuda`` on the oriented pairs
    must launch K1b and K7 once a cached image, each captured call
    replayed bit-equal to its plain version."""
    from tests import torch_jpeg_scans as js
    from tests import torch_png
    from underwater_image_enhancement_tpu_torch.train.data import (
        PairedImageDataset,
    )
    from underwater_image_enhancement_tpu_torch.utils import io as uio
    from underwater_image_enhancement_tpu_torch.utils.jpeg import (
        decode_jpeg,
        encode_jpeg,
    )

    t_phase = time.perf_counter()
    root = WORK / "exif"
    dirs = {k: root / k for k in ("raw", "ref", "raw_turned", "ref_turned")}
    for d_ in dirs.values():
        d_.mkdir(parents=True, exist_ok=True)
    for i in range(EXIF_PAIRS):
        raw = np.round(synthetic_frame(2000 + i, TRAIN_H, TRAIN_W)
                       * 255).astype(np.uint8)
        ref = np.clip(raw.astype(np.int32) * 5 // 4 + 10, 0, 255).astype(
            np.uint8)
        orient = 6 if i < EXIF_PAIRS // 2 else 8
        for kind, img in (("raw", raw), ("ref", ref)):
            if orient == 6:
                data = encode_jpeg(img)
                plain = decode_jpeg(data)
                data = js.with_app1(data, b"Exif\x00\x00"
                                    + js.exif_tiff(6, "II"))
                name = f"pair{i:02d}.jpg"
            else:
                plain = img
                data = js.with_png_chunks(uio.encode_png(img), [
                    torch_png.chunk(b"eXIf", js.exif_tiff(8, "MM"))])
                name = f"pair{i:02d}.png"
            (dirs[kind] / name).write_bytes(data)
            (dirs[kind + "_turned"] / f"pair{i:02d}.png").write_bytes(
                uio.encode_png(np.rot90(plain, EXIF_TURNS[orient])))
    first = uio.imread_u8(str(dirs["raw"] / "pair00.jpg"))
    check(first.shape == (TRAIN_W, TRAIN_H, 3),
          f"exif: imread_u8 of an orientation-6 JPEG {first.shape}")
    ds = PairedImageDataset(str(dirs["raw"]), str(dirs["ref"]), 256, False)
    turned = PairedImageDataset(str(dirs["raw_turned"]),
                                str(dirs["ref_turned"]), 256, False)
    for i in range(EXIF_PAIRS):
        a, b = ds.load_pair(i), turned.load_pair(i)
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"exif: load_pair({i}) differs from its turned twin")
    log("exif", pairs=EXIF_PAIRS, orientations="6 (JPEG), 8 (PNG eXIf)",
        load_pair="equal to the turned twins", frame=f"{TRAIN_W}x{TRAIN_H}")
    out = root / "train_mlp"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        calls, launches, secs = run_cli(
            ["train-mlp", "--input", str(dirs["raw"]), "--reference",
             str(dirs["ref"]), "--output", str(out), "--epochs", "1",
             "--batch-size", "1", "--device", "cuda"], True)
    hist = json.loads((out / "training_history.json").read_text())
    want = {**NONE, "lab_forward_u8": EXIF_PAIRS,
            "hysteresis_propagate": EXIF_PAIRS}
    check(launches == want and captured_match(calls, launches),
          f"exif: train-mlp launched {launches}")
    check(len(hist["train_loss"]) == 1
          and bool(np.isfinite(hist["train_loss"] + hist["val_loss"]).all()),
          f"exif: train-mlp history {hist}")
    for kname, arglists in calls.items():
        for k, args in enumerate(arglists):
            replay(kname, args, f"exif train-mlp call {k}")
    torch.cuda.synchronize()
    log("exif", command="'train-mlp --device cuda' (oriented pairs)",
        epochs=1, seconds=f"{secs:.2f}",
        train_loss=f"{hist['train_loss'][0]:.6f}",
        launches=json.dumps(nonzero(launches), separators=(",", ":")),
        replayed_bit_equal=json.dumps(
            {k: len(v) for k, v in calls.items() if v},
            separators=(",", ":")),
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}",
        card=repr(smi))


# [tiff_variants]: 1080p frame 0 as the TIFF variants that libtiff's RGBA
# reader and cv2's own path take apart from 8- and 16-bit chunky RGB, each
# decoding to the array it encodes as cv2 converts it; six on the
# orientation-3 file against six on the PNG of the same frame
TIFF_STRIP_ROWS = 16
TIFF_TILE = (256, 256)


def variants_frame() -> np.ndarray:
    """Frame 0 as ``[write]`` and ``[png16]`` read it: (H, W, 3) uint8."""
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    u8 = uio.imread_u8(str(WORK / "in" / "frame0.png"))
    check(u8 is not None and u8.shape == (H, W, 3), "variants: frame 0")
    return u8


def held_file(phase: str, out: Path, name: str, write, decode, want,
              smi: str, shape_only: bool = False, **extra) -> bytes:
    """Write a file by ``write()``, decode it by ``decode(data)`` and hold
    it equal to ``want``, dtype included (with ``shape_only``, of its
    shape and dtype only); log both host ms."""
    t0 = time.perf_counter()
    data = write()
    ms_w = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    got = decode(data)
    ms_r = (time.perf_counter() - t0) * 1e3
    check(got.shape == want.shape and got.dtype == want.dtype and (
        shape_only or np.array_equal(got, want)),
          f"{phase}: {name} decodes to other pixels than it encodes")
    (out / name).write_bytes(data)
    log(phase, file=name, bytes=len(data), frame=f"{W}x{H}",
        write_host_ms=f"{ms_w:.1f}", decode_host_ms=f"{ms_r:.1f}",
        **extra, card=repr(smi))
    return data


# six's PNGs and launches on frame 0's PNG, by the PNG's bytes: the run
# every six_twin compares with, made once
SIX_ON_PNG: dict = {}


def six_twin(torch, run_cli, captured_match, replay, smi: str, phase: str,
             out: Path, u8: np.ndarray, label: str, name: str, data: bytes,
             what: str) -> None:
    """``cli six --device cuda`` on a folder holding frame 0's PNG (run
    once: ``SIX_ON_PNG``) and on one holding ``data`` (named ``name``),
    ``what`` in the logs: both launch six exact's kernels of one frame
    (``SIX_ONE_FRAME``), each of the second's calls replayed bit-equal to
    its plain version, and both write the same PNGs."""
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        SIX_ORDER,
    )
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    png = uio.encode_png(u8)
    outs = {"png": SIX_ON_PNG.get(png)}
    for lab, nm, dat in (("png", "frame0.png", png), (label, name, data)):
        if outs.get(lab) is not None:
            continue
        src = out / f"in_{lab}"
        src.mkdir(parents=True, exist_ok=True)
        (src / nm).write_bytes(dat)
        calls, launches, secs = run_cli(
            ["six", "--device", "cuda", "--input", str(src), "--output",
             str(out / f"six_{lab}")], lab != "png")
        d = launches["hysteresis_propagate"]
        check(all(launches[k_] == v for k_, v in SIX_ONE_FRAME.items())
              and d >= 1 and launches["sat_rows"] == d + 1,
              f"{phase}: six on the {lab} file launched {launches}")
        pngs = {p.name: p.read_bytes()
                for p in sorted((out / f"six_{lab}").glob("*.png"))}
        check(sorted(pngs) == sorted(f"frame0_{n}.png" for n in SIX_ORDER),
              f"{phase}: six outputs {sorted(pngs)}")
        outs[lab] = (pngs, launches)
        if lab == "png":
            SIX_ON_PNG[png] = outs[lab]
        else:
            check(captured_match(calls, launches),
                  f"{phase}: captured calls "
                  f"{[len(v) for v in calls.values()]} vs {launches}")
            for kname, arglists in calls.items():
                for j, args in enumerate(arglists):
                    replay(kname, args, f"{phase} six call {j} ({what})")
            torch.cuda.synchronize()
            log(phase, command=f"'six --device cuda' ({what})",
                seconds=f"{secs:.2f}", descent_levels=d,
                launches=json.dumps(nonzero(launches), separators=(",", ":")),
                replayed_bit_equal=json.dumps(
                    {k_: len(v) for k_, v in calls.items() if v},
                    separators=(",", ":")), card=repr(smi))
    check(outs[label] == outs["png"],
          f"{phase}: six writes other PNGs (or launches) for the {what} "
          "than for the frame's PNG")


def tiff_variants_slice(torch, run_cli, captured_match, replay,
                        smi: str) -> None:
    """[tiff_variants]: from 1080p frame 0, ``tests/torch_tiff.py``
    writes an orientation-3 file (the frame turned 180 degrees, Deflate
    with the predictor, strips of ``TIFF_STRIP_ROWS`` rows), a palette
    file (``palette_332``'s 256 colours in a 16-bit colormap), planar RGB
    in ``TIFF_TILE`` tiles, CMYK (C, M, Y the complements of R, G, B, K a
    quarter of the darkest), a WhiteIsZero gray (the green plane), an
    old-style LZW file, a fill-order-2 LZW file and a JPEG-in-TIFF
    (YCbCr strips of the port's JPEG encoder, its tables in JPEGTables).
    Each decodes (``tiff.decode_tiff``, host ms printed) to the array it
    encodes as cv2 converts it: the frame turned back, the colormap's high
    bytes, ``(255 - c) * (255 - k) // 255`` and alpha 255, the gray, the
    strips' own JPEG decodes.  ``cli six --device cuda`` on the
    orientation-3 file launches six exact's kernels of one frame
    (``SIX_ONE_FRAME``), each call replayed bit-equal to its plain
    version, and writes PNGs byte-equal to those of ``cli six`` on the
    frame's PNG."""
    from tests import torch_tiff as T
    from underwater_image_enhancement_tpu_torch.utils.jpeg import (
        decode_jpeg,
        encode_jpeg,
    )
    from underwater_image_enhancement_tpu_torch.utils.tiff import (
        decode_tiff,
    )

    t_phase = time.perf_counter()
    out = WORK / "tiff_variants"
    out.mkdir(parents=True, exist_ok=True)
    u8 = variants_frame()
    rows = TIFF_STRIP_ROWS

    def held(name, write, want, **extra):
        return held_file("tiff_variants", out, name, write, decode_tiff,
                         want, smi, **extra)

    held("orientation3.tif", lambda: T.tiff(
        [u8[::-1, ::-1]], compression=8, predictor=2, rows_per_strip=rows,
        tags={274: (3, [3])}), u8, equal_to="the frame")
    idx, pal = palette_332(u8)
    cmap = (pal.T.astype(np.int64) * 257).reshape(-1).tolist()
    held("palette.tif", lambda: T.tiff(
        [idx.astype(np.uint8)], compression=8, photometric=3,
        rows_per_strip=rows, tags={320: (3, cmap)}), pal[idx],
        equal_to="the palette's colours")
    held("planar.tif", lambda: T.tiff([u8], planar=2, tile=TIFF_TILE), u8,
         equal_to="the frame")
    k = u8.min(-1) // 4
    cmyk = np.concatenate([255 - u8, k[..., None]], -1)
    conv = ((255 - cmyk[..., :3].astype(np.int32))
            * (255 - k[..., None].astype(np.int32)) // 255).astype(np.uint8)
    held("cmyk.tif", lambda: T.tiff([cmyk], compression=8, photometric=5,
                                    rows_per_strip=rows),
         np.concatenate([conv, np.full((H, W, 1), 255, np.uint8)], -1),
         equal_to="libtiff's CMYK conversion")
    held("white_is_zero.tif", lambda: T.tiff(
        [255 - u8[..., 1]], compression=5, photometric=0,
        rows_per_strip=rows), u8[..., 1:2], equal_to="the gray")
    held("old_lzw.tif", lambda: T.tiff([u8], compression="lzw-old",
                                       rows_per_strip=rows), u8,
         equal_to="the frame")
    held("fill_order2.tif", lambda: T.tiff(
        [u8], compression=5, predictor=2, fill_order=2,
        rows_per_strip=rows), u8, equal_to="the frame")
    tables = []

    def strip_jpeg(blk, plane):
        head, chunk = T.jpeg_split(encode_jpeg(np.ascontiguousarray(blk)))
        tables[:] = [head]
        return chunk

    T.tiff([u8[:rows]], compression=7, photometric=6, jpeg=strip_jpeg)
    strips = np.concatenate([decode_jpeg(encode_jpeg(np.ascontiguousarray(
        u8[y:y + rows]))) for y in range(0, H, rows)])
    held("jpeg.tif", lambda: T.tiff(
        [u8], compression=7, photometric=6, jpeg=strip_jpeg,
        rows_per_strip=rows, tags={347: (7, tables[0]), 530: (3, [2, 2])}),
        strips, equal_to="the strips' JPEG decodes")
    six_twin(torch, run_cli, captured_match, replay, smi, "tiff_variants",
             out, u8, "orientation3", "frame0.tif",
             (out / "orientation3.tif").read_bytes(), "orientation-3 TIFF")
    log("tiff_variants", six_outputs="byte-equal to the PNG's",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=repr(smi))


# [tiff_layouts]: 1080p frame 0 as the TIFF layouts of ROADMAP Queue 1
# item 11.9's third part: no StripByteCounts, palette + ExtraSamples, JPEG
# in planar RGB and in CMYK; six on the first against six on the PNG
def tiff_layouts_slice(torch, run_cli, captured_match, replay,
                       smi: str) -> None:
    """[tiff_layouts]: from 1080p frame 0, ``tests/torch_tiff.py`` writes
    an LZW file of one strip (the predictor on) and an uncompressed planar
    file of one strip a plane, both without StripByteCounts (the port
    estimates the counts as libtiff does), a palette file of two samples a
    pixel (``palette_332``'s indices and an unassociated alpha of the
    green plane, Deflate, strips of ``TIFF_STRIP_ROWS`` rows), a planar
    RGB JPEG file (each plane one JPEG of one component, its quantisation
    table in JPEGTables) and a CMYK JPEG file (one JPEG of four
    components: C, M, Y the complements of R, G, B, K a quarter of the
    darkest; its tables in JPEGTables too).  Each decodes
    (``tiff.decode_tiff``, host ms printed) to its closed form: the frame,
    the palette's colours (the alpha ignored), the planes' own JPEG
    decodes, ``(255 - c) * (255 - k) // 255`` of the components' own
    decode and alpha 255.  ``cli six --device cuda`` on the LZW file
    (``six_twin``) launches six exact's kernels of one frame, each call
    replayed bit-equal, and writes six's PNGs of the frame's PNG."""
    from tests import torch_jpeg_scans as js
    from tests import torch_tiff as T
    from underwater_image_enhancement_tpu_torch.utils.jpeg import (
        decode_jpeg_chunk,
    )
    from underwater_image_enhancement_tpu_torch.utils.tiff import (
        decode_tiff,
    )

    t_phase = time.perf_counter()
    out = WORK / "tiff_layouts"
    out.mkdir(parents=True, exist_ok=True)
    u8 = variants_frame()

    def held(name, write, want, **extra):
        return held_file("tiff_layouts", out, name, write, decode_tiff,
                         want, smi, **extra)

    held("no_counts_lzw.tif", lambda: T.tiff(
        [u8], compression=5, predictor=2, tags={279: None}), u8,
        equal_to="the frame")
    held("no_counts_planar.tif", lambda: T.tiff(
        [u8], planar=2, tags={279: None}), u8, equal_to="the frame")
    idx, pal = palette_332(u8)
    cmap = (pal.T.astype(np.int64) * 257).reshape(-1).tolist()
    held("palette_alpha.tif", lambda: T.tiff(
        [np.stack([idx.astype(np.uint8), u8[..., 1]], -1)], compression=8,
        photometric=3, rows_per_strip=TIFF_STRIP_ROWS,
        tags={320: (3, cmap), 338: (3, [2])}), pal[idx],
        equal_to="the palette's colours")
    jpegs = {}

    def raw_jpeg(blk, plane):
        jpegs[plane] = js.sequential([blk[..., c] for c in range(
            blk.shape[2])], app=())
        head, chunk = T.jpeg_split(jpegs[plane], (0xDB,))
        jpegs["tables"] = head
        return chunk

    T.tiff([u8[:8, :8]], compression=7, photometric=2, jpeg=raw_jpeg)
    tables = jpegs["tables"]

    def jpeg_tiff(img, **kw):
        """The file and the host ms to write it, its JPEGs kept in
        ``jpegs`` for the closed form (``held_file`` times only the
        copy)."""
        t0 = time.perf_counter()
        data = T.tiff([img], compression=7, jpeg=raw_jpeg,
                      tags={347: (7, tables)}, **kw)
        return data, f"{(time.perf_counter() - t0) * 1e3:.1f}"

    data, ms = jpeg_tiff(u8, photometric=2, planar=2)
    planes = np.stack([decode_jpeg_chunk(b"", jpegs[p], "rgb")
                       for p in range(3)], -1)
    held("jpeg_planar.tif", lambda: data, planes, encode_host_ms=ms,
         equal_to="the planes' JPEG decodes")
    cmyk = np.concatenate([255 - u8, (u8.min(-1) // 4)[..., None]], -1)
    data, ms = jpeg_tiff(cmyk, photometric=5)
    c = decode_jpeg_chunk(b"", jpegs[0], "rgb").astype(np.int32)
    conv = ((255 - c[..., :3]) * (255 - c[..., 3:]) // 255).astype(np.uint8)
    held("jpeg_cmyk.tif", lambda: data, np.concatenate(
        [conv, np.full((H, W, 1), 255, np.uint8)], -1), encode_host_ms=ms,
        equal_to="libtiff's CMYK conversion of the JPEG's components")
    six_twin(torch, run_cli, captured_match, replay, smi, "tiff_layouts",
             out, u8, "no_counts", "frame0.tif",
             (out / "no_counts_lzw.tif").read_bytes(),
             "TIFF without StripByteCounts")
    log("tiff_layouts", six_outputs="byte-equal to the PNG's",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=repr(smi))


# [tiff_codecs]: 1080p frame 0 as the CCITT and SGILog TIFFs of ROADMAP
# Queue 1 item 11.9's second part, each decode held to cv2's SHA-256; six
# on the Group 4 file against six on the same bits as a PNG
TIFF_CODECS = {  # name -> (compression, T4Options, fill order)
    "ccitt_rle.tif": (2, 0, 1), "ccitt_rlew.tif": (32771, 0, 1),
    "ccitt_g3_1d.tif": (3, 0, 1), "ccitt_g3_2d_fill.tif": (3, 5, 1),
    "ccitt_g4.tif": (4, 0, 1), "ccitt_g4_fill_order2.tif": (4, 0, 2)}
SGILOG_FILES = {  # name -> (compression, photometric interpretation)
    "sgilog_logl.tif": (34676, 32844), "sgilog_logluv.tif": (34676, 32845),
    "sgilog24_logluv.tif": (34677, 32845)}
# each file's SHA-256, then that of cv2.imread's array of it (OpenCV
# 5.0.0 with its libtiff 4.7.1) in IMREAD_UNCHANGED and in IMREAD_COLOR,
# as ``tiff_codec_sha256`` takes them: the card's host has no cv2, and its
# libm and numpy must give cv2's floats.  Made by
# ``python tools/tiff_codec_hashes.py``.
TIFF_CODEC_SHA256 = {
    "ccitt_rle.tif": (
        "e6f338dc984cd6a847b731cc48f7348b704d4ca38d6c4e34c84e21ac144d811f",
        "6d05cb23640e613b5111b84094499d4ebce2c1ab6c70de92847121129bc88ce3",
        "e4a6b51153a54366859204243a44c619f55bca6979d22f6bd83d0afd5aab7909"),
    "ccitt_rlew.tif": (
        "b1152f226851b8f99ab110599ab7f3b1ccbffc3f522784e0cd2f5973290d4433",
        "6d05cb23640e613b5111b84094499d4ebce2c1ab6c70de92847121129bc88ce3",
        "e4a6b51153a54366859204243a44c619f55bca6979d22f6bd83d0afd5aab7909"),
    "ccitt_g3_1d.tif": (
        "b9d566ac5b0de0063a539c2bd5c7c4e507a44c26e2d0f9403f847d98996bda16",
        "6d05cb23640e613b5111b84094499d4ebce2c1ab6c70de92847121129bc88ce3",
        "e4a6b51153a54366859204243a44c619f55bca6979d22f6bd83d0afd5aab7909"),
    "ccitt_g3_2d_fill.tif": (
        "e8b0afef43b28b60c2fcc128d1db553fb0a7bfaa6ad71f62ed296c5e1b5f8c7c",
        "6d05cb23640e613b5111b84094499d4ebce2c1ab6c70de92847121129bc88ce3",
        "e4a6b51153a54366859204243a44c619f55bca6979d22f6bd83d0afd5aab7909"),
    "ccitt_g4.tif": (
        "91304ac9986417850a607d8d06ce7dbcf90eba52799f0009fe63162f2c572d96",
        "6d05cb23640e613b5111b84094499d4ebce2c1ab6c70de92847121129bc88ce3",
        "e4a6b51153a54366859204243a44c619f55bca6979d22f6bd83d0afd5aab7909"),
    "ccitt_g4_fill_order2.tif": (
        "64b163d5b56a2119e46bb6b697962e74ed314d480ead52ed9f7d5f7ff6218642",
        "6d05cb23640e613b5111b84094499d4ebce2c1ab6c70de92847121129bc88ce3",
        "e4a6b51153a54366859204243a44c619f55bca6979d22f6bd83d0afd5aab7909"),
    "sgilog_logl.tif": (
        "3ca96b6fc060cbd25231c783a59256876fbb450672a64fd52f09744648669c36",
        "4c54ed8ceab23d4b01cf7a926e2c7795cbb6d1ed9c33be2d1bbfda360f2db046",
        "578befe401a314ed7d1a1bf05e39378097da4942c7e92d96539a59570ea8f1e9"),
    "sgilog_logluv.tif": (
        "894d9f14b51b4bbae1fddc5f833a1c52dbba7622296c6435e7e66302923fb132",
        "d8b4136c65b3b24716ccd414d7d7b93a9072de0e6233296b700e1fb8ab2d2086",
        "4c45b27bd8e4a9b103fc6a99be66fa3029096c5b02240f48eb643b59bebf0dbe"),
    "sgilog24_logluv.tif": (
        "5be670a1e178463ad546c2b3889565da6cb3293b13ff28d8e481eb7bde5568bd",
        "fb0fb202f6c05fe17a18d762b679e17efac57be4e118361d19efbf49018361a7",
        "4b46dd57e8bad219446a1b7acad020c6003a4e0cb9822047d5ac1430213749aa"),
}


def codec_bits(u8: np.ndarray) -> np.ndarray:
    """Frame 0 made bi-level: 1 (black) where OpenCV's integer gray of it
    (``(4899 r + 9617 g + 1868 b + 8192) >> 14``) lies below its median."""
    c = u8.astype(np.int64)
    gray = (c[..., 0] * 4899 + c[..., 1] * 9617 + c[..., 2] * 1868
            + 8192) >> 14
    return (gray < np.median(gray)).astype(np.uint8)


def tiff_codec_files(u8: np.ndarray) -> dict:
    """name -> a function writing the file (``tests/torch_tiff.py``) from
    frame 0: ``codec_bits`` in each of ``TIFF_CODECS`` (WhiteIsZero,
    strips of ``TIFF_STRIP_ROWS`` rows) and the frame's X, Y, Z in each of
    ``SGILOG_FILES`` (``frame_xyz``, ``sgilog_codes``; strips of
    ``TIFF_STRIP_ROWS`` rows)."""
    from tests import torch_tiff as T

    bits = codec_bits(u8)
    files = {}
    for name, (comp, opts, order) in TIFF_CODECS.items():
        files[name] = (lambda comp=comp, opts=opts, order=order: T.tiff(
            [bits], compression=comp, bits=1, photometric=0,
            rows_per_strip=TIFF_STRIP_ROWS, fill_order=order,
            coder=lambda blk: T.ccitt(blk, comp, opts),
            tags={292: (4, [opts])} if comp == 3 else None))
    for name, (comp, ph) in SGILOG_FILES.items():
        def write(comp=comp, ph=ph):
            codes = T.sgilog_codes(T.frame_xyz(u8), comp, ph)
            return T.tiff([T.sgilog_page(codes, ph)], compression=comp,
                          photometric=ph, rows_per_strip=TIFF_STRIP_ROWS,
                          coder=T.sgilog_coder(ph, comp))
        files[name] = write
    return files


def tiff_codec_sha256(a: np.ndarray) -> str:
    """SHA-256 of an image array as the port lays it out (RGB order): its
    dtype and shape, then its bytes."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype.str}{a.shape}".encode()
                          + a.tobytes()).hexdigest()


def tiff_codecs_slice(torch, run_cli, captured_match, replay,
                      smi: str) -> None:
    """[tiff_codecs]: ``tiff_codec_files`` of 1080p frame 0: six CCITT
    files (RLE, RLEW, Group 3 1-D, Group 3 2-D with fill bits, Group 4 and
    Group 4 of fill order 2) and three SGILog ones (LogL, LogLuv, SGILog24
    LogLuv).  Each file's bytes, and ``tiff.decode_tiff``'s array of it
    in IMREAD_UNCHANGED and IMREAD_COLOR, hash to ``TIFF_CODEC_SHA256``
    (cv2's arrays, where cv2 runs); the CCITT files decode to
    their bits (255 white, 0 black).  Host ms of each write and decode
    printed.  ``cli six --device cuda`` on the Group 4 file
    (``six_twin``) launches six exact's kernels of one frame (the
    descent's levels d printed), each call replayed bit-equal, and writes
    the PNGs six writes for the same bits as a PNG."""
    from underwater_image_enhancement_tpu_torch.utils.tiff import (
        decode_tiff,
    )

    t_phase = time.perf_counter()
    out = WORK / "tiff_codecs"
    out.mkdir(parents=True, exist_ok=True)
    u8 = variants_frame()
    bits = codec_bits(u8)
    white = np.where(bits, 0, 255).astype(np.uint8)
    for name, write in tiff_codec_files(u8).items():
        t0 = time.perf_counter()
        data = write()
        ms_w = (time.perf_counter() - t0) * 1e3
        want_file, want_raw, want_color = TIFF_CODEC_SHA256[name]
        got_file = hashlib.sha256(data).hexdigest()
        check(got_file == want_file,
              f"tiff_codecs: {name} is not the file whose cv2 reading is "
              f"recorded (frame 0 or the writer differs here: {got_file})")
        ms = {}
        for mode, color, want in (("unchanged", False, want_raw),
                                  ("color", True, want_color)):
            t0 = time.perf_counter()
            got = decode_tiff(data, color)
            ms[mode] = f"{(time.perf_counter() - t0) * 1e3:.1f}"
            digest = tiff_codec_sha256(got)
            check(digest == want, f"tiff_codecs: {name} decodes "
                  f"({mode}) to other bits than cv2's ({digest})")
            if name in TIFF_CODECS and not color:
                check(np.array_equal(got[..., 0], white),
                      f"tiff_codecs: {name} decodes to other bits")
        (out / name).write_bytes(data)
        log("tiff_codecs", file=name, bytes=len(data), frame=f"{W}x{H}",
            write_host_ms=f"{ms_w:.1f}",
            decode_host_ms_unchanged=ms["unchanged"],
            decode_host_ms_color=ms["color"], sha256_equal_to_cv2=True,
            card=repr(smi))
    six_twin(torch, run_cli, captured_match, replay, smi, "tiff_codecs",
             out, np.repeat(white[..., None], 3, axis=2), "g4",
             "frame0.tif", (out / "ccitt_g4.tif").read_bytes(),
             "Group 4 TIFF")
    log("tiff_codecs", six_outputs="byte-equal to the bits' PNG's",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=repr(smi))


# [tiff_samples]: 1080p frame 0 as the TIFF sample types, colour spaces
# and containers cv2 reads apart from 8- and 16-bit unsigned samples, each
# decoding to its closed form; six on the float TIFF against six on the
# PNG of the same frame
def tiff_samples_slice(torch, run_cli, captured_match, replay,
                       smi: str) -> None:
    """[tiff_samples]: from 1080p frame 0, ``tests/torch_tiff.py`` writes
    a float32 RGB file of the samples 0-255 (Deflate with the
    floating-point predictor), a 12-bit RGB file (LZW) of the samples
    widened to 12 bits, a signed 16-bit gray (the green plane over the
    whole int16 range), a BigTIFF of the frame, a 2x2 YCbCr file
    (uncompressed; Y, Cb, Cr the green, blue and red planes), an 8-bit
    CIELab file (L*, a*, b* the frame's three bytes) and a file tagged
    JPEG 2000 (compression 34712, which libtiff does not know).  Each
    decodes (``tiff.decode_tiff``, host ms printed) to its closed form:
    the floats as written, the 12-bit values ``<< 4``, the signed plane's
    high bytes in ``IMREAD_COLOR`` (its int16 samples in
    ``IMREAD_UNCHANGED``, which ``io.decode_image`` names: JAX's reader
    raises on it), the frame, zeros; the YCbCr and CIELab files to (H, W,
    3) uint8 (the CPU tests hold them to cv2).  ``cli six --device cuda``
    on the float file launches six exact's kernels of one frame
    (``SIX_ONE_FRAME``), each call replayed bit-equal to its plain
    version, and writes PNGs byte-equal to those of ``cli six`` on the
    frame's PNG."""
    from tests import torch_tiff as T
    from underwater_image_enhancement_tpu_torch.utils import io as uio
    from underwater_image_enhancement_tpu_torch.utils.jpeg import (
        Unsupported,
    )
    from underwater_image_enhancement_tpu_torch.utils.tiff import (
        decode_tiff,
    )

    t_phase = time.perf_counter()
    out = WORK / "tiff_samples"
    out.mkdir(parents=True, exist_ok=True)
    u8 = variants_frame()
    rows = TIFF_STRIP_ROWS

    def held(name, write, want, decode=decode_tiff, **extra):
        return held_file("tiff_samples", out, name, write, decode, want,
                         smi, **extra)

    held("float32.tif", lambda: T.tiff(
        [u8.astype(np.float32)], compression=8, predictor=3,
        rows_per_strip=rows), u8.astype(np.float32),
        equal_to="the floats as written")
    v12 = (u8.astype(np.uint16) << 4) | (u8 >> 4)
    held("rgb12.tif", lambda: T.tiff([v12], bits=12, compression=5,
                                     rows_per_strip=rows), v12 << 4,
         equal_to="the samples << 4")
    s16 = (u8[..., 1].astype(np.int32) * 257 - 32768).astype(np.int16)
    high = np.repeat((s16.view(np.uint16) >> 8).astype(np.uint8)[..., None],
                     3, axis=2)
    data = held("signed16.tif", lambda: T.tiff([s16], rows_per_strip=rows),
                high, decode=lambda d: decode_tiff(d, True),
                equal_to="the high bytes (IMREAD_COLOR)")
    check(np.array_equal(decode_tiff(data), s16[..., None]),
          "tiff_samples: the signed file's IMREAD_UNCHANGED samples")
    try:
        uio.decode_image(data)
        named = None
    except Unsupported as e:
        named = str(e)
    check(named == "signed 16-bit TIFF, on which the JAX reader raises",
          f"tiff_samples: the signed file named {named!r}")
    log("tiff_samples", file="signed16.tif", imread_unit=f"named {named!r}",
        card=repr(smi))
    held("bigtiff.tif", lambda: T.tiff([u8], big=True, compression=8,
                                       predictor=2, rows_per_strip=rows),
         u8, equal_to="the frame")
    ycc = u8[..., [1, 2, 0]]
    held("ycbcr22.tif", lambda: T.tiff(
        [ycc], photometric=6, block=T.ycbcr_block(2, 2),
        rows_per_strip=rows, tags={530: (3, [2, 2])}),
        np.empty((H, W, 3), np.uint8), shape_only=True,
        equal_to="(H, W, 3) uint8")
    held("cielab8.tif", lambda: T.tiff([u8], photometric=8,
                                       rows_per_strip=rows),
         np.empty((H, W, 3), np.uint8), shape_only=True,
         equal_to="(H, W, 3) uint8")
    held("jpeg2000.tif", lambda: T.tiff([u8], rows_per_strip=rows,
                                        tags={259: (3, [34712])}),
         np.zeros((H, W, 3), np.uint8), equal_to="zeros")
    six_twin(torch, run_cli, captured_match, replay, smi, "tiff_samples",
             out, u8, "float32", "frame0.tif",
             (out / "float32.tif").read_bytes(), "float TIFF")
    log("tiff_samples", six_outputs="byte-equal to the PNG's",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=repr(smi))


# [bmp_variants]: 1080p frame 0 as an RLE8, a 4-bit and a 16-bit BMP
BMP_16_COLOURS = np.array([[r * 255, g * 85, b * 255] for r in (0, 1)
                           for g in range(4) for b in (0, 1)], np.uint8)


def bmp_variants_slice(smi: str) -> None:
    """[bmp_variants]: from 1080p frame 0, ``tests/torch_bmp.py`` writes
    an RLE8 file of ``palette_332``'s indices, a 4-bit file (R and B by
    their top bit, G by its top two: ``BMP_16_COLOURS``) and a 16-bit
    5-5-5 file; each decodes (``bmp.decode_bmp``, host ms printed) to the
    palette's colours, or to the samples' top five bits shifted up, as
    OpenCV's decoder gives them."""
    from tests import torch_bmp as B
    from underwater_image_enhancement_tpu_torch.utils.bmp import decode_bmp

    t_phase = time.perf_counter()
    out = WORK / "bmp_variants"
    out.mkdir(parents=True, exist_ok=True)
    u8 = variants_frame()
    idx, pal = palette_332(u8)
    held_file("bmp_variants", out, "rle8.bmp", lambda: B.bmp(
        B.rle(idx, 8), W, H, 8, B.BI_RLE8, palette=pal), decode_bmp,
        pal[idx], smi, equal_to="the palette's colours")
    idx4 = ((u8[..., 0] >> 7) << 3) | ((u8[..., 1] >> 6) << 1) | (
        u8[..., 2] >> 7)
    held_file("bmp_variants", out, "4bit.bmp", lambda: B.bmp(
        B.pack(idx4[::-1], 4), W, H, 4, palette=BMP_16_COLOURS),
        decode_bmp, BMP_16_COLOURS[idx4], smi,
        equal_to="the palette's colours")
    v = ((u8[..., 0].astype(np.int64) >> 3) << 10
         | (u8[..., 1].astype(np.int64) >> 3) << 5 | u8[..., 2] >> 3)
    held_file("bmp_variants", out, "555.bmp", lambda: B.bmp(
        B.pack(v[::-1], 16), W, H, 16), decode_bmp, u8 >> 3 << 3, smi,
        equal_to="the top five bits")
    log("bmp_variants",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=repr(smi))


# [other_formats]: 1080p frame 0 through the formats outside
# SUPPORTED_FORMATS that the port reads and writes
def other_formats_slice(torch, run_cli, captured_match, replay,
                        smi: str) -> None:
    """[other_formats]: 1080p frame 0 written by the port's writers as PPM,
    PAM, PFM, Sun raster and HDR, and by ``tests/torch_formats.py`` as an
    ASCII P2 (the green plane), a 16-bit P6 (``sixteen_bit``), a Sun
    raster with ``palette_332``'s colormap, an old-style RLE HDR of the
    HDR writer's quads (its repeats read as pixels, as cv2 reads them)
    and an interlaced GIF with a local table of ``palette_332``'s
    colours; each decodes (host ms printed) to its array: the frame, its
    samples as float32, the RGBE samples of ``torch_formats.rgbe_quads``'s
    ``float2rgbe`` (of the frame, and for the old-style file of its
    ``palette_332`` colours, which repeat), the palette's colours.  An RLE Sun raster is refused,
    as cv2 refuses every RT_BYTE_ENCODED file.  ``cli six --device cuda``
    on the PFM (named ``frame0.png``: a folder run collects the suffixes
    of ``SUPPORTED_FORMATS``, and the reader goes by the signature)
    launches six exact's kernels of one frame
    (``SIX_ONE_FRAME``), each call replayed bit-equal, and writes PNGs
    byte-equal to six's on the frame's PNG; ``cli enhance --input
    frame0.hdr --output out.hdr`` on the card and with ``--device cpu``:
    each file the HDR writer's bytes of its own enhanced frame, and the
    two frames within 1e-6 (``enhance`` on each device)."""
    from tests import torch_formats as F
    from underwater_image_enhancement_tpu_torch import cli
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        enhance,
    )
    from underwater_image_enhancement_tpu_torch.utils import io as uio
    from underwater_image_enhancement_tpu_torch.utils.gif import decode_gif
    from underwater_image_enhancement_tpu_torch.utils.hdr import (
        decode_hdr,
        encode_hdr,
    )
    from underwater_image_enhancement_tpu_torch.utils.pxm import (
        decode_pam,
        decode_pfm,
        decode_pnm,
    )
    from underwater_image_enhancement_tpu_torch.utils.sunras import (
        decode_sunras,
    )

    t_phase = time.perf_counter()
    out = WORK / "other_formats"
    out.mkdir(parents=True, exist_ok=True)
    u8 = variants_frame()
    idx, pal = palette_332(u8)
    quads = F.rgbe_quads(u8.astype(np.float32)
                         * (np.float32(1) / np.float32(255)))

    def held(name, write, decode, want, **extra):
        return held_file("other_formats", out, name, write, decode, want,
                         smi, **extra)

    for name, decode, want in (
            ("frame0.ppm", decode_pnm, u8), ("frame0.pam", decode_pam, u8),
            ("frame0.pfm", decode_pfm, u8.astype(np.float32)),
            ("frame0.ras", decode_sunras, u8),
            ("frame0.hdr", decode_hdr, F.rgbe_float(quads))):
        held(name, lambda n=name: uio.encoder_for(n)(u8), decode, want,
             writer="the port's")
    held("ascii_p2.pgm", lambda: F.pnm(2, u8[..., 1]), decode_pnm,
         u8[..., 1], equal_to="the green plane")
    v16 = sixteen_bit(u8, 16)
    held("p6_16.ppm", lambda: F.pnm(6, v16, 65535), decode_pnm, v16,
         equal_to="the 16-bit samples")
    held("palette.ras", lambda: F.sunras(F.sunras_rows(idx, 8), W, H, 8,
                                         cmap=pal), decode_sunras, pal[idx],
         equal_to="the palette's colours")
    runs = F.rgbe_quads(pal[idx].astype(np.float32)
                        * (np.float32(1) / np.float32(255)))
    _, flat = F.hdr_old_rle(runs, W)
    held("old_rle.hdr", lambda: F.hdr_old_rle(runs, W)[0], decode_hdr,
         F.rgbe_float(flat), equal_to="the repeats read as pixels",
         rows=flat.shape[0],
         repeats=int((flat[..., :3] == 1).all(-1).sum()))
    held("interlaced.gif", lambda: F.gif(W, H, [F.gif_image(
        idx, lct=pal, interlace=True)]), decode_gif, pal[idx],
         equal_to="the palette's colours")
    rle = F.sunras(F.sunras_rle(idx.astype(np.uint8).tobytes()), W, H, 8,
                   kind=2, cmap=pal)
    try:
        decode_sunras(rle)
        refused = False
    except ValueError:
        refused = True
    check(refused, "other_formats: an RT_BYTE_ENCODED Sun raster decoded, "
          "which cv2 refuses")
    log("other_formats", file="rle.ras", bytes=len(rle),
        refused="as cv2 refuses RT_BYTE_ENCODED", card=repr(smi))
    six_twin(torch, run_cli, captured_match, replay, smi, "other_formats",
             out, u8, "pfm", "frame0.png", (out / "frame0.pfm").read_bytes(),
             "PFM")
    src = out / "frame0.hdr"
    args = cli.build_parser().parse_args(
        ["enhance", "--input", str(src), "--output", "x.hdr"])
    params = {"omega": args.omega, "gamma": args.gamma,
              "L_low": args.l_low, "L_high": args.l_high}
    unit = uio.imread_unit(str(src))
    frames = {}
    for dev in ("cuda", "cpu"):
        _, launches, secs = run_cli(
            ["enhance", "--device", dev, "--input", str(src), "--output",
             str(out / f"enhanced_{dev}.hdr")], False)
        check(not any(launches.values()),
              f"other_formats: enhance on {dev} launched {launches}")
        e = enhance(unit, params, device=dev).cpu()
        frames[dev] = e
        e_u8 = (np.clip(e.numpy(), 0, 1) * 255).astype(np.uint8)
        check((out / f"enhanced_{dev}.hdr").read_bytes() == encode_hdr(e_u8),
              f"other_formats: enhance --device {dev} wrote another HDR "
              f"than its frame's")
        log("other_formats", command=f"'enhance --device {dev}' (HDR in "
            f"and out)", seconds=f"{secs:.2f}", card=repr(smi))
    d_e = float((frames["cuda"].double() - frames["cpu"].double()).abs().max())
    check(d_e <= 1e-6, f"other_formats: enhance card vs CPU {d_e} > 1e-6")
    same = (out / "enhanced_cuda.hdr").read_bytes() == (
        out / "enhanced_cpu.hdr").read_bytes()
    log("other_formats", function="enhance (HDR frame)", max_abs=d_e,
        files_byte_equal=same, six_outputs="byte-equal to the PNG's",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=repr(smi))


# [train_mesh]: MLPTrainer, ZooTrainer("vit"), the f32 VGGTrainer and the
# ResNet18 and EfficientNet b0 ZooTrainer at published widths on mesh None,
# one position and two positions of the one card; 3 steps from one seed
# with dropout on.  One position must be bit-equal to mesh None (cuDNN held
# deterministic for the phase, mesh None run twice to show the card repeats
# itself).  Two positions against mesh None: the step-1 loss (relative),
# the step-1 gradients (over the largest), BatchNorm's running statistics
# after step 1 (over the largest) and the parameters after the steps (the
# share over MESH_PARAM_ABS, each within 2 lr a step: Adam's first steps
# move an element by about lr * sign(g)).  Controls: one drops the last
# position's sums and gradients (it must fail every gate of the MLP and
# the ViT, the loss and gradient gates of the BatchNorm nets), one takes
# each BatchNorm net's statistics from each position's own rows (it must
# fail the loss and gradient gates).  The BatchNorm nets' f32 gradients
# move with the rows a BatchNorm call sees (the VGG's by 1.9e-4 of the
# largest when mesh None's rows are swapped in pairs on the card, ResNet18's
# by 2.3e-4 on the CPU at 224^2): their gradient gate is MESH_GRAD_REL_BN,
# and their parameters drift apart over the steps (the VGG's 0.46 of them,
# ResNet18's 0.71 with dropout on), so these are held to the 2-lr bound
# only.  ResNet18 and EfficientNet also run the step-1 gradient in f64 on
# mesh None and two positions, which must agree within MESH_F64_REL: the
# f32 gaps are rounding, not the mesh (tests/test_torch_train_mesh_f64.py)
MESH_STEPS = 3
MESH_TIMED_STEPS = 5
MESH_LOSS_REL = 1e-6
MESH_GRAD_REL = 1e-4
MESH_GRAD_REL_BN = 2e-3
MESH_STATS_REL = 1e-5
MESH_F64_REL = 1e-10
MESH_PARAM_ABS = 1e-6
MESH_FLIP_SHARE = 1e-3
MESH_RUNS = ("mlp", "vit", "vgg", "resnet", "efficientnet")
MESH_BATCHNORM = ("vgg", "resnet", "efficientnet")
MESH_F64 = ("resnet", "efficientnet")


def mesh_trainer(torch, label: str, dev, mesh, cache):
    """The trainer of a MESH_RUNS label at full width on ``mesh`` (the MLP
    reading ``cache``, the 79 features of the pairs; the VGG in f32 with
    its seeded perceptual trunk)."""
    import warnings

    from underwater_image_enhancement_tpu_torch.train import trainer as tr

    if label == "mlp":
        t = tr.MLPTrainer(mesh=mesh, device=dev)
        t._feature_cache = cache
        return t
    if label == "vgg":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the seeded perceptual trunk
            return tr.VGGTrainer(compute_dtype="float32", pretrained_vgg=None,
                                 mesh=mesh, device=dev)
    return tr.ZooTrainer(label, pretrained=None, mesh=mesh, device=dev)


def mesh_loss_grads(torch, tlayers, t, batch):
    """The step-1 loss, the gradients it leaves (by name) and the running
    statistics after it (by name), no update."""
    idx, imgs, refs, _ = batch
    with tlayers.no_tf32():
        t.optimizer.zero_grad(set_to_none=True)
        if t.sharded:
            loss = t._mesh_loss(idx, imgs, refs, True)
        else:
            t.model.train()
            loss = t._loss_fn(idx, imgs, refs, True)
            loss.backward()
    stats = {k: b.detach().clone() for k, b in t.model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return loss.detach(), {k: p.grad.detach().clone() for k, p in
                           t.model.named_parameters()
                           if p.grad is not None}, stats


def mesh_run(torch, tlayers, label, dev, mesh, cache, batch,
             steps=MESH_STEPS):
    """(step-1 loss, its gradients, the running statistics after it, the
    ``steps`` step losses, the parameters after them, the learning rate)
    of a fresh trainer; the first forward moves no parameter."""
    t = mesh_trainer(torch, label, dev, mesh, cache)
    loss, grads, stats = mesh_loss_grads(torch, tlayers, t, batch)
    idx, imgs, refs, _ = batch
    losses = torch.stack([t._step(idx, imgs, refs) for _ in range(steps)]
                         or [loss])
    params = {k: p.detach().clone() for k, p in t.model.named_parameters()}
    lr = t.optimizer.param_groups[0]["lr"]
    del t
    return loss, grads, stats, losses, params, lr


def step1_readings(got, want) -> dict:
    """The step-1 (loss, gradients, running statistics) ``got`` against
    ``want``: the loss relative, the rest over their largest."""
    loss, grads, stats = got
    loss0, grads0, stats0 = want
    gmax = max(float(g.abs().max()) for g in grads0.values())
    smax = max([float(v.abs().max()) for v in stats0.values()] or [1.0])
    return {"loss_rel": abs(float(loss) / float(loss0) - 1),
            "grad_rel": max(float((grads[k] - grads0[k]).abs().max())
                            for k in grads0) / gmax,
            "stats_rel": max([float((stats[k] - stats0[k]).abs().max())
                              for k in stats0] or [0.0]) / smax}


def mesh_readings(torch, got, want) -> dict:
    """``step1_readings`` of two ``mesh_run`` results, and their parameters
    after the steps: the largest difference, the share over
    MESH_PARAM_ABS."""
    params, params0 = got[4], want[4]
    over = sum(int(((params[k] - params0[k]).abs() > MESH_PARAM_ABS).sum())
               for k in params0)
    n = sum(p.numel() for p in params0.values())
    return {**step1_readings(got[:3], want[:3]),
            "param_max": max(float((params[k] - params0[k]).abs().max())
                             for k in params0),
            "flip_share": over / n}


def mesh_within(r: dict, label: str, lr: float) -> dict:
    bn = label in MESH_BATCHNORM
    return {"loss": r["loss_rel"] <= MESH_LOSS_REL,
            "grad": r["grad_rel"] <= (MESH_GRAD_REL_BN if bn
                                      else MESH_GRAD_REL),
            "stats": r["stats_rel"] <= MESH_STATS_REL,
            "params": ((r["flip_share"] <= MESH_FLIP_SHARE or bn)
                       and r["param_max"] <= 2.001 * lr * MESH_STEPS)}


def mesh_f64(torch, tlayers, label, dev, mesh, batch) -> tuple:
    """(step-1 loss, gradients, running statistics) of a fresh trainer
    with its model, ImageNet constants and batch in f64."""
    t = mesh_trainer(torch, label, dev, mesh, None)
    t.model.double()
    t._mean, t._inv_std = t._mean.double(), t._inv_std.double()
    idx, imgs, refs, _ = batch
    got = mesh_loss_grads(torch, tlayers, t,
                          (idx, imgs.double(), refs.double(), None))
    del t
    return got


@contextlib.contextmanager
def mesh_control(tr, tlayers, control: str):
    """A control of ``[train_mesh]`` for the block: "drop" drops the last
    position's sums and gradients (``trainer._mesh_sum``), "local" takes
    each position's BatchNorm statistics from its own rows
    (``layers.MeshStats.combine``)."""
    if control == "drop":
        owner, name = tr, "_mesh_sum"
        add = tr._mesh_sum
        patch = lambda parts: add(list(parts)[:-1])  # noqa: E731
    else:
        owner, name = tlayers.MeshStats, "combine"
        patch = staticmethod(lambda index, slot: slot[index])
    found = owner.__dict__[name]
    setattr(owner, name, patch)
    try:
        yield
    finally:
        setattr(owner, name, found)


def train_mesh_slice(torch, dev, train_ds, captured_match, runs,
                     smi: str) -> None:
    """[train_mesh] (the gates above).  The MLP's features come from one
    ``cache_features`` pass (K1b and K7 once a pair, captured and
    replayed with the other runs); the steps launch no kernel.  Then ms a
    step for mesh None against two positions, in turns."""
    from underwater_image_enhancement_tpu_torch.models import layers as tlayers
    from underwater_image_enhancement_tpu_torch.ops import kernels
    from underwater_image_enhancement_tpu_torch.parallel.mesh import Mesh
    from underwater_image_enhancement_tpu_torch.train import trainer as tr

    t_phase = time.perf_counter()
    one, two = Mesh((dev,)), Mesh((dev, dev))
    calls, restore = capture_calls(torch, kernels)
    kernels.reset_launches()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cache = mesh_trainer(torch, "mlp", dev, None, None)
        cache.cache_features(train_ds[256], log=lambda *_: None)
        cache = cache._feature_cache
        for label in MESH_RUNS:
            ds = train_ds[train_size(label)]
            batch = train_batch(torch, label, ds, dev)
            base = mesh_run(torch, tlayers, label, dev, None, cache, batch)
            again = mesh_run(torch, tlayers, label, dev, None, cache, batch)
            single = mesh_run(torch, tlayers, label, dev, one, cache, batch)
            for name, got in (("mesh None again", again),
                              ("one position", single)):
                check(torch.equal(got[0], base[0])
                      and torch.equal(got[3], base[3])
                      and got[1].keys() == base[1].keys()
                      and all(torch.equal(got[1][k], base[1][k])
                              for k in base[1])
                      and all(torch.equal(got[2][k], base[2][k])
                              for k in base[2])
                      and all(torch.equal(got[4][k], base[4][k])
                              for k in base[4]),
                      f"train_mesh {label}: {name} is not bit-equal to mesh "
                      "None")
            got = mesh_readings(torch, mesh_run(torch, tlayers, label, dev,
                                                two, cache, batch), base)
            bn = label in MESH_BATCHNORM
            controls = {}
            for control in ("drop", "local") if bn else ("drop",):
                with mesh_control(tr, tlayers, control):
                    controls[control] = mesh_readings(torch, mesh_run(
                        torch, tlayers, label, dev, two, cache, batch,
                        steps=0 if bn else MESH_STEPS), base)
            lr = base[5]
            ok = mesh_within(got, label, lr)
            f64 = {}
            if label in MESH_F64:
                f64 = step1_readings(
                    mesh_f64(torch, tlayers, label, dev, two, batch),
                    mesh_f64(torch, tlayers, label, dev, None, batch))
            log("train_mesh", run=label, batch=TRAIN_BATCH,
                size=train_size(label), steps=MESH_STEPS,
                one_position="bit-equal", mesh_none_repeat="bit-equal",
                **{k: f"{v:.3g}" for k, v in got.items()},
                **{f"{c}_{k}": f"{v:.3g}" for c, r in controls.items()
                   for k, v in r.items()},
                **{f"f64_{k}": f"{v:.3g}" for k, v in f64.items()},
                gates=f"loss<={MESH_LOSS_REL},grad<="
                      f"{MESH_GRAD_REL_BN if bn else MESH_GRAD_REL},"
                      f"stats<={MESH_STATS_REL},"
                      + ("param_max<=2lr/step" if bn
                         else f"share>{MESH_PARAM_ABS}<={MESH_FLIP_SHARE}")
                      + (f",f64<={MESH_F64_REL}" if f64 else ""))
            check(all(v <= MESH_F64_REL for v in f64.values()),
                  f"train_mesh {label}: two positions in f64 are not mesh "
                  f"None's: {f64}")
            check(all(ok.values()), f"train_mesh {label}: two positions "
                  f"outside the gates: {got}")
            for control, ctl in controls.items():
                held = mesh_within(ctl, label, lr)
                failed = (not held["loss"] and not held["grad"]
                          and (bn or not held["params"]))
                check(failed, f"train_mesh {label}: the {control} control "
                      f"passes a gate: {ctl}")
            del base, again, single
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
    finally:
        restore()
        torch.backends.cudnn.deterministic = deterministic
    check(captured_match(calls, launches)
          and launches == EXPECTED_SLICE["train_mlp"],
          f"train_mesh: launches {launches}")
    runs["train_mesh"] = (calls, launches, None)
    # ms a step, mesh None against two positions, in turns
    for label in MESH_RUNS:
        batch = train_batch(torch, label, train_ds[train_size(label)], dev)
        idx, imgs, refs, _ = batch
        ms = {"none": [], "two": []}
        for key in ("none", "two", "two", "none"):
            t = mesh_trainer(torch, label, dev, None if key == "none" else two,
                             cache)
            t._step(idx, imgs, refs)  # warm-up
            for _ in range(MESH_TIMED_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t._step(idx, imgs, refs)
                end.record()
                end.synchronize()
                ms[key].append(start.elapsed_time(end))
            del t
        log("train_mesh_timing", run=label, batch=TRAIN_BATCH,
            ms_per_step_mesh_none=f"{statistics.median(ms['none']):.3f}",
            ms_per_step_two_positions=f"{statistics.median(ms['two']):.3f}",
            steps=2 * MESH_TIMED_STEPS, card=repr(smi))
    log("train_mesh", seconds=f"{time.perf_counter() - t_phase:.1f}",
        launches=json.dumps(nonzero(launches), separators=(",", ":")))


# [dp]: the label program's gates on the card (features 1e-4 relative
# or 1e-5, scores 1e-3, the same winner unless the top two lie within
# 1e-2) between mesh positions and the single call; the enhance 1e-6
DP_SCORE_MAX_ABS = 1e-3
DP_FEATURE_REL, DP_FEATURE_ABS = 1e-4, 1e-5
DP_GAP = 1e-2
DP_ENHANCE_MAX_ABS = 1e-6
# kernels a frame of the auto and label programs launches whatever its
# descent (K7 and K6 follow the levels)
DP_PER_FRAME = {"lab_forward_unit": 1, "lab_forward_l_u8": 5,
                "clahe_apply": 1, "lab_inverse_unit": 1}


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def dp_compare(torch, what, got, want) -> dict:
    """A mesh run of the label or auto program against the single call:
    (features,) scores, best, frames.  Returns the differing counts."""
    if len(want) == 4:
        feats, scores, best, imgs = got
        w_feats, w_scores, w_best, w_imgs = want
        err = (feats.double() - w_feats.double()).abs()
        ok = (err <= DP_FEATURE_REL * w_feats.double().abs()) | (
            err <= DP_FEATURE_ABS)
        check(feats.shape == w_feats.shape and bool(ok.all()),
              f"{what}: features off at {torch.nonzero(~ok).tolist()[:8]}")
        diff = {"features": int((feats != w_feats).sum())}
    else:
        imgs, best, scores = got
        w_imgs, w_best, w_scores = want
        diff = {}
    sd = float((scores - w_scores).abs().max())
    check(scores.shape == w_scores.shape and sd <= DP_SCORE_MAX_ABS,
          f"{what}: scores differ by {sd}")
    for j in range(len(w_best)):
        top = torch.sort(w_scores[j], descending=True).values
        if float(top[0] - top[1]) >= DP_GAP:
            check(int(best[j]) == int(w_best[j]),
                  f"{what}: frame {j} winner {int(best[j])}, single call "
                  f"{int(w_best[j])}")
        if int(best[j]) == int(w_best[j]):
            q = [(torch.clamp(x, 0, 1) * 255).to(torch.uint8)
                 for x in (imgs[j], w_imgs[j])]
            check(torch.equal(q[0], q[1]),
                  f"{what}: frame {j}'s u8 winner differs from the single "
                  "call's")
    diff.update(scores=int((scores != w_scores).sum()),
                winners=int((best != w_best).sum()),
                frame_values=int((imgs != w_imgs).sum()))
    return diff


def dp_slice(torch, dev, frames, run_cli, captured_match, runs, smi,
             device_args=()) -> None:
    """[dp]: data parallelism over a mesh on the one card, rehearsed as
    mesh positions that repeat it: ``run_data_parallel`` of
    ``auto_enhance_batch`` and of the label program on the three frames
    with 2 positions (padded to 4) and 3, ``label_batch_dp`` and
    ``enhance_batch_dp`` on 3 positions (3 frames) and 2 (2 frames), each
    against its single call (the differing values printed; the kernel
    calls captured into ``runs`` and replayed with the others); ``cli
    build-dataset`` and ``cli enhance`` with ``--devices 1`` against their
    runs without it (the same bytes); ``examples.main("all")`` and
    ``profiling.trace`` around one frame on the card; then ms a frame of
    the label and auto programs for mesh None against 3 positions, in
    turns.  ``device_args`` are added to each command (none: the
    card)."""
    from underwater_image_enhancement_tpu_torch import examples
    from underwater_image_enhancement_tpu_torch.ops import kernels
    from underwater_image_enhancement_tpu_torch.parallel.mesh import (
        Mesh,
        run_data_parallel,
    )
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        auto_enhance_batch,
        enhance_batch,
        enhance_batch_dp,
        six_strategy_tuple,
    )
    from underwater_image_enhancement_tpu_torch.select.system import (
        label_batch,
        label_batch_dp,
    )
    from underwater_image_enhancement_tpu_torch.utils import profiling
    from underwater_image_enhancement_tpu_torch.utils.config import (
        DEFAULT_QUALITY_WEIGHTS as w8,
    )

    host = torch.from_numpy(np.stack(frames))
    batch = host.to(dev)
    meshes = {2: Mesh((dev,) * 2), 3: Mesh((dev,) * 3)}
    check(all(d.type != "cuda" or d.index is not None
              for m in meshes.values() for d in m.devices),
          f"mesh devices unindexed: {meshes}")
    single = {"auto": auto_enhance_batch(batch, device=dev),
              "label": label_batch(batch, w8)}
    programs = {
        "auto": lambda x: auto_enhance_batch(x, device=x.device),
        "label": lambda x: label_batch(x, w8),
    }

    def counted(key, fn):
        calls, restore = capture_calls(torch, kernels)
        t0 = time.perf_counter()
        try:
            kernels.reset_launches()
            out = fn()
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
        finally:
            restore()
        check(captured_match(calls, launches),
              f"{key}: captured calls vs launches {launches}")
        runs[key] = (calls, launches, None)
        return out, launches, time.perf_counter() - t0

    for name, fn in programs.items():
        for n, m in meshes.items():
            seen = []

            def shard(x, fn=fn):
                seen.append(int(x.shape[0]))
                return fn(x)

            out, launches, secs = counted(
                f"dp_{name}_{n}", lambda: run_data_parallel(shard, host, m))
            diff = dp_compare(torch, f"run_data_parallel({name}) on {n}",
                              out, single[name])
            frames_run = sum(seen)
            check(seen == ([2, 2] if n == 2 else [1, 1, 1]),
                  f"{name} on {n} positions: shards {seen}")
            check(all(launches[k] == v * frames_run
                      for k, v in DP_PER_FRAME.items()),
                  f"{name} on {n} positions: launches {launches} for "
                  f"{frames_run} frames")
            if n == 3:
                same = runs["auto" if name == "auto" else "build"][1]
                check(launches == same, f"{name} on 3 positions launched "
                      f"{launches}, the single-device CLI run {same}")
            log("dp", program=name, positions=n, shards=",".join(
                map(str, seen)), seconds=f"{secs:.2f}",
                differing=json.dumps(diff, separators=(",", ":")),
                launches=json.dumps(nonzero(launches), separators=(",", ":")))
    for n, m in meshes.items():
        imgs = batch[:n]
        want = [t[:n] for t in single["label"]]
        got, launches, secs = counted(
            f"dp_label_batch_dp_{n}", lambda: label_batch_dp(imgs, w8, m))
        diff = dp_compare(torch, f"label_batch_dp on {n}", got, want)
        e_want = enhance_batch(imgs, 10.0, 90.0, 0.6, 1.2, device=dev)
        e_got = enhance_batch_dp(imgs, 10.0, 90.0, 0.6, 1.2, m)
        ed = float((e_got - e_want).abs().max())
        check(e_got.shape == e_want.shape and ed <= DP_ENHANCE_MAX_ABS,
              f"enhance_batch_dp on {n}: max |d| {ed}")
        diff["enhance_values"] = int((e_got != e_want).sum())
        log("dp", function="label_batch_dp,enhance_batch_dp", positions=n,
            frames=n, seconds=f"{secs:.2f}", enhance_max_abs=ed,
            differing=json.dumps(diff, separators=(",", ":")),
            launches=json.dumps(nonzero(launches), separators=(",", ":")))

    # the CLI with --devices 1 (one plain call, as unset on one card)
    src = WORK / "in"
    for key, argv, ref, pattern in (
            ("build", ["build-dataset", "--input", str(src), "--output",
                       str(WORK / "dp_build")], WORK / "build",
             "strategy_results/*.png"),
            ("enhance", ["enhance", "--input", str(src), "--output",
                         str(WORK / "dp_enhance")], WORK / "enhance",
             "*.png")):
        out_dir = Path(argv[4])
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            _, launches, secs = run_cli(
                argv + ["--devices", "1"] + list(device_args), False)
        got = {p.relative_to(out_dir): p.read_bytes()
               for p in sorted(out_dir.glob(pattern))}
        want = {p.relative_to(ref): p.read_bytes()
                for p in sorted(ref.glob(pattern))}
        check(len(got) == 3 and got == want,
              f"{key} --devices 1: outputs differ from the run without it")
        if key == "build":
            csv_path = Path("reports") / "dataset_building.csv"
            check((out_dir / csv_path).read_bytes()
                  == (ref / csv_path).read_bytes(),
                  "build-dataset --devices 1: the CSV differs")
            check(launches == runs["build"][1],
                  f"build-dataset --devices 1 launched {launches}")
        runs[f"dp_cli_{key}"] = ({}, launches, None)
        log("dp", command=" ".join(argv[:1] + ["--devices", "1"]),
            same_bytes=True, outputs=len(got), seconds=f"{secs:.2f}")

    # the examples and a trace on the card
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        examples.main("all", device=dev)
    text = printed.getvalue()
    heads = [ln for ln in text.splitlines() if ln.startswith("--- ")]
    check(len(heads) == 7 and "nan" not in text
          and f"Phase-1 data mesh on {dev}: None" in text,
          f"examples printed {text!r}")
    trace_dir = WORK / "trace"
    timer = profiling.StageTimer()
    with profiling.trace(str(trace_dir)):
        with timer.stage("six_exact", sync_on=dev):
            six_strategy_tuple(frames[0], device=dev)
    traces = list(trace_dir.glob("trace_*.json"))
    check(len(traces) == 1, f"profiling.trace wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    check(len(events) > 0, "profiling.trace wrote no event")
    log("dp", examples=len(heads), trace_events=len(events),
        trace_package_kernels=sum(any(k in str(e.get("name", ""))
                                      for k in OUR_KERNELS) for e in events),
        six_exact_stage_s=f"{timer.totals['six_exact']:.3f}",
        validate="'not driven here: its float64 oracles need cv2, which this "
                 "machine lacks; the CPU tests hold it to JAX'")

    # ms a frame, mesh None against 3 positions on the one card, in turns
    for name, fn in programs.items():
        ms = {"none": [], "mesh3": []}
        for key in ("none", "mesh3", "mesh3", "none") * 2:
            call = ((lambda: fn(batch)) if key == "none" else
                    (lambda: run_data_parallel(fn, batch, meshes[3])))
            ms[key] += [t / 3 for t in event_ms(torch, call, 4, warmup=1)]
        log("dp_timing", program=name, frames=3,
            **{f"{k}_ms_per_frame_{s}": v for k in ms
               for s, v in spread(ms[k]).items()},
            none_runs=",".join(f"{t:.3f}" for t in ms["none"]),
            mesh3_runs=",".join(f"{t:.3f}" for t in ms["mesh3"]),
            card=repr(smi),
            note="'3 positions on one card: no overlap is measured'")


# [spatial]: one 2160x3840 frame sharded on rows over mesh positions of the
# one card (SPATIAL_*): six_strategy_spatial at 1, 2 and 8 positions (8:
# 270-row blocks, the masked percentiles and the strip guided filter; 2:
# 1080-row blocks, the aligned path), ancuti_fusion_spatial at 2 and 8
# (135-row blocks at 8, no pad), WaterNet's enhance_sharded; the gates of
# the JAX suite's tests/test_six_spatial.py
SPATIAL_H, SPATIAL_W = 2160, 3840
SPATIAL_POSITIONS = (1, 2, 8)
SPATIAL_DEHAZE_DB = 55.0
SPATIAL_EXACT_MAX_ABS = 1e-5
SPATIAL_FUSION_DB = 55.0
SPATIAL_CPU_HW = (270, 480)


def psnr_db(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def spatial_launches(positions: int, legs: int, airlight: bool) -> dict:
    """Launches of one sharded frame: K1b and K3b once a CLAHE leg and
    block, K7 (the halo'd Canny) and K6 (the local row table) once a
    block."""
    out = {**NONE, "lab_forward_u8": legs * positions,
           "lab_inverse_u8": legs * positions}
    if airlight:
        out.update(hysteresis_propagate=positions, sat_rows=positions)
    return out


@contextlib.contextmanager
def airlight_recorded(tss):
    """Records the sharded airlight of each ``six_strategy_spatial`` run
    inside, read from that run: a dict a run with its A (3,) on the
    host, its final box (r0, c0, h, w) and the box of each quadtree
    level (``path``)."""
    runs, descend, airlight = [], tss.quadtree_descend, tss._airlight_sharded

    def traced_descend(corners, h, w, min_size=1):
        path = []

        def corners_at(rows, cols):
            path.append((int(rows[0]), int(cols[0]), int(rows[2] - rows[0]),
                         int(cols[2] - cols[0])))
            return corners(rows, cols)
        box = descend(corners_at, h, w, min_size)
        runs.append({"box": tuple(int(v) for v in box), "path": path})
        return box

    def traced_airlight(*args, **kwargs):
        A = airlight(*args, **kwargs)
        runs[-1]["A"] = A[0].cpu()
        return A

    tss.quadtree_descend, tss._airlight_sharded = (traced_descend,
                                                   traced_airlight)
    try:
        yield runs
    finally:
        tss.quadtree_descend, tss._airlight_sharded = descend, airlight


def spatial_slice(torch, dev, captured_match, runs, smi, wn_gpu) -> None:
    """[spatial]: one 2160x3840 frame sharded on rows over 1, 2 and 8 mesh
    positions of the one card.  six_strategy_spatial: the cast code, the
    airlight A and its final box of each run (``airlight_recorded``)
    equal at every position count and the six outputs bit-equal to one
    position's (where A differs, the level where the descents part is
    printed, the dehazing outputs held at SPATIAL_DEHAZE_DB and the other
    three bit-equal); its launches (``spatial_launches``); ms a frame at
    each count, in turns, and peak memory.  ancuti_fusion_spatial on 2
    and 8 positions against ``ancuti_fusion`` on the card
    (SPATIAL_EXACT_MAX_ABS and SPATIAL_FUSION_DB).  WaterNet at its
    default widths: ``enhance_sharded(shard_rows=True)`` on 2 positions
    within WATERNET_MAX_ABS of ``waternet_enhance`` on the whole frame (a
    TF32 control must fail the gate), and the batch mode on two 1080p
    frames.  The card against the port's CPU path: six_strategy_spatial
    of a 270x480 frame (padded to 272 rows) on 2 positions, A and box
    equal and all six within SPATIAL_EXACT_MAX_ABS.  Every kernel call is
    captured into ``runs`` and replayed with the others."""
    from underwater_image_enhancement_tpu_torch.models import layers
    from underwater_image_enhancement_tpu_torch.models import waternet as twn
    from underwater_image_enhancement_tpu_torch.ops import kernels
    from underwater_image_enhancement_tpu_torch.parallel import (
        six_spatial as tss,
    )
    from underwater_image_enhancement_tpu_torch.parallel.fusion_spatial import (
        ancuti_fusion_spatial,
    )
    from underwater_image_enhancement_tpu_torch.parallel.mesh import Mesh
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        SIX_ORDER,
    )
    from underwater_image_enhancement_tpu_torch.pipeline.fusion import (
        ancuti_fusion,
    )

    t_phase = time.perf_counter()
    frame = torch.from_numpy(synthetic_frame(3, SPATIAL_H, SPATIAL_W)).to(dev)
    meshes = {n: Mesh((dev,) * n) for n in SPATIAL_POSITIONS + (2, 8)}

    def counted(key, fn, expected):
        calls, restore = capture_calls(torch, kernels)
        try:
            kernels.reset_launches()
            out = fn()
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
        finally:
            restore()
        check(captured_match(calls, launches),
              f"{key}: captured calls vs launches {launches}")
        check(launches == expected, f"{key}: launches {nonzero(launches)}, "
              f"expected {nonzero(expected)}")
        runs[key] = (calls, launches, None)
        return out

    def six_of(img, mesh, key=None):
        """six_strategy_spatial of a frame with the airlight of that run
        (``airlight_recorded``), its launches counted under ``key`` where
        one is given -> (outs, code, airlight)."""
        def run():
            return tss.six_strategy_spatial(img, mesh)

        with airlight_recorded(tss) as air:
            outs, code = run() if key is None else counted(
                key, run, spatial_launches(mesh.size, 5, True))
        check(len(air) == 1 and "A" in air[0],
              f"{key}: {len(air)} airlight descents recorded")
        return outs, code, air[0]

    def compare(what, got, want, code, want_code, air, want_air, exact):
        """The six outputs against the reference's: the cast code equal;
        where the airlight A and box are equal, all six bit-equal
        (``exact``) or within SPATIAL_EXACT_MAX_ABS; where they differ,
        the dehazing three at SPATIAL_DEHAZE_DB and the others so.  -> (A
        and box equal, the level where the descents part, max |d| each)."""
        check(int(code) == int(want_code),
              f"{what}: cast code {int(code)} vs {int(want_code)}")
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{what}: shape {tuple(got.shape)} or non-finite values")
        same_a = (air["box"] == want_air["box"]
                  and torch.equal(air["A"], want_air["A"]))
        parted = None if same_a else next(
            (k for k, (a, b) in enumerate(zip(air["path"], want_air["path"]))
             if a != b), min(len(air["path"]), len(want_air["path"])))
        diffs = {}
        for k, n in enumerate(SIX_ORDER):
            a, b = got[k], want[k]
            diffs[n] = float((a.double() - b.double()).abs().max())
            if k < 3 and not same_a:
                check(psnr_db(a, b) >= SPATIAL_DEHAZE_DB,
                      f"{what} {n}: {psnr_db(a, b):.1f} dB")
            elif exact:
                check(torch.equal(a, b), f"{what} {n}: max |d| {diffs[n]}")
            else:
                check(diffs[n] <= SPATIAL_EXACT_MAX_ABS,
                      f"{what} {n}: max |d| {diffs[n]}")
        return same_a, parted, diffs

    # six_strategy_spatial at 1, 2 and 8 positions
    six, air, peak = {}, {}, {}
    for n in SPATIAL_POSITIONS:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs, code, air[n] = six_of(frame, meshes[n], f"spatial_six_{n}")
        six[n] = (outs, code)
        peak[n] = torch.cuda.max_memory_allocated() - base
    for n in SPATIAL_POSITIONS:
        outs, code = six[n]
        same_a, parted, diffs = compare(
            f"six_strategy_spatial on {n}", outs, six[1][0], code, six[1][1],
            air[n], air[1], True)
        log("spatial", function="six_strategy_spatial", positions=n,
            rows_a_block=SPATIAL_H // n, code=int(code),
            A=json.dumps(air[n]["A"].tolist()), box=air[n]["box"],
            A_equal_one_position=same_a, descents_part_at_level=parted,
            max_abs_vs_one_position=json.dumps(diffs, separators=(",", ":")),
            launches=json.dumps(nonzero(runs[f"spatial_six_{n}"][1]),
                                separators=(",", ":")),
            peak_mib=f"{peak[n] / 2 ** 20:.1f}")
    del six, outs

    # ms a 4K frame at each position count, in turns
    ms = {n: [] for n in SPATIAL_POSITIONS}
    for n in SPATIAL_POSITIONS + SPATIAL_POSITIONS[::-1]:
        ms[n] += event_ms(torch, lambda n=n: tss.six_strategy_spatial(
            frame, meshes[n]), 2, warmup=0)
    for n in SPATIAL_POSITIONS:
        log("spatial_timing", function="six_strategy_spatial",
            frame=f"{SPATIAL_H}x{SPATIAL_W}", positions=n,
            ms=",".join(f"{t:.3f}" for t in ms[n]),
            median_ms=f"{statistics.median(ms[n]):.3f}",
            peak_mib=f"{peak[n] / 2 ** 20:.1f}", card=repr(smi),
            note="'positions on one card: no overlap across cards is "
                 "measured'")

    # the Ancuti fusion at 2 and 8 positions against the single device
    want = ancuti_fusion(frame)
    for n in (2, 8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = counted(f"spatial_fusion_{n}", lambda n=n: ancuti_fusion_spatial(
            frame, meshes[n]), spatial_launches(n, 1, False))
        secs = time.perf_counter() - t0
        db = psnr_db(got, want)
        d = float((got.double() - want.double()).abs().max())
        check(got.shape == want.shape and d <= SPATIAL_EXACT_MAX_ABS
              and db > SPATIAL_FUSION_DB,
              f"ancuti_fusion_spatial on {n}: max |d| {d}, {db:.1f} dB")
        log("spatial", function="ancuti_fusion_spatial", positions=n,
            psnr_db=f"{db:.2f}",
            gate=f"'<= {SPATIAL_EXACT_MAX_ABS} and > {SPATIAL_FUSION_DB} dB'",
            max_abs=d, seconds=f"{secs:.3f}",
            launches=json.dumps(nonzero(runs[f"spatial_fusion_{n}"][1]),
                                separators=(",", ":")))
    del want, got

    # WaterNet: one 4K frame's rows on 2 positions, and the batch mode
    with tf32(torch, cudnn=True, matmul=True):
        x = frame[None]
        whole = twn.waternet_enhance(wn_gpu, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = counted("spatial_waternet_rows", lambda: twn.enhance_sharded(
            wn_gpu, x, meshes[2], shard_rows=True), NONE)
        secs = time.perf_counter() - t0
        d_rows = float((rows - whole).abs().max())
        check(rows.shape == whole.shape and d_rows <= WATERNET_MAX_ABS,
              f"enhance_sharded rows: max |d| {d_rows}")
        guard = layers.no_tf32
        layers.no_tf32 = contextlib.nullcontext
        try:
            d_tf32 = float((twn.enhance_sharded(
                wn_gpu, x, meshes[2], shard_rows=True) - whole).abs().max())
        finally:
            layers.no_tf32 = guard
        check(d_tf32 > WATERNET_MAX_ABS,
              f"enhance_sharded rows: TF32 moved it by {d_tf32} only")
        del rows, whole
        pair = torch.nn.functional.interpolate(
            frame.permute(2, 0, 1)[None], scale_factor=0.5, mode="area"
        )[0].permute(1, 2, 0)
        pair = torch.stack([pair, pair.flip(1)]).contiguous()
        batch = counted("spatial_waternet_batch", lambda: twn.enhance_sharded(
            wn_gpu, pair, meshes[2]), NONE)
        d_batch = float((batch - twn.waternet_enhance(wn_gpu, pair))
                        .abs().max())
        check(batch.shape == pair.shape and d_batch <= WATERNET_BATCH_MAX_ABS,
              f"enhance_sharded batch: max |d| {d_batch}")
    log("spatial", function="enhance_sharded", model="WaterNet(128, 32)",
        rows_frame=f"{SPATIAL_H}x{SPATIAL_W}", positions=2,
        rows_max_abs=d_rows, gate=f"<= {WATERNET_MAX_ABS}",
        tf32_max_abs=d_tf32, rows_seconds=f"{secs:.3f}",
        batch="x".join(map(str, pair.shape[:3])), batch_max_abs=d_batch,
        batch_gate=f"<= {WATERNET_BATCH_MAX_ABS}")

    # the card against the port's CPU path, 270x480 (padded to 272)
    h, w = SPATIAL_CPU_HW
    small = synthetic_frame(4, h, w)
    g_out, g_code, g_air = six_of(small, meshes[2], "spatial_six_card_vs_cpu")
    c_out, c_code, c_air = six_of(small, Mesh((torch.device("cpu"),) * 2))
    same_a, parted, diffs = compare("six_strategy_spatial card vs CPU",
                                    g_out.cpu(), c_out, g_code, c_code,
                                    g_air, c_air, False)
    check(same_a, f"card vs CPU: airlight {g_air['A'].tolist()} "
          f"{g_air['box']} vs {c_air['A'].tolist()} {c_air['box']}")
    log("spatial", function="six_strategy_spatial", frame=f"{h}x{w}",
        positions=2, card_vs_cpu=True, code=int(c_code),
        A=json.dumps(c_air["A"].tolist()), box=c_air["box"],
        max_abs=json.dumps(diffs, separators=(",", ":")))
    log("spatial", seconds=f"{time.perf_counter() - t_phase:.1f}",
        card=repr(smi))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from underwater_image_enhancement_tpu_torch import cli
    from underwater_image_enhancement_tpu_torch.ops import airlight
    from underwater_image_enhancement_tpu_torch.ops import colorspace as tcs
    from underwater_image_enhancement_tpu_torch.ops import histeq, kernels
    from underwater_image_enhancement_tpu_torch.ops.colorspace import (
        quantize_u8,
        u8_to_unit,
    )
    from underwater_image_enhancement_tpu_torch.ops.layout import split_planes
    from underwater_image_enhancement_tpu_torch.ops.stretch import U8_GRID
    from underwater_image_enhancement_tpu_torch.pipeline import cast as cast_mod
    from underwater_image_enhancement_tpu_torch.pipeline.fusion import (
        ancuti_fusion,
    )
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        CONFIG_ORDER,
        SIX_ORDER,
        auto_enhance_batch,
        enhance_batch,
        six_strategy_tuple,
    )
    from underwater_image_enhancement_tpu_torch.features.full import (
        extract_all_features,
    )
    from underwater_image_enhancement_tpu_torch.metrics.quality import (
        comprehensive_assessment,
        comprehensive_planes,
    )
    from underwater_image_enhancement_tpu_torch.metrics.uiqm import uciqe, uiqm
    from underwater_image_enhancement_tpu_torch.pipeline.strategies import (
        DEHAZE,
        STRATEGY_DISPLAY,
        strategy_planes,
    )
    from underwater_image_enhancement_tpu_torch.models import bridge
    from underwater_image_enhancement_tpu_torch.models import layers as tlayers
    from underwater_image_enhancement_tpu_torch.models import vgg as tvgg
    from underwater_image_enhancement_tpu_torch.models import waternet as twn
    from underwater_image_enhancement_tpu_torch.models.predictor import (
        EnhancementPredictor,
        ZooPredictor,
    )
    from underwater_image_enhancement_tpu_torch.select.mlp_classifier import (
        FlaxMLPClassifier,
    )
    from underwater_image_enhancement_tpu_torch.select.system import (
        label_batch,
    )
    from underwater_image_enhancement_tpu_torch.utils.config import (
        DEFAULT_QUALITY_WEIGHTS,
    )
    from underwater_image_enhancement_tpu_torch.pipeline.six import (
        airlight as tier_airlight,
        run_strategy,
    )
    from underwater_image_enhancement_tpu_torch.utils import cuda_build
    from underwater_image_enhancement_tpu_torch.utils import io as uio

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. card -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    bw = hbm_bytes_per_s(name)
    log("card", name=repr(name), torch=torch.__version__,
        cuda=torch.version.cuda, hbm_bytes_per_s=bw)

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    ext = cuda_build.extension()
    log("build", seconds=f"{time.perf_counter() - t0:.1f}",
        extension=Path(ext.__file__).name)

    # 3. kernels against their plain versions -----------------------------
    err = {k: 0.0 for k in KERNELS}
    checked = {k: 0 for k in KERNELS}

    def expect_equal(kname, got, want, what):
        for g_, w_ in zip(got, want):
            e = float((g_.double() - w_.double()).abs().max())
            err[kname] = max(err[kname], e)
            check(g_.shape == w_.shape and torch.equal(g_, w_),
                  f"{kname} differs from its plain version on {what}: "
                  f"max |d| = {e}")
        checked[kname] += 1

    def replay(kname, args, what):
        """The kernel and its plain version on the same arguments."""
        got = getattr(kernels, kname)(*args)
        want = getattr(kernels, KERNELS[kname][3])(*args)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        expect_equal(kname, got, want, what)

    grid = torch.as_tensor(U8_GRID, device=dev)
    idx = torch.arange(1 << 24, device=dev, dtype=torch.int32).reshape(4096, 4096)
    trip = tuple(((idx >> s) & 255).contiguous() for s in (16, 8, 0))
    rgb = tuple(grid[t.long()] for t in trip)
    replay("lab_forward_unit", rgb, "all 2^24 u8 RGB triples")
    replay("lab_forward_unit_approx", rgb, "all 2^24 u8 RGB triples")
    # K9: both probes on the card against the plain probe on the CPU
    probes = {}
    for tname in ("cbrt", "inv_gamma"):
        got = kernels.surrogate_values(tname, dev)
        expect_equal("surrogate_corrections", (got.cpu(),),
                     (kernels.surrogate_values_plain(tname, "cpu"),),
                     f"every {tname} table index")
        probes[tname] = kernels.surrogate_corrections(tname, dev)
        check(probes[tname] == kernels.surrogate_corrections_plain(tname, "cpu"),
              f"{tname}: the card's corrections {probes[tname]} are not the CPU's")
    check(probes["cbrt"] is not None, "the cube-root probe gave None on the "
          "card: K8 _fast would read the table")
    log("probe", cbrt_fixups=len(probes["cbrt"][0]),
        cbrt=json.dumps(probes["cbrt"], separators=(",", ":")),
        inv_gamma=json.dumps(probes["inv_gamma"], separators=(",", ":")))
    replay("lab_forward_unit_fast", rgb, "all 2^24 u8 RGB triples")
    fast_vs_k1 = sum(int((f != e).sum()) for f, e in zip(
        kernels.lab_forward_unit_fast(*rgb), kernels.lab_forward_unit(*rgb)))
    approx_d = max(int((a - e).abs().max()) for a, e in zip(
        kernels.lab_forward_unit_approx(*rgb), kernels.lab_forward_unit(*rgb)))
    check(approx_d == 1, f"approximate LAB off exact by {approx_d}, not 1")
    replay("lab_forward_u8", trip, "all 2^24 u8 RGB triples")
    replay("lab_forward_l_u8", trip, "all 2^24 u8 RGB triples")
    lab_u8 = kernels.lab_forward_u8(*trip)
    check(torch.equal(kernels.lab_forward_l_u8(*trip), lab_u8[0]),
          "K4 differs from K1b's L plane")
    check(all(torch.equal(a, b) for a, b in
              zip(lab_u8, kernels.lab_forward_unit(*rgb))),
          "K1b differs from K1 on the u8 grid")
    del lab_u8
    gen = torch.Generator(device=dev).manual_seed(1)
    wide = tuple(torch.randint(-300, 600, (H, W), generator=gen, device=dev,
                               dtype=torch.int32) for _ in range(3))
    replay("lab_forward_u8", wide, f"{H}x{W} int32 values in [-300, 600)")
    replay("lab_forward_l_u8", wide, f"{H}x{W} int32 values in [-300, 600)")
    del wide
    # the forward-LAB kernels' vector path, its scalar tail and the scalar
    # loop of misaligned planes, one launch a call
    for shape in LAB_SHAPES:
        cases = []
        for offsets in LAB_OFFSETS:
            for kname in LAB_WRAPPERS:
                args = lab_planes(torch, kname, shape, offsets, gen, dev)
                replay(kname, args, f"{shape} planes at offsets {offsets}")
                cases.append((getattr(kernels, kname), args))
        names = cuda_kernel_names(
            torch, lambda: [fn(*args) for fn, args in cases], expect=len(cases))
        check(len(names) == len(cases)
              and all("lab_forward_kernel" in n for n in names),
              f"forward LAB on {shape}: {len(cases)} calls launched "
              f"{len(names)} kernels")
        del cases
    lab_info = {k: dict(zip(("regs", "local_bytes", "blocks_per_sm", "grid",
                             "threads"), ext.lab_forward_info(i, H * W)))
                for i, k in enumerate(LAB_WRAPPERS)}
    log("kernels", lab_forward_sweep=len(LAB_SHAPES) * len(LAB_OFFSETS)
        * len(LAB_WRAPPERS), launches_per_call=1,
        lab_forward_1080p=json.dumps(lab_info, separators=(",", ":")))
    # the inverse-LAB kernels over the same sweep, and CLAHE apply over its
    # own, one launch a call
    for shape in LAB_SHAPES:
        cases = []
        for offsets in LAB_OFFSETS:
            for kname in INV_WRAPPERS:
                args = lab_planes(torch, kname, shape, offsets, gen, dev)
                replay(kname, args, f"{shape} planes at offsets {offsets}")
                cases.append((getattr(kernels, kname), args))
        names = cuda_kernel_names(
            torch, lambda: [fn(*args) for fn, args in cases], expect=len(cases))
        check(len(names) == len(cases)
              and all("lab_inverse_kernel" in n for n in names),
              f"inverse LAB on {shape}: {len(cases)} calls launched "
              f"{len(names)} kernels")
        del cases
    n_clahe = 0
    for shape in CLAHE_SHAPES:
        cases = clahe_cases(torch, histeq, shape, gen, dev)
        for args in cases:
            replay("clahe_apply", args,
                   f"{shape} at offset {args[0].storage_offset()}, tiles "
                   f"{args[8]}x{args[9]}, LUTs {int(args[1].min())}.."
                   f"{int(args[1].max())}")
        names = cuda_kernel_names(
            torch, lambda: [kernels.clahe_apply(*args) for args in cases],
            expect=len(cases))
        check(len(names) == len(cases)
              and all("clahe_apply_kernel" in n for n in names),
              f"CLAHE apply on {shape}: {len(cases)} calls launched "
              f"{len(names)} kernels")
        n_clahe += len(cases)
        del cases
    # the ring refilled again and again, and K2's strips on a large plane:
    # each kernel 12 times on 4096x4096 planes
    big = lab_planes(torch, "lab_inverse_u8", (4096, 4096), (0, 0, 0), gen,
                     dev)
    big_clahe = clahe_cases(torch, histeq, (4096, 4096), gen, dev)[0]
    for kname, args in (("lab_inverse_unit", big),
                        ("lab_inverse_unit_gamma", big + (1.4,)),
                        ("lab_inverse_u8", big), ("clahe_apply", big_clahe)):
        want = getattr(kernels, KERNELS[kname][3])(*args)
        want = (want,) if isinstance(want, torch.Tensor) else want
        for k in range(12):
            got = getattr(kernels, kname)(*args)
            got = (got,) if isinstance(got, torch.Tensor) else got
            expect_equal(kname, got, want, f"4096x4096 planes, call {k}")
    del big, big_clahe, want, got
    inv_info = {k: dict(zip(("regs", "local_bytes", "blocks_per_sm", "grid",
                             "threads"), ext.lab_inverse_info(i, H * W)))
                for i, k in enumerate(("lab_inverse_unit_and_gamma",
                                       "lab_inverse_u8"))}
    geo = histeq._geometry(H, W, 8, 8)
    clahe_info = dict(zip(("regs", "local_bytes", "blocks_per_sm", "grid_x",
                           "grid_y", "strip_rows", "threads"),
                          ext.clahe_apply_info(geo.th, 8, 8)))
    check(clahe_info["strip_rows"] == kernels.clahe_strip_rows(
        geo.th, 8, 8, clahe_info["blocks_per_sm"]
        * torch.cuda.get_device_properties(0).multi_processor_count),
        f"CLAHE apply's strips {clahe_info} differ from clahe_strip_rows")
    log("kernels", lab_inverse_sweep=len(LAB_SHAPES) * len(LAB_OFFSETS)
        * len(INV_WRAPPERS), clahe_apply_sweep=n_clahe, launches_per_call=1,
        repeats_4096x4096=12,
        lab_inverse_1080p=json.dumps(inv_info, separators=(",", ":")),
        clahe_apply_1080p=json.dumps(clahe_info, separators=(",", ":")))
    replay("lab_inverse_unit", trip, "all 2^24 (L, a, b) triples")
    replay("lab_inverse_u8", trip, "all 2^24 (L, a, b) triples")
    expect_equal("lab_inverse_unit", kernels.lab_inverse_unit(*trip),
                 [u8_to_unit(v) for v in kernels.lab_inverse_u8(*trip)],
                 "all 2^24 (L, a, b) triples, K3 = K3b / 255")
    for g in GAMMAS:
        replay("lab_inverse_unit_gamma", trip + (g,),
               f"all 2^24 (L, a, b) triples, gamma {g}")
    del idx, trip, rgb
    rng = torch.Generator(device=dev).manual_seed(0)
    for hh, ww in ((H, W), (1079, 1917)):
        yy = torch.arange(hh, device=dev)[:, None]
        xx = torch.arange(ww, device=dev)[None, :]
        smooth = (yy * 255 // hh + xx * 64 // ww) % 256
        noise = torch.randint(-20, 21, (hh, ww), generator=rng, device=dev)
        plane = torch.clamp(smooth + noise, 0, 255).to(torch.int32)
        a_p, b_p = (torch.randint(0, 256, (hh, ww), generator=rng, device=dev,
                                  dtype=torch.int32) for _ in range(2))
        for clip in CLIPS:
            luts, ya, xa, geo = histeq.clahe_prep(plane, clip, 8, 8)
            replay("clahe_apply", (plane, luts, ya, xa, *geo),
                   f"{hh}x{ww} clip {clip}")
            args = (plane, a_p, b_p, luts, ya, xa, *geo)
            replay("clahe_lab_apply", args, f"{hh}x{ww} clip {clip}")
            expect_equal("clahe_lab_apply", kernels.clahe_lab_apply(*args),
                         kernels.lab_inverse_u8(kernels.clahe_apply(
                             plane, luts, ya, xa, *geo), a_p, b_p),
                         f"{hh}x{ww} clip {clip}, K5 = K2 then K3b")
    # sparse strong seeds in a dense weak field: long chains
    u = torch.rand((1, H, W), generator=rng, device=dev)
    strong = (u < 0.004).to(torch.int32)
    weak = ((u >= 0.004) & (u < 0.5)).to(torch.int32)
    for it in (4, 64):
        replay("hysteresis_propagate", (strong, weak, it),
               f"1x{H}x{W} percolation field, {it} rounds")
    for shape, dim in (((6, H, W), -2), ((7, H // 8, W), -2), ((18, W), -1)):
        x = torch.rand(shape, generator=rng, device=dev)
        replay("sat_rows", (x, dim), f"{shape} along {dim}")
    del u, strong, weak, x
    k7_max = 64
    while kernels.hysteresis_tile(k7_max + 1, H, W) is not None:
        k7_max += 1
    for it in (0, 1, 4, 63, 64, k7_max):
        for k, shape in enumerate(K7_SHAPES):
            u = torch.rand(shape, generator=rng, device=dev)
            replay("hysteresis_propagate",
                   ((u < 0.004).to(torch.int32),
                    ((u >= 0.004) & (u < 0.5)).to(torch.int32), it),
                   f"{shape} percolation field, {it} rounds")
        # a weak path longer than `it` over tile borders, along rows and
        # along columns: exactly `it` steps of it are lit
        for hh, ww in ((400, 1000), (H, W)):
            for t in (False, True):
                sw = tuple(p.transpose(1, 2).contiguous() if t else p
                           for p in serpentine(torch, hh, ww, dev))
                replay("hysteresis_propagate", sw + (it,),
                       f"{hh}x{ww} serpentine{' transposed' * t}, {it} rounds")
                lit = int(kernels.hysteresis_propagate(*sw, it).sum())
                check(lit == it + 1, f"serpentine {hh}x{ww}: {lit} cells lit "
                      f"in {it} rounds, not {it + 1}")
    scan_launch_names = set()
    for L in SCAN_LENGTHS:
        cases = []
        for M in SCAN_WIDTHS:
            base = torch.randn((2, L, M), generator=rng, device=dev)
            base[0, 0, 0] = -0.0
            for x, dim in ((base[0], 0), (base, 1),
                           (base[0].t().contiguous(), 1)):
                what = f"{tuple(x.shape)} along {dim}"
                replay("sat_rows", (x, dim), what)
                bare = ext.sat_rows(x, dim, False)
                want = kernels.xla_cumsum(x, dim)
                check(torch.equal(bare, want) and torch.equal(
                    torch.signbit(bare), torch.signbit(want)),
                    f"prefix sums without the leading zero differ on {what}")
                cases.append((x, dim))
        # the launches of the length's 15 calls, in one profiled session
        names = cuda_kernel_names(
            torch, lambda: [kernels.sat_rows(x, dim) for x, dim in cases],
            expect=len(cases))
        check(len(names) == len(cases)
              and all("prefix_scan_kernel" in n for n in names),
              f"sat_rows along {L} values: {len(cases)} calls launched "
              f"{len(names)} kernels")
        scan_launch_names.update(names)
        del cases, base
    log("k6_k7_sweeps", k7_iters=f"0,1,4,63,64,{k7_max}",
        k7_shapes=len(K7_SHAPES), k6_cases=len(SCAN_LENGTHS) * len(SCAN_WIDTHS) * 3,
        k6_launches_per_call=1,
        k6_kernel=",".join(sorted(
            n.replace("(anonymous namespace)::", "").replace("void ", "")
            .split("(")[0] for n in scan_launch_names)))
    torch.cuda.synchronize()
    log("kernels", result="bit-equal", checks=json.dumps(checked),
        max_abs_err=json.dumps(err, separators=(",", ":")),
        approx_lab_vs_exact_max=approx_d,
        fast_lab_vs_k1_mismatches=fast_vs_k1)

    # 4. the slice through the CLI ----------------------------------------
    shutil.rmtree(WORK, ignore_errors=True)
    src = WORK / "in"
    src.mkdir(parents=True)
    frames = [synthetic_frame(seed) for seed in (0, 1, 2)]
    for i, f in enumerate(frames):
        uio.imwrite_unit(str(src / f"frame{i}.png"), f)

    def run_cli(argv, capture: bool):
        calls, restore = (capture_calls(torch, kernels) if capture
                          else ({}, lambda: None))
        t0 = time.perf_counter()
        try:
            kernels.reset_launches()
            cli.main(argv)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
        finally:
            restore()
        return calls, launches, time.perf_counter() - t0

    def captured_match(calls, launches):
        return all(len(calls[k]) == launches[k] for k in CAPTURED)

    want = sorted(f"frame{i}_{n}.png" for i in range(3) for n in SIX_ORDER)
    runs = {}
    for tier, extra in (("exact", []), ("fast", ["--fast"])):
        out = WORK / f"six_{tier}"
        calls, launches, secs = run_cli(
            ["six", "--input", str(src), "--output", str(out)] + extra, True)
        pngs = sorted(p.name for p in out.glob("*.png"))
        with open(out / "processing_log.csv", newline="") as fh:
            rows = list(csv.DictReader(fh))
        check(pngs == want, f"{tier}: outputs {pngs}")
        check(len(rows) == 18 and all(r["status"] == "success" for r in rows),
              f"{tier}: log rows {rows}")
        for p in pngs:
            img = uio.imread_u8(str(out / p))
            check(img is not None and img.shape == (H, W, 3),
                  f"{tier}: bad PNG {p}")
        check(captured_match(calls, launches),
              f"{tier}: captured calls {[len(v) for v in calls.values()]} "
              f"vs launches {launches}")
        runs[tier] = (calls, launches, rows)
        log("slice", tier=tier, frames=3, outputs=len(pngs),
            csv_rows=len(rows), seconds=f"{secs:.2f}",
            launches=json.dumps(launches, separators=(",", ":")))
    exact_l, fast_l = runs["exact"][1], runs["fast"][1]
    check(all(exact_l[k] == v for k, v in COMMON.items())
          and exact_l["lab_forward_unit"] == 15
          and exact_l["lab_forward_unit_approx"] == 0
          and exact_l["lab_forward_u8"] == exact_l["lab_forward_l_u8"] == 0
          and exact_l["hysteresis_propagate"] >= 3
          and exact_l["sat_rows"] == 3 + exact_l["hysteresis_propagate"],
          f"exact launches {exact_l}")
    check(fast_l == EXPECTED_FAST, f"fast launches {fast_l}")
    check([r["image_type"] for r in runs["exact"][2]]
          == [r["image_type"] for r in runs["fast"][2]],
          "the two tiers detect different casts")

    out = WORK / "enhance"
    _, enh_l, secs = run_cli(["enhance", "--input", str(src), "--output",
                              str(out)], False)
    pngs = sorted(p.name for p in out.glob("*.png"))
    check(pngs == [f"frame{i}_enhanced.png" for i in range(3)],
          f"enhance outputs {pngs}")
    for p in pngs:
        img = uio.imread_u8(str(out / p))
        check(img is not None and img.shape == (H, W, 3), f"bad PNG {p}")
    check(sum(enh_l.values()) == 0, f"enhance launched kernels: {enh_l}")
    log("slice", command="enhance", frames=3, outputs=len(pngs),
        seconds=f"{secs:.2f}")

    # [write] enhance --output NAME.jpg/.bmp/.tif
    write_slice(torch, run_cli, src, smi)
    # [jpeg_prog] frame0.jpg as progressive files, and six on one
    jpeg_prog_slice(torch, run_cli, smi)
    # [png16] 16-bit PNG and TIFF, palette and Adam7 PNG; six on 16 bits
    png16_slice(torch, run_cli, captured_match, replay, smi)
    # [jpeg_variants] CMYK, YCCK, lossless and arithmetic JPEG; six on CMYK
    jpeg_variants_slice(torch, run_cli, captured_match, replay, smi)
    # [exif] oriented training pairs through the loader and train-mlp
    exif_slice(torch, run_cli, captured_match, replay, smi)
    # [tiff_variants] the TIFF variants at 1080p; six on an oriented TIFF
    tiff_variants_slice(torch, run_cli, captured_match, replay, smi)
    # [tiff_layouts] no StripByteCounts, palette + alpha, planar and CMYK
    # JPEG TIFF at 1080p; six on the first
    tiff_layouts_slice(torch, run_cli, captured_match, replay, smi)
    # [tiff_codecs] CCITT and SGILog TIFF at 1080p, held to cv2's SHA-256;
    # six on the Group 4 file
    tiff_codecs_slice(torch, run_cli, captured_match, replay, smi)
    # [bmp_variants] RLE8, 4-bit and 16-bit BMP at 1080p
    bmp_variants_slice(smi)
    # [other_formats] PPM, PAM, PFM, Sun raster, HDR, GIF; six on a PFM
    other_formats_slice(torch, run_cli, captured_match, replay, smi)
    # [tiff_samples] float, 12-bit, signed, BigTIFF, YCbCr, CIELab and
    # JPEG 2000 TIFF at 1080p; six on the float TIFF
    tiff_samples_slice(torch, run_cli, captured_match, replay, smi)

    # Phase-1 labeling: auto, build-dataset, build-dataset --fast
    for key, argv in (
            ("auto", ["auto", "--input", str(src), "--output",
                      str(WORK / "auto")]),
            ("build", ["build-dataset", "--input", str(src), "--output",
                       str(WORK / "build")]),
            ("build_fast", ["build-dataset", "--input", str(src), "--output",
                            str(WORK / "build_fast"), "--fast"])):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            calls, launches, secs = run_cli(argv, True)
        text = printed.getvalue()
        print(text, end="", flush=True)
        if key == "auto":
            lines = [ln for ln in text.splitlines() if ".png: " in ln]
            winners = [ln.split(": ")[1].split(" ")[0] for ln in lines]
            check(len(lines) == 3 and all(w in CONFIG_ORDER for w in winners)
                  and all(float(ln.rsplit("(", 1)[1].rstrip(")")) > 0
                          for ln in lines), f"auto printed {lines}")
            pngs = sorted(p.name for p in (WORK / "auto").glob("*.png"))
            check(pngs == sorted(f"frame{i}_{w}.png"
                                 for i, w in enumerate(winners)),
                  f"auto outputs {pngs} for winners {winners}")
            out_dir = WORK / "auto"
        else:
            out_dir = WORK / key / "strategy_results"
            with open(WORK / key / "reports" / "dataset_building.csv",
                      newline="") as fh:
                rows = list(csv.DictReader(fh))
            names = [STRATEGY_DISPLAY[k] for k in CONFIG_ORDER]
            check(len(rows) == 3 and all(
                r["best_strategy"] in names
                and all(np.isfinite(float(r[n])) for n in names)
                and float(r["best_score"]) == max(float(r[n]) for n in names)
                for r in rows), f"{key}: CSV rows {rows}")
            with open(WORK / key / "trained_models" / "dataset.pkl", "rb") as fh:
                items = pickle.load(fh)
            check(len(items) == 3 and all(
                it["features"].shape == (79,)
                and bool(np.isfinite(it["features"]).all()) for it in items),
                f"{key}: dataset.pkl")
            winners = [r["best_strategy"] for r in rows]
            pngs = sorted(p.name for p in out_dir.glob("*.png"))
            check(pngs == sorted(f"{r['filename'][:-4]}_{r['best_strategy']}.png"
                                 for r in rows), f"{key}: outputs {pngs}")
        for p in pngs:
            img = uio.imread_u8(str(out_dir / p))
            check(img is not None and img.shape == (H, W, 3),
                  f"{key}: bad PNG {p}")
        check(captured_match(calls, launches),
              f"{key}: captured calls vs launches {launches}")
        check(all(launches[k] == v for k, v in EXPECTED_LABEL[key].items()),
              f"{key}: launches {launches}")
        if key in EXTRA_CANNY:
            levels = launches["sat_rows"] - 3
            check(levels >= 3 and launches["hysteresis_propagate"]
                  == levels + EXTRA_CANNY[key],
                  f"{key}: K7 {launches['hysteresis_propagate']} and K6 "
                  f"{launches['sat_rows']} disagree on the descent's levels")
        runs[key] = (calls, launches, None)
        log("slice", command=key, frames=3, outputs=len(pngs),
            winners=",".join(winners), seconds=f"{secs:.2f}",
            launches=json.dumps(launches, separators=(",", ":")))
    check(runs["auto"][1]["sat_rows"] == runs["build"][1]["sat_rows"],
          "auto and build-dataset descend differently on the same frames")

    # cli assess: the weighted total, UIQM, UCIQE and the eight metrics
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        calls, launches, secs = run_cli(["assess", "--input", str(src),
                                         "--device", "cuda"], True)
    text = printed.getvalue()
    print(text, end="", flush=True)
    lines = [ln.split() for ln in text.splitlines() if ln.strip()]
    check(lines[0][:4] == ["file", "total", "uiqm", "uciqe"]
          and len(lines[0]) == 12 and [ln[0] for ln in lines[1:]]
          == [f"frame{i}.png" for i in range(3)]
          and all(len(ln) == 12 and all(np.isfinite(float(v)) for v in ln[1:])
                  for ln in lines[1:]), f"assess printed {lines}")
    check(captured_match(calls, launches)
          and launches == EXPECTED_SLICE["assess"],
          f"assess: launches {launches}")
    runs["assess"] = (calls, launches, None)
    log("slice", command="assess", frames=3, seconds=f"{secs:.2f}",
        launches=json.dumps(launches, separators=(",", ":")))
    # UIQM and UCIQE of each frame: the card against the CPU path
    metric_rel = {}
    for i, f in enumerate(frames):
        x = torch.from_numpy(f)
        for mname, fn in (("uiqm", uiqm), ("uciqe", uciqe)):
            g_, c_ = float(fn(x.to(dev))), float(fn(x))
            rel = abs(g_ - c_) / abs(c_)
            metric_rel[f"frame{i}_{mname}"] = rel
            check(rel <= 1e-4, f"frame{i} {mname}: card {g_} vs CPU {c_}")
    log("card_vs_cpu", command="assess",
        rel=json.dumps(metric_rel, separators=(",", ":")))

    def library_run(key, fn):
        """fn() through the library entry points, its kernel calls captured
        and its launches counted (set to 0 just before, read just after)."""
        calls, restore = capture_calls(torch, kernels)
        t0 = time.perf_counter()
        try:
            kernels.reset_launches()
            result = fn()
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
        finally:
            restore()
        secs = time.perf_counter() - t0
        check(captured_match(calls, launches)
              and launches == EXPECTED_SLICE[key], f"{key}: launches {launches}")
        runs[key] = (calls, launches, None)
        return result, launches, secs

    # the five CLAHE legs of each frame, fused (K5) against split (K2, K3)
    planes3 = [split_planes(torch.from_numpy(f).to(dev)) for f in frames]
    fused, launches, secs = library_run("clahe_fused", lambda: [
        histeq.clahe_enhancement_planes(p, clip, gamma=g, impl="fused")
        for p in planes3 for clip, g in CLAHE_LEGS])
    split = [histeq.clahe_enhancement_planes(p, clip, gamma=g, impl="split")
             for p in planes3 for clip, g in CLAHE_LEGS]
    for k, (fu, sp) in enumerate(zip(fused, split)):
        check(all(a.shape == (H, W) and torch.equal(a, b)
                  for a, b in zip(fu, sp)),
              f"fused CLAHE leg {k} differs from the split leg")
    log("slice", command="clahe_enhancement_planes(impl='fused')", frames=3,
        legs=len(fused), fused_equals_split=True, seconds=f"{secs:.2f}",
        launches=json.dumps(launches, separators=(",", ":")))
    del fused, split

    # the u8 LAB round trip of each frame, and its LAB from the unit planes
    # through the probe-corrected forward LAB (the probe runs anew: its
    # cache is emptied first)
    kernels._CORRECTIONS.clear()
    kernels._FIXUPS.clear()

    def lab_round_trips():
        out = []
        for p in planes3:
            rgb8 = torch.stack([quantize_u8(c) for c in p], dim=-1)
            lab = tcs.rgb_to_lab_u8_exact(rgb8)
            fast = tcs.rgb_unit_to_lab_planes_fast(*p)
            out.append((rgb8, lab, fast, tcs.lab_to_rgb_u8_exact(lab)))
        return out

    trips, launches, secs = library_run("lab_u8", lab_round_trips)
    fast_mismatch = 0
    for rgb8, lab, fast, back in trips:
        check(back.shape == (H, W, 3) and back.dtype == torch.int32
              and int(back.min()) >= 0 and int(back.max()) <= 255,
              "lab_to_rgb_u8_exact: shape, type or range")
        fast_mismatch += sum(int((f != lab[..., c]).sum())
                             for c, f in enumerate(fast))
    rgb8, lab, _, back = trips[0]
    check(torch.equal(back.cpu(), tcs.lab_to_rgb_u8_exact(
        tcs.rgb_to_lab_u8_exact(rgb8.cpu()))),
        "frame 0: the u8 LAB round trip on the card differs from the CPU's")
    log("slice", command="lab_to_rgb_u8_exact(rgb_to_lab_u8_exact)",
        frames=3, fast_lab_vs_k1b_mismatches=fast_mismatch,
        round_trip_max_abs=max(int((t[3] - t[0]).abs().max()) for t in trips),
        seconds=f"{secs:.2f}",
        launches=json.dumps(launches, separators=(",", ":")))
    del trips

    # cli fusion: the three frames as one batch (the default batch size 4),
    # 5 pyramid levels at 1080p; the batch against single frames and frame
    # 0 against the CPU path
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        calls, launches, secs = run_cli(["fusion", "--input", str(src),
                                         "--output", str(WORK / "fusion")],
                                        True)
    text = printed.getvalue()
    print(text, end="", flush=True)
    pngs = sorted(p.name for p in (WORK / "fusion").glob("*.png"))
    check(pngs == [f"frame{i}_fusion.png" for i in range(3)]
          and f"fused 3 images -> {WORK / 'fusion'}" in text,
          f"fusion outputs {pngs}, printed {text!r}")
    written = [uio.imread_u8(str(WORK / "fusion" / p)) for p in pngs]
    check(all(w is not None and w.shape == (H, W, 3) for w in written),
          "fusion: bad PNG")
    check(captured_match(calls, launches)
          and launches == EXPECTED_SLICE["fusion"],
          f"fusion: launches {launches}")
    runs["fusion"] = (calls, launches, None)
    log("slice", command="fusion", frames=3, outputs=len(pngs),
        seconds=f"{secs:.2f}",
        launches=json.dumps(launches, separators=(",", ":")))
    fused_b = ancuti_fusion(torch.from_numpy(np.stack(frames)).to(dev))
    singles = [ancuti_fusion(torch.from_numpy(f).to(dev)) for f in frames]
    check(all(torch.equal(fused_b[i], singles[i]) for i in range(3)),
          "fusion: the batch differs from the single frames on the card")
    check(all(np.array_equal(w, (fused_b[i].clamp(0, 1) * 255).to(
        torch.uint8).cpu().numpy()) for i, w in enumerate(written)),
        "fusion: the PNGs differ from the batch result")
    cpu0 = ancuti_fusion(torch.from_numpy(frames[0]))
    d = (singles[0].cpu().double() - cpu0.double()).abs()
    mse = float((d ** 2).mean())
    psnr = float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)
    check(bool(torch.isfinite(singles[0]).all()) and psnr >= FUSION_PSNR_DB
          and float(d.max()) <= FUSION_MAX_ABS,
          f"fusion frame 0: card vs CPU {psnr:.1f} dB, max |d| {float(d.max())}")
    log("card_vs_cpu", command="fusion", frame=0, max_abs=float(d.max()),
        pixels_differing=int((d > 0).sum()), psnr_db=f"{psnr:.2f}",
        gate=f">= {FUSION_PSNR_DB} dB and max |d| <= {FUSION_MAX_ABS}",
        batch_equals_single=True)
    del fused_b, singles, cpu0, written

    # the batch forms of CLAHE, each image against the single-plane calls
    lab3 = tcs.rgb_unit_to_lab_planes(
        *(torch.stack([p[c] for p in planes3]) for c in range(3)))
    limits = (3.0, 2.0, 4.0)
    got, launches, secs = library_run(
        "clahe_u8_batch", lambda: histeq.clahe_u8_batch(lab3[0], limits))
    check(all(torch.equal(got[i], histeq.clahe_u8(lab3[0][i], c))
              for i, c in enumerate(limits)),
          "clahe_u8_batch differs from clahe_u8 of an image")
    log("slice", command="clahe_u8_batch", limits=",".join(map(str, limits)),
        equals_single=True, seconds=f"{secs:.2f}",
        launches=json.dumps(launches, separators=(",", ":")))
    legs = [(p, clip) for p in planes3 for clip in CLIPS]
    got, launches, secs = library_run(
        "clahe_multi", lambda: histeq.clahe_enhancement_planes_multi(
            [p for p, _ in legs], [c for _, c in legs]))
    check(all(all(torch.equal(a, b) for a, b in zip(
        g_, histeq.clahe_enhancement_planes(p, clip)))
        for g_, (p, clip) in zip(got, legs)),
        "clahe_enhancement_planes_multi differs from a single leg")
    log("slice", command="clahe_enhancement_planes_multi", legs=len(legs),
        equals_single=True, seconds=f"{secs:.2f}",
        launches=json.dumps(launches, separators=(",", ":")))
    got, launches, secs = library_run(
        "clahe_fused_batch",
        lambda: histeq._clahe_lab_fused_batched(*lab3, 3.0, 8, 8))
    for i in range(3):
        luts, ya, xa, geo = histeq.clahe_prep(lab3[0][i], 3.0, 8, 8)
        one = kernels.clahe_lab_apply(*(c[i] for c in lab3), luts, ya, xa,
                                      *geo)
        check(all(torch.equal(got[c][i], one[c]) for c in range(3)),
              f"_clahe_lab_fused_batched differs from K5 on image {i}")
    log("slice", command="_clahe_lab_fused_batched", images=3,
        equals_single=True, seconds=f"{secs:.2f}",
        launches=json.dumps(launches, separators=(",", ":")))
    del got, lab3
    # [predictor] cli enhance --model at full width (hidden 256, input
    # 224, VGG16 to conv4_3) on the three frames, from an .npz written
    # through the bridge from seeded numpy parameters, under PyTorch's
    # default flags (TF32 cuDNN convs, f32 matmuls): the predictor's own
    # guard is what keeps its convs in f32
    with tf32(torch, cudnn=True, matmul=False):
        npz = WORK / "predictor.npz"
        bridge.save_npz(str(npz), predictor_tree(bridge, tvgg))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            calls, launches, secs = run_cli(
                ["enhance", "--input", str(src), "--output",
                 str(WORK / "predictor"), "--model", str(npz)], True)
        text = printed.getvalue()
        print(text, end="", flush=True)
        pngs = sorted(p.name for p in (WORK / "predictor").glob("*.png"))
        check(pngs == [f"frame{i}_enhanced.png" for i in range(3)]
              and f"enhanced 3 images -> {WORK / 'predictor'}" in text,
              f"enhance --model outputs {pngs}, printed {text!r}")
        check(captured_match(calls, launches)
              and launches == EXPECTED_SLICE["predictor"],
              f"predictor: launches {launches}")
        runs["predictor"] = (calls, launches, None)
        log("predictor", command="enhance --model", frames=3, hidden=256,
            input_size=224, seconds=f"{secs:.2f}",
            launches=json.dumps(launches, separators=(",", ":")))
        pred_gpu = EnhancementPredictor(str(npz), pretrained_vgg=None,
                                        device=dev)
        pred_cpu = EnhancementPredictor(str(npz), pretrained_vgg=None,
                                        device="cpu")
        pred_params = []
        for i, f in enumerate(frames):
            p_g = pred_gpu.predict_parameters(f)
            p_c = pred_cpu.predict_parameters(f)
            dp = max(abs(p_g[k] - p_c[k]) for k in p_c)
            check(set(p_g) == set(p_c) and dp <= PREDICTOR_PARAM_MAX_ABS,
                  f"predictor frame {i}: card {p_g} vs CPU {p_c}")
            out_g = pred_gpu.enhance_image(f, p_c)
            out_c = pred_cpu.enhance_image(f, p_c)
            d = np.abs(out_g.astype(np.float64) - out_c)
            mse = float((d ** 2).mean())
            psnr = float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)
            check(out_g.shape == (H, W, 3) and bool(np.isfinite(out_g).all())
                  and float(d.max()) <= PREDICTOR_FRAME_MAX_ABS,
                  f"predictor frame {i}: card vs CPU max |d| {float(d.max())}")
            written = uio.imread_u8(str(WORK / "predictor"
                                        / f"frame{i}_enhanced.png"))
            check(np.array_equal(written, (pred_gpu.enhance_image(f) * 255)
                                 .astype(np.uint8)),
                  f"predictor frame {i}: the PNG differs from enhance_image")
            pred_params.append(p_g)
            log("card_vs_cpu", command="predictor", frame=i,
                card=json.dumps({k: round(v, 7) for k, v in p_g.items()}),
                cpu=json.dumps({k: round(v, 7) for k, v in p_c.items()}),
                param_max_abs=dp, frame_max_abs=float(d.max()),
                psnr_db=f"{psnr:.2f}",
                gate=f"params <= {PREDICTOR_PARAM_MAX_ABS}, frame <= "
                     f"{PREDICTOR_FRAME_MAX_ABS}")
        check(torch.backends.cudnn.allow_tf32,
              "predictor: cuDNN's TF32 setting was not restored")
        # the control: the predictor's guard taken away, so its convs run in
        # TF32; the parameter gate must fail it
        guard = tlayers.no_tf32
        tlayers.no_tf32 = contextlib.nullcontext
        try:
            d_tf32 = [max(abs(p_t[k] - p_g[k]) for k in p_g)
                      for p_t, p_g in zip(map(pred_gpu.predict_parameters,
                                              frames), pred_params)]
        finally:
            tlayers.no_tf32 = guard
    check(max(d_tf32) > PREDICTOR_PARAM_MAX_ABS,
          f"predictor: TF32 convs moved the parameters by {d_tf32}, within "
          f"the gate {PREDICTOR_PARAM_MAX_ABS}: it cannot tell them from f32")
    log("predictor", control="TF32 convs",
        tf32_param_max_abs=",".join(map(str, d_tf32)),
        gate=f"> {PREDICTOR_PARAM_MAX_ABS}",
        note="'not the port's path: its convs run in full f32'")
    del pred_cpu

    # [selector_mlp] the MLP classifier fitted on the card and on the CPU
    # from equal parameters (both draw them on the CPU from the seed)
    rng = np.random.default_rng(0)
    centres = rng.normal(0, 1, (MLP_CLASSES, 79))
    y_mlp = rng.integers(0, MLP_CLASSES, MLP_ROWS)
    X_mlp = (centres[y_mlp] + rng.normal(0, 1.5, (MLP_ROWS, 79))).astype(
        np.float32)
    labels_mlp = np.array([f"class{k}" for k in y_mlp])
    FlaxMLPClassifier(epochs=2, device=dev).fit(X_mlp, labels_mlp)  # warm-up
    fit_s = {}
    clfs = {}
    for key, d_ in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        clfs[key] = FlaxMLPClassifier(device=d_).fit(X_mlp, labels_mlp)
        fit_s[key] = time.perf_counter() - t0
    pr_g = clfs["card"].predict_proba(X_mlp)
    pr_c = clfs["cpu"].predict_proba(X_mlp)
    dpr = float(np.abs(pr_g - pr_c).max())
    # the control: the same fit on the card in TF32 matmuls; the gate must
    # fail it
    with tf32(torch, matmul=True):
        pr_t = FlaxMLPClassifier(device=dev).fit(
            X_mlp, labels_mlp).predict_proba(X_mlp)
    dpr_tf32 = float(np.abs(pr_t - pr_c).max())
    check(dpr_tf32 > MLP_PROBA_MAX_ABS,
          f"selector MLP: TF32 matmuls moved predict_proba by {dpr_tf32}, "
          f"within the gate {MLP_PROBA_MAX_ABS}: it cannot tell them from "
          "f32")
    acc = {k: float((c.predict(X_mlp) == labels_mlp).mean())
           for k, c in clfs.items()}
    check(pr_g.shape == (MLP_ROWS, MLP_CLASSES)
          and bool(np.isfinite(pr_g).all()) and dpr <= MLP_PROBA_MAX_ABS
          and float(np.abs(pr_g.sum(1) - 1).max()) <= 1e-5,
          f"selector MLP: card vs CPU predict_proba max |d| {dpr}")
    log("selector_mlp", rows=MLP_ROWS, features=79, classes=MLP_CLASSES,
        hidden=128, epochs=200, proba_max_abs=dpr,
        gate=f"<= {MLP_PROBA_MAX_ABS}", tf32_proba_max_abs=dpr_tf32,
        train_accuracy=json.dumps(acc),
        fit_s_card=f"{fit_s['card']:.3f}", fit_s_cpu=f"{fit_s['cpu']:.3f}",
        card=repr(smi))
    del clfs

    # [zoo] cli enhance --model --arch at full width (ResNet18,
    # EfficientNet b0 and b3, ViT-B/16 at 224^2) on the three frames, from
    # .npz files written through the bridge from seeded numpy parameters,
    # under PyTorch's TF32 flags both on: the nets' own guard is what keeps
    # their convs and matmuls in f32
    zoo_preds = {}
    with tf32(torch, cudnn=True, matmul=True):
        for label, arch, variant in ZOO_NETS:
            npz = WORK / f"{label}.npz"
            zoo_cpu = ZooPredictor(model_type=arch, variant=variant,
                                    device="cpu")
            net = zoo_cpu.model
            bridge.load_flax(net, seeded_tree(bridge, net))
            calibrate_batch_norm(torch, net, torch.stack(
                [zoo_cpu._preprocess(torch.from_numpy(f.copy()))
                 for f in frames + [f[::-1] for f in frames]]))
            bridge.save_npz(str(npz), bridge.to_flax(net))
            out = WORK / f"zoo_{label}"
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                calls, launches, secs = run_cli(
                    ["enhance", "--input", str(src), "--output", str(out),
                     "--model", str(npz), "--arch", arch, "--variant",
                     variant], True)
            text = printed.getvalue()
            pngs = sorted(p.name for p in out.glob("*.png"))
            check(pngs == [f"frame{i}_enhanced.png" for i in range(3)]
                  and f"enhanced 3 images -> {out}" in text,
                  f"enhance --arch {label}: outputs {pngs}, printed {text!r}")
            check(launches == NONE and not any(calls.values()),
                  f"enhance --arch {label} launched kernels: {launches}")
            zoo_gpu = ZooPredictor(str(npz), model_type=arch,
                                    variant=variant, device=dev)
            found = []
            for i, f in enumerate(frames):
                p_g = zoo_gpu.predict_parameters(f)
                p_c = zoo_cpu.predict_parameters(f)
                d = head_rel(p_g, p_c)
                check(d <= ZOO_PARAM_MAX_REL, f"{label} frame {i}: card "
                      f"{p_g} vs CPU {p_c}, {d} of a head's range")
                written = uio.imread_u8(str(out / f"frame{i}_enhanced.png"))
                check(np.array_equal(written, (zoo_gpu.enhance_image(f)
                                               * 255).astype(np.uint8)),
                      f"{label} frame {i}: the PNG differs from enhance_image")
                found.append((p_g, d))
            d_frame = float(np.abs(
                zoo_gpu.enhance_image(frames[0], found[0][0]).astype(
                    np.float64)
                - zoo_cpu.enhance_image(frames[0], found[0][0])).max())
            check(d_frame <= PREDICTOR_FRAME_MAX_ABS,
                  f"{label}: enhance_zoo card vs CPU max |d| {d_frame}")
            # the control: the nets' guard taken away, TF32 convs and
            # matmuls; the gate must fail it
            guard = tlayers.no_tf32
            tlayers.no_tf32 = contextlib.nullcontext
            try:
                d_tf32 = [head_rel(zoo_gpu.predict_parameters(f), p_g)
                          for f, (p_g, _) in zip(frames, found)]
            finally:
                tlayers.no_tf32 = guard
            check(min(d_tf32) > ZOO_PARAM_MAX_REL,
                  f"{label}: TF32 moved the heads by {d_tf32} of their "
                  f"range, within the gate {ZOO_PARAM_MAX_REL}: it cannot "
                  "tell them from f32")
            log("zoo", command=f"enhance --arch {arch} --variant {variant}",
                net=label, frames=3, input_size=224, seconds=f"{secs:.2f}",
                launches=sum(launches.values()),
                head_rel_max=",".join(f"{d:.3g}" for _, d in found),
                gate=f"<= {ZOO_PARAM_MAX_REL} of a head's range",
                tf32_head_rel=",".join(f"{d:.3g}" for d in d_tf32),
                enhance_zoo_max_abs=d_frame,
                params=json.dumps({k: round(v, 5)
                                   for k, v in found[0][0].items()}))
            zoo_preds[label] = zoo_gpu
            del zoo_cpu, net
        check(torch.backends.cudnn.allow_tf32
              and torch.backends.cuda.matmul.allow_tf32,
              "zoo: the TF32 settings were not restored")

    # [waternet] cli waternet on the three frames as one batch, f32 and
    # --bf16, from a seeded full-width tree (features 128, FTU 32), under
    # PyTorch's TF32 flags both on
    wn_npz = WORK / "waternet.npz"
    bridge.save_npz(str(wn_npz), seeded_tree(bridge, twn.WaterNet()))
    wn_gpu = bridge.load_flax(twn.WaterNet(), bridge.load_npz(
        str(wn_npz))).eval().to(dev)
    wn_bf16 = twn.WaterNet(dtype=torch.bfloat16).to(dev)
    wn_batch = torch.from_numpy(np.stack(frames)).to(dev)
    with tf32(torch, cudnn=True, matmul=True):
        wn_out = {}
        for dtype, extra in (("f32", []), ("bf16", ["--bf16"])):
            out = WORK / f"waternet_{dtype}"
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                calls, launches, secs = run_cli(
                    ["waternet", "--input", str(src), "--output", str(out),
                     "--checkpoint", str(wn_npz), "--batch-size", "3"]
                    + extra, True)
            text = printed.getvalue()
            check(f"waternet-enhanced 3 images -> {out}" in text
                  and launches == NONE and not any(calls.values()),
                  f"waternet {dtype}: printed {text!r}, launches {launches}")
            wn_out[dtype] = twn.waternet_enhance(
                wn_gpu, wn_batch, wn_bf16 if dtype == "bf16" else None)
            for i in range(3):
                written = uio.imread_u8(str(out / f"frame{i}_waternet.png"))
                check(np.array_equal(written, (wn_out[dtype][i].cpu().numpy()
                                               * 255).astype(np.uint8)),
                      f"waternet {dtype} frame {i}: the PNG differs from "
                      "waternet_enhance")
            log("waternet", command=" ".join(["waternet"] + extra), frames=3,
                batch=3, seconds=f"{secs:.2f}",
                launches=sum(launches.values()))
        singles = [twn.waternet_enhance(wn_gpu, wn_batch[i]) for i in range(3)]
        d_batch = max(float((wn_out["f32"][i] - singles[i]).abs().max())
                      for i in range(3))
        check(d_batch <= WATERNET_BATCH_MAX_ABS,
              f"waternet: the batch against single frames {d_batch}")
        d_bf16 = float((wn_out["bf16"] - wn_out["f32"]).abs().max())
        check(0 < d_bf16 <= WATERNET_BF16_MAX_ABS,
              f"waternet: bf16 against f32 {d_bf16}")
        wn_cpu = bridge.load_flax(twn.WaterNet(), bridge.load_npz(
            str(wn_npz))).eval()
        t0 = time.perf_counter()
        cpu0 = twn.waternet_enhance(wn_cpu, frames[0])
        cpu_s = time.perf_counter() - t0
        d_cpu = float((singles[0].cpu() - cpu0).abs().max())
        un_tree = seeded_tree(bridge, twn.UNetEnhancer())
        un_gpu = bridge.load_flax(twn.UNetEnhancer(), un_tree).eval().to(dev)
        un_cpu = bridge.load_flax(twn.UNetEnhancer(), un_tree).eval()
        # 1078x1918: unet_enhance edge-pads 2 rows and 2 columns
        crop = frames[0][:H - 2, :W - 2]
        un0 = twn.unet_enhance(un_cpu, crop)
        d_unet = float((twn.unet_enhance(un_gpu, crop).cpu() - un0)
                       .abs().max())
        check(d_cpu <= WATERNET_MAX_ABS and d_unet <= WATERNET_MAX_ABS,
              f"waternet card vs CPU {d_cpu}, unet {d_unet}")
        # the control: the guard taken away, TF32 convs; the gate must
        # fail it
        guard = tlayers.no_tf32
        tlayers.no_tf32 = contextlib.nullcontext
        try:
            t_wn = float((twn.waternet_enhance(wn_gpu, wn_batch[0]).cpu()
                          - cpu0).abs().max())
            t_un = float((twn.unet_enhance(un_gpu, crop).cpu() - un0)
                         .abs().max())
        finally:
            tlayers.no_tf32 = guard
        check(min(t_wn, t_un) > WATERNET_MAX_ABS,
              f"waternet: TF32 moved the frame by {t_wn}, the unet by "
              f"{t_un}, within the gate {WATERNET_MAX_ABS}")
    log("waternet", frame=0, card_vs_cpu_max_abs=d_cpu,
        unet_1078x1918_max_abs=d_unet, gate=f"<= {WATERNET_MAX_ABS}",
        tf32_max_abs=t_wn, unet_tf32_max_abs=t_un, bf16_vs_f32=d_bf16,
        bf16_gate=f"<= {WATERNET_BF16_MAX_ABS}", batch_vs_single=d_batch,
        cpu_s=f"{cpu_s:.2f}", card=repr(smi))
    del wn_out, singles, wn_cpu, cpu0, un_cpu, un_gpu, un0

    # [dp] data parallelism over a mesh on the one card
    dp_slice(torch, dev, frames, run_cli, captured_match, runs, smi)

    # [spatial] one 4K frame's rows over mesh positions of the one card
    spatial_slice(torch, dev, captured_match, runs, smi, wn_gpu)

    # [train] the trainers through the CLI and their gates
    train_ds = train_slice(torch, dev, run_cli, captured_match, runs)

    unused = [k for k in KERNELS if not any(r[1][k] for r in runs.values())]
    check(not unused, f"kernels the main path never launched: {unused}")

    # every kernel call of the runs, replayed on its own inputs
    replayed = {}
    for tier in runs:
        for kname, arglists in runs[tier][0].items():
            for k, args in enumerate(arglists):
                shape = "x".join(str(s) for s in args[0].shape)
                replay(kname, args, f"{tier} main-path call {k} ({shape})")
            replayed[f"{tier}:{kname}"] = len(arglists)
    torch.cuda.synchronize()
    log("main_path_inputs", result="bit-equal",
        calls=json.dumps(replayed, separators=(",", ":")))

    # frame 0 of each tier: the card against the port's CPU path
    img0 = frames[0]
    for tier, fast in (("exact", False), ("fast", True)):
        outs_gpu, code_gpu = six_strategy_tuple(img0, fast=fast, device="cuda")
        outs_cpu, code_cpu = six_strategy_tuple(img0, fast=fast, device="cpu")
        check(int(code_gpu) == int(code_cpu),
              f"{tier}: cast code card {int(code_gpu)} vs CPU {int(code_cpu)}")
        corr_g, _ = cast_mod.detect_and_correct(torch.from_numpy(img0).to(dev))
        corr_c, _ = cast_mod.detect_and_correct(torch.from_numpy(img0))
        desc = (airlight.quadtree_airlight_planes if fast
                else airlight.quadtree_airlight_exact_planes)
        kw = {"edge_iters": 4} if fast else {}
        A_g, box_g = desc(split_planes(corr_g), return_box=True, **kw)
        A_c, box_c = desc(split_planes(corr_c), return_box=True, **kw)
        check(box_g == box_c and torch.equal(A_g.cpu(), A_c),
              f"{tier}: airlight card {A_g.tolist()} {box_g} vs CPU "
              f"{A_c.tolist()} {box_c}")
        diffs = {}
        for k, n in enumerate(SIX_ORDER):
            a = outs_gpu[k].cpu().double()
            b = outs_cpu[k].double()
            check(a.shape == (H, W, 3) and bool(torch.isfinite(a).all()),
                  f"{tier} {n}: shape {tuple(a.shape)} or non-finite values")
            d = float((a - b).abs().max())
            mse = float(((a - b) ** 2).mean())
            psnr = float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)
            diffs[n] = d
            if k >= 3:
                check(d <= 1e-6, f"{tier} {n}: card vs CPU max |d| {d} > 1e-6")
            else:
                check(psnr >= 50.0, f"{tier} {n}: card vs CPU {psnr:.1f} dB < 50")
        log("card_vs_cpu", tier=tier, code=int(code_cpu), A=A_c.tolist(),
            box=box_c, max_abs=json.dumps(diffs))
    batch = np.stack(frames)
    e_g = enhance_batch(batch, 10.0, 90.0, 0.6, 1.2, device="cuda").cpu()
    e_c = enhance_batch(batch, 10.0, 90.0, 0.6, 1.2, device="cpu")
    d = float((e_g.double() - e_c.double()).abs().max())
    check(e_g.shape == (3, H, W, 3) and bool(torch.isfinite(e_g).all())
          and d <= 1e-6, f"enhance_batch card vs CPU max |d| {d}")
    log("card_vs_cpu", command="enhance_batch", max_abs=d)

    # frame 0 through the label program, both tiers: strategies, scores,
    # winner and features on the card against the CPU path
    x0 = torch.from_numpy(frames[0][None])
    n_px = H * W
    for tier, fast in (("exact", False), ("fast", True)):
        f_g, s_g, b_g, st_g = (t.cpu() for t in label_batch(
            x0.to(dev), DEFAULT_QUALITY_WEIGHTS, True, fast))
        f_c, s_c, b_c, st_c = label_batch(x0, DEFAULT_QUALITY_WEIGHTS, True,
                                          fast)
        diffs = {}
        for k, n in enumerate(CONFIG_ORDER):
            a, b = st_g[0, k].double(), st_c[0, k].double()
            check(a.shape == (H, W, 3) and bool(torch.isfinite(a).all()),
                  f"label {tier} {n}: shape or non-finite values")
            diffs[n] = float((a - b).abs().max())
            mse = float(((a - b) ** 2).mean())
            if n in DEHAZE:
                check(mse == 0 or 10 * np.log10(1.0 / mse) >= 50.0,
                      f"label {tier} {n}: card vs CPU under 50 dB")
            else:
                check(diffs[n] <= 1e-6, f"label {tier} {n}: card vs CPU "
                      f"max |d| {diffs[n]} > 1e-6")
        sd = float((s_g - s_c).abs().max())
        check(sd <= 1e-3, f"label {tier}: scores differ by {sd}")
        top = torch.sort(s_c[0], descending=True).values
        if float(top[0] - top[1]) >= 1e-2:
            check(int(b_g[0]) == int(b_c[0]), f"label {tier}: winner "
                  f"{int(b_g[0])} on the card, {int(b_c[0])} on the CPU")
        else:
            check(float(s_c[0, int(b_g[0])]) >= float(top[0]) - 1e-2,
                  f"label {tier}: the card's pick is no near tie")
        ferr = (f_g.double() - f_c.double()).abs()[0]
        rel = ferr / f_c.double().abs()[0].clamp(min=1e-30)
        ok = (ferr <= 1e-4 * f_c.double().abs()[0]) | (ferr <= 1e-5)
        ok[35:45] = ferr[35:45] <= 2.5 / n_px
        check(bool(ok.all()) and bool(torch.isfinite(f_g).all()),
              f"label {tier}: features off at {torch.nonzero(~ok).ravel()}")
        log("card_vs_cpu", command=f"label_{tier}",
            winner=CONFIG_ORDER[int(b_c[0])],
            scores=",".join(f"{v:.4f}" for v in s_c[0].tolist()),
            score_max_abs=sd, feature_max_abs=float(ferr.max()),
            feature_max_rel=float(rel[ferr > 1e-5].max()) if (ferr > 1e-5).any()
            else 0.0, strategy_max_abs=json.dumps(diffs))

    # 5. timing -----------------------------------------------------------
    imgs = [torch.from_numpy(f).to(dev) for f in frames]

    def profile_frame(fn):
        """Wall ms, device busy ms and launches of one call of fn, and the
        package's kernels among those launches."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        ours = {}
        for e in ev:
            if any(k in e.name for k in OUR_KERNELS):
                key = (e.name.replace("(anonymous namespace)::", "")
                       .replace("void ", "").split("(")[0])
                ours[key] = ours.get(key, 0) + 1
        return wall, busy, ev, ours

    # the two tiers in turns (exact, fast, exact, fast), FRAME_RUNS frames
    # a turn after FRAME_WARMUP: the host's share of a frame drifts
    frame_ms = {"exact": [], "fast": []}
    turns = {"exact": [], "fast": []}
    for tier, fast in (("exact", False), ("fast", True)) * 2:
        it = iter(range(10 ** 6))
        ms = event_ms(
            torch, lambda: six_strategy_tuple(imgs[next(it) % 3], fast=fast),
            FRAME_RUNS, warmup=FRAME_WARMUP)
        frame_ms[tier] += ms
        turns[tier].append(f"{statistics.median(ms):.3f}")
    for tier, fast in (("exact", False), ("fast", True)):
        wall, busy, ev, ours = profile_frame(
            lambda: six_strategy_tuple(imgs[0], fast=fast))
        log("frame", tier=tier, **{f"ms_{k}": v for k, v in
                                   spread(frame_ms[tier]).items()},
            turn_medians=",".join(turns[tier]),
            runs=",".join(f"{t:.3f}" for t in frame_ms[tier]),
            profiled_wall_ms=f"{wall:.3f}",
            device_busy_ms=f"{busy:.3f}" if ev else "not measured",
            device_idle_share=(f"{1 - busy / wall:.3f}" if ev
                               else "not measured"),
            device_launches=len(ev),
            package_kernels=json.dumps(ours, separators=(",", ":")))

    # the label path: auto (strategies, scores, pick) and the label program
    # (plus the features) per frame, one frame a call
    w8 = DEFAULT_QUALITY_WEIGHTS
    label_fns = {
        "auto": lambda i: auto_enhance_batch(imgs[i][None], device=dev),
        "label_exact": lambda i: label_batch(imgs[i][None], w8, False, False),
        "label_fast": lambda i: label_batch(imgs[i][None], w8, False, True),
    }
    for key, fn in label_fns.items():
        it = iter(range(10 ** 6))
        ms = event_ms(torch, lambda: fn(next(it) % 3), 6, warmup=2)
        wall, busy, ev, ours = profile_frame(lambda: fn(0))
        log("frame", path=key, **{f"ms_{k}": v for k, v in spread(ms).items()},
            runs=",".join(f"{t:.3f}" for t in ms),
            profiled_wall_ms=f"{wall:.3f}",
            device_busy_ms=f"{busy:.3f}" if ev else "not measured",
            device_idle_share=(f"{1 - busy / wall:.3f}" if ev
                               else "not measured"),
            device_launches=len(ev),
            package_kernels=json.dumps(ours, separators=(",", ":")))

    # this slice: one CLAHE leg (clip 3.0, gamma 1.5) fused against split,
    # in turns; UIQM, UCIQE and the assess command's work a frame, and one
    # profiled assess frame
    leg_ms = {"fused": [], "split": []}
    for impl in ("fused", "split") * 2:
        leg_ms[impl] += event_ms(
            torch, lambda: histeq.clahe_enhancement_planes(
                planes3[0], 3.0, gamma=1.5, impl=impl), STAGE_RUNS)
    log("clahe_leg", frame=f"{H}x{W}", clip=3.0, gamma=1.5,
        **{f"{k}_ms_{s}": v for k in leg_ms
           for s, v in spread(leg_ms[k]).items()},
        fused_runs=",".join(f"{t:.3f}" for t in leg_ms["fused"]),
        split_runs=",".join(f"{t:.3f}" for t in leg_ms["split"]))

    def assess_frame(x):
        total, scores = comprehensive_assessment(x)
        return torch.stack([total, uiqm(x), uciqe(x)]
                           + list(scores.values())).cpu()

    for key, fn in (("uiqm", uiqm), ("uciqe", uciqe),
                    ("assess", assess_frame)):
        it = iter(range(10 ** 6))
        ms = event_ms(torch, lambda: fn(imgs[next(it) % 3]), 6, warmup=2)
        extra = {}
        if key == "assess":
            wall, busy, ev, ours = profile_frame(lambda: assess_frame(imgs[0]))
            extra = dict(
                profiled_wall_ms=f"{wall:.3f}",
                device_busy_ms=f"{busy:.3f}" if ev else "not measured",
                device_idle_share=(f"{1 - busy / wall:.3f}" if ev
                                   else "not measured"),
                device_launches=len(ev),
                package_kernels=json.dumps(ours, separators=(",", ":")))
        log("frame", path=key, **{f"ms_{k}": v for k, v in spread(ms).items()},
            runs=",".join(f"{t:.3f}" for t in ms), **extra)

    # Ancuti fusion a frame (one frame a call), and the CLI's batch of 3
    it = iter(range(10 ** 6))
    ms = event_ms(torch, lambda: ancuti_fusion(imgs[next(it) % 3][None]), 6,
                  warmup=2)
    batch3 = torch.stack(imgs)
    ms3 = event_ms(torch, lambda: ancuti_fusion(batch3), 3, warmup=1)
    wall, busy, ev, ours = profile_frame(lambda: ancuti_fusion(imgs[0][None]))
    log("frame", path="fusion", **{f"ms_{k}": v for k, v in spread(ms).items()},
        runs=",".join(f"{t:.3f}" for t in ms),
        batch3_ms_per_frame=f"{statistics.median(ms3) / 3:.3f}",
        profiled_wall_ms=f"{wall:.3f}",
        device_busy_ms=f"{busy:.3f}" if ev else "not measured",
        device_idle_share=(f"{1 - busy / wall:.3f}" if ev
                           else "not measured"),
        device_launches=len(ev),
        package_kernels=json.dumps(ours, separators=(",", ":")))
    del batch3

    # the predictor a frame: its three parts alone (the 79 features, the
    # VGG and MLP at 224^2, enhance_image at 1080p), the whole frame, and
    # one profiled frame
    vin = pred_gpu._preprocess(imgs[0])[None]
    feats0 = extract_all_features(imgs[0])[None]
    with torch.no_grad():
        parts = {
            "features": lambda: extract_all_features(imgs[0]),
            "preprocess": lambda: pred_gpu._preprocess(imgs[0]),
            "vgg_224": lambda: pred_gpu.model(vin, feats0),
            "enhance_1080p": lambda: pred_gpu.enhance_image(
                imgs[0], pred_params[0]),
        }
        part_ms = {k: statistics.median(event_ms(torch, fn, 6, warmup=2))
                   for k, fn in parts.items()}
        it = iter(range(10 ** 6))
        ms = event_ms(torch, lambda: pred_gpu.enhance_image(
            imgs[next(it) % 3]), 6, warmup=2)
        wall, busy, ev, ours = profile_frame(
            lambda: pred_gpu.enhance_image(imgs[0]))
    log("frame", path="predictor", **{f"ms_{k}": v
                                      for k, v in spread(ms).items()},
        runs=",".join(f"{t:.3f}" for t in ms),
        **{f"{k}_ms": f"{v:.3f}" for k, v in part_ms.items()},
        profiled_wall_ms=f"{wall:.3f}",
        device_busy_ms=f"{busy:.3f}" if ev else "not measured",
        device_idle_share=(f"{1 - busy / wall:.3f}" if ev
                           else "not measured"),
        device_launches=len(ev),
        package_kernels=json.dumps(ours, separators=(",", ":")),
        card=repr(smi))
    del pred_gpu, vin, feats0

    # the zoo predictors a frame: predict_parameters alone, the whole
    # enhance_image, one profiled frame
    for label, pred in zoo_preds.items():
        it = iter(range(10 ** 6))
        ms_pred = event_ms(torch, lambda: pred.predict_parameters(
            imgs[next(it) % 3]), 6, warmup=2)
        ms = event_ms(torch, lambda: pred.enhance_image(imgs[next(it) % 3]),
                      6, warmup=2)
        wall, busy, ev, ours = profile_frame(
            lambda: pred.enhance_image(imgs[0]))
        log("frame", path=f"enhance --arch {label}",
            **{f"ms_{k}": v for k, v in spread(ms).items()},
            runs=",".join(f"{t:.3f}" for t in ms),
            predict_ms=f"{statistics.median(ms_pred):.3f}",
            profiled_wall_ms=f"{wall:.3f}",
            device_busy_ms=f"{busy:.3f}" if ev else "not measured",
            device_idle_share=(f"{1 - busy / wall:.3f}" if ev
                               else "not measured"),
            device_launches=len(ev),
            package_kernels=json.dumps(ours, separators=(",", ":")),
            card=repr(smi))
    del zoo_preds

    # WaterNet a frame in each dtype: the batch of three a call, one frame
    # a call, one profiled batch, the batch's peak device memory above
    # what was live before it (the earlier phases' captured calls among it)
    for dtype, model in (("f32", None), ("bf16", wn_bf16)):
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms3 = event_ms(torch, lambda: twn.waternet_enhance(
            wn_gpu, wn_batch, model), 3, warmup=1)
        peak = torch.cuda.max_memory_allocated() - live
        ms1 = event_ms(torch, lambda: twn.waternet_enhance(
            wn_gpu, wn_batch[0], model), 3, warmup=1)
        wall, busy, ev, ours = profile_frame(
            lambda: twn.waternet_enhance(wn_gpu, wn_batch, model))
        log("frame", path=f"waternet {dtype}",
            batch3_ms_per_frame=f"{statistics.median(ms3) / 3:.3f}",
            batch3_runs=",".join(f"{t:.3f}" for t in ms3),
            one_frame_ms=f"{statistics.median(ms1):.3f}",
            peak_gb_batch3=f"{peak / 1e9:.3f}", live_gb=f"{live / 1e9:.3f}",
            profiled_wall_ms_batch3=f"{wall:.3f}",
            device_busy_ms=f"{busy:.3f}" if ev else "not measured",
            device_idle_share=(f"{1 - busy / wall:.3f}" if ev
                               else "not measured"),
            device_launches=len(ev),
            package_kernels=json.dumps(ours, separators=(",", ":")),
            card=repr(smi))
    del wn_gpu, wn_bf16, wn_batch


    img = imgs[0]
    corrected, _ = cast_mod.detect_and_correct(img)
    planes = split_planes(corrected)
    stage_fns = {"cast": lambda: cast_mod.detect_and_correct(img)}
    for tier, fast in (("exact", False), ("fast", True)):
        A = tier_airlight(planes, fast)
        stage_fns[f"airlight_{tier}"] = lambda f=fast: tier_airlight(planes, f)
        for n in SIX_ORDER:
            stage_fns[f"{n}_{tier}"] = (
                lambda n=n, A=A, f=fast: run_strategy(n, corrected, A, f))
    # the label program's three parts on the raw frame
    for tier, fast in (("exact", False), ("fast", True)):
        outs5 = strategy_planes(img, fast)
        stage_fns[f"label_strategies_{tier}"] = (
            lambda f=fast: strategy_planes(img, f))
        stage_fns[f"label_scores_{tier}"] = (
            lambda o=outs5, f=fast: [comprehensive_planes(x, w8, f) for x in o])
        stage_fns[f"label_features_{tier}"] = (
            lambda f=fast: extract_all_features(img, f))
    stages = {k: event_ms(torch, fn, STAGE_RUNS) for k, fn in stage_fns.items()}
    log("stages", **{k: f"{statistics.median(v):.3f}" for k, v in stages.items()})
    log("stages_min", **{k: f"{min(v):.3f}" for k, v in stages.items()})

    def launches_of(fn):
        """CUDA kernels one call of fn launches (0 where the profiler
        recorded no device activity in any of its tries)."""
        return len(cuda_kernel_names(torch, fn))

    stack = torch.stack([planes[0], planes[1], planes[2], planes[0] ** 2,
                         planes[1] ** 2, planes[2] ** 2])
    sats = airlight._sat_rows(stack)
    levels = len(airlight._level_plan(H, W, 1))
    prefix = {
        "sat_rows": lambda: airlight._sat_rows(stack),
        "corner_grid": lambda: airlight._corner_grid(
            sats, (0, H // 2, H), (0, W // 2, W)),
        "xla_cumsum_rows": lambda: kernels.sat_rows_plain(stack, -2),
        "torch_cumsum_rows": lambda: torch.cumsum(stack, -2),
    }
    ps = {k: (statistics.median(event_ms(torch, fn, STAGE_RUNS)),
              launches_of(fn)) for k, fn in prefix.items()}
    check(ps["sat_rows"][1] == 1,
          f"the row table took {ps['sat_rows'][1]} launches, not 1")
    log("prefix_sums", levels=levels,
        per_frame_ms=f"{ps['sat_rows'][0] + levels * ps['corner_grid'][0]:.3f}",
        per_frame_launches=ps["sat_rows"][1] + levels * ps["corner_grid"][1],
        **{f"{k}_ms": f"{v[0]:.3f}" for k, v in ps.items()},
        **{f"{k}_launches": v[1] for k, v in ps.items()})

    # [train_mesh] the trainers over mesh positions of the card, after the
    # profiled launch counts above (its many steps can leave the profiler
    # recording nothing in later sessions, as train_timing's do), its
    # captured kernel calls replayed here
    train_mesh_slice(torch, dev, train_ds, captured_match, runs, smi)
    for kname, arglists in runs["train_mesh"][0].items():
        for k, args in enumerate(arglists):
            shape = "x".join(str(s) for s in args[0].shape)
            replay(kname, args, f"train_mesh main-path call {k} ({shape})")
    torch.cuda.synchronize()

    # each kernel on a main-path call of it (frame 0, the exact run's first
    # call where the exact tier runs it); its bytes: the tensors and tables
    # it reads once and the tensors it writes once
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    fwd_bytes = kernels._table("fwd_u16", dev).numel() * 4
    table_bytes = {
        "lab_forward_unit": fwd_bytes,
        "lab_forward_unit_approx": (12 + 256) * 4,  # header and GAMMA only
        "lab_forward_u8": fwd_bytes,
        "lab_forward_l_u8": fwd_bytes,
        # INV_TABLE_U8 and the epilogue's f32 table
        "lab_inverse_unit": kernels._table("inv_u8", dev).numel() * 4
        + 256 * 4,
        "lab_inverse_unit_gamma": kernels._table("inv_u8", dev).numel() * 4
        + 256 * 4,
        "lab_inverse_u8": kernels._table("inv_u8", dev).numel() * 4,
        "clahe_lab_apply": kernels._table("inv_u8", dev).numel() * 4,
        # header, GAMMA and the fix-ups
        "lab_forward_unit_fast": (12 + 256 + 2 * len(probes["cbrt"][0])) * 4,
    }

    def time_call(kname, args):
        if kname == "surrogate_corrections":
            # the launch it makes: the probe of one table
            fn, plain = kernels.surrogate_values, kernels.surrogate_values_plain
            tensors = [kernels._probe_index(*args)]
        else:
            fn = getattr(kernels, kname)
            plain = getattr(kernels, KERNELS[kname][3])
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
        outs = fn(*args)
        outs = (outs,) if isinstance(outs, torch.Tensor) else outs
        nbytes = table_bytes.get(kname, 0) + sum(
            t.numel() * t.element_size() for t in tensors + list(outs))
        ms = statistics.median(event_ms(torch, lambda: fn(*args), 30, 3, flush))
        plain_ms = statistics.median(event_ms(torch, lambda: plain(*args), 10,
                                              1, flush))
        lib_ms = None
        if kname == "sat_rows":
            lib_ms = statistics.median(event_ms(
                torch, lambda: torch.cumsum(args[0], args[1]), 30, 3, flush))
        # the floor of this timing: a PyTorch copy of the kernel's planes
        copy = COPY_FLOORS.get(kname)
        copy_ms = None if copy is None else statistics.median(event_ms(
            torch, lambda: getattr(torch, copy)(
                *([tensors[:3]] if copy == "stack" else tensors[:3]
                  if copy == "addcmul" else tensors[:1])), 30, 3, flush))
        t_bytes = nbytes / bw * 1e3
        t_ops = KERNELS[kname][2] * tensors[0].numel() / F32_PEAK * 1e3
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms, "copy_ms": copy_ms, "bytes": nbytes,
                "shape": list(tensors[0].shape)}

    def us(v):
        return "null" if v is None else f"{v * 1e3:.2f}"

    # the floor of a launch under this timing: a kernel that does next to
    # nothing (a one-element fill_, one thread, one 4-byte store), flushed
    # and timed as the kernels are; the bound of K9, whose bytes take less
    one = torch.zeros(1, device=dev)
    launch_floor_ms = statistics.median(event_ms(
        torch, lambda: one.fill_(1.0), 30, 3, flush))
    log("timing", kernel="launch_floor", on="'one-element fill_'",
        us=us(launch_floor_ms))

    # the first main-path call of each kernel, in run order
    calls = {k: next(r[0][k] for r in runs.values() if r[0][k])
             for k in CAPTURED}
    calls["surrogate_corrections"] = [("cbrt", dev)]
    records = []
    for kname, (source, replaces, _, _) in KERNELS.items():
        t = time_call(kname, calls[kname][0])
        records.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r[1][kname] for r in runs.values()),
            "max_abs_err": err[kname], **t})
        if kname == "surrogate_corrections":
            records[-1]["launch_floor_ms"] = launch_floor_ms
        log("timing", kernel=kname, shape="x".join(map(str, t["shape"])),
            us=us(t["ms"]), plain_us=us(t["plain_ms"]),
            bound_us=us(t["bound_ms"]), library_us=us(t["library_ms"]),
            copy_us=us(t["copy_ms"]), bytes=t["bytes"])
    # the other main-path shapes of K7 and K6: the metrics' Canny (64
    # rounds on the frame), the fast tier's global Canny (4 rounds), the
    # exact descent's second and third levels (whole planes in one block),
    # the fast tier's band prefix and the exact descent's corner strips
    exact_k7 = runs["exact"][0]["hysteresis_propagate"]
    for kname, args, what in (
            ("hysteresis_propagate",
             runs["assess"][0]["hysteresis_propagate"][0], "metric Canny"),
            ("hysteresis_propagate", runs["fast"][0]["hysteresis_propagate"][0],
             "fast global Canny"),
            ("hysteresis_propagate", exact_k7[1], "exact descent level 2"),
            ("hysteresis_propagate", exact_k7[2], "exact descent level 3"),
            ("sat_rows", runs["fast"][0]["sat_rows"][0], "fast band prefix"),
            ("sat_rows", runs["exact"][0]["sat_rows"][1], "exact corner strip")):
        t = time_call(kname, args)
        extra = ({"below_cumsum": t["ms"] < t["library_ms"]}
                 if kname == "sat_rows" else {})
        log("timing", kernel=kname, on=repr(what),
            shape="x".join(map(str, t["shape"])), us=us(t["ms"]),
            plain_us=us(t["plain_ms"]), bound_us=us(t["bound_ms"]),
            library_us=us(t["library_ms"]), bytes=t["bytes"], **extra)
    # the trainers' steps last: their profiled steps (up to 26,800
    # launches each) can leave the profiler recording nothing in later
    # sessions, which the launch counts above rely on
    train_timing(torch, dev, train_ds, profile_frame, smi)
    shutil.rmtree(WORK, ignore_errors=True)

    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
