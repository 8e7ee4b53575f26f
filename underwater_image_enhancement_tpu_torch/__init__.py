"""PyTorch/CUDA port of ``underwater_image_enhancement_tpu`` for one NVIDIA H100.

The JAX package beside this one stays the reference; this package imports
neither it nor JAX.  Entry points run on the CUDA device unless the caller
asks for the CPU (``device="cpu"``); functions that take tensors run on the
tensors' device.  The hand-written CUDA kernels live in ``csrc/`` and are
wrapped by ``ops/kernels.py``.

Ported so far: ``pipeline.enhance.six_strategy_tuple`` (exact and fast
tiers), ``enhance``/``enhance_batch`` (fixed parameters,
``models.diff_enhance.enhance_vgg``), Phase-1 labeling
(``pipeline.enhance.auto_enhance_batch``, ``select.system``), and the
``six``, ``enhance``, ``auto`` and ``build-dataset`` subcommands of
``cli``.
"""

from underwater_image_enhancement_tpu_torch.version import __version__  # noqa: F401
