"""PyTorch/CUDA port of ``underwater_image_enhancement_tpu`` for one NVIDIA H100.

The JAX package beside this one stays the reference; this package imports
neither it nor JAX.  Entry points run on the CUDA device unless the caller
asks for the CPU (``device="cpu"``); functions that take tensors run on the
tensors' device.  The three hand-written CUDA kernels of the ``six`` exact
tier live in ``csrc/`` and are wrapped by ``ops/kernels.py``.

Ported so far: ``pipeline.enhance.six_strategy_tuple`` (exact tier) and the
``six`` subcommand of ``cli``.
"""

from underwater_image_enhancement_tpu_torch.version import __version__  # noqa: F401
