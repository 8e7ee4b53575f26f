"""Profiling and per-stage timing (the JAX package's
``utils/profiling.py``): a ``torch.profiler`` trace and stage timers."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the host and, where there is
    a card, its kernels; written into ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``, Perfetto and chrome://tracing read it)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Named wall-clock stage timing with device synchronization.

    Usage::

        t = StageTimer()
        with t.stage("decode"): ...
        with t.stage("enhance", sync_on=out): out = fn(x)
        print(t.summary())

    ``sync_on``: a CUDA tensor (or device) whose card is synchronised
    before the stage's clock stops, where JAX waits with
    ``block_until_ready``; a CPU tensor needs no wait."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on: Optional[object] = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<20} total {total * 1e3:8.1f} ms   "
                         f"x{n}   avg {total / n * 1e3:8.2f} ms")
        return "\n".join(lines)


def _synchronize(sync_on) -> None:
    """Wait for the card that ``sync_on`` (a tensor or a device) is on."""
    import torch

    dev = getattr(sync_on, "device", sync_on)
    if dev is not None and torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
