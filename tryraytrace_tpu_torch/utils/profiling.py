"""Profiling helpers: per-phase wall clock and torch.profiler traces
(the counterpart of tryraytrace_tpu/utils/profiling.py).

``PhaseTimer`` sums named phases (build/upload/render/tonemap) and
prints ms per call; ``trace_context`` wraps a block in a torch.profiler
session, written as a Chrome trace under ``TPURT_TRACE_DIR``, when that
variable is set.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on: torch.Tensor | None = None):
        """Time the block.  With ``block_on``, wait for the device that
        holds that tensor before reading the clock (a CUDA
        synchronize; nothing for a CPU tensor, whose work is done when
        the call returns)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.device.type == "cuda":
                torch.cuda.synchronize(block_on.device)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = max(self.counts[name], 1)
            lines.append(f"{name}: {total * 1e3:.1f} ms total, "
                         f"{total / n * 1e3:.2f} ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_context(name: str):
    """A torch.profiler session around the block when TPURT_TRACE_DIR is
    set (its Chrome trace is written there as ``<name>.json``), else a
    no-op.

    Hazard: on an H100 one torch.profiler session slowed every later
    step of the same process by ~260 ms (PERF.md §6), so time nothing
    after a traced block in the same process."""
    trace_dir = os.environ.get("TPURT_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))


def mrays_per_sec(rays: float, seconds: float) -> float:
    return rays / max(seconds, 1e-12) / 1e6
