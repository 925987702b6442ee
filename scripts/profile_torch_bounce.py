"""Where a step of the PyTorch port's bounce engine spends its time on a
card.

    python3 scripts/profile_torch_bounce.py [--width 1200 --height 800]

Renders chip_smoke.py's main-path scene (Cornell box + icosphere(5),
20,487 triangles) with ``engine="bounce"``: one step to warm up,
``--steps`` steps timed by the host clock in a process that has started
no profiler, then one step under torch.profiler.  Prints the unprofiled
steps' times, then the profiled step's wall time, bounces, device
operations and device time, each engine kernel's launches and share of
the device time (``KERNELS``: the threaded walks, the shade, the NEE
add, the camera rays) beside the other device operations (fills,
copies, eager ops), and the operations that take the most device time.
The device's busy share is given two ways: the device time over the
median unprofiled step (the profiler slows the host, not the kernels),
and the union of the operations' intervals in the trace over the
profiled step's wall time (what the profiled step itself shows).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tryraytrace_tpu_torch.camera.controller import CameraController  # noqa: E402
from tryraytrace_tpu_torch.config import RenderConfig  # noqa: E402
from tryraytrace_tpu_torch.engine.renderer import Renderer  # noqa: E402


# The engine's kernels: a bounce's two threaded walks, its shade and NEE
# add, a sample's camera rays (ops/threaded.py, ops/bounce.py).
KERNELS = ("threaded_walk_kernel", "bounce_shade_kernel",
           "bounce_nee_kernel", "bounce_rays_kernel")


def _union_ms(ranges) -> float:
    """Milliseconds covered by the union of the intervals (us)."""
    total, end = 0.0, float("-inf")
    for r in sorted(ranges, key=lambda r: r.start):
        if r.end > end:
            total += r.end - max(r.start, end)
            end = r.end
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_bounce: no CUDA device", file=sys.stderr)
        return 2
    w, h = args.width, args.height
    t0 = time.perf_counter()
    r = Renderer(chip_smoke.main_path_arrays(),
                 cfg=RenderConfig(width=w, height=h, spp=1, engine="bounce"),
                 device="cuda")
    print(f"[profile] scene + upload {time.perf_counter() - t0:.2f} s")
    params = CameraController().get_params(w, h)
    r.step(params)
    r.block_until_ready()
    plain = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        r.step(params)
        r.block_until_ready()
        plain.append(1e3 * (time.perf_counter() - t0))
    step_ms = statistics.median(plain)
    print(f"[profile] steps without the profiler "
          f"{', '.join(f'{ms:.1f}' for ms in plain)} ms (median "
          f"{step_ms:.1f}), {r.last_stats['iterations']} bounces")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.step(params)
        r.block_until_ready()
        wall = 1e3 * (time.perf_counter() - t0)
    bounces = r.last_stats["iterations"]
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in kernels)
    device = sum(e.device_time_total for e in kernels) / 1e3
    busy = _union_ms([e.time_range for e in prof.events()
                      if e.device_type == DeviceType.CUDA])
    print(f"[profile] step under the profiler {wall:.1f} ms wall, "
          f"{bounces} bounces; {launches} device operations (kernels, "
          f"fills, copies; {launches / bounces:.1f} a bounce), device "
          f"time {device:.3f} ms")
    named = 0
    for name in KERNELS:
        found = [e for e in kernels if name in e.key]
        count = sum(e.count for e in found)
        ms = sum(e.device_time_total for e in found) / 1e3
        named += count
        print(f"[profile]   {name}: {count} launches "
              f"({count / bounces:.2f} a bounce), {ms:.3f} ms "
              f"({ms / device:.3f} of the device time)")
    print(f"[profile]   other device operations: {launches - named} "
          f"({(launches - named) / bounces:.2f} a bounce)")
    print(f"[profile] busy share: device kernel time over the median "
          f"unprofiled step {device / step_ms:.3f}; kernels' intervals "
          f"in the trace ({busy:.2f} ms) over the profiled step "
          f"{busy / wall:.3f}")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:12]:
        print(f"[profile]   {e.device_time_total / 1e3:8.3f} ms  "
              f"{e.count:5d} x  {e.key[:90]}")
    print(f"[profile] {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
