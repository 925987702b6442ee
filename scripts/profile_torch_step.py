"""Where a step of the PyTorch port's engine spends its time on a card.

    python3 scripts/profile_torch_step.py [--width 1200 --height 800]
        [--window 2:8]

Renders chip_smoke.py's main-path scene (Cornell box + icosphere(5),
20,487 triangles) once to warm up, then profiles rounds ``window`` of
the next step's round loop (one walk-kernel launch and one
service-kernel launch per round, and the small launches around them)
with torch.profiler: host wall time and device kernel time per round
(their ratio is the device's busy share), kernel launches per round,
the walk and service kernels' device time, and the kernels that take
the most device time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tryraytrace_tpu_torch.camera.controller import CameraController  # noqa: E402
from tryraytrace_tpu_torch.config import RenderConfig  # noqa: E402
from tryraytrace_tpu_torch.engine import persistent  # noqa: E402
from tryraytrace_tpu_torch.engine.renderer import Renderer  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--window", default="2:8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    lo, hi = (int(v) for v in args.window.split(":"))
    w, h = args.width, args.height
    t0 = time.perf_counter()
    r = Renderer(chip_smoke.main_path_arrays(),
                 cfg=RenderConfig(width=w, height=h, spp=1), device="cuda")
    print(f"[profile] scene + upload {time.perf_counter() - t0:.2f} s")
    params = CameraController().get_params(w, h)
    r.step(params)
    r.block_until_ready()

    step = persistent._round_quad
    state = dict(i=0, prof=None, t0=0.0, wall=0.0)

    def traced_step(*a, **kw):
        if state["i"] == lo:
            torch.cuda.synchronize()
            state["prof"] = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].__enter__()
            state["t0"] = time.perf_counter()
        out = step(*a, **kw)
        state["i"] += 1
        if state["i"] == hi:
            torch.cuda.synchronize()
            state["wall"] = time.perf_counter() - state["t0"]
            state["prof"].__exit__(None, None, None)
        return out

    persistent._round_quad = traced_step
    try:
        t0 = time.perf_counter()
        r.step(params)
        r.block_until_ready()
        step_s = time.perf_counter() - t0
    finally:
        persistent._round_quad = step
    if state["prof"] is None:
        print(f"[profile] the step had {state['i']} rounds, none in the "
              f"window {lo}:{hi}", file=sys.stderr)
        return 1
    if state["i"] < hi:  # the step ended inside the window
        state["wall"] = time.perf_counter() - state["t0"]
        state["prof"].__exit__(None, None, None)
        hi = state["i"]
    n_it = hi - lo
    ka = state["prof"].key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    walk_us = sum(e.device_time_total for e in kernels
                  if "quad_walk_kernel" in e.key)
    service_us = sum(e.device_time_total for e in kernels
                     if "service_pass_kernel" in e.key)
    print(f"[profile] {torch.cuda.get_device_name(0)}; {w}x{h}; step "
          f"{step_s * 1e3:.1f} ms under the profiler, "
          f"{r.last_stats['iterations']} rounds")
    print(f"[profile] rounds {lo}..{hi - 1}: wall "
          f"{state['wall'] / n_it * 1e3:.3f} ms/round, device kernels "
          f"{dev_us / n_it / 1e3:.3f} ms/round (walk kernel "
          f"{walk_us / n_it / 1e3:.3f}, service kernel "
          f"{service_us / n_it / 1e3:.3f}), busy share "
          f"{dev_us / 1e6 / state['wall']:.3f}, kernel launches "
          f"{launches / n_it:.0f}/round")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:15]:
        print(f"[profile]   {e.device_time_total / n_it:9.1f} us/round "
              f"{e.count / n_it:6.1f}/round  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
