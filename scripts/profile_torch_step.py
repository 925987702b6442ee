"""Where a step of the PyTorch port's engine spends its time on a card.

    python3 scripts/profile_torch_step.py [--tree DIR] [--width 1200
        --height 800] [--steps 3] [--tiles N]

Imports ``tryraytrace_tpu_torch`` and ``chip_smoke`` (for the main-path
scene) from ``DIR`` (default: this checkout), so that a commit and its
parent can be profiled alike, each in a process of its own.  Renders
chip_smoke.py's main-path scene (Cornell box + icosphere(5), 20,487
triangles) once to warm up, then profiles ``--steps`` whole steps
(``Renderer.step``, or ``Renderer.step_tiled`` with ``--tiles N``, each
ended by ``Renderer.block_until_ready``) with torch.profiler: host wall
time and device time per step (their ratio is the device's busy share),
device operations per step (kernels, copies and fills), the device time
of the engine's kernels by name (the wave kernel, or the walk and
service kernels of a tree that runs the round loop, and the lane set-up
kernel of a tree that has one) and the device time outside the wave
kernel, and then every kernel, copy and fill of a step by name with its
launches and device time per step.  Prints one JSON line last.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The engine's kernels, by a part of their names.
ENGINE_KERNELS = ("wave_advance_kernel", "quad_walk_kernel",
                  "service_pass_kernel", "lane_init_kernel")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--tiles", type=int, default=0,
                    help="profile step_tiled with this many strips")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from tryraytrace_tpu_torch.camera.controller import CameraController
    from tryraytrace_tpu_torch.config import RenderConfig
    from tryraytrace_tpu_torch.engine.renderer import Renderer
    if not chip_smoke.__file__.startswith(tree):
        raise RuntimeError(f"imported {chip_smoke.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    w, h = args.width, args.height
    t0 = time.perf_counter()
    r = Renderer(chip_smoke.main_path_arrays(),
                 cfg=RenderConfig(width=w, height=h, spp=1), device="cuda")
    print(f"[profile] {tree}: scene + upload {time.perf_counter() - t0:.2f} s")
    params = CameraController().get_params(w, h)
    step = ((lambda: r.step_tiled(params, args.tiles)) if args.tiles
            else (lambda: r.step(params)))
    step()
    r.block_until_ready()
    rounds = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
            r.block_until_ready()
            rounds.append(r.last_stats["iterations"])
        wall = time.perf_counter() - t0
    n = args.steps
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in ops)
    launches = sum(e.count for e in ops)
    engine = {name: sum(e.device_time_total for e in ops
                        if name in e.key) / n / 1e3
              for name in ENGINE_KERNELS}
    outside = (dev_us - sum(e.device_time_total for e in ops
                            if "wave_advance_kernel" in e.key)) / n / 1e3
    what = f"step_tiled({args.tiles})" if args.tiles else "step"
    print(f"[profile] {torch.cuda.get_device_name(0)}; {w}x{h}; {n} "
          f"{what}s of {rounds} rounds under the profiler: wall "
          f"{wall / n * 1e3:.3f} ms/step, device {dev_us / n / 1e3:.3f} "
          f"ms/step ({outside:.4f} ms outside the wave kernel), busy share "
          f"{dev_us / 1e6 / wall:.3f}, device operations "
          f"{launches / n:.1f}/step; engine kernels (ms/step) {engine}")
    listing = []
    for e in sorted(ops, key=lambda e: -e.device_time_total):
        listing.append(dict(name=e.key, per_step=e.count / n,
                            us_per_step=e.device_time_total / n))
        print(f"[profile]   {e.device_time_total / n:9.1f} us/step "
              f"{e.count / n:6.1f}/step  {e.key[:110]}")
    print(json.dumps({
        "tree": tree, "device": torch.cuda.get_device_name(0),
        "what": what, "steps": n, "rounds": rounds,
        "wall_ms_per_step": wall / n * 1e3,
        "device_ms_per_step": dev_us / n / 1e3,
        "outside_wave_ms_per_step": outside,
        "busy_share": dev_us / 1e6 / wall, "launches_per_step": launches / n,
        "engine_ms_per_step": engine, "operations": listing}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
