"""Milliseconds per 1-spp step of the port's main path, for the port in
one checkout, in a process that does nothing else.

    python3 scripts/time_torch_step.py [--tree DIR] [--steps 8]
        [--profile-first]

Imports ``tryraytrace_tpu_torch`` and ``chip_smoke`` (for the main-path
scene) from ``DIR`` (default: this checkout), so that a commit and its
parent can be timed in turn in one run on one card.  Renders
chip_smoke.py's main path (Cornell box + icosphere(5), 20,487
triangles, 1200x800 at 1 spp): one warm-up step, then ``--steps``
steps, each timed on the host clock and ended by
``Renderer.block_until_ready``.  ``--profile-first`` runs one
torch.profiler session around a tonemap before the warm-up, to see
whether a profiler session slows the steps that follow it.  Prints one
JSON line: the step times, rounds, path and shadow rays and rows per
step, and the image mean.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--profile-first", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from tryraytrace_tpu_torch.camera.controller import CameraController
    from tryraytrace_tpu_torch.config import RenderConfig
    from tryraytrace_tpu_torch.engine.renderer import Renderer
    from tryraytrace_tpu_torch.ops import tonemap as tm
    for mod in (chip_smoke, tm):
        if not mod.__file__.startswith(tree):
            raise RuntimeError(f"imported {mod.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        print("time_torch_step: no CUDA device", file=sys.stderr)
        return 2
    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
    r = Renderer(chip_smoke.main_path_arrays(),
                 cfg=RenderConfig(width=w, height=h, spp=1))
    params = CameraController().get_params(w, h)
    if args.profile_first:
        acc = torch.zeros((w * h, 3), dtype=torch.float32, device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            tm.tonemap_cuda(acc, 1)
            torch.cuda.synchronize()
    steps = []
    for i in range(args.steps + 1):
        t0 = time.perf_counter()
        r.step(params)
        r.block_until_ready()
        dt = time.perf_counter() - t0
        st = r.last_stats
        if i:
            steps.append(dict(ms=1e3 * dt, rounds=st["iterations"],
                              path=int(st["n_traced"]),
                              shadow=int(st["n_shadow"]),
                              rows=int(st["rows_fetched"])))
    img = r.image()
    print(json.dumps({"tree": tree, "profile_first": args.profile_first,
                      "ms": [s["ms"] for s in steps], "steps": steps,
                      "image_mean": float(img.mean()),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
