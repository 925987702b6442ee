"""Milliseconds per 1-spp step of the port's main path, for the port in
one checkout, in a process that does nothing else.

    python3 scripts/time_torch_step.py [--tree DIR] [--steps 8]
        [--profile-first] [--progressive ROUNDS]

Imports ``tryraytrace_tpu_torch`` and ``chip_smoke`` (for the main-path
scene) from ``DIR`` (default: this checkout), so that a commit and its
parent can be timed in turn in one run on one card.  Renders
chip_smoke.py's main path (Cornell box + icosphere(5), 20,487
triangles, 1200x800 at 1 spp): one warm-up step, then ``--steps``
steps, each timed on the host clock and ended by
``Renderer.block_until_ready``.  ``--profile-first`` runs one
torch.profiler session around a tonemap before the warm-up, to see
whether a profiler session slows the steps that follow it.  Prints one
JSON line: the step times, their median and quartiles, rounds, path and
shadow rays and rows per step, and the image mean.  ``--progressive
ROUNDS`` times ``--steps`` frames of an unbounded ProgressiveRenderer
(ROUNDS rounds a frame, as the app's ticks) instead.  Needs a CUDA device.
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
    ap.add_argument("--progressive", type=int, default=0, metavar="ROUNDS",
                    help="time progressive frames of ROUNDS rounds "
                         "(ProgressiveRenderer.step) instead of steps")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
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
    params = CameraController().get_params(w, h)
    if args.progressive:
        return _progressive(args, tree, chip_smoke, params, np, torch)
    r = Renderer(chip_smoke.main_path_arrays(),
                 cfg=RenderConfig(width=w, height=h, spp=1))
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
    q1, median, q3 = (float(v) for v in np.percentile(
        [s["ms"] for s in steps], (25, 50, 75)))
    print(json.dumps({"tree": tree, "profile_first": args.profile_first,
                      "ms": [s["ms"] for s in steps], "median_ms": median,
                      "q1_ms": q1, "q3_ms": q3, "steps": steps,
                      "image_mean": float(img.mean()),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


def _progressive(args, tree, chip_smoke, params, np, torch) -> int:
    """``--steps`` frames of ``--progressive`` rounds of an unbounded
    ProgressiveRenderer on the main path's scene (after one warm-up
    frame), each timed on the host clock and ended by
    ``block_until_ready``; one JSON line."""
    from tryraytrace_tpu_torch.config import RenderConfig
    from tryraytrace_tpu_torch.engine.progressive import ProgressiveRenderer
    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
    pr = ProgressiveRenderer(chip_smoke.main_path_arrays(),
                             cfg=RenderConfig(width=w, height=h))
    frames = []
    for i in range(args.steps + 1):
        t0 = time.perf_counter()
        pr.step(params, args.progressive)
        pr.block_until_ready()
        if i:
            frames.append(1e3 * (time.perf_counter() - t0))
    _, counts = pr.snapshot()
    q1, median, q3 = (float(v) for v in np.percentile(frames, (25, 50, 75)))
    print(json.dumps({"tree": tree, "progressive_rounds": args.progressive,
                      "ms": frames, "median_ms": median, "q1_ms": q1,
                      "q3_ms": q3, "mean_spp": float(counts.mean()),
                      "rays": pr.rays_traced(),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
