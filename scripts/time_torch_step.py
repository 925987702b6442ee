"""Milliseconds per 1-spp step of the port's main path, for the port in
one checkout, in a process that does nothing else.

    python3 scripts/time_torch_step.py [--tree DIR] [--steps 8]
        [--profile-first] [--progressive ROUNDS] [--split] [--tiles N]

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
(ROUNDS rounds a frame, as the app's ticks) instead.  ``--tiles N``
times ``Renderer.step_tiled(cam, N)`` instead of ``Renderer.step``.

``--split`` also times the host side of each step's parts (``SPLIT``:
``Wave.__init__`` apart from what it calls, ``CameraParams.to``,
``init_lane_ctx`` or ``lane_init_cuda``, ``service_params``,
``Wave.advance`` apart from ``wave_advance_cuda``, the
``wave_advance_cuda`` wrapper, ``Wave.read``, ``Wave.stats`` and
``Renderer._accumulate``), each function wrapped so that it adds its
host-clock time, less that of the parts it calls, to its entry; a part
a tree does not have is left out.  Nothing is synchronized inside a
step, so a part's time is its host work plus whatever device work it
waits for (a read of a device value waits for every launch queued
before it); ``other`` is the step less its parts.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The parts of a step that --split times: (label, module path, owner
# within the module or "", function name).
SPLIT = (
    ("Wave.__init__", "tryraytrace_tpu_torch.engine.persistent", "Wave",
     "__init__"),
    ("CameraParams.to", "tryraytrace_tpu_torch.camera.controller",
     "CameraParams", "to"),
    ("init_lane_ctx", "tryraytrace_tpu_torch.engine.persistent", "",
     "init_lane_ctx"),
    ("lane_init_cuda", "tryraytrace_tpu_torch.engine.persistent", "",
     "lane_init_cuda"),
    ("service_params", "tryraytrace_tpu_torch.engine.persistent", "",
     "service_params"),
    ("Wave.advance", "tryraytrace_tpu_torch.engine.persistent", "Wave",
     "advance"),
    ("wave_advance_cuda", "tryraytrace_tpu_torch.engine.persistent", "",
     "wave_advance_cuda"),
    ("Wave.read", "tryraytrace_tpu_torch.engine.persistent", "Wave", "read"),
    ("Wave.stats", "tryraytrace_tpu_torch.engine.persistent", "Wave",
     "stats"),
    ("Renderer._accumulate", "tryraytrace_tpu_torch.engine.renderer",
     "Renderer", "_accumulate"),
)


class _Split:
    """Host-clock time of each wrapped part, less the parts it calls."""

    def __init__(self):
        self.ms = {}
        self.calls = {}
        self._stack = []

    def wrap(self, label, fn):
        def timed(*a, **kw):
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = 1e3 * (time.perf_counter() - t0)
                inner = self._stack.pop()
                if self._stack:
                    self._stack[-1] += dt
                self.ms[label] = self.ms.get(label, 0.0) + dt - inner
                self.calls[label] = self.calls.get(label, 0) + 1
        return timed

    def install(self) -> list:
        import importlib
        found = []
        for label, module, owner, name in SPLIT:
            mod = importlib.import_module(module)
            obj = getattr(mod, owner) if owner else mod
            if hasattr(obj, name):
                setattr(obj, name, self.wrap(label, getattr(obj, name)))
                found.append(label)
        return found

    def take(self) -> tuple:
        ms, calls = self.ms, self.calls
        self.ms, self.calls = {}, {}
        return ms, calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--profile-first", action="store_true")
    ap.add_argument("--progressive", type=int, default=0, metavar="ROUNDS",
                    help="time progressive frames of ROUNDS rounds "
                         "(ProgressiveRenderer.step) instead of steps")
    ap.add_argument("--split", action="store_true",
                    help="also time the host side of each step's parts")
    ap.add_argument("--tiles", type=int, default=0,
                    help="time step_tiled with this many strips")
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
    split = _Split()
    parts = split.install() if args.split else []
    step = ((lambda: r.step_tiled(params, args.tiles)) if args.tiles
            else (lambda: r.step(params)))
    if args.profile_first:
        acc = torch.zeros((w * h, 3), dtype=torch.float32, device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            tm.tonemap_cuda(acc, 1)
            torch.cuda.synchronize()
    steps = []
    for i in range(args.steps + 1):
        torch.cuda.synchronize()
        split.take()
        t0 = time.perf_counter()
        step()
        r.block_until_ready()
        dt = time.perf_counter() - t0
        ms, calls = split.take()
        st = r.last_stats
        if i:
            steps.append(dict(ms=1e3 * dt, rounds=st["iterations"],
                              path=int(st["n_traced"]),
                              shadow=int(st["n_shadow"]),
                              rows=int(st["rows_fetched"])))
            if args.split:
                ms["other"] = 1e3 * dt - sum(ms.values())
                steps[-1].update(split_ms=ms, split_calls=calls)
    img = r.image()
    q1, median, q3 = (float(v) for v in np.percentile(
        [s["ms"] for s in steps], (25, 50, 75)))
    out = {"tree": tree, "profile_first": args.profile_first,
           "tiles": args.tiles, "ms": [s["ms"] for s in steps],
           "median_ms": median, "q1_ms": q1, "q3_ms": q3, "steps": steps,
           "image_mean": float(img.mean()),
           "device": torch.cuda.get_device_name(0)}
    if args.split:
        labels = [*parts, "other"]
        out["split_parts"] = parts
        out["split_median_ms"] = {
            k: float(np.median([s["split_ms"].get(k, 0.0) for s in steps]))
            for k in labels}
        out["split_calls_per_step"] = {
            k: steps[-1]["split_calls"].get(k, 0) for k in parts}
        print("[split] median host ms a step: " + ", ".join(
            f"{k} {v:.4f} ({out['split_calls_per_step'].get(k, '-')})"
            for k, v in out["split_median_ms"].items()))
    print(json.dumps(out))
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
