"""Milliseconds per 1-spp step of the port's main path, for the port in
one checkout, in a process that does nothing else.

    python3 scripts/time_torch_step.py [--tree DIR] [--steps 8]
        [--engine persistent|bounce] [--profile-first]
        [--progressive ROUNDS] [--split] [--tiles N] [--parent DIR]

Imports ``tryraytrace_tpu_torch`` and ``chip_smoke`` (for the main-path
scene) from ``DIR`` (default: this checkout), so that a commit and its
parent can be timed in turn in one run on one card.  Renders
chip_smoke.py's main path (Cornell box + icosphere(5), 20,487
triangles, 1200x800 at 1 spp) with the engine ``--engine`` names
(default: the persistent engine): one warm-up step, then ``--steps``
steps, each timed on the host clock and ended by
``Renderer.block_until_ready``.  ``--profile-first`` runs one
torch.profiler session around a tonemap before the warm-up, to see
whether a profiler session slows the steps that follow it.  Prints one
JSON line: the step times, their median and quartiles, rounds (the
bounce engine's bounces), path and shadow rays and rows per step, the
image mean, and the launches over the timed steps of each hand-written
kernel the tree counts (``COUNTED``).  ``--progressive ROUNDS`` times
``--steps`` frames of an unbounded ProgressiveRenderer (ROUNDS rounds a
frame, as the app's ticks) instead.  ``--tiles N`` times
``Renderer.step_tiled(cam, N)`` instead of ``Renderer.step``.

``--parent DIR`` runs this script with the other arguments on ``DIR``
and on this checkout in turns, parent, this, this, parent, each in a
process of its own (so no profiler session and no other tree's kernels
share it), prints each run's line and then a summary line with every
run's median and quartiles.

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
import importlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
# The wrappers whose ``launches`` a tree may count: (module, function).
COUNTED = (("tryraytrace_tpu_torch.ops.lane_init", "lane_init_cuda"),
           ("tryraytrace_tpu_torch.ops.wave", "wave_advance_cuda"),
           ("tryraytrace_tpu_torch.ops.threaded", "threaded_walk_cuda"),
           ("tryraytrace_tpu_torch.ops.bounce", "bounce_rays_cuda"),
           ("tryraytrace_tpu_torch.ops.bounce", "bounce_shade_cuda"),
           ("tryraytrace_tpu_torch.ops.bounce", "bounce_nee_cuda"))


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


def _launch_counts() -> dict:
    """{wrapper: its launches so far} for the COUNTED wrappers the
    imported tree has."""
    out = {}
    for module, name in COUNTED:
        try:
            out[name] = getattr(importlib.import_module(module),
                                name).launches
        except (ImportError, AttributeError):
            continue
    return out


def _in_turns(parent: str) -> int:
    """This script's other arguments on ``parent`` and on this checkout,
    parent, this, this, parent, a process each; one summary line."""
    argv, skip = [], False
    for a in sys.argv[1:]:
        if skip or a == "--parent" or a.startswith("--parent="):
            skip = a == "--parent"
            continue
        argv.append(a)
    runs = []
    for label, tree in (("parent", parent), ("change", HERE),
                        ("change", HERE), ("parent", parent)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), *argv, "--tree",
             tree], capture_output=True, text=True, check=True,
            timeout=1200).stdout.strip().splitlines()[-1]
        print(out, flush=True)
        res = json.loads(out)
        runs.append(dict(label=label, **{k: res.get(k) for k in (
            "median_ms", "q1_ms", "q3_ms", "launches", "image_mean")}))
    print(json.dumps(dict(device=res["device"], turns=runs)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--parent", metavar="DIR",
                    help="time DIR and this checkout in turns")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--engine", choices=("persistent", "bounce"),
                    default="persistent")
    ap.add_argument("--profile-first", action="store_true")
    ap.add_argument("--progressive", type=int, default=0, metavar="ROUNDS",
                    help="time progressive frames of ROUNDS rounds "
                         "(ProgressiveRenderer.step) instead of steps")
    ap.add_argument("--split", action="store_true",
                    help="also time the host side of each step's parts")
    ap.add_argument("--tiles", type=int, default=0,
                    help="time step_tiled with this many strips")
    args = ap.parse_args()
    if args.parent:
        return _in_turns(os.path.abspath(args.parent))
    if args.progressive and args.engine != "persistent":
        ap.error("--progressive runs the persistent engine")
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
                 cfg=RenderConfig(width=w, height=h, spp=1,
                                  engine=args.engine))
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
    steps, before = [], _launch_counts()
    for i in range(args.steps + 1):
        torch.cuda.synchronize()
        if i == 1:
            before = _launch_counts()
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
    after = _launch_counts()
    out = {"tree": tree, "engine": args.engine,
           "profile_first": args.profile_first,
           "tiles": args.tiles, "ms": [s["ms"] for s in steps],
           "median_ms": median, "q1_ms": q1, "q3_ms": q3, "steps": steps,
           "image_mean": float(img.mean()),
           "launches": {k: after[k] - before[k] for k in after},
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
