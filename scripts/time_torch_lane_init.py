"""The lane set-up kernel's own time on every ``chip_smoke.py
[lane_init]`` case, for several builds of it in one process on one card.

    python3 scripts/time_torch_lane_init.py [--tree DIR]
        [--variant NAME=FLAGS ...] [--reps 20] [--out FILE]

Builds ``csrc/lane_init.cu`` of this checkout as the port builds it
("change"), the same source with extra nvcc flags for each ``--variant``
(for example ``r32=-maxrregcount=32``, or ``-D`` of a macro in a trial
copy of the source), and, with ``--tree``, the lane set-up kernel of
the checkout DIR ("parent", for example a ``git archive`` of the parent
commit unpacked under ``build/parent``).  Every build is launched through
``ops/lane_init.py lane_init_cuda(..., library=)``: the kernel's C
interface is the same in each.  Prints each build's registers, shared
memory, stack and spills (``ptxas -v``) and, for this checkout's
source, its launch plan (SMs, blocks an SM, grid, shared bytes).

Then, for each case of ``chip_smoke.py [lane_init]``
(``chip_smoke.lane_cases``: the main path's 960,000 lanes, a tiled
strip, a shard, a lens, an untextured scene, the [features] renderer, a
pixel tensor, the last 257 pixels, 240,000 lanes from an odd pixel),
holds every build to ``init_lane_ctx`` on a poisoned guarded state
(``chip_smoke._lane_case``: every field bit for bit, the totals and
rows, no guard byte changed), and takes each build's own time a launch
(``chip_smoke._kernel_ms``: torch.profiler's durations of the kernel) on
state as a ``Wave`` allocates it, in turns: the builds in order, then in
reverse order, so a drift of the card's clock falls on both ends alike.
Prints one line a case, with its byte bound (``chip_smoke.
lane_state_bytes`` over the card's memory rate), and a JSON summary
(also written to ``--out``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tryraytrace_tpu_torch import cli  # noqa: E402
from tryraytrace_tpu_torch.camera.controller import CameraController  # noqa: E402
from tryraytrace_tpu_torch.config import RenderConfig  # noqa: E402
from tryraytrace_tpu_torch.engine import persistent  # noqa: E402
from tryraytrace_tpu_torch.engine.renderer import Renderer  # noqa: E402
from tryraytrace_tpu_torch.ops import _build, lane_init, service  # noqa: E402

KERNEL = "lane_init_kernel"


class Build:
    """One build of a lane set-up kernel source."""

    def __init__(self, name: str, source: str, flags=()):
        self.name = name
        self.ours = source == lane_init.LIBRARY.source
        functions = dict(lane_init.LIBRARY.functions)
        if not self.ours:  # another tree's kernel: only its launch
            del functions["trt_lane_init_plan"]
        self.lib = _build.KernelLibrary("lane_init", functions)
        self.lib.source = source
        self.lib.flags = (*self.lib.flags, *flags)
        self.numbers = {}

    def load(self) -> None:
        self.lib.load()
        self.numbers = chip_smoke.ptxas_numbers(self.lib.compiler_log, KERNEL)
        if self.ours:
            self.numbers["plan"] = lane_init.launch_plan(self.lib)


def renderers(tmp: str) -> tuple:
    """The main path's Renderer and the [features] one, at 1200x800."""
    r = Renderer(chip_smoke.main_path_arrays(), cfg=RenderConfig(
        width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT, spp=1))
    args, _ = chip_smoke.features_scene_args(tmp)
    arrays = cli.build_scene_arrays(cli.build_parser().parse_args(
        ["render", *args]))
    features_r = Renderer(arrays, cfg=RenderConfig(
        width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT, spp=1,
        **chip_smoke.FEATURE_CFG))
    return r, features_r


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_lane_init: no CUDA device", file=sys.stderr)
        return 2
    source = lane_init.LIBRARY.source
    builds = [Build("change", source)]
    if args.tree:
        builds.insert(0, Build("parent", os.path.join(
            os.path.abspath(args.tree), "tryraytrace_tpu_torch", "csrc",
            "lane_init.cu")))
    for spec in args.variant:
        name, flags = spec.split("=", 1)
        builds.append(Build(name, source, flags.split()))
    _build.build_all([b.lib for b in builds])
    for b in builds:
        b.load()
        extra = b.lib.flags[len(_build.NVCC_FLAGS):]
        print(f"[time_lane_init] {b.name}: {list(extra)} {b.numbers}",
              flush=True)
    params = CameraController().get_params(chip_smoke.WIDTH,
                                           chip_smoke.HEIGHT)
    table = {}
    with tempfile.TemporaryDirectory() as tmp:
        r, features_r = renderers(tmp)
        for case in chip_smoke.lane_cases(r, features_r, params):
            label, rr, cam, pixels, frame, seed_spp, offset = case
            for b in builds:
                chip_smoke._lane_case(f"{b.name}: {label}", rr, cam, pixels,
                                      frame, seed_spp, offset, library=b.lib)
            ranged = isinstance(pixels, range)
            n = len(pixels)
            fr = persistent._Frame(rr.scene, rr.inline, rr.cfg, cam, frame,
                                   chip_smoke.WIDTH, chip_smoke.HEIGHT, 1,
                                   seed_spp, offset)
            p = service.service_params(fr)
            s = lane_init.new_lane_state(n, rr.cfg.quad_regs,
                                         rr.inline.tex0 is not None,
                                         rr.device, None if ranged else pixels)
            totals = torch.empty(len(service.TOTALS), dtype=torch.int64,
                                 device=rr.device)
            rows = torch.empty((), dtype=torch.int64, device=rr.device)
            first = pixels.start if ranged else None
            times = {b.name: [] for b in builds}
            for b in builds + builds[::-1]:
                times[b.name].append(chip_smoke._kernel_ms(
                    lambda: lane_init.lane_init_cuda(
                        s, rr.inline, p, totals, rows, first, library=b.lib),
                    KERNEL, reps=args.reps))
            bound_ms = 1e3 * chip_smoke.lane_state_bytes(s) / \
                chip_smoke.MEM_BYTES_PER_S
            table[label] = dict(lanes=n, bound_ms=bound_ms, own_ms={
                k: float(np.mean(v)) for k, v in times.items()},
                turns={k: v for k, v in times.items()})
            print(f"[time_lane_init] {label} ({n} lanes, byte bound "
                  f"{bound_ms:.5f} ms): " + ", ".join(
                      f"{k} {v[0]:.5f}/{v[1]:.5f} ms "
                      f"({np.mean(v) / bound_ms:.2f}x)"
                      for k, v in times.items()), flush=True)
            del s, p, fr
    summary = dict(device=torch.cuda.get_device_name(0),
                   builds={b.name: dict(flags=list(b.lib.flags), **b.numbers)
                           for b in builds},
                   cases=table)
    line = json.dumps(summary)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
