"""The wave kernel's own device time on the main step, as the port builds
it and in benchmark builds of the same source, timed in turns.

    python3 scripts/time_torch_wave.py [--variant NAME=FLAGS ...]
        [--reps 5] [--turns 2]

Builds chip_smoke.py's main path (Cornell box + icosphere(5), 20,487
triangles, 1200x800 at 1 spp) and the fresh lane state of a step, and
runs the wave kernel (csrc/wave_advance.cu) on copies of it, every lane
to its end: the port's build, and each ``--variant`` (``-D`` flags,
comma-separated, e.g. ``blocks3=TRT_WAVE_MIN_BLOCKS=3``), each held bit
for bit to the port's build first (every state field, the totals, the
rows and the rounds).  Then every build is timed ``--turns`` times, in
forward and backward order, by torch.profiler's durations of the kernel
itself (chip_smoke._kernel_ms, ``--reps`` launches a time).  Prints
each build's registers, stack and spills, one line per time and a JSON
line last.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tryraytrace_tpu_torch.camera.controller import CameraController  # noqa: E402
from tryraytrace_tpu_torch.config import RenderConfig  # noqa: E402
from tryraytrace_tpu_torch.engine.renderer import Renderer  # noqa: E402
from tryraytrace_tpu_torch.ops import _build, wave  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DEFINE[,DEFINE...]")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_wave: no CUDA device", file=sys.stderr)
        return 2
    builds = {"port": wave.LIBRARY}
    for spec in args.variant:
        name, flags = spec.split("=", 1)
        builds[name] = _build.KernelLibrary(
            "wave_advance", wave.LIBRARY.functions,
            defines=tuple(f for f in flags.split(",") if f))
    _build.build_all(builds.values())
    for name, lib in builds.items():
        print(f"[time_wave] {name} {lib.flags[len(_build.NVCC_FLAGS):]}: "
              f"{chip_smoke.kernel_builds(lib, 'wave_advance_kernel')}")
    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
    r = Renderer(chip_smoke.main_path_arrays(),
                 cfg=RenderConfig(width=w, height=h, spp=1))
    params = CameraController().get_params(w, h)
    fr, s0 = chip_smoke.service_frame(r, params)
    passes = max(1, r.cfg.quad_redirect_passes)
    n = w * h
    port = wave.LIBRARY

    def run(library):
        """The build's wave over a fresh copy of the state: (state,
        totals, rows, rounds, live)."""
        wave.LIBRARY = library
        try:
            s = chip_smoke._copy(s0)
            totals = torch.tensor([n, 0, 0, 0], device=r.device)
            rows = torch.zeros((), dtype=torch.int64, device=r.device)
            ran, live = wave.wave_advance_cuda(
                s, r.inline, fr.service, totals, rows, k=r.scene.leaf_size,
                fmt=r.scene.leaf_fmt, passes=passes)
        finally:
            wave.LIBRARY = port
        return s, totals, rows, ran, live

    want = run(port)
    for name, lib in builds.items():
        got = run(lib)
        bad = [k for k in want[0] if not torch.equal(
            chip_smoke._bits(got[0][k]), chip_smoke._bits(want[0][k]))]
        same = (not bad and got[1].tolist() == want[1].tolist()
                and int(got[2]) == int(want[2]) and got[3:] == want[3:])
        print(f"[time_wave] {name}: {got[3]} rounds, totals "
              f"{got[1].tolist()}, rows {int(got[2])}; fields not bit-equal "
              f"to the port's {bad}")
        if not same:
            raise AssertionError(f"build {name} differs from the port's")
    times = {name: [] for name in builds}
    for turn in range(args.turns):
        order = list(builds) if turn % 2 == 0 else list(builds)[::-1]
        for name in order:
            ms = chip_smoke._kernel_ms(lambda: run(builds[name]),
                                       "wave_advance_kernel", reps=args.reps)
            times[name].append(ms)
            print(f"[time_wave] turn {turn}: {name} {ms:.4f} ms")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "rounds": want[3], "rows": int(want[2]),
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
