"""The wave kernel's own device time, by build, timed in turns; and the
round clock of its benchmark builds.

    python3 scripts/time_torch_wave.py [--tree DIR]
        [--variant NAME=DEFINE[,DEFINE...] ...] [--rounds]
        [--reps 5] [--turns 2] [--out FILE]

Builds chip_smoke.py's main path (Cornell box + icosphere(5), 20,487
triangles, 1200x800 at 1 spp) and two lane states: the fresh state of a
step ("main", every lane run to its end) and a fresh progressive wave
with no sample cap ("progressive 8", one call of 8 rounds, as an app
tick runs it).  Runs the wave kernel (csrc/wave_advance.cu) on copies of
them: this checkout's source as the port builds it ("port"), the wave
kernel of the checkout ``--tree DIR`` ("parent"; a ``git archive`` of
another commit unpacked into a directory that .gitignore lists, such as
``build/parent``), and each ``--variant`` (this source with ``-D``
flags, comma-separated: ``TRT_WAVE_MIN_BLOCKS=N`` the launch bounds'
blocks an SM, ``TRT_WAVE_TAIL_WARP_LANES=N`` the tail's threshold in
live lanes a warp of the grid, 0 for no tail).  Every build is launched
by ops/wave.py wave_advance_cuda and held bit for bit to the port's
build first (every state field, the four totals, the rows, the rounds
and the live lanes), then timed ``--turns`` times, in forward and
backward order, by torch.profiler's durations of the kernel itself
(chip_smoke._kernel_ms, ``--reps`` launches a time).

``--rounds`` also builds every build of this source with
``-D TRT_WAVE_ROUND_CLOCK`` and runs it once on the main step: thread 0
of block 0 records the card's clock after each grid sync, so each dense
round's walk phase and service phase (ms, a barrier included) and the
lanes it leaves live are printed beside the round loop's longest walk
of that round (chip_smoke.longest_quad_walk) and its latency floor,
that walk times one warp's dependent fetch step (measured here as
chip_smoke.py [fetch] measures it); the tail, where there is one, is
one span from the last dense round to the launch's end, printed beside
two floors of those rounds: the round loop's (the sum of their longest
walks x the step) and the longest lane's own chain (the most walk rows
one lane fetches in them x the step), which a tail whose warps wait
for no other could reach.

Prints each build's registers, stack, spills and blocks an SM, one line
per time and a JSON line last (also written to ``--out``).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tryraytrace_tpu_torch.accel.bvh import LEAF_FORMATS  # noqa: E402
from tryraytrace_tpu_torch.camera.controller import CameraController  # noqa: E402
from tryraytrace_tpu_torch.config import RenderConfig  # noqa: E402
from tryraytrace_tpu_torch.engine import persistent  # noqa: E402
from tryraytrace_tpu_torch.engine.renderer import Renderer  # noqa: E402
from tryraytrace_tpu_torch.ops import _build, service, walk, wave  # noqa: E402

CLOCK = "TRT_WAVE_ROUND_CLOCK"
CLOCK_HEAD = 4           # csrc/wave_advance.cu Clock: start, end, dense, tail
CLOCK_ROUNDS = 1024      # its kClockRounds
PROGRESSIVE_ROUNDS = 8


class Build:
    """One build of a wave kernel source, launched by ops/wave.py
    wave_advance_cuda (which sizes the launch counters from the
    library's own layout)."""

    def __init__(self, name: str, source: str, defines=()):
        self.name = name
        functions = dict(wave.LIBRARY.functions)
        if CLOCK in defines:
            functions["trt_wave_round_clock"] = (ctypes.c_void_p,
                                                 ctypes.c_int)
        self.lib = _build.KernelLibrary("wave_advance", functions,
                                        defines=defines)
        self.lib.source = source
        self.defines = tuple(defines)

    def load(self):
        handle = self.lib.load()
        self.numbers = chip_smoke.ptxas_numbers(self.lib.compiler_log,
                                                "wave_advance_kernel")
        return handle

    def run(self, r: Renderer, fr, s, totals, rows, budget=None):
        """One launch on ``s`` in place; returns (rounds run, lanes
        live)."""
        out = wave.wave_advance_cuda(
            s, r.inline, fr.service, totals, rows, budget,
            k=r.scene.leaf_size, fmt=r.scene.leaf_fmt,
            passes=r.cfg.quad_redirect_passes, library=self.lib)
        self.plan = wave.wave_advance_cuda.plan
        return out

    def clock(self) -> list:
        """The round clock of the build's last launch (clock builds)."""
        out = (ctypes.c_longlong * (CLOCK_HEAD + 3 * CLOCK_ROUNDS))()
        err = self.lib.handle.trt_wave_round_clock(ctypes.addressof(out),
                                                   len(out))
        if err != 0:
            raise RuntimeError(f"{self.name}: clock read failed, {err}")
        return list(out)


def blocks_an_sm(build: Build, r: Renderer, regs: int) -> int:
    """Blocks an SM of the main path's instance by registers alone: the
    plan of a one-row table with nothing staged."""
    plan = (ctypes.c_int * 5)()
    levels = (ctypes.c_longlong * 1)(0)
    err = build.lib.handle.trt_wave_advance_plan(
        1, r.inline.walk.shape[1], regs, LEAF_FORMATS[r.scene.leaf_fmt],
        levels, 0, plan)
    if err != 0:
        raise RuntimeError(f"{build.name}: plan failed, CUDA error {err}")
    return plan[3]


def round_table(clock: list, work: list, latency_ns: float) -> dict:
    """Each dense round's phases (ms), live lanes and the round loop's
    longest walk and latency floor of that round, from a clock build's
    record and two_kernel_rounds' work; and for the rounds after the
    last dense one, the round loop's per-round floor (their longest
    walks x the step) and the longest lane's own chain (the most walk
    rows of one lane in those rounds x the step; its services' latency
    not counted), the least time of a tail in which a warp waits for
    no other."""
    start, end, dense, tail = clock[:CLOCK_HEAD]
    rows, prev = [], start
    for i in range(min(dense, CLOCK_ROUNDS)):
        walk_end, serve_end, live = clock[CLOCK_HEAD + 3 * i:
                                          CLOCK_HEAD + 3 * i + 3]
        rows.append(dict(
            round=i, walk_ms=(walk_end - prev) * 1e-6,
            service_ms=(serve_end - walk_end) * 1e-6, live_after=live,
            longest_walk=work[i]["longest_walk"],
            floor_ms=work[i]["longest_walk"] * latency_ns * 1e-6))
        prev = serve_end
    after = work[min(dense, len(work)):]
    chain = (int(torch.stack([x["lane_rows"] for x in after]).sum(0).max())
             if after else 0)
    return dict(rounds=rows, dense=dense, tail_rounds=tail,
                tail_ms=(end - prev) * 1e-6, total_ms=(end - start) * 1e-6,
                after_floor_ms=sum(x["longest_walk"] for x in after)
                * latency_ns * 1e-6,
                lane_chain_rows=chain,
                lane_chain_ms=chain * latency_ns * 1e-6)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", help="a checkout whose wave kernel is timed "
                                   "as 'parent'")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DEFINE[,DEFINE...]")
    ap.add_argument("--rounds", action="store_true",
                    help="also the round clock of this source's builds")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_wave: no CUDA device", file=sys.stderr)
        return 2
    source = wave.LIBRARY.source
    builds = [Build("port", source)]
    if args.tree:
        builds.append(Build("parent", os.path.join(
            os.path.abspath(args.tree), "tryraytrace_tpu_torch", "csrc",
            "wave_advance.cu")))
    for spec in args.variant:
        name, flags = spec.split("=", 1)
        builds.append(Build(name, source,
                            tuple(f for f in flags.split(",") if f)))
    clocks = []
    if args.rounds:
        clocks = [Build(f"{b.name}+clock", source, (*b.defines, CLOCK))
                  for b in builds if b.lib.source == source]
    _build.build_all([b.lib for b in (*builds, *clocks)])

    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
    r = Renderer(chip_smoke.main_path_arrays(),
                 cfg=RenderConfig(width=w, height=h, spp=1))
    params = CameraController().get_params(w, h)
    n = w * h
    cam = params.to(r.device)
    fr, s_main = chip_smoke.service_frame(r, params)
    pfr = persistent._Frame(r.scene, r.inline, r.cfg, cam, 0, w, h,
                            chip_smoke.UNBOUNDED_SPP, 1)
    pfr.service = service.service_params(pfr)
    s_prog = persistent.init_lane_ctx(
        0, 1, torch.arange(n, device=r.device), cam, w, h, r.cfg,
        with_tstash=r.inline.tex0 is not None)
    cases = {"main": (fr, s_main, None),
             f"progressive {PROGRESSIVE_ROUNDS}": (pfr, s_prog,
                                                   PROGRESSIVE_ROUNDS)}
    for b in (*builds, *clocks):
        b.load()
        b.numbers["blocks_an_sm"] = blocks_an_sm(b, r,
                                                 walk.state_regs(s_main))
        extra = b.lib.flags[len(_build.NVCC_FLAGS):]
        print(f"[time_wave] {b.name} {b.lib.source} {extra}: {b.numbers}",
              flush=True)

    def run(b, case):
        cfr, s0, budget = cases[case]
        s = chip_smoke._copy(s0)
        totals = torch.tensor([n, 0, 0, 0], device=r.device)
        rows = torch.zeros((), dtype=torch.int64, device=r.device)
        ran, live = b.run(r, cfr, s, totals, rows, budget)
        return s, totals, rows, ran, live

    results = {}
    for case in cases:
        want = run(builds[0], case)
        for b in (*builds, *clocks):
            got = want if b is builds[0] else run(b, case)
            bad = [k for k in want[0] if not torch.equal(
                chip_smoke._bits(got[0][k]), chip_smoke._bits(want[0][k]))]
            same = (not bad and got[1].tolist() == want[1].tolist()
                    and int(got[2]) == int(want[2]) and got[3:] == want[3:])
            print(f"[time_wave] {case}: {b.name}: {got[3]} rounds, {got[4]} "
                  f"live, totals {got[1].tolist()}, rows {int(got[2])}, plan "
                  f"{b.plan}; fields not bit-equal to the port's {bad}",
                  flush=True)
            if not same:
                raise AssertionError(f"build {b.name} differs from the "
                                     f"port's on {case}")
        results[case] = dict(rounds=want[3], live=want[4], rows=int(want[2]),
                             ms={b.name: [] for b in builds})
    for turn in range(args.turns):
        order = builds if turn % 2 == 0 else builds[::-1]
        for b in order:
            for case in cases:
                ms = chip_smoke._kernel_ms(lambda: run(b, case),
                                           "wave_advance_kernel",
                                           reps=args.reps)
                results[case]["ms"][b.name].append(ms)
                print(f"[time_wave] turn {turn}: {case}: {b.name} {ms:.4f} "
                      f"ms", flush=True)
    out = dict(device=torch.cuda.get_device_name(0), cases=results,
               builds={b.name: dict(flags=list(b.lib.flags[len(
                   _build.NVCC_FLAGS):]), source=b.lib.source, plan=b.plan,
                   **b.numbers) for b in (*builds, *clocks)})
    if clocks:
        latency = chip_smoke._load_fetch_script().latency_ns(0)["global_ns"]
        work = []
        s = chip_smoke._copy(s_main)
        totals = torch.tensor([n, 0, 0, 0], device=r.device)
        rows = torch.zeros((), dtype=torch.int64, device=r.device)
        chip_smoke.two_kernel_rounds(r, fr, s, totals, rows, None, 0, work,
                                     lane_rows=True)
        floor = sum(x["longest_walk"] for x in work) * latency * 1e-6
        print(f"[time_wave] one warp's dependent fetch step {latency:.1f} ns;"
              f" the round loop's {len(work)} rounds: latency floor "
              f"{floor:.4f} ms (longest walks {[x['longest_walk'] for x in work]})")
        out.update(latency_ns=latency, latency_floor_ms=floor, clock={})
        for b in clocks:
            run(b, "main")
            torch.cuda.synchronize()
            table = round_table(b.clock(), work, latency)
            out["clock"][b.name] = table
            print(f"[time_wave] {b.name}: {table['dense']} dense rounds, "
                  f"{table['tail_rounds']} tail rounds; launch "
                  f"{table['total_ms']:.4f} ms, after the last dense round "
                  f"{table['tail_ms']:.4f} ms (the round loop's per-round "
                  f"floor of those rounds {table['after_floor_ms']:.4f} ms; "
                  f"the longest lane's own walks in them "
                  f"{table['lane_chain_rows']} rows, "
                  f"{table['lane_chain_ms']:.4f} ms)")
            print("[time_wave]   round  walk_ms  service_ms  live_after  "
                  "longest_walk  floor_ms")
            for x in table["rounds"]:
                print(f"[time_wave]   {x['round']:5d} {x['walk_ms']:8.4f} "
                      f"{x['service_ms']:11.4f} {x['live_after']:11d} "
                      f"{x['longest_walk']:13d} {x['floor_ms']:9.4f}")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
