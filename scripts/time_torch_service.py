"""The service kernel's own time on every ``chip_smoke.py [service]``
state, for several builds of it in one process on one card.

    python3 scripts/time_torch_service.py [--tree DIR]
        [--variant NAME=FLAGS ...] [--reps 10] [--out FILE]

Builds ``csrc/service_pass.cu`` of this checkout as the port builds it
("change"), the same source with extra nvcc flags for each ``--variant``
(for example ``-D`` of a macro in a trial copy of the source), and, with
``--tree``, the service kernel of the checkout DIR
("parent"; a commit before the kernel kept the wave's totals takes three
counters where this one takes the totals, which the script reads from
the library's layout).  Prints each build's registers, stack and spills
(``ptxas -v``).

Then, for each state of ``chip_smoke.py [service]`` (the main path's
and the [features] path's fresh, shadow and late rounds, rounds 0 and 4
of the 17-light and pack-2 frames, and the seed-made mixed state; the
rounds stepped by this checkout's kernels), holds every build to the
plain version (every field equal, and the totals, or for three counters
their sums), and takes each build's own time per launch
(``chip_smoke._kernel_ms``: torch.profiler's durations of the kernel)
in turns: the builds in order, then in reverse order, so a drift of the
card's clock falls on both ends alike.  Prints one line a state and a
JSON summary (also written to ``--out``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
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
from tryraytrace_tpu_torch.ops import _build, service  # noqa: E402


class Build:
    """One build of a service kernel source, launched through the C
    interface its library reports (four totals, or three counters)."""

    def __init__(self, name: str, source: str, flags=()):
        self.name = name
        self.lib = _build.KernelLibrary(
            "service_pass", {"trt_service_layout": (ctypes.c_void_p,)})
        self.lib.source = source
        self.lib.flags = (*self.lib.flags, *flags)

    def load(self):
        handle = self.lib.load()
        layout = (ctypes.c_int * 4)(-1, -1, -1, -1)
        handle.trt_service_layout(ctypes.addressof(layout))
        self.totals = layout[3] == len(service.TOTALS)
        fn = handle.trt_service_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * self.totals + [ctypes.c_void_p])
        self.launch = fn
        self.numbers = chip_smoke.ptxas_numbers(self.lib.compiler_log,
                                                "service_pass_kernel")

    def run(self, s, inline, params):
        """One pass on ``s`` in place; returns its totals (path, shadow,
        live) as a list."""
        dev = s["mode"].device
        ptrs = [inline.table.data_ptr(), params.lights.data_ptr(),
                params.metas.data_ptr()]
        for name, _, _ in service.FIELDS:
            ptrs.append(0 if name == "tstash" and inline.tex0 is None
                        else s[name].data_ptr())
        counts = torch.zeros(len(service.TOTALS) if self.totals else 3,
                             dtype=torch.int64, device=dev)
        ptrs.append(counts.data_ptr())
        host = (ctypes.c_void_p * len(ptrs))(*ptrs)
        floats = np.ascontiguousarray(params.floats, np.float32)
        ints = np.ascontiguousarray(params.ints, np.int64)
        stream = torch.cuda.current_stream().cuda_stream
        args = [floats.ctypes.data, ints.ctypes.data, ctypes.addressof(host),
                s["mode"].shape[0], *([0] if self.totals else []), stream]
        err = self.launch(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: launch failed, CUDA error {err}")
        if self.totals:
            return counts[:3]
        cont, shadow, start = counts
        return torch.stack([cont + start, shadow])


def states(params, tmp: str):
    """Yield (label, Renderer, _Frame, state) for each [service] state."""
    runs = [("main", Renderer(chip_smoke.main_path_arrays(),
                              cfg=RenderConfig(width=chip_smoke.WIDTH,
                                               height=chip_smoke.HEIGHT,
                                               spp=1)))]
    args, _ = chip_smoke.features_scene_args(tmp)
    arrays = cli.build_scene_arrays(cli.build_parser().parse_args(
        ["render", *args]))
    runs.append(("features", Renderer(arrays, cfg=RenderConfig(
        width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT, spp=1,
        **chip_smoke.FEATURE_CFG))))
    for name, r in runs:
        for label, _, fr, _, walked in chip_smoke.labelled_rounds(r, params):
            yield f"{name} {label}", r, fr, walked
    for name, arrays, cfg in chip_smoke.service_scenes(tmp):
        r = Renderer(arrays, cfg=cfg)
        fr, s0 = chip_smoke.service_frame(r, params)
        for rnd, _, walked in chip_smoke.frame_rounds(r, fr, s0):
            if rnd in chip_smoke.SERVICE_ROUNDS:
                yield f"{name}, round {rnd}", r, fr, walked
            if rnd == max(chip_smoke.SERVICE_ROUNDS):
                break
    r = Renderer(chip_smoke.mixed_arrays(), cfg=RenderConfig(
        width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT, spp=1))
    fr, s = chip_smoke.mixed_state(r, params, chip_smoke.WIDTH,
                                   chip_smoke.HEIGHT, chip_smoke.MIXED_SEED)
    fr.service = service.service_params(fr)
    yield "mixed", r, fr, s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_service: no CUDA device", file=sys.stderr)
        return 2
    source = service.LIBRARY.source
    builds = [Build("change", source)]
    if args.tree:
        builds.insert(0, Build("parent", os.path.join(
            os.path.abspath(args.tree), "tryraytrace_tpu_torch", "csrc",
            "service_pass.cu")))
    for spec in args.variant:
        name, flags = spec.split("=", 1)
        builds.append(Build(name, source, flags.split()))
    _build.build_all([b.lib for b in builds])
    for b in builds:
        b.load()
        extra = b.lib.flags[len(_build.NVCC_FLAGS):]
        print(f"[time_service] {b.name}: {extra} {b.numbers}", flush=True)
    params = CameraController().get_params(chip_smoke.WIDTH,
                                           chip_smoke.HEIGHT)
    table = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, r, fr, s in states(params, tmp):
            fresh = lambda: {k: v.clone() for k, v in s.items()}
            want_totals = torch.zeros(len(service.TOTALS),
                                      dtype=torch.int64, device=r.device)
            want = persistent.service_plain(s, r.inline, fr, want_totals, 0)
            fields = [f for f, _, _ in service.FIELDS if f in s]
            for b in builds:
                got = fresh()
                totals = b.run(got, r.inline, fr.service)
                torch.cuda.synchronize()
                bad = [f for f in fields if not chip_smoke._same(got[f],
                                                                 want[f])]
                if bad or totals.tolist() != want_totals[
                        :len(totals)].tolist():
                    raise AssertionError(f"{b.name} disagrees with the plain "
                                         f"version on {label}: {bad}")
            times = {b.name: [] for b in builds}
            for b in builds + builds[::-1]:
                times[b.name].append(chip_smoke._kernel_ms(
                    lambda: b.run(fresh(), r.inline, fr.service),
                    "service_pass_kernel", reps=args.reps))
            table[label] = {k: float(np.mean(v)) for k, v in times.items()}
            print(f"[time_service] {label}: " + ", ".join(
                f"{k} {v[0]:.4f}/{v[1]:.4f} ms" for k, v in times.items()),
                flush=True)
            del s, fr, r
    summary = dict(device=torch.cuda.get_device_name(0),
                   builds={b.name: dict(flags=list(b.lib.flags),
                                        **b.numbers) for b in builds},
                   own_ms=table)
    line = json.dumps(summary)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
