"""The threaded-walk kernel's own time on every ``chip_smoke.py`` threaded
state, for several builds of it in one process on one card.

    python3 scripts/time_torch_threaded.py [--tree DIR]
        [--variant NAME=FLAGS ...] [--reps 10] [--out FILE]

Builds ``csrc/threaded_walk.cu`` of this checkout as the port builds it
("change"), the same source with extra nvcc flags for each ``--variant``
(for example ``-maxrregcount=48``, or ``-D`` of a macro in a trial
copy of the source), and, with ``--tree``, the threaded-walk kernel of
the checkout DIR ("parent").  A parent that predates the walk-order copy
(entry points ``trt_threaded_closest_launch`` /
``trt_threaded_any_launch``, scalar loads) is timed twice: on the
scene's threaded table as it walked it ("parent"), and on the
walk-order copy ("parent on copy").  Prints each build's registers, stack and spills (``ptxas
-v``).

The states are ``chip_smoke.py``'s six: the camera rays, the first
bounce's shadow rays and a late closest-hit walk (at most 10% of the
lanes alive) of a 1200x800 bounce frame, over the main path's tree
("bw" leaves) and over the [features] path's SBVH ("mt" leaves, rows
of 78 floats, 80 in the copy).  On each, every build is first held to
the plain version (every output and the rows fetched equal), then
timed by its own device time per launch (``chip_smoke._kernel_ms``:
torch.profiler's durations of the kernel) in turns: the builds in
order, then in reverse order, so a drift of the card's clock falls on
both ends alike.  Prints one line a state and a JSON summary (also
written to ``--out``).  Needs a CUDA device.
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
from tryraytrace_tpu_torch.accel.bvh import LEAF_FORMATS  # noqa: E402
from tryraytrace_tpu_torch.camera.controller import CameraController  # noqa: E402
from tryraytrace_tpu_torch.config import RenderConfig  # noqa: E402
from tryraytrace_tpu_torch.engine.renderer import Renderer  # noqa: E402
from tryraytrace_tpu_torch.ops import _build, threaded, traverse  # noqa: E402

KERNEL = "threaded_walk_kernel"
# The C interface of a kernel from before the walk-order copy: table,
# sentinel, width, k, fmt, lanes, o, d, then the closest hit's active,
# t, id, rows, stream, or the any hit's max_dist, active, occluded,
# rows, stream.
_OLD = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        *([ctypes.c_void_p] * 5))


class Build:
    """One build of a threaded-walk source, launched through the C
    interface its library has: this kernel's (through
    ``threaded_walk_cuda``) or the scalar-load kernel's (``old``), which
    walks ``table`` ("node": the scene's threaded table, or "copy": the
    walk-order copy)."""

    def __init__(self, name: str, source: str, flags=(), table="copy"):
        self.name = name
        self.table = table
        self.lib = _build.KernelLibrary("threaded_walk", {})
        self.lib.source = source
        self.lib.flags = (*self.lib.flags, *flags)
        self.old = False

    def load(self):
        handle = self.lib.load()
        self.old = not hasattr(handle, "trt_threaded_walk_launch")
        self.lib.functions = (
            {f: _OLD for f in ("trt_threaded_closest_launch",
                               "trt_threaded_any_launch")}
            if self.old else threaded.LIBRARY.functions)
        for fname, argtypes in self.lib.functions.items():
            fn = getattr(handle, fname)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
        self.numbers = chip_smoke.threaded_builds(self.lib.compiler_log)

    def run(self, scene, walk, state):
        """One walk of ``state`` -> the wrapper's outputs."""
        o, d, active, max_dist = state
        k, fmt = scene.leaf_size, scene.leaf_fmt
        if not self.old:
            saved = threaded.LIBRARY
            threaded.LIBRARY = self.lib
            try:
                return threaded.threaded_walk_cuda(walk, k, o, d, active,
                                                   max_dist, fmt=fmt)
            finally:
                threaded.LIBRARY = saved
        table = scene.node_table if self.table == "node" else walk
        sentinel, width = table.shape
        dev = table.device
        n = o.shape[0]
        rows = torch.zeros((), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        common = (table.data_ptr(), sentinel, width, k, LEAF_FORMATS[fmt],
                  n, o.data_ptr(), d.data_ptr())
        if max_dist is not None:
            occ = torch.zeros((n,), dtype=torch.bool, device=dev)
            err = self.lib.handle.trt_threaded_any_launch(
                *common, max_dist.data_ptr(), active.data_ptr(),
                occ.data_ptr(), rows.data_ptr(), stream)
            out = (occ, rows)
        else:
            t = torch.full((n,), traverse.MISS_T, device=dev)
            hid = torch.full((n,), -1, dtype=torch.int64, device=dev)
            err = self.lib.handle.trt_threaded_closest_launch(
                *common, active.data_ptr(), t.data_ptr(), hid.data_ptr(),
                rows.data_ptr(), stream)
            out = (t, hid, rows)
        if err != 0:
            raise RuntimeError(f"{self.name}: launch failed, CUDA error {err}")
        return out


def states(params, tmp: str):
    """Yield (label, scene, walk table, state) for the six states."""
    rb = Renderer(chip_smoke.main_path_arrays(), cfg=RenderConfig(
        width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT, spp=1,
        engine="bounce"))
    args, _ = chip_smoke.features_scene_args(tmp)
    arrays = cli.build_scene_arrays(cli.build_parser().parse_args(
        ["render", *args]))
    rf = Renderer(arrays, cfg=RenderConfig(
        width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT, spp=1,
        engine="bounce", **chip_smoke.FEATURE_CFG))
    for fmt, r in (("bw", rb), ("mt", rf)):
        got = chip_smoke._bounce_states(r.scene, r.inline, r.bounce_tables,
                                        r.cfg, params)
        for label in ("fresh", "shadow", "late"):
            yield f"{fmt} {label}", r.scene, r.inline, got[label]
        del got


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_threaded: no CUDA device", file=sys.stderr)
        return 2
    source = threaded.LIBRARY.source
    builds = [Build("change", source)]
    for spec in args.variant:
        name, flags = spec.split("=", 1)
        builds.append(Build(name, source, flags.split()))
    if args.tree:
        parent = os.path.join(os.path.abspath(args.tree),
                              "tryraytrace_tpu_torch", "csrc",
                              "threaded_walk.cu")
        builds.insert(0, Build("parent", parent, table="node"))
    _build.build_all([b.lib for b in builds])
    for b in builds:
        b.load()
        extra = b.lib.flags[len(_build.NVCC_FLAGS):]
        print(f"[time_threaded] {b.name}: {extra} {b.numbers}", flush=True)
    if builds[0].old:
        on_copy = Build("parent on copy", builds[0].lib.source)
        on_copy.lib = builds[0].lib
        on_copy.load()
        builds.insert(1, on_copy)
    params = CameraController().get_params(chip_smoke.WIDTH,
                                           chip_smoke.HEIGHT)
    table = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, scene, walk, state in states(params, tmp):
            o, d, active, max_dist = state
            k, fmt = scene.leaf_size, scene.leaf_fmt
            if max_dist is None:
                want, longest = chip_smoke.longest_walk(
                    lambda: traverse.closest_hit_packed(walk, k, o, d,
                                                        active, fmt=fmt))
            else:
                want, longest = chip_smoke.longest_walk(
                    lambda: traverse.any_hit_packed(walk, k, o, d,
                                                    max_dist, active,
                                                    fmt=fmt))
            for b in builds:
                got = b.run(scene, walk, state)
                torch.cuda.synchronize()
                bad = [i for i, (x, y) in enumerate(zip(got, want))
                       if not torch.equal(x, y)]
                if bad:
                    raise AssertionError(f"{b.name} disagrees with the plain "
                                         f"version on {label}: outputs {bad}")
            times = {b.name: [] for b in builds}
            for b in builds + builds[::-1]:
                times[b.name].append(chip_smoke._kernel_ms(
                    lambda: b.run(scene, walk, state), KERNEL,
                    reps=args.reps))
            table[label] = dict({k: float(np.mean(v))
                                 for k, v in times.items()},
                                rows=int(want[-1]), longest_walk=longest,
                                active=int(active.sum()))
            print(f"[time_threaded] {label} ({int(active.sum())} active, "
                  f"{int(want[-1])} rows, longest walk {longest}): "
                  + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f} ms"
                              for k, v in times.items()), flush=True)
    summary = dict(device=torch.cuda.get_device_name(0),
                   builds={b.name: dict(flags=list(b.lib.flags),
                                        table=b.table, **b.numbers)
                           for b in builds},
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
