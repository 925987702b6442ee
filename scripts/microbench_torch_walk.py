"""Staged top rows and lane refill of the walk kernel, timed on a card.

    python3 scripts/microbench_torch_walk.py [--reps 10]

Builds chip_smoke.py's main-path scene (Cornell box + icosphere(5),
20,487 triangles, 1200x800 at 1 spp), takes two states of a frame's
rounds (the fresh 960,000-lane state, and the first round with at least
10,000 lanes in SHADOW) and times the walk kernel's own device time
(torch.profiler) as the port builds it and in benchmark builds of the
same source (csrc/quad_walk.cu): with at most 0 or 3 tree levels staged
in shared memory (TRT_WALK_MAX_LEVELS; the port stages as many as fit),
and with a warp refilling once 1, 8 or 32 of its threads are idle
(TRT_WALK_REFILL_IDLE; the port: 16; 32 = only when all are).  Every
build is timed twice, in a forward and a backward pass.  Then, as the
port builds it, every 8th, 4th, 2nd and every lane of the fresh state
(a sample of the whole image each time): a time that grows with the
lanes is throughput, the part that does not is fixed cost (launch,
staging, the longest walk).
Every variant's written fields and row count must equal
``walk_plain``'s.  Prints one line per run and a JSON line with all of
them.  Needs a CUDA device.
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
from tryraytrace_tpu_torch.engine import persistent  # noqa: E402
from tryraytrace_tpu_torch.engine.renderer import Renderer  # noqa: E402
from tryraytrace_tpu_torch.ops import _build, service, walk  # noqa: E402

# Benchmark builds beside the port's own (label, -D flags).
BUILDS = (("port", ()),
          ("max 0 levels", ("TRT_WALK_MAX_LEVELS=0",)),
          ("max 3 levels", ("TRT_WALK_MAX_LEVELS=3",)),
          ("refill 1", ("TRT_WALK_REFILL_IDLE=1",)),
          ("refill 8", ("TRT_WALK_REFILL_IDLE=8",)),
          ("refill 32", ("TRT_WALK_REFILL_IDLE=32",)))
LANE_SHARES = (8, 4, 2, 1)      # every share-th lane of the fresh state


def states(r: Renderer, params):
    """(label, state) of the fresh round and the first round with at
    least chip_smoke.SHADOW_LANES_MIN lanes in SHADOW."""
    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
    inline, cfg = r.inline, r.cfg
    cam = params.to(r.device)
    fr = persistent._Frame(r.scene, inline, cfg, cam, 1, w, h, 1, 1)
    s = persistent.init_lane_ctx(1, 1, torch.arange(w * h, device=r.device),
                                 cam, w, h, cfg,
                                 with_tstash=inline.tex0 is not None)
    yield "fresh", s
    passes = max(1, cfg.quad_redirect_passes)
    totals = torch.zeros(len(service.TOTALS), dtype=torch.int64,
                         device=r.device)
    for rnd in range(cfg.max_depth * 2 + 1):
        s = persistent._round_quad(s, inline, r.scene.leaf_size, fr, passes,
                                   totals, rnd % 2)[0]
        if int((s["mode"] == walk.SHADOW).sum()) >= \
                chip_smoke.SHADOW_LANES_MIN:
            yield "shadow", s
            return
    raise AssertionError("no round had enough lanes in SHADOW")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("microbench_torch_walk: no CUDA device", file=sys.stderr)
        return 2
    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
    r = Renderer(chip_smoke.main_path_arrays(),
                 cfg=RenderConfig(width=w, height=h, spp=1), device="cuda")
    params = CameraController().get_params(w, h)
    inline, k, fmt = r.inline, r.scene.leaf_size, r.scene.leaf_fmt
    passes = max(1, r.cfg.quad_redirect_passes)
    table, sentinel = inline.walk, inline.sentinel
    print(f"[walkbench] {torch.cuda.get_device_name(0)}; walk-order rows "
          f"{tuple(table.shape)}, rows per level {list(inline.walk_levels)}",
          flush=True)
    port = walk.LIBRARY
    libraries = {label: port if not flags else _build.KernelLibrary(
        "quad_walk", port.functions, defines=flags)
        for label, flags in BUILDS}
    _build.build_all(libraries.values())
    results = []

    def run(label, s, want, want_rows, build):
        walk.LIBRARY = libraries[build]
        try:
            launch = lambda: walk.quad_walk_cuda(  # noqa: E731
                s, table, sentinel, k, passes, inline.walk_levels, fmt=fmt)
            got, rows = launch()
            plan = walk.quad_walk_cuda.plan
            exact = (int(rows) == int(want_rows) and all(
                chip_smoke._same(got[f], want[f]) for f in walk.WRITES))
            ms = chip_smoke._kernel_ms(launch, "quad_walk_kernel",
                                       reps=args.reps)
        finally:
            walk.LIBRARY = port
        res = dict(state=label, lanes=s["mode"].shape[0], build=build,
                   ms=ms, rows=int(rows), exact=exact, **plan)
        results.append(res)
        print(f"[walkbench] {label}, {res['lanes']} lanes, {build}: "
              f"{plan['staged_rows']} rows staged ({plan['shared_bytes']} B),"
              f" grid {plan['grid']} ({plan['blocks_per_sm']}/SM): "
              f"{ms:.4f} ms, {int(rows) / ms / 1e6:.3f} G rows/s, "
              f"{'EXACT' if exact else 'DIFFERENT'}", flush=True)
        if not exact:
            raise AssertionError(f"variant {res} disagrees with walk_plain")

    order = [label for label, _ in BUILDS]
    for label, s in states(r, params):
        want, want_rows = walk.walk_plain(s, table, sentinel, k, passes,
                                          fmt=fmt)
        for build in order + order[::-1]:
            run(label, s, want, want_rows, build)
        if label != "fresh":
            continue
        for share in LANE_SHARES:
            part = {key: val[::share].contiguous() for key, val in s.items()}
            want, want_rows = walk.walk_plain(part, table, sentinel, k,
                                              passes, fmt=fmt)
            run(label, part, want, want_rows, "port")
    print(json.dumps({"walk_variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
