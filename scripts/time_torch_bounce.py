"""The PyTorch port's bounce shade and NEE add (csrc/bounce.cu) alone on
the fresh, mid and late states of a bounce frame, on one card.

    python3 scripts/time_torch_bounce.py [--define NAME=MACRO[,MACRO...]]
        [--rounds 2] [--out FILE]
    python3 scripts/time_torch_bounce.py --parent DIR [--rounds 2]

Renders frame 1 of chip_smoke.py's main path (Cornell box +
icosphere(5), 20,487 triangles, 1200x800 at 1 spp) with
``engine="bounce"`` and records its fresh, mid and late states
(chip_smoke.py ``bounce_kernel_states``).  Then each build's shade and
NEE add on each state, held to the plain versions and timed
(chip_smoke.py ``check_bounce_shade`` and ``check_bounce_nee``: own
time under torch.profiler, wrapper time, the bounds), ``--rounds``
rounds, the builds in order and then in reverse: the port's build
("change") and, for each ``--define`` (for example
``s05=TRT_BOUNCE_DENSE_SHARE=0.5``), the same source built with those
macros defined, one nvcc each, side by side, handed to the wrappers as
``library=``.  The late state is also timed with its listed lanes
gathered into a dense state of their own (``gathered``), the change's
kernels over it with no list.  Prints one line a build and a JSON
summary (also written to ``--out``).

``--parent DIR`` times the kernels of DIR's tree and of this checkout in
turns (parent, this, this, parent), each in a process of its own that
imports the port and chip_smoke.py from its tree (``--tree``) and builds
that tree's ``csrc/bounce.cu`` as its port does: the shade and the NEE
add on the three states, ``--rounds`` times each; one JSON line a run
and a summary line of each state's fastest time.  Bounce steps are timed
by ``scripts/time_torch_step.py --engine bounce``, and their kernels'
device time by ``scripts/profile_torch_bounce.py``.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ("fresh", "mid", "late")


def _import(tree: str):
    """chip_smoke and the port from ``tree`` (checked), and torch."""
    sys.path.insert(0, tree)
    global torch, chip_smoke, CameraController, RenderConfig, Renderer
    global _build, bounce
    import torch

    import chip_smoke
    from tryraytrace_tpu_torch.camera.controller import CameraController
    from tryraytrace_tpu_torch.config import RenderConfig
    from tryraytrace_tpu_torch.engine.renderer import Renderer
    from tryraytrace_tpu_torch.ops import _build, bounce
    for mod in (chip_smoke, bounce):
        if not mod.__file__.startswith(tree):
            raise RuntimeError(f"imported {mod.__file__}, not from {tree}")


def _states():
    """A bounce Renderer of the main path, its camera's kernel params and
    the recorded states of its frame 1."""
    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
    r = Renderer(chip_smoke.main_path_arrays(),
                 cfg=RenderConfig(width=w, height=h, spp=1, engine="bounce"))
    states = chip_smoke.bounce_kernel_states(
        r, CameraController().get_params(w, h), w, h)
    return r, states["rays"]["params"], states


def _times(label: str, r, bp, st, **library) -> dict:
    """The shade's and the NEE add's numbers on one state."""
    shade = chip_smoke.check_bounce_shade(label, r, bp, st, **library)
    nee = chip_smoke.check_bounce_nee(label, st, **library)
    return dict(shade_ms=shade["ms"], nee_ms=nee["ms"],
                shade_wrapper_ms=shade["wrapper_ms"],
                nee_wrapper_ms=nee["wrapper_ms"],
                shade_bound_ms=shade["bound_ms"],
                nee_bound_ms=nee["bound_ms"],
                shade_list_bound_ms=shade.get("list_bound_ms"),
                nee_list_bound_ms=nee.get("list_bound_ms"))


def _tree(tree: str, rounds: int) -> int:
    """The kernels of ``tree`` (imported) on the three states, ``rounds``
    times; one JSON line."""
    r, bp, states = _states()
    out = {label: dict(shade_ms=[], nee_ms=[]) for label in LABELS}
    for _ in range(rounds):
        for label in LABELS:
            got = _times(label, r, bp, states[label])
            out[label]["shade_ms"].append(got["shade_ms"])
            out[label]["nee_ms"].append(got["nee_ms"])
    print(json.dumps(dict(tree=tree, device=torch.cuda.get_device_name(0),
                          states=out)))
    return 0


def _in_turns(parent: str, rounds: int) -> int:
    """``_tree`` of ``parent`` and of this checkout, parent, this, this,
    parent, a process each; one summary line."""
    runs = []
    for label, tree in (("parent", parent), ("change", HERE),
                        ("change", HERE), ("parent", parent)):
        line = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree,
             "--rounds", str(rounds)],
            capture_output=True, text=True, check=True,
            timeout=1200).stdout.strip().splitlines()[-1]
        print(line, flush=True)
        res = json.loads(line)
        runs.append(dict(label=label, states={
            k: {f: min(v[f]) for f in v} for k, v in res["states"].items()}))
    print(json.dumps(dict(device=res["device"], turns=runs)))
    return 0


def gathered(st) -> dict:
    """A recorded bounce state (chip_smoke.bounce_kernel_states) with its
    listed lanes gathered, in lane order, into tensors of their own: a
    dense state of those lanes alone, served with no list."""
    idx = st["lanes"][:st["n_lanes"]].long().sort().values
    take = lambda x: x[idx].contiguous()
    return dict(st, pixels=take(st["pixels"]), t=take(st["t"]),
                hit_id=take(st["hit_id"]),
                s={k: take(v) for k, v in st["s"].items()},
                nee=tuple(take(x) for x in st["nee"]), lanes=None,
                n_lanes=None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--define", action="append", default=[],
                    metavar="NAME=MACRO[,MACRO...]")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    ap.add_argument("--parent", metavar="DIR",
                    help="time DIR's kernels and this checkout's in turns")
    ap.add_argument("--tree", help="time this tree's kernels alone")
    args = ap.parse_args()
    if args.parent:
        return _in_turns(os.path.abspath(args.parent), args.rounds)
    tree = os.path.abspath(args.tree or HERE)
    _import(tree)
    if not torch.cuda.is_available():
        print("time_torch_bounce: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        return _tree(tree, args.rounds)
    builds = {"change": bounce.LIBRARY}
    for spec in args.define:
        name, macros = spec.split("=", 1)
        builds[name] = _build.KernelLibrary("bounce", bounce.FUNCTIONS,
                                            defines=macros.split(","))
    _build.build_all(builds.values())
    out = {name: dict(dense_share=bounce.dense_share(lib),
                      build=chip_smoke.ptxas_numbers(
                          lib.compiler_log, "bounce_shade_kernel"),
                      states={label: {} for label in LABELS})
           for name, lib in builds.items()}
    for name, lib in builds.items():
        print(f"[time_bounce] {name}: "
              f"{list(lib.flags[len(_build.NVCC_FLAGS):])} dense share "
              f"{out[name]['dense_share']}, shade build {out[name]['build']}",
              flush=True)
    r, bp, states = _states()
    order = list(builds)
    for k in range(args.rounds):
        for name in (order if k % 2 == 0 else order[::-1]):
            for label in LABELS:
                got = _times(f"{label} [{name}]", r, bp, states[label],
                             library=builds[name])
                res = out[name]["states"][label]
                for key, value in got.items():
                    res.setdefault(key, []).append(value)
    # The late state's lanes gathered into a dense state of their own
    # (the same lanes, inputs and arithmetic; no list): the change's
    # kernels on it, against their time on the wave's scattered lanes.
    late = gathered(states["late"])
    res = out["change"]["late_gathered"] = dict(lanes=len(late["hit_id"]))
    for _ in range(args.rounds):
        for key, value in _times("late gathered", r, bp, late).items():
            res.setdefault(key, []).append(value)
    for name in order:
        print(f"[time_bounce] {name}: own ms " + "; ".join(
            f"{label} shade {out[name]['states'][label]['shade_ms']} nee "
            f"{out[name]['states'][label]['nee_ms']}" for label in LABELS),
            flush=True)
    print(f"[time_bounce] change: late state gathered shade "
          f"{res['shade_ms']} nee {res['nee_ms']}", flush=True)
    summary = dict(device=torch.cuda.get_device_name(0), builds=out)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
