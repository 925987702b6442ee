"""The tonemap kernel's own time and its wrapper's, at the main path's
shape, for the port in one checkout.

    python3 scripts/time_torch_tonemap.py [--tree DIR] [--reps 50]

Imports ``tryraytrace_tpu_torch`` from ``DIR`` (default: this
checkout), so that two checkouts, for example a commit and its parent,
can be timed one after the other in one run on one card.  Holds the
kernel's bytes to the plain version's, then times
``tonemap_cuda(accum, 3)`` on a [960000, 3] float32 sum: the kernel's
own device time per launch (torch.profiler's durations of the kernels
named ``tonemap_kernel``) and the wrapper's time per call (CUDA events
around ``--reps`` calls).  Prints one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tryraytrace_tpu_torch.ops import tonemap as tm
    if not tm.__file__.startswith(tree):
        raise RuntimeError(f"imported {tm.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        print("time_torch_tonemap: no CUDA device", file=sys.stderr)
        return 2
    r = np.random.RandomState(1234)
    acc = torch.from_numpy((r.normal(0.5, 0.6, size=(960000, 3)) * 3)
                           .astype(np.float32)).cuda()
    launch = lambda: tm.tonemap_cuda(acc, 3)  # noqa: E731
    exact = bool(torch.equal(launch(), tm.tonemap_plain(acc, 3)))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    wrapper_ms = start.elapsed_time(end) / args.reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            launch()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "tonemap_kernel" in e.key]
    count = sum(e.count for e in found)  # the profiler may miss a few
    if not 0 < count <= args.reps:
        raise AssertionError(f"the profiler saw {count} tonemap launches in "
                             f"{args.reps} calls")
    ms = sum(e.device_time_total for e in found) / count / 1e3
    print(json.dumps({"tree": tree, "ms": ms, "wrapper_ms": wrapper_ms,
                      "exact": exact, "device": torch.cuda.get_device_name(0)}))
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
