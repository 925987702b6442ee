"""Dependent row-fetch chain on a CUDA card: is a dependent table-row
fetch cheaper from shared memory than from L2?

    python3 scripts/microbench_torch_fetch.py [--seed 0] [--lanes N] [--cpu]

The PyTorch/CUDA counterpart of scripts/microbench_pallas_fetch.py, with
the same variant list (table height M, row width W, table dtype) plus
one variant whose chain depends on the data
(tryraytrace_tpu_torch/ops/fetch.py VARIANTS).  Every lane follows a
chain of ``steps`` row fetches, the next row computed from the fetched
one, like a BVH walk.  For each variant it prints the time per call and
the cost in ns per lane per step of the hand-written kernel with the
table read from device memory (L2-resident at these sizes), of the same
kernel with the table staged in shared memory (or that the table does
not fit), and of the plain PyTorch gather chain; then it checks that
both placements return the plain chain's outputs exactly.

``--lanes N`` runs every variant with N lanes instead of 65,536, and
then the latency variants: with one warp of lanes (``--lanes 32``) no
other warp hides a fetch, so a call's time over its 64 steps is the
latency of one dependent fetch step on the card, from device memory
after a warm-up (a 2 MB table of 16-byte rows: one load and four adds a
step, the table in L2) and from shared memory (a 16 KB table).

Needs a CUDA device and exits non-zero without one; ``--cpu`` runs only
the plain version, at 512 lanes and 4 steps, as a dry run of the script.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tryraytrace_tpu_torch.ops import fetch  # noqa: E402

CPU_LANES, CPU_STEPS = 512, 4
# (M, W, dtype, data-dependent) of the latency variants: 16-byte rows
# whose column 1 picks the next row, a table past any SM's L1 for device
# memory and one that shared memory holds.
LATENCY_VARIANTS = ((131072, 4, torch.float32, True),
                    (1024, 4, torch.float32, True))


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _own_ms(fn, reps: int) -> float:
    """The fetch-chain kernel's own device time per call of ``fn``
    (torch.profiler, chip_smoke._kernel_ms): a one-warp call is shorter
    than the host's time to make it, which CUDA events around a run of
    calls would measure instead."""
    from chip_smoke import _kernel_ms

    return _kernel_ms(fn, "fetch_chain_kernel", reps)


def variant_name(m, w, dtype, dependent) -> str:
    kind = "dependent" if dependent else "uniform"
    return f"M={m} W={w} {str(dtype).replace('torch.', '')} {kind}"


def run_benchmark(seed: int, reps: int = 20, lanes: int = fetch.LANES,
                  variants=fetch.VARIANTS, timer=_time_ms) -> list:
    """Time and check ``variants`` with ``lanes`` lanes on the current
    CUDA device (``timer(fn, reps)``: ms a call).  Returns one dict per
    variant: ``ms`` by placement (None where the table does not fit
    shared memory), ``plain_ms``, ``exact`` (both outputs of every
    placement equal the plain chain's) and ``table_bytes``."""
    rs = np.random.RandomState(seed)
    steps = fetch.STEPS
    results = []
    for m, w, dtype, dependent in variants:
        table, idx = fetch.make_inputs(rs, m, w, dtype, dependent, lanes)
        table, idx = table.cuda(), idx.cuda()
        want = fetch.fetch_chain_plain(table, idx, steps)
        res = dict(name=variant_name(m, w, dtype, dependent), m=m, w=w,
                   dtype=str(dtype), dependent=dependent, lanes=lanes,
                   steps=steps, ms={}, exact=True,
                   table_bytes=table.numel() * table.element_size(),
                   checksum=float(want[0].sum()))
        for placement in fetch.PLACEMENTS:
            if placement == "shared" and not fetch.fits_shared(table):
                res["ms"][placement] = None
                continue
            got = fetch.fetch_chain(table, idx, steps, placement)
            torch.cuda.synchronize()
            res["exact"] &= all(torch.equal(g, x) for g, x in zip(got, want))
            res["ms"][placement] = timer(
                lambda: fetch.fetch_chain(table, idx, steps, placement), reps)
        res["plain_ms"] = _time_ms(
            lambda: fetch.fetch_chain_plain(table, idx, steps), 3)
        results.append(res)
    return results


def latency_ns(seed: int, lanes: int = 32) -> dict:
    """One dependent fetch step's latency in ns by placement ("global":
    device memory after a warm-up, "shared"), from a warp of ``lanes``
    walking the latency variants: a call's time over its steps."""
    res = run_benchmark(seed, lanes=lanes, variants=LATENCY_VARIANTS,
                        timer=_own_ms)
    if not all(r["exact"] for r in res):
        raise AssertionError("a latency variant differs from the plain "
                             "chain")
    return dict(global_ns=res[0]["ms"]["global"] * 1e6 / res[0]["steps"],
                shared_ns=res[1]["ms"]["shared"] * 1e6 / res[1]["steps"],
                global_l1_table_ns=res[1]["ms"]["global"] * 1e6
                / res[1]["steps"], variants=res)


def _per(ms, res) -> str:
    if ms is None:
        return "does not fit shared memory"
    ns = ms * 1e6 / (res["lanes"] * res["steps"])
    return f"{ms:8.4f} ms/call {ns:7.4f} ns/lane/step"


def run_cpu(seed: int) -> None:
    rs = np.random.RandomState(seed)
    for m, w, dtype, dependent in fetch.VARIANTS:
        table, idx = fetch.make_inputs(rs, m, w, dtype, dependent, CPU_LANES)
        t0 = time.perf_counter()
        acc, rowsum = fetch.fetch_chain(table, idx, CPU_STEPS)
        dt = time.perf_counter() - t0
        print(f"  {variant_name(m, w, dtype, dependent):<34} plain chain on "
              f"the CPU, {CPU_LANES} lanes x {CPU_STEPS} steps: host "
              f"{dt * 1e3:.2f} ms (acc sum {float(acc.sum()):.3f}, rowsum "
              f"sum {float(rowsum.sum()):.3f})")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lanes", type=int, default=None,
                    help="lanes a call (default 65,536); also times the "
                         "latency variants")
    ap.add_argument("--cpu", action="store_true",
                    help="dry run: the plain version on the CPU, no timing "
                         "of the device")
    args = ap.parse_args()
    if args.cpu:
        run_cpu(args.seed)
        return 0
    if not torch.cuda.is_available():
        print("microbench_torch_fetch: no CUDA device (--cpu runs the "
              "plain version)", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    lanes = args.lanes or fetch.LANES
    print(f"{lanes} lanes x {fetch.STEPS} steps, seed {args.seed}"
          + ("; kernel times are its own device time (torch.profiler)"
             if args.lanes else ""))
    timer = _own_ms if args.lanes else _time_ms
    results = run_benchmark(args.seed, lanes=lanes, timer=timer)
    if args.lanes:
        results += run_benchmark(args.seed, lanes=lanes,
                                 variants=LATENCY_VARIANTS, timer=timer)
    for res in results:
        print(f"  {res['name']} ({res['table_bytes']} B)")
        print(f"    kernel, table in device memory: "
              f"{_per(res['ms']['global'], res)}")
        print(f"    kernel, table in shared memory: "
              f"{_per(res['ms']['shared'], res)}")
        print(f"    plain gather chain:             "
              f"{_per(res['plain_ms'], res)}")
        print(f"    kernel vs plain chain: "
              f"{'EXACT' if res['exact'] else 'DIFFERENT'} "
              f"(checksum {res['checksum']:.1f})")
        if args.lanes:
            per_step = {k: None if v is None
                        else f"{v * 1e6 / res['steps']:.1f}"
                        for k, v in res["ms"].items()}
            print(f"    ns a step of a lane's chain by placement: {per_step}")
    return 0 if all(res["exact"] for res in results) else 1


if __name__ == "__main__":
    sys.exit(main())
