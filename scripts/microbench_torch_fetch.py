"""Dependent row-fetch chain on a CUDA card: the fetch-chain kernel's own
time against its bound, with the table in device memory and staged in
shared memory.

    python3 scripts/microbench_torch_fetch.py [--seed 0] [--lanes N] [--cpu]
    python3 scripts/microbench_torch_fetch.py --tree DIR
        [--variant NAME=FLAGS ...] [--lanes N] [--reps 20] [--out FILE]

The PyTorch/CUDA counterpart of scripts/microbench_pallas_fetch.py, with
the same variant list (table height M, row width W, table dtype) plus
one variant whose chain depends on the data
(tryraytrace_tpu_torch/ops/fetch.py VARIANTS).  Every lane follows a
chain of ``steps`` row fetches, the next row computed from the fetched
one, like a BVH walk, and reads every column of every row it fetches.
For each variant it prints the kernel's own device time a call
(torch.profiler) and the wrapper's (CUDA events) with the table read
from device memory ("global") and with its leading rows staged in
shared memory ("shared", ``fetch.staged_rows``), the plain PyTorch
gather chain's time, and the bound: the larger of the bytes the lanes'
rows move through the SMs' load path (lanes x steps x row bytes over
SM count x 128 B x the maximum SM clock) and the chain's 64 dependent
steps; then it checks that both placements return the plain chain's
outputs exactly.

``--lanes N`` runs every variant with N lanes instead of 65,536 (a
sweep over N tells a latency-bound kernel, whose time stays flat, from
a throughput-bound one, whose time grows with N), and then the latency
variants: with one warp of lanes (``--lanes 32``) no other warp hides a
fetch, so a call's time over its 64 steps is the latency of one
dependent fetch step on the card, from device memory after a warm-up (a
2 MB table of 16-byte rows: one load a step, the table in L2) and from
shared memory (a 16 KB table).

``--tree DIR`` builds the fetch-chain kernel of the checkout DIR
("parent") beside this checkout's ("change"), and ``--variant
NAME=FLAGS`` the same source with extra nvcc flags (``-D`` switches);
each build's instances' registers, spills and 128-bit loads in their
machine code are printed (``[build]``).  On both placements of the six
variants (``--lanes`` lanes) and of the two latency variants (32 lanes)
every build is first held to the plain chain (both outputs equal), then
timed by its own device time in turns: the builds in order, then in
reverse, so a drift of the card's clock falls on both ends alike.  A
parent from before staged rows (entry point ``trt_fetch_chain_launch``)
stages a whole padded table or none, so its "shared" cell is empty
where the table does not fit.  Prints one line a case and a JSON summary (also written to
``--out``).

Needs a CUDA device and exits non-zero without one; ``--cpu`` runs only
the plain version, at 512 lanes and 4 steps, as a dry run of the script.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tryraytrace_tpu_torch.ops import _build, fetch  # noqa: E402

CPU_LANES, CPU_STEPS = 512, 4
KERNEL = "fetch_chain_kernel"
# Bytes an SM's load path moves a clock (shared memory / L1).
SM_LOAD_BYTES_PER_CLOCK = 128
# The C interface of a kernel from before staged rows: table, idx, acc,
# rowsum, n, m, w, itemsize, steps, shared, stream.
_OLD = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p)
_OLD_PAD_BYTES = 16


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

    return _kernel_ms(fn, KERNEL, reps)


def variant_name(m, w, dtype, dependent) -> str:
    kind = "dependent" if dependent else "uniform"
    return f"M={m} W={w} {str(dtype).replace('torch.', '')} {kind}"


def card_rates() -> dict:
    """The current card's SM count (torch) and maximum SM clock in MHz
    (nvidia-smi)."""
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return dict(sms=torch.cuda.get_device_properties(0).multi_processor_count,
                sm_clock_mhz=float(clock))


def byte_bound_ms(lanes: int, steps: int, row_bytes: int,
                  rates: dict) -> float:
    """The least time for every lane's ``steps`` rows of ``row_bytes`` to
    cross the SMs' load path at 128 B a clock an SM."""
    per_s = (rates["sms"] * SM_LOAD_BYTES_PER_CLOCK
             * rates["sm_clock_mhz"] * 1e6)
    return 1e3 * lanes * steps * row_bytes / per_s


class Build:
    """One build of a fetch-chain source, launched through the C
    interface its library has: this kernel's (through
    ``fetch.fetch_chain_cuda``) or the older whole-table one (``old``)."""

    def __init__(self, name: str, source: str, flags=()):
        self.name = name
        self.lib = _build.KernelLibrary("fetch_chain", {})
        self.lib.source = source
        self.lib.flags = (*self.lib.flags, *flags)
        self.old = False
        self.numbers = {}

    def load(self):
        from chip_smoke import fetch_builds

        handle = self.lib.load()
        self.old = not hasattr(handle, "trt_fetch_chain_launch_staged")
        self.lib.functions = ({"trt_fetch_chain_launch": _OLD} if self.old
                              else fetch.LIBRARY.functions)
        for fname, argtypes in self.lib.functions.items():
            fn = getattr(handle, fname)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
        self.numbers = fetch_builds(self.lib)

    def run(self, table, idx, steps, placement):
        """(acc, rowsum) of one call, or None where this build does not
        take the table in this placement."""
        if not self.old:
            saved = fetch.LIBRARY
            fetch.LIBRARY = self.lib
            try:
                return fetch.fetch_chain_cuda(table, idx, steps, placement)
            finally:
                fetch.LIBRARY = saved
        m, w = table.shape
        row = w * table.element_size()
        shared = placement == "shared"
        if shared and m * (row + _OLD_PAD_BYTES) > fetch.SHARED_LIMIT_BYTES:
            return None
        n = idx.shape[0]
        acc = torch.empty((n, 1), dtype=torch.float32, device=table.device)
        rowsum = torch.empty_like(acc)
        err = self.lib.handle.trt_fetch_chain_launch(
            table.data_ptr(), idx.data_ptr(), acc.data_ptr(),
            rowsum.data_ptr(), n, m, w, table.element_size(), int(steps),
            int(shared), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: launch failed, CUDA error {err}")
        return acc, rowsum


def run_benchmark(seed: int, reps: int = 20, lanes: int = fetch.LANES,
                  variants=fetch.VARIANTS) -> list:
    """Check and time ``variants`` with ``lanes`` lanes on the current
    CUDA device.  Returns one dict per variant: by placement the kernel's
    own time ``ms`` (torch.profiler) and the wrapper's ``wrapper_ms``
    (CUDA events), ms a call; ``plain_ms``; ``exact`` (both outputs of
    every placement equal the plain chain's); ``staged_rows`` and the
    table's and a row's bytes."""
    rs = np.random.RandomState(seed)
    steps = fetch.STEPS
    results = []
    for m, w, dtype, dependent in variants:
        table, idx = fetch.make_inputs(rs, m, w, dtype, dependent, lanes)
        table, idx = table.cuda(), idx.cuda()
        want = fetch.fetch_chain_plain(table, idx, steps)
        res = dict(name=variant_name(m, w, dtype, dependent), m=m, w=w,
                   dtype=str(dtype), dependent=dependent, lanes=lanes,
                   steps=steps, ms={}, wrapper_ms={}, exact=True,
                   table_bytes=table.numel() * table.element_size(),
                   row_bytes=w * table.element_size(),
                   staged_rows=fetch.staged_rows(table),
                   checksum=float(want[0].sum()))
        for placement in fetch.PLACEMENTS:
            call = lambda: fetch.fetch_chain(table, idx, steps, placement)
            got = call()
            torch.cuda.synchronize()
            res["exact"] &= all(torch.equal(g, x) for g, x in zip(got, want))
            res["ms"][placement] = _own_ms(call, reps)
            res["wrapper_ms"][placement] = _time_ms(call, reps)
        res["plain_ms"] = _time_ms(
            lambda: fetch.fetch_chain_plain(table, idx, steps), 3)
        results.append(res)
    return results


def latency_ns(seed: int) -> dict:
    """One dependent fetch step's latency in ns by placement ("global":
    device memory after a warm-up, "shared"), from a warp of lanes
    walking the latency variants: a call's own time over its steps."""
    res = run_benchmark(seed, lanes=fetch.LATENCY_LANES,
                        variants=fetch.LATENCY_VARIANTS)
    if not all(r["exact"] for r in res):
        raise AssertionError("a latency variant differs from the plain "
                             "chain")
    return dict(global_ns=res[0]["ms"]["global"] * 1e6 / res[0]["steps"],
                shared_ns=res[1]["ms"]["shared"] * 1e6 / res[1]["steps"],
                global_l1_table_ns=res[1]["ms"]["global"] * 1e6
                / res[1]["steps"], variants=res)


def _per(ms, res) -> str:
    ns = ms * 1e6 / (res["lanes"] * res["steps"])
    return f"{ms:8.4f} ms/call {ns:7.4f} ns/lane/step"


def compare(args, rates: dict) -> int:
    """The ``--tree`` / ``--variant`` run: every build on every case, held
    to the plain chain, then timed in turns."""
    source = fetch.LIBRARY.source
    builds = [Build("change", source)]
    for spec in args.variant:
        name, flags = spec.split("=", 1)
        builds.append(Build(name, source, flags.split()))
    if args.tree:
        parent = os.path.join(os.path.abspath(args.tree),
                              "tryraytrace_tpu_torch", "csrc",
                              "fetch_chain.cu")
        builds.insert(0, Build("parent", parent))
    _build.build_all([b.lib for b in builds])
    for b in builds:
        b.load()
        extra = b.lib.flags[len(_build.NVCC_FLAGS):]
        print(f"[build] {b.name} {list(extra)}: {b.numbers}", flush=True)
    cases = [(v, args.lanes or fetch.LANES) for v in fetch.VARIANTS]
    cases += [(v, fetch.LATENCY_LANES) for v in fetch.LATENCY_VARIANTS]
    rs = np.random.RandomState(args.seed)
    steps = fetch.STEPS
    rows = []
    for (m, w, dtype, dependent), lanes in cases:
        table, idx = fetch.make_inputs(rs, m, w, dtype, dependent, lanes)
        table, idx = table.cuda(), idx.cuda()
        want = fetch.fetch_chain_plain(table, idx, steps)
        bound = byte_bound_ms(lanes, steps, w * table.element_size(), rates)
        for placement in fetch.PLACEMENTS:
            taken = []
            for b in builds:
                got = b.run(table, idx, steps, placement)
                torch.cuda.synchronize()
                if got is None:
                    continue
                if not all(torch.equal(g, x) for g, x in zip(got, want)):
                    raise AssertionError(
                        f"{b.name} disagrees with the plain chain on "
                        f"{variant_name(m, w, dtype, dependent)} "
                        f"{placement}, {lanes} lanes")
                taken.append(b)
            times = {b.name: [] for b in taken}
            for b in taken + taken[::-1]:
                times[b.name].append(_own_ms(
                    lambda: b.run(table, idx, steps, placement), args.reps))
            row = dict(name=variant_name(m, w, dtype, dependent),
                       placement=placement, lanes=lanes,
                       staged_rows=(fetch.staged_rows(table)
                                    if placement == "shared" else 0),
                       byte_bound_ms=bound,
                       own_ms={k: float(np.mean(v)) for k, v in times.items()},
                       turns=times)
            rows.append(row)
            print(f"[compare] {row['name']} {placement}, {lanes} lanes, "
                  f"{row['staged_rows']} rows staged, byte bound "
                  f"{bound:.5f} ms: "
                  + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f} ms "
                              f"({np.mean(v) / bound:.2f}x; "
                              f"{np.mean(v) * 1e6 / steps:.1f} ns a step)"
                              for k, v in times.items()), flush=True)
    summary = dict(device=torch.cuda.get_device_name(0), rates=rates,
                   builds={b.name: dict(flags=list(b.lib.flags),
                                        instances=b.numbers)
                           for b in builds},
                   cases=rows)
    line = json.dumps(summary)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


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
              f"sum {float(rowsum.sum()):.3f}; {fetch.staged_rows(table)} "
              f"of {m} rows would be staged)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lanes", type=int, default=None,
                    help="lanes a call (default 65,536); also times the "
                         "latency variants")
    ap.add_argument("--tree", help="also build and time the fetch-chain "
                                   "kernel of this checkout")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: also this source with nvcc FLAGS")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
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
    rates = card_rates()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"{rates['sms']} SMs, max SM clock {rates['sm_clock_mhz']} MHz")
    if args.tree or args.variant:
        return compare(args, rates)
    lanes = args.lanes or fetch.LANES
    print(f"{lanes} lanes x {fetch.STEPS} steps, seed {args.seed}; own "
          f"time: torch.profiler, wrapper: CUDA events")
    results = run_benchmark(args.seed, reps=args.reps, lanes=lanes)
    if args.lanes:
        results += run_benchmark(args.seed, reps=args.reps,
                                 lanes=fetch.LATENCY_LANES,
                                 variants=fetch.LATENCY_VARIANTS)
    for res in results:
        bound = byte_bound_ms(res["lanes"], res["steps"], res["row_bytes"],
                              rates)
        print(f"  {res['name']} ({res['table_bytes']} B, {res['lanes']} "
              f"lanes; byte bound {bound:.5f} ms)")
        for placement in fetch.PLACEMENTS:
            ms = res["ms"][placement]
            staged = (f"{res['staged_rows']} rows staged"
                      if placement == "shared" else "no rows staged")
            print(f"    kernel, {placement:<6} ({staged}): own {_per(ms, res)}"
                  f" ({ms / bound:.2f}x the byte bound, "
                  f"{ms * 1e6 / res['steps']:.1f} ns a step), wrapper "
                  f"{res['wrapper_ms'][placement]:.4f} ms")
        print(f"    plain gather chain:             "
              f"{_per(res['plain_ms'], res)}")
        print(f"    kernel vs plain chain: "
              f"{'EXACT' if res['exact'] else 'DIFFERENT'} "
              f"(checksum {res['checksum']:.1f})")
    return 0 if all(res["exact"] for res in results) else 1


if __name__ == "__main__":
    sys.exit(main())
