"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels (tonemap, fetch_chain,
quad_walk, threaded_walk, service_pass, wave_advance, lane_init and
bounce's three; one nvcc a source, side by side) from the sources
in this checkout and holds each against its plain PyTorch version on
the card at the shapes its path gives it.  It drives the port's paths,
each with the kernels' launch counts set to 0 just before and read just
after, and with the ``Wave.advance`` calls that have work counted beside
them (on a card each is one wave-kernel launch):

  - the main path (Renderer -> render_frame_persistent -> Renderer.image)
    at the reference's interactive operating point, 1200x800 at 1 spp
    per step, on a 20,487-triangle Cornell box built in the repo: one
    lane set-up launch (the wave's fresh state) and one wave-kernel
    launch per step (every lane's walks and services to its end), no
    launch of the walk or the service kernel, and, in one more step, no
    synchronizing call from the step's start to the wave kernel's read
    of its counters (torch.cuda.set_sync_debug_mode("error")).  It runs
    first, before any kernel is timed under torch.profiler;
  - the progressive path (ProgressiveRenderer.step / snapshot) on the
    same scene and raster, also before any profiler session: a capped
    wave held bit for bit to a batch step, the same wave split across
    calls, and an unbounded wave timed frame by frame; then
    Renderer.step_tiled held to Renderer.step, and a .npz checkpoint
    round trip held to the step it replaces;
  - the entry points a user runs, also before any profiler session:
    ``[cli]`` drives ``tpurt-torch render`` (cli.main, in this process)
    at 1200x800 on the Cornell box with the icosphere written out as an
    .obj and loaded through ``--obj``, held byte for byte to a Renderer
    stepped by hand, a resume and a tiled run held to the plain run;
    ``[app]`` runs the batch App (a camera move, a save, periodic
    checkpoints) against a Renderer driven by hand, and the
    ProgressiveApp for 16 ticks with a camera move, timing each tick's
    render, snapshot and host ARGB packing; ``[bench]`` runs
    benchmarks.py: cube256 at 256x256 against the NumPy oracle, the
    interactive config, and the progressive interactive config;
  - the features past the default path, also before any profiler
    session: ``[features]`` drives ``tpurt-torch render --smooth --uv
    --leaf-isect mt --bvh-method sbvh`` at 1200x800 on the Cornell box
    with the icosphere and per-vertex UVs from an .obj, held byte for
    byte to a Renderer stepped by hand; an SBVH build of the main path's
    scene, bit-identical to its SAH render; ``Renderer.refit`` after a
    seed-made displacement of the icosphere, against a fresh build; and
    each feature alone (smooth shading, UV mapping, "mt" leaves, SBVH,
    17 lights, a texture past 2 MB of tile rows) at 64x48, the card
    against the CPU bit for bit and against the port's NumPy oracle;
  - the bounce engine, also before any profiler session: ``[bounce]``
    steps ``Renderer(engine="bounce")`` on the main path's scene at
    1200x800 (a sample's camera rays one bounce_rays launch; a bounce
    its closest-hit and NEE walks in the threaded-walk kernel, one
    bounce_shade and one bounce_nee launch; each counted), holds frame 1
    to the persistent engine's (equal ray counts,
    sums within the JAX engine test's _ULP except at pixels whose two
    walks hit different triangles at the same t, traced walk by walk),
    the card's bounce render to the CPU's at 64x48 bit for bit, and
    ``render --engine bounce`` to a hand-driven Renderer;
  - the parallel layer, also before any profiler session:
    ``[parallel]`` holds ShardedRenderer meshes of (1,1), (2,1) and (4,1)
    shards of the one card to the Renderer bit for bit and (2,2) within
    atol 1e-4 with equal ray totals, for both engines, and two processes
    of ``render --coordinator ...`` over gloo on the card to one
    process, byte for byte (NCCL across cards needs more than one card
    and is not run);
  - the row-fetch microbenchmark (scripts/microbench_torch_fetch.py):
    65,536 lanes, 64 steps, six table variants, both placements (device
    memory; the leading rows that fit staged in shared memory); then
    one warp of lanes on tables of 16-byte rows, whose device time over
    its 64 steps is one dependent fetch step's latency (L2, shared
    memory).

The walk kernel is held to its plain version on three states of a
path's rounds (fresh, many shadow walks, mostly done): the main path's
tree with its Baldwin-Weber leaf slots, and the [features] path's SBVH
with its Moller-Trumbore ("mt") slots at the auto leaf size; the
threaded-walk kernel is held to its plain version on three states of a
full-width bounce frame (camera rays, the first bounce's shadow rays,
a late bounce) over the walk-order copies of both trees, with each
state's longest walk (the plain loop's count) and its latency bound.
``[wave]`` holds the wave kernel to
the two-kernel round loop on the card (quad_walk_cuda, then
service_pass_cuda, a round, no compaction), every state field, the
four totals, the rows and the rounds bit for bit, on the main path's
1200x800 1-spp step (and to its plain version, ops/wave.py
wave_advance_plain, field for field), on that step in calls that end
in its grid-wide rounds, at the switch to the kernel's sparse tail and
inside it (equal to one call), on a progressive wave advanced in
calls of 1, 3 and 8 rounds (equal to one call of 12), on a tiled
wave's strip, on the [features] path's renderer ("mt" leaves, SBVH,
smooth normals, UVs, textures) and on a 1200x800 frame with "mt" leaves,
smooth normals, UVs, textures, 17 lights and two trimat rows a table
row; it times the kernel on the main step and gives its bounds (the
byte bound, the round loop's, and the rounds' latency floor: each
round's longest walk times [fetch]'s one-warp dependent step).
``[bounce_kernels]`` holds the bounce engine's three kernels to their
plain versions (ops/bounce.py bounce_shade_plain, bounce_nee_plain,
bounce_rays_plain) on the card, on copies, on the fresh, mid (bounce
4) and late (at most 10% of the lanes alive) states of a 1200x800
bounce frame of the main path's scene, by ops/bounce.py's contract
(shade_contract: floats bit for bit, NaN at the same places; the
counts exactly), and gives each one's own time, wrapper time, plain
time and bound (bytes, and FP64 work by the branches the lanes take).
``[lane_init]`` holds the lane set-up kernel to its plain version
(persistent.init_lane_ctx) on the card, every field bit for bit on a
state poisoned first (NaN payloads, 0x5A bytes), each field a view into
one buffer of guard bytes that must not change, with the wave's totals
and rows, in nine cases at 1200x800 (the main path's 960,000 lanes, a
tiled strip, a sample-parallel shard, a thin lens, an untextured scene
with no skip registers, the [features] renderer, a pixel tensor read as
given, the last 257 pixels, 240,000 lanes from an odd pixel), and the
main case also to init_lane_ctx run on the CPU; it gives the kernel's
own time, its wrapper's, the plain version's, its byte bound and its
launch plan (grid, shared bytes) (it runs after every
phase that times steps, and its own time is the first profiler
session).  ``[service]`` holds the service kernel to its plain version
(persistent.service_plain, the eager service block) on each of the walk
kernel's six states just after its walk
(the main path's: textured, TEXG lanes in flight; the [features]
path's: smooth shading and UV mapping on), on rounds SERVICE_ROUNDS
of two more full-width frames (17 lights, and the main path's scene at
leaf 6, two trimat rows a table row) and on a seed-made 960,000-lane
state whose every warp mixes SHADEG, TEXG, REFILL, DONE, TRAVERSE and
SHADOW lanes and takes every branch (mixed_state); field for field and
the wave's four totals exactly.  It also checks the port's render on the card
(the wave kernel) against the plain version of the whole on the CPU
(the interleaved eager loop, one row per lane per step), bit for bit
at 64x64 and 64x48.  Every phase prints its own lines; any failure
raises and the script exits non-zero.  The last line is a JSON object
{"ok": true, "device": {...}}, the line before it the card's name and
power limit, and the line before that the kernel table of ten
kernels (the wave, lane set-up, walk and service kernels' entries count
their launches on
each path: ``launches`` on the main path, ``progressive_launches``,
``tiled_launches``, ``cli_launches``, ``app_launches``,
``bench_launches`` and ``features_launches``, ``bounce_launches`` and
``parallel_launches``, each with the count set to 0 just before the path
and read just after; the wave kernel launches once a step on every
persistent path, the lane set-up kernel once a wave (a step, a strip, a
shard, a progressive wave), and the walk and service kernels on none,
only in
``[walk]``, ``[service]`` and ``[wave]``'s checks; the wave kernel's
``features_mt_launches`` are its launches over "mt" leaves in
``[features]``, its ``cases`` the ``[wave]`` cases' numbers, and its
bound entries those of ``wave_bound``; the walk kernel's ``mt`` entry
holds the "mt" walk's own numbers; the other kernels' entries carry the
entry points', ``[features]``', ``[bounce]``'s and ``[parallel]``'s
counts the same way, where ``parallel_launches`` sums the sharded steps
of every mesh, each counted from 0 around its ``step`` and ``image``
alone, and ``parallel_mesh_launches`` gives each mesh's count; the
threaded walk's ``launches`` are the bounce path's, and its ``states``
and ``mt`` entries hold each state's numbers; so are the three bounce
kernels' (``main_launches`` is 0, the main path's), whose ``states``
hold each ``[bounce_kernels]`` state's numbers; the service kernel's
``states`` entry holds each ``[service]`` state's numbers).  Without a
CUDA device it
exits non-zero and prints no result.

A kernel's ``ms`` is its own device time per launch (torch.profiler's
durations of the kernel itself; a profiler that records no CUDA
operation at all in a process fails the timing, and the whole script
runs once more in a fresh process, where it must record),
``wrapper_ms`` the time per call of
its Python wrapper with everything the wrapper does around the launch
(CUDA events around a run of calls).  ``bound_ms`` is the least time
the card could take: the larger of the bytes its outputs depend on
plus the bytes it writes (each counted once) over the device-memory
rate and the float32 operations those outputs need over the float32
rate, both NVIDIA's published figures for the H100 SXM.  The threaded
walk's entry also gives ``latency_bound_ms``: the chain of dependent
fetches no design of it avoids (the state's longest walk in rows times
one dependent fetch step's latency from the one-warp run); the larger
of the two is its bound (PERF.md).  The fetch chain's ``bound_ms`` is
the larger of ``byte_bound_ms``, every column of every fetched row
through the SMs' load path (lanes x steps x row bytes over the SM count
x 128 B x the maximum SM clock, ``sms`` and ``sm_clock_mhz``), and
``latency_bound_ms``, its 64 steps times that one-warp step; its
``dram_bound_ms`` is the table and the lanes' bytes once over the
device-memory rate, and ``staged_rows`` the rows its "shared" placement
stages.  The service
kernel's operations are its double-precision calls on the branches its
lanes take (service_work), at the FP64 instructions a call of each kind
takes in the machine code nvcc builds (fp64_per_call), over the FP64
rate; its entry also gives both times apart (``bytes_ms``,
``fp64_ms``) and its build's registers, stack and spills.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import importlib.util
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tryraytrace_tpu_torch import benchmarks, cli
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.display import pipeline as display_pipeline
from tryraytrace_tpu_torch.display.app import App, ProgressiveApp
from tryraytrace_tpu_torch.display.input import ScriptedInput
from tryraytrace_tpu_torch.engine import persistent, wavefront
from tryraytrace_tpu_torch.engine.progressive import (UNBOUNDED_SPP,
                                                      ProgressiveRenderer)
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.engine.state import load_checkpoint, save_checkpoint
from tryraytrace_tpu_torch.io.ppm import load_ppm
from tryraytrace_tpu_torch.io.snapshot import tonemap_accum
from tryraytrace_tpu_torch.core import rng, vec
from tryraytrace_tpu_torch.ops import (_build, bounce, fetch, threaded,
                                       traverse)
from tryraytrace_tpu_torch.ops import tonemap as tm
from tryraytrace_tpu_torch.ops import lane_init, service, shade, walk, wave
from tryraytrace_tpu_torch.ops.texture import TEX_ROW
from tryraytrace_tpu_torch.oracle import oracle_render
from tryraytrace_tpu_torch.parallel.mesh import make_mesh
from tryraytrace_tpu_torch.parallel.shard import ShardedRenderer
from tryraytrace_tpu_torch.scene.assets import (checker_texture, cube_mesh,
                                                icosphere_mesh)
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import Object, flatten_scene
from tryraytrace_tpu_torch.scene.objloader import load_obj

WIDTH, HEIGHT = 1200, 800      # reference main.cpp:49-50
TIMED_STEPS = 4
TONEMAP_SHAPE = (WIDTH * HEIGHT, 3)
# Kernel vs plain version: bytes may differ only by 1, only where
# p * 255 + 0.5 sits within a float32 ulp of an integer (a powf
# rounding boundary), and in at most this share of the bytes.
MAX_BOUNDARY_SHARE = 1e-5
# The main path is deterministic: warm-up + TIMED_STEPS steps of this
# scene at this raster tonemap to this mean on every run.
MAIN_IMAGE_MEAN = 79.99852708333333
# ... and each timed step traces these (path rays, shadow rays, rows
# fetched, rounds): the walk's table layout, launch shape and lane order
# may change, the rows a step reads may not.
MAIN_STEP_COUNTS = ((6993820, 4624618, 41695872, 39),
                    (6990289, 4622327, 41665360, 40),
                    (6987560, 4620238, 41678080, 40),
                    (6996627, 4627204, 41692751, 39))
SHADOW_LANES_MIN = 10000       # [walk]'s second state: this many in SHADOW
# [progressive]: the capped runs render samples 0..CAP-1 of frame F (the
# batch step's seeds at spp CAP); the unbounded run advances its wave
# this many rounds per display frame, for the frames before and after
# its reset.
PROGRESSIVE_CAP = 2
PROGRESSIVE_FRAME_SEED = 7
PROGRESSIVE_ROUNDS = 8
PROGRESSIVE_FRAMES = (6, 2)
TILES = 4                      # [tiled]: step_tiled against step
LATE_DONE_SHARE = 0.9          # [walk]'s third state: this share DONE
SERVICE_ROUNDS = (0, 4)        # [service]: the rounds of its other states
MIXED_SPP, MIXED_SEED = 2, 11  # [service]: the seed-made mixed state
CLI_FRAMES = 4                 # [cli]: frames of the plain render
# [app]: the batch App's script (a camera move on tick 3, a save on tick
# 5) and checkpoint period; the ProgressiveApp's ticks, with a camera
# move on tick PROGRESSIVE_MOVE.
APP_SCRIPT = [{}, {}, {"keys": ["w"]}, {}, {"save": True}, {}]
APP_CHECKPOINT_EVERY = 3
PROGRESSIVE_TICKS = 16
PROGRESSIVE_MOVE = 8
ORACLE_MSE = 1e-9              # [bench]: cube256 against the NumPy oracle
# [features]: the four features together through ``tpurt-torch render``;
# a refit after moving the icosphere's vertices by a seed-made normal
# displacement; each feature alone at a small raster (card against CPU,
# and the oracle) on an icosphere of this subdivision.
FEATURE_CFG = dict(smooth_shading=True, uv_mapping=True, leaf_isect="mt",
                   bvh_method="sbvh")
FEATURE_FRAMES = 2
REFIT_SEED, REFIT_SIGMA = 8, 0.3
SMALL_W, SMALL_H = 64, 48
SMALL_SUBDIV = 1
SMALL_FEATURES = {
    "smooth": dict(smooth_shading=True),
    "uv": dict(uv_mapping=True),
    "mt": dict(leaf_isect="mt"),
    "sbvh": dict(bvh_method="sbvh"),
    "lights": {},
    "big_texture": dict(uv_mapping=True),
}

# [bounce]: timed steps of the bounce engine; the JAX engine test's
# tolerance between its two engines (tests/test_persistent_engine.py
# _ULP); the frames of ``render --engine bounce``; the third kernel state
# is the first closest-hit walk with at most this share of lanes alive.
BOUNCE_STEPS = 3
ULP = dict(rtol=2e-6, atol=1e-6)
BOUNCE_CLI_FRAMES = 2
LATE_ACTIVE_SHARE = 0.1
MID_DEPTH = 4                  # [bounce_kernels]: the mid state's bounce
BOUNCE_KERNELS = ("bounce_rays", "bounce_shade", "bounce_nee")
# [bounce_kernels]: the shuffled lists' seed, and the -D builds of
# csrc/bounce.cu checked and timed beside the port's (PERF.md): every
# bounce after 0 launched over its list, and none (PR 18's launch shape).
BOUNCE_SHUFFLE_SEED = 19
BOUNCE_VARIANTS = {
    "list_every_bounce": ("TRT_BOUNCE_DENSE_SHARE=1",),
    "no_list": ("TRT_BOUNCE_DENSE_SHARE=0",),
}
# [parallel]: samples a step (divisible by every mesh's sp), the meshes
# (dp, sp) on the one card, the bound for sp > 1 (tests/test_parallel.py),
# and how long the two processes may take.
PARALLEL_SPP = 2
PARALLEL_MESHES = ((1, 1), (2, 1), (4, 1), (2, 2))
ATOL_SP = 1e-4
TWO_PROCESS_TIMEOUT_S = 300

# Profiler sessions _kernel_ms runs before it gives up on a kernel whose
# launches the profiler recorded none of; the argument of the one run
# again in a fresh process after a profiler that recorded nothing.
PROFILE_TRIES = 3
PROFILER_RETRY = "--profiler-retry"

# NVIDIA's published H100 SXM figures: device-memory rate, and float32
# and float64 rates outside the tensor cores.
MEM_BYTES_PER_S = 3.35e12
LANE_POISON = 0x7FC05A5A       # [lane_init]: a NaN with a payload
LANE_GUARD = 0xA5              # [lane_init]: bytes around a guarded state
LANE_FIELD_ALIGN = 512         # where a guarded state's fields start
LANE_GUARD_BYTES = 64          # guard bytes at least after each field
LANE_ODD_FIRST = 240_001       # [lane_init]: a range from an odd pixel
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bounce_variant_libraries() -> dict:
    """The BOUNCE_VARIANTS builds of csrc/bounce.cu (not built yet)."""
    return {name: _build.KernelLibrary("bounce", bounce.FUNCTIONS,
                                       defines=defines)
            for name, defines in BOUNCE_VARIANTS.items()}


def cornell_with(v0, v1, v2, offset, **material):
    scene = create_cornell_box(mesh=None)
    off = np.asarray(offset, np.float32)
    for a, b, c in zip(v0 + off, v1 + off, v2 + off):
        scene.objects.append(Object(v0=tuple(a), v1=tuple(b), v2=tuple(c),
                                    **material))
    return scene


def cube256_arrays():
    """benchmarks.py cube256: Cornell box + a 15x cube at (50, 20, 50),
    checker 64 (the cube mesh stands in for cube.obj)."""
    scene = cornell_with(*cube_mesh(15.0), (50.0, 20.0, 50.0),
                         albedo=(0.75, 0.75, 0.75), roughness=1.0)
    return flatten_scene(scene, textures=[checker_texture(64)])


def main_path_arrays():
    """Cornell box + icosphere(5) scaled 15 at (50, 20, 50), metallic
    1.0, roughness 0.1 (the reference's mesh material), checker 256:
    7 + 20,480 triangles, all generated here."""
    scene = cornell_with(*icosphere_mesh(5, 15.0), (50.0, 20.0, 50.0),
                         albedo=(0.75, 0.75, 0.75), metallic=1.0,
                         roughness=0.1)
    return flatten_scene(scene, textures=[checker_texture(256)])


def bound(n_bytes: float, n_flops: float) -> dict:
    """bound_ms / bound_by of a kernel that must move ``n_bytes`` and do
    ``n_flops`` float32 operations."""
    by_bytes = 1e3 * n_bytes / MEM_BYTES_PER_S
    by_ops = 1e3 * n_flops / F32_FLOP_PER_S
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def ptxas_numbers(compiler_log: str, kernel: str) -> dict:
    """Registers, stack frame and spill bytes of the kernel whose name
    holds ``kernel``, from a library's ``ptxas -v`` output."""
    lines = compiler_log.splitlines()
    out = {}
    for k, line in enumerate(lines):
        if kernel not in line:
            continue
        if "Function properties for" in line:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", lines[k + 1])
            out.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        elif "Compiling entry function" in line:
            used = next(m for m in (re.search(r"Used (\d+) registers", x)
                                    for x in lines[k + 1:]) if m)
            out["registers"] = int(used.group(1))
            cumulative = re.search(r"(\d+) bytes cumulative stack size",
                                   used.string)
            if cumulative:
                out["cumulative_stack_bytes"] = int(cumulative.group(1))
            smem = re.search(r"(\d+) bytes smem", used.string)
            if smem:
                out["shared_bytes"] = int(smem.group(1))
    return out


def _sass_listing(path: str) -> dict:
    """Each kernel's instructions in a built library's machine code
    (cuobjdump -sass); empty where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    listing, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            listing[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            listing[name].append(line)
    return listing


def _sass_sizes(path: str) -> dict:
    """Instructions of each kernel in a built library's machine code."""
    return {name: len(lines) for name, lines in _sass_listing(path).items()}


def kernel_builds(lib, kernel: str) -> dict:
    """Registers, stack and spills of each instance of ``kernel`` in a
    built library (its template arguments as the name), and its loads
    through the read-only data cache (``LDG...CONSTANT``) in the machine
    code."""
    listing = _sass_listing(lib.path)
    out = {}
    for name in sorted(set(re.findall(rf"_Z\w*{kernel}\w*",
                                      lib.compiler_log))):
        m = re.search(rf"{kernel}(?:I(\w+?)E)?E", name)
        label = kernel + (f"<{m.group(1)}>" if m and m.group(1) else "")
        out[label] = dict(ptxas_numbers(lib.compiler_log, name),
                          readonly_loads=sum(
                              "LDG" in line and "CONSTANT" in line
                              for line in listing.get(name, [])))
    return out


def wave_builds(lib) -> dict:
    """kernel_builds of the wave kernel's instances, each with the blocks
    of 256 threads an SM holds by its registers (its plan for a one-row
    table with nothing staged)."""
    out = kernel_builds(lib, "wave_advance_kernel")
    for label, nums in out.items():
        m = re.search(r"<Li(\d+)ELi(\d+)>", label)
        plan = (ctypes.c_int * 5)()
        levels = (ctypes.c_longlong * 1)(0)
        err = lib.handle.trt_wave_advance_plan(1, 64, int(m.group(1)),
                                               int(m.group(2)), levels, 0,
                                               plan)
        if err != 0:
            raise RuntimeError(f"wave plan failed: CUDA error {err}")
        nums["blocks_an_sm"] = plan[3]
    return out


def fetch_builds(lib) -> dict:
    """Registers, spills and 128-bit loads (by kind: LDG from device
    memory, LDS from shared memory, LD generic) in the machine code of
    each fetch_chain_kernel instance of a built library, by instance
    (dtype, placement, 16-byte chunks a row where the source has that
    template parameter)."""
    listing = _sass_listing(lib.path)
    out = {}
    for name in sorted(set(re.findall(r"_Z\w*fetch_chain_kernel\w*",
                                      lib.compiler_log))):
        m = re.search(r"ILb(\d)ELb(\d)E(?:Li(\d+)E)?", name)
        label = (f"{'bf16' if m.group(1) == '1' else 'f32'} "
                 f"{'shared' if m.group(2) == '1' else 'global'}"
                 + (f" {m.group(3)} chunks" if m.group(3) else ""))
        loads = {}
        for line in listing.get(name, []):
            k = re.search(r"\b(LDG|LDS|LD)(\.[A-Z0-9_]+)*\.128\b", line)
            if k:
                loads[k.group(1)] = loads.get(k.group(1), 0) + 1
        out[label] = dict(ptxas_numbers(lib.compiler_log, name),
                          loads_128=loads)
    return out


def phase_environment(variants=()) -> str:
    """The card, the toolkit and every kernel's build (the port's
    libraries and ``variants``, one nvcc each, side by side), with their
    registers, spills and machine code sizes.  Returns the card's name
    and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{nvcc.stdout.strip().splitlines()[-1]}")
    log(f"[env] device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    libraries = [tm.LIBRARY, fetch.LIBRARY, walk.LIBRARY, threaded.LIBRARY,
                 service.LIBRARY, wave.LIBRARY, lane_init.LIBRARY,
                 bounce.LIBRARY, *variants]
    _build.build_all(libraries)
    for lib in libraries:
        log(f"[build] {lib.path} in {lib.build_seconds:.3f} s")
        for line in lib.compiler_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
        for name, n in _sass_sizes(lib.path).items():
            log(f"[build]   {name}: {n} SASS instructions")
    for label, nums in fetch_builds(fetch.LIBRARY).items():
        log(f"[build] fetch_chain_kernel {label}: {nums}")
    for lib, kernel in ((walk.LIBRARY, "quad_walk_kernel"),
                        (service.LIBRARY, "service_pass_kernel"),
                        *((bounce.LIBRARY, f"{name}_kernel")
                          for name in BOUNCE_KERNELS)):
        for name, nums in kernel_builds(lib, kernel).items():
            log(f"[build] {name}: {nums}")
    for name, nums in wave_builds(wave.LIBRARY).items():
        log(f"[build] {name}: {nums}")
    log(f"[build] all kernels in {time.perf_counter() - t0:.3f} s")
    return smi


def _time_ms(fn, reps: int = 50) -> float:
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


class ProfilerBlind(AssertionError):
    """torch.profiler recorded no CUDA operation in a process."""


def _kernel_ms(fn, kernel: str, reps: int = 20) -> float:
    """The kernel's own device time per launch: ``fn`` (a wrapper call
    that launches it once) ``reps`` times under torch.profiler, and the
    durations of the CUDA kernels whose name holds ``kernel`` summed
    over their count.  The wrapper's other work (allocations, copies,
    checks, host time between launches) is left out.  The profiler may
    miss a launch's record (it did on an H100, 6 of 10 kept once), so
    the mean is over the records it kept; a session that kept none of
    them (once on an H100, for the walk after two earlier sessions) is
    run again, at most PROFILE_TRIES times in all.  If none of them
    recorded any CUDA operation (once on an H100, for the walk: the
    profiler then stayed blind for the rest of the process), raises
    ProfilerBlind, and the script runs again in a fresh process.  More
    records than launches means the name matched another kernel."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and kernel in e.key]
        count = sum(e.count for e in found)
        if count:
            break
    if not any(e.device_type == DeviceType.CUDA
               for e in prof.key_averages()):
        raise ProfilerBlind(f"torch.profiler recorded no CUDA operation in "
                            f"{PROFILE_TRIES} sessions of {reps} calls that "
                            f"launch {kernel!r}")
    if not 0 < count <= reps:
        seen = sorted({e.key for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA})
        raise AssertionError(f"the profiler saw {count} launches of "
                             f"{kernel!r} in {reps} calls; CUDA records: "
                             f"{seen[:8]}")
    return sum(e.device_time_total for e in found) / count / 1e3


def phase_tonemap() -> dict:
    """The kernel against its plain version on the card."""
    r = np.random.RandomState(1234)
    worst, mismatches, total = 0, 0, 0
    for spp in (1, 3, 7):
        acc_np = (r.normal(0.5, 0.6, size=TONEMAP_SHAPE) * spp).astype(
            np.float32)
        acc = torch.from_numpy(acc_np).cuda()
        got = tm.tonemap_cuda(acc, spp)
        torch.cuda.synchronize()
        want = tm.tonemap_plain(acc, spp)
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        bad = diff.nonzero()
        n_bad = int(bad.shape[0])
        worst = max(worst, int(diff.max()))
        mismatches += n_bad
        total += diff.numel()
        for i, c in bad[:20].tolist():
            v = float(np.float64(acc_np[i, c]) * tm.inv_spp(spp))
            q = min(max(v, 0.0), 1.0) ** tm.GAMMA_EXP * 255.0 + 0.5
            log(f"[tonemap] spp {spp} [{i},{c}] accum {acc_np[i, c]!r} "
                f"kernel {int(got[i, c])} plain {int(want[i, c])} "
                f"p*255+0.5 = {q!r}")
            if abs(q - round(q)) > 1e-4 or int(diff[i, c]) != 1:
                raise AssertionError("kernel and plain tonemap differ "
                                     "away from a rounding boundary")
        log(f"[tonemap] spp {spp}: {n_bad} of {diff.numel()} bytes differ")
    if worst > 1 or mismatches > MAX_BOUNDARY_SHARE * total:
        raise AssertionError(f"tonemap kernel disagrees: {mismatches} "
                             f"bytes, max diff {worst}")
    acc = torch.from_numpy((r.normal(0.5, 0.6, size=TONEMAP_SHAPE)
                            * 3).astype(np.float32)).cuda()
    runs = {"plain": [], "wrapper": [], "kernel": []}
    for name in ("plain", "wrapper", "kernel", "kernel", "wrapper", "plain"):
        if name == "plain":
            runs[name].append(_time_ms(lambda: tm.tonemap_plain(acc, 3)))
        elif name == "wrapper":
            runs[name].append(_time_ms(lambda: tm.tonemap_cuda(acc, 3)))
        else:
            runs[name].append(_kernel_ms(lambda: tm.tonemap_cuda(acc, 3),
                                         "tonemap_kernel", reps=50))
    ms, wrapper_ms, plain_ms = (float(np.mean(runs[k])) for k in
                                ("kernel", "wrapper", "plain"))
    # 4 B read and 1 B written per float; scale, two clamps, powf (counted
    # as 20), scale, offset, truncation.
    n = acc.numel()
    out = dict(max_abs_err=worst, ms=ms, wrapper_ms=wrapper_ms,
               plain_ms=plain_ms, library_ms=None, **bound(5 * n, 26 * n))
    log(f"[tonemap] {list(TONEMAP_SHAPE)} f32: kernel's own time {ms:.4f} "
        f"ms (runs {runs['kernel']}), wrapper {wrapper_ms:.4f} ms (runs "
        f"{runs['wrapper']}), plain {plain_ms:.4f} ms (runs "
        f"{runs['plain']}); bound {out['bound_ms']:.4f} ms by "
        f"{out['bound_by']}; {mismatches} differing bytes of {total}")
    return out


def _load_fetch_script():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "microbench_torch_fetch.py")
    spec = importlib.util.spec_from_file_location("microbench_torch_fetch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_fetch(seed: int) -> dict:
    """The fetch-chain kernel, both placements, against the plain gather
    chain on the card (bit-equal) on the six variants and the two
    latency variants, then the microbenchmark path itself, and the
    kernel's bound."""
    script = _load_fetch_script()
    rates = script.card_rates()
    rs = np.random.RandomState(seed + 1)
    worst = 0.0
    cases = [(v, fetch.LANES) for v in fetch.VARIANTS]
    cases += [(v, fetch.LATENCY_LANES) for v in fetch.LATENCY_VARIANTS]
    for (m, w, dtype, dependent), lanes in cases:
        table, idx = fetch.make_inputs(rs, m, w, dtype, dependent, lanes)
        table, idx = table.cuda(), idx.cuda()
        want = fetch.fetch_chain_plain(table, idx, fetch.STEPS)
        for placement in fetch.PLACEMENTS:
            name = (f"{script.variant_name(m, w, dtype, dependent)} "
                    f"{placement}, {lanes} lanes")
            got = fetch.fetch_chain_cuda(table, idx, fetch.STEPS, placement)
            torch.cuda.synchronize()
            errs = [float((g - x).abs().max()) for g, x in zip(got, want)]
            worst = max(worst, *errs)
            staged = fetch.staged_rows(table) if placement == "shared" else 0
            log(f"[fetch] {name}, {staged} of {m} rows staged: acc max abs "
                f"err {errs[0]!r}, rowsum max abs err {errs[1]!r} (acc sum "
                f"{float(got[0].sum())!r})")
            if not all(torch.equal(g, x) for g, x in zip(got, want)):
                raise AssertionError(f"fetch_chain kernel disagrees with "
                                     f"its plain version: {name}")
    # The microbenchmark path, through its entry point's own function.
    fetch.fetch_chain_cuda.launches = 0
    results = script.run_benchmark(seed)
    launches = fetch.fetch_chain_cuda.launches
    if launches < 1:
        raise AssertionError("the microbenchmark never launched fetch_chain")
    # One dependent fetch's latency: a warp of lanes walks the latency
    # variants (16-byte rows), from L2 after a warm-up and from shared
    # memory; each call timed by its own device time.
    lat = script.latency_ns(seed)
    log(f"[fetch] one dependent fetch step, one warp: device memory (L2) "
        f"{lat['global_ns']:.1f} ns, shared memory {lat['shared_ns']:.1f} "
        f"ns, a 16 KB table from device memory {lat['global_l1_table_ns']:.1f}"
        f" ns")
    # Two bounds: every column of every fetched row crosses the SMs' load
    # path (lanes x steps x row bytes at 128 B a clock an SM, at the
    # card's SM count and maximum SM clock), and no chain is shorter than
    # its steps' dependent fetches, one warp's step each (the lanes'
    # chains run side by side, so one chain bounds the call).
    for res in results:
        if not res["exact"]:
            raise AssertionError(f"microbenchmark: {res['name']} not exact")
        res["byte_bound_ms"] = script.byte_bound_ms(
            res["lanes"], res["steps"], res["row_bytes"], rates)
        res["latency_bound_ms"] = res["steps"] * lat["global_ns"] * 1e-6
        larger = max(res["byte_bound_ms"], res["latency_bound_ms"])
        per = 1e6 / (res["lanes"] * res["steps"])
        for placement in fetch.PLACEMENTS:
            ms = res["ms"][placement]
            log(f"[fetch] {res['name']} {placement} "
                f"({res['staged_rows'] if placement == 'shared' else 0} rows"
                f" staged): own {ms:.4f} ms ({ms * per:.4f} ns/lane/step), "
                f"wrapper {res['wrapper_ms'][placement]:.4f} ms; bounds "
                f"{res['byte_bound_ms']:.5f} ms by bytes on chip, "
                f"{res['latency_bound_ms']:.5f} ms by latency; own time "
                f"{ms / larger:.2f}x the larger")
        log(f"[fetch] {res['name']} plain {res['plain_ms']:.4f} ms "
            f"({res['plain_ms'] * per:.4f} ns/lane/step), EXACT")
    # The kernel line reports the first variant (the TPU script's first),
    # read from device memory.  Beside its bound, the bytes it would move
    # from device memory if each input were read once (the table, an
    # index and two outputs per lane) and the float32 operations its
    # outputs need (an add and an index advance per step, one W-column
    # sum of the last row).
    first = results[0]
    lanes, steps = first["lanes"], first["steps"]
    dram = bound(first["table_bytes"] + 12 * lanes,
                 lanes * (2 * steps + first["w"]))
    byte_ms, latency_ms = first["byte_bound_ms"], first["latency_bound_ms"]
    out = dict(max_abs_err=worst, ms=first["ms"]["global"],
               wrapper_ms=first["wrapper_ms"]["global"],
               plain_ms=first["plain_ms"], library_ms=None,
               launches=launches, variants=results,
               latency={k: v for k, v in lat.items() if k != "variants"},
               bound_ms=max(byte_ms, latency_ms),
               bound_by="bytes" if byte_ms >= latency_ms else "latency",
               byte_bound_ms=byte_ms, latency_bound_ms=latency_ms,
               dram_bound_ms=dram["bound_ms"],
               staged_rows=first["staged_rows"], **rates)
    log(f"[fetch] {first['name']}, device memory: kernel's own time "
        f"{out['ms']:.4f} ms, wrapper {out['wrapper_ms']:.4f} ms; bound "
        f"{out['bound_ms']:.5f} ms by {out['bound_by']} ({lanes} lanes x "
        f"{steps} steps x {first['row_bytes']} B over {rates['sms']} SMs x "
        f"{script.SM_LOAD_BYTES_PER_CLOCK} B x {rates['sm_clock_mhz']} MHz "
        f"= {byte_ms:.5f} ms; {steps} x {lat['global_ns']:.1f} ns = "
        f"{latency_ms:.5f} ms), {out['ms'] / out['bound_ms']:.2f}x; from "
        f"device memory once {out['dram_bound_ms']:.5f} ms")
    return out


def phase_cuda_vs_cpu() -> None:
    """The renderer on the card (the wave kernel) against the
    plain version of the whole on the CPU (interleaved eager loop), bit
    for bit, at 64x64 and at 64x48 (a side that is not a power of two:
    the camera rays divide by it)."""
    arrays = cube256_arrays()
    for w, h in ((64, 64), (64, 48)):
        _card_vs_cpu(arrays, w, h)


def _card_vs_cpu(arrays, w: int, h: int) -> None:
    cfg = RenderConfig(width=w, height=h, spp=1)
    params = CameraController().get_params(w, h)
    t0 = time.perf_counter()
    r = Renderer(arrays, cfg=cfg)
    r.step(params)
    on_card, card_stats = r.accum_host(), r.last_stats
    t1 = time.perf_counter()
    host = Renderer(arrays, cfg=cfg, device="cpu")
    acc, cpu_stats = persistent.render_frame_interleaved(
        host.scene, host.inline, params, host.frame, w, h, cfg, 1)
    on_cpu = acc.numpy().reshape(h, w, 3)
    t2 = time.perf_counter()
    mse = float(((on_card - on_cpu) ** 2).mean())
    n_off = int((on_card != on_cpu).sum())
    counts = {dev: (int(st["n_traced"]), int(st["n_shadow"]),
                    int(st["rows_fetched"]))
              for dev, st in (("card", card_stats), ("cpu", cpu_stats))}
    log(f"[cube256 {w}x{h}] card vs CPU: {n_off} of {on_card.size} sum "
        f"floats differ, MSE {mse!r} (card {t1 - t0:.2f} s in "
        f"{card_stats['iterations']} rounds, CPU {t2 - t1:.2f} s in "
        f"{cpu_stats['iterations']} steps, mean radiance "
        f"{float(on_card.mean())!r}); (path rays, shadow rays, rows "
        f"fetched) card {counts['card']} CPU {counts['cpu']}")
    if not np.isfinite(on_card).all() or on_card.tobytes() != on_cpu.tobytes():
        raise AssertionError(f"card render differs from the CPU's at {w}x{h}:"
                             f" {n_off} floats, MSE {mse}")
    if counts["card"] != counts["cpu"]:
        raise AssertionError(f"ray or row counts differ: {counts}")
    if not on_card.mean() > 0.0:
        raise AssertionError("cube256 render is black")


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal as numbers (so -0.0 == 0.0: the plain step adds + 0.0 to
    every lane's rad, the kernel only to the lanes it walked), NaN equal
    to NaN."""
    eq = a == b
    if a.is_floating_point():
        eq = eq | (a.isnan() & b.isnan())
    return bool(eq.all())


def walk_state_bytes(n_traverse: int, n_shadow: int, n_other: int) -> int:
    """Bytes of lane state a walk's outputs depend on, plus those it
    writes.  Every lane's mode is read (8 B).  A TRAVERSE lane also reads
    cur, hit_id, d_min, o and d (44 B) and writes mode, cur, hit_id and
    d_min (28 B).  A SHADOW lane reads all that and rad, so, sd, smax,
    pend and cont_after_shadow (53 B more) and writes rad too (12 B)."""
    return (8 * n_other + (8 + 44 + 28) * n_traverse
            + (8 + 44 + 53 + 28 + 12) * n_shadow)


def _check_walk(label: str, rnd: int, s, inline, k: int, passes: int,
                fmt: str) -> dict:
    """One state through the kernel and through walk_plain over the
    walk-order rows (leaf slots of format ``fmt``): every written field
    and the row count must be equal.  Then the kernel's own time and the
    wrapper's."""
    table, levels, sentinel = inline.walk, inline.walk_levels, inline.sentinel
    modes = torch.bincount(s["mode"], minlength=walk.TEXG + 1).tolist()
    n_lanes = s["mode"].shape[0]
    n_traverse, n_shadow = modes[walk.TRAVERSE], modes[walk.SHADOW]
    torch.cuda.synchronize()
    got, rows = walk.quad_walk_cuda(s, table, sentinel, k, passes, levels,
                                    fmt=fmt)
    torch.cuda.synchronize()
    plan = walk.quad_walk_cuda.plan
    t1 = time.perf_counter()
    want, want_rows = walk.walk_plain(s, table, sentinel, k, passes,
                                      fmt=fmt)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t1)
    bad = [f for f in walk.WRITES if not _same(got[f], want[f])]
    err = max(float((got[f].double() - want[f].double()).abs()
                    .nan_to_num(0.0).max()) for f in walk.WRITES)
    log(f"[walk] {label} state (round {rnd}): {n_traverse} TRAVERSE, "
        f"{n_shadow} SHADOW, {modes[walk.DONE]} DONE of {n_lanes} lanes; "
        f"rows fetched kernel {int(rows)} plain {int(want_rows)}; fields "
        f"differing {bad} (-0.0 == 0.0, NaN == NaN), max abs err {err!r}")
    if bad or int(rows) != int(want_rows):
        raise AssertionError(f"quad_walk kernel disagrees with walk_plain "
                             f"on the {label} state: {bad}")
    launch = lambda: walk.quad_walk_cuda(s, table, sentinel, k, passes,
                                         levels, fmt=fmt)
    wrapper_ms = _time_ms(launch, reps=5)
    ms = _kernel_ms(launch, "quad_walk_kernel", reps=10)
    n_rows = int(rows)
    # The walk-order rows once at their padded width (at most: a walk
    # may leave some unvisited) and the lane state by mode.  Operations:
    # the cheaper row kind, an internal row's four slab tests at 30 each.
    out = dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
               plain_ms=plain_ms, library_ms=None, rows_fetched=n_rows,
               plan=plan,
               **bound(sentinel * table.shape[1] * 4
                       + walk_state_bytes(n_traverse, n_shadow,
                                          n_lanes - n_traverse - n_shadow),
                       120 * n_rows))
    log(f"[walk] {label} state: kernel's own time {ms:.4f} ms, wrapper "
        f"{wrapper_ms:.4f} ms, plain {plain_ms:.1f} ms; "
        f"{n_rows / ms / 1e6:.3f} G rows/s; bound {out['bound_ms']:.5f} ms "
        f"by {out['bound_by']}; staged {plan['staged_rows']} rows "
        f"({plan['shared_bytes']} B of shared memory a block), grid "
        f"{plan['grid']} blocks of {plan['threads']} ({plan['blocks_per_sm']}"
        f" per SM)")
    return out


def service_state_bytes(s, want, params) -> int:
    """Bytes of lane state and table rows a service pass's outputs
    depend on, plus those it writes, for the lanes of state ``s`` in
    each mode (``want``: the state after the pass, ``params`` its
    ServiceParams).  Every lane's mode is read (8 B).  A SHADEG lane
    reads hit_id, o, d and d_min (36 B); one parked in TEXG writes so,
    sd, pend, its 10-float stash, mode, cur and hit_id (100 B).  A TEXG
    lane reads cur, hit_id, o, d, d_min, its stash, so, sd and pend (140
    B).  A lane shaded reads depth, seed, pix, tp, rad and prev_spec (49
    B) and writes mode, cur, hit_id, depth, d_min, o, d, tp, rad,
    prev_spec and pend (97 B); one that fires a shadow ray also writes
    so, sd, smax and cont_after_shadow (29 B).  A lane refilled reads
    rad, out, sample and pix (40 B) and writes out, rad, sample, seed and
    mode (48 B); one that starts a sample also writes cur, d_min, hit_id,
    o, d, tp, depth and prev_spec (65 B).  The table counts once, as the
    walk bounds count theirs: each distinct trimat row the SHADEG lanes
    hit (148 B) and four texels (48 B, at least) of each distinct tile
    row the TEXG lanes read.  The light rows, the texture layout and the
    four totals count once too."""
    mode = s["mode"]
    shadeg = mode == walk.SHADEG
    texg = mode == walk.TEXG
    parked = shadeg & (want["mode"] == walk.TEXG)
    shaded = (shadeg & ~parked) | texg
    fired = shaded & (want["mode"] == walk.SHADOW)
    refilled = want["sample"] != s["sample"]
    started = refilled & (want["mode"] != walk.DONE)
    n = lambda m: int(m.sum())
    distinct = lambda v: int(torch.unique(v).numel())
    return (8 * mode.numel() + 36 * n(shadeg) + 100 * n(parked)
            + 140 * n(texg) + 146 * n(shaded) + 29 * n(fired)
            + 88 * n(refilled) + 65 * n(started)
            + 148 * distinct(s["hit_id"][shadeg & (s["hit_id"] >= 0)])
            + 48 * distinct(s["cur"][texg])
            + params.lights.numel() * 4 + params.metas.numel() * 8
            + 8 * len(service.TOTALS))


# A tiny kernel per double-precision call the service kernel makes, built
# as the kernels are, whose machine code gives the FP64 instructions of
# one call (fp64_per_call).
FP64_PROBE = r"""
#include <math.h>
extern "C" __global__ void probe_sqrt(const float* x, float* y) {
  y[threadIdx.x] = (float)sqrt((double)x[threadIdx.x]);
}
extern "C" __global__ void probe_cos(const float* x, float* y) {
  y[threadIdx.x] = (float)cos((double)x[threadIdx.x]);
}
extern "C" __global__ void probe_sin(const float* x, float* y) {
  y[threadIdx.x] = (float)sin((double)x[threadIdx.x]);
}
extern "C" __global__ void probe_pow(const float* x, float* y) {
  y[threadIdx.x] = (float)pow((double)x[threadIdx.x], 5.0);
}
"""
FP64_OPCODES = re.compile(r"^D(ADD|MUL|FMA|SETP|MNMX|SET)\b")
_fp64_per_call = {}


def _fp64_path(lines: list) -> tuple:
    """FP64 instructions on a probe's straight path: from its entry to
    its first unpredicated EXIT, following unpredicated jumps and calls
    (to their RET); predicated branches (the slow paths of special and
    huge arguments) are not followed.  Returns (on the path, in the
    whole listing, calls whose target could not be read)."""
    at = {addr: k for k, (addr, _) in enumerate(lines)}
    total = sum(bool(FP64_OPCODES.match(op)) for _, op in lines)
    count = unread = 0
    stack, k, seen = [], 0, set()
    while 0 <= k < len(lines) and k not in seen:
        seen.add(k)
        op = lines[k][1]
        predicated = op.startswith("@")
        word = op.split()[0] if op else ""
        target = re.search(r"0x([0-9a-f]+)", op)
        if FP64_OPCODES.match(op):
            count += 1
        if not predicated and word == "EXIT" and not stack:
            break
        if not predicated and word.startswith("RET") and stack:
            k = stack.pop()
            continue
        if not predicated and word.startswith(("CALL", "BRA")):
            dest = at.get(int(target.group(1), 16)) if target else None
            if dest is None:
                unread += word.startswith("CALL")
            else:
                if word.startswith("CALL"):
                    stack.append(k + 1)
                k = dest
                continue
        k += 1
    return count, total, unread


def fp64_per_call() -> dict:
    """FP64 instructions (DADD, DMUL, DFMA, DSETP, DMNMX, DSET) of one
    double sqrt, cos, sin and pow(x, 5.0) as nvcc builds them for the
    service kernel (sm_90a, --fmad=false): FP64_PROBE's kernels compiled
    with the kernels' flags and read with cuobjdump -sass (_fp64_path).
    Computed once a process; logged with each probe's whole listing."""
    if _fp64_per_call:
        return _fp64_per_call
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "fp64_probe.cu")
    cubin = os.path.join(_build.BUILD_DIR, "fp64_probe.cubin")
    with open(src, "w") as f:
        f.write(FP64_PROBE)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.nvcc(), *flags, "-cubin", "-o", cubin, src],
                   check=True, capture_output=True, text=True, timeout=300)
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", cubin], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    listings, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            listings[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and m:
            listings[name].append((int(m.group(1), 16), m.group(2).strip()))
    for call in ("sqrt", "cos", "sin", "pow"):
        path, total, unread = _fp64_path(listings[f"probe_{call}"])
        if not path:
            raise AssertionError(f"no FP64 instruction in probe_{call}")
        log(f"[service] FP64 instructions of one double {call}: {path} on "
            f"the straight path ({total} in the probe's listing"
            f"{f'; {unread} calls not followed' if unread else ''})")
        _fp64_per_call[call] = path
    return _fp64_per_call


def service_work(s, fr):
    """The plain service pass on ``s`` (persistent.service_plain) and the
    work its lanes' taken branches give the kernel.  Returns (state
    after, totals after, work): ``work["lanes"]`` counts the lanes by
    what they take (SHADEG lanes parked for a texture; ready lanes by
    branch: specular with roughness 0 or above, transmission by total
    internal reflection or refraction with roughness 0 or above,
    diffuse; ready lanes whose path ended before a branch, by whether
    they retire or restart; camera rays started) and ``work["calls"]``
    the double sqrt, cos, sin and pow calls and the DMULs of the
    kernel's code on those lanes.  The branch of each lane is read from
    the plain pass's own inputs to ops/shade.py scatter (recorded as it
    runs) with the pass's own functions."""
    seen = {}
    real_surface, real_scatter = shade.surface, shade.scatter

    def surface(hitrow, x_hit, d, *args):
        seen["hitrow"], seen["x_hit"] = hitrow, x_hit
        return real_surface(hitrow, x_hit, d, *args)

    def scatter(q, d, tp, rad, alive, prev_spec, u, rr_on, scene, cfg):
        seen.update(q=q, d=d, alive=alive, u=u, rr_on=rr_on)
        return real_scatter(q, d, tp, rad, alive, prev_spec, u, rr_on, scene,
                            cfg)

    totals = torch.zeros(len(service.TOTALS), dtype=torch.int64,
                         device=s["mode"].device)
    shade.surface, shade.scatter = surface, scatter
    try:
        want = persistent.service_plain(s, fr.inline, fr, totals, 0)
    finally:
        shade.surface, shade.scatter = real_surface, real_scatter
    cfg, scene = fr.cfg, fr.scene
    q, d, u = seen["q"], seen["d"], seen["u"]
    mode = s["mode"]
    shadeg = mode == walk.SHADEG
    ready = (shadeg & (want["mode"] != walk.TEXG)) | (mode == walk.TEXG)
    # scatter's liveness: a hit that is no emitter and survives roulette.
    alive = seen["alive"] & ~(q["emission"]
                              > cfg.emitter_stop_threshold).any(dim=-1)
    p_live = torch.clamp(q["albedo"].amax(dim=-1), min=cfg.rr_min_p)
    alive = alive & (~seen["rr_on"] | (u[:, rng.SLOT_RR] < p_live))
    p_spec, p_trans, _ = shade.pbr_weights(
        q["albedo"], q["metallic"], q["roughness"], q["transmission"],
        q["nl"], d)
    u_b = u[:, rng.SLOT_BRANCH]
    m_spec = alive & (u_b < p_spec)
    m_trans = alive & ~m_spec & (u_b < p_spec + p_trans)
    m_diff = alive & ~m_spec & ~m_trans
    tir = m_trans & shade.refract_branch(
        d, q["nrm"], q["nl"], q["ior"], q["roughness"],
        u[:, rng.SLOT_DIR_R1], u[:, rng.SLOT_DIR_R2])[1]
    rough = q["roughness"] > 0.0
    dead = ready & ~alive
    refilled = want["sample"] != s["sample"]
    # ops/shade.py smooth_normal's test, for the SHADEG lanes' second sqrt.
    smooth_ok = torch.zeros_like(shadeg)
    if cfg.smooth_shading and scene.has_normals:
        row, x_hit = seen["hitrow"], seen["x_hit"]
        b1, b2, ok_den = shade.barycentric(row[:, 0:3], row[:, 3:6],
                                           row[:, 6:9], x_hit)
        b0 = 1.0 - b1 - b2
        ns = (row[:, 21:24] * b0[:, None] + row[:, 24:27] * b1[:, None]
              + row[:, 27:30] * b2[:, None])
        smooth_ok = shadeg & ok_den & (vec.dot(ns, ns) > 1e-12)
    n = lambda m: int(m.sum())
    lanes = dict(
        shadeg=n(shadeg), parked=n(shadeg & ~ready), ready=n(ready),
        spec_smooth=n(m_spec & ~rough), spec_rough=n(m_spec & rough),
        tir=n(tir), trans_smooth=n(m_trans & ~tir & ~rough),
        trans_rough=n(m_trans & ~tir & rough), diff=n(m_diff),
        dead_retire=n(dead & (want["mode"] == walk.DONE)),
        dead_restart=n(dead & (want["mode"] != walk.DONE)),
        camera=n(refilled & (want["mode"] != walk.DONE)))
    # The kernel's calls on these lanes: a face normal (1 sqrt) for every
    # SHADEG lane and a smooth one (1) where smooth_normal keeps it; pow
    # and the DMUL of pow(., 2) for every live lane; a perturbed
    # direction (2 sqrt, cos, sin) for specular lanes, total internal
    # reflection and rough refraction; a refraction (2 sqrt); the light
    # sample (3 sqrt) and a cosine-weighted direction (4 sqrt, cos, sin)
    # for diffuse lanes; that direction for a retiring dead lane; a
    # camera ray (7 sqrt, cos, sin) for every sample started.
    trans_refr = lanes["trans_smooth"] + lanes["trans_rough"]
    perturbed = (lanes["spec_smooth"] + lanes["spec_rough"] + lanes["tir"]
                 + lanes["trans_rough"])
    hemisphere = lanes["diff"] + lanes["dead_retire"]
    trig = perturbed + hemisphere + lanes["camera"]
    calls = dict(
        sqrt=(lanes["shadeg"] + n(smooth_ok) + 2 * perturbed
              + 2 * trans_refr + (3 * lanes["diff"] if scene.num_lights
                                  else 0)
              + 4 * hemisphere + 7 * lanes["camera"]),
        cos=trig, sin=trig, pow=n(alive), dmul=n(alive))
    return want, totals, dict(lanes=lanes, calls=calls)


def service_bound(n_bytes: int, calls: dict) -> dict:
    """The service pass's bound: the larger of its bytes over the memory
    rate and its FP64 instructions (each a two-operation slot of the
    FP64 pipe, the rate's FMA) over NVIDIA's FP64 rate for the H100 SXM,
    34 TFLOP/s."""
    per = fp64_per_call()
    fp64 = sum(calls[k] * per[k] for k in per) + calls["dmul"]
    by_bytes = 1e3 * n_bytes / MEM_BYTES_PER_S
    by_fp64 = 1e3 * 2 * fp64 / F64_FLOP_PER_S
    return dict(bound_ms=max(by_bytes, by_fp64),
                bound_by="bytes" if by_bytes >= by_fp64 else "operations",
                bytes_ms=by_bytes, fp64_ms=by_fp64, fp64_instructions=fp64)


def _check_service(label: str, rnd, s, r: Renderer, fr) -> dict:
    """One state whose walks have ended through the service kernel and
    through its plain version (persistent.service_plain) on the card:
    every field and the four totals must be equal (-0.0 == 0.0, NaN ==
    NaN).  Then the kernel's own time, the wrapper's (each call on a
    fresh copy: the pass writes in place), the plain version's, and the
    bound of the work its lanes' taken branches give the kernel
    (service_work)."""
    inline = r.inline
    modes = torch.bincount(s["mode"], minlength=walk.TEXG + 1).tolist()
    fresh = lambda: {key: val.clone() for key, val in s.items()}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    persistent.service_plain(s, inline, fr, torch.zeros(
        len(service.TOTALS), dtype=torch.int64, device=r.device), 0)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t1)
    want, want_totals, work = service_work(s, fr)
    totals = torch.zeros_like(want_totals)
    scratch = torch.zeros_like(want_totals)
    run = lambda st, t=scratch: service.service_pass_cuda(
        st, inline, fr.service, t, 0)
    got = run(fresh(), totals)
    torch.cuda.synchronize()
    fields = [f for f, _, _ in service.FIELDS if f in s]
    bad = [f for f in fields if not _same(got[f], want[f])]
    err = max(float((got[f].double() - want[f].double()).abs()
                    .nan_to_num(0.0).max()) for f in fields)
    log(f"[service] {label} state (round {rnd}): SHADEG {modes[walk.SHADEG]}"
        f", TEXG {modes[walk.TEXG]}, REFILL {modes[walk.REFILL]}, DONE "
        f"{modes[walk.DONE]} of {len(s['mode'])} lanes; totals (path, "
        f"shadow, live, other slot) kernel {totals.tolist()} plain "
        f"{want_totals.tolist()}; fields differing {bad} (-0.0 == 0.0, NaN "
        f"== NaN), max abs err {err!r}")
    if bad or totals.tolist() != want_totals.tolist():
        raise AssertionError(f"the service kernel disagrees with its plain "
                             f"version on the {label} state: {bad}")
    copies = iter([fresh() for _ in range(6)])
    wrapper_ms = _time_ms(lambda: run(next(copies)), reps=5)
    ms = _kernel_ms(lambda: run(fresh()), "service_pass_kernel", reps=10)
    del copies
    out = dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
               plain_ms=plain_ms, library_ms=None, modes=modes,
               totals=totals.tolist(), lanes=work["lanes"],
               calls=work["calls"],
               **service_bound(service_state_bytes(s, want, fr.service),
                               work["calls"]))
    log(f"[service] {label} state: lanes taking each branch {work['lanes']};"
        f" double calls {work['calls']}")
    log(f"[service] {label} state: kernel's own time {ms:.4f} ms, wrapper "
        f"{wrapper_ms:.4f} ms, plain {plain_ms:.1f} ms; bound "
        f"{out['bound_ms']:.5f} ms by {out['bound_by']} (bytes "
        f"{out['bytes_ms']:.5f} ms, FP64 {out['fp64_ms']:.5f} ms: "
        f"{out['fp64_instructions']} instructions)")
    return out


def service_frame(r: Renderer, params, spp: int = 1):
    """(_Frame, fresh lane state) of a full-width frame of ``r``'s
    scene, its service parameters packed."""
    cam = params.to(r.device)
    fr = persistent._Frame(r.scene, r.inline, r.cfg, cam, 1, WIDTH, HEIGHT,
                           spp, spp)
    fr.service = service.service_params(fr)
    s = persistent.init_lane_ctx(
        1, spp, torch.arange(WIDTH * HEIGHT, device=r.device), cam, WIDTH,
        HEIGHT, r.cfg, with_tstash=r.inline.tex0 is not None)
    return fr, s


def frame_rounds(r: Renderer, fr, s):
    """Yield (round, state, state after the round's walks) for each round
    of the frame of ``fr`` from state ``s``, the rounds run with the two
    kernels as the round loop runs them."""
    inline, cfg = r.inline, r.cfg
    passes = max(1, cfg.quad_redirect_passes)
    totals = torch.zeros(len(service.TOTALS), dtype=torch.int64,
                         device=r.device)
    for rnd in range(cfg.max_depth * 2 + 2):
        walked, _ = walk.quad_walk(s, inline.walk, inline.sentinel,
                                   r.scene.leaf_size, passes,
                                   inline.walk_levels, fmt=r.scene.leaf_fmt)
        yield rnd, s, walked
        s = service.service_pass_cuda(walked, inline, fr.service, totals,
                                      rnd % 2)


def labelled_rounds(r: Renderer, params):
    """Yield (label, round, fr, state, state after its walks) for three
    rounds of a full-width frame of ``r``: the fresh 960,000-lane state
    (a closest-hit round), the first round with at least
    SHADOW_LANES_MIN lanes in SHADOW, and the first round with at least
    LATE_DONE_SHARE of its lanes DONE (uncompacted)."""
    fr, s0 = service_frame(r, params)
    todo = ["fresh", "shadow", "late"]
    for rnd, s, walked in frame_rounds(r, fr, s0):
        modes = torch.bincount(s["mode"], minlength=walk.TEXG + 1).tolist()
        walking = modes[walk.TRAVERSE] + modes[walk.SHADOW]
        if rnd == 0:
            label = "fresh"
        elif "shadow" in todo and modes[walk.SHADOW] >= SHADOW_LANES_MIN:
            label = "shadow"
        elif ("late" in todo and walking
              and modes[walk.DONE] >= LATE_DONE_SHARE * WIDTH * HEIGHT):
            label = "late"
        else:
            continue
        yield label, rnd, fr, s, walked
        todo.remove(label)
        if not todo:
            return
    raise AssertionError(f"no round gave the {todo} states")


def phase_walk(r: Renderer, params) -> tuple:
    """quad_walk_cuda against walk_plain over the walk-order rows of
    ``r`` (a path's Renderer, with its tree and leaf format) in the three
    states of labelled_rounds (threads skip most lanes of the late one
    and refill often), and the service kernel against its plain version
    on each of these states just after its walk.  Returns the fresh
    state's walk numbers and each state's service numbers."""
    inline, k, cfg = r.inline, r.scene.leaf_size, r.cfg
    fmt = r.scene.leaf_fmt
    passes = max(1, cfg.quad_redirect_passes)
    log(f"[walk] {fmt} leaves x{k}: walk-order rows "
        f"{tuple(inline.walk.shape)}, rows per level "
        f"{list(inline.walk_levels)}")
    fresh = None
    services = {}
    for label, rnd, fr, s, walked in labelled_rounds(r, params):
        res = _check_walk(f"{label} ({fmt})", rnd, s, inline, k, passes, fmt)
        fresh = fresh or res
        services[label] = _check_service(f"{label} ({fmt})", rnd, walked, r,
                                         fr)
    return fresh, services


def service_scenes(tmp: str) -> list:
    """(name, arrays, config) of the [service] frames beyond the [walk]
    paths': the [features] "lights" scene (17 lights) and the main path's
    scene at leaf 6 (quad rows of 82 floats, so two trimat rows a table
    row)."""
    lights, knobs = _feature_scene(tmp, "lights")
    return [("17 lights", lights,
             RenderConfig(width=WIDTH, height=HEIGHT, spp=1, **knobs)),
            ("pack 2", main_path_arrays(),
             RenderConfig(width=WIDTH, height=HEIGHT, spp=1,
                          bvh_leaf_size=6))]


def mixed_arrays():
    """The main path's scene (Cornell box, checker-textured back wall,
    the rough metal icosphere) with a mirror cube (roughness 0), a clear
    glass cube (roughness 0) and a frosted one (roughness 0.3), so that
    every branch of the shade has lanes."""
    scene = cornell_with(*icosphere_mesh(5, 15.0), (50.0, 20.0, 50.0),
                         albedo=(0.75, 0.75, 0.75), metallic=1.0,
                         roughness=0.1)
    v0, v1, v2 = cube_mesh(10.0)
    for off, mat in (((10, 10, 80), dict(metallic=1.0, roughness=0.0)),
                     ((85, 10, 80), dict(ior=1.5, transmission=1.0)),
                     ((50, 60, 100), dict(ior=1.5, transmission=1.0,
                                          roughness=0.3))):
        o = np.asarray(off, np.float32)
        for a, b, c in zip(v0 + o, v1 + o, v2 + o):
            scene.objects.append(Object(v0=tuple(a), v1=tuple(b),
                                        v2=tuple(c),
                                        albedo=(0.95, 0.95, 0.95), **mat))
    return flatten_scene(scene, textures=[checker_texture(256)])


def mixed_state(r: Renderer, params, w: int, h: int, seed: int) -> tuple:
    """(_Frame, state) of w * h lanes over ``r``'s scene (mixed_arrays)
    made from ``seed``: every warp of 32 lanes holds SHADEG, TEXG,
    REFILL, DONE, TRAVERSE and SHADOW lanes in a shuffled order; a SHADEG
    lane hits a triangle of one material class (diffuse, textured,
    mirror, rough metal, clear glass, frosted glass, emitter), at a
    random point of it from a random direction (so rays leave the glass
    too, and some reflect totally), or misses; depths span Russian
    roulette, samples retire or restart (MIXED_SPP samples a pixel), and
    radiance sums hold NaN, inf, negative and firefly values."""
    n = w * h
    if n % 32:
        raise ValueError(f"{n} lanes are not whole warps")
    dev, cfg, inline = r.device, r.cfg, r.inline
    cam = params.to(dev)
    fr = persistent._Frame(r.scene, inline, cfg, cam, 1, w, h, MIXED_SPP,
                           MIXED_SPP)
    rs = np.random.RandomState(seed)
    pattern = ([walk.SHADEG] * 12 + [walk.TEXG] * 5 + [walk.REFILL] * 6
               + [walk.DONE, walk.TRAVERSE, walk.SHADOW] * 3)
    mode = np.concatenate([rs.permutation(pattern) for _ in range(n // 32)])
    tm_rows = r.scene.trimat.cpu().numpy()
    emitter = (tm_rows[:, 12:15] > 0).any(axis=1)
    metal, rough = tm_rows[:, 15] > 0, tm_rows[:, 16] > 0
    glass, textured = tm_rows[:, 18] > 0, tm_rows[:, 19] >= 0
    classes = [np.flatnonzero(m) for m in (
        ~emitter & ~metal & ~glass & ~textured, textured,
        metal & ~rough, metal & rough, glass & ~rough, glass & rough,
        emitter)]
    if not all(len(c) for c in classes):
        raise AssertionError("the scene lacks a material class")
    shadeg = np.flatnonzero(mode == walk.SHADEG)
    pick = rs.randint(0, len(classes), shadeg.size)
    hit = np.full(n, -1, np.int64)
    hit[shadeg] = [c[rs.randint(len(c))] for c in
                   (classes[k] for k in pick)]
    hit[shadeg[rs.rand(shadeg.size) < 1 / 16]] = -1  # misses
    d = rs.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    bary = rs.dirichlet((1.0, 1.0, 1.0), n).astype(np.float32)
    tri = tm_rows[np.maximum(hit, 0), 0:9].reshape(n, 3, 3)
    x_hit = (bary[:, :, None] * tri).sum(axis=1)
    d_min = rs.uniform(1.0, 100.0, n).astype(np.float32)
    o = (x_hit - d * d_min[:, None]).astype(np.float32)
    cur = np.zeros(n, np.int64)
    texg = mode == walk.TEXG
    tiles = int(inline.table.shape[0]) - inline.tex0
    cur[texg] = inline.tex0 + rs.randint(0, tiles, int(texg.sum()))
    hit[texg] = rs.randint(0, 16, int(texg.sum()))
    rad = rs.uniform(0.0, 3.0, (n, 3)).astype(np.float32)
    bad = rs.choice(6, n, p=[0.6, 0.08, 0.08, 0.08, 0.08, 0.08])
    rad[bad == 1, 0] = np.nan
    rad[bad == 2, 1] = np.inf
    rad[bad == 3, 2] = -1.0
    rad[bad == 4] = 500.0
    unit = lambda: _unit_rows(rs, n)
    tstash = np.concatenate([
        rs.uniform(0, 1, (n, 3)), rs.choice([0.0, 0.5, 1.0], (n, 1)),
        rs.uniform(0, 1, (n, 1)), rs.uniform(1, 2, (n, 1)),
        rs.choice([0.0, 1.0], (n, 1)), rs.uniform(0, 1, (n, 2)),
        rs.choice([0.0, 1.0], (n, 1))], axis=1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    s = persistent.init_lane_ctx(1, MIXED_SPP, torch.arange(n, device=dev),
                                 cam, w, h, cfg, with_tstash=True)
    s.update(
        mode=t(mode), hit_id=t(hit), d_min=t(d_min), cur=t(cur), o=t(o),
        d=t(d), rad=t(rad), tstash=t(tstash),
        depth=t(rs.randint(0, cfg.max_depth, n).astype(np.int64)),
        sample=t(rs.randint(0, MIXED_SPP, n).astype(np.int64)),
        tp=t(rs.uniform(0.1, 1.0, (n, 3)).astype(np.float32)),
        prev_spec=t(rs.rand(n) < 0.5),
        cont_after_shadow=t(rs.rand(n) < 0.5), so=t(unit()), sd=t(unit()),
        smax=t(rs.uniform(1, 100, n).astype(np.float32)),
        pend=t(np.where(rs.rand(n, 1) < 0.2, 5.0, 0.0).astype(np.float32)
               * np.ones((1, 3), np.float32)),
        out=t(rs.uniform(0, 2, (n, 3)).astype(np.float32)))
    return fr, s


def _unit_rows(rs, n: int) -> np.ndarray:
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def phase_service(params) -> dict:
    """The service kernel against its plain version on states of two
    more full-width frames (service_scenes), each just after the walks
    of the rounds SERVICE_ROUNDS, and on the seed-made mixed state
    (mixed_state at 1200x800, every warp mixing every mode and taking
    every branch).  Logs the kernel's registers, stack and spills."""
    build = ptxas_numbers(service.LIBRARY.compiler_log, "service_pass_kernel")
    log(f"[service] kept build: {build}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, arrays, cfg in service_scenes(tmp):
            r = Renderer(arrays, cfg=cfg)
            inline = r.inline
            log(f"[service] {name}: {arrays.num_objects} triangles, "
                f"{r.scene.num_lights} lights, leaf {r.scene.leaf_fmt} x"
                f"{r.scene.leaf_size}, unified table "
                f"{tuple(inline.table.shape)}, pack {inline.pack}")
            if name == "pack 2" and inline.pack != 2:
                raise AssertionError(f"pack {inline.pack}, not 2")
            if name == "17 lights" and r.scene.num_lights != 17:
                raise AssertionError(f"{r.scene.num_lights} lights")
            fr, s0 = service_frame(r, params)
            for rnd, _, walked in frame_rounds(r, fr, s0):
                if rnd in SERVICE_ROUNDS:
                    out[f"{name}, round {rnd}"] = _check_service(
                        name, rnd, walked, r, fr)
                if rnd == max(SERVICE_ROUNDS):
                    break
            del r, walked, fr, s0
    r = Renderer(mixed_arrays(), cfg=RenderConfig(width=WIDTH, height=HEIGHT,
                                                  spp=1))
    fr, s = mixed_state(r, params, WIDTH, HEIGHT, MIXED_SEED)
    fr.service = service.service_params(fr)
    res = _check_service("mixed", "-", s, r, fr)
    empty = [k for k, v in res["lanes"].items() if not v]
    if empty:
        raise AssertionError(f"the mixed state has no lanes taking {empty}")
    out["mixed"] = res
    return out


def phase_main_path(r: Renderer, params) -> dict:
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    r.step(params)
    r.block_until_ready()
    warm_rounds = r.last_stats["iterations"]
    log(f"[main] warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms, "
        f"{warm_rounds} rounds")
    steps = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        r.step(params)
        r.block_until_ready()
        dt = time.perf_counter() - t0
        st = r.last_stats
        rays = int(st["n_traced"]) + int(st["n_shadow"])
        steps.append(dict(ms=1e3 * dt, path=int(st["n_traced"]),
                          shadow=int(st["n_shadow"]),
                          rounds=st["iterations"],
                          rows_fetched=int(st["rows_fetched"]),
                          mrays_per_s=rays / dt / 1e6))
        log(f"[main] step {1e3 * dt:.1f} ms, path rays {steps[-1]['path']}, "
            f"shadow rays {steps[-1]['shadow']}, {st['iterations']} "
            f"rounds, {steps[-1]['rows_fetched']} rows fetched, "
            f"{steps[-1]['mrays_per_s']:.3f} Mrays/s")
    img = r.image()
    launched = _counts()
    launches = launched["tonemap"]
    wave_launches = launched["wave"]
    walk_launches = launched["walk"]
    service_launches = launched["service"]
    accum = r.state.accum
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(accum).all()):
        raise AssertionError("non-finite radiance in the accumulator")
    if img.shape != (HEIGHT, WIDTH, 3) or img.dtype != np.uint8:
        raise AssertionError(f"image {img.shape} {img.dtype}")
    if launches < 1:
        raise AssertionError("the main path never launched the tonemap kernel")
    rounds = warm_rounds + sum(s["rounds"] for s in steps)
    if (wave_launches != 1 + TIMED_STEPS
            or wave_launches != launched["advances"]):
        raise AssertionError(f"{wave_launches} wave-kernel launches for "
                             f"{launched['advances']} advances in "
                             f"{1 + TIMED_STEPS} steps: a step is one launch")
    if walk_launches or service_launches:
        raise AssertionError(f"{walk_launches} walk and {service_launches} "
                             "service launches on the main path: its rounds "
                             "run inside the wave kernel")
    if launched["lane_init"] != wave_launches:
        raise AssertionError(f"{launched['lane_init']} lane set-up launches "
                             f"for {wave_launches} wave-kernel launches: a "
                             "step's wave is set up by one launch")
    if any(launched[name] for name in BOUNCE_KERNELS):
        raise AssertionError(f"bounce kernels launched on the main path: "
                             f"{launched}")
    if not img.max() > 0:
        raise AssertionError("the image is all black")
    want = tm.tonemap_plain(accum.cpu(), r.spp()).numpy().reshape(img.shape)
    off = np.abs(img.astype(np.int32) - want.astype(np.int32))
    log(f"[main] image mean {float(img.mean())!r}, spp {r.spp()}, peak "
        f"device memory {peak} B, tonemap launches {launches}, wave-kernel "
        f"launches {wave_launches} ({launched['advances']} advances with work,"
        f" {1 + TIMED_STEPS} steps, {rounds} rounds), walk launches "
        f"{walk_launches}, service launches {service_launches}, lane set-up "
        f"launches {launched['lane_init']}, bytes off the CPU tonemap "
        f"{int((off > 0).sum())} (max {int(off.max())})")
    if float(img.mean()) != MAIN_IMAGE_MEAN:
        raise AssertionError(f"image mean {float(img.mean())!r} is not "
                             f"{MAIN_IMAGE_MEAN!r}: the render changed")
    counts = tuple((st["path"], st["shadow"], st["rows_fetched"],
                    st["rounds"]) for st in steps)
    if counts != MAIN_STEP_COUNTS:
        raise AssertionError(f"steps traced {counts}, not "
                             f"{MAIN_STEP_COUNTS}: the work changed")
    no_sync_step(r, params)
    ms = float(np.mean([s["ms"] for s in steps]))
    return dict(steps=steps, launches=launches, counts=launched,
                ms_per_step=ms,
                mrays_per_s=float(np.mean([s["mrays_per_s"] for s in steps])),
                peak_bytes=peak, image_mean=float(img.mean()))


def no_sync_step(r: Renderer, params) -> None:
    """One more ``Renderer.step`` with synchronizing calls refused
    (torch.cuda.set_sync_debug_mode("error")) from its start to the wave
    kernel's one read of its counters (ops/wave.py read_counters): the
    wave's set-up (Wave.__init__, the lane set-up kernel) and the wave
    kernel's launch wait for nothing on the card."""
    read = wave.read_counters
    reads = []

    def counters(ctl):
        torch.cuda.set_sync_debug_mode(0)
        reads.append(1)
        return read(ctl)

    wave.read_counters = counters
    try:
        torch.cuda.set_sync_debug_mode("error")
        r.step(params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        wave.read_counters = read
    r.block_until_ready()
    log(f"[main] a step with synchronizing calls refused up to the wave "
        f"kernel's read of its counters: ran, {len(reads)} read")
    if len(reads) != 1:
        raise AssertionError(f"{len(reads)} counter reads in a step")


def _launched(fn) -> dict:
    """The launches ``fn()`` made, by COUNTED's names; a step of the
    persistent engine on the card must launch the wave kernel once for
    each Wave.advance with work and neither the walk nor the service
    kernel."""
    before = _counts()
    fn()
    got = {k: v - before[k] for k, v in _counts().items()}
    if got["wave"] != got["advances"] or got["walk"] or got["service"]:
        raise AssertionError(f"launches {got}: an advance with work is one "
                             "wave-kernel launch, and nothing else walks")
    return got


def _progressive_steps(pr: ProgressiveRenderer, params, rounds) -> tuple:
    """``pr.step(params, n)`` for each n of ``rounds`` while the wave is
    not done, with a snapshot after each; (the wave-kernel launches they
    made, the steps)."""
    launches = steps = 0
    for n in rounds:
        if pr.done() and pr.wave is not None:
            break
        launches += _launched(lambda: pr.step(params, n))["wave"]
        steps += 1
        pr.snapshot()
    return launches, steps


def phase_progressive(r: Renderer, arrays, params) -> dict:
    """ProgressiveRenderer on the main path's scene at full width:
      (a) a capped run (PROGRESSIVE_CAP spp, frame PROGRESSIVE_FRAME_SEED)
          to done(), equal bit for bit to a batch step of that frame at
          that spp, sums and int64 ray counts;
      (c) the same run split into calls of 1, 2, 3, ... rounds, with a
          snapshot after each, equal to (a) bit for bit;
      (b) an unbounded run: PROGRESSIVE_FRAMES[0] frames of
          PROGRESSIVE_ROUNDS rounds, reset(), PROGRESSIVE_FRAMES[1] more;
          counts only grow between resets, and reset() zeroes them.
    Every step is one wave-kernel launch.  Returns the wave kernel's
    launches in the progressive renderers' steps and the unbounded
    frames."""
    cfg = RenderConfig(width=WIDTH, height=HEIGHT)
    cap, seed = PROGRESSIVE_CAP, PROGRESSIVE_FRAME_SEED
    n = WIDTH * HEIGHT
    t0 = time.perf_counter()
    pr = ProgressiveRenderer(arrays, cfg=cfg, spp_cap=cap, frame_seed=seed,
                             seed_spp=cap, device=r.device)
    t1 = time.perf_counter()
    launches, steps = _progressive_steps(pr, params, [1 << 20])
    pr.block_until_ready()
    t2 = time.perf_counter()
    capped_rounds = pr.wave.rounds
    accum, counts = pr.snapshot()
    rays = (int(pr.wave.n_traced), int(pr.wave.n_shadow))
    r.reset()
    r.frame = seed
    r.step(params, spp=cap)
    want = r.state.accum.cpu().numpy()
    want_rays = (int(r.last_stats["n_traced"]), int(r.last_stats["n_shadow"]))
    log(f"[progressive] capped at {cap} spp, frame {seed}: setup "
        f"{t1 - t0:.2f} s, {capped_rounds} rounds in "
        f"{1e3 * (t2 - t1):.1f} ms, (path, shadow) rays {rays}; batch step "
        f"{r.last_stats['iterations']} rounds, {want_rays}; sums equal "
        f"{accum.tobytes() == want.tobytes()}")
    if not pr.done() or not (counts == cap).all():
        raise AssertionError(f"capped run: done {pr.done()}, counts "
                             f"{counts.min()}..{counts.max()}, not {cap}")
    if accum.tobytes() != want.tobytes() or rays != want_rays:
        raise AssertionError("capped progressive run differs from the batch "
                             f"step: rays {rays} vs {want_rays}")
    pr.reset()
    split_launches, calls = _progressive_steps(pr, params, range(1, 1 << 20))
    launches += split_launches
    steps += calls
    split = pr.snapshot()
    log(f"[progressive] split into calls of 1, 2, 3, ... rounds: "
        f"{pr.wave.rounds} rounds in {calls} calls, sums equal "
        f"{split[0].tobytes() == accum.tobytes()}, counts equal "
        f"{bool((split[1] == counts).all())}")
    if (split[0].tobytes() != accum.tobytes()
            or not (split[1] == counts).all() or pr.rays_traced() != sum(rays)
            or pr.wave.rounds != capped_rounds):
        raise AssertionError("the split run differs from the one-call run")
    del pr
    pu = ProgressiveRenderer(arrays, cfg=cfg, device=r.device)
    frames = []
    prev = np.zeros(n, np.int32)
    for i in range(sum(PROGRESSIVE_FRAMES)):
        if i == PROGRESSIVE_FRAMES[0]:
            pu.reset()
            acc0, prev = pu.snapshot()
            if acc0.any() or prev.any() or pu.rays_traced() != 0:
                raise AssertionError("reset() left samples or rays")
        tr0, sh0 = ((int(pu.wave.n_traced), int(pu.wave.n_shadow))
                    if pu.wave is not None else (0, 0))
        before = _counts()
        t0 = time.perf_counter()
        pu.step(params, PROGRESSIVE_ROUNDS)
        pu.block_until_ready()
        dt = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in _counts().items()}
        frame_launches = got["wave"]
        t1 = time.perf_counter()
        acc, cnt = pu.snapshot()
        snap_ms = 1e3 * (time.perf_counter() - t1)
        path = int(pu.wave.n_traced) - tr0
        shadow = int(pu.wave.n_shadow) - sh0
        f = dict(ms=1e3 * dt, snapshot_ms=snap_ms, launches=frame_launches,
                 mean_spp=float(cnt.mean()), min_spp=int(cnt.min()),
                 max_spp=int(cnt.max()), path=path, shadow=shadow,
                 mrays_per_s=(path + shadow) / dt / 1e6)
        frames.append(f)
        launches += frame_launches
        steps += 1  # one pu.step
        log(f"[progressive] unbounded frame {i + 1}: {f['ms']:.1f} ms "
            f"(snapshot {snap_ms:.1f} ms), {frame_launches} wave-kernel "
            f"launch for {PROGRESSIVE_ROUNDS} rounds, {got['lane_init']} lane "
            f"set-up, spp mean {f['mean_spp']!r} min {f['min_spp']} max "
            f"{f['max_spp']}, path rays {path}, shadow rays {shadow}, "
            f"{f['mrays_per_s']:.3f} Mrays/s")
        if (frame_launches != 1 or got["advances"] != 1 or got["walk"]
                or got["service"] or pu.done()):
            raise AssertionError(f"frame {i + 1}: launches {got} for "
                                 f"{PROGRESSIVE_ROUNDS} rounds in one step")
        if got["lane_init"] != (i in (0, PROGRESSIVE_FRAMES[0])):
            raise AssertionError(f"frame {i + 1}: {got['lane_init']} lane "
                                 "set-up launches: one a wave, in the first "
                                 "frame after a reset")
        if not (cnt >= prev).all() or not cnt.sum() > prev.sum():
            raise AssertionError(f"frame {i + 1}: a count fell or none grew")
        if not np.isfinite(acc).all() or not path > 0:
            raise AssertionError(f"frame {i + 1}: non-finite sums or no rays")
        prev = cnt
    if launches != steps:
        raise AssertionError(f"{launches} wave-kernel launches in {steps} "
                             "steps: a step is one launch")
    return dict(launches=launches, steps=steps, frames=frames,
                capped_rounds=capped_rounds)


def phase_tiled(r: Renderer, params) -> dict:
    """step_tiled(TILES) against step at full width, bit for bit, and the
    three image paths."""
    r.reset()
    r.step(params)
    want, want_stats = r.state.accum.clone(), r.last_stats
    r.reset()
    t0 = time.perf_counter()
    got = _launched(lambda: r.step_tiled(params, TILES))
    r.block_until_ready()
    dt = time.perf_counter() - t0
    launches = got["wave"]
    st = r.last_stats
    counts = [(int(x["n_traced"]), int(x["n_shadow"]), int(x["rows_fetched"]))
              for x in (want_stats, st)]
    equal = torch.equal(r.state.accum, want)
    img = r.image()
    off = int((r.image(on_device=False) != img).sum())
    log(f"[tiled] {TILES} tiles: {1e3 * dt:.1f} ms, {st['iterations']} rounds "
        f"({launches} wave-kernel and {got['lane_init']} lane set-up "
        f"launches; step: "
        f"{want_stats['iterations']}), "
        f"(path, shadow, rows) {counts[1]} vs step {counts[0]}; sums equal "
        f"{equal}; image bytes off the host tonemap {off}")
    if not equal or counts[0] != counts[1]:
        raise AssertionError("step_tiled differs from step")
    if launches != TILES or got["lane_init"] != TILES:
        raise AssertionError(f"{launches} wave-kernel and "
                             f"{got['lane_init']} lane set-up launches for "
                             f"{TILES} strips: a strip's wave is one of "
                             "each")
    if not np.array_equal(r.image(on_device=True), img):
        raise AssertionError("image(on_device=True) differs from image()")
    if off > MAX_BOUNDARY_SHARE * img.size:
        raise AssertionError(f"{off} image bytes off the host tonemap")
    return dict(launches=launches)


def phase_checkpoint(r: Renderer, params) -> None:
    """A step's state through a .npz checkpoint and back: the next step
    from the loaded state equals the step from the state itself."""
    cam = CameraController()
    r.reset()
    r.step(params)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_checkpoint(path, r.state, WIDTH, HEIGHT, camera=cam,
                        frame_seed=r.frame)
        r.step(params)
        want = r.state.accum.clone()
        state, w, h, frame_seed, cam2 = load_checkpoint(path)
        size = os.path.getsize(path)
    r.state, r.frame = state, frame_seed
    r.step(cam2.get_params(WIDTH, HEIGHT))
    equal = torch.equal(r.state.accum, want)
    log(f"[checkpoint] {size} B .npz, {w}x{h}, frame {frame_seed}, state on "
        f"{state.accum.device}; next step equal {equal}")
    if (w, h) != (WIDTH, HEIGHT) or state.accum.device.type != "cuda":
        raise AssertionError(f"loaded {w}x{h} on {state.accum.device}")
    if not equal or r.spp() != 2:
        raise AssertionError("the step after the round trip differs")


def write_icosphere_obj(path: str, subdiv: int = 5, uv: bool = False) -> int:
    """icosphere_mesh(subdiv) (unit radius) as an .obj with shared
    vertices, each float32 coordinate written so that it parses back
    exactly; with ``uv``, one spherical ``vt`` per vertex and faces
    ``f a/a b/b c/c``."""
    tris = np.stack(icosphere_mesh(subdiv), axis=1)      # [T, 3, 3]
    verts, faces = np.unique(tris.reshape(-1, 3), axis=0,
                             return_inverse=True)
    faces = faces.reshape(-1, 3) + 1
    with open(path, "w") as f:
        for v in verts.astype(np.float64).tolist():
            f.write(f"v {v[0]!r} {v[1]!r} {v[2]!r}\n")
        if uv:
            us = 0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi)
            vs = 0.5 - np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi
            for a, b in zip(us.tolist(), vs.tolist()):
                f.write(f"vt {a!r} {b!r}\n")
        for a, b, c in faces.tolist():
            f.write(f"f {a}/{a} {b}/{b} {c}/{c}\n" if uv
                    else f"f {a} {b} {c}\n")
    return int(faces.shape[0])


class _Advances:
    """The ``Wave.advance`` calls with work (the wave not done, a budget of
    at least one round) on a card, counted as a wrapper counts its
    launches: each is one wave-kernel launch (``count_advances``)."""

    launches = 0


def count_advances() -> None:
    """Wrap ``persistent.Wave.advance`` so that each call with work on a
    wave on a CUDA device adds one to ``_Advances.launches``; once a
    process (main)."""
    real = persistent.Wave.advance
    if getattr(real, "counted", False):
        return

    def advance(self, max_rounds=None):
        if (self.totals.is_cuda and not self.done
                and (max_rounds is None or max_rounds >= 1)):
            _Advances.launches += 1
        return real(self, max_rounds)

    advance.counted = True
    persistent.Wave.advance = advance


# The wrappers whose launches the phases count, by the name of their key
# in those phases' results, and the advances with work beside them.
COUNTED = dict(tonemap=tm.tonemap_cuda, fetch_chain=fetch.fetch_chain_cuda,
               walk=walk.quad_walk_cuda,
               threaded_walk=threaded.threaded_walk_cuda,
               service=service.service_pass_cuda,
               wave=wave.wave_advance_cuda,
               lane_init=lane_init.lane_init_cuda,
               bounce_rays=bounce.bounce_rays_cuda,
               bounce_shade=bounce.bounce_shade_cuda,
               bounce_nee=bounce.bounce_nee_cuda, advances=_Advances)
# The kernels among them.
KERNELS = ("tonemap", "fetch_chain", "walk", "threaded_walk", "service",
           "wave", "lane_init", "bounce_rays", "bounce_shade", "bounce_nee")


def _zero_counts() -> None:
    for wrapper in COUNTED.values():
        wrapper.launches = 0


def _counts() -> dict:
    return {name: wrapper.launches for name, wrapper in COUNTED.items()}


def _cli(argv: list) -> dict:
    """cli.main(argv) in this process: its stdout, host seconds and the
    kernels it launched (the counts set to 0 just before)."""
    _zero_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main({argv}) returned {rc}")
    return dict(stdout=out.getvalue().strip(), seconds=seconds, **_counts())


def phase_cli(tmp: str) -> dict:
    """``tpurt-torch render`` at 1200x800 on the Cornell box plus the
    icosphere loaded from an .obj: the PPM against a Renderer over the
    CLI's own scene stepped by hand, byte for byte; 2 + 2 frames through
    a checkpoint and --tiles against the plain run, bit for bit."""
    obj = os.path.join(tmp, "icosphere.obj")
    n_tris = write_icosphere_obj(obj)
    scene = ["--scene", "cornell-nomesh", "--obj", f"{obj}:15:50,20,50",
             "--width", str(WIDTH), "--height", str(HEIGHT)]
    path = lambda name: os.path.join(tmp, name)

    def render(name, frames, *extra):
        res = _cli(["render", *scene, "--frames", str(frames), "--out",
                    path(f"{name}.ppm"), "--checkpoint", path(f"{name}.npz"),
                    *extra])
        with np.load(path(f"{name}.npz")) as z:
            res["ck"] = {k: z[k] for k in z.files}
        res["ppm"] = load_ppm(path(f"{name}.ppm"))
        dt = float(re.search(r"spp, ([0-9.]+)s\)$", res["stdout"]).group(1))
        res["ms_per_frame"] = 1e3 * dt / frames
        if res["wave"] != res["advances"] or res["walk"] or res["service"]:
            raise AssertionError(f"[cli] {name}: {res['wave']} wave-kernel "
                                 f"launches for {res['advances']} advances, "
                                 f"{res['walk']} walk and {res['service']} "
                                 "service launches")
        log(f"[cli] {name}: {res['stdout']}; {res['ms_per_frame']:.1f} ms a "
            f"frame, {res['seconds']:.2f} s in all; launches: tonemap "
            f"{res['tonemap']}, fetch_chain {res['fetch_chain']}, wave "
            f"{res['wave']} ({res['advances']} advances), walk "
            f"{res['walk']}, service {res['service']}")
        return res

    plain = render("plain", CLI_FRAMES)
    args = cli.build_parser().parse_args(["render", *scene])
    arrays = cli.build_scene_arrays(args)
    r = Renderer(arrays, cfg=RenderConfig(width=WIDTH, height=HEIGHT, spp=1))
    params = CameraController().get_params(WIDTH, HEIGHT)
    rounds = 0
    before = _counts()
    for _ in range(CLI_FRAMES):
        r.step(params)
        rounds += r.last_stats["iterations"]
    hand = {k: v - before[k] for k, v in _counts().items()}
    want = r.image()
    host = tonemap_accum(plain["ck"]["accum"].reshape(HEIGHT, WIDTH, 3),
                         CLI_FRAMES)
    off = int((plain["ppm"] != host).sum())
    log(f"[cli] {arrays.num_objects} triangles ({n_tris} from the .obj); "
        f"PPM equal to the hand-driven Renderer's image "
        f"{plain['ppm'].tobytes() == want.tobytes()}, sums equal "
        f"{plain['ck']['accum'].tobytes() == r.state.accum.cpu().numpy().tobytes()}"
        f"; {off} of {host.size} bytes off the host tonemap_accum of its "
        f"checkpoint; {rounds} rounds and {hand['wave']} wave-kernel "
        f"launches in the hand-driven steps")
    if n_tris != 20480 or arrays.num_objects != 7 + n_tris:
        raise AssertionError(f"{arrays.num_objects} triangles in the scene")
    if plain["ppm"].tobytes() != want.tobytes():
        raise AssertionError("the CLI's image differs from the Renderer's")
    if plain["ck"]["accum"].tobytes() != r.state.accum.cpu().numpy().tobytes():
        raise AssertionError("the CLI's sums differ from the Renderer's")
    if (plain["tonemap"] != 1 or plain["wave"] != hand["wave"]
            or hand["wave"] != hand["advances"]):
        raise AssertionError(f"{plain['tonemap']} tonemap and "
                             f"{plain['wave']} wave-kernel launches; the "
                             f"hand-driven steps launched {hand}")
    if off > MAX_BOUNDARY_SHARE * host.size:
        raise AssertionError(f"{off} image bytes off the host tonemap")
    if not np.isfinite(plain["ck"]["accum"]).all() or not want.max() > 0:
        raise AssertionError("non-finite sums or a black image")
    del r
    first = render("first", CLI_FRAMES // 2)
    resumed = render("resumed", CLI_FRAMES - CLI_FRAMES // 2, "--resume",
                     path("first.npz"))
    tiled = render("tiled", CLI_FRAMES, "--tiles", str(TILES))
    for name, got in (("resumed", resumed), ("tiled", tiled)):
        same = (got["ppm"].tobytes() == plain["ppm"].tobytes()
                and all(got["ck"][k].tobytes() == plain["ck"][k].tobytes()
                        for k in ("accum", "spp", "frame_seed")))
        log(f"[cli] {name} equal to the plain run: {same}")
        if not same:
            raise AssertionError(f"the {name} render differs from the plain")
    runs = (plain, first, resumed, tiled)
    return dict({k: sum(x[k] for x in runs) for k in COUNTED},
                ms_per_frame=plain["ms_per_frame"],
                tiled_ms_per_frame=tiled["ms_per_frame"],
                offhost_bytes=off)


def phase_app(arrays, tmp: str) -> dict:
    """The batch App (APP_SCRIPT, checkpoints every APP_CHECKPOINT_EVERY
    frames) against a Renderer driven by hand, bit for bit; then the
    ProgressiveApp for PROGRESSIVE_TICKS ticks, a camera move on tick
    PROGRESSIVE_MOVE, with its round budget, render, snapshot and host
    ARGB packing timed tick by tick."""
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=1)
    ck = os.path.join(tmp, "app.npz")
    _zero_counts()
    t0 = time.perf_counter()
    app = App(arrays, cfg, input_source=ScriptedInput(APP_SCRIPT),
              out_dir=os.path.join(tmp, "app"),
              checkpoint_every=APP_CHECKPOINT_EVERY, checkpoint_path=ck)
    t1 = time.perf_counter()
    app.run()
    t2 = time.perf_counter()
    launches = _counts()
    cam = CameraController()
    r = Renderer(arrays, cfg=cfg)
    rounds = 0
    before = _counts()
    for i in range(len(APP_SCRIPT)):
        if i == 2:
            r.reset()
            cam.update(1.0, {"w"})
        r.step(cam.get_params(WIDTH, HEIGHT))
        rounds += r.last_stats["iterations"]
        if i == 3:
            at_checkpoint = r.state.accum.cpu().numpy()
    hand = {k: v - before[k] for k, v in _counts().items()}
    state, w, h, frame_seed, _ = load_checkpoint(ck)
    equal = torch.equal(app.renderer.state.accum, r.state.accum)
    ck_equal = state.accum.cpu().numpy().tobytes() == at_checkpoint.tobytes()
    log(f"[app] batch App: setup {t1 - t0:.2f} s, {len(APP_SCRIPT)} ticks in "
        f"{t2 - t1:.2f} s, {app.frames_displayed} frames displayed, "
        f"snapshots {len(app.snapshots)}; sums equal to the hand-driven "
        f"Renderer {equal}; last checkpoint frame {frame_seed}, spp "
        f"{state.spp}, equal {ck_equal}; launches: tonemap "
        f"{launches['tonemap']}, fetch_chain {launches['fetch_chain']}, wave"
        f" {launches['wave']}, walk {launches['walk']}, service "
        f"{launches['service']} ({rounds} rounds; the hand-driven steps "
        f"launched the wave kernel {hand['wave']} times)")
    if not equal or not ck_equal or (frame_seed, state.spp) != (3, 2):
        raise AssertionError("the App differs from the hand-driven Renderer")
    if len(app.snapshots) != 2 or app.frames_displayed < 1:
        raise AssertionError(f"{len(app.snapshots)} snapshots, "
                             f"{app.frames_displayed} frames displayed")
    if launches != dict(tonemap=0, fetch_chain=0, walk=0, threaded_walk=0,
                        service=0, wave=hand["wave"],
                        lane_init=hand["lane_init"],
                        **dict.fromkeys(BOUNCE_KERNELS, 0),
                        advances=hand["advances"]) or not hand["wave"]:
        raise AssertionError(f"launches {launches}; the hand-driven steps "
                             f"launched {hand}")
    del app, r

    script = [{}] * PROGRESSIVE_TICKS
    script[PROGRESSIVE_MOVE - 1] = {"keys": ["w"]}
    _zero_counts()
    papp = ProgressiveApp(arrays, RenderConfig(width=WIDTH, height=HEIGHT),
                          input_source=ScriptedInput(script),
                          out_dir=os.path.join(tmp, "papp"))
    pr = papp.renderer
    ticks, snaps, packs = [], [], []
    step, snapshot = pr.step, pr.snapshot
    pack = display_pipeline.tonemap_to_argb

    def timed_step(params, iters):
        t = time.perf_counter()
        step(params, iters)
        pr.block_until_ready()
        ticks.append(dict(rounds=int(iters), render_ms=1e3 * (
            time.perf_counter() - t), snapshot_ms=None, mean_spp=None))
        if len(ticks) in (PROGRESSIVE_MOVE - 1, PROGRESSIVE_MOVE):
            # Read on both sides of the move whether or not the pipeline
            # takes a frame; outside the tick's timed render.
            ticks[-1]["move_spp"] = float(snapshot()[1].mean())

    def timed_snapshot():
        t = time.perf_counter()
        out = snapshot()
        snaps.append((len(ticks) - 1, 1e3 * (time.perf_counter() - t),
                      float(out[1].mean())))
        return out

    def timed_pack(accum, frame):
        t = time.perf_counter()
        out = pack(accum, frame)
        packs.append(1e3 * (time.perf_counter() - t))
        return out

    pr.step, pr.snapshot = timed_step, timed_snapshot
    display_pipeline.tonemap_to_argb = timed_pack
    try:
        t0 = time.perf_counter()
        papp.run()
        seconds = time.perf_counter() - t0
    finally:
        display_pipeline.tonemap_to_argb = pack
    plaunches = _counts()
    # The last snapshot is the exit snapshot's; the others are the ticks'.
    for i, ms, mean in snaps[:-1]:
        ticks[i].update(snapshot_ms=ms, mean_spp=mean)
    for i, t in enumerate(ticks):
        log(f"[app] progressive tick {i + 1}: budget {t['rounds']} rounds, "
            f"render {t['render_ms']:.1f} ms, "
            + (f"snapshot {t['snapshot_ms']:.1f} ms, mean spp "
               f"{t['mean_spp']!r}" if t["snapshot_ms"] is not None
               else "no snapshot (pipeline busy: frame dropped)"))
    dropped = sum(t["snapshot_ms"] is None for t in ticks)
    log(f"[app] ProgressiveApp: {len(ticks)} ticks in {seconds:.2f} s, "
        f"{papp.frames_displayed} frames displayed, {dropped} dropped; host "
        f"ARGB packing {len(packs)} x {np.mean(packs):.2f} ms (min "
        f"{min(packs):.2f}, max {max(packs):.2f}); launches {plaunches} for "
        f"{sum(t['rounds'] for t in ticks)} rounds in {len(ticks)} steps")
    if len(ticks) != PROGRESSIVE_TICKS or plaunches != dict(
            tonemap=0, fetch_chain=0, walk=0, threaded_walk=0, service=0,
            wave=len(ticks), lane_init=2, **dict.fromkeys(BOUNCE_KERNELS, 0),
            advances=len(ticks)):
        raise AssertionError("a tick is one step, a step one wave-kernel "
                             "launch, and the two waves (the first tick's "
                             "and the camera move's) one lane set-up each")
    if not all(4 <= t["rounds"] <= 4096 for t in ticks) or not packs:
        raise AssertionError("budget out of [4, 4096] or nothing displayed")
    before, after = (ticks[PROGRESSIVE_MOVE - 2]["move_spp"],
                     ticks[PROGRESSIVE_MOVE - 1]["move_spp"])
    log(f"[app] mean spp after tick {PROGRESSIVE_MOVE - 1} {before!r}, "
        f"after tick {PROGRESSIVE_MOVE} (the camera move) {after!r}")
    if not after < before:
        raise AssertionError("the camera move did not restart the wave")
    return dict({k: launches[k] + plaunches[k] for k in COUNTED}, ticks=ticks,
                pack_ms=packs, dropped=dropped,
                displayed=papp.frames_displayed)


def phase_bench() -> dict:
    """benchmarks.py: cube256 against the oracle, the interactive config
    and the progressive interactive config."""
    _zero_counts()
    t0 = time.perf_counter()
    cube = benchmarks.run_config("cube256")
    t1 = time.perf_counter()
    batch = benchmarks.run_config("interactive", frames=3)
    prog = benchmarks.run_progressive("interactive", frames=5)
    launches = _counts()
    for rec in (cube, batch, prog):
        log(f"[bench] {json.dumps(rec)}")
    log(f"[bench] cube256 with its oracle check {t1 - t0:.1f} s; launches: "
        f"tonemap {launches['tonemap']}, fetch_chain "
        f"{launches['fetch_chain']}, wave {launches['wave']} "
        f"({launches['advances']} advances), walk {launches['walk']}, "
        f"service {launches['service']}")
    if not cube["mse_vs_oracle"] < ORACLE_MSE:
        raise AssertionError(f"cube256 MSE {cube['mse_vs_oracle']!r} vs the "
                             "oracle")
    for rec in (cube, batch, prog):
        if not rec["mrays_per_s"] > 0 or rec["device"] != (
                torch.cuda.get_device_name(0)):
            raise AssertionError(f"bad record {rec}")
    if not prog["spp_per_frame"] > 0 or launches["wave"] < 1:
        raise AssertionError("the progressive bench did not advance")
    if (launches["wave"] != launches["advances"] or launches["walk"]
            or launches["service"] or launches["threaded_walk"]):
        raise AssertionError(f"bench launches {launches}: an advance is one "
                             "wave-kernel launch")
    return dict(launches, records=[cube, batch, prog])


def _feature_scene(tmp: str, kind: str):
    """A small scene for the card-against-CPU and oracle checks of
    [features]: the Cornell box and a subdivision-SMALL_SUBDIV icosphere
    with UVs from an .obj (loaded as ``tpurt-torch --uv`` does: texture
    slot 0, the loader's vertex normals); "lights" adds 16 small
    emitters under the ceiling (17 lights), "big_texture" a 512x512
    checker (4.9 MB of tile rows).  Returns (arrays, config fields)."""
    obj = os.path.join(tmp, "small_uv.obj")
    if not os.path.exists(obj):
        write_icosphere_obj(obj, SMALL_SUBDIV, uv=True)
    scene = create_cornell_box(mesh=None)
    load_obj(obj, scene.objects, offset=(50.0, 25.0, 60.0), scale=20.0,
             parse_uv=True, tex_id=0)
    if kind == "lights":
        _add_small_lights(scene)
    tex = checker_texture(512 if kind == "big_texture" else 64)
    arrays = flatten_scene(scene, textures=[tex])
    return arrays, SMALL_FEATURES[kind]


def _add_small_lights(scene) -> None:
    """16 small emitters under the ceiling (17 lights with the box's)."""
    for i in range(16):
        x = 10.0 + 4 * i
        scene.objects.append(Object(
            v0=(x, 99.0, 40), v1=(x + 2, 99.0, 40), v2=(x + 1, 99.0, 42),
            emission=(5.0, 5.0, 5.0)))


def all_features_arrays(tmp: str):
    """The [features] path's scene (the Cornell box and an icosphere(5)
    with UVs on texture slot 0, from an .obj, checker 256) with 16 small
    emitters under the ceiling: 17 lights."""
    obj = os.path.join(tmp, "icosphere_uv.obj")
    if not os.path.exists(obj):
        write_icosphere_obj(obj, 5, uv=True)
    scene = create_cornell_box(mesh=None)
    load_obj(obj, scene.objects, offset=(50.0, 20.0, 50.0), scale=15.0,
             parse_uv=True, tex_id=0)
    _add_small_lights(scene)
    return flatten_scene(scene, textures=[checker_texture(256)])


def _small_feature_checks(tmp: str) -> dict:
    """Each feature alone at SMALL_W x SMALL_H: the card's Renderer
    against the CPU's, bit for bit, sums and ray counts, and both against
    the port's copy of the NumPy oracle (MSE < ORACLE_MSE)."""
    w, h = SMALL_W, SMALL_H
    params = CameraController().get_params(w, h)
    out = {}
    for kind in SMALL_FEATURES:
        arrays, knobs = _feature_scene(tmp, kind)
        cfg = RenderConfig(width=w, height=h, spp=1, **knobs)
        got = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            r = Renderer(arrays, cfg=cfg, device=dev)
            r.step(params)
            st = r.last_stats
            got[dev] = (r.accum_host().reshape(-1, 3),
                        (int(st["n_traced"]), int(st["n_shadow"]),
                         int(st["rows_fetched"])),
                        time.perf_counter() - t0)
        t0 = time.perf_counter()
        ora = oracle_render(arrays, params, w, h, frame_seed=1, cfg=cfg)
        t_ora = time.perf_counter() - t0
        card, cpu = got["cuda"][0], got["cpu"][0]
        mse = float(((card - ora) ** 2).mean())
        n_off = int((card != cpu).sum())
        tile_mb = (r.inline.table.shape[0] - r.inline.tex0) * TEX_ROW * 4 / 2**20
        log(f"[features] {kind} ({knobs}) at {w}x{h}: {arrays.num_objects} "
            f"triangles, {arrays.num_lights} lights, leaf {r.scene.leaf_fmt}"
            f" x{r.scene.leaf_size}, {tile_mb:.2f} MiB of tile rows; card vs "
            f"CPU {n_off} of {card.size} sum floats differ, (path, shadow, "
            f"rows) card {got['cuda'][1]} CPU {got['cpu'][1]}; MSE vs the "
            f"oracle {mse!r}; seconds card {got['cuda'][2]:.2f} CPU "
            f"{got['cpu'][2]:.2f} oracle {t_ora:.2f}")
        if card.tobytes() != cpu.tobytes() or got["cuda"][1] != got["cpu"][1]:
            raise AssertionError(f"[features] {kind}: the card differs from "
                                 "the CPU")
        if not np.isfinite(card).all() or not card.mean() > 0:
            raise AssertionError(f"[features] {kind}: non-finite or black")
        if not mse < ORACLE_MSE:
            raise AssertionError(f"[features] {kind}: MSE {mse} vs the oracle")
        if kind == "big_texture" and not tile_mb > 2:
            raise AssertionError(f"{tile_mb} MiB of tile rows")
        if kind == "lights" and arrays.num_lights != 17:
            raise AssertionError(f"{arrays.num_lights} lights")
        out[kind] = dict(mse_vs_oracle=mse)
    return out


def features_scene_args(tmp: str) -> tuple:
    """The ``tpurt-torch render`` scene arguments of [features] (the
    Cornell box and an icosphere(5) with UVs written to an .obj in
    ``tmp``; smooth shading, UV mapping, "mt" leaves, SBVH) and the
    icosphere's triangles."""
    obj = os.path.join(tmp, "icosphere_uv.obj")
    n_tris = write_icosphere_obj(obj, 5, uv=True)
    return ["--scene", "cornell", "--obj", f"{obj}:15:50,20,50",
            "--smooth", "--uv", "--leaf-isect", "mt", "--bvh-method",
            "sbvh", "--width", str(WIDTH), "--height", str(HEIGHT)], n_tris


def phase_features(r: Renderer, params, tmp: str) -> dict:
    """The features past the default path.
      - ``tpurt-torch render --scene cornell --obj <icosphere(5) with UVs>
        --smooth --uv --leaf-isect mt --bvh-method sbvh`` at full width,
        FEATURE_FRAMES frames, held byte for byte (PPM and sums) to a
        Renderer over the CLI's scene stepped by hand;
      - the main path's scene built as an SBVH (at its leaf size),
        bit-identical to its SAH step;
      - a refit after a seed-made displacement of the icosphere against
        a fresh build of the moved scene (MSE < ORACLE_MSE, equal rays);
      - each feature alone at SMALL_W x SMALL_H, card against CPU bit for
        bit and against the port's oracle.
    Every kernel's launches are counted over the phase.  Returns its
    numbers and the hand-driven Renderer, whose walk-order table [walk]
    checks."""
    _zero_counts()
    t_phase = time.perf_counter()
    scene, n_tris = features_scene_args(tmp)
    ppm, npz = os.path.join(tmp, "features.ppm"), os.path.join(tmp, "f.npz")
    res = _cli(["render", *scene, "--frames", str(FEATURE_FRAMES), "--out",
                ppm, "--checkpoint", npz])
    cli_counts = {k: res[k] for k in COUNTED}
    dt = float(re.search(r"spp, ([0-9.]+)s\)$", res["stdout"]).group(1))
    with np.load(npz) as z:
        sums = z["accum"]
    arrays = cli.build_scene_arrays(
        cli.build_parser().parse_args(["render", *scene]))
    mesh = arrays.uv_mask > 0
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=1, **FEATURE_CFG)
    t0 = time.perf_counter()
    rf = Renderer(arrays, cfg=cfg)
    setup = time.perf_counter() - t0
    rounds, path, shadow = 0, 0, 0
    before = _counts()
    for _ in range(FEATURE_FRAMES):
        rf.step(params)
        st = rf.last_stats
        rounds += st["iterations"]
        path += int(st["n_traced"])
        shadow += int(st["n_shadow"])
    hand = {k: v - before[k] for k, v in _counts().items()}
    img = rf.image()
    same_ppm = load_ppm(ppm).tobytes() == img.tobytes()
    same_sums = sums.tobytes() == rf.state.accum.cpu().numpy().tobytes()
    log(f"[features] render {' '.join(scene[:3])} icosphere_uv.obj "
        f"({n_tris} triangles, {int(mesh.sum())} with UVs on texture slot 0"
        f") --smooth --uv --leaf-isect mt --bvh-method sbvh at "
        f"{WIDTH}x{HEIGHT}: {1e3 * dt / FEATURE_FRAMES:.1f} ms a frame, "
        f"{res['seconds']:.2f} s in all; leaf {rf.scene.leaf_fmt} x"
        f"{rf.scene.leaf_size}, {rf.scene.quad_table.shape[0]} quad rows, "
        f"walk rows of {rf.inline.walk.shape[1]} floats, {rf.bvh.perm.size} "
        f"references; hand-driven setup {setup:.2f} s, {rounds} rounds, "
        f"path rays {path}, shadow rays {shadow}; launches: wave "
        f"{cli_counts['wave']} (hand-driven {hand['wave']}), walk "
        f"{cli_counts['walk']}, service {cli_counts['service']}, tonemap "
        f"{cli_counts['tonemap']}, fetch_chain {cli_counts['fetch_chain']};"
        f" PPM equal {same_ppm}, sums equal {same_sums}")
    if n_tris != 20480 or int(mesh.sum()) != n_tris or not (
            arrays.tex_id[mesh] == 0).all():
        raise AssertionError("the icosphere's triangles do not all carry UVs "
                             "on texture slot 0")
    if not same_ppm or not same_sums:
        raise AssertionError("the features render differs from the Renderer")
    if (cli_counts["wave"] != hand["wave"]
            or hand["wave"] != hand["advances"] or not hand["wave"]
            or cli_counts["walk"] or cli_counts["service"] or hand["walk"]
            or hand["service"] or cli_counts["tonemap"] != 1
            or cli_counts["fetch_chain"]):
        raise AssertionError(f"launches {cli_counts}; the hand-driven steps "
                             f"launched {hand}")
    if rf.scene.leaf_fmt != "mt" or not np.isfinite(sums).all():
        raise AssertionError("not an mt render, or non-finite sums")

    # SBVH against SAH on the main path's scene.
    main_arrays = main_path_arrays()
    r.reset()
    r.step(params)
    sah, sah_stats = r.state.accum.cpu().numpy(), r.last_stats
    t0 = time.perf_counter()
    rs = Renderer(main_arrays, cfg=RenderConfig(
        width=WIDTH, height=HEIGHT, spp=1, bvh_method="sbvh",
        bvh_leaf_size=r.scene.leaf_size))
    sbvh_setup = time.perf_counter() - t0
    rs.step(params)
    sbvh_equal = sah.tobytes() == rs.state.accum.cpu().numpy().tobytes()
    counts = [(int(x["n_traced"]), int(x["n_shadow"]), int(x["rows_fetched"]),
               x["iterations"]) for x in (sah_stats, rs.last_stats)]
    log(f"[features] SBVH of the main path (leaf {rs.scene.leaf_size}): "
        f"build and upload {sbvh_setup:.2f} s, {rs.bvh.perm.size} references"
        f" for {main_arrays.num_objects} triangles, "
        f"{rs.scene.quad_table.shape[0]} quad rows (SAH "
        f"{r.scene.quad_table.shape[0]}); (path, shadow, rows, rounds) SBVH "
        f"{counts[1]} SAH {counts[0]}; sums bit-identical {sbvh_equal}")
    if not sbvh_equal or counts[0][:2] != counts[1][:2]:
        raise AssertionError("the SBVH render differs from the SAH render")
    del rs

    # Refit against a fresh build of the moved scene.
    ico = np.arange(main_arrays.num_objects) >= main_arrays.num_objects - n_tris
    moved = dataclasses.replace(main_arrays)
    rng = np.random.RandomState(REFIT_SEED)
    for name in ("tri_v0", "tri_v1", "tri_v2"):
        v = getattr(main_arrays, name).copy()
        v[ico] += rng.normal(0.0, REFIT_SIGMA, (int(ico.sum()), 3)).astype(
            np.float32)
        setattr(moved, name, v)
    main_cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=1)
    rr = Renderer(main_arrays, cfg=main_cfg)
    rr.step(params)
    t0 = time.perf_counter()
    rr.refit(moved)
    rr.block_until_ready()
    refit_s = time.perf_counter() - t0
    rr.step(params)
    t0 = time.perf_counter()
    fresh = Renderer(moved, cfg=main_cfg)
    fresh.block_until_ready()
    fresh_s = time.perf_counter() - t0
    fresh.step(params)
    a, b = rr.state.accum.cpu().numpy(), fresh.state.accum.cpu().numpy()
    refit_mse = float(((a - b) ** 2).mean())
    rays = [(int(x.last_stats["n_traced"]), int(x.last_stats["n_shadow"]))
            for x in (rr, fresh)]
    log(f"[features] refit after moving {int(ico.sum())} triangles (seed "
        f"{REFIT_SEED}, sigma {REFIT_SIGMA}): refit {refit_s:.3f} s against "
        f"a fresh build's setup {fresh_s:.3f} s; step vs the fresh build's: "
        f"MSE {refit_mse!r}, bit-equal {a.tobytes() == b.tobytes()}, "
        f"(path, shadow) refit {rays[0]} fresh {rays[1]}")
    if not refit_mse < ORACLE_MSE or rays[0] != rays[1]:
        raise AssertionError("the refit step differs from the fresh build's")
    del rr, fresh

    small = _small_feature_checks(tmp)
    launches = _counts()
    seconds = time.perf_counter() - t_phase
    mt_wave = cli_counts["wave"] + hand["wave"]
    log(f"[features] {seconds:.1f} s in all; launches: tonemap "
        f"{launches['tonemap']}, fetch_chain {launches['fetch_chain']}, wave "
        f"{launches['wave']} (mt leaves {mt_wave}; {launches['advances']} "
        f"advances), walk {launches['walk']}, service {launches['service']}")
    if (launches["wave"] != launches["advances"] or launches["walk"]
            or launches["service"]):
        raise AssertionError(f"[features] launches {launches}: an advance "
                             "is one wave-kernel launch")
    return dict(launches, mt_wave=mt_wave,
                ms_per_frame=1e3 * dt / FEATURE_FRAMES, refit_s=refit_s,
                fresh_setup_s=fresh_s, small=small, seconds=seconds), rf


# -- [wave]: the wave kernel against the two-kernel round loop ---------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits (float32 as int32), for bit-for-bit comparison."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _copy(s) -> dict:
    return {key: val.clone() for key, val in s.items()}


def state_bytes_once(s, textured: bool) -> int:
    """Bytes of lane state a wave's whole advance must move at least: the
    fields of ops/service.py FIELDS of every lane not DONE, read once and
    written once (pix only read; tstash only with textures), and the mode
    of every DONE lane."""
    per_lane = sum(torch.empty((), dtype=dtype).element_size() * cols
                   for name, dtype, cols in service.FIELDS
                   if textured or name != "tstash")
    live = int((s["mode"] != walk.DONE).sum())
    return (2 * per_lane - 8) * live + 8 * (s["mode"].numel() - live)


def longest_quad_walk(s, r: Renderer, passes: int, lane_rows=None) -> tuple:
    """(rows, longest): the rows that the walks of state ``s`` fetch and
    its longest walk in rows, by the plain walk (walk_index, walk_step)
    over the walking lanes alone (the lanes are independent): one fetch
    of every walking lane's row a step, so the steps are the longest
    walk.  Adds each lane's rows to ``lane_rows`` (int [lanes]) when
    given.  ``s`` is left as it was."""
    mode = s["mode"]
    lanes = torch.nonzero((mode == walk.TRAVERSE) | (mode == walk.SHADOW))
    sub = {key: val[lanes[:, 0]] for key, val in s.items()}
    table, sentinel = r.inline.walk, r.inline.sentinel
    rows = steps = 0
    while True:
        idx, stepping = walk.walk_index(sub, sentinel)
        n = int(stepping.sum())
        if n == 0:
            return rows, steps
        if lane_rows is not None:
            lane_rows.index_add_(0, lanes[:, 0],
                                 stepping.to(lane_rows.dtype))
        rows += n
        steps += 1
        sub = walk.walk_step(sub, table[idx], sentinel, r.scene.leaf_size,
                             passes, fmt=r.scene.leaf_fmt)


def two_kernel_rounds(r: Renderer, fr, s, totals, rows, budget,
                      rounds_before: int, work=None,
                      lane_rows=False) -> tuple:
    """The two-kernel round loop on the card as ``Wave.advance`` runs it
    with ``round_fn=_round_quad``, but without compaction: each round one
    quad_walk_cuda launch (every lane's walk to its end), then one
    service_pass_cuda launch; while a lane is live and at most ``budget``
    rounds (None: no budget).  Updates ``totals`` and ``rows``; returns
    (state, rounds run, lanes live).  With ``work`` (a list), each round
    appends what [walk] and [service] count for their bounds: the walk's
    rows, its longest walk (longest_quad_walk, which must fetch the same
    rows) and state bytes (walk_state_bytes), the pass's bytes
    (service_state_bytes) and double calls (service_work), and the
    triangles and tile rows the pass reads, and the lanes it leaves
    live; with ``lane_rows`` also each lane's walk rows (int32 [lanes])."""
    inline = r.inline
    passes = max(1, r.cfg.quad_redirect_passes)
    ran = 0
    live = int((s["mode"] != walk.DONE).sum())
    while live and (budget is None or ran < budget):
        modes = torch.bincount(s["mode"], minlength=walk.TEXG + 1).tolist()
        walked, n = walk.quad_walk_cuda(s, inline.walk, inline.sentinel,
                                        r.scene.leaf_size, passes,
                                        inline.walk_levels,
                                        fmt=r.scene.leaf_fmt)
        rows += n
        if work is not None:
            per = (torch.zeros(s["mode"].shape, dtype=torch.int32,
                               device=s["mode"].device) if lane_rows else None)
            plain_rows, longest = longest_quad_walk(s, r, passes, per)
            if plain_rows != int(n):
                raise AssertionError(f"[wave] the plain walks fetch "
                                     f"{plain_rows} rows, the kernel {int(n)}")
            want, _, sw = service_work(walked, fr)
            mode = walked["mode"]
            shadeg = (mode == walk.SHADEG) & (walked["hit_id"] >= 0)
            work.append(dict(
                walk_rows=int(n), longest_walk=longest,
                walk_bytes=walk_state_bytes(
                    modes[walk.TRAVERSE], modes[walk.SHADOW],
                    mode.numel() - modes[walk.TRAVERSE] - modes[walk.SHADOW]),
                service_bytes=service_state_bytes(walked, want, fr.service),
                calls=sw["calls"],
                hits=torch.unique(walked["hit_id"][shadeg]),
                tiles=torch.unique(walked["cur"][mode == walk.TEXG]),
                lane_rows=per))
        slot = (rounds_before + ran) % 2
        s = service.service_pass_cuda(walked, inline, fr.service, totals,
                                      slot)
        live = int(totals[service.LIVE + slot])
        if work is not None:
            work[-1]["live"] = live
        ran += 1
    return s, ran, live


def wave_bound(s0, work, r: Renderer, fr, latency_ns: float) -> dict:
    """Three bounds of the main step's wave kernel.  ``bound_ms``: the
    least time the card could take for the step's work, the larger of
    its bytes (every lane's state read and written once,
    state_bytes_once; the walk-order rows once; each triangle's trimat
    row and each tile row the services read, once) over the memory rate
    and its operations (the walks' float32 work, 120 a row as [walk]
    counts it; the services' FP64 instructions as [service] counts them)
    over their rates.  ``rounds_bound_ms``: the sum over the step's
    rounds of the walk's and the service's bounds as [walk] and
    [service] state them, the bound of the two-kernel round loop.
    ``latency_floor_ms``: the sum over the rounds of each round's
    longest walk times ``latency_ns``, one warp's dependent fetch step
    ([fetch]): the least time of rounds that each end on their longest
    walk."""
    inline = r.inline
    table_bytes = inline.sentinel * inline.walk.shape[1] * 4
    per = fp64_per_call()
    rounds_ms = 0.0
    rows = fp64 = 0
    for rnd in work:
        rounds_ms += bound(table_bytes + rnd["walk_bytes"],
                           120 * rnd["walk_rows"])["bound_ms"]
        sb = service_bound(rnd["service_bytes"], rnd["calls"])
        rounds_ms += sb["bound_ms"]
        rows += rnd["walk_rows"]
        fp64 += sb["fp64_instructions"]
    hits = torch.unique(torch.cat([rnd["hits"] for rnd in work]))
    tiles = torch.unique(torch.cat([rnd["tiles"] for rnd in work]))
    n_bytes = (state_bytes_once(s0, inline.tex0 is not None) + table_bytes
               + 148 * hits.numel() + 48 * tiles.numel()
               + fr.service.lights.numel() * 4
               + fr.service.metas.numel() * 8 + 8 * len(service.TOTALS))
    bytes_ms = 1e3 * n_bytes / MEM_BYTES_PER_S
    f32_ms = 1e3 * 120 * rows / F32_FLOP_PER_S
    fp64_ms = 1e3 * 2 * fp64 / F64_FLOP_PER_S
    larger = max(bytes_ms, f32_ms, fp64_ms)
    floor_ms = sum(rnd["longest_walk"] for rnd in work) * latency_ns * 1e-6
    return dict(bound_ms=larger, latency_floor_ms=floor_ms,
                longest_walks=[rnd["longest_walk"] for rnd in work],
                latency_ns=latency_ns,
                bound_by="bytes" if bytes_ms == larger else "operations",
                bytes_ms=bytes_ms, f32_ms=f32_ms, fp64_ms=fp64_ms,
                bound_bytes=n_bytes, rounds_bound_ms=rounds_ms,
                rows_fetched=rows, fp64_instructions=fp64)


def _check_wave(label: str, r: Renderer, fr, s0, budgets, work=None,
                one_call: int | None = None) -> dict:
    """The wave kernel (wave_advance_cuda, one launch a call) and the
    two-kernel round loop, each on a copy of state ``s0``, in calls of
    ``budgets`` rounds: after every call each state field, the four
    totals, the rows and the rounds and live lanes must be equal bit for
    bit.  With ``one_call``, a third copy advanced by one call of that
    many rounds must equal the calls' end.  Returns the counts."""
    inline = r.inline
    n = s0["mode"].shape[0]
    passes = max(1, r.cfg.quad_redirect_passes)
    new_totals = lambda: torch.tensor([n, 0, 0, 0], dtype=torch.int64,
                                      device=r.device)
    new_rows = lambda: torch.zeros((), dtype=torch.int64, device=r.device)
    kern, k_tot, k_rows = _copy(s0), new_totals(), new_rows()
    ref, r_tot, r_rows = _copy(s0), new_totals(), new_rows()
    advance = lambda s, t, rw, budget, before: wave.wave_advance_cuda(
        s, inline, fr.service, t, rw, budget, k=r.scene.leaf_size,
        fmt=r.scene.leaf_fmt, passes=passes, rounds_before=before)
    done, calls = 0, []
    for budget in budgets:
        before = wave.wave_advance_cuda.launches
        ran, live = advance(kern, k_tot, k_rows, budget, done)
        if wave.wave_advance_cuda.launches != before + 1:
            raise AssertionError(f"[wave] {label}: a call launched "
                                 f"{wave.wave_advance_cuda.launches - before}")
        ref, ref_ran, ref_live = two_kernel_rounds(
            r, fr, ref, r_tot, r_rows, budget, done, work)
        done += ran
        bad = [key for key in kern if not torch.equal(_bits(kern[key]),
                                                      _bits(ref[key]))]
        same = (not bad and (ran, live) == (ref_ran, ref_live)
                and k_tot.tolist() == r_tot.tolist()
                and int(k_rows) == int(r_rows))
        calls.append(dict(budget=budget, rounds=ran, live=live,
                          totals=k_tot.tolist(), rows=int(k_rows)))
        log(f"[wave] {label}, a call of {budget or 'all'} rounds: kernel "
            f"{ran} rounds, {live} lanes live, totals {k_tot.tolist()}, rows "
            f"{int(k_rows)}; round loop {ref_ran}, {ref_live}, "
            f"{r_tot.tolist()}, {int(r_rows)}; fields not bit-equal {bad}")
        if not same:
            raise AssertionError(f"[wave] {label}: the kernel differs from "
                                 f"the two-kernel round loop")
    if one_call is not None:
        one, o_tot, o_rows = _copy(s0), new_totals(), new_rows()
        ran, live = advance(one, o_tot, o_rows, one_call, 0)
        bad = [key for key in kern if not torch.equal(_bits(kern[key]),
                                                      _bits(one[key]))]
        log(f"[wave] {label}: one call of {one_call} rounds: {ran} rounds, "
            f"{live} live, totals {o_tot.tolist()}, rows {int(o_rows)}; "
            f"fields not bit-equal to the calls' {bad}")
        if (bad or (ran, live) != (done, calls[-1]["live"])
                or o_tot.tolist() != k_tot.tolist()
                or int(o_rows) != int(k_rows)):
            raise AssertionError(f"[wave] {label}: the calls differ from one "
                                 "call")
    return dict(lanes=n, rounds=done, calls=calls, state=kern)


def phase_wave(r: Renderer, features_r: Renderer, params, tmp: str,
               latency_ns: float) -> dict:
    """The wave kernel against the two-kernel round loop on the card, bit
    for bit (_check_wave), on the main path's 1200x800 1-spp step (and
    against its plain version, wave_advance_plain, field for field), on a
    progressive wave (unbounded cap) in calls of 1, 3 and 8 rounds
    against one call of 12, on the main step in calls that end before,
    at and inside the switch to the kernel's sparse tail against one
    call, on strip 2 of a TILES-strip tiled step, on
    the [features] path's renderer ("mt" leaves, SBVH, smooth normals,
    UVs, textures) and on a 1200x800 frame with "mt" leaves, smooth
    normals, UVs, textures, 17 lights and two trimat rows a table row (a
    median build at leaf 10).  Then the kernel's own time and its
    wrapper's on the main step, its plain version's, its bounds
    (wave_bound; ``latency_ns`` is [fetch]'s one-warp dependent step) and
    its builds."""
    out = dict(cases={})
    cam = params.to(r.device)
    n = WIDTH * HEIGHT
    # The main step.
    fr, s0 = service_frame(r, params)
    work = []
    res = _check_wave("main step", r, fr, s0, [None], work)
    out["cases"]["main"] = {k: v for k, v in res.items() if k != "state"}
    # Its plain version on the card, field for field (-0.0 == 0.0; the
    # skip registers stay in the kernel's threads).
    plain, p_tot = _copy(s0), torch.tensor([n, 0, 0, 0], device=r.device)
    p_rows = torch.zeros((), dtype=torch.int64, device=r.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ran, live = wave.wave_advance_plain(
        plain, r.inline, fr, p_tot, p_rows,
        passes=max(1, r.cfg.quad_redirect_passes))
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    got = res["state"]
    fields = [f for f in got if f not in ("reg_e", "reg_s")]
    bad = [f for f in fields if not _same(got[f], plain[f])]
    err = max(float((got[f].double() - plain[f].double()).abs()
                    .nan_to_num(0.0).max()) for f in fields)
    log(f"[wave] main step against wave_advance_plain: {ran} rounds, {live} "
        f"live, totals {p_tot.tolist()}, rows {int(p_rows)} in {plain_ms:.1f}"
        f" ms; fields differing {bad} (-0.0 == 0.0, NaN == NaN), max abs err "
        f"{err!r}")
    if (bad or (ran, live) != (res["rounds"], 0)
            or p_tot.tolist() != res["calls"][-1]["totals"]
            or int(p_rows) != res["calls"][-1]["rows"]):
        raise AssertionError("[wave] the kernel differs from its plain "
                             "version on the main step")
    del plain, got, res
    # The main step in calls that end in the grid-wide rounds, at the
    # switch to the sparse tail (the last grid-wide round before it) and
    # inside the tail (a call's first round is grid-wide, over every
    # lane), then the rest, against one call.
    tail_lanes = wave.wave_advance_cuda.plan["tail_lanes"]
    switch = next((i + 1 for i, rnd in enumerate(work)
                   if rnd["live"] <= tail_lanes), None)
    if switch is not None and switch > 2:
        budgets = [switch - 2, 2, 3, None]
    else:
        budgets = [5, 10, 20, None]
    log(f"[wave] main step: tail at <= {tail_lanes} live lanes, after round "
        f"{switch} of {len(work)} (live lanes a round "
        f"{[rnd['live'] for rnd in work]}); calls of {budgets}")
    res = _check_wave("main step in calls", r, fr, s0, budgets,
                      one_call=len(work))
    out["cases"]["main in calls"] = dict(
        {k: v for k, v in res.items() if k != "state"}, switch=switch,
        tail_lanes=tail_lanes)
    del res
    # A progressive wave: unbounded cap, the progressive renderer's seeds.
    pfr = persistent._Frame(r.scene, r.inline, r.cfg, cam, 0, WIDTH, HEIGHT,
                            UNBOUNDED_SPP, 1)
    pfr.service = service.service_params(pfr)
    ps = persistent.init_lane_ctx(0, 1, torch.arange(n, device=r.device),
                                  cam, WIDTH, HEIGHT, r.cfg,
                                  with_tstash=r.inline.tex0 is not None)
    res = _check_wave("progressive", r, pfr, ps, [1, 3, 8], one_call=12)
    out["cases"]["progressive"] = {k: v for k, v in res.items()
                                   if k != "state"}
    # A tiled step's second strip.
    span = -(-n // TILES)
    strip = torch.arange(span, 2 * span, device=r.device)
    tfr = persistent._Frame(r.scene, r.inline, r.cfg, cam, 1, WIDTH, HEIGHT,
                            1, 1)
    tfr.service = service.service_params(tfr)
    ts = persistent.init_lane_ctx(1, 1, strip, cam, WIDTH, HEIGHT, r.cfg,
                                  with_tstash=r.inline.tex0 is not None)
    res = _check_wave("tiled strip 2", r, tfr, ts, [None])
    out["cases"]["tiled"] = {k: v for k, v in res.items() if k != "state"}
    # The features: the [features] path's renderer (SBVH), and the other
    # features at once with 17 lights and two trimat rows a table row: a
    # median build at leaf 10, whose "mt" quad rows are 100 floats (SAH
    # and SBVH leaves on this mesh hold at most 6 triangles, 64 floats).
    rall = Renderer(all_features_arrays(tmp), cfg=RenderConfig(
        width=WIDTH, height=HEIGHT, spp=1, bvh_leaf_size=10,
        **dict(FEATURE_CFG, bvh_method="median")))
    if (rall.scene.num_lights != 17 or rall.inline.pack != 2
            or rall.scene.leaf_fmt != "mt" or rall.inline.tex0 is None):
        raise AssertionError(f"{rall.scene.num_lights} lights, pack "
                             f"{rall.inline.pack}, {rall.scene.leaf_fmt}")
    for label, rr in (("features", features_r),
                      ("features, 17 lights, median leaf 10, pack 2",
                       rall)):
        ffr, fs = service_frame(rr, params)
        res = _check_wave(label, rr, ffr, fs, [None])
        out["cases"][label] = {k: v for k, v in res.items() if k != "state"}
    del rall
    # The kernel's own time, its wrapper's, and its bound, on the main step.
    passes = max(1, r.cfg.quad_redirect_passes)

    def run(s, t, rw):
        return wave.wave_advance_cuda(s, r.inline, fr.service, t, rw,
                                      k=r.scene.leaf_size,
                                      fmt=r.scene.leaf_fmt, passes=passes)

    totals0 = torch.tensor([n, 0, 0, 0], device=r.device)
    rows0 = torch.zeros((), dtype=torch.int64, device=r.device)
    fresh = lambda: (_copy(s0), totals0.clone(), rows0.clone())
    copies = iter([fresh() for _ in range(4)])
    wrapper_ms = _time_ms(lambda: run(*next(copies)), reps=3)
    del copies
    ms = _kernel_ms(lambda: run(*fresh()), "wave_advance_kernel", reps=5)
    b = wave_bound(s0, work, r, fr, latency_ns)
    build = wave_builds(wave.LIBRARY)
    out.update(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
               plain_ms=plain_ms, library_ms=None, plan=wave.wave_advance_cuda
               .plan, build=build, rounds=out["cases"]["main"]["rounds"], **b)
    log(f"[wave] main step: kernel's own time {ms:.4f} ms, wrapper "
        f"{wrapper_ms:.4f} ms, plain {plain_ms:.1f} ms; {b['rows_fetched']} "
        f"rows in {out['rounds']} rounds; bound {b['bound_ms']:.5f} ms by "
        f"{b['bound_by']} (bytes {b['bytes_ms']:.5f} ms: {b['bound_bytes']} B;"
        f" float32 {b['f32_ms']:.5f} ms; FP64 {b['fp64_ms']:.5f} ms: "
        f"{b['fp64_instructions']} instructions), own time "
        f"{ms / b['bound_ms']:.1f}x; the round loop's bound (each round's "
        f"walk and service bounds summed) {b['rounds_bound_ms']:.4f} ms, own "
        f"time {ms / b['rounds_bound_ms']:.2f}x; the rounds' latency floor "
        f"(each round's longest walk x {latency_ns:.1f} ns, summed) "
        f"{b['latency_floor_ms']:.4f} ms, own time "
        f"{ms / b['latency_floor_ms']:.2f}x; plan {out['plan']}")
    return out


# -- [lane_init]: the lane set-up kernel --------------------------------------

def _poison(s, skip=()) -> None:
    """Fill a state's fields with a pattern the kernel must overwrite:
    NaN payloads in float32 fields, 0x5A bytes in the others (fresh
    device memory is often zero, which would hide an unwritten field)."""
    for key, t in s.items():
        if key in skip:
            continue
        if t.dtype == torch.float32:
            t.view(torch.int32).fill_(LANE_POISON)
        else:
            t.view(torch.uint8).fill_(0x5A)


def guarded_lane_state(n: int, regs: int, textured: bool, device,
                       pixels=None) -> tuple:
    """A lane state as ``new_lane_state`` shapes it, every field a view
    into one buffer of LANE_GUARD bytes: each field starts at a multiple
    of LANE_FIELD_ALIGN bytes (the first one LANE_FIELD_ALIGN in) and has
    at least LANE_GUARD_BYTES guard bytes after it; the fields are
    poisoned.  ``pixels`` (a tensor) is ``pix`` as given, outside the
    buffer.  Returns (state, buffer, each field's byte span in it)."""
    shapes = lane_init.new_lane_state(n, regs, textured, "meta")
    spans, at = {}, LANE_FIELD_ALIGN
    for key, t in shapes.items():
        if key == "pix" and pixels is not None:
            continue
        size = t.numel() * t.element_size()
        spans[key] = (at, at + size)
        at += -(-(size + LANE_GUARD_BYTES) // LANE_FIELD_ALIGN) * \
            LANE_FIELD_ALIGN
    buf = torch.full((at,), LANE_GUARD, dtype=torch.uint8, device=device)
    s = {key: (pixels if key not in spans else
               buf[spans[key][0]:spans[key][1]].view(t.dtype).view(t.shape))
         for key, t in shapes.items()}
    _poison(s, skip=() if pixels is None else ("pix",))
    return s, buf, spans


def guard_bytes_changed(buf: torch.Tensor, spans: dict) -> int:
    """How many of ``guarded_lane_state``'s guard bytes are no longer
    LANE_GUARD."""
    guard = torch.ones_like(buf, dtype=torch.bool)
    for lo, hi in spans.values():
        guard[lo:hi] = False
    return int((guard & (buf != LANE_GUARD)).sum())


def lane_state_bytes(s) -> int:
    """Bytes the lane set-up kernel must move at least: every field it
    writes once (pix read once instead when it is given), plus the four
    totals and the row count."""
    return (sum(t.numel() * t.element_size() for t in s.values())
            + 8 * (len(service.TOTALS) + 1))


def _lane_case(label: str, r: Renderer, cam, pixels, frame: int,
               seed_spp: int, offset: int, library=lane_init.LIBRARY) -> dict:
    """The kernel (``library``'s build) on a poisoned guarded state
    (guarded_lane_state) against init_lane_ctx on the card, field for
    field, bit for bit, with the wave's totals and rows; no guard byte
    around a field may change."""
    n = len(pixels)
    fr = persistent._Frame(r.scene, r.inline, r.cfg, cam, frame, WIDTH,
                           HEIGHT, 1, seed_spp, offset)
    params = service.service_params(fr)
    textured = r.inline.tex0 is not None
    ranged = isinstance(pixels, range)
    pix = (torch.arange(pixels.start, pixels.stop, device=r.device)
           if ranged else pixels)
    s, buf, spans = guarded_lane_state(n, r.cfg.quad_regs, textured,
                                       r.device, None if ranged else pixels)
    totals = torch.full((len(service.TOTALS),), 0x5A5A, dtype=torch.int64,
                        device=r.device)
    rows = torch.full((), 0x5A5A, dtype=torch.int64, device=r.device)
    before = lane_init.lane_init_cuda.launches
    lane_init.lane_init_cuda(s, r.inline, params, totals, rows,
                             pixels.start if ranged else None,
                             library=library)
    torch.cuda.synchronize()
    want = persistent.init_lane_ctx(frame, seed_spp, pix, cam, WIDTH, HEIGHT,
                                    r.cfg, with_tstash=textured,
                                    sample_offset=offset)
    bad = [k for k in want if k not in s or not torch.equal(_bits(s[k]),
                                                            _bits(want[k]))]
    err = max(float((s[k].double() - want[k].double()).abs()
                    .nan_to_num(float("inf")).max())
              for k in want if k in s and s[k].is_floating_point())
    guards = guard_bytes_changed(buf, spans)
    log(f"[lane_init] {label}: {n} lanes, regs {r.cfg.quad_regs}, texture "
        f"stash {textured}, pixels {pixels if ranged else 'given'}, frame "
        f"{frame}, seed spp {seed_spp}, sample offset {offset}: fields not "
        f"bit-equal {bad}, max abs err {err!r}, guard bytes changed "
        f"{guards}, totals {totals.tolist()}, rows {int(rows)}")
    if (bad or list(s) != list(want) or err != 0.0 or guards
            or totals.tolist() != [n, 0, 0, 0] or int(rows) != 0
            or lane_init.lane_init_cuda.launches != before + 1):
        raise AssertionError(f"[lane_init] {label}: the kernel differs from "
                             "init_lane_ctx")
    return dict(lanes=n, state=s, fr=fr, params=params, want=want,
                max_abs_err=err)


def lane_cases(r: Renderer, features_r: Renderer, params) -> list:
    """[lane_init]'s cases at 1200x800, the main path's first: (label,
    renderer, camera, pixels, frame, seed spp, sample offset).  The main
    path's 960,000 lanes (texture stash, 3 skip registers), a step_tiled
    strip that does not start at pixel 0, a sample-parallel shard
    (sample offset 1, seed spp 2, the second half of the pixels), a thin
    lens (aperture 2.0), an untextured cube256 scene with no skip
    registers, the [features] renderer, a pixel tensor read as given
    (reversed), and two ragged ends of the kernel's 256-lane tiles: the
    last 257 pixels, and 240,000 lanes of the untextured scene from an
    odd pixel."""
    n = WIDTH * HEIGHT
    span = -(-n // TILES)
    lens = CameraController()
    lens.aperture = 2.0
    cube = Renderer(flatten_scene(cornell_with(
        *cube_mesh(15.0), (50.0, 20.0, 50.0), albedo=(0.75, 0.75, 0.75),
        roughness=1.0), textures=[]), cfg=RenderConfig(
            width=WIDTH, height=HEIGHT, spp=1, quad_regs=0,
            quad_select="perm"), device=r.device)
    if cube.inline.tex0 is not None or cube.cfg.quad_regs:
        raise AssertionError("the cube256 case must be untextured, no regs")
    return [
        ("main", r, params, range(n), 1, 1, 0),
        ("tiled strip 2", r, params, range(span, 2 * span), 1, 1, 0),
        ("shard", r, params, range(n // 2, n), 3, 2, 1),
        ("lens", r, lens.get_params(WIDTH, HEIGHT), range(n), 2, 1, 0),
        ("cube256 untextured", cube, params, range(n), 1, 1, 0),
        ("features", features_r, params, range(n), 1, 1, 0),
        ("pixel tensor", r, params,
         torch.arange(n, device=r.device).flip(0).contiguous(), 5, 1, 0),
        ("last 257 pixels", r, params, range(n - 257, n), 6, 1, 0),
        ("240,000 lanes untextured", cube, params,
         range(LANE_ODD_FIRST, LANE_ODD_FIRST + span), 7, 1, 0)]


def phase_lane_init(r: Renderer, features_r: Renderer, params) -> dict:
    """The lane set-up kernel (ops/lane_init.py lane_init_cuda) against
    its plain version, init_lane_ctx, on the card, bit for bit and field
    for field on a poisoned guarded state (_lane_case), in lane_cases'
    nine cases at 1200x800; the main case also against init_lane_ctx run
    on the CPU.  Then the kernel's own time, its wrapper's, the plain
    version's, its bound, its build and its launch plan, on the main
    case."""
    n = WIDTH * HEIGHT
    cases, main = {}, None
    for case in lane_cases(r, features_r, params):
        res = _lane_case(*case)
        if main is None:
            main = res
        else:
            cases[case[0]] = dict(lanes=res["lanes"])
        del res
    # The card against the CPU at 1200x800 (camera rays included).
    got = main["state"]
    cpu = persistent.init_lane_ctx(1, 1, torch.arange(n), params, WIDTH,
                                   HEIGHT, r.cfg, with_tstash=True)
    bad = [k for k in cpu if not torch.equal(_bits(got[k].cpu()),
                                             _bits(cpu[k]))]
    log(f"[lane_init] main: the card's state against init_lane_ctx on the "
        f"CPU at {WIDTH}x{HEIGHT}: fields not bit-equal {bad}")
    if bad:
        raise AssertionError("[lane_init] the card differs from the CPU")
    del cpu, got
    # Times on the main case, on state as a Wave allocates it.
    p = main["params"]
    s = lane_init.new_lane_state(n, r.cfg.quad_regs, True, r.device)
    totals = torch.empty(len(service.TOTALS), dtype=torch.int64,
                         device=r.device)
    rows = torch.empty((), dtype=torch.int64, device=r.device)
    run = lambda: lane_init.lane_init_cuda(s, r.inline, p, totals, rows, 0)
    wrapper_ms = _time_ms(run, reps=20)
    plain_ms = _time_ms(lambda: persistent.init_lane_ctx(
        1, 1, torch.arange(n, device=r.device), params, WIDTH, HEIGHT, r.cfg,
        with_tstash=True), reps=5)
    ms = _kernel_ms(run, "lane_init_kernel", reps=20)
    n_bytes = lane_state_bytes(s)
    b = service_bound(n_bytes, dict(sqrt=7 * n, cos=n, sin=n, pow=0,
                                    dmul=0))
    build = ptxas_numbers(lane_init.LIBRARY.compiler_log, "lane_init_kernel")
    plan = lane_init.launch_plan()
    log(f"[lane_init] main: kernel's own time {ms:.5f} ms, wrapper "
        f"{wrapper_ms:.5f} ms, plain (init_lane_ctx on the card) "
        f"{plain_ms:.4f} ms; bound {b['bound_ms']:.5f} ms by "
        f"{b['bound_by']} ({n_bytes} B written: {b['bytes_ms']:.5f} ms; "
        f"FP64 {b['fp64_ms']:.5f} ms: {b['fp64_instructions']} "
        f"instructions), own time {ms / b['bound_ms']:.2f}x; build {build}; "
        f"grid {plan['grid']} blocks ({plan['sms']} SMs x "
        f"{plan['blocks_per_sm']}) over {-(-n // 256)} tiles of 256 lanes, "
        f"{plan['shared_bytes']} B shared a block (the rays' tiles), every "
        f"field by 16-byte stores")
    return dict(max_abs_err=main["max_abs_err"], ms=ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=None,
                bound_bytes=n_bytes, build=build, plan=plan, cases=cases,
                **{k: b[k] for k in ("bound_ms", "bound_by", "bytes_ms",
                                     "fp64_ms", "fp64_instructions")})


# -- [bounce]: the bounce engine ---------------------------------------------

@contextlib.contextmanager
def _walks(closest=None, anyhit=None):
    """The bounce engine's two walks replaced for one block (a wrapper
    around the real ones that records what it was given)."""
    saved = wavefront.closest_hit, wavefront.any_hit
    wavefront.closest_hit = closest or saved[0]
    wavefront.any_hit = anyhit or saved[1]
    try:
        yield
    finally:
        wavefront.closest_hit, wavefront.any_hit = saved


def _tie_trace(rb: Renderer, scene_quad, params):
    """One bounce frame of ``rb`` (frame 1, 1 spp) in which every
    closest-hit walk is also run as the persistent engine's quad walk
    (traverse.closest_hit_quad over ``scene_quad``'s quad rows) on the
    same rays.  A lane whose two walks hit different triangles at the
    same t is an exact tie, which only the visit order decides
    (tryraytrace_tpu/ops/traverse.py:699-703); different triangles at
    different t is a fault.  Returns (sums [n, 3], tie pixels, fault
    pixels)."""
    n = WIDTH * HEIGHT
    tie = torch.zeros(n, dtype=torch.bool, device=rb.device)
    fault = torch.zeros_like(tie)
    real = threaded.closest_hit

    def closest(table, k, o, d, active, *, fmt):
        t, hid, rows = real(table, k, o, d, active, fmt=fmt)
        tq, idq = traverse.closest_hit_quad(scene_quad.quad_table, k, o, d,
                                            active, fmt=fmt)
        differ = active & (hid != idq)
        tie.logical_or_(differ & (t == tq))
        fault.logical_or_(differ & (t != tq))
        return t, hid, rows

    with _walks(closest=closest):
        acc, _ = wavefront.render_frame(rb.scene, rb.inline,
                                        rb.device_textures, params, 1, WIDTH,
                                        HEIGHT, rb.cfg, 1,
                                        tables=rb.bounce_tables)
    return acc, tie, fault


def phase_bounce(arrays, r: Renderer, params, tmp: str) -> tuple:
    """The bounce engine (engine="bounce") on the main path's scene at
    1200x800, 1 spp a step:
      - a warm-up and BOUNCE_STEPS timed steps, then Renderer.image();
        the kernels' launches over these are the path's: one bounce_rays
        a sample, two threaded walks, one bounce_shade and one
        bounce_nee a bounce, one tonemap, nothing else;
      - frame 1 against the persistent engine's frame 1 (``r``): equal
        int64 ray counts and sums within _ULP, except at pixels traced to
        exact-tie hits (``_tie_trace``), whose number is printed;
      - cube256 at 64x48, the card's bounce render against the CPU's,
        bit for bit;
      - ``tpurt-torch render --engine bounce`` (cli.main) against a
        hand-driven Renderer, byte for byte.
    The same frame stepped twice gives the same sums and image bit for
    bit (the lane lists' order may differ between runs).  The device
    operations a bounce are counted later, under the profiler
    (bounce_step_profile).  Returns (its numbers, the bounce
    Renderer)."""
    _zero_counts()
    t0 = time.perf_counter()
    rb = Renderer(arrays, cfg=RenderConfig(width=WIDTH, height=HEIGHT, spp=1,
                                           engine="bounce"))
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    rb.step(params)
    rb.block_until_ready()
    warm_bounces = rb.last_stats["iterations"]
    log(f"[bounce] setup {setup:.2f} s (threaded table "
        f"{tuple(rb.scene.node_table.shape)}, leaf {rb.scene.leaf_fmt} x"
        f"{rb.scene.leaf_size}); warm-up step "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    steps = []
    for _ in range(BOUNCE_STEPS):
        t0 = time.perf_counter()
        rb.step(params)
        rb.block_until_ready()
        dt = time.perf_counter() - t0
        st = rb.last_stats
        rays = int(st["n_traced"]) + int(st["n_shadow"])
        steps.append(dict(ms=1e3 * dt, path=int(st["n_traced"]),
                          shadow=int(st["n_shadow"]),
                          bounces=st["iterations"],
                          rows_fetched=int(st["rows_fetched"]),
                          mrays_per_s=rays / dt / 1e6))
        log(f"[bounce] step {1e3 * dt:.1f} ms, path rays {steps[-1]['path']}"
            f", shadow rays {steps[-1]['shadow']}, {st['iterations']} "
            f"bounces, {steps[-1]['rows_fetched']} threaded rows, "
            f"{steps[-1]['mrays_per_s']:.3f} Mrays/s")
    img = rb.image()
    launches = _counts()
    bounces = warm_bounces + sum(s["bounces"] for s in steps)
    log(f"[bounce] image mean {float(img.mean())!r}, spp {rb.spp()}; "
        f"{bounces} bounces in {1 + BOUNCE_STEPS} samples; launches: "
        f"threaded_walk {launches['threaded_walk']}, bounce_rays "
        f"{launches['bounce_rays']}, bounce_shade "
        f"{launches['bounce_shade']}, bounce_nee {launches['bounce_nee']}, "
        f"tonemap {launches['tonemap']}, walk {launches['walk']}, "
        f"fetch_chain {launches['fetch_chain']}, service "
        f"{launches['service']}, wave {launches['wave']}, lane_init "
        f"{launches['lane_init']}")
    if not bool(torch.isfinite(rb.state.accum).all()) or not img.max() > 0:
        raise AssertionError("non-finite sums or a black bounce image")
    # A sample's camera rays; a bounce's two walks (the closest hit and
    # the NEE any hit), its shade and its NEE add (the scene has lights).
    expect = dict(launches, threaded_walk=2 * bounces,
                  bounce_rays=1 + BOUNCE_STEPS, bounce_shade=bounces,
                  bounce_nee=bounces, tonemap=1, walk=0, fetch_chain=0,
                  service=0, wave=0, lane_init=0, advances=0)
    if launches != expect:
        raise AssertionError(f"bounce path launches {launches}, not "
                             f"{expect}")

    # Frame 1 of both engines.
    rb.reset()
    rb.step(params)
    r.reset()
    r.step(params)
    b, a = rb.state.accum.cpu().numpy(), r.state.accum.cpu().numpy()
    counts = {name: (int(x.last_stats["n_traced"]),
                     int(x.last_stats["n_shadow"]))
              for name, x in (("bounce", rb), ("persistent", r))}
    traced, tie, fault = _tie_trace(rb, r.scene, params)
    same_trace = traced.cpu().numpy().tobytes() == b.tobytes()
    tie, fault = tie.cpu().numpy(), fault.cpu().numpy()
    off = (a != b).any(axis=1)
    untraced = off & ~tie
    close = np.isclose(b[~tie], a[~tie], **ULP).all()
    log(f"[bounce] frame 1 against the persistent engine: {int((a != b).sum())}"
        f" of {a.size} sum floats differ, at {int(off.sum())} pixels; "
        f"{int(tie.sum())} pixels hit an exact tie (two walks, two triangles"
        f", one t), {int(fault.sum())} pixels where the walks disagree in t; "
        f"differing pixels not traced to a tie {int(untraced.sum())}; the "
        f"rest within _ULP {close}; (path, shadow) rays {counts}; traced run "
        f"equal to the step {same_trace}")
    if not same_trace or fault.any() or untraced.any() or not close:
        raise AssertionError("the bounce engine differs from the persistent "
                             "engine beyond exact ties")
    if counts["bounce"] != counts["persistent"] and not tie.any():
        raise AssertionError(f"ray counts differ without a tie: {counts}")
    r.reset()
    # The same step again: the lane lists' order may differ, the image
    # may not.
    first_img = rb.image()
    rb.reset()
    rb.step(params)
    twice = (rb.state.accum.cpu().numpy().tobytes() == b.tobytes()
             and rb.image().tobytes() == first_img.tobytes())
    log(f"[bounce] frame 1 stepped again: sums and image equal to the "
        f"first run {twice}")
    if not twice:
        raise AssertionError("two runs of one bounce step differ")

    # The card against the CPU at 64x48.
    small = cube256_arrays()
    cfg = RenderConfig(width=64, height=48, spp=1, engine="bounce")
    p_small = CameraController().get_params(64, 48)
    got = {}
    for dev in ("cuda", "cpu"):
        x = Renderer(small, cfg=cfg, device=dev)
        x.step(p_small)
        got[dev] = (x.accum_host().tobytes(),
                    (int(x.last_stats["n_traced"]),
                     int(x.last_stats["n_shadow"]),
                     int(x.last_stats["rows_fetched"])))
    log(f"[bounce] cube256 64x48 card vs CPU: sums equal "
        f"{got['cuda'][0] == got['cpu'][0]}, (path, shadow, rows) card "
        f"{got['cuda'][1]} CPU {got['cpu'][1]}")
    if got["cuda"] != got["cpu"]:
        raise AssertionError("the card's bounce render differs from the CPU's")

    # The CLI.
    obj = os.path.join(tmp, "icosphere.obj")
    write_icosphere_obj(obj)
    scene = ["--scene", "cornell-nomesh", "--obj", f"{obj}:15:50,20,50",
             "--width", str(WIDTH), "--height", str(HEIGHT)]
    ppm, npz = os.path.join(tmp, "bounce.ppm"), os.path.join(tmp, "b.npz")
    res = _cli(["render", *scene, "--engine", "bounce", "--frames",
                str(BOUNCE_CLI_FRAMES), "--out", ppm, "--checkpoint", npz])
    args = cli.build_parser().parse_args(["render", *scene])
    hand = Renderer(cli.build_scene_arrays(args), cfg=RenderConfig(
        width=WIDTH, height=HEIGHT, spp=1, engine="bounce"))
    for _ in range(BOUNCE_CLI_FRAMES):
        hand.step(params)
    with np.load(npz) as z:
        same = (load_ppm(ppm).tobytes() == hand.image().tobytes()
                and z["accum"].tobytes()
                == hand.state.accum.cpu().numpy().tobytes())
    dt = float(re.search(r"spp, ([0-9.]+)s\)$", res["stdout"]).group(1))
    log(f"[bounce] render --engine bounce, {BOUNCE_CLI_FRAMES} frames: "
        f"{1e3 * dt / BOUNCE_CLI_FRAMES:.1f} ms a frame; PPM and sums equal to"
        f" the hand-driven Renderer's {same}; launches: threaded_walk "
        f"{res['threaded_walk']}, bounce_rays {res['bounce_rays']}, "
        f"bounce_shade {res['bounce_shade']}, bounce_nee "
        f"{res['bounce_nee']}, tonemap {res['tonemap']}, walk "
        f"{res['walk']}")
    if (not same or res["tonemap"] != 1 or res["walk"] or res["service"]
            or not res["threaded_walk"]
            or res["bounce_rays"] != BOUNCE_CLI_FRAMES
            or res["bounce_shade"] != res["threaded_walk"] // 2
            or res["bounce_nee"] != res["bounce_shade"]):
        raise AssertionError(f"render --engine bounce differs from the "
                             f"Renderer, or launched {res}")
    ms = float(np.mean([s["ms"] for s in steps]))
    return dict(launches, steps=steps, ms_per_step=ms, setup_s=setup,
                image_mean=float(img.mean()), tie_pixels=int(tie.sum()),
                differing_floats=int((a != b).sum()),
                cli_ms_per_frame=1e3 * dt / BOUNCE_CLI_FRAMES), rb


def _bounce_states(scene, walk_table, tables, cfg, params) -> dict:
    """The threaded walks' inputs at three points of one full-width
    bounce frame over ``walk_table`` (the engine's walk-order copy of the
    threaded rows) and ``tables`` (its BounceTables): the camera rays
    (closest hit), the first bounce's shadow rays (any hit), and the
    first closest-hit walk with at most LATE_ACTIVE_SHARE of the lanes
    alive."""
    states = {}
    n = WIDTH * HEIGHT
    real_c, real_a = threaded.closest_hit, threaded.any_hit

    def closest(table, k, o, d, active, *, fmt):
        if "fresh" not in states:
            states["fresh"] = (o.clone(), d.clone(), active.clone(), None)
        elif ("late" not in states
              and int(active.sum()) <= LATE_ACTIVE_SHARE * n):
            states["late"] = (o.clone(), d.clone(), active.clone(), None)
        return real_c(table, k, o, d, active, fmt=fmt)

    def anyhit(table, k, o, d, max_dist, active, *, fmt):
        if "shadow" not in states:
            states["shadow"] = (o.clone(), d.clone(), active.clone(),
                                max_dist.clone())
        return real_a(table, k, o, d, max_dist, active, fmt=fmt)

    with _walks(closest, anyhit):
        wavefront.render_frame(scene, walk_table, tables.textures, params, 1,
                               WIDTH, HEIGHT, cfg, 1, tables=tables)
    if sorted(states) != ["fresh", "late", "shadow"]:
        raise AssertionError(f"the frame gave the states {sorted(states)}")
    return states


def longest_walk(fn):
    """(fn(), the loop count of the plain threaded walk ``fn`` runs): one
    fetch of the live lanes' rows an iteration, so the count is the
    state's longest walk in rows.  Counted around
    ``traverse._threaded_rows``; the walk's results are its own."""
    real = traverse._threaded_rows
    count = [0]

    def counted(*args, **kwargs):
        count[0] += 1
        return real(*args, **kwargs)

    traverse._threaded_rows = counted
    try:
        out = fn()
    finally:
        traverse._threaded_rows = real
    return out, count[0]


def threaded_builds(log_text: str) -> dict:
    """Registers, stack and spills of each threaded-walk kernel instance
    (leaf format, closest or any hit) from a build's ptxas -v lines."""
    out = {}
    for name in sorted(set(re.findall(
            r"_Z\w*threaded_walk_kernel\w*", log_text))):
        m = re.search(r"ILi(\d)ELb(\d)E", name)
        label = (f"{'mt' if m.group(1) == '1' else 'bw'} "
                 f"{'any' if m.group(2) == '1' else 'closest'}")
        out[label] = ptxas_numbers(log_text, name)
    return out


def _check_threaded(label: str, scene, walk_table, state,
                    latency_ns: float) -> dict:
    """One state through the kernel and through its plain version over the
    same walk-order rows: every output and the rows fetched must be
    equal.  Then the kernel's own time and the wrapper's, the state's
    longest walk (the plain loop count) and the two bounds."""
    o, d, active, max_dist = state
    k, fmt = scene.leaf_size, scene.leaf_fmt
    table = walk_table
    shadow = max_dist is not None
    launch = lambda: threaded.threaded_walk_cuda(table, k, o, d, active,
                                                 max_dist, fmt=fmt)
    torch.cuda.synchronize()
    got = launch()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if shadow:
        want, longest = longest_walk(lambda: traverse.any_hit_packed(
            table, k, o, d, max_dist, active, fmt=fmt))
    else:
        want, longest = longest_walk(lambda: traverse.closest_hit_packed(
            table, k, o, d, active, fmt=fmt))
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t1)
    names = ("occluded", "rows") if shadow else ("t", "hit_id", "rows")
    bad = [nm for nm, a, b in zip(names, got, want) if not torch.equal(a, b)]
    err = 0.0 if shadow else float((got[0].double() - want[0].double())
                                   .abs().max())
    n, n_act, rows = o.shape[0], int(active.sum()), int(got[-1])
    log(f"[bounce] {label} walk ({fmt} leaves x{k}, walk-order table "
        f"{tuple(table.shape)}): {n_act} of {n} lanes active; rows fetched "
        f"kernel {rows} plain {int(want[-1])}; longest walk {longest} rows; "
        f"outputs differing {bad}, max abs err {err!r}; launch: "
        f"{-(-n // 64)} blocks of 64 threads, one a ray, 0 staged rows, 0 B "
        f"of shared memory (no plan: staging and persistent blocks were "
        f"measured and dropped)")
    if bad:
        raise AssertionError(f"threaded_walk kernel disagrees with its plain "
                             f"version on the {label} state: {bad}")
    wrapper_ms = _time_ms(launch, reps=5)
    ms = _kernel_ms(launch, "threaded_walk_kernel", reps=10)
    # The threaded table once (its rows as pack_traversal_table packs
    # them), each lane's active flag, an active lane's ray (and segment
    # length), each lane's outputs; a fetched row's slab test at 30
    # operations (leaf slots left out: a lower count).
    n_bytes = (scene.node_table.numel() * 4 + n
               + n_act * (28 if shadow else 24) + n * (1 if shadow else 12))
    # The longest walk's chain of dependent fetches, one L2 latency each.
    latency_ms = longest * latency_ns * 1e-6
    out = dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
               plain_ms=plain_ms, library_ms=None, rows_fetched=rows,
               active_lanes=n_act, longest_walk=longest,
               latency_bound_ms=latency_ms,
               **bound(n_bytes, 30 * rows))
    larger = max(out["bound_ms"], latency_ms)
    log(f"[bounce] {label} walk: kernel's own time {ms:.4f} ms, wrapper "
        f"{wrapper_ms:.4f} ms, plain {plain_ms:.1f} ms; "
        f"{rows / ms / 1e6:.3f} G rows/s; bounds: {out['bound_ms']:.5f} ms "
        f"by {out['bound_by']}, {latency_ms:.5f} ms by latency ({longest} "
        f"rows x {latency_ns:.1f} ns); own time {ms / larger:.2f}x the "
        f"larger")
    return out


def phase_threaded_walk(rb: Renderer, features_r: Renderer, params,
                        latency_ns: float) -> dict:
    """The threaded-walk kernel against its plain version on three states
    of the 960,000-lane bounce wave, over the engine's walk-order copy of
    the main path's tree ("bw" slots) and of the [features] Renderer's
    SBVH ("mt" slots, auto leaf 6, rows of 78 floats padded to 80).
    ``latency_ns`` is one dependent L2 fetch's latency ([fetch]).
    Returns the "bw" states' numbers, fresh first, the "mt" ones under
    "mt", and the kernel instances' registers under "build"."""
    out = {"build": threaded_builds(threaded.LIBRARY.compiler_log)}
    log(f"[bounce] threaded_walk kernel builds: {out['build']}")
    fs = features_r.scene
    runs = (("bw", rb.scene, rb.inline, rb.bounce_tables, rb.cfg),
            ("mt", fs, threaded.walk_table(fs.node_table, fs.leaf_size,
                                           fs.leaf_fmt),
             bounce.bounce_tables(fs, features_r.textures),
             features_r.cfg.replace(engine="bounce")))
    for fmt, scene, walk_table, tables, cfg in runs:
        states = _bounce_states(scene, walk_table, tables, cfg, params)
        res = {label: _check_threaded(label, scene, walk_table,
                                      states[label], latency_ns)
               for label in ("fresh", "shadow", "late")}
        del states
        out[fmt] = res
    return out


# -- [bounce_kernels]: the bounce engine's shade, NEE add and camera rays ----


@contextlib.contextmanager
def _recording_bounce(states: dict, n: int):
    """Record ``bounce_shade``'s and ``bounce_nee``'s inputs (clones) at
    three bounces of the sample that runs inside the block: "fresh"
    (bounce 0), "mid" (bounce MID_DEPTH) and "late" (the first bounce that
    starts with at most LATE_ACTIVE_SHARE of the ``n`` lanes alive), as
    ``states[label] = dict(seed, pixels, depth, t, hit_id, s, lanes,
    n_lanes, nee)``: ``lanes`` and ``n_lanes`` the list the shade and the
    NEE add served (None at bounce 0 and on the CPU), ``nee`` (rad,
    geo_ok, contrib, occluded) just before the NEE add."""
    real_shade, real_nee = bounce.bounce_shade, bounce.bounce_nee
    now = {}

    def shade_(scene, tables, params, seed, pixels, depth, t, hit_id, s,
               counts, lanes=None, n_lanes=None, next_lanes=None):
        label = None
        if depth == 0 and "fresh" not in states:
            label = "fresh"
        elif depth == MID_DEPTH and "mid" not in states:
            label = "mid"
        elif ("late" not in states and depth > MID_DEPTH
              and int(s["alive"].sum()) <= LATE_ACTIVE_SHARE * n):
            label = "late"
        if label is not None:
            states[label] = dict(
                seed=seed, pixels=pixels.clone(), depth=depth, t=t.clone(),
                hit_id=hit_id.clone(), s=_copy(s),
                lanes=None if lanes is None else lanes.clone(),
                n_lanes=n_lanes)
        now["label"] = label
        return real_shade(scene, tables, params, seed, pixels, depth, t,
                          hit_id, s, counts, lanes, n_lanes, next_lanes)

    def nee_(s, occluded, lanes=None, n_lanes=None):
        if now.get("label") is not None:
            states[now["label"]]["nee"] = (
                s["rad"].clone(), s["geo_ok"].clone(), s["contrib"].clone(),
                occluded.clone())
        return real_nee(s, occluded, lanes, n_lanes)

    bounce.bounce_shade, bounce.bounce_nee = shade_, nee_
    try:
        yield
    finally:
        bounce.bounce_shade, bounce.bounce_nee = real_shade, real_nee


def bounce_kernel_states(rb: Renderer, params, width: int, height: int,
                         frame: int = 1) -> dict:
    """The inputs of ``bounce_shade`` and ``bounce_nee`` at three bounces
    of one 1-spp frame of the bounce Renderer ``rb`` (_recording_bounce)
    and of ``bounce_rays`` (its params, seed and pixels), run with the
    Renderer's own engine.  The scene must have lights."""
    states = {}
    n = width * height
    with _recording_bounce(states, n):
        wavefront.render_frame(rb.scene, rb.inline, rb.device_textures,
                               params, frame, width, height, rb.cfg, 1,
                               tables=rb.bounce_tables)
    if sorted(states) != ["fresh", "late", "mid"]:
        raise AssertionError(f"the frame gave the states {sorted(states)}")
    tables = rb.bounce_tables
    bp = bounce.bounce_params(rb.scene, tables, rb.cfg, width, height,
                              params)
    states["rays"] = dict(params=bp, seed=states["fresh"]["seed"],
                          pixels=states["fresh"]["pixels"])
    return states


def _same_bits(a: torch.Tensor, b: torch.Tensor, where=None) -> bool:
    """Equal bit for bit where ``where`` holds (everywhere when None), a
    NaN equal to a NaN of any payload."""
    if where is not None:
        a, b = a[where], b[where]
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(_bits(a[~na]), _bits(b[~nb]))


def shade_contract(got: dict, want: dict) -> list:
    """The fields in which ``bounce_shade``'s kernel (``got``) and plain
    version (``want``) differ by the contract of ops/bounce.py: rad, tp,
    alive, prev_spec and geo_ok on every lane, o and d on the lanes alive
    after the bounce, so, sd, smax and contrib where geo_ok holds; floats
    bit for bit, NaN at the same places."""
    alive, bad = want["alive"], []
    geo = want.get("geo_ok")
    for name, _, _ in bounce.STATE + (bounce.NEE if geo is not None
                                      else ()):
        where = (alive if name in ("o", "d")
                 else geo if name in ("so", "sd", "smax", "contrib")
                 else None)
        if not _same_bits(got[name], want[name], where):
            bad.append(name)
    return bad


def _max_err(got: dict, want: dict, names) -> float:
    return max([float((got[k].double() - want[k].double()).abs()
                      .nan_to_num(0.0).max()) for k in names
                if got[k].is_floating_point() and got[k].numel()] or [0.0])


def texel_taps(u, v, w: int, h: int):
    """The flat texel indices [N, 4] of the bilinear taps at (u, v) in a
    w x h texture, by ops/texture.py sample_bilinear_wrap's arithmetic."""
    x0 = torch.floor((u - torch.floor(u)) * w - 0.5).to(torch.int64) % w
    y0 = torch.floor((v - torch.floor(v)) * h - 0.5).to(torch.int64) % h
    x1, y1 = (x0 + 1) % w, (y0 + 1) % h
    return torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1],
                       dim=-1)


def shade_work(rb_scene, tables, cfg, st, want) -> dict:
    """The bytes a bounce's shade must move and its FP64 calls, from its
    inputs ``st`` (a recorded state) and the plain version's outputs
    ``want``.  Bytes: each lane's alive flag read and, with lights, its
    geo_ok written (2 B); a lane alive at entry reads hit_id and writes
    alive (9 B); one that hit also reads t, o, d, pix, tp, rad and
    prev_spec (61 B) and writes rad (12 B); one on a branch also writes
    o, d, tp and prev_spec (37 B), one that fires a shadow ray so, sd,
    smax and contrib (40 B).  Each distinct trimat row hit (148 B), each
    distinct texel a textured hit taps (12 B; texel_taps), the texture
    metas and the light rows count once.
    Calls, by the branch each lane takes (chip_smoke.service_work's
    accounting): a face normal (1 sqrt) a hit and a smooth one where
    smooth_normal keeps it (1), pow and a DMUL a lane past roulette, a
    perturbed direction (2 sqrt, cos, sin) on the specular branch, total
    internal reflection and rough refraction, a refraction (2 sqrt), a
    light sample (3 sqrt) and a cosine-weighted direction (4 sqrt, cos,
    sin) on the diffuse branch."""
    s, hit_id = st["s"], st["hit_id"]
    entry = s["alive"]
    hit = entry & (hit_id >= 0)
    seen = {}
    real_surface, real_scatter = shade.surface, shade.scatter

    def surface(hitrow, x_hit, d, *args, **kwargs):
        seen["hitrow"], seen["x_hit"] = hitrow, x_hit
        out = real_surface(hitrow, x_hit, d, *args, **kwargs)
        seen["uv"] = out[1]
        return out

    def scatter(q, d, tp, rad, alive, prev_spec, u, *args):
        seen.update(q=q, d=d, u=u)
        return real_scatter(q, d, tp, rad, alive, prev_spec, u, *args)

    shade.surface, shade.scatter = surface, scatter
    try:
        bounce.bounce_shade_plain(rb_scene, tables, cfg, st["seed"],
                                  st["pixels"], st["depth"], st["t"], hit_id,
                                  _copy(s))
    finally:
        shade.surface, shade.scatter = real_surface, real_scatter
    q, d, u = seen["q"], seen["d"], seen["u"]
    alive = hit & ~(q["emission"] > cfg.emitter_stop_threshold).any(dim=-1)
    p_live = torch.clamp(q["albedo"].amax(dim=-1), min=cfg.rr_min_p)
    if st["depth"] > cfg.rr_threshold:
        alive = alive & (u[:, rng.SLOT_RR] < p_live)
    p_spec, p_trans, _ = shade.pbr_weights(
        q["albedo"], q["metallic"], q["roughness"], q["transmission"],
        q["nl"], d)
    u_b = u[:, rng.SLOT_BRANCH]
    m_spec = alive & (u_b < p_spec)
    m_trans = alive & ~m_spec & (u_b < p_spec + p_trans)
    m_diff = alive & ~m_spec & ~m_trans
    tir = m_trans & shade.refract_branch(
        d, q["nrm"], q["nl"], q["ior"], q["roughness"],
        u[:, rng.SLOT_DIR_R1], u[:, rng.SLOT_DIR_R2])[1]
    rough = q["roughness"] > 0.0
    smooth_ok = torch.zeros_like(hit)
    if cfg.smooth_shading and rb_scene.has_normals:
        row, x_hit = seen["hitrow"], seen["x_hit"]
        b1, b2, ok_den = shade.barycentric(row[:, 0:3], row[:, 3:6],
                                           row[:, 6:9], x_hit)
        b0 = 1.0 - b1 - b2
        ns = (row[:, 21:24] * b0[:, None] + row[:, 24:27] * b1[:, None]
              + row[:, 27:30] * b2[:, None])
        smooth_ok = hit & ok_den & (vec.dot(ns, ns) > 1e-12)
    n = lambda m: int(m.sum())
    fired = want["geo_ok"] if "geo_ok" in want else torch.zeros_like(hit)
    texels = 0
    if tables.textures:
        u_tex, v_tex = seen["uv"]
        tid = seen["hitrow"][:, 19].to(torch.int64)
        for k, (_, w, h) in enumerate(tables.metas.tolist()):
            m = hit & (tid == k)
            texels += int(torch.unique(texel_taps(u_tex[m], v_tex[m], w,
                                                  h)).numel())
    lights = 0 if rb_scene.num_lights == 0 else 1
    n_bytes = (2 * entry.numel() if lights else entry.numel()) \
        + 9 * n(entry) + 73 * n(hit) + 37 * n(alive) + 40 * n(fired) \
        + 148 * int(torch.unique(hit_id[hit]).numel()) + 12 * texels \
        + tables.lights.numel() * 4 + tables.metas.numel() * 8
    lanes = dict(entry=n(entry), hit=n(hit), branch=n(alive),
                 spec=n(m_spec), tir=n(tir),
                 trans_smooth=n(m_trans & ~tir & ~rough),
                 trans_rough=n(m_trans & ~tir & rough), diff=n(m_diff),
                 fired=n(fired))
    perturbed = lanes["spec"] + lanes["tir"] + lanes["trans_rough"]
    trans_refr = lanes["trans_smooth"] + lanes["trans_rough"]
    trig = perturbed + lanes["diff"]
    calls = dict(sqrt=(lanes["hit"] + n(smooth_ok) + 2 * perturbed
                       + 2 * trans_refr + 3 * lights * lanes["diff"]
                       + 4 * lanes["diff"]),
                 cos=trig, sin=trig, pow=n(alive), dmul=n(alive))
    return dict(n_bytes=n_bytes, lanes=lanes, calls=calls, texels=texels)


def _shuffled(lanes, n_lanes: int):
    """A copy of the list ``lanes`` with its first ``n_lanes`` entries in
    a seed-made order (BOUNCE_SHUFFLE_SEED)."""
    out = lanes.clone()
    g = torch.Generator().manual_seed(BOUNCE_SHUFFLE_SEED)
    perm = torch.randperm(n_lanes, generator=g).to(lanes.device)
    out[:n_lanes] = lanes[:n_lanes][perm]
    return out


def _off_list(st):
    """[N] bool: the lanes off a recorded state's list (none at bounce 0)."""
    off = torch.ones_like(st["s"]["alive"])
    if st["lanes"] is None:
        return ~off
    off[st["lanes"][:st["n_lanes"]].long()] = False
    return off


def _untouched(got: dict, before: dict, where) -> list:
    """The fields of ``got`` not bit-equal to ``before`` on the lanes
    ``where`` (NaN payloads included)."""
    return [k for k in got if not torch.equal(_bits(got[k][where]),
                                              _bits(before[k][where]))]


def _shade_call(rb: Renderer, params, st, s, lanes, counts, nxt,
                library=None) -> dict:
    """bounce_shade_cuda on the recorded state's inputs and the state
    ``s`` (written in place), over ``lanes`` (the recorded count), into
    ``counts`` and the next list ``nxt``."""
    return bounce.bounce_shade_cuda(
        rb.scene, rb.bounce_tables, params, st["seed"], st["pixels"],
        st["depth"], st["t"], st["hit_id"], s, counts, lanes,
        None if lanes is None else st["n_lanes"], nxt, library=library)


def _listed(n: int, count, library=None) -> bool:
    """Whether a build launches over a list of ``count`` of ``n`` lanes
    (None: no list) and not over all n: csrc/bounce.cu's rule, a list of
    at most the build's dense share of the wave."""
    return count is not None and count <= bounce.dense_share(library) * n


def _served(n: int, count, library=None) -> int:
    """The lanes such a launch runs over: the list's, or all n."""
    return count if _listed(n, count, library) else n


def check_bounce_shade(label: str, rb: Renderer, params, st,
                       timed: bool = True, library=None) -> dict:
    """A recorded state through ``bounce_shade_cuda`` (``library``'s
    build, default the port's) and through ``bounce_shade_plain`` on the
    card, each on a copy: the kernel over the recorded list (every lane at
    bounce 0), every field by shade_contract, the counts exact, and the
    next list, sorted, the lanes alive after.  Past bounce 0 also over a
    shuffled copy of the list, on a copy whose lanes off the list carry
    NaN payloads in o, d, so, sd, smax and contrib (fields the contract
    does not compare there): the same checks, and every field of every
    lane off the list bit for bit as it was.  With ``timed``, the
    kernel's own time, the wrapper's (each call on a fresh copy: the
    kernel writes in place), the plain version's, and the bound
    (service_bound of shade_work: PR 18's bytes, every lane's flags;
    ``list_bound_ms`` the bytes of this build's launch: the next list,
    and over a list its entries and only the listed lanes' flags)."""
    scene, tables = rb.scene, rb.bounce_tables
    dev = scene.trimat.device
    n = len(st["hit_id"])
    args = (st["seed"], st["pixels"], st["depth"], st["t"], st["hit_id"])
    zeros = lambda: torch.zeros(len(bounce.COUNTS), dtype=torch.int64,
                                device=dev)
    counts, nxt = zeros(), torch.full((n,), -1, dtype=torch.int32,
                                      device=dev)
    got = _shade_call(rb, params, st, _copy(st["s"]), st["lanes"], counts,
                      nxt, library)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want, fired, live = bounce.bounce_shade_plain(scene, tables, rb.cfg,
                                                  *args, _copy(st["s"]))
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t1)
    alive_after = want["alive"].nonzero().flatten()
    next_ok = lambda nx: torch.equal(
        nx[:int(live)].long().sort().values, alive_after)
    bad = shade_contract(got, want)
    err = _max_err(got, want, ["rad", "tp"])
    entry = int(st["s"]["alive"].sum())
    count = None if st["lanes"] is None else st["n_lanes"]
    listed, served = _listed(n, count, library), _served(n, count, library)
    off = _off_list(st)
    ok = (not bad and counts.tolist() == [int(fired), int(live)]
          and next_ok(nxt) and not bool((st["s"]["alive"] & off).any()))
    shuffled = dict(fields=[], counts=[], next_ok=True, touched=[])
    if st["lanes"] is not None:
        poisoned = _copy(st["s"])
        for name in ("o", "d", "so", "sd", "smax", "contrib"):
            poisoned[name][off] = torch.tensor(LANE_POISON, dtype=torch.int32,
                                               device=dev).view(torch.float32)
        before = _copy(poisoned)
        counts2, nxt2 = zeros(), torch.full_like(nxt, -1)
        got2 = _shade_call(rb, params, st, poisoned,
                           _shuffled(st["lanes"], count), counts2, nxt2,
                           library)
        shuffled = dict(fields=shade_contract(got2, want),
                        counts=counts2.tolist(), next_ok=next_ok(nxt2),
                        touched=(_untouched(got2, before, off)
                                 if listed else []))
        ok = (ok and not shuffled["fields"] and shuffled["next_ok"]
              and shuffled["counts"] == counts.tolist()
              and not shuffled["touched"])
    log(f"[bounce_kernels] shade {label} (bounce {st['depth']}): {entry} of "
        f"{n} lanes alive at entry, {served} served (over the list "
        f"{listed}); counts (shadow, live) "
        f"kernel {counts.tolist()} plain {[int(fired), int(live)]}; fields "
        f"differing {bad}, max abs err {err!r}; next list equal to the "
        f"lanes alive after {next_ok(nxt)}; shuffled list: fields "
        f"differing {shuffled['fields']}, counts {shuffled['counts']}, next "
        f"list {shuffled['next_ok']}, off-list fields changed "
        f"{shuffled['touched']}")
    if not ok:
        raise AssertionError(f"bounce_shade kernel disagrees with its plain "
                             f"version on the {label} state: {bad}, "
                             f"{shuffled}")
    out = dict(max_abs_err=err, depth=st["depth"], entry=entry,
               served=served, listed=listed, counts=counts.tolist())
    if not timed:
        return out
    work = shade_work(scene, tables, rb.cfg, st, want)
    # The bytes of this build's launch: PR 18's count and the next list,
    # and over a list its entries, less the flags of the lanes off it.
    flags = 2 if "geo_ok" in want else 1
    list_bytes = work["n_bytes"] + 4 * int(live) + (
        4 * served - flags * (n - served) if listed else 0)
    calls = [(_copy(st["s"]), zeros()) for _ in range(6)]
    copies = iter(calls)

    def run(s, c):
        return _shade_call(rb, params, st, s, st["lanes"], c, nxt, library)

    wrapper_ms = _time_ms(lambda: run(*next(copies)), reps=5)
    del calls, copies

    def fresh():
        counts.zero_()
        return run(_copy(st["s"]), counts)

    ms = _kernel_ms(fresh, "bounce_shade_kernel", reps=10)
    listed_bound = service_bound(list_bytes, work["calls"])
    out.update(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
               library_ms=None, lanes=work["lanes"], calls=work["calls"],
               texels=work["texels"], bound_bytes=work["n_bytes"],
               list_bound_bytes=list_bytes,
               list_bound_ms=listed_bound["bound_ms"],
               **service_bound(work["n_bytes"], work["calls"]))
    log(f"[bounce_kernels] shade {label}: lanes {work['lanes']}; distinct "
        f"texels {work['texels']}; double calls {work['calls']}")
    log(f"[bounce_kernels] shade {label}: kernel's own time {ms:.5f} ms, "
        f"wrapper {wrapper_ms:.5f} ms, plain {plain_ms:.2f} ms; bound "
        f"{out['bound_ms']:.5f} ms by {out['bound_by']} ({work['n_bytes']} "
        f"B: {out['bytes_ms']:.5f} ms; FP64 {out['fp64_ms']:.5f} ms: "
        f"{out['fp64_instructions']} instructions); own time "
        f"{ms / out['bound_ms']:.2f}x; this launch's bytes "
        f"{list_bytes} B, bound {listed_bound['bound_ms']:.5f} ms, own "
        f"{ms / listed_bound['bound_ms']:.2f}x")
    return out


def check_bounce_nee(label: str, st, timed: bool = True,
                     library=None) -> dict:
    """A recorded NEE add (rad, geo_ok, contrib, occluded) through
    ``bounce_nee_cuda`` (``library``'s build) over the recorded list and
    over a shuffled copy, and through ``bounce_nee_plain`` over every
    lane, on the card: rad bit for bit on every lane, NaN at the same
    places.  With ``timed``, the kernel's own time, the wrapper's, the
    plain version's and the byte bound: geo_ok and occluded of every
    lane (2 B), and rad read and written and contrib read on each lit
    lane (36 B); ``list_bound_ms`` counts, where the build runs over the
    list, the flags and the list entry (6 B) of the listed lanes only."""
    rad, geo_ok, contrib, occluded = st["nee"]
    lanes = st["lanes"]
    n_lanes = None if lanes is None else st["n_lanes"]
    listed = _listed(len(geo_ok), n_lanes, library)
    served = _served(len(geo_ok), n_lanes, library)
    state = lambda: dict(rad=rad.clone(), geo_ok=geo_ok, contrib=contrib)
    run = lambda s, ls=lanes: bounce.bounce_nee_cuda(s, occluded, ls,
                                                     n_lanes, library)
    got = run(state())["rad"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = bounce.bounce_nee_plain(rad, geo_ok, occluded, contrib)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t1)
    lit = int((geo_ok & ~occluded).sum())
    same = _same_bits(got, want)
    shuffled = (True if lanes is None else
                _same_bits(run(state(), _shuffled(lanes, n_lanes))["rad"],
                           want))
    err = _max_err(dict(r=got), dict(r=want), ["r"])
    log(f"[bounce_kernels] nee {label}: {int(geo_ok.sum())} shadow rays, "
        f"{lit} lit, {served} lanes served (over the list "
        f"{listed}); rad equal {same}, with the "
        f"list shuffled {shuffled}; max abs err {err!r}")
    if not same or not shuffled:
        raise AssertionError(f"bounce_nee kernel disagrees with its plain "
                             f"version on the {label} state")
    out = dict(max_abs_err=err, lit=lit, served=served, listed=listed)
    if not timed:
        return out
    n_bytes = 2 * geo_ok.numel() + 36 * lit
    list_bytes = 6 * served + 36 * lit if listed else n_bytes
    copies = iter([state() for _ in range(6)])
    wrapper_ms = _time_ms(lambda: run(next(copies)), reps=5)
    ms = _kernel_ms(lambda: run(state()), "bounce_nee_kernel", reps=10)
    listed_bound = bound(list_bytes, 3 * lit)
    out.update(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
               library_ms=None, bound_bytes=n_bytes,
               list_bound_bytes=list_bytes,
               list_bound_ms=listed_bound["bound_ms"],
               **bound(n_bytes, 3 * lit))
    log(f"[bounce_kernels] nee {label}: kernel's own time {ms:.5f} ms, "
        f"wrapper {wrapper_ms:.5f} ms, plain {plain_ms:.3f} ms; bound "
        f"{out['bound_ms']:.5f} ms by {out['bound_by']} ({n_bytes} B); own "
        f"time {ms / out['bound_ms']:.2f}x; this launch's bytes "
        f"{list_bytes} B, "
        f"bound {listed_bound['bound_ms']:.5f} ms, own "
        f"{ms / listed_bound['bound_ms']:.2f}x")
    return out


def check_bounce_rays(st, timed: bool = True) -> dict:
    """``bounce_rays_cuda`` against ``bounce_rays_plain`` on the card on
    a recorded sample's pixels: every field bit for bit.  With ``timed``,
    the kernel's own time, the wrapper's, the plain version's and the
    bound: the pixels read and the state written (58 B a lane), and the
    camera ray's double calls (7 sqrt, cos, sin a lane: lane_init's
    accounting)."""
    bp, seed, pixels = st["params"], st["seed"], st["pixels"]
    width = int(bp.ints[service.INTS.index("width")])
    height = int(bp.ints[service.INTS.index("height")])
    got = bounce.bounce_rays_cuda(bp, seed, pixels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = bounce.bounce_rays_plain(bp.cam, width, height, seed, pixels)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t1)
    bad = [k for k, _, _ in bounce.STATE if not _same_bits(got[k], want[k])]
    err = _max_err(got, want, ["o", "d"])
    n = int(pixels.shape[0])
    log(f"[bounce_kernels] rays: {n} lanes, seed {seed}; fields differing "
        f"{bad}, max abs err {err!r}")
    if bad:
        raise AssertionError(f"bounce_rays kernel disagrees with its plain "
                             f"version: {bad}")
    out = dict(max_abs_err=err, lanes=n)
    if not timed:
        return out
    run = lambda: bounce.bounce_rays_cuda(bp, seed, pixels)
    wrapper_ms = _time_ms(run, reps=20)
    ms = _kernel_ms(run, "bounce_rays_kernel", reps=10)
    n_bytes = 58 * n
    out.update(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
               library_ms=None, bound_bytes=n_bytes,
               **service_bound(n_bytes, dict(sqrt=7 * n, cos=n, sin=n,
                                             pow=0, dmul=0)))
    log(f"[bounce_kernels] rays: kernel's own time {ms:.5f} ms, wrapper "
        f"{wrapper_ms:.5f} ms, plain {plain_ms:.3f} ms; bound "
        f"{out['bound_ms']:.5f} ms by {out['bound_by']} ({n_bytes} B: "
        f"{out['bytes_ms']:.5f} ms; FP64 {out['fp64_ms']:.5f} ms); own time "
        f"{ms / out['bound_ms']:.2f}x")
    return out


def bounce_step_profile(rb: Renderer, params) -> dict:
    """One bounce step of ``rb`` under torch.profiler (after one
    unprofiled step): its bounces, device operations (kernels, fills,
    copies) and device time, each bounce kernel's launches and device
    time in it, and the shade's device time and lanes alive at entry at
    each bounce."""
    rb.step(params)
    rb.block_until_ready()
    served, real = [], bounce.bounce_shade

    def shade_(*args):
        served.append(_served(len(args[4]), args[11]))
        return real(*args)

    bounce.bounce_shade = shade_
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rb.step(params)
            rb.block_until_ready()
    finally:
        bounce.bounce_shade = real
    bounces = rb.last_stats["iterations"]
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    ops = sum(e.count for e in device)
    out = dict(bounces=bounces, operations=ops,
               operations_a_bounce=ops / bounces, served_by_bounce=served,
               device_ms=sum(e.device_time_total for e in device) / 1e3)
    for name in ("threaded_walk", *BOUNCE_KERNELS):
        found = [e for e in device if f"{name}_kernel" in e.key]
        out[name] = dict(launches=sum(e.count for e in found),
                         ms=sum(e.device_time_total for e in found) / 1e3)
    # The shade's launches in order: its device ms at each bounce.
    out["shade_ms_by_bounce"] = [
        e.time_range.elapsed_us() / 1e3 for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA
             and "bounce_shade_kernel" in e.name),
            key=lambda e: e.time_range.start)]
    log(f"[bounce] profiled step: {bounces} bounces, {ops} device "
        f"operations ({ops / bounces:.2f} a bounce), device time "
        f"{out['device_ms']:.3f} ms; " + ", ".join(
            f"{name} {out[name]['launches']} launches {out[name]['ms']:.4f}"
            f" ms" for name in ("threaded_walk", *BOUNCE_KERNELS)))
    log(f"[bounce] profiled step: the shade's ms by bounce "
        f"{[round(x, 5) for x in out['shade_ms_by_bounce']]}, lanes "
        f"served {served}")
    return out


def phase_bounce_kernels(rb: Renderer, params, variants: dict) -> dict:
    """The bounce engine's three kernels against their plain versions on
    the card, at the main path's scene and raster (1200x800, the bounce
    Renderer of [bounce]): bounce_shade and bounce_nee on the fresh, mid
    and late states of frame 1 (bounce_kernel_states) with the lists the
    engine gave them and shuffled copies, bounce_rays on its camera rays;
    each checked on copies, then timed (after every phase that times
    steps: its own time runs torch.profiler), with its registers, stack
    and spills; the same for the shade and the NEE add of each build in
    ``variants`` (name -> a -D build of csrc/bounce.cu); and one bounce
    step profiled (bounce_step_profile)."""
    out = dict(build={k: ptxas_numbers(bounce.LIBRARY.compiler_log, k)
                      for k in (f"{name}_kernel" for name in
                                BOUNCE_KERNELS)},
               dense_share=bounce.dense_share())
    log(f"[bounce_kernels] builds: {out['build']}; dense share "
        f"{out['dense_share']}")
    states = bounce_kernel_states(rb, params, WIDTH, HEIGHT)
    bp = states["rays"]["params"]
    labels = ("fresh", "mid", "late")
    out["shade"] = {label: check_bounce_shade(label, rb, bp, states[label])
                    for label in labels}
    out["nee"] = {label: check_bounce_nee(label, states[label])
                  for label in labels}
    out["rays"] = check_bounce_rays(states["rays"])
    out["variants"] = {}
    for name, lib in variants.items():
        var = dict(dense_share=bounce.dense_share(lib),
                   build=ptxas_numbers(lib.compiler_log,
                                       "bounce_shade_kernel"))
        log(f"[bounce_kernels] variant {name} "
            f"({' '.join(lib.flags[len(_build.NVCC_FLAGS):])}): dense share "
            f"{var['dense_share']}, shade build {var['build']}")
        for label in labels:
            shade_ = check_bounce_shade(f"{label} [{name}]", rb, bp,
                                        states[label], library=lib)
            nee_ = check_bounce_nee(f"{label} [{name}]", states[label],
                                    library=lib)
            var[label] = dict(
                shade={k: shade_[k] for k in ("ms", "wrapper_ms", "bound_ms",
                                              "list_bound_ms")},
                nee={k: nee_[k] for k in ("ms", "wrapper_ms", "bound_ms",
                                          "list_bound_ms")})
        out["variants"][name] = var
    out["step"] = bounce_step_profile(rb, params)
    return out


# -- [parallel]: ShardedRenderer and two processes ---------------------------

def phase_parallel(arrays, r: Renderer, rb: Renderer, params,
                   tmp: str) -> dict:
    """ShardedRenderer on the card over the main path's scene at
    1200x800, PARALLEL_SPP samples a step, for each engine: 1x1, (2,1)
    and (4,1) meshes of the one card bit-equal to the Renderer (sums and
    image), (2,2) within ATOL_SP, with equal int64 ray totals.  The
    counts are set to 0 after each reference render, just before each
    mesh's ``sr.step``, and read just after its ``sr.image()``: they
    must be exactly what the sharded step alone launches (a wave kernel a
    shard, two threaded walks a bounce, summed over the shards; one
    tonemap).  Then two processes of ``tpurt-torch
    render --coordinator ... --num-processes 2`` over gloo on the one
    card, whose PPM must equal a one-process render's byte for byte.
    NCCL across cards needs more than one card, so it is not run
    here."""
    card = torch.device("cuda", torch.cuda.current_device())
    out = dict(meshes=[])
    totals = dict.fromkeys(COUNTED, 0)
    for engine, ref in (("persistent", r), ("bounce", rb)):
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=PARALLEL_SPP,
                           engine=engine)
        ref.reset()
        ref.step(params, spp=PARALLEL_SPP)
        want = ref.accum_host()
        want_img = ref.image()
        want_rays = (int(ref.last_stats["n_traced"]),
                     int(ref.last_stats["n_shadow"]))
        for tile, sample in PARALLEL_MESHES:
            mesh = make_mesh([card] * (tile * sample), tile=tile,
                             sample=sample)
            t0 = time.perf_counter()
            sr = ShardedRenderer(arrays, cfg, mesh=mesh)
            setup = time.perf_counter() - t0
            _zero_counts()
            t0 = time.perf_counter()
            sr.step(params)
            sr.block_until_ready()
            dt = time.perf_counter() - t0
            img = sr.image()
            launches = _counts()
            iters = sr.last_stats["shard_iterations"]
            n_iter = sum(iters.values())
            waves = len(iters) if engine == "persistent" else 0
            bounces = n_iter if engine == "bounce" else 0
            # A shard renders PARALLEL_SPP / sample samples of its pixels.
            samples = tile * PARALLEL_SPP if engine == "bounce" else 0
            expect = dict(tonemap=1, fetch_chain=0, walk=0,
                          threaded_walk=2 * bounces, service=0, wave=waves,
                          lane_init=waves, bounce_rays=samples,
                          bounce_shade=bounces, bounce_nee=bounces,
                          advances=waves)
            got = sr.accum_host()
            rays = (int(sr.last_stats["n_traced"]),
                    int(sr.last_stats["n_shadow"]))
            exact = got.tobytes() == want.tobytes()
            err = float(np.abs(got - want).max())
            same_img = img.tobytes() == want_img.tobytes() if sample == 1 \
                else None
            what = "rounds" if engine == "persistent" else "bounces"
            log(f"[parallel] {engine} mesh {tile}x{sample} on one card: "
                f"setup {setup:.2f} s, step {1e3 * dt:.1f} ms; sums "
                f"bit-equal to the Renderer's {exact}, max abs err {err!r}; "
                f"image equal {same_img}; (path, shadow) rays {rays} "
                f"Renderer {want_rays}; {what} by shard "
                f"{sorted(iters.items())}; launches in the sharded step "
                f"and image {launches}")
            if launches != expect:
                raise AssertionError(f"the {tile}x{sample} {engine} mesh "
                                     f"launched {launches}, not {expect}")
            if sorted(iters) != [(i, j) for i in range(tile)
                                 for j in range(sample)]:
                raise AssertionError(f"shards {sorted(iters)} rendered")
            if rays != want_rays:
                raise AssertionError("sharded ray totals differ")
            if sample == 1 and not (exact and same_img):
                raise AssertionError(f"the {tile}x1 mesh differs from the "
                                     "Renderer")
            if not err <= ATOL_SP:
                raise AssertionError(f"the {tile}x{sample} mesh is {err} "
                                     "off the Renderer")
            for name, n in launches.items():
                totals[name] += n
            out["meshes"].append(dict(engine=engine, tile=tile,
                                      sample=sample, ms=1e3 * dt,
                                      max_abs_err=err, exact=exact,
                                      launches=launches))
            del sr
        ref.reset()
    log(f"[parallel] launches of the sharded steps and images, summed over "
        f"the meshes: {totals}")
    if (totals["wave"] < 1 or totals["threaded_walk"] < 1 or totals["walk"]
            or totals["service"] or totals["bounce_shade"] < 1):
        raise AssertionError(f"the sharded renders launched {totals}")

    # Two processes on the one card over gloo, against one process.
    obj = os.path.join(tmp, "icosphere.obj")
    write_icosphere_obj(obj)
    scene = ["--scene", "cornell-nomesh", "--obj", f"{obj}:15:50,20,50",
             "--width", str(WIDTH), "--height", str(HEIGHT), "--frames", "1"]
    single = os.path.join(tmp, "single.ppm")
    _cli(["render", *scene, "--out", single])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    two = os.path.join(tmp, "two.ppm")
    base = [sys.executable, "-m", "tryraytrace_tpu_torch.cli", "render",
            *scene, "--out", two, "--coordinator", f"localhost:{port}",
            "--num-processes", "2", "--dist-backend", "gloo"]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(base + ["--process-id", str(i)], cwd=here,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=TWO_PROCESS_TIMEOUT_S)[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"process {i} exited {p.returncode}:\n"
                                 f"{logs[i][-3000:]}")
    same = load_ppm(two).tobytes() == load_ppm(single).tobytes()
    wrote = [line for line in logs[0].splitlines() if "[tpurt] wrote" in line]
    log(f"[parallel] two processes (gloo, one card, mesh 2x1 across them): "
        f"{seconds:.1f} s; PPM byte-equal to one process's {same}; process "
        f"0: {wrote}")
    log("[parallel] NCCL across cards: not run (this machine has one card)")
    if not same or not wrote or "[tpurt] wrote" in logs[1]:
        raise AssertionError("the two-process render differs")
    return dict(totals, two_process_s=seconds, **out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    count_advances()
    variants = bounce_variant_libraries()
    smi = phase_environment(variants.values())
    phase_cuda_vs_cpu()
    t0 = time.perf_counter()
    arrays = main_path_arrays()
    r = Renderer(arrays, cfg=RenderConfig(width=WIDTH, height=HEIGHT, spp=1))
    params = CameraController().get_params(WIDTH, HEIGHT)
    log(f"[main] {arrays.num_objects} triangles, leaf {r.scene.leaf_size}, "
        f"quad rows {r.scene.quad_table.shape[0]}, unified table "
        f"{tuple(r.inline.table.shape)}; setup {time.perf_counter() - t0:.2f} s")
    # The steps are timed before the first torch.profiler session
    # (_kernel_ms): after one, the same process steps far slower
    # (PERF.md; scripts/time_torch_step.py --profile-first).
    main_run = phase_main_path(r, params)
    _zero_counts()
    progressive = phase_progressive(r, arrays, params)
    progressive["counts"] = _counts()
    _zero_counts()
    tiled = phase_tiled(r, params)
    tiled["counts"] = _counts()
    phase_checkpoint(r, params)
    with tempfile.TemporaryDirectory() as tmp:
        cli_run = phase_cli(tmp)
        app_run = phase_app(arrays, tmp)
        bench_run = phase_bench()
        features_run, features_r = phase_features(r, params, tmp)
        bounce_run, rb = phase_bounce(arrays, r, params, tmp)
        parallel_run = phase_parallel(arrays, r, rb, params, tmp)
        # After every phase that times steps: its own time is the first
        # torch.profiler session.
        lane = phase_lane_init(r, features_r, params)
        tone = phase_tonemap()
        chain = phase_fetch(seed=0)
        walked, serviced = phase_walk(r, params)
        # The Moller-Trumbore leaf slots on the table the features path
        # walks (smooth shading and UV mapping on for its service states).
        walked_mt, serviced_features = phase_walk(features_r, params)
        serviced_more = phase_service(params)
        if not any(x["modes"][walk.TEXG] for x in serviced.values()):
            raise AssertionError("no [service] state of the main path had "
                                 "TEXG lanes in flight")
        waved = phase_wave(r, features_r, params, tmp,
                           chain["latency"]["global_ns"])
    threaded_states = phase_threaded_walk(rb, features_r, params,
                                          chain["latency"]["global_ns"])
    bounced = phase_bounce_kernels(rb, params, variants)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    keys = ("max_abs_err", "ms", "wrapper_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # Each kernel's launches on the paths counted with COUNTED: the main
    # path's, the progressive and tiled phases', the entry points'.
    main_counts = lambda name: dict(
        launches=main_run["counts"][name],
        progressive_launches=progressive["counts"][name],
        tiled_launches=tiled["counts"][name])
    path_counts = lambda name: dict(
        cli_launches=cli_run[name], app_launches=app_run[name],
        bench_launches=bench_run[name],
        features_launches=features_run[name],
        bounce_launches=bounce_run[name],
        parallel_launches=parallel_run[name],
        parallel_mesh_launches=per_mesh(name))
    # Each kernel's launches in each sharded step (and its image), by
    # engine and mesh.
    per_mesh = lambda name: {
        f"{m['engine']} {m['tile']}x{m['sample']}": m["launches"][name]
        for m in parallel_run["meshes"]}
    bw_walk = threaded_states["bw"]
    state_keys = (*keys, "rows_fetched", "active_lanes", "longest_walk",
                  "latency_bound_ms")
    log(json.dumps({"kernels": [
        dict(name="tonemap", route="cuda",
             source="tryraytrace_tpu_torch/csrc/tonemap.cu",
             replaces="tryraytrace_tpu/ops/pallas_tonemap.py:33",
             launches=main_run["launches"], **path_counts("tonemap"),
             **{k: tone[k] for k in keys}),
        dict(name="fetch_chain", route="cuda",
             source="tryraytrace_tpu_torch/csrc/fetch_chain.cu",
             replaces="scripts/microbench_pallas_fetch.py:34",
             launches=chain["launches"], **path_counts("fetch_chain"),
             **{k: chain[k] for k in keys},
             **{k: chain[k] for k in ("byte_bound_ms", "latency_bound_ms",
                                      "dram_bound_ms", "staged_rows", "sms",
                                      "sm_clock_mhz")},
             latency_ns=chain["latency"], variants=chain["variants"]),
        dict(name="quad_walk", route="cuda",
             source="tryraytrace_tpu_torch/csrc/quad_walk.cu",
             replaces="tryraytrace_tpu/engine/persistent.py:948",
             **main_counts("walk"), **path_counts("walk"),
             **{k: walked[k] for k in keys},
             rows_fetched=walked["rows_fetched"], plan=walked["plan"],
             build=kernel_builds(walk.LIBRARY, "quad_walk_kernel"),
             mt={k: walked_mt[k] for k in (*keys, "rows_fetched", "plan")}),
        dict(name="threaded_walk", route="cuda",
             source="tryraytrace_tpu_torch/csrc/threaded_walk.cu",
             replaces="tryraytrace_tpu/ops/traverse.py:696",
             also_replaces="tryraytrace_tpu/ops/traverse.py:742",
             launches=bounce_run["threaded_walk"],
             **path_counts("threaded_walk"),
             **{k: bw_walk["fresh"][k] for k in keys},
             longest_walk=bw_walk["fresh"]["longest_walk"],
             latency_bound_ms=bw_walk["fresh"]["latency_bound_ms"],
             build=threaded_states["build"],
             states={label: {k: res[k] for k in state_keys}
                     for label, res in bw_walk.items()},
             mt={label: {k: res[k] for k in state_keys}
                 for label, res in threaded_states["mt"].items()}),
        dict(name="service_pass", route="cuda",
             source="tryraytrace_tpu_torch/csrc/service_pass.cu",
             replaces="tryraytrace_tpu/engine/persistent.py:793",
             also_replaces="tryraytrace_tpu/engine/persistent.py:776,1166,"
                           "1265,1450",
             **main_counts("service"), **path_counts("service"),
             **{k: serviced["fresh"][k] for k in keys},
             bytes_ms=serviced["fresh"]["bytes_ms"],
             fp64_ms=serviced["fresh"]["fp64_ms"],
             build=ptxas_numbers(service.LIBRARY.compiler_log,
                                 "service_pass_kernel"),
             fp64_per_call=fp64_per_call(),
             states={label: {k: res[k] for k in (
                         *keys, "bytes_ms", "fp64_ms", "fp64_instructions",
                         "modes", "totals", "lanes", "calls")}
                     for label, res in (
                         *((f"main {x}", y) for x, y in serviced.items()),
                         *((f"features {x}", y)
                           for x, y in serviced_features.items()),
                         *serviced_more.items())}),
        dict(name="wave_advance", route="cuda",
             source="tryraytrace_tpu_torch/csrc/wave_advance.cu",
             replaces="tryraytrace_tpu/engine/persistent.py:623,635; "
                      "tryraytrace_tpu/engine/progressive.py:248",
             **main_counts("wave"), **path_counts("wave"),
             features_mt_launches=features_run["mt_wave"],
             **{k: waved[k] for k in keys},
             **{k: waved[k] for k in (
                 "rounds", "rows_fetched", "bytes_ms", "f32_ms", "fp64_ms",
                 "bound_bytes", "fp64_instructions", "rounds_bound_ms",
                 "latency_floor_ms", "longest_walks", "latency_ns", "plan",
                 "build")},
             cases=waved["cases"]),
        dict(name="lane_init", route="cuda",
             source="tryraytrace_tpu_torch/csrc/lane_init.cu",
             replaces="tryraytrace_tpu/engine/persistent.py:167; "
                      "tryraytrace_tpu/engine/camera_rays.py:21",
             **main_counts("lane_init"), **path_counts("lane_init"),
             **{k: lane[k] for k in keys},
             **{k: lane[k] for k in ("bound_bytes", "bytes_ms", "fp64_ms",
                                     "fp64_instructions", "build", "plan")},
             cases=lane["cases"]),
        *(dict(name=name, route="cuda",
               source="tryraytrace_tpu_torch/csrc/bounce.cu",
               replaces=replaces, launches=bounce_run[name],
               main_launches=main_run["counts"][name],
               **path_counts(name),
               **{k: res[k] for k in keys}, bound_bytes=res["bound_bytes"],
               bytes_ms=res.get("bytes_ms"), fp64_ms=res.get("fp64_ms"),
               build=bounced["build"][f"{name}_kernel"], **more)
          for name, replaces, res, more in (
              ("bounce_shade", "tryraytrace_tpu/engine/wavefront.py:97; "
               "tryraytrace_tpu/engine/wavefront.py:232",
               bounced["shade"]["fresh"],
               dict(dense_share=bounced["dense_share"], step=bounced["step"],
                    states={label: {k: x[k] for k in (
                        *keys, "depth", "entry", "served", "listed", "counts",
                        "lanes", "calls", "bound_bytes", "bytes_ms",
                        "fp64_ms", "list_bound_bytes", "list_bound_ms")}
                        for label, x in bounced["shade"].items()},
                    variants={name: {k: v for k, v in var.items()
                                     if k != "build"}
                              for name, var in bounced["variants"].items()})),
              ("bounce_nee", "tryraytrace_tpu/engine/wavefront.py:232",
               bounced["nee"]["fresh"],
               dict(states={label: {k: x[k] for k in (
                   *keys, "lit", "served", "listed", "bound_bytes",
                   "list_bound_bytes", "list_bound_ms")}
                   for label, x in bounced["nee"].items()})),
              ("bounce_rays", "tryraytrace_tpu/engine/wavefront.py:45; "
               "tryraytrace_tpu/engine/camera_rays.py:21",
               bounced["rays"], dict(lanes=bounced["rays"]["lanes"]))))]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except ProfilerBlind as e:
        if PROFILER_RETRY in sys.argv:
            raise
        # Every check so far passed; the times need a profiler that
        # records, so the whole run starts again in a fresh process (the
        # kernels' builds are reused), once.
        log(f"[profile] {e}; running again in a fresh process")
        sys.stderr.flush()
        os.execv(sys.executable, [sys.executable, os.path.abspath(__file__),
                                  PROFILER_RETRY])
