"""Command-line interface of the port:
``tpurt-torch render | interactive | bench | info`` (also
``python -m tryraytrace_tpu_torch.cli``).

The same commands, flags, defaults and output lines as the JAX
package's ``tpurt`` (tryraytrace_tpu/cli.py), on the card: every
command takes ``--device {cuda,cpu}`` (default ``cuda``), and without a
card it fails unless given ``--device cpu``; nothing moves to the CPU
on its own.  What the port does not render is refused with a message
and a non-zero exit, never ignored:

* ``bench`` without ``--config``: the repo-root ``bench.py`` is the JAX
  package's harness;
* ``--checkpoint-every`` with ``--progressive``: the progressive
  renderer has no checkpoint format (the JAX CLI drops the flag);
* a config the port does not render (a traversal or scheduler other
  than the default): config.py ``check_supported``.

``--engine bounce``, ``--smooth``, ``--uv`` (with the JAX CLI's
texture-slot rule for ``--obj`` meshes), ``--leaf-isect mt`` and
``--bvh-method sbvh`` render as in the JAX package.

``render`` takes the JAX CLI's parallel flags (parallel/): ``--sharded``
renders over a (dp, sp) mesh of every device (``--mesh-tile`` /
``--mesh-sample`` split it; ``--cpu-devices N`` makes it N shards of the
CPU); ``--coordinator HOST:PORT --num-processes P --process-id I`` joins
a torch.distributed process group first (NCCL on cards, gloo on the
CPU, or ``--dist-backend gloo`` for processes that share a card) and
renders over every process's devices.  Every process joins the
accumulator's gather; only process 0 writes the image and the
checkpoint.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tryraytrace_tpu_torch.benchmarks import CONFIGS
from tryraytrace_tpu_torch.config import RenderConfig, check_supported
from tryraytrace_tpu_torch.engine.state import resolve_device

def _add_scene_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="cornell",
                   help="cornell | cornell-nomesh | empty")
    p.add_argument("--obj", action="append", default=[],
                   help="extra mesh: path[:scale[:ox,oy,oz]] (repeatable)")
    p.add_argument("--width", type=int, default=1200)   # main.cpp:49
    p.add_argument("--height", type=int, default=800)   # main.cpp:50
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--max-depth", type=int, default=30)
    p.add_argument("--aperture", type=float, default=0.0)
    p.add_argument("--focus", type=float, default=240.0)
    p.add_argument("--engine", default=None,
                   help="persistent | bounce (default: config)")
    p.add_argument("--leaf-isect", default=None,
                   help="leaf intersection format: bw | mt (default: "
                        "config)")
    p.add_argument("--traversal", default=None,
                   help="quad (the port's only traversal)")
    p.add_argument("--scheduler", default=None,
                   help="owner (the port's only schedule)")
    p.add_argument("--smooth", action="store_true",
                   help="smooth shading from computed vertex normals")
    p.add_argument("--bvh-method", default=None,
                   help="sah | median | sbvh (default: config)")
    p.add_argument("--uv", action="store_true",
                   help="UV texture mapping: parse OBJ vt/slash faces "
                        "(the reference skips them) and sample textures "
                        "at interpolated per-vertex UVs; --obj entries "
                        "get texture slot 0 when UVs are present")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="render device (default: the CUDA card; fails "
                        "without one unless --device cpu)")


def build_scene_arrays(args):
    from tryraytrace_tpu_torch.io.ppm import load_ppm
    from tryraytrace_tpu_torch.scene.assets import checker_texture, find_asset
    from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
    from tryraytrace_tpu_torch.scene.model import Scene, flatten_scene
    from tryraytrace_tpu_torch.scene.objloader import load_obj

    if args.scene == "cornell":
        scene = create_cornell_box()
    elif args.scene == "cornell-nomesh":
        scene = create_cornell_box(mesh=None)
    elif args.scene == "empty":
        scene = Scene()
    else:
        raise SystemExit(f"unknown scene {args.scene!r}")

    for spec in args.obj:
        parts = spec.split(":")
        path = find_asset(parts[0]) or parts[0]
        scale = float(parts[1]) if len(parts) > 1 else 1.0
        offset = (tuple(float(x) for x in parts[2].split(","))
                  if len(parts) > 2 else (0.0, 0.0, 0.0))
        if args.uv:
            before = len(scene.objects)
            load_obj(path, scene.objects, offset=offset, scale=scale,
                     parse_uv=True,
                     tex_id=0 if scene.texture_files else -1)
            # Meshes that came back without any UVs stay untextured.
            if not any(o.uv0 is not None
                       for o in scene.objects[before:]):
                for o in scene.objects[before:]:
                    o.tex_id = -1
        else:
            load_obj(path, scene.objects, offset=offset, scale=scale)

    # earth.ppm is absent from the reference mount; substitute the
    # checker stand-in so tex_id 0 renders (SURVEY.md section 0).
    textures = None
    if scene.texture_files:
        textures = []
        for f in scene.texture_files:
            p = find_asset(f.split("/")[-1])
            if p is not None:
                textures.append(load_ppm(p).astype(np.float32) / 255.0)
            else:
                textures.append(checker_texture(256))
    return flatten_scene(scene, textures=textures)


def _cfg_from_args(args) -> RenderConfig:
    """The render config the flags ask for; exits with check_supported's
    message when the port does not render it."""
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth)
    if args.engine:
        cfg = cfg.replace(engine=args.engine)
    if args.traversal:
        cfg = cfg.replace(traversal=args.traversal)
    if args.leaf_isect:
        cfg = cfg.replace(leaf_isect=args.leaf_isect)
    if args.scheduler:
        cfg = cfg.replace(scheduler=args.scheduler)
    if args.smooth:
        cfg = cfg.replace(smooth_shading=True)
    if args.uv:
        cfg = cfg.replace(uv_mapping=True)
    if args.bvh_method:
        cfg = cfg.replace(bvh_method=args.bvh_method)
    try:
        check_supported(cfg)
    except ValueError as e:
        raise SystemExit(f"[tpurt] {e}") from None
    return cfg


def _device(args) -> torch.device:
    # --cpu-devices asks for shards of the CPU (the JAX CLI's flag forces
    # its CPU platform).
    device = "cpu" if getattr(args, "cpu_devices", None) else args.device
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(f"[tpurt] {e} (on the command line: --device "
                         "cpu)") from None


def _make_renderer(args, arrays, cfg, device):
    """One device's Renderer, or a ShardedRenderer over the (dp, sp) mesh
    of every process's devices once init_distributed has run, else of
    this process's: every card, or ``--cpu-devices`` shards of the CPU."""
    if not (args.coordinator or args.sharded):
        from tryraytrace_tpu_torch.engine.renderer import Renderer

        return Renderer(arrays, cfg=cfg, device=device)
    from tryraytrace_tpu_torch.parallel.mesh import make_mesh
    from tryraytrace_tpu_torch.parallel.shard import ShardedRenderer

    devices = None
    if device.type == "cpu" and not args.coordinator:
        devices = [device] * (args.cpu_devices or 1)
    mesh = make_mesh(devices, tile=args.mesh_tile, sample=args.mesh_sample)
    return ShardedRenderer(arrays, cfg, mesh=mesh)


def cmd_render(args) -> int:
    from tryraytrace_tpu_torch.parallel import distributed

    cfg = _cfg_from_args(args)
    device = _device(args)
    if args.checkpoint and not args.checkpoint.endswith(".npz"):
        raise SystemExit(f"[tpurt] --checkpoint {args.checkpoint!r}: the "
                         "port writes .npz checkpoints only (Orbax "
                         "directories are JAX-only)")
    # Joining the process group comes before anything else.
    if args.coordinator:
        distributed.init_distributed(
            args.coordinator, args.num_processes or 1, args.process_id or 0,
            cpu_devices_per_process=args.cpu_devices, device=device,
            backend=args.dist_backend)
    try:
        return _render(args, cfg, device)
    finally:
        distributed.shutdown()


def _render(args, cfg, device) -> int:
    from tryraytrace_tpu_torch.camera.controller import CameraController
    from tryraytrace_tpu_torch.engine.state import (RenderState,
                                                    load_checkpoint,
                                                    save_checkpoint)
    from tryraytrace_tpu_torch.io.ppm import save_image
    from tryraytrace_tpu_torch.parallel import distributed
    from tryraytrace_tpu_torch.utils.logging import log_event
    from tryraytrace_tpu_torch.utils.profiling import PhaseTimer, trace_context

    timer = PhaseTimer()
    with timer.phase("build+upload"):
        arrays = build_scene_arrays(args)
        r = _make_renderer(args, arrays, cfg, device)
    sharded = not hasattr(r, "step_tiled")
    cam = CameraController()
    cam.aperture = args.aperture
    cam.focus_dist = args.focus

    if args.resume:
        state, w, h, frame_seed, saved_cam = load_checkpoint(
            args.resume, device="cpu" if sharded else r.device)
        if (w, h) != (cfg.width, cfg.height):
            raise SystemExit(f"checkpoint is {w}x{h}, requested "
                             f"{cfg.width}x{cfg.height}")
        # The frame counter seeds the next step's streams: without it
        # the resumed frames would draw frame 1's samples again.
        if sharded:
            r.restore(state)   # each process keeps its rows' blocks
        else:
            r.state = state
        r.frame = frame_seed
        if saved_cam is not None:
            cam = saved_cam
        log_event("resume", path=args.resume, spp=r.spp())

    params = cam.get_params(cfg.width, cfg.height)
    t0 = time.perf_counter()
    with timer.phase("render"):
        with trace_context("render"):
            for _ in range(args.frames):
                if args.tiles > 1 and not sharded:
                    r.step_tiled(params, args.tiles)
                else:
                    r.step(params)
        r.block_until_ready()
    dt = time.perf_counter() - t0
    log_event("render_done", frames=args.frames, spp=r.spp(),
              ms_per_frame=round(dt / max(args.frames, 1) * 1e3, 2))

    # Every process joins the gathers (collectives on a mesh across
    # processes); only process 0 writes.
    state = None
    if args.checkpoint:
        state = (RenderState(torch.from_numpy(r.accum_host().reshape(-1, 3)),
                             r.spp()) if sharded else r.state)
    with timer.phase("tonemap+write"):
        # On the card the tonemap kernel runs there and only the uint8
        # pixels are copied out.
        img = r.image()
        if distributed.process_index() == 0:
            save_image(args.out, img)
    if distributed.process_index() == 0:
        if args.checkpoint:
            save_checkpoint(args.checkpoint, state, cfg.width, cfg.height,
                            camera=cam, frame_seed=r.frame)
            log_event("checkpoint_saved", path=args.checkpoint)
        print(f"[tpurt] wrote {args.out} ({cfg.width}x{cfg.height}, "
              f"{r.spp()} spp, {dt:.2f}s)")
    print(timer.summary(), file=sys.stderr)
    return 0


def cmd_interactive(args) -> int:
    from tryraytrace_tpu_torch.display.app import App, ProgressiveApp
    from tryraytrace_tpu_torch.display.input import ScriptedInput

    cfg = _cfg_from_args(args)
    device = _device(args)
    arrays = build_scene_arrays(args)
    window = not args.headless
    if window:
        try:
            import pygame  # noqa: F401
        except ImportError:
            print("[tpurt] pygame not available; running headless")
            window = False
    script = None
    if args.script:
        with open(args.script) as f:
            script = ScriptedInput(json.load(f))
    if args.progressive:
        # Cross-frame progressive wave (engine/progressive.py): no
        # per-frame drain, per-pixel progressive accumulation.
        app = ProgressiveApp(arrays, cfg, input_source=script,
                             window=window, out_dir=args.out_dir,
                             device=device)
    else:
        app = App(arrays, cfg, input_source=script, window=window,
                  out_dir=args.out_dir,
                  checkpoint_every=args.checkpoint_every, device=device)
    app.run(max_frames=args.frames)
    print(f"[tpurt] displayed {app.frames_displayed} frames; "
          f"snapshots: {app.snapshots}")
    return 0


def cmd_bench(args) -> int:
    from tryraytrace_tpu_torch.benchmarks import run_config

    _cfg_from_args(args)
    device = _device(args)
    names = CONFIGS if args.config == "all" else [args.config]
    cfg_kw = {}
    if args.leaf_size is not None:
        cfg_kw["bvh_leaf_size"] = args.leaf_size
    for name in names:
        print(json.dumps(run_config(name, frames=args.frames,
                                    cfg_kw=cfg_kw or None, device=device)),
              flush=True)
    return 0


def cmd_info(args) -> int:
    from tryraytrace_tpu_torch.accel.bvh import build_bvh

    _cfg_from_args(args)
    device = _device(args)
    if device.type == "cuda":
        where = (f"{torch.cuda.get_device_name(device)} x"
                 f"{torch.cuda.device_count()}")
    else:
        where = "cpu"
    print(f"torch {torch.__version__}; device: {where}")
    arrays = build_scene_arrays(args)
    bvh = build_bvh(arrays.tri_v0, arrays.tri_v1, arrays.tri_v2,
                    leaf_size=8)
    print(f"scene: {arrays.num_objects} triangles, "
          f"{arrays.num_lights} lights, {len(arrays.textures)} textures")
    print(f"bvh: {bvh.num_nodes} nodes, depth {bvh.max_depth()}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpurt-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="offline progressive render -> PPM")
    _add_scene_args(p)
    p.add_argument("--frames", type=int, default=16,
                   help="progressive passes (each adds --spp samples)")
    p.add_argument("--out", default="out.ppm")
    p.add_argument("--checkpoint", default=None,
                   help="save accumulator+camera after rendering (*.npz)")
    p.add_argument("--resume", default=None,
                   help="resume from a .npz checkpoint of either package")
    p.add_argument("--tiles", type=int, default=0,
                   help="render each pass as N sequential pixel-strip "
                        "waves (bit-identical)")
    p.add_argument("--sharded", action="store_true",
                   help="render over a (dp, sp) device mesh of every "
                        "device")
    p.add_argument("--mesh-tile", type=int, default=None,
                   help="dp (pixel-row) shards of the mesh")
    p.add_argument("--mesh-sample", type=int, default=None,
                   help="sp (sample) shards of the mesh")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process: process 0's rendezvous address "
                        "(implies --sharded)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--cpu-devices", type=int, default=None,
                   help="shards of the CPU per process (renders on the "
                        "CPU)")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend (default: nccl on "
                        "cards, gloo on the CPU; gloo lets processes "
                        "share a card)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("interactive", help="windowed/headless game loop")
    _add_scene_args(p)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--headless", action="store_true")
    p.add_argument("--script", default=None,
                   help="JSON input script (see display/input.py)")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="autosave render state every N frames (0 = off; "
                        "batch app only)")
    p.add_argument("--progressive", action="store_true",
                   help="cross-frame progressive wave: no per-frame "
                        "drain, per-pixel progressive sample counts "
                        "(engine/progressive.py)")
    p.set_defaults(fn=cmd_interactive)

    p = sub.add_parser("bench", help="performance benchmark (JSON lines)")
    _add_scene_args(p)
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--config", default=None, choices=CONFIGS + ("all",),
                   help="benchmark config, or all")
    p.add_argument("--leaf-size", type=int, default=None,
                   help="BVH fat-leaf size (0 = auto; default: "
                        "RenderConfig default)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("info", help="device + scene info")
    _add_scene_args(p)
    p.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cmd == "bench" and args.config is None:
        ap.error("bench needs --config NAME|all: the repo-root bench.py "
                 "is the JAX package's harness")
    if (args.cmd == "interactive" and args.progressive
            and args.checkpoint_every):
        ap.error("--checkpoint-every works with the batch app only: the "
                 "progressive renderer has no checkpoint format")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
