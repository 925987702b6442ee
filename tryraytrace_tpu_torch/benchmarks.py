"""The measurement configs of the JAX package's benchmarks.py, runnable
on the port one at a time (``tpurt-torch bench --config <name>``) or
all together.

Each run returns a JSON-able dict with Mrays/s, ms/frame, the device it
ran on and, for cube256, the MSE against the NumPy oracle -- the
acceptance check.  The ray count is exact: the int64 path + shadow ray
counters of the timed frames' steps (``Renderer.last_stats``).  The
repo holds no ``.obj`` asset, so each mesh config renders a cube in
place of a missing mesh and says so on stderr, as the JAX package does.
"""

from __future__ import annotations

import sys
import time

import torch

from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine.progressive import ProgressiveRenderer
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.scene.assets import checker_texture, cube_mesh, find_asset
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import Object, Scene, flatten_scene
from tryraytrace_tpu_torch.scene.objloader import load_obj
from tryraytrace_tpu_torch.utils.profiling import mrays_per_sec

CONFIGS = ("cube256", "teapot512", "cow800", "teddy1024",
           "flythrough1080", "interactive")


def _cornell_with(meshes: list[tuple[str, float, tuple]]) -> Scene:
    scene = create_cornell_box(mesh=None)
    for name, scale, offset in meshes:
        path = find_asset(name)
        if path is not None:
            load_obj(path, scene.objects, offset=offset, scale=scale,
                     albedo=(0.75, 0.75, 0.75), metallic=0.0, roughness=1.0)
        else:
            print(f"[bench] asset {name} missing; substituting cube", file=sys.stderr)
            v0, v1, v2 = cube_mesh(scale)
            for a, b, c in zip(v0 + offset, v1 + offset, v2 + offset):
                scene.objects.append(Object(v0=tuple(a), v1=tuple(b),
                                            v2=tuple(c),
                                            albedo=(0.75, 0.75, 0.75),
                                            roughness=1.0))
    return scene


def build_config(name: str):
    """-> (SceneArrays, width, height, spp, check_oracle)."""
    if name == "cube256":
        scene = _cornell_with([("cube.obj", 15.0, (50.0, 20.0, 50.0))])
        return flatten_scene(scene, textures=[checker_texture(64)]), \
            256, 256, 1, True
    if name == "teapot512":
        scene = _cornell_with([("teapot.obj", 10.0, (50.0, 10.0, 50.0))])
        return flatten_scene(scene, textures=[checker_texture(128)]), \
            512, 512, 4, False
    if name == "cow800":
        scene = _cornell_with([("cow.obj", 10.0, (50.0, 30.0, 50.0))])
        return flatten_scene(scene, textures=[checker_texture(256)]), \
            800, 600, 16, False
    if name == "teddy1024":
        scene = _cornell_with([
            ("teddy.obj", 1.5, (30.0, 35.0, 60.0)),
            ("pumpkin.obj", 0.12, (70.0, 0.0, 60.0)),
        ])
        return flatten_scene(scene, textures=[checker_texture(128)]), \
            1024, 1024, 64, False
    if name == "interactive":
        # The reference's dev operating point: 1200x800 window, 1 spp
        # per frame (main.cpp:49-50,181), over the default Cornell +
        # teapot scene it opens with (scene.cpp:24-123).
        scene = _cornell_with([("teapot.obj", 10.0, (50.0, 10.0, 50.0))])
        return flatten_scene(scene, textures=[checker_texture(256)]), \
            1200, 800, 1, False
    if name == "flythrough1080":
        scene = _cornell_with([
            ("teapot.obj", 10.0, (50.0, 10.0, 50.0)),
            ("cow.obj", 8.0, (25.0, 25.0, 80.0)),
            ("teddy.obj", 1.2, (75.0, 30.0, 40.0)),
        ])
        return flatten_scene(scene, textures=[checker_texture(256)]), \
            1920, 1080, 16, False
    raise ValueError(f"unknown config {name!r}; choose from {CONFIGS}")


def spp_chunk(width: int, height: int, spp: int) -> int:
    """Samples per step call: at most ~2e8 traced rays (~12 per primary
    sample) a call, and a divisor of ``spp``.  It is the JAX package's
    rule (its benchmarks.py ``run_config``) kept exactly, because it sets
    the spp of each step and so the seed schedule
    ``1984 + frame*spp + sample``: another chunking renders another
    image."""
    chunk = max(1, min(spp, int(2e8 / (width * height * 12))))
    while spp % chunk:
        chunk -= 1
    return chunk


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def run_progressive(name: str, frames: int = 10, device="cuda") -> dict:
    """Measure the cross-frame progressive wave (engine/progressive.py)
    at config ``name``'s raster: sustained Mrays/s plus ms per
    1-spp-equivalent frame (the mean per-pixel sample count advancing by
    1 is one reference frame's worth of work, main.cpp:181).

    A frame's budget is in rounds (a lane's walk and one service each),
    calibrated to ~1 mean sample per frame from a warm-up
    probe."""
    arrays, w, h, _spp, _ = build_config(name)
    cfg = RenderConfig(width=w, height=h, spp=1)
    pr = ProgressiveRenderer(arrays, cfg=cfg, device=device)
    cam = CameraController().get_params(w, h)

    # Warm up (the first call builds the walk kernel), then calibrate
    # rounds per mean sample.
    t0 = time.perf_counter()
    pr.step(cam, 4)
    pr.block_until_ready()
    compile_s = time.perf_counter() - t0
    m0 = float(pr.snapshot()[1].mean())
    pr.step(cam, 16)
    pr.block_until_ready()
    m1 = float(pr.snapshot()[1].mean())
    per_iter = max((m1 - m0) / 16.0, 1e-6)
    iters = max(1, round(1.0 / per_iter))

    r0 = pr.rays_traced()
    t0 = time.perf_counter()
    for _ in range(frames):
        pr.step(cam, iters)
        pr.block_until_ready()
    dt = (time.perf_counter() - t0) / frames
    rays = (pr.rays_traced() - r0) / frames
    m2 = float(pr.snapshot()[1].mean())
    spp_per_frame = max((m2 - m1) / frames, 1e-9)
    return dict(
        config=name, mode="progressive", width=w, height=h,
        tris=arrays.num_objects, iters_per_frame=iters,
        ms_per_frame=round(dt * 1e3, 2),
        spp_per_frame=round(spp_per_frame, 3),
        ms_per_1spp=round(dt * 1e3 / spp_per_frame, 2),
        fps=round(1.0 / dt, 2),
        mrays_per_s=round(mrays_per_sec(rays, dt), 3),
        compile_s=round(compile_s, 1),
        device=_device_name(pr.device),
    )


def run_config(name: str, frames: int = 2, cfg_kw: dict | None = None,
               device="cuda") -> dict:
    """Render config ``name``: one warm-up frame, then ``frames`` timed
    frames of ``spp`` samples (``spp // spp_chunk`` steps each), each
    after a camera move for flythrough1080; for cube256 also one frame
    against the oracle.  ``cfg_kw`` adds RenderConfig fields (the CLI's
    ``--leaf-size``)."""
    from tryraytrace_tpu_torch.oracle.cpu_renderer import oracle_render

    arrays, w, h, spp, check = build_config(name)
    chunk = spp_chunk(w, h, spp)
    cfg = RenderConfig(width=w, height=h, spp=chunk, **(cfg_kw or {}))
    r = Renderer(arrays, cfg=cfg, device=device)
    cam = CameraController()

    # Warm up (the first step builds the walk kernel).
    params = cam.get_params(w, h)
    r.step(params)
    r.block_until_ready()

    stats = []
    t0 = time.perf_counter()
    for _ in range(frames):
        if name == "flythrough1080":
            # Scripted camera path: the config-5 animated fly-through.
            cam.update(1.0, {"w"})
            cam.process_mouse(30.0, 0.0)
            r.reset()
            params = cam.get_params(w, h)
        for _ in range(spp // chunk):
            r.step(params)
            stats.append(r.last_stats)
        r.block_until_ready()
    dt = (time.perf_counter() - t0) / frames
    rays = sum(int(st["n_traced"]) + int(st["n_shadow"])
               for st in stats) / frames

    result = dict(
        config=name, width=w, height=h, spp=spp,
        tris=arrays.num_objects,
        ms_per_frame=round(dt * 1e3, 2),
        fps=round(1.0 / dt, 2),
        rays_per_frame=rays,
        mrays_per_s=round(mrays_per_sec(rays, dt), 3),
        engine=cfg.engine,
        device=_device_name(r.device),
    )
    if check:
        r.reset()
        r.step(params)
        eng = r.accum_host().reshape(-1, 3) / max(r.spp(), 1)
        ora = oracle_render(arrays, params, w, h,
                            frame_seed=1, spp=spp, cfg=cfg) / spp
        result["mse_vs_oracle"] = float(((eng - ora) ** 2).mean())
    return result
