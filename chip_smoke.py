"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernel from the sources in this
checkout, checks it against its plain PyTorch version on the card,
checks the port's render on the card against the port's render on the
CPU, then drives the main path (Renderer -> render_frame_persistent
-> Renderer.image) at the reference's interactive operating point,
1200x800 at 1 spp per step, on a 20,487-triangle Cornell box built in
the repo.  Every phase prints its own lines; any failure raises and
the script exits non-zero.  The last line is a JSON object
{"ok": true, "device": {...}} and the line before it the kernel table.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.ops import tonemap as tm
from tryraytrace_tpu_torch.scene.assets import (checker_texture, cube_mesh,
                                                icosphere_mesh)
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import Object, flatten_scene

WIDTH, HEIGHT = 1200, 800      # reference main.cpp:49-50
TIMED_STEPS = 4
TONEMAP_SHAPE = (WIDTH * HEIGHT, 3)
# Kernel vs plain version: bytes may differ only by 1, only where
# p * 255 + 0.5 sits within a float32 ulp of an integer (a powf
# rounding boundary), and in at most this share of the bytes.
MAX_BOUNDARY_SHARE = 1e-5
RENDER_MSE = 1e-9              # port on the card vs port on the CPU


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([tm._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{nvcc.stdout.strip().splitlines()[-1]}")
    log(f"[env] device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    path = tm.build_library()
    log(f"[build] {path} in {tm._Library.build_seconds:.3f} s")
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
    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = (lambda: tm.tonemap_plain(acc, 3)) if name == "plain" else (
            lambda: tm.tonemap_cuda(acc, 3))
        runs[name].append(_time_ms(fn))
    ms, plain_ms = float(np.mean(runs["kernel"])), float(
        np.mean(runs["plain"]))
    log(f"[tonemap] {list(TONEMAP_SHAPE)} f32: kernel {ms:.4f} ms "
        f"(runs {runs['kernel']}), plain {plain_ms:.4f} ms "
        f"(runs {runs['plain']}); {mismatches} differing bytes of {total}")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def render_once(arrays, w, h, device) -> np.ndarray:
    r = Renderer(arrays, cfg=RenderConfig(width=w, height=h, spp=1),
                 device=device)
    r.step(CameraController().get_params(w, h))
    return r.accum_host()


def phase_cuda_vs_cpu() -> float:
    arrays = cube256_arrays()
    t0 = time.perf_counter()
    on_card = render_once(arrays, 64, 64, "cuda")
    t1 = time.perf_counter()
    on_cpu = render_once(arrays, 64, 64, "cpu")
    t2 = time.perf_counter()
    mse = float(((on_card - on_cpu) ** 2).mean())
    log(f"[cube256 64x64] card vs CPU MSE {mse!r} (card {t1 - t0:.2f} s, "
        f"CPU {t2 - t1:.2f} s, mean radiance {float(on_card.mean())!r})")
    if not np.isfinite(on_card).all() or not mse < RENDER_MSE:
        raise AssertionError(f"card render disagrees with the CPU: {mse}")
    if not on_card.mean() > 0.0:
        raise AssertionError("cube256 render is black")
    return mse


def phase_main_path() -> dict:
    t0 = time.perf_counter()
    arrays = main_path_arrays()
    r = Renderer(arrays, cfg=RenderConfig(width=WIDTH, height=HEIGHT,
                                          spp=1), device="cuda")
    params = CameraController().get_params(WIDTH, HEIGHT)
    log(f"[main] {arrays.num_objects} triangles, leaf {r.scene.leaf_size}, "
        f"quad rows {r.scene.quad_table.shape[0]}, unified table "
        f"{tuple(r.inline.table.shape)}; setup {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    tm.tonemap_cuda.launches = 0
    t0 = time.perf_counter()
    r.step(params)
    r.block_until_ready()
    log(f"[main] warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms, "
        f"{r.last_stats['iterations']} iterations")
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
                          iterations=st["iterations"],
                          mrays_per_s=rays / dt / 1e6))
        log(f"[main] step {1e3 * dt:.1f} ms, path rays {steps[-1]['path']}, "
            f"shadow rays {steps[-1]['shadow']}, {st['iterations']} "
            f"iterations, {steps[-1]['mrays_per_s']:.3f} Mrays/s")
    img = r.image()
    launches = tm.tonemap_cuda.launches
    accum = r.state.accum
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(accum).all()):
        raise AssertionError("non-finite radiance in the accumulator")
    if img.shape != (HEIGHT, WIDTH, 3) or img.dtype != np.uint8:
        raise AssertionError(f"image {img.shape} {img.dtype}")
    if launches < 1:
        raise AssertionError("the main path never launched the tonemap kernel")
    if not img.max() > 0:
        raise AssertionError("the image is all black")
    want = tm.tonemap_plain(accum.cpu(), r.spp()).numpy().reshape(img.shape)
    off = np.abs(img.astype(np.int32) - want.astype(np.int32))
    log(f"[main] image mean {float(img.mean())!r}, spp {r.spp()}, peak "
        f"device memory {peak} B, tonemap launches {launches}, "
        f"bytes off the CPU tonemap {int((off > 0).sum())} (max {int(off.max())})")
    ms = float(np.mean([s["ms"] for s in steps]))
    return dict(steps=steps, launches=launches, ms_per_step=ms,
                mrays_per_s=float(np.mean([s["mrays_per_s"] for s in steps])),
                peak_bytes=peak, image_mean=float(img.mean()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_environment()
    tone = phase_tonemap()
    phase_cuda_vs_cpu()
    main_run = phase_main_path()
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": [dict(
        name="tonemap", route="cuda",
        source="tryraytrace_tpu_torch/csrc/tonemap.cu",
        replaces="tryraytrace_tpu/ops/pallas_tonemap.py:33",
        launches=main_run["launches"], max_abs_err=tone["max_abs_err"],
        ms=tone["ms"], plain_ms=tone["plain_ms"])]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
