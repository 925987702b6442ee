"""The bounce engine (the counterpart of tryraytrace_tpu/engine/
wavefront.py): the JAX package's cross-check engine, and the frame
dispatch over both engines.

The whole wave of a sample advances bounce by bounce in lockstep:

  raygen -> [closest-hit walk -> shade (+ NEE any-hit walk)] x depth

Each stage is masked tensor math over every lane of the wave; dead
lanes are masked, not compacted, and the loop runs while
``depth < max_depth`` and any lane is alive, so the ray counts are the
JAX engine's.  The two walks are the threaded walks of ops/threaded.py:
the hand-written CUDA kernel on a card, its plain version on the CPU,
both over the walk-order copy of the scene's threaded rows
(``ops/threaded.py walk_table``; ``engine_tables`` builds it, so a
refit rebuilds it).
Textures are sampled from the raw texture tensors
(``device_scene.device_textures``), not from the persistent engine's
tile rows.

Every constant, epsilon and draw order is the reference's, and the
arithmetic is the persistent engine's (ops/shade.py, core/rng.py,
core/vec.py), so both engines give the same sums up to exact ties in
the closest hit, which only the walks' visit order decides.  The ray
counters are int64.

``render_frame`` renders a frame's samples with either engine
(``cfg.engine``) and takes the pixel set, the sample offset and the
seed schedule's spp, which a shard of the parallel layer needs
(parallel/shard.py).
"""

from __future__ import annotations

import torch

from tryraytrace_tpu_torch.config import RenderConfig, check_supported
from tryraytrace_tpu_torch.core import rng
from tryraytrace_tpu_torch.engine.camera_rays import generate_rays
from tryraytrace_tpu_torch.engine.device_scene import device_textures
from tryraytrace_tpu_torch.ops import shade
from tryraytrace_tpu_torch.ops.texture import sample_textures
from tryraytrace_tpu_torch.ops.threaded import (any_hit, closest_hit,
                                                walk_table)

def _sanitize(rad, cfg: RenderConfig):
    """Sample sanitation before accumulation (renderer.cu:737-756):
    NaN/Inf drops the whole sample, negatives clamp to 0, luminance
    fireflies rescale to ``cfg.firefly_clamp``."""
    bad = (torch.isnan(rad) | torch.isinf(rad)).any(dim=-1)
    rad = torch.where(bad[..., None], 0.0, rad)
    rad = torch.clamp(rad, min=0.0)
    if cfg.clamp_fireflies:
        lum = rad[..., 0] * 0.21 + rad[..., 1] * 0.71 + rad[..., 2] * 0.07
        over = lum > cfg.firefly_clamp
        # A tensor division: torch computes ``c / t`` as
        # ``reciprocal(t) * c``, which rounds twice.
        clamp = torch.full_like(lum, cfg.firefly_clamp)
        scale = torch.where(over, clamp / torch.where(over, lum, 1.0), 1.0)
        rad = rad * scale[..., None]
    return rad


def render_sample(scene, walk, textures, cam, seed: int, width: int,
                  height: int, cfg: RenderConfig, pixels=None):
    """Trace one 1-spp pass for ``pixels`` (int64 [N] on the scene's
    device; every pixel by default) with sample seed ``seed`` over the
    walk-order threaded rows ``walk`` (``ops/threaded.py walk_table``) ->
    (radiance [N, 3], stats).  Streams are keyed by absolute pixel, so
    a pixel subset renders its pixels' samples exactly.  ``cam`` holds
    tensors on the scene's device (CameraParams.to).

    stats: ``n_traced`` (path rays, camera rays included) and
    ``n_shadow`` (NEE shadow rays) as int64 tensors, ``iterations`` (the
    bounces run) and ``rows_fetched`` (int64 tensor: threaded rows both
    walks fetched)."""
    dev = scene.trimat.device
    if pixels is None:
        pixels = torch.arange(width * height, device=dev)
    n = int(pixels.shape[0])
    o, d = generate_rays(cam, width, height,
                         torch.full((n,), seed, dtype=torch.int64,
                                    device=dev), pixels)
    tp = torch.ones((n, 3), device=dev)
    rad = torch.zeros((n, 3), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_spec = torch.ones((n,), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n_traced, n_shadow, rows = zero, zero, zero
    depth = 0
    while depth < cfg.max_depth and bool(alive.any()):
        n_traced = n_traced + alive.sum()
        o, d, tp, rad, alive, prev_spec, sh, rw = _bounce(
            scene, walk, textures, seed, pixels, depth, o, d, tp, rad,
            alive, prev_spec, cfg)
        n_shadow = n_shadow + sh
        rows = rows + rw
        depth += 1
    return _sanitize(rad, cfg), dict(n_traced=n_traced, n_shadow=n_shadow,
                                     iterations=depth, rows_fetched=rows)


def _bounce(scene, walk, textures, seed: int, pixels, depth: int, o, d, tp,
            rad, alive, prev_spec, cfg: RenderConfig):
    """One wavefront bounce: closest-hit walk, shade (ops/shade.py
    ``surface`` and ``scatter``, the texture sampled from the raw
    textures), the NEE shadow rays as one any-hit walk, next-ray
    selection.  Returns (o, d, tp, rad, alive, prev_spec, shadow rays
    fired, rows fetched)."""
    t, hit_id, rows = closest_hit(walk, scene.leaf_size, o, d, alive,
                                  fmt=scene.leaf_fmt)
    alive = alive & (hit_id >= 0)  # miss -> path ends (renderer.cu:427)
    hitrow = scene.trimat[torch.clamp(hit_id, min=0)]
    q, uv = shade.surface(hitrow, o + d * t[:, None], d, scene, cfg,
                          textured=bool(textures))
    if uv is not None:
        q["albedo"] = q["albedo"] * sample_textures(
            textures, hitrow[:, 19].to(torch.int64), *uv)

    # The bounce's seven draws in one hash: slots 0..6 of this depth.
    base = rng.CAMERA_DRAWS + depth * rng.DRAWS_PER_BOUNCE
    slots = torch.arange(rng.SLOT_LIGHT_R2 + 1, device=pixels.device)
    u = rng.uniform(seed, pixels[:, None], base + slots)
    rr_on = torch.full_like(alive, depth > cfg.rr_threshold)
    out = shade.scatter(q, d, tp, rad, alive, prev_spec, u, rr_on, scene,
                        cfg)
    rad = out["rad"]
    n_shadow = torch.zeros((), dtype=torch.int64, device=pixels.device)
    if out["nee"] is not None:
        geo_ok, so, sd, smax, contrib = out["nee"]
        occluded, nee_rows = any_hit(walk, scene.leaf_size, so, sd, smax,
                                     geo_ok, fmt=scene.leaf_fmt)
        rad = rad + torch.where((geo_ok & ~occluded)[:, None], contrib, 0.0)
        n_shadow = geo_ok.sum()
        rows = rows + nee_rows
    return (out["o"], out["d"], out["tp"], rad, out["alive"],
            out["prev_spec"], n_shadow, rows)


def engine_tables(scene, textures, cfg: RenderConfig) -> tuple:
    """(inline, texture tensors): what ``render_frame``'s engine reads
    besides the scene, on the scene's device.  The persistent engine
    reads its unified table (engine/persistent.py
    ``build_inline_table``), the bounce engine the walk-order copy of the
    threaded rows (``ops/threaded.py walk_table``) and the raw textures;
    ``textures`` are the upload's [H, W, 3] NumPy textures."""
    if cfg.engine == "bounce":
        return (walk_table(scene.node_table, scene.leaf_size,
                           scene.leaf_fmt),
                device_textures(textures, scene.trimat.device))
    from tryraytrace_tpu_torch.engine.persistent import build_inline_table

    return build_inline_table(scene, textures), ()


def render_frame(scene, inline, textures, cam, frame_seed: int, width: int,
                 height: int, cfg: RenderConfig, spp: int | None = None,
                 pixels=None, sample_offset: int = 0,
                 seed_spp: int | None = None):
    """One frame's radiance sums over ``spp`` samples of ``pixels`` (a
    ``range`` of step 1 or an int64 tensor of pixel ids; every pixel by
    default) with the engine ``cfg.engine`` picks -> (sums [N, 3] in the
    order of ``pixels``, stats).

    The seeds are ``sample_seed(frame_seed, seed_spp, sample_offset +
    s)`` for s in [0, spp), so any (frame, spp) tiling of a frame's
    sample set, and a sample-parallel shard of it, draws the same
    streams.  ``inline`` and ``textures`` are ``engine_tables``; each
    engine reads only its own.  Stats: the engine's int64 ``n_traced`` and
    ``n_shadow``, ``iterations`` (rounds, or bounces summed over the
    samples) and ``rows_fetched``."""
    spp = cfg.spp if spp is None else spp
    seed_spp = spp if seed_spp is None else seed_spp
    if isinstance(pixels, range) and cfg.engine != "persistent":
        pixels = torch.arange(pixels.start, pixels.stop,
                              device=scene.trimat.device)
    if cfg.engine == "persistent":
        from tryraytrace_tpu_torch.engine.persistent import (
            render_frame_persistent)

        return render_frame_persistent(scene, inline, cam, frame_seed, width,
                                       height, cfg, spp, pixels,
                                       sample_offset=sample_offset,
                                       seed_spp=seed_spp)
    check_supported(cfg)
    dev = scene.trimat.device
    cam = cam.to(dev)
    frame_seed = int(frame_seed) & rng.MASK32
    n = width * height if pixels is None else int(pixels.shape[0])
    acc = torch.zeros((n, 3), device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    stats = dict(n_traced=zero, n_shadow=zero, iterations=0,
                 rows_fetched=zero)
    for s in range(spp):
        seed = rng.sample_seed(frame_seed, seed_spp, sample_offset + s)
        rad, st = render_sample(scene, inline, textures, cam, seed, width,
                                height, cfg, pixels)
        acc = acc + rad
        stats = {key: stats[key] + st[key] for key in stats}
    return acc, stats


def frame_ray_stats(scene, inline, textures, cam, frame_seed: int,
                    width: int, height: int, cfg: RenderConfig, spp: int):
    """Total (path rays, shadow rays) traced for one frame, as Python
    ints: the ray count that, divided by frame time, gives Mrays/s."""
    _, st = render_frame(scene, inline, textures, cam, frame_seed, width,
                         height, cfg, spp=spp)
    return int(st["n_traced"]), int(st["n_shadow"])
