"""The bounce engine (the counterpart of tryraytrace_tpu/engine/
wavefront.py): the JAX package's cross-check engine, and the frame
dispatch over both engines.

The whole wave of a sample advances bounce by bounce in lockstep:

  camera rays -> [closest-hit walk -> shade (-> NEE any-hit walk ->
  NEE add)] x depth

Dead lanes are masked, not compacted, and the loop runs while
``depth < max_depth`` and any lane is alive, so the ray counts are the
JAX engine's.  The two walks are the threaded walks of ops/threaded.py,
over the walk-order copy of the scene's threaded rows
(``ops/threaded.py walk_table``); the camera rays, the shade and the NEE
add are ops/bounce.py's ``bounce_rays``, ``bounce_shade`` and
``bounce_nee``.  Each is a hand-written CUDA kernel on a card and its
plain version (eager PyTorch) on the CPU, so a bounce on a card is four
launches (and the walks' counter fills), and the loop reads one number
a bounce: the live count the shade leaves on the device.  On a card the
shade lists the lanes it leaves alive, and once they are at most
``bounce.dense_share()`` of the wave the next bounce's shade and NEE
add serve only that list (a grid sized by the count just read), so a
late bounce's kernels cost its live lanes; the walks still run over
the whole wave, dead lanes masked.
``engine_tables`` builds the walk-order copy and the ``BounceTables``
(the textures in one buffer, which are sampled as they are, not as the
persistent engine's tile rows; the light rows) once a table set, so a
refit rebuilds them.

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
from tryraytrace_tpu_torch.ops import bounce
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


def render_sample(scene, walk, tables, params, seed: int, pixels,
                  cfg: RenderConfig):
    """Trace one 1-spp pass for ``pixels`` (int64 [N] on the scene's
    device) with sample seed ``seed`` over the walk-order threaded rows
    ``walk`` (``ops/threaded.py walk_table``) -> (radiance [N, 3],
    stats).  Streams are keyed by absolute pixel, so a pixel subset
    renders its pixels' samples exactly.  ``tables`` are the engine's
    ``BounceTables`` and ``params`` the frame's ``bounce_params``.

    On a card a sample is one ``bounce_rays`` launch, then per bounce the
    closest-hit walk, ``bounce_shade``, and with lights the any-hit walk
    and ``bounce_nee``; the loop reads one number a bounce, the live
    count ``bounce_shade`` leaves on the device, which also sizes the
    next bounce's launches over the lanes the shade listed.

    stats: ``n_traced`` (path rays, camera rays included) and
    ``n_shadow`` (NEE shadow rays) as int64 tensors, ``iterations`` (the
    bounces run) and ``rows_fetched`` (int64 tensor: threaded rows both
    walks fetched)."""
    dev = pixels.device
    n = int(pixels.shape[0])
    s = bounce.bounce_rays(params, seed, pixels)
    if scene.num_lights > 0:
        s.update(bounce.new_nee_state(n, dev))
    # Each bounce's [shadow rays fired, lanes alive after].
    counts = torch.zeros((cfg.max_depth, len(bounce.COUNTS)),
                         dtype=torch.int64, device=dev)
    # Bounce k serves the lanes bounce k - 1 listed (all at bounce 0) and
    # lists its own survivors in the other list (None, None on the CPU).
    lists = bounce.new_lane_lists(n, dev)
    rows, live, depth, lanes = [], n, 0, None
    while depth < cfg.max_depth and live > 0:
        rows += _bounce(scene, walk, tables, params, seed, pixels, depth, s,
                        counts[depth], lanes, live, lists[depth % 2])
        live = int(counts[depth, 1])
        lanes = lists[depth % 2]
        depth += 1
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    # A bounce traces the lanes alive at its start: all n, then each
    # bounce's survivors.
    n_traced = counts[:depth - 1, 1].sum() + n if depth else zero
    return _sanitize(s["rad"], cfg), dict(
        n_traced=n_traced, n_shadow=counts[:depth, 0].sum(),
        iterations=depth,
        rows_fetched=torch.stack(rows).sum() if rows else zero)


def _bounce(scene, walk, tables, params, seed: int, pixels, depth: int,
            s: dict, counts, lanes=None, live=None, next_lanes=None) -> list:
    """One wavefront bounce of the state ``s`` (``bounce.STATE`` and,
    with lights, ``bounce.NEE``, which the bounce writes): the
    closest-hit walk, ``bounce_shade`` (ops/bounce.py), and with lights
    the NEE shadow rays as one any-hit walk and ``bounce_nee``.
    ``tables`` are the engine's ``BounceTables``, ``params`` the frame's
    ``bounce_params``, and ``counts`` the int64 [2] that the bounce adds
    [shadow rays fired, lanes alive after] to.  On a card the shade and
    the NEE add serve the ``live`` lanes listed in ``lanes`` (every lane
    where None) and the shade lists its survivors in ``next_lanes``; the
    CPU's plain versions serve every lane.  ``s`` is updated: on a card
    its tensors are written in place.  Returns the rows each walk
    fetched (int64 tensors)."""
    n_lanes = None if lanes is None else live
    t, hit_id, rows = closest_hit(walk, scene.leaf_size, s["o"], s["d"],
                                  s["alive"], fmt=scene.leaf_fmt)
    bounce.bounce_shade(scene, tables, params, seed, pixels, depth, t,
                        hit_id, s, counts, lanes, n_lanes, next_lanes)
    rows = [rows]
    if scene.num_lights > 0:
        occluded, nee_rows = any_hit(walk, scene.leaf_size, s["so"],
                                     s["sd"], s["smax"], s["geo_ok"],
                                     fmt=scene.leaf_fmt)
        bounce.bounce_nee(s, occluded, lanes, n_lanes)
        rows.append(nee_rows)
    return rows


def engine_tables(scene, textures, cfg: RenderConfig) -> tuple:
    """(inline, device textures, bounce tables): what ``render_frame``'s
    engine reads besides the scene, on the scene's device.  The
    persistent engine reads its unified table (engine/persistent.py
    ``build_inline_table``; no textures, no bounce tables), the bounce
    engine the walk-order copy of the threaded rows (``ops/threaded.py
    walk_table``) and its ``BounceTables`` (every texture in one buffer
    with its layout, the lights' trimat rows; ops/bounce.py
    ``bounce_tables``), whose [H, W, 3] texture views are the device
    textures; ``textures`` are the upload's [H, W, 3] NumPy textures."""
    if cfg.engine == "bounce":
        tables = bounce.bounce_tables(scene, textures)
        return (walk_table(scene.node_table, scene.leaf_size,
                           scene.leaf_fmt), tables.textures, tables)
    from tryraytrace_tpu_torch.engine.persistent import build_inline_table

    return build_inline_table(scene, textures), (), None


def render_frame(scene, inline, textures, cam, frame_seed: int, width: int,
                 height: int, cfg: RenderConfig, spp: int | None = None,
                 pixels=None, sample_offset: int = 0,
                 seed_spp: int | None = None, tables=None):
    """One frame's radiance sums over ``spp`` samples of ``pixels`` (a
    ``range`` of step 1 or an int64 tensor of pixel ids; every pixel by
    default) with the engine ``cfg.engine`` picks -> (sums [N, 3] in the
    order of ``pixels``, stats).

    The seeds are ``sample_seed(frame_seed, seed_spp, sample_offset +
    s)`` for s in [0, spp), so any (frame, spp) tiling of a frame's
    sample set, and a sample-parallel shard of it, draws the same
    streams.  ``inline``, ``textures`` and ``tables`` are
    ``engine_tables``; each engine reads only its own, and the bounce
    engine builds its tables from ``textures`` when ``tables`` is None.
    Stats: the engine's int64 ``n_traced`` and ``n_shadow``,
    ``iterations`` (rounds, or bounces summed over the samples) and
    ``rows_fetched``."""
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
    frame_seed = int(frame_seed) & rng.MASK32
    if pixels is None:
        pixels = torch.arange(width * height, device=dev)
    if tables is None:
        tables = bounce.bounce_tables(scene, textures)
    # Packed once a frame, from the caller's camera as it is (a host
    # camera is not copied to the card).
    params = bounce.bounce_params(scene, tables, cfg, width, height, cam)
    acc = torch.zeros((int(pixels.shape[0]), 3), device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    stats = dict(n_traced=zero, n_shadow=zero, iterations=0,
                 rows_fetched=zero)
    for s in range(spp):
        seed = rng.sample_seed(frame_seed, seed_spp, sample_offset + s)
        rad, st = render_sample(scene, inline, tables, params, seed, pixels,
                                cfg)
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
