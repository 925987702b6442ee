"""The bounce engine's shading, NEE add and camera rays: the hand-written
CUDA kernels (csrc/bounce.cu), their plain versions and the dispatch.

On the TPU a bounce-engine sample is one jitted ``lax.while_loop`` of
XLA-fused code (tryraytrace_tpu/engine/wavefront.py:45 ``render_sample``,
:97 ``_bounce``, :232 ``_nee_contribution``).  Its two walks have their
own kernel (ops/threaded.py); what runs between them is here:

  - ``bounce_rays``: a sample's camera rays and its fresh carry (tp 1,
    rad 0, alive and prev_spec true), one launch a sample;
  - ``bounce_shade``: the shading half of a bounce, from the hit-row
    gather to the NEE request: the hit's frame and material, its own
    texture, the seven draws, the emission, roulette, the exclusive
    branch and its next ray, and the light sample, one launch a bounce;
  - ``bounce_nee``: the NEE add after the any-hit walk, one launch a
    bounce with lights.

Each ``*_plain`` function is the eager block the engine ran before
(engine/wavefront.py), op for op, and each kernel is held to it bit for
bit.  ``bounce_rays``, ``bounce_shade`` and ``bounce_nee`` take the plain
version for CPU tensors and the kernel for CUDA tensors; there is no
fallback between the two.

A bounce state is a dict of ``STATE`` (o, d, tp, rad [N, 3] float32;
alive, prev_spec [N] bool) and, with lights, ``NEE`` (geo_ok [N] bool,
so, sd [N, 3], smax [N], contrib [N, 3] float32: the shadow-ray lanes,
their segments and tp x the light's contribution if unoccluded).
``bounce_shade`` and ``bounce_nee`` update it: on a card the kernels
write its tensors in place, on the CPU the plain versions' new tensors
replace its entries.  What the kernels write, by lane:

  - ``bounce_shade`` works on the lanes alive at entry that hit
    (``hit_id >= 0``); a lane that misses is marked dead.  It writes rad,
    alive and, for a lane on a branch, o, d, tp and prev_spec; a lane on
    no branch keeps its tp and prev_spec.  The NEE fields are written
    where geo_ok holds, geo_ok on every lane served.  The eager block
    also writes a dead lane's o and d from a garbage hit; the next walk
    reads a dead lane as inactive, so only the lanes alive after the
    bounce carry o and d.  What is compared, kernel against plain
    version: rad, tp, alive, prev_spec and geo_ok on every lane, o and d
    on the lanes alive after, so, sd, smax and contrib where geo_ok
    holds.
  - ``bounce_nee`` adds contrib to rad where geo_ok holds and the shadow
    ray is not occluded.

The lists of live lanes.  On a card the shade lists the lanes alive
after it (``next_lanes``): a block's one atomic add on the live count,
which starts at 0, gives the block's offset, and each live lane writes
its index at that offset plus its rank in the block.  So a list's order
is the atomics' and may change from run to run; no lane reads another's
slots and the counts are integer sums, so the results do not depend on
it.  The engine hands bounce k > 0 the list of bounce k - 1 with its
count (the live count its loop reads anyway).  The kernel then has two
launch shapes (csrc/bounce.cu): over the list, one listed lane a thread
in a grid sized by the count, where the count is at most
``dense_share()`` of the wave (0.9); over every lane in lane order at
bounce 0 (no list: ``bounce_rays`` left every lane alive) and above
that share, where a dead lane returns at its flag.  The NEE add takes
the same list and count and decides alike, so it runs over the lanes
its bounce's shade served, the only ones where geo_ok can hold.  The
plain versions run over every lane and read no list.

Why a lane off the list may be left alone: the invariant of the plain
version that a lane dead at a bounce's entry leaves it with rad, tp and
prev_spec bit-equal to their inputs and alive and geo_ok false (geo_ok
is set only on the diffuse branch, whose lanes stay alive, so a lane
that dies leaves with geo_ok false; its o, d and the other NEE fields
are not compared).  So the kernel writes geo_ok only on the lanes it
serves, and a lane off the list keeps the false geo_ok its last shade
wrote.  tests/test_torch_bounce_kernel.py holds the plain path to the
invariant on every bounce of two small frames.

Measured and dropped (PERF.md, PR 19): the [N, 3] fields of a
contiguous launch staged through shared memory and stored in whole
16-byte pieces (72 registers, slower than a thread storing its own
lane), one atomic a warp for the counts (slower than one a block), the
list on every bounce after 0 (a list read costs more than it saves
above 90% of the lanes alive) and no list at all.

Signed zeros: the eager blocks add ``+ 0.0`` to every lane's rad, the
kernels only to the lanes they serve; rad starts at +0.0 and a sum of
floats is -0.0 only when both terms are, so the two never differ.

The constants a launch reads are packed once a frame (``bounce_params``)
in the service kernel's parameter layout (ops/service.py ``FLOATS``,
``INTS``; the slots the bounce kernels do not read are 0), from the
caller's camera and configuration as float32 values the plain versions
compute with.  The texture and light tables are built once a table set
(``bounce_tables``; engine/wavefront.py ``engine_tables``, so a refit
and every shard rebuild them).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.core import rng
from tryraytrace_tpu_torch.engine.camera_rays import generate_rays
from tryraytrace_tpu_torch.ops import service, shade
from tryraytrace_tpu_torch.ops._build import KernelLibrary
from tryraytrace_tpu_torch.ops.shade import INV_PI, TWO_PI
from tryraytrace_tpu_torch.ops.texture import sample_textures

# The carried state of a sample's lanes and the NEE request of a bounce:
# (name, dtype, columns).
STATE = (("o", torch.float32, 3), ("d", torch.float32, 3),
         ("tp", torch.float32, 3), ("rad", torch.float32, 3),
         ("alive", torch.bool, 1), ("prev_spec", torch.bool, 1))
NEE = (("geo_ok", torch.bool, 1), ("so", torch.float32, 3),
       ("sd", torch.float32, 3), ("smax", torch.float32, 1),
       ("contrib", torch.float32, 3))
# A bounce's int64 counts, which bounce_shade adds to: shadow rays fired,
# lanes alive after the bounce.
COUNTS = ("shadow", "live")
TRIMAT_ROW = 37  # accel/bvh.py pack_trimat_table

# The entry points' argument types (ctypes: c_void_p for every pointer
# and the stream).
FUNCTIONS = {
    "trt_bounce_layout": (ctypes.c_void_p,),
    "trt_bounce_rays_launch": (
        # floats, ints (host arrays), pix, lanes, seed,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong,
        # o, d, tp, rad, alive, prev_spec, stream
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p),
    "trt_bounce_shade_launch": (
        # floats, ints, pointers (host arrays), lanes, the list and its
        # count, the next list, seed, depth, stream
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p),
    "trt_bounce_nee_launch": (
        # lanes, the list and its count, geo_ok, occluded, contrib, rad,
        # stream
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p)}
LIBRARY = KernelLibrary("bounce", FUNCTIONS)

# bounce_shade's device pointers, in csrc/bounce.cu's ShadePtr order.
SHADE_POINTERS = ("trimat", "texels", "metas", "lights", "pix", "t",
                  "hit_id", *(name for name, _, _ in STATE),
                  *(name for name, _, _ in NEE), "counts")
MAX_LANES = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class BounceTables:
    """What the bounce engine reads besides the scene, on the scene's
    device (``bounce_tables``): every texture in one float32 buffer with
    int64 metas (offset in floats, w, h) per slot, the lights' trimat
    rows, and the [H, W, 3] views of the buffer, one a texture, that the
    plain version samples."""

    textures: tuple       # [H, W, 3] float32 views of ``texels``
    texels: torch.Tensor  # float32 [sum of h * w * 3], 16-byte aligned
    metas: torch.Tensor   # int64 [textures, 3]: offset, w, h
    lights: torch.Tensor  # float32 [lights, 37]: trimat[light_indices[:L]]


def bounce_tables(scene, textures) -> BounceTables:
    """The ``BounceTables`` of ``scene`` (a DeviceScene) and ``textures``
    (a sequence of [H, W, 3] float32 tensors or arrays), on the scene's
    device."""
    dev = scene.trimat.device
    raw = [torch.as_tensor(t, dtype=torch.float32, device=dev)
           for t in textures]
    shapes, metas, off = [], [], 0
    for t in raw:
        h, w = int(t.shape[0]), int(t.shape[1])
        shapes.append((h, w, 3))
        metas.append((off, w, h))
        off += h * w * 3
    texels = (torch.cat([t.reshape(-1) for t in raw]).contiguous() if raw
              else torch.zeros(0, device=dev))
    views = tuple(texels[o:o + h * w * 3].view(h, w, c)
                  for (o, _, _), (h, w, c) in zip(metas, shapes))
    lights = scene.trimat[scene.light_indices[:scene.num_lights]]
    return BounceTables(views, texels,
                        torch.tensor(metas, dtype=torch.int64,
                                     device=dev).reshape(-1, 3),
                        lights.contiguous())


@dataclasses.dataclass(frozen=True)
class BounceParams:
    """A frame's constants for the bounce kernels (``bounce_params``) and
    what the plain versions read instead: the configuration and the
    camera (a CameraParams, None where no camera ray is made)."""

    cfg: RenderConfig
    cam: object
    floats: np.ndarray  # float32 [len(service.FLOATS)]
    ints: np.ndarray    # int64 [len(service.INTS)]


def bounce_params(scene, tables: BounceTables, cfg: RenderConfig,
                  width: int = 0, height: int = 0, cam=None) -> BounceParams:
    """Pack the constants of a bounce frame in ops/service.py's layout:
    every float is the float32 the plain versions compute with (a Python
    constant as torch rounds it against a float32 tensor, the camera's
    float32 values as they are; a camera on the card is read back once).
    Without ``cam`` (and a raster) the camera's slots are 0, which the
    shade and the NEE add do not read and ``bounce_rays`` refuses."""
    f32 = np.float32
    n_lights = int(scene.num_lights)
    floats = {}
    if cam is not None:
        # The camera's slots lead the layout: pos, cx, cy, dir (3 each),
        # lens radius, focus distance.
        floats.update(zip(service.FLOATS, [
            *service._host_f32(cam.pos), *service._host_f32(cam.cx),
            *service._host_f32(cam.cy), *service._host_f32(cam.dir),
            *service._host_f32(cam.lens_radius),
            *service._host_f32(cam.focus_dist)]))
    floats.update(
        width=f32(width), height=f32(height), rr_min_p=f32(cfg.rr_min_p),
        emitter_stop_threshold=f32(cfg.emitter_stop_threshold),
        shadow_eps=f32(cfg.shadow_eps), refr_offset=f32(cfg.refr_offset),
        shadow_max_dist_eps=f32(cfg.shadow_max_dist_eps),
        nee_dist_sq_floor=f32(cfg.nee_dist_sq_floor),
        firefly_clamp=f32(cfg.firefly_clamp),
        tex_planar_scale=f32(cfg.tex_planar_scale),
        light_pick_scale=f32(n_lights - 0.001), light_count=f32(n_lights),
        two_pi=f32(TWO_PI), inv_pi=f32(INV_PI))
    ints = dict(
        width=width, height=height, num_textures=len(tables.textures),
        num_lights=n_lights, rr_threshold=cfg.rr_threshold,
        max_depth=cfg.max_depth,
        nee_dist_floor_enabled=int(cfg.nee_dist_floor_enabled),
        clamp_fireflies=int(cfg.clamp_fireflies),
        smooth=int(cfg.smooth_shading and scene.has_normals),
        uv=int(cfg.uv_mapping and scene.has_uvs))
    return BounceParams(
        cfg, cam,
        np.array([floats.get(k, 0.0) for k in service.FLOATS], np.float32),
        np.array([ints.get(k, 0) for k in service.INTS], np.int64))


def new_nee_state(n: int, device) -> dict:
    """The NEE fields for ``n`` lanes on ``device``, allocated and not
    filled: bounce 0's ``bounce_shade`` writes geo_ok on every lane (each
    later one on the lanes it serves) and the rest where geo_ok holds."""
    return {name: torch.empty((n,) if cols == 1 else (n, cols), dtype=dtype,
                              device=device) for name, dtype, cols in NEE}


# -- the plain versions -------------------------------------------------------

def bounce_rays_plain(cam, width: int, height: int, seed: int,
                      pixels) -> dict:
    """A sample's fresh state for ``pixels`` (int64 [N]) with sample seed
    ``seed``: the camera rays (engine/camera_rays.py ``generate_rays``),
    tp 1, rad 0, alive and prev_spec true."""
    n, dev = int(pixels.shape[0]), pixels.device
    o, d = generate_rays(cam, width, height,
                         torch.full((n,), seed, dtype=torch.int64,
                                    device=dev), pixels)
    return dict(o=o, d=d, tp=torch.ones((n, 3), device=dev),
                rad=torch.zeros((n, 3), device=dev),
                alive=torch.ones((n,), dtype=torch.bool, device=dev),
                prev_spec=torch.ones((n,), dtype=torch.bool, device=dev))


def bounce_shade_plain(scene, tables: BounceTables, cfg: RenderConfig,
                       seed: int, pixels, depth: int, t, hit_id,
                       s: dict) -> tuple:
    """The shading half of one bounce after its closest-hit walk (``t``,
    ``hit_id``) on the state ``s`` (ops/shade.py ``surface`` and
    ``scatter``, the texture sampled from the raw textures) -> (the new
    state: ``STATE`` and, with lights, ``NEE``; shadow rays fired, lanes
    alive after, as int64 tensors)."""
    o, d, alive = s["o"], s["d"], s["alive"]
    alive = alive & (hit_id >= 0)  # miss -> path ends (renderer.cu:427)
    hitrow = scene.trimat[torch.clamp(hit_id, min=0)]
    q, uv = shade.surface(hitrow, o + d * t[:, None], d, scene, cfg,
                          textured=bool(tables.textures))
    if uv is not None:
        q["albedo"] = q["albedo"] * sample_textures(
            tables.textures, hitrow[:, 19].to(torch.int64), *uv)

    # The bounce's seven draws in one hash: slots 0..6 of this depth.
    base = rng.CAMERA_DRAWS + depth * rng.DRAWS_PER_BOUNCE
    slots = torch.arange(rng.SLOT_LIGHT_R2 + 1, device=pixels.device)
    u = rng.uniform(seed, pixels[:, None], base + slots)
    rr_on = torch.full_like(alive, depth > cfg.rr_threshold)
    out = shade.scatter(q, d, s["tp"], s["rad"], alive, s["prev_spec"], u,
                        rr_on, scene, cfg)
    new = {name: out[name] for name, _, _ in STATE}
    fired = torch.zeros((), dtype=torch.int64, device=pixels.device)
    if out["nee"] is not None:
        new.update(zip((name for name, _, _ in NEE), out["nee"]))
        fired = new["geo_ok"].sum()
    return new, fired, new["alive"].sum()


def bounce_nee_plain(rad, geo_ok, occluded, contrib):
    """The NEE add after the any-hit walk: ``rad`` plus ``contrib`` where
    the shadow ray was fired and is not occluded."""
    return rad + torch.where((geo_ok & ~occluded)[:, None], contrib, 0.0)


# -- the kernels --------------------------------------------------------------

def _check(name, t, dtype, shape, dev):
    """Refuse a tensor the kernels cannot take: off ``dev``, another
    dtype or shape, not contiguous, or not starting on 16 bytes (the
    engine allocates every buffer; the entry points check it too)."""
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on {dev}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned (data_ptr "
                         f"{t.data_ptr():#x})")


def _check_fields(s: dict, fields, n: int, dev) -> None:
    for name, dtype, cols in fields:
        if name not in s:
            raise ValueError(f"the state has no field {name!r}")
        _check(name, s[name], dtype, (n,) if cols == 1 else (n, cols), dev)


def _on_card(dev, who: str) -> None:
    """The last refusal: tensors off a CUDA device."""
    if dev.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {dev}")


def _lanes(t) -> int:
    n = int(t.shape[0]) if t.dim() == 1 else -1
    if n > MAX_LANES:
        raise ValueError(f"{n} lanes: the kernels take fewer than 2**31")
    return n


def _host(params: BounceParams):
    if (params.floats.shape != (len(service.FLOATS),)
            or params.ints.shape != (len(service.INTS),)):
        raise ValueError("params are not packed in ops/service.py's layout")
    return (np.ascontiguousarray(params.floats, np.float32),
            np.ascontiguousarray(params.ints, np.int64))


_checked = set()  # libraries whose parameter layout matched the wrapper's


def _layout(lib) -> tuple:
    layout = (ctypes.c_int * 4)()
    lib.trt_bounce_layout(ctypes.addressof(layout))
    return tuple(layout)


def _load(library=None):
    """The loaded ``library`` (default ``LIBRARY``; a benchmark may pass a
    ``-D`` build of the same source), its layout checked once."""
    library = LIBRARY if library is None else library
    lib = library.load()
    if library not in _checked:
        want = (len(service.FLOATS), len(service.INTS), len(SHADE_POINTERS))
        if _layout(lib)[:3] != want:
            raise RuntimeError(f"bounce kernels take {_layout(lib)[:3]} "
                               f"(floats, ints, shade pointers), the "
                               f"wrapper packs {want}")
        _checked.add(library)
    return lib


def dense_share(library=None) -> float:
    """A build's TRT_BOUNCE_DENSE_SHARE: a bounce whose listed lanes are
    more than this share of the wave is launched over every lane (0:
    never listed; 1: always)."""
    return _layout(_load(library))[3] / 1000


def _launch(dev, name: str, fn, *args) -> None:
    """Call the entry point ``fn`` with ``args`` and the current stream of
    ``dev``; raise if the launch failed."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def new_lane_lists(n: int, device) -> tuple:
    """The two lists of live lanes a sample's bounces take turns with (the
    shade of bounce k reads list (k - 1) % 2 and writes list k % 2): two
    int32 [n] tensors on a CUDA ``device``, allocated and not filled; on
    the CPU (None, None), since the plain versions run over every lane."""
    if torch.device(device).type == "cpu":
        return None, None
    return tuple(torch.empty(n, dtype=torch.int32, device=device)
                 for _ in range(2))


def _lane_list(lanes, n_lanes, n: int, dev) -> int:
    """Refuse a list the kernels cannot take; return the lanes to serve
    (n where ``lanes`` is None)."""
    if lanes is None:
        if n_lanes is not None:
            raise ValueError("a count of listed lanes without a list")
        return n
    _check("lanes", lanes, torch.int32, (n,), dev)
    if isinstance(n_lanes, bool) \
            or not isinstance(n_lanes, (int, np.integer)) \
            or not 0 <= n_lanes <= n:
        raise ValueError(f"listed lanes {n_lanes!r} out of range [0, {n}]")
    return int(n_lanes)


def _overlap(a, b) -> bool:
    lo = max(a.data_ptr(), b.data_ptr())
    hi = min(a.data_ptr() + a.numel() * a.element_size(),
             b.data_ptr() + b.numel() * b.element_size())
    return lo < hi


def bounce_rays_cuda(params: BounceParams, seed: int, pixels) -> dict:
    """Launch the camera-ray kernel on the current stream: a sample's
    fresh state for ``pixels`` (int64 [N] on a CUDA device, contiguous,
    16-byte aligned) with sample seed ``seed``, the raster and camera
    packed in ``params``; bit for bit ``bounce_rays_plain``.  The state
    is allocated here and not filled: the kernel writes every lane.
    Refuses on the host, before any library is loaded, what the kernel
    cannot take."""
    dev = pixels.device
    n = _lanes(pixels)
    _check("pixels", pixels, torch.int64, (n,), dev)
    floats, ints = _host(params)
    if min(ints[service.INTS.index("width")],
           ints[service.INTS.index("height")]) < 1:
        raise ValueError("params carry no raster (width and height >= 1)")
    _on_card(dev, "bounce_rays_cuda")
    s = {name: torch.empty((n,) if cols == 1 else (n, cols), dtype=dtype,
                           device=dev) for name, dtype, cols in STATE}
    if n > 0:
        lib = _load()
        _launch(dev, "bounce_rays", lib.trt_bounce_rays_launch,
                floats.ctypes.data, ints.ctypes.data, pixels.data_ptr(), n,
                int(seed) & rng.MASK32,
                *(s[name].data_ptr() for name, _, _ in STATE))
        bounce_rays_cuda.launches += 1
    return s


bounce_rays_cuda.launches = 0


def bounce_shade_cuda(scene, tables: BounceTables, params: BounceParams,
                      seed: int, pixels, depth: int, t, hit_id, s: dict,
                      counts, lanes=None, n_lanes=None, next_lanes=None,
                      library=None) -> dict:
    """Launch the shading kernel on the current stream: one bounce's
    shading after its closest-hit walk (``t`` [N] float32, ``hit_id`` [N]
    int64) on the state ``s`` for ``pixels`` (int64 [N]) with sample seed
    ``seed`` at bounce ``depth``, bit for bit ``bounce_shade_plain`` by
    the module docstring's contract.  Serves the first ``n_lanes`` lanes
    listed in ``lanes`` (int32 [N], each lane at most once, every lane
    alive at entry on it; 0 <= n_lanes <= N), or every lane where
    ``lanes`` is None; a lane off the list is neither read nor written.
    Writes ``s`` in place (``STATE``, and ``NEE`` with lights, which ``s``
    must then hold) and adds the shadow rays fired and the lanes alive
    after to ``counts`` (int64 [2]); where ``next_lanes`` (int32 [N], not
    overlapping ``lanes``) is given and the live count starts at 0, lists
    the lanes alive after in ``next_lanes[:live]``, in an order that may
    change from run to run.  Every tensor lies on the scene's CUDA
    device, contiguous and 16-byte aligned, with its dtype and shape;
    ``params`` is packed for ``tables``; ``library`` is the kernels' build
    (default ``LIBRARY``).  Refuses on the host, before any library is
    loaded, what the kernel cannot take."""
    trimat = scene.trimat
    dev = trimat.device
    n = _lanes(pixels)
    _check("trimat", trimat, torch.float32,
           (int(trimat.shape[0]), TRIMAT_ROW), dev)
    n_tex, n_lights = len(tables.textures), int(scene.num_lights)
    _check("tables.texels", tables.texels, torch.float32,
           (tables.texels.numel(),), dev)
    _check("tables.metas", tables.metas, torch.int64, (n_tex, 3), dev)
    _check("tables.lights", tables.lights, torch.float32,
           (n_lights, TRIMAT_ROW), dev)
    floats, ints = _host(params)
    if (int(ints[service.INTS.index("num_textures")]) != n_tex
            or int(ints[service.INTS.index("num_lights")]) != n_lights):
        raise ValueError("params were packed for other tables")
    if depth < 0:
        raise ValueError(f"bounce {depth} < 0")
    _check("pixels", pixels, torch.int64, (n,), dev)
    _check("t", t, torch.float32, (n,), dev)
    _check("hit_id", hit_id, torch.int64, (n,), dev)
    _check_fields(s, STATE + (NEE if n_lights else ()), n, dev)
    _check("counts", counts, torch.int64, (len(COUNTS),), dev)
    served = _lane_list(lanes, n_lanes, n, dev)
    if next_lanes is not None:
        _check("next_lanes", next_lanes, torch.int32, (n,), dev)
        if lanes is not None and n and _overlap(lanes, next_lanes):
            raise ValueError("next_lanes aliases lanes")
    _on_card(dev, "bounce_shade_cuda")
    given = dict(trimat=trimat, texels=tables.texels, metas=tables.metas,
                 lights=tables.lights, pix=pixels, t=t, hit_id=hit_id,
                 counts=counts, **s)
    absent = (("texels", "metas") if not n_tex else ()) + (
        ("lights", *(name for name, _, _ in NEE)) if not n_lights else ())
    ptrs = (ctypes.c_void_p * len(SHADE_POINTERS))(*(
        None if name in absent else given[name].data_ptr()
        for name in SHADE_POINTERS))
    if served > 0:
        lib = _load(library)
        _launch(dev, "bounce_shade", lib.trt_bounce_shade_launch,
                floats.ctypes.data, ints.ctypes.data, ctypes.addressof(ptrs),
                n, None if lanes is None else lanes.data_ptr(), served,
                None if next_lanes is None else next_lanes.data_ptr(),
                int(seed) & rng.MASK32, int(depth))
        bounce_shade_cuda.launches += 1
    return s


bounce_shade_cuda.launches = 0


def bounce_nee_cuda(s: dict, occluded, lanes=None, n_lanes=None,
                    library=None) -> dict:
    """Launch the NEE-add kernel on the current stream: ``s["rad"] +=
    s["contrib"]`` where ``s["geo_ok"]`` holds and ``occluded`` (bool [N])
    does not, in place, bit for bit ``bounce_nee_plain``, over the first
    ``n_lanes`` lanes listed in ``lanes`` (int32 [N]: the lanes the
    bounce's shade served, the only ones where geo_ok can hold), or every
    lane where ``lanes`` is None.  The tensors lie on one CUDA device,
    contiguous and 16-byte aligned.  Refuses on the host, before any
    library is loaded, what the kernel cannot take."""
    dev = occluded.device
    n = _lanes(occluded)
    _check("occluded", occluded, torch.bool, (n,), dev)
    _check_fields(s, tuple(f for f in STATE + NEE
                           if f[0] in ("rad", "geo_ok", "contrib")), n, dev)
    served = _lane_list(lanes, n_lanes, n, dev)
    _on_card(dev, "bounce_nee_cuda")
    if served > 0:
        lib = _load(library)
        _launch(dev, "bounce_nee", lib.trt_bounce_nee_launch, n,
                None if lanes is None else lanes.data_ptr(), served,
                s["geo_ok"].data_ptr(), occluded.data_ptr(),
                s["contrib"].data_ptr(), s["rad"].data_ptr())
        bounce_nee_cuda.launches += 1
    return s


bounce_nee_cuda.launches = 0


# -- the dispatch -------------------------------------------------------------

def bounce_rays(params: BounceParams, seed: int, pixels) -> dict:
    """A sample's fresh state for ``pixels`` on their own device: the
    plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if pixels.device.type == "cpu":
        width = int(params.ints[service.INTS.index("width")])
        height = int(params.ints[service.INTS.index("height")])
        return bounce_rays_plain(params.cam, width, height, seed, pixels)
    return bounce_rays_cuda(params, seed, pixels)


def bounce_shade(scene, tables: BounceTables, params: BounceParams,
                 seed: int, pixels, depth: int, t, hit_id, s: dict,
                 counts, lanes=None, n_lanes=None, next_lanes=None) -> dict:
    """One bounce's shading on the state ``s`` (updated and returned),
    adding [shadow rays fired, lanes alive after] to ``counts``: the
    plain version for CPU tensors, over every lane (the lists are not
    read); the kernel for CUDA tensors, over the first ``n_lanes`` of
    ``lanes`` (every lane where None), listing the lanes alive after in
    ``next_lanes``."""
    if scene.trimat.device.type == "cpu":
        new, fired, live = bounce_shade_plain(scene, tables, params.cfg,
                                              seed, pixels, depth, t, hit_id,
                                              s)
        s.update(new)
        counts += torch.stack([fired, live])
        return s
    return bounce_shade_cuda(scene, tables, params, seed, pixels, depth, t,
                             hit_id, s, counts, lanes, n_lanes, next_lanes)


def bounce_nee(s: dict, occluded, lanes=None, n_lanes=None) -> dict:
    """The NEE add on the state ``s`` (updated and returned): the plain
    version for CPU tensors, over every lane; the kernel for CUDA
    tensors, over the first ``n_lanes`` of ``lanes`` (every lane where
    None)."""
    if occluded.device.type == "cpu":
        s["rad"] = bounce_nee_plain(s["rad"], s["geo_ok"], occluded,
                                    s["contrib"])
        return s
    return bounce_nee_cuda(s, occluded, lanes, n_lanes)
