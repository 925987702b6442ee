"""The service half of the persistent engine's round: the hand-written
CUDA kernel that shades, textures and regenerates every lane in one
launch, and the packing of its parameters.

After a round's walks (ops/walk.py) every lane that needs service is
served once: a SHADEG lane shades its hit (or parks in TEXG to fetch a
texture tile), a TEXG lane shades with its texture sample, and a lane
in REFILL, or ended by its shade, flushes its sample and starts the
pixel's next one.  On the TPU this is the service half of the XLA-fused
loop body of ``_step_quad`` (tryraytrace_tpu/engine/persistent.py
:776, :793, :1166, :1265, :1450); the port's plain version is the
eager block in engine/persistent.py (``service_plain``), and
``service_pass_cuda`` (csrc/service_pass.cu) is held to it field for
field and total for total.

The engine's round (engine/persistent.py ``_round_quad``) runs the plain
version for CPU tensors and the kernel for CUDA tensors; there is no
fallback between the two.  The kernel covers every configuration
``config.py check_supported`` accepts:
textures or none, pack 1 or 2, smooth shading, UV mapping, any light
count, fireflies clamped or not.

The constants a pass reads (camera, raster, seed schedule, table
layout, configuration) are packed once per wave into a
``ServiceParams`` (``service_params``): float32 and int64 host arrays
the launch copies into the kernel's by-value parameters, packed from the
caller's host camera with nothing read back from the card, and two small
device arrays, the lights' trimat rows and the texture layout, which
the unified table carries (engine/persistent.py ``InlineTable``, built
once per table).

Signed zeros: the plain block adds ``+ 0.0`` to every lane's ``rad``
and ``out``, the kernel only to the lanes it serves, so the two are held
equal as numbers (``-0.0 == 0.0``), as ops/walk.py's are.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tryraytrace_tpu_torch.ops._build import KernelLibrary
from tryraytrace_tpu_torch.ops.shade import INV_PI, TWO_PI

# The kernel's parameter arrays, in its order (csrc/service_pass.cu
# FloatParam, IntParam, PtrParam).
FLOATS = ("cam_pos_x", "cam_pos_y", "cam_pos_z", "cam_cx_x", "cam_cx_y",
          "cam_cx_z", "cam_cy_x", "cam_cy_y", "cam_cy_z", "cam_dir_x",
          "cam_dir_y", "cam_dir_z", "lens_radius", "focus_dist", "width",
          "height", "rr_min_p", "emitter_stop_threshold", "shadow_eps",
          "refr_offset", "shadow_max_dist_eps", "nee_dist_sq_floor",
          "firefly_clamp", "tex_planar_scale", "light_pick_scale",
          "light_count", "two_pi", "inv_pi")
INTS = ("width", "height", "spp_cap", "seed_base", "sample_offset",
        "sentinel", "pack", "tex0", "num_textures", "num_lights",
        "rr_threshold", "max_depth", "nee_dist_floor_enabled",
        "clamp_fireflies", "smooth", "uv", "table_rows", "table_width")
# State fields the kernel reads or writes: (name, dtype, columns).
FIELDS = (("mode", torch.int64, 1), ("cur", torch.int64, 1),
          ("hit_id", torch.int64, 1), ("depth", torch.int64, 1),
          ("sample", torch.int64, 1), ("seed", torch.int64, 1),
          ("pix", torch.int64, 1), ("d_min", torch.float32, 1),
          ("o", torch.float32, 3), ("d", torch.float32, 3),
          ("tp", torch.float32, 3), ("rad", torch.float32, 3),
          ("so", torch.float32, 3), ("sd", torch.float32, 3),
          ("smax", torch.float32, 1), ("pend", torch.float32, 3),
          ("out", torch.float32, 3), ("tstash", torch.float32, 10),
          ("prev_spec", torch.bool, 1),
          ("cont_after_shadow", torch.bool, 1))
# A wave's running int64 totals, which every pass adds to on the device:
# path rays started (camera rays included), shadow rays fired, and two
# slots for the count of lanes not DONE after a pass, which the rounds of
# a wave take in turn (a pass adds to its slot, zero when it starts, and
# zeroes the other for the next round).
TOTALS = ("path", "shadow", "live0", "live1")
LIVE = TOTALS.index("live0")


@dataclasses.dataclass
class ServiceParams:
    """What a service pass reads besides the lane state, packed for the
    kernel (``service_params``)."""

    floats: np.ndarray    # float32 [len(FLOATS)]
    ints: np.ndarray      # int64 [len(INTS)]
    table: torch.Tensor   # the unified table (InlineTable.table)
    lights: torch.Tensor  # [max(lights, 1), 37] f32: the lights' trimat rows
    metas: torch.Tensor   # [max(textures, 1), 4] int64: offset, tiles_x, w, h


def _host_f32(v) -> np.ndarray:
    """A camera field as float32 host values: a NumPy array or scalar as
    it is (CameraParams.to moves the same float32 values), a tensor read
    back."""
    if isinstance(v, torch.Tensor):
        v = v.cpu()
    return np.asarray(v, np.float32).reshape(-1)


def service_params(fr) -> ServiceParams:
    """Pack the constants of a wave (engine/persistent.py ``_Frame``)
    for the kernel: every float is the float32 the plain version
    computes with (a Python constant as torch rounds it against a
    float32 tensor, the camera's float32 values as they are, from host
    arrays without a read of the card), the light rows are the scene's
    trimat rows of its lights and the metas the texture layout of
    ``build_texture_tiles``, both as the unified table carries them."""
    scene, inline, cfg, cam = fr.scene, fr.inline, fr.cfg, fr.cam
    table = inline.table
    f32 = np.float32
    n_lights = int(scene.num_lights)
    floats = np.array(
        [*_host_f32(cam.pos), *_host_f32(cam.cx), *_host_f32(cam.cy),
         *_host_f32(cam.dir), *_host_f32(cam.lens_radius),
         *_host_f32(cam.focus_dist),
         f32(fr.width), f32(fr.height), f32(cfg.rr_min_p),
         f32(cfg.emitter_stop_threshold), f32(cfg.shadow_eps),
         f32(cfg.refr_offset), f32(cfg.shadow_max_dist_eps),
         f32(cfg.nee_dist_sq_floor), f32(cfg.firefly_clamp),
         f32(cfg.tex_planar_scale), f32(n_lights - 0.001), f32(n_lights),
         f32(TWO_PI), f32(INV_PI)], np.float32)
    textured = inline.tex0 is not None
    ints = np.array(
        [fr.width, fr.height, fr.spp_cap,
         (1984 + fr.frame_seed * fr.seed_spp) & 0xFFFFFFFF,
         fr.sample_offset, inline.sentinel, inline.pack,
         inline.tex0 if textured else -1, len(inline.metas), n_lights,
         cfg.rr_threshold, cfg.max_depth, int(cfg.nee_dist_floor_enabled),
         int(cfg.clamp_fireflies),
         int(cfg.smooth_shading and scene.has_normals),
         int(cfg.uv_mapping and scene.has_uvs), table.shape[0],
         table.shape[1]], np.int64)
    return ServiceParams(floats, ints, table, inline.light_rows,
                         inline.meta_rows)


LIBRARY = KernelLibrary("service_pass", {
    "trt_service_layout": (ctypes.c_void_p,),
    "trt_service_launch": (
        # floats, ints, pointers (host arrays), lanes, live slot, stream
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)})


def _check_layout(lib) -> None:
    layout = (ctypes.c_int * 4)()
    lib.trt_service_layout(ctypes.addressof(layout))
    # The kernel's pointers: table, lights, metas, the fields, totals.
    want = (len(FLOATS), len(INTS), 3 + len(FIELDS) + 1, len(TOTALS))
    if tuple(layout) != want:
        raise RuntimeError(f"service_pass kernel takes {tuple(layout)} "
                           f"(floats, ints, pointers, totals), the wrapper "
                           f"packs {want}")


def state_pointers(s, inline, params: ServiceParams, totals,
                   who: str) -> list:
    """The device pointers a service kernel takes, in its order (the
    unified table, the light rows, the texture metas, the state fields
    of ``FIELDS``, the totals), after refusing for the wrapper ``who``
    what it cannot take: ``params`` packed for another table, a field
    with another dtype or shape or not contiguous (``tstash`` only with
    textures; a null pointer without), totals that are not ``TOTALS``'
    int64 [4], tensors off the table's device, and last a table off a
    CUDA device.  Waits for nothing on the device."""
    table = inline.table
    dev = table.device
    if table is not params.table:
        raise ValueError("params were packed for another table")
    if (table.dim() != 2 or table.dtype != torch.float32
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous [rows, width] float32 "
                         "tensor")
    textured = inline.tex0 is not None
    w = s["mode"].shape[0]
    ptrs = [table.data_ptr()]
    for name, t in (("lights", params.lights), ("metas", params.metas)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"params.{name} must be contiguous on {dev}")
        ptrs.append(t.data_ptr())
    for name, dtype, cols in FIELDS:
        if name == "tstash" and not textured:
            ptrs.append(0)
            continue
        t = s[name]
        shape = (w,) if cols == 1 else (w, cols)
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"state field {name!r} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
        ptrs.append(t.data_ptr())
    if (totals.device != dev or totals.dtype != torch.int64
            or tuple(totals.shape) != (len(TOTALS),)
            or not totals.is_contiguous()):
        raise ValueError(f"totals must be a contiguous int64 tensor of shape "
                         f"({len(TOTALS)},) on {dev}")
    ptrs.append(totals.data_ptr())
    if dev.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {dev}")
    return ptrs


def service_pass_cuda(s, inline, params: ServiceParams, totals, slot: int):
    """Launch the service kernel on the current stream.

    ``s`` holds the engine's lane state (engine/persistent.py
    ``init_lane_ctx``) on the table's CUDA device.  Every field in
    ``FIELDS`` must have its engine dtype and shape and be contiguous
    (``tstash`` only with textures); a field that is not raises, and
    none is copied.  After a compaction ``Wave.advance`` indexes the
    state, which gives contiguous fields.  ``params`` is the wave's
    ``service_params``.  ``totals`` is the wave's int64 tensor of
    ``TOTALS`` on the same device: the pass adds the path rays it starts
    and the shadow rays it fires to the first two, adds the count of
    lanes not DONE after it to ``totals[LIVE + slot]`` (which must be 0)
    and zeroes ``totals[LIVE + 1 - slot]``; nothing else is launched.
    The pass writes the state in place: the returned state is ``s``
    itself, and the caller keeps no copy of the state before the pass."""
    ptrs = state_pointers(s, inline, params, totals, "service_pass_cuda")
    w = s["mode"].shape[0]
    if slot not in (0, 1):
        raise ValueError(f"live slot {slot} is not 0 or 1")
    library = LIBRARY
    lib = library.load()
    if library not in _checked:
        _check_layout(lib)
        _checked.add(library)
    host_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    floats = np.ascontiguousarray(params.floats, np.float32)
    ints = np.ascontiguousarray(params.ints, np.int64)
    if w > 0:
        with torch.cuda.device(inline.table.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.trt_service_launch(floats.ctypes.data, ints.ctypes.data,
                                         ctypes.addressof(host_ptrs), w,
                                         slot, stream)
        if err != 0:
            raise RuntimeError(f"service_pass kernel launch failed: CUDA "
                               f"error {err}")
        service_pass_cuda.launches += 1
    return s


service_pass_cuda.launches = 0
_checked = set()  # libraries whose parameter layout matched the wrapper's

