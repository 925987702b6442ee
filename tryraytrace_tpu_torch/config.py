"""Render configuration of the PyTorch port.

``RenderConfig`` has the same fields and defaults as
tryraytrace_tpu/config.py (whose comments carry the history of every
knob), so a default config renders the same image in both packages.
The port runs the JAX package's two engines: ``engine="persistent"``
(the default), the owner-schedule wave with quad traversal and inline
shading and texturing, and ``engine="bounce"``, the cross-check engine
that advances a sample's whole wave bounce by bounce over the threaded
table (engine/wavefront.py).  ``check_supported`` says how it treats
the other knobs:

* Knobs that select a variant the port leaves out by design (the
  variant produces the same image and exists only to schedule a TPU
  in lockstep) raise ``ValueError`` on any non-default value:
  ``traversal``, ``scheduler``, ``dual_walk``, ``shadow_pred``,
  ``inline_shade``, ``inline_tex=False``, ``quad_layout`` and
  ``quad_select="rank"``; so does an engine other than these two.
* The features past the default path render as in the JAX package:
  ``smooth_shading``, ``uv_mapping``, ``leaf_isect`` "bw" or "mt" and
  ``bvh_method`` "sah", "median" or "sbvh".  Any light count renders:
  the NEE pick gathers the picked light's row, which is the row the
  JAX engine's where-chain (up to its ``INLINE_MAX_LIGHTS``, 16) and
  its tick path's gather (past it) both pick.
* Knobs that only schedule work are accepted and ignored, because the
  image does not depend on them: ``shade_every``, ``step_unroll``,
  ``inline_service_steps``, ``shade_ready_frac``, ``tail_spill``,
  ``spill_stages``, ``spill_floor``, ``tail_unroll``, ``pool_span``,
  ``quota_accum`` and ``max_wave_lanes`` (the port renders a frame as
  one wave).  The bounce engine reads none of the persistent engine's
  knobs, as in the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters; defaults reproduce the reference."""

    width: int = 1200
    height: int = 800
    spp: int = 1
    max_depth: int = 30
    rr_threshold: int = 3
    rr_min_p: float = 0.05
    fov_scale: float = 0.5135
    firefly_clamp: float = 100.0
    nee_dist_sq_floor: float = 5.0
    light_scan_threshold: float = 0.1
    emitter_stop_threshold: float = 1e-3
    intersect_eps: float = 1e-5
    shadow_eps: float = 1e-3
    refr_offset: float = 1e-4
    shadow_max_dist_eps: float = 1e-2
    max_bvh_depth: int = 32
    # 0 = auto: the largest fat leaf (8, 6, 4) whose quad table stays
    # under the JAX package's gather knee (engine/device_scene.py).
    bvh_leaf_size: int = 0
    bvh_method: str = "sah"
    tex_planar_scale: float = 0.01
    clamp_fireflies: bool = True
    nee_dist_floor_enabled: bool = True
    smooth_shading: bool = False
    uv_mapping: bool = False
    engine: str = "persistent"
    shade_every: int = 0
    inline_shade: bool | None = None
    inline_service_steps: int = 0
    inline_tex: bool | None = None
    traversal: str = "quad"
    leaf_isect: str = "bw"
    quad_redirect_passes: int = 1
    shadow_pred: bool = False
    quad_regs: int = 3
    quad_select: str | None = None
    quad_layout: str | None = "mux"
    quad_collapse: str = "dp"
    step_unroll: int = 4
    dual_walk: bool | None = None
    shade_ready_frac: float = 0.0
    scheduler: str = "owner"
    pool_span: int = 262144
    quota_accum: str = "onehot"
    tail_spill: bool = True
    spill_stages: int = 8
    spill_floor: int = 64
    tail_unroll: int = 0
    max_wave_lanes: int = 65536

    def with_size(self, width: int, height: int) -> "RenderConfig":
        return dataclasses.replace(self, width=width, height=height)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# field -> values the port accepts (see the module docstring).
_PORTED_VALUES = {
    "engine": ("persistent", "bounce"),
    "traversal": ("quad",),
    "scheduler": ("owner",),
    "dual_walk": (None, False),
    "shadow_pred": (False,),
    "inline_shade": (None, True),
    "inline_tex": (None, True),
    "quad_layout": ("mux",),
    "leaf_isect": ("bw", "mt"),
    "bvh_method": ("sah", "median", "sbvh"),
}


def check_supported(cfg: RenderConfig) -> None:
    """Raise ValueError for a knob value the port does not render."""
    for name, ok in _PORTED_VALUES.items():
        val = getattr(cfg, name)
        if val not in ok:
            raise ValueError(
                f"RenderConfig.{name}={val!r} is not ported to the "
                f"PyTorch engine (accepted: {ok}); see "
                "tryraytrace_tpu_torch/config.py")
    if quad_select_resolved(cfg) != "perm":
        raise ValueError("quad_select='rank' is not ported to the "
                         "PyTorch engine")


def quad_select_resolved(cfg: RenderConfig) -> str:
    """Resolve cfg.quad_select (None = auto) to "perm" | "rank",
    exactly as the JAX package does: rank needs the register-free
    walk and the "mux" layout."""
    sel = cfg.quad_select
    if sel is None:
        sel = ("rank" if cfg.quad_regs == 0
               and cfg.quad_layout in (None, "mux") else "perm")
    if sel not in ("perm", "rank"):
        raise ValueError(f"unknown quad_select {sel!r}")
    if sel == "rank":
        if cfg.quad_regs != 0:
            raise ValueError(
                "quad_select='rank' requires quad_regs=0 (the rank "
                "decode produces no skip-register pushes)")
        if cfg.quad_layout not in (None, "mux"):
            raise ValueError(
                "quad_select='rank' requires the 'mux' quad layout")
    return sel


DEFAULT_CONFIG = RenderConfig()
