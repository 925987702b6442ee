"""Device-resident scene: the upload step.

The counterpart of tryraytrace_tpu/engine/device_scene.py for the
port's two walks (quad rows in the "mux" layout for the persistent
engine, threaded rows for the bounce engine; Baldwin-Weber or
Moller-Trumbore leaves): build the BVH on the host, permute the
primitives, pack the quad table, the threaded table and the fused
triangle+material rows, and move them to ``device``.  The packing code
is the same NumPy as the JAX package's, so both packages walk
byte-identical tables;
``DeviceScene.from_numpy`` takes the JAX package's uploaded arrays as
they are.  ``refit_scene`` repacks a scene over moved vertices without
a rebuild.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from tryraytrace_tpu_torch.accel.bvh import (LEAF_STRIDE, LinearBVH,
                                             build_bvh, collapse_bvh,
                                             pack_quad_table,
                                             pack_traversal_table,
                                             pack_trimat_table,
                                             quad_row_width, refit_bvh)
from tryraytrace_tpu_torch.engine.state import resolve_device
from tryraytrace_tpu_torch.scene.model import SceneArrays


@dataclasses.dataclass
class DeviceScene:
    """What the engine reads, as tensors on one device."""

    quad_table: torch.Tensor     # [R, 10 + max(29, stride * K)] f32 quad rows
    node_table: torch.Tensor     # [M, stride * K + 24] f32 threaded rows
    trimat: torch.Tensor         # [T, 37] f32 triangle+material rows
    light_indices: torch.Tensor  # [max(L, 1)] int64 trimat row per light
    num_lights: int
    leaf_size: int               # K, triangles per leaf row
    # Any triangle with nonzero vertex normals / real per-corner UVs?
    # Without them smooth shading / UV mapping change nothing, and the
    # engine leaves their blocks out, as the JAX engine does.
    has_normals: bool = False
    has_uvs: bool = False
    leaf_fmt: str = "bw"         # leaf slot format: "bw" or "mt"

    # The arrays and statics of a JAX DeviceScene this one takes over.
    ARRAYS = ("quad_table", "node_table", "trimat", "light_indices")
    STATICS = ("num_lights", "leaf_size", "has_normals", "has_uvs",
               "leaf_fmt")

    @classmethod
    def from_numpy(cls, fields: dict, statics: dict, device) -> "DeviceScene":
        """Build from NumPy arrays keyed as the JAX DeviceScene's fields
        (``fields``; extra keys are ignored) and its static fields
        (``statics``), e.g. a JAX upload's
        ``{name: np.asarray(getattr(dev, name))}``.  Raises on a scene
        the port does not render: another quad layout or decode."""
        layout = (statics.get("quad_layout", "mux"),
                  statics.get("quad_select", "perm"))
        if layout != ("mux", "perm"):
            raise ValueError("the port walks the 'mux' quad layout with the "
                             f"'perm' decode; got {layout}")
        fmt = statics.get("leaf_fmt", "bw")
        if fmt not in LEAF_STRIDE:
            raise ValueError(f"unknown leaf format {fmt!r}")
        t = {name: torch.tensor(np.asarray(fields[name]), device=device)
             for name in cls.ARRAYS}
        t["light_indices"] = t["light_indices"].to(torch.int64)
        return cls(**t, num_lights=int(statics["num_lights"]),
                   leaf_size=int(statics["leaf_size"]),
                   has_normals=bool(statics.get("has_normals", False)),
                   has_uvs=bool(statics.get("has_uvs", False)),
                   leaf_fmt=fmt)


def _build_auto_leaf(arrays: SceneArrays, method: str, quad_collapse: str,
                     leaf_fmt: str = "bw"):
    """Auto leaf size, exactly as the JAX package picks it for the quad
    walk: the largest fat leaf (8, 6, 4) whose quad table, at the leaf
    format's row width, stays under 2.3 MB (that engine's measured
    gather knee; the tables must match, so the rule is kept as it is)."""
    knee_bytes = 2.3e6
    candidates = (8, 6, 4)
    for cand in candidates:
        bvh = build_bvh(arrays.tri_v0, arrays.tri_v1, arrays.tri_v2,
                        leaf_size=cand, method=method)
        width = quad_row_width(
            int(max(1, bvh.leaf_count.max())) if bvh.num_nodes else 1,
            leaf_fmt)
        rows = bvh.num_nodes
        if rows:
            rows = (len(collapse_bvh(bvh, criterion=quad_collapse))
                    + int((bvh.leaf_count > 0).sum()))
        if rows * width * 4 <= knee_bytes or cand == candidates[-1]:
            return bvh
    raise AssertionError("unreachable")


def upload_scene(arrays: SceneArrays, leaf_size: int = 0,
                 method: str = "sah", quad_collapse: str = "dp",
                 device="cuda", leaf_fmt: str = "bw"
                 ) -> tuple[DeviceScene, tuple, LinearBVH]:
    """Build the BVH (``leaf_size`` 0 = auto; reordering primitives,
    main.cpp:82-86 contract), pack the quad table with ``leaf_fmt`` leaf
    rows in the "mux" layout, the threaded table with the same leaf rows
    and the trimat rows, and move them to
    ``device`` (the card by default; raises without one unless
    ``device="cpu"``).

    Returns (device_scene, textures, bvh); ``textures`` is the tuple of
    [H, W, 3] float32 NumPy textures (the persistent engine tiles them
    into its unified table, engine/persistent.build_inline_table; the
    bounce engine samples them as they are, ``device_textures``)."""
    device = resolve_device(device)
    if leaf_fmt not in LEAF_STRIDE:
        raise ValueError(f"unknown leaf_isect {leaf_fmt!r} "
                         f"(expected one of {sorted(LEAF_STRIDE)})")
    if leaf_size <= 0:
        bvh = _build_auto_leaf(arrays, method, quad_collapse, leaf_fmt)
    else:
        bvh = build_bvh(arrays.tri_v0, arrays.tri_v1, arrays.tri_v2,
                        leaf_size=leaf_size, method=method)
    leaf_size = int(max(1, bvh.leaf_count.max())) if bvh.num_nodes else 1
    ordered = arrays.permuted(bvh.perm) if bvh.perm.size else arrays

    n_lights = ordered.num_lights
    light_idx = ordered.light_indices
    if n_lights == 0:
        print("[Renderer Warning] No lights found in scene!", file=sys.stderr)  # renderer.cu:182
        light_idx = np.zeros(1, dtype=np.int32)

    bvh.quad_children = collapse_bvh(bvh, criterion=quad_collapse)
    q_table = pack_quad_table(
        bvh, ordered.tri_v0, ordered.tri_v1, ordered.tri_v2,
        leaf_size=leaf_size, children=bvh.quad_children, leaf_fmt=leaf_fmt)
    node_table = pack_traversal_table(
        bvh, ordered.tri_v0, ordered.tri_v1, ordered.tri_v2,
        leaf_size=leaf_size, leaf_fmt=leaf_fmt)
    fields = dict(quad_table=q_table, node_table=node_table,
                  trimat=pack_trimat_table(ordered), light_indices=light_idx)
    statics = dict(num_lights=n_lights, leaf_size=leaf_size,
                   has_normals=_has_normals(ordered),
                   has_uvs=bool(ordered.uv_mask is not None
                                and ordered.uv_mask.max(initial=0.0) > 0),
                   leaf_fmt=leaf_fmt)
    dev = DeviceScene.from_numpy(fields, statics, device)
    textures = tuple(np.asarray(t, np.float32) for t in ordered.textures)
    return dev, textures, bvh


def _has_normals(arrays: SceneArrays) -> bool:
    return bool(arrays.nrm0 is not None
                and (np.abs(arrays.nrm0).max(initial=0.0) > 0
                     or np.abs(arrays.nrm1).max(initial=0.0) > 0
                     or np.abs(arrays.nrm2).max(initial=0.0) > 0))


def refit_scene(dev: DeviceScene, bvh: LinearBVH, arrays: SceneArrays
                ) -> tuple[DeviceScene, LinearBVH]:
    """Re-upload moved geometry without rebuilding the BVH (JAX
    device_scene.py ``refit_scene``).  ``arrays`` is the scene in its
    original primitive order, with the topology and light set of the
    upload; vertices and materials may have moved.  The tree keeps its
    shape and its collapse mapping (``bvh.quad_children``), so every
    table keeps its shape; the statics are kept as they are.  Returns
    (the new scene on ``dev``'s device, the refit BVH)."""
    ordered = arrays.permuted(bvh.perm) if bvh.perm.size else arrays
    new_bvh = refit_bvh(bvh, ordered.tri_v0, ordered.tri_v1,
                        ordered.tri_v2)
    device = dev.quad_table.device
    q_table, n_table = dev.quad_table, dev.node_table
    if int(q_table.shape[0]):
        q_table = torch.as_tensor(pack_quad_table(
            new_bvh, ordered.tri_v0, ordered.tri_v1, ordered.tri_v2,
            leaf_size=dev.leaf_size, children=new_bvh.quad_children,
            leaf_fmt=dev.leaf_fmt), device=device)
        n_table = torch.as_tensor(pack_traversal_table(
            new_bvh, ordered.tri_v0, ordered.tri_v1, ordered.tri_v2,
            leaf_size=dev.leaf_size, leaf_fmt=dev.leaf_fmt), device=device)
    new = dataclasses.replace(
        dev, quad_table=q_table, node_table=n_table,
        trimat=torch.as_tensor(pack_trimat_table(ordered), device=device))
    return new, new_bvh


def device_textures(textures, device) -> tuple:
    """The raw [H, W, 3] float32 textures on ``device``: what the bounce
    engine samples (ops/texture.py ``sample_textures``)."""
    return tuple(torch.as_tensor(np.asarray(t, np.float32), device=device)
                 for t in textures)
