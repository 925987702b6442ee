"""The port's host layer against the JAX package's: the port imports no
jax, and its config, camera, BVH build, packed tables, texture tiles
and unified inline table equal the JAX package's byte for byte."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tryraytrace_tpu.config as jconfig
from tryraytrace_tpu.accel.bvh import build_bvh as jbuild_bvh
from tryraytrace_tpu.camera.controller import CameraController as JCam
from tryraytrace_tpu.engine.device_scene import upload_scene as jupload
from tryraytrace_tpu.engine.persistent import (build_inline_table as
                                               jbuild_inline)
from tryraytrace_tpu.scene import assets as jassets
from tryraytrace_tpu.scene.cornell import create_cornell_box as jcornell
from tryraytrace_tpu.scene.model import Object as JObject
from tryraytrace_tpu.scene.model import flatten_scene as jflatten

from tryraytrace_tpu_torch import config as tconfig
from tryraytrace_tpu_torch.accel.bvh import build_bvh as tbuild_bvh
from tryraytrace_tpu_torch.camera.controller import CameraController as TCam
from tryraytrace_tpu_torch.engine.device_scene import DeviceScene
from tryraytrace_tpu_torch.engine.device_scene import upload_scene as tupload
from tryraytrace_tpu_torch.engine.persistent import (build_inline_table as
                                                     tbuild_inline)
from tryraytrace_tpu_torch.scene import assets as tassets
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box as tcornell
from tryraytrace_tpu_torch.scene.model import Object as TObject
from tryraytrace_tpu_torch.scene.model import flatten_scene as tflatten

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import tryraytrace_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('tryraytrace_tpu.') or m == 'tryraytrace_tpu']\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_render_config_defaults_match():
    assert (dataclasses.asdict(tconfig.RenderConfig())
            == dataclasses.asdict(jconfig.RenderConfig()))
    for kw in ({}, {"quad_regs": 2}, {"quad_select": "perm"}):
        assert (tconfig.quad_select_resolved(tconfig.RenderConfig(**kw))
                == jconfig.quad_select_resolved(jconfig.RenderConfig(**kw)))


@pytest.mark.parametrize("kw", [
    {"traversal": "pair"}, {"scheduler": "pool"}, {"dual_walk": True},
    {"shadow_pred": True}, {"inline_shade": False},
    {"quad_layout": "octant"}, {"quad_layout": None},
    {"quad_select": "rank", "quad_regs": 0}, {"engine": "wavefront"},
    {"inline_tex": False}, {"leaf_isect": "xx"}, {"bvh_method": "xx"},
])
def test_unported_knobs_raise(kw):
    with pytest.raises(ValueError):
        tconfig.check_supported(tconfig.RenderConfig(**kw))


@pytest.mark.parametrize("kw", [
    {"smooth_shading": True}, {"uv_mapping": True}, {"leaf_isect": "mt"},
    {"engine": "bounce"},
])
def test_feature_knobs_are_accepted(kw):
    tconfig.check_supported(tconfig.RenderConfig(**kw))


def test_scheduling_knobs_are_accepted():
    tconfig.check_supported(tconfig.RenderConfig(
        shade_every=3, step_unroll=2, inline_service_steps=1,
        spill_stages=4, max_wave_lanes=1024))


@pytest.mark.parametrize("moves", [(), ("w", "d"), ("q", "t", "t")])
def test_camera_params_match(moves):
    jc, tc = JCam(), TCam()
    for key in moves:
        jc.update(1.0, {key})
        tc.update(1.0, {key})
    jc.process_mouse(12.5, -3.0)
    tc.process_mouse(12.5, -3.0)
    jp, tp = jc.get_params(320, 200), tc.get_params(320, 200)
    for f in dataclasses.fields(tp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    cuda_free = tp.to("cpu")
    np.testing.assert_array_equal(cuda_free.cx.numpy(), jp.cx)


def _scenes(kind):
    """The same scene built by both packages' host code."""
    out = []
    for cornell, obj, flatten, assets in (
            (jcornell, JObject, jflatten, jassets),
            (tcornell, TObject, tflatten, tassets)):
        scene = cornell(mesh=None)
        if kind == "cube":
            v0, v1, v2 = assets.cube_mesh(15.0)
            off = np.float32([50, 20, 50])
        else:
            v0, v1, v2 = assets.icosphere_mesh(2, 15.0)
            off = np.float32([50, 20, 50])
        for a, b, c in zip(v0 + off, v1 + off, v2 + off):
            scene.objects.append(obj(v0=tuple(a), v1=tuple(b), v2=tuple(c),
                                     albedo=(0.75, 0.75, 0.75),
                                     metallic=1.0, roughness=0.1))
        out.append(flatten(scene, textures=[assets.checker_texture(64)]))
    return out


@pytest.mark.parametrize("kind", ["cube", "icosphere"])
def test_upload_and_inline_table_match_jax(kind):
    ja, ta = _scenes(kind)
    for f in dataclasses.fields(ta):
        a, b = getattr(ja, f.name), getattr(ta, f.name)
        if f.name == "textures":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)

    jcfg = jconfig.RenderConfig()
    jdev, jtex, jbvh = jupload(
        ja, leaf_size=jcfg.bvh_leaf_size, method=jcfg.bvh_method,
        traversal=jcfg.traversal, leaf_fmt=jcfg.leaf_isect,
        quad_collapse=jcfg.quad_collapse, quad_layout=jcfg.quad_layout,
        quad_select=jconfig.quad_select_resolved(jcfg))
    tcfg = tconfig.RenderConfig()
    tdev, ttex, tbvh = tupload(
        ta, leaf_size=tcfg.bvh_leaf_size, method=tcfg.bvh_method,
        quad_collapse=tcfg.quad_collapse, device="cpu")

    # BVH arrays and the auto leaf size.
    for name in ("bounds", "leaf_prim", "leaf_count", "miss", "left",
                 "right", "axis", "perm"):
        np.testing.assert_array_equal(getattr(jbvh, name),
                                      getattr(tbvh, name))
    assert jbvh.quad_children == tbvh.quad_children
    assert jdev.leaf_size == tdev.leaf_size
    for name in DeviceScene.STATICS:
        assert getattr(jdev, name) == getattr(tdev, name), name
    # Packed quad table and trimat rows.
    np.testing.assert_array_equal(np.asarray(jdev.quad_table),
                                  tdev.quad_table.numpy())
    np.testing.assert_array_equal(np.asarray(jdev.trimat),
                                  tdev.trimat.numpy())
    np.testing.assert_array_equal(np.asarray(jdev.light_indices),
                                  tdev.light_indices.numpy())

    # Unified inline table: quad rows, packed trimat rows, tile rows.
    jtable, jctx = jbuild_inline(
        jdev.quad_table, jdev.quad_table.shape[0], jdev, jtex, jcfg, None,
        0, None, 8, 8, 1, 0, 1, 1, 64)
    tin = tbuild_inline(tdev, ttex)
    assert jctx["tex"] is not None and tin.tex0 == jctx["tex"]["tex0"]
    assert tin.pack == jctx["pack"]
    assert tin.sentinel == jdev.quad_table.shape[0]
    assert tin.metas == jctx["tex"]["metas"]
    np.testing.assert_array_equal(np.asarray(jtable), tin.table.numpy())

    # The carry-over: the JAX upload's arrays give the port's scene.
    fields, statics = {}, {}
    for f in dataclasses.fields(jdev):
        val = getattr(jdev, f.name)
        if isinstance(val, (int, bool, str)):
            statics[f.name] = val
        else:
            fields[f.name] = np.asarray(val)
    carried = DeviceScene.from_numpy(fields, statics, "cpu")
    for name in DeviceScene.ARRAYS:
        assert torch.equal(getattr(carried, name), getattr(tdev, name))
    assert DeviceScene.from_numpy(fields, dict(statics, leaf_fmt="mt"),
                                  "cpu").leaf_fmt == "mt"
    with pytest.raises(ValueError):
        DeviceScene.from_numpy(fields, dict(statics, leaf_fmt="xx"), "cpu")
    with pytest.raises(ValueError):
        DeviceScene.from_numpy(fields, dict(statics, quad_layout="octant"),
                               "cpu")


@pytest.mark.parametrize("method,leaf_size", [("sah", 4), ("median", 1)])
def test_numpy_bvh_build_matches_native_and_jax(method, leaf_size):
    ja, ta = _scenes("icosphere")
    want = jbuild_bvh(ja.tri_v0, ja.tri_v1, ja.tri_v2, leaf_size=leaf_size,
                      method=method)
    for use_native in (True, False):
        got = tbuild_bvh(ta.tri_v0, ta.tri_v1, ta.tri_v2,
                         use_native=use_native, leaf_size=leaf_size,
                         method=method)
        for name in ("bounds", "leaf_prim", "leaf_count", "miss", "left",
                     "right", "axis", "perm"):
            np.testing.assert_array_equal(getattr(want, name),
                                          getattr(got, name), name)


# Vertex and face lines the reference loader (loader.cpp:22-103) treats
# differently: slash faces, a quad, out-of-range and malformed indices,
# and a malformed vertex that still takes an index slot.
_OBJ_TEXT = """\
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
v 1 x 2
f 1 2 3
f 1 2 4
f 2 3 4 1
f 1/1 2/2 3/3
f 1 2 3/7
f 1 2 9
f 0 1 2
f 3 4 5
"""


@pytest.mark.parametrize("parser", ["default", "python"])
def test_obj_loader_matches_jax(tmp_path, parser):
    from tryraytrace_tpu.scene import objloader as jobj
    from tryraytrace_tpu_torch.scene import objloader as tobj

    path = tmp_path / "mesh.obj"
    path.write_text(_OBJ_TEXT)
    want = jobj.parse_obj_arrays(str(path))
    got = (tobj.parse_obj_arrays(str(path)) if parser == "default"
           else tobj._parse_obj_python(str(path)))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert want[1].shape == (5, 3)
    jl, tl = [], []
    kw = dict(offset=(50.0, 10.0, 50.0), scale=10.0, metallic=1.0,
              roughness=0.1)
    assert jobj.load_obj(str(path), jl, **kw) == tobj.load_obj(
        str(path), tl, **kw) == 5
    assert [dataclasses.asdict(o) for o in jl] == [
        dataclasses.asdict(o) for o in tl]
    assert tobj.load_obj(str(tmp_path / "missing.obj"), tl) == 0


def test_ppm_round_trip_matches_jax(tmp_path):
    from tryraytrace_tpu.io import ppm as jppm
    from tryraytrace_tpu_torch.io import ppm as tppm

    img = np.random.RandomState(5).randint(0, 256, (7, 11, 3)).astype(
        np.uint8)
    tppm.save_ppm(tmp_path / "t.ppm", img)
    jppm.save_ppm(tmp_path / "j.ppm", img)
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()
    np.testing.assert_array_equal(tppm.load_ppm(tmp_path / "j.ppm"), img)


@pytest.mark.parametrize("leaf_size", [4, 6])
def test_explicit_leaf_and_collapse_match(leaf_size):
    ja, ta = _scenes("icosphere")
    for crit in ("count", "sa"):
        jdev, _, _ = jupload(ja, leaf_size=leaf_size, leaf_fmt="bw",
                             quad_collapse=crit)
        tdev, _, _ = tupload(ta, leaf_size=leaf_size, quad_collapse=crit,
                             device="cpu")
        np.testing.assert_array_equal(np.asarray(jdev.quad_table),
                                      tdev.quad_table.numpy())
