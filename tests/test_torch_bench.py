"""The port's benchmark configs and NumPy oracle on the CPU: build_config
field-equal to the JAX package's, the copied oracle byte-equal to the
JAX oracle, the spp chunking rule, and run_config / run_progressive /
``bench --config`` at a small raster.  No JAX program is compiled."""

import json

import numpy as np
import pytest
import torch

from tryraytrace_tpu import benchmarks as jbench
from tryraytrace_tpu.oracle.cpu_renderer import oracle_render as joracle

from tryraytrace_tpu_torch import benchmarks, cli
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.oracle import oracle_render
from tryraytrace_tpu_torch.scene.assets import checker_texture, cube_mesh
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import Object, flatten_scene

torch.set_num_threads(1)

W, H = 16, 12
MSE_EXPECT = 1e-9  # tests/test_golden.py
ARRAY_FIELDS = ("tri_v0", "tri_v1", "tri_v2", "albedo", "emission",
                "metallic", "roughness", "ior", "transmission", "tex_id",
                "light_indices", "nrm0", "nrm1", "nrm2", "uv0", "uv1", "uv2",
                "uv_mask")
# The JAX package's run_config record (tryraytrace_tpu/benchmarks.py).
JAX_RECORD_KEYS = {"config", "width", "height", "spp", "tris",
                   "ms_per_frame", "fps", "rays_per_frame", "mrays_per_s",
                   "engine"}
JAX_PROGRESSIVE_KEYS = {"config", "mode", "width", "height", "tris",
                        "iters_per_frame", "ms_per_frame", "spp_per_frame",
                        "ms_per_1spp", "fps", "mrays_per_s", "compile_s"}


@pytest.fixture
def small(monkeypatch):
    """build_config at W x H (every other field as the config has it)."""
    build = benchmarks.build_config

    def patched(name):
        arrays, _w, _h, spp, check = build(name)
        return arrays, W, H, spp, check

    monkeypatch.setattr(benchmarks, "build_config", patched)


@pytest.mark.parametrize("name", benchmarks.CONFIGS)
def test_build_config_matches_jax(name):
    ours, theirs = benchmarks.build_config(name), jbench.build_config(name)
    assert ours[1:] == theirs[1:]
    a, b = ours[0], theirs[0]
    for field in ARRAY_FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field
    assert [t.tobytes() for t in a.textures] == [t.tobytes()
                                                 for t in b.textures]


def test_build_config_says_which_mesh_it_substituted(capsys):
    benchmarks.build_config("teddy1024")
    err = capsys.readouterr().err
    assert "[bench] asset teddy.obj missing; substituting cube" in err
    assert "[bench] asset pumpkin.obj missing; substituting cube" in err
    with pytest.raises(ValueError, match="unknown config 'nope'"):
        benchmarks.build_config("nope")


@pytest.mark.parametrize("name", benchmarks.CONFIGS)
def test_spp_chunk_is_the_jax_rule(name):
    _, w, h, spp, _ = benchmarks.build_config(name)
    # tryraytrace_tpu/benchmarks.py:148-150
    want = max(1, min(spp, int(2e8 / (w * h * 12))))
    while spp % want:
        want -= 1
    assert benchmarks.spp_chunk(w, h, spp) == want
    assert spp % want == 0


def _textured_cornell():
    return flatten_scene(create_cornell_box(mesh=None),
                         textures=[checker_texture(32)])


@pytest.mark.parametrize("scene,frame_seed,spp,aperture", [
    ("cube256", 1, 1, 0.0),
    ("cube256", 9, 2, 0.0),
    ("cornell", 3, 1, 2.0),
])
def test_oracle_is_byte_equal_to_jax(scene, frame_seed, spp, aperture):
    arrays = (benchmarks.build_config("cube256")[0] if scene == "cube256"
              else _textured_cornell())
    cam = CameraController()
    cam.aperture = aperture
    params = cam.get_params(W, H)
    cfg = RenderConfig(width=W, height=H, spp=spp)
    ours = oracle_render(arrays, params, W, H, frame_seed=frame_seed,
                         spp=spp, cfg=cfg)
    theirs = joracle(arrays, params, W, H, frame_seed=frame_seed, spp=spp,
                     cfg=cfg)
    assert ours.dtype == np.float32 and ours.shape == (W * H, 3)
    assert ours.tobytes() == theirs.tobytes()
    assert ours.mean() > 0


def _featured_cornell():
    """The Cornell box and a textured cube whose corners carry normals
    (the cube's vertex directions) and UVs."""
    scene = create_cornell_box(mesh=None)
    v0, v1, v2 = cube_mesh()
    for tri in zip(v0, v1, v2):
        corners = [np.asarray(v, np.float32) for v in tri]
        scene.objects.append(Object(
            *(tuple(c * 15 + [50, 25, 55]) for c in corners),
            albedo=(0.8, 0.8, 0.8), roughness=1.0, tex_id=0,
            n0=tuple(corners[0] / np.linalg.norm(corners[0])),
            n1=tuple(corners[1] / np.linalg.norm(corners[1])),
            n2=tuple(corners[2] / np.linalg.norm(corners[2])),
            uv0=(0.1, 0.2), uv1=(0.9, 0.3), uv2=(0.4, 0.8)))
    return flatten_scene(scene, textures=[checker_texture(32)])


@pytest.mark.parametrize("knob", [dict(smooth_shading=True),
                                  dict(uv_mapping=True),
                                  dict(leaf_isect="mt")])
def test_oracle_features_are_byte_equal_to_jax(knob):
    arrays = _featured_cornell()
    params = CameraController().get_params(W, H)
    cfg = RenderConfig(width=W, height=H, **knob)
    ours = oracle_render(arrays, params, W, H, frame_seed=2, cfg=cfg)
    theirs = joracle(arrays, params, W, H, frame_seed=2, cfg=cfg)
    assert ours.tobytes() == theirs.tobytes()
    plain = oracle_render(arrays, params, W, H, frame_seed=2,
                          cfg=RenderConfig(width=W, height=H))
    assert ours.mean() > 0
    if "leaf_isect" not in knob:   # the leaf format changes no pixel here
        assert ours.tobytes() != plain.tobytes()


def test_run_config_holds_the_render_to_the_oracle(small):
    rec = benchmarks.run_config("cube256", frames=1, device="cpu")
    assert JAX_RECORD_KEYS | {"mse_vs_oracle"} <= set(rec)
    assert (rec["config"], rec["width"], rec["height"], rec["spp"]) == (
        "cube256", W, H, 1)
    assert rec["device"] == "cpu" and rec["engine"] == "persistent"
    assert rec["mse_vs_oracle"] < MSE_EXPECT
    # The timed frame is frame 2, after one warm-up step: its exact rays.
    arrays = benchmarks.build_config("cube256")[0]
    r = Renderer(arrays, cfg=RenderConfig(width=W, height=H, spp=1),
                 device="cpu")
    params = CameraController().get_params(W, H)
    r.step(params)
    r.step(params)
    st = r.last_stats
    assert rec["rays_per_frame"] == int(st["n_traced"]) + int(st["n_shadow"])
    assert rec["mrays_per_s"] > 0 and rec["ms_per_frame"] > 0


def test_run_config_fly_through(monkeypatch):
    """flythrough1080's camera path, at W x H and 1 spp with the oracle
    check on, so the frame after the moves is held to the oracle."""
    build = benchmarks.build_config

    def patched(name):
        arrays = build(name)[0]
        return arrays, W, H, 1, name == "flythrough1080"

    monkeypatch.setattr(benchmarks, "build_config", patched)
    rec = benchmarks.run_config("flythrough1080", frames=2, device="cpu")
    assert rec["config"] == "flythrough1080" and rec["spp"] == 1
    assert rec["rays_per_frame"] > W * H and rec["mse_vs_oracle"] < MSE_EXPECT


def test_run_progressive(small):
    rec = benchmarks.run_progressive("interactive", frames=2, device="cpu")
    assert JAX_PROGRESSIVE_KEYS <= set(rec)
    assert rec["mode"] == "progressive" and rec["device"] == "cpu"
    assert rec["spp_per_frame"] > 0 and rec["iters_per_frame"] >= 1
    assert rec["mrays_per_s"] > 0


def test_cli_bench_prints_one_json_line_per_config(small, capsys):
    assert cli.main(["bench", "--config", "cube256", "--frames", "1",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["config"] == "cube256" and rec["mse_vs_oracle"] < MSE_EXPECT
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--config", "nope", "--device", "cpu"])
    assert e.value.code == 2


@pytest.mark.cuda
def test_cuda_cube256_against_the_oracle():
    """On the card: cube256 at its full 256x256 against the oracle."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA device")
    rec = benchmarks.run_config("cube256", frames=1)
    assert rec["mse_vs_oracle"] < MSE_EXPECT
    assert rec["device"] == torch.cuda.get_device_name(0)
