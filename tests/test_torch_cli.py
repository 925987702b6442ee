"""The port's CLI (``python -m tryraytrace_tpu_torch.cli``) on the CPU:
render held to the Renderer and to the JAX package's NumPy oracle,
resume and tiles bit-equal to the plain run, --obj scenes and info
against the JAX package, the engine and parallel-layer flags against
the Renderer, the flags the port refuses, and the headless
interactive commands.  No JAX program is compiled."""

import json
import os
import re
import socket

import numpy as np
import pytest
import torch

from tryraytrace_tpu import cli as jcli
from tryraytrace_tpu.accel.bvh import build_bvh as jbuild_bvh
from tryraytrace_tpu.oracle.cpu_renderer import oracle_render

from tryraytrace_tpu_torch import cli
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.io.ppm import load_ppm

torch.set_num_threads(1)

W, H = 24, 16
MSE_EXPECT = 1e-9  # tests/test_torch_renderer.py
SCENE = ["--scene", "cornell-nomesh", "--width", str(W), "--height", str(H)]
OCTAHEDRON = """# an octahedron
v 1 0 0
v -1 0 0
v 0 1 0
v 0 -1 0
v 0 0 1
v 0 0 -1
f 1 3 5
f 3 2 5
f 2 4 5
f 4 1 5
f 3 1 6
f 2 3 6
f 4 2 6
f 1 4 6
"""


def _render(tmp_path, name, *extra, frames=2):
    out = tmp_path / f"{name}.ppm"
    ck = tmp_path / f"{name}.npz"
    rc = cli.main(["render", *SCENE, "--device", "cpu", "--frames",
                   str(frames), "--out", str(out), "--checkpoint", str(ck),
                   *extra])
    assert rc == 0
    with np.load(ck) as z:
        return load_ppm(out), {k: z[k] for k in z.files}


def _args(*argv):
    return cli.build_parser().parse_args(["render", *argv])


def test_render_matches_renderer_and_oracle(tmp_path, capsys):
    img, ck = _render(tmp_path, "a")
    out = capsys.readouterr().out
    assert f"[tpurt] wrote {tmp_path / 'a.ppm'} ({W}x{H}, 2 spp," in out
    arrays = cli.build_scene_arrays(_args(*SCENE))
    cfg = RenderConfig(width=W, height=H, spp=1)
    r = Renderer(arrays, cfg=cfg, device="cpu")
    params = CameraController().get_params(W, H)
    r.step(params)
    r.step(params)
    assert img.tobytes() == r.image().tobytes()
    assert ck["accum"].tobytes() == r.state.accum.numpy().tobytes()
    assert (int(ck["spp"]), int(ck["frame_seed"])) == (2, 3)
    ora = sum(oracle_render(arrays, params, W, H, frame_seed=f, spp=1,
                            cfg=cfg) for f in (1, 2))
    assert float(((ck["accum"] / 2 - ora / 2) ** 2).mean()) < MSE_EXPECT


def test_resume_equals_one_command(tmp_path):
    whole = _render(tmp_path, "whole", frames=4)
    _render(tmp_path, "first", frames=2)
    resumed = _render(tmp_path, "resumed", "--resume",
                      str(tmp_path / "first.npz"), frames=2)
    assert resumed[0].tobytes() == whole[0].tobytes()
    for key in ("accum", "spp", "frame_seed", "cam_pos", "cam_yaw"):
        assert resumed[1][key].tobytes() == whole[1][key].tobytes(), key


def test_tiles_equal_no_tiles(tmp_path):
    plain = _render(tmp_path, "plain", frames=1)
    tiled = _render(tmp_path, "tiled", "--tiles", "3", frames=1)
    assert tiled[0].tobytes() == plain[0].tobytes()
    assert tiled[1]["accum"].tobytes() == plain[1]["accum"].tobytes()


def test_resume_at_another_size_exits(tmp_path):
    _render(tmp_path, "small", frames=1)
    out = tmp_path / "big.ppm"
    with pytest.raises(SystemExit, match=f"checkpoint is {W}x{H}"):
        cli.main(["render", "--scene", "cornell-nomesh", "--width", "32",
                  "--height", str(H), "--device", "cpu", "--frames", "1",
                  "--resume", str(tmp_path / "small.npz"), "--out", str(out)])
    assert not out.exists()


def test_obj_scene_matches_jax(tmp_path):
    obj = tmp_path / "octa.obj"
    obj.write_text(OCTAHEDRON)
    args = _args("--scene", "cornell-nomesh", "--obj",
                 f"{obj}:12.5:50,20,45", "--obj", str(obj))
    ours, theirs = cli.build_scene_arrays(args), jcli.build_scene_arrays(args)
    assert ours.num_objects == theirs.num_objects == 7 + 16
    for name in ("tri_v0", "tri_v1", "tri_v2", "albedo", "emission",
                 "metallic", "roughness", "ior", "transmission", "tex_id",
                 "light_indices", "nrm0", "nrm1", "nrm2", "uv0", "uv1",
                 "uv2", "uv_mask"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert len(ours.textures) == len(theirs.textures) == 1
    assert ours.textures[0].tobytes() == theirs.textures[0].tobytes()


def test_info_matches_jax_bvh(tmp_path, capsys):
    obj = tmp_path / "octa.obj"
    obj.write_text(OCTAHEDRON)
    argv = ["--scene", "cornell-nomesh", "--obj", f"{obj}:10:50,30,50"]
    assert cli.main(["info", *argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"torch {torch.__version__}; device: cpu")
    arrays = jcli.build_scene_arrays(_args(*argv))
    bvh = jbuild_bvh(arrays.tri_v0, arrays.tri_v1, arrays.tri_v2,
                     leaf_size=8)
    assert f"scene: 15 triangles, {arrays.num_lights} lights, 1 textures" in out
    assert f"bvh: {bvh.num_nodes} nodes, depth {bvh.max_depth()}" in out
    assert bvh.max_depth() > 1


@pytest.mark.parametrize("argv,message", [
    (["--traversal", "pair"], "RenderConfig.traversal='pair' is not"),
    (["--scheduler", "pool"], "RenderConfig.scheduler='pool' is not"),
    (["--checkpoint", "state.orbax"], "writes .npz checkpoints only"),
])
def test_refused_flags_exit_with_a_message(argv, message, tmp_path, capsys):
    out = tmp_path / "x.ppm"
    with pytest.raises(SystemExit) as e:
        cli.main(["render", *SCENE, "--device", "cpu", "--frames", "1",
                  "--out", str(out), *argv])
    said = str(e.value.code) + capsys.readouterr().err
    assert e.value.code not in (0, None) and message in said
    assert not out.exists() and not list(tmp_path.iterdir())


@pytest.mark.parametrize("flag", [["--smooth"], ["--uv"],
                                  ["--leaf-isect", "mt"],
                                  ["--bvh-method", "sbvh"]])
def test_feature_flags_render(flag, tmp_path):
    """Each feature flag renders the Renderer's image under the config
    it asks for (tests/test_torch_features.py holds the features to the
    oracle)."""
    out = tmp_path / "x.ppm"
    obj = tmp_path / "octa.obj"
    obj.write_text(OCTAHEDRON)
    argv = [*SCENE, "--obj", f"{obj}:12:50,25,60", "--device", "cpu", *flag]
    assert cli.main(["render", *argv, "--frames", "1", "--out",
                     str(out)]) == 0
    args = cli.build_parser().parse_args(["render", *argv])
    cfg = cli._cfg_from_args(args)
    assert cfg != RenderConfig(width=W, height=H)
    r = Renderer(cli.build_scene_arrays(args), cfg=cfg, device="cpu")
    r.step(CameraController().get_params(W, H))
    assert load_ppm(str(out)).tobytes() == r.image().tobytes()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


COORDINATOR = ["--coordinator", "PORT", "--num-processes", "1",
               "--process-id", "0"]


@pytest.mark.parametrize("flags", [
    ["--engine", "bounce"],
    ["--sharded"],
    ["--sharded", "--cpu-devices", "2", "--mesh-tile", "2"],
    ["--sharded", "--cpu-devices", "2", "--mesh-sample", "2"],
    ["--sharded", "--cpu-devices", "4"],
    ["--sharded", "--cpu-devices", "4", "--mesh-tile", "2"],
    ["--sharded", "--cpu-devices", "2", "--engine", "bounce"],
    COORDINATOR,
    [*COORDINATOR, "--cpu-devices", "2", "--dist-backend", "gloo"],
    [*COORDINATOR, "--cpu-devices", "2", "--mesh-sample", "2", "--engine",
     "bounce"],
], ids=lambda f: " ".join(f).replace("PORT", "host:port"))
def test_engine_and_parallel_flags_render(flags, tmp_path):
    """Each engine and parallel-layer flag renders the one-device
    Renderer's image and sums: dp shards split pixels, and with spp equal
    to the sp shards each shard adds one sample to zero, so every mesh
    here is bit-exact (tests/test_torch_parallel.py holds the other
    splits)."""
    flags = [f"localhost:{_free_port()}" if f == "PORT" else f
             for f in flags]
    out, ck = tmp_path / "x.ppm", tmp_path / "x.npz"
    argv = ["render", *SCENE, "--device", "cpu", "--spp", "2", *flags]
    assert cli.main([*argv, "--frames", "1", "--out", str(out),
                     "--checkpoint", str(ck)]) == 0
    assert not torch.distributed.is_initialized()
    args = cli.build_parser().parse_args(argv)
    cfg = cli._cfg_from_args(args)
    r = Renderer(cli.build_scene_arrays(args), cfg=cfg, device="cpu")
    r.step(CameraController().get_params(W, H))
    assert load_ppm(str(out)).tobytes() == r.image().tobytes()
    with np.load(ck) as z:
        assert z["accum"].tobytes() == r.accum_host().reshape(-1, 3).tobytes()
        assert int(z["spp"]) == 2 and int(z["frame_seed"]) == 2


def test_bench_without_config_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--device", "cpu"])
    assert e.value.code == 2
    assert "bench.py is the JAX package's harness" in capsys.readouterr().err


def test_progressive_checkpoint_every_is_a_usage_error(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["interactive", *SCENE, "--device", "cpu", "--headless",
                  "--progressive", "--checkpoint-every", "2",
                  "--out-dir", str(tmp_path)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "usage:" in err and "--checkpoint-every works with the batch" in err
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("mode", ["batch", "progressive"])
def test_interactive_headless_script(mode, tmp_path, capsys):
    script = tmp_path / "script.json"
    script.write_text(json.dumps([{}, {"keys": ["a"]}, {"save": True}, {}]))
    out_dir = tmp_path / "out"
    extra = (["--progressive"] if mode == "progressive"
             else ["--checkpoint-every", "2"])
    rc = cli.main(["interactive", "--scene", "cornell-nomesh", "--width",
                   "16", "--height", "12", "--device", "cpu", "--headless",
                   "--script", str(script), "--out-dir", str(out_dir),
                   *extra])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"\[tpurt\] displayed (\d+) frames; snapshots: (.*)",
                     line)
    assert m and int(m.group(1)) >= 1
    snaps = [s.strip(" '") for s in m.group(2).strip("[]").split(",")]
    assert len(snaps) == 2 and all(os.path.exists(s) for s in snaps)
    assert (out_dir / "render_state.npz").exists() == (mode == "batch")


def test_render_without_a_card_fails_and_writes_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "x.ppm"
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["render", *SCENE, "--frames", "1", "--out", str(out),
                  "--checkpoint", str(tmp_path / "x.npz")])
    assert not list(tmp_path.iterdir())


@pytest.mark.cuda
def test_cuda_render_equals_cpu_render(tmp_path):
    """On the card: tpurt-torch render at 64x64 writes the bytes the CPU
    run writes."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA device")
    imgs = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.ppm"
        assert cli.main(["render", "--scene", "cornell-nomesh", "--width",
                         "64", "--height", "64", "--frames", "2",
                         "--device", device, "--out", str(out)]) == 0
        imgs[device] = out.read_bytes()
    assert imgs["cuda"] == imgs["cpu"]
