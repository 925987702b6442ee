"""The port's parallel layer (tryraytrace_tpu_torch/parallel/) on the CPU:
meshes split as the JAX package's, ShardedRenderer over repeated CPU
devices against the one-device Renderer, and two OS processes joined
over gloo through the CLI.

Tolerances (tests/test_parallel.py): with sp = 1 a mesh only splits
pixels, so the image is the Renderer's bit for bit; with sp > 1 the
sample slices' sums are added in another order than one device adds
them, so the sums agree within atol 1e-4, and the int64 ray totals are
equal.  No JAX engine program is compiled."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tryraytrace_tpu.parallel.mesh import make_mesh as jmake_mesh

from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.io.ppm import load_ppm
from tryraytrace_tpu_torch.parallel import distributed
from tryraytrace_tpu_torch.parallel.mesh import (SAMPLE_AXIS, TILE_AXIS,
                                                 make_mesh)
from tryraytrace_tpu_torch.parallel.shard import (ShardedRenderer,
                                                  render_frame_sharded)
from tryraytrace_tpu_torch.scene.assets import checker_texture
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import flatten_scene

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
W, H, SPP = 16, 8, 4
ATOL_SP = 1e-4  # tests/test_parallel.py


@pytest.fixture(scope="module")
def arrays():
    return flatten_scene(create_cornell_box(mesh=None),
                         textures=[checker_texture(32)])


def _cpu_mesh(tile, sample):
    return make_mesh(["cpu"] * (tile * sample), tile=tile, sample=sample)


_SINGLE = {}


def _single(arrays, frames=1, engine="persistent"):
    """The one-device Renderer after ``frames`` steps (made once)."""
    if (frames, engine) not in _SINGLE:
        r = Renderer(arrays, cfg=RenderConfig(width=W, height=H, spp=SPP,
                                              engine=engine), device="cpu")
        p = CameraController().get_params(W, H)
        for _ in range(frames):
            r.step(p)
        _SINGLE[frames, engine] = r
    return _SINGLE[frames, engine]


def _sharded(arrays, tile, sample, frames=1, **cfg_kw):
    r = ShardedRenderer(arrays, RenderConfig(width=W, height=H, spp=SPP,
                                             **cfg_kw),
                        mesh=_cpu_mesh(tile, sample))
    p = CameraController().get_params(W, H)
    for _ in range(frames):
        r.step(p)
    return r


@pytest.mark.parametrize("n,tile,sample", [
    (8, None, None), (8, 4, None), (8, None, 2), (8, 2, 4), (6, 3, 2),
    (8, 3, None), (8, None, 3), (8, 4, 4), (1, None, None)])
def test_make_mesh_splits_and_errors_as_jax(n, tile, sample):
    jdevs = jax.devices()[:n]
    try:
        want = dict(jmake_mesh(jdevs, tile=tile, sample=sample).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match="!= .* devices"):
            make_mesh(["cpu"] * n, tile=tile, sample=sample)
        assert "devices" in str(e)
        return
    mesh = make_mesh(["cpu"] * n, tile=tile, sample=sample)
    assert mesh.shape == {TILE_AXIS: want["dp"], SAMPLE_AXIS: want["sp"]}
    assert len(mesh.local(0)) == n and mesh.local(1) == []


def test_default_mesh_takes_every_card_and_raises_without_one():
    if torch.cuda.is_available():
        assert make_mesh().shape[TILE_AXIS] == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.parametrize("engine", ["persistent", "bounce"])
@pytest.mark.parametrize("tile", [1, 2, 4])
def test_tile_sharded_is_bit_identical(arrays, engine, tile):
    """sp = 1 over two frames: each shard renders its pixels' samples, so
    the sums are the Renderer's bit for bit, and so is the image."""
    ref = _single(arrays, frames=2, engine=engine)
    out = _sharded(arrays, tile, 1, frames=2, engine=engine)
    np.testing.assert_array_equal(out.accum_host(), ref.accum_host())
    assert out.image().tobytes() == ref.image().tobytes()
    assert out.spp() == ref.spp() == 2 * SPP and out.frame == ref.frame
    for key in ("n_traced", "n_shadow"):
        assert int(out.last_stats[key]) == int(ref.last_stats[key])


@pytest.mark.parametrize("engine", ["persistent", "bounce"])
@pytest.mark.parametrize("tile,sample", [(2, 2), (1, 2), (1, 4)])
def test_sample_sharded_matches_single(arrays, engine, tile, sample):
    ref = _single(arrays, frames=2, engine=engine)
    out = _sharded(arrays, tile, sample, frames=2, engine=engine)
    np.testing.assert_allclose(out.accum_host(), ref.accum_host(), rtol=0,
                               atol=ATOL_SP)
    for key in ("n_traced", "n_shadow"):
        assert int(out.last_stats[key]) == int(ref.last_stats[key])


@pytest.mark.parametrize("engine", ["persistent", "bounce"])
def test_sharded_step_reports_each_shards_iterations(arrays, engine):
    """``last_stats["shard_iterations"]`` holds one entry per shard (what
    a launch count is checked against): on a 1x1 mesh the Renderer's
    rounds or bounces, on a (2,2) mesh every shard's."""
    ref = _single(arrays, engine=engine)
    one = _sharded(arrays, 1, 1, engine=engine)
    assert one.last_stats["shard_iterations"] == {
        (0, 0): ref.last_stats["iterations"]}
    four = _sharded(arrays, 2, 2, engine=engine)
    its = four.last_stats["shard_iterations"]
    assert sorted(its) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(n > 0 for n in its.values())


def test_render_frame_sharded_returns_blocks_and_totals(arrays):
    r = _sharded(arrays, 4, 1)
    blocks, (tr, sh) = render_frame_sharded(
        r.replicas, CameraController().get_params(W, H), 1, W, H, r.cfg,
        SPP, r.mesh, with_stats=True)
    ref = _single(arrays)
    assert sorted(blocks) == [0, 1, 2, 3]
    got = torch.cat([blocks[i] for i in range(4)]).numpy()
    assert got.tobytes() == ref.accum_host().reshape(-1, 3).tobytes()
    assert (tr, sh) == (int(ref.last_stats["n_traced"]),
                        int(ref.last_stats["n_shadow"]))


def test_bad_divisibility_raises(arrays):
    cam = CameraController()
    r = ShardedRenderer(arrays, RenderConfig(width=10, height=3, spp=1),
                        mesh=_cpu_mesh(8, 1))
    with pytest.raises(ValueError, match="not divisible by dp=8"):
        r.step(cam.get_params(10, 3))
    r = ShardedRenderer(arrays, RenderConfig(width=W, height=H, spp=1),
                        mesh=_cpu_mesh(2, 4))
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        r.step(cam.get_params(W, H), spp=3)


def test_spp_change_mid_accumulation_raises(arrays):
    p = CameraController().get_params(W, H)
    r = ShardedRenderer(arrays, RenderConfig(width=W, height=H, spp=2),
                        mesh=_cpu_mesh(2, 2))
    r.step(p)
    with pytest.raises(ValueError, match="alias"):
        r.step(p, spp=4)
    r.reset()
    assert r.spp() == 0 and not r.accum_host().any()
    r.step(p, spp=4)
    assert r.spp() == 4


def test_restore_takes_over_a_whole_image(arrays):
    ref = _single(arrays, frames=2)
    r = _sharded(arrays, 4, 1)
    one = _single(arrays)
    r.restore(one.state)
    assert r.spp() == SPP
    r.frame = one.frame
    r.step(CameraController().get_params(W, H))
    np.testing.assert_array_equal(r.accum_host(), ref.accum_host())


# -- two OS processes through the CLI ---------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(n_proc, extra):
    """``n_proc`` processes of ``tpurt-torch render`` over gloo on the
    CPU, two CPU shards each."""
    base = [sys.executable, "-m", "tryraytrace_tpu_torch.cli", "render",
            "--device", "cpu", "--scene", "cornell-nomesh", "--width", "16",
            "--height", "16", "--spp", "2", "--frames", "1", "--sharded",
            "--coordinator", f"localhost:{_free_port()}", "--num-processes",
            str(n_proc), "--cpu-devices", "2", *extra]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(base + ["--process-id", str(i)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(n_proc)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"process {i} failed:\n{logs[i]}"
    return logs


def _reference(frames):
    r = Renderer(flatten_scene(create_cornell_box(mesh=None),
                               textures=[checker_texture(256)]),
                 cfg=RenderConfig(width=16, height=16, spp=2), device="cpu")
    cam = CameraController()
    cam.aperture, cam.focus_dist = 0.0, 240.0
    for _ in range(frames):
        r.step(cam.get_params(16, 16))
    return r.image()


def test_two_process_render_matches_one_process(tmp_path):
    out = tmp_path / "dist.ppm"
    logs = _run(2, ["--out", str(out)])
    assert "[tpurt] wrote" in logs[0] and "[tpurt] wrote" not in logs[1]
    assert load_ppm(str(out)).tobytes() == _reference(1).tobytes()


def test_two_process_resume_from_checkpoint(tmp_path):
    ck = tmp_path / "ck.npz"
    _run(1, ["--checkpoint", str(ck), "--out", str(tmp_path / "f1.ppm")])
    out = tmp_path / "resumed.ppm"
    _run(2, ["--resume", str(ck), "--out", str(out)])
    assert load_ppm(str(out)).tobytes() == _reference(2).tobytes()
    assert not distributed.is_distributed()
