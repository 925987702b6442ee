"""The persistent engine's lane set-up (ops/lane_init.py) and the wave's
path to the wave kernel's launch.

On the CPU:
  - the port's ``init_lane_ctx`` (the plain version of the lane set-up
    kernel) against the JAX package's ``init_lane_ctx`` at 16x12, with
    the same seed-made frame seeds: sample offsets 0 and 3, seed-schedule
    spp 1 and 4, apertures 0 and 2.0, textured and untextured, 0 and 3
    skip registers, pixels from 0 and a range that does not start at 0;
  - ``service_params`` packed from a host camera byte-equal to the same
    camera moved to the device, and the light rows and texture layout
    built once per unified table and rebuilt by ``Renderer.refit``;
  - ``lane_init_cuda``'s refusals (CPU tensors, a field's dtype or
    shape, the skip registers, 2**31 lanes, a written field that does not
    start on 16 bytes), raised before any library is loaded;
  - chip_smoke.py's guarded state (every field a view into one buffer
    of guard bytes) and its check of the guard bytes;
  - a CPU ``Wave`` (a ``range`` of pixels or a pixel tensor): its fresh
    state is ``init_lane_ctx``'s, and ``read()`` after the compacting
    round loop equals the plain wave loop's sums and counts.
On a card (``cuda``-marked, skipped elsewhere): the kernel against
``init_lane_ctx`` on the card, bit for bit, on a state poisoned first
(NaN payloads in floats, 0x5A bytes in integers and bools) so that a
field it does not write shows; ``Renderer.step`` and ``step_tiled`` on
the card against the CPU at 64x48, bit for bit, one lane set-up launch
a wave; and the step from ``Wave.__init__`` to the wave kernel's read
of its counters without a synchronizing call.

Tolerance.  Integer, bool and seed fields exactly (the JAX package's
int32 and uint32 compared as int64), the constant float fields exactly;
``o`` and ``d`` within tests/test_torch_ops.py's tolerance for
``generate_rays``, rtol 1e-6 (and atol 1e-6 with a lens: cos and sin
in float64 on one side, float32 on the other).  The kernel against the
plain version: bit for bit.  The JAX package is imported inside the
tests that compare with it, so the card's tests run without it; no JAX
program is compiled.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine import persistent
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.ops import lane_init, service, wave
from tryraytrace_tpu_torch.ops._build import KernelLibrary
from tryraytrace_tpu_torch.scene.assets import checker_texture
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import flatten_scene

torch.set_num_threads(1)

W, H = 16, 12
RTOL = 1e-6
ATOL_LENS = 1e-6
# name -> (sample_offset, seed_spp, aperture, textured, quad_regs,
#          first pixel, lanes (None: the rest of the frame))
CASES = {
    "base": (0, 1, 0.0, True, 3, 0, None),
    "offset3_spp4": (3, 4, 0.0, True, 3, 0, None),
    "lens": (0, 1, 2.0, True, 3, 0, None),
    "untextured_no_regs": (0, 1, 0.0, False, 0, 0, None),
    "strip": (0, 1, 0.0, True, 3, 50, 100),
    "all": (3, 4, 2.0, False, 0, 37, 120),
}
FLOAT_FIELDS = ("d_min", "tp", "rad", "so", "sd", "smax", "pend", "tstash")


def _cfg(regs: int, **kw) -> RenderConfig:
    return RenderConfig(width=W, height=H, quad_regs=regs,
                        quad_select="perm", **kw)


def _camera(aperture: float, w: int = W, h: int = H):
    cc = CameraController()
    cc.aperture = aperture
    return cc.get_params(w, h)


def _pixels(first: int, lanes, w: int = W, h: int = H) -> range:
    return range(first, w * h if lanes is None else first + lanes)


def _arrays(textured: bool):
    return flatten_scene(create_cornell_box(mesh=None),
                         textures=[checker_texture(32)] if textured else [])


@pytest.fixture(scope="module")
def renderers():
    return {tex: Renderer(_arrays(tex), cfg=_cfg(3), device="cpu")
            for tex in (True, False)}


@pytest.mark.parametrize("name", list(CASES))
def test_init_lane_ctx_matches_the_jax_package(name):
    from tryraytrace_tpu.camera.controller import CameraController as JCam
    from tryraytrace_tpu.config import RenderConfig as JConfig
    from tryraytrace_tpu.engine.persistent import init_lane_ctx as jinit
    import jax.numpy as jnp

    off, seed_spp, aperture, textured, regs, first, lanes = CASES[name]
    frame_seed = int(np.random.RandomState(sum(map(ord, name)))
                     .randint(0, 2**31))
    pix = np.arange(_pixels(first, lanes).start,
                    _pixels(first, lanes).stop)
    jc = JCam()
    jc.aperture = aperture
    want = jinit(0, frame_seed, seed_spp, off, jnp.asarray(pix, jnp.int32),
                 jc.get_params(W, H), W, H, JConfig(quad_regs=regs),
                 pair=False, quad=True, with_tstash=textured)
    got = persistent.init_lane_ctx(frame_seed, seed_spp, torch.as_tensor(pix),
                                   _camera(aperture), W, H, _cfg(regs),
                                   with_tstash=textured, sample_offset=off)
    assert set(got) == set(want) | {"out"}
    assert not got["out"].any() and got["out"].shape == (len(pix), 3)
    atol = ATOL_LENS if aperture else 0.0
    for key, val in want.items():
        val, mine = np.asarray(val), got[key].numpy()
        assert mine.shape == val.shape, key
        if key in ("o", "d"):
            np.testing.assert_allclose(mine, val, rtol=RTOL, atol=atol,
                                       err_msg=key)
        elif key in FLOAT_FIELDS:
            assert mine.dtype == np.float32
            assert mine.tobytes() == val.astype(np.float32).tobytes(), key
        else:
            assert np.array_equal(mine, val.astype(mine.dtype)), key
            assert np.array_equal(mine.astype(np.int64),
                                  val.astype(np.int64)), key


@pytest.mark.parametrize("aperture", [0.0, 2.0])
def test_service_params_from_a_host_camera(renderers, aperture):
    r = renderers[True]
    cam = _camera(aperture)
    pack = lambda c: service.service_params(persistent._Frame(
        r.scene, r.inline, r.cfg, c, 5, W, H, 2, 2, 1))
    host, moved = pack(cam), pack(cam.to("cpu"))
    assert host.floats.dtype == np.float32 and host.ints.dtype == np.int64
    assert host.floats.tobytes() == moved.floats.tobytes()
    assert host.ints.tobytes() == moved.ints.tobytes()
    assert host.lights is moved.lights is r.inline.light_rows
    assert host.metas is moved.metas is r.inline.meta_rows


def test_light_and_texture_rows_follow_refit():
    arrays = _arrays(True)
    r = Renderer(arrays, cfg=_cfg(3), device="cpu")
    n = r.scene.num_lights
    rows = lambda rr: rr.scene.trimat[rr.scene.light_indices[:n]]
    old = r.inline.light_rows
    assert n >= 1 and torch.equal(old, rows(r))
    metas = [[m["offset"], m["tiles_x"], m["w"], m["h"]]
             for m in r.inline.metas]
    assert r.inline.meta_rows.tolist() == metas
    moved = dataclasses.replace(arrays)
    shift = np.random.RandomState(2).normal(0, 0.5, 3).astype(np.float32)
    for field in ("tri_v0", "tri_v1", "tri_v2"):
        setattr(moved, field, getattr(arrays, field) + shift)
    r.refit(moved)
    assert torch.equal(r.inline.light_rows, rows(r))
    assert not torch.equal(r.inline.light_rows, old)
    fr = persistent._Frame(r.scene, r.inline, r.cfg, _camera(0.0), 1, W, H,
                           1, 1)
    assert service.service_params(fr).lights is r.inline.light_rows
    assert r.inline.meta_rows.tolist() == metas


def _refuse(self):
    raise AssertionError(f"loaded {self.name}")


def test_lane_init_cuda_refuses_before_loading(renderers, monkeypatch):
    monkeypatch.setattr(KernelLibrary, "load", _refuse)
    r = renderers[True]
    fr = persistent._Frame(r.scene, r.inline, r.cfg, _camera(0.0), 1, W, H,
                           1, 1)
    params = service.service_params(fr)
    n = W * H
    s = lane_init.new_lane_state(n, 3, True, "cpu")
    totals = torch.empty(len(service.TOTALS), dtype=torch.int64)
    rows = torch.empty((), dtype=torch.int64)
    run = lambda st=s, t=totals, rw=rows, first=0: lane_init.lane_init_cuda(
        st, r.inline, params, t, rw, first)
    before = lane_init.lane_init_cuda.launches
    with pytest.raises(ValueError, match="needs CUDA"):
        run()
    with pytest.raises(ValueError, match="'mode'"):
        run({**s, "mode": s["mode"].to(torch.int32)})
    with pytest.raises(ValueError, match="'o'"):
        run({**s, "o": s["o"][:-1]})
    with pytest.raises(ValueError, match="'d'"):
        run({**s, "d": s["d"].t().contiguous().t()})
    with pytest.raises(ValueError, match="'tstash'"):
        run({**s, "tstash": s["tstash"][:, :9].contiguous()})
    with pytest.raises(ValueError, match="skip registers 'reg_s'"):
        run({**s, "reg_s": s["reg_s"][:, :2].contiguous()})
    with pytest.raises(ValueError, match="skip registers 'reg_e'"):
        run({**s, "reg_e": s["reg_e"].to(torch.int32)})
    with pytest.raises(ValueError, match="totals"):
        run(t=totals[:3])
    with pytest.raises(ValueError, match="rows"):
        run(rw=rows.to(torch.int32))
    with pytest.raises(ValueError, match="first pixel"):
        run(first=-1)
    huge = {"mode": torch.empty(2**31, dtype=torch.int64, device="meta")}
    with pytest.raises(ValueError, match="2\\*\\*31"):
        run(huge)
    # Fields that start 4 (or 8) bytes into a larger tensor: the kernel
    # writes every field in 16-byte stores.
    with pytest.raises(ValueError, match="'d_min' is not 16-byte aligned"):
        run({**s, "d_min": torch.empty(n + 1)[1:]})
    with pytest.raises(ValueError, match="'o' is not 16-byte aligned"):
        run({**s, "o": torch.empty(3 * n + 1)[1:].view(n, 3)})
    with pytest.raises(ValueError, match="'reg_s' is not 16-byte aligned"):
        run({**s, "reg_s": torch.empty(3 * n + 1, dtype=torch.int64)[1:]
             .view(n, 3)})
    shifted_pix = torch.empty(n + 1, dtype=torch.int64)[1:]
    with pytest.raises(ValueError, match="'pix' is not 16-byte aligned"):
        run({**s, "pix": shifted_pix})
    # A pix the kernel only reads may start anywhere (here the refusal is
    # the CPU tensors).
    with pytest.raises(ValueError, match="needs CUDA"):
        run({**s, "pix": shifted_pix}, first=None)
    assert lane_init.lane_init_cuda.launches == before


def test_guarded_lane_state_layout():
    """chip_smoke.guarded_lane_state: every field new_lane_state makes,
    a poisoned view into one buffer, starting on a multiple of 512 bytes
    with at least 64 guard bytes after it; a byte written past a field
    shows in guard_bytes_changed."""
    n = 37
    s, buf, spans = chip_smoke.guarded_lane_state(n, 3, True, "cpu")
    want = lane_init.new_lane_state(n, 3, True, "cpu")
    assert list(s) == list(want) and list(spans) == list(want)
    base = buf.data_ptr()
    ends = sorted(spans.values())
    for key, t in s.items():
        lo, hi = spans[key]
        assert t.dtype == want[key].dtype and t.shape == want[key].shape
        assert t.is_contiguous() and t.data_ptr() == base + lo
        assert lo % chip_smoke.LANE_FIELD_ALIGN == 0 and lo > 0
        assert hi - lo == t.numel() * t.element_size()
        poison = (chip_smoke.LANE_POISON if t.dtype == torch.float32
                  else None)
        if poison is None:
            assert bool((t.view(torch.uint8) == 0x5A).all()), key
        else:
            assert bool((t.view(torch.int32) == poison).all()), key
    for (_, hi), (lo, _) in zip(ends, ends[1:]):
        assert lo - hi >= chip_smoke.LANE_GUARD_BYTES
    assert buf.numel() - ends[-1][1] >= chip_smoke.LANE_GUARD_BYTES
    assert chip_smoke.guard_bytes_changed(buf, spans) == 0
    s["o"].fill_(1.0)
    assert chip_smoke.guard_bytes_changed(buf, spans) == 0
    buf[spans["o"][1]] = 0
    buf[spans["mode"][0] - 1] = 1
    assert chip_smoke.guard_bytes_changed(buf, spans) == 2
    pix = torch.arange(n)
    s, buf, spans = chip_smoke.guarded_lane_state(n, 0, False, "cpu", pix)
    assert s["pix"] is pix and "pix" not in spans and "reg_e" not in s


def test_new_lane_state_has_init_lane_ctx_fields(renderers):
    for textured, regs in ((True, 3), (False, 0)):
        got = lane_init.new_lane_state(10, regs, textured, "cpu")
        want = persistent.init_lane_ctx(
            1, 1, torch.arange(10), _camera(0.0), W, H, _cfg(regs),
            with_tstash=textured)
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].shape == want[key].shape, key
            assert got[key].is_contiguous(), key
    pix = torch.arange(5, 15)
    assert lane_init.new_lane_state(10, 3, True, "cpu", pix)["pix"] is pix


@pytest.mark.parametrize("pixels", ["range", "tensor"])
def test_cpu_wave_state_and_read_unchanged(pixels, monkeypatch):
    """A CPU Wave fills its state with init_lane_ctx and never loads a
    kernel; after the compacting round loop, read() equals the plain
    wave loop (no compaction) on the same fresh state."""
    monkeypatch.setattr(KernelLibrary, "load", _refuse)
    w, h, spp = 40, 30, 2    # 1,200 lanes: the round loop compacts
    r = Renderer(_arrays(True), cfg=RenderConfig(width=w, height=h, spp=spp),
                 device="cpu")
    cam = _camera(0.0, w, h)
    px = (range(100, w * h) if pixels == "range"
          else torch.arange(100, w * h))
    wv = persistent.Wave(r.scene, r.inline, cam, 3, w, h, r.cfg, px, spp,
                         spp)
    n = w * h - 100
    want = persistent.init_lane_ctx(3, spp, torch.arange(100, w * h), cam,
                                    w, h, r.cfg, with_tstash=True)
    assert list(wv.state) == list(want)
    for key in want:
        assert torch.equal(wv.state[key], want[key]), key
    assert wv.totals.tolist() == [n, 0, 0, 0] and int(wv.rows_fetched) == 0
    fresh = {k: v.clone() for k, v in wv.state.items()}
    totals, rows = wv.totals.clone(), wv.rows_fetched.clone()
    before = lane_init.lane_init_cuda.launches
    assert wv.advance() is True
    assert wv.state["mode"].shape[0] < n  # it compacted
    out, count = wv.read()
    out2, count2 = wv.read()
    assert torch.equal(out, out2) and torch.equal(count, count2)
    ran, live = wave.wave_advance_plain(fresh, r.inline, wv._fr, totals,
                                        rows)
    assert live == 0 and ran == wv.rounds
    assert out.numpy().tobytes() == fresh["out"].numpy().tobytes()
    assert torch.equal(count, fresh["sample"])
    assert totals.tolist()[:2] == wv.totals.tolist()[:2]
    assert int(rows) == int(wv.rows_fetched)
    assert lane_init.lane_init_cuda.launches == before


# -- on a card ----------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA lane set-up kernel runs only on a CUDA device")


def _poison(s, skip=()) -> None:
    """NaN payloads in float fields, 0x5A bytes in the others."""
    for key, t in s.items():
        if key in skip:
            continue
        if t.dtype == torch.float32:
            t.view(torch.int32).fill_(0x7FC05A5A)
        else:
            t.view(torch.uint8).fill_(0x5A)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*CASES, "pixel_tensor"])
def test_cuda_kernel_matches_init_lane_ctx(name):
    _need_card()
    off, seed_spp, aperture, textured, regs, first, lanes = CASES.get(
        name, (1, 2, 0.0, True, 3, 0, None))
    w, h = 64, 48
    r = Renderer(_arrays(textured), cfg=RenderConfig(
        width=w, height=h, quad_regs=regs, quad_select="perm"),
        device="cuda")
    cam = _camera(aperture, w, h)
    px = _pixels(first, lanes, w, h)
    pix = torch.arange(px.start, px.stop, device="cuda")
    if name == "pixel_tensor":
        pix = pix.flip(0).contiguous()
    fr = persistent._Frame(r.scene, r.inline, r.cfg, cam, 9, w, h, 4,
                           seed_spp, off)
    params = service.service_params(fr)
    s = lane_init.new_lane_state(len(px), regs, textured, "cuda",
                                 pix if name == "pixel_tensor" else None)
    _poison(s, skip=("pix",) if name == "pixel_tensor" else ())
    totals = torch.full((4,), 77, dtype=torch.int64, device="cuda")
    rows = torch.full((), 77, dtype=torch.int64, device="cuda")
    lane_init.lane_init_cuda(s, r.inline, params, totals, rows,
                             None if name == "pixel_tensor" else px.start)
    want = persistent.init_lane_ctx(9, seed_spp, pix, cam, w, h, r.cfg,
                                    with_tstash=textured, sample_offset=off)
    assert list(s) == list(want)
    bad = [k for k in want if not torch.equal(_bits(s[k]), _bits(want[k]))]
    assert not bad
    assert totals.tolist() == [len(px), 0, 0, 0] and int(rows) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,first", [(1, 0), (31, 7), (255, 1000),
                                         (257, 4096), (4097, 123_456),
                                         (240_000, 240_000)])
def test_cuda_kernel_ragged_tiles_stay_inside_their_fields(lanes, first):
    """Lane counts off and on the kernel's 256-lane tiles, every field a
    view at a multiple of 512 bytes into one buffer of guard bytes:
    every field equals init_lane_ctx bit for bit, no guard byte
    changes."""
    _need_card()
    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
    r = Renderer(_arrays(True), cfg=RenderConfig(
        width=w, height=h, quad_regs=3, quad_select="perm"), device="cuda")
    cam = _camera(0.0, w, h)
    fr = persistent._Frame(r.scene, r.inline, r.cfg, cam, 4, w, h, 1, 1, 0)
    s, buf, spans = chip_smoke.guarded_lane_state(lanes, 3, True, "cuda")
    totals = torch.full((4,), 77, dtype=torch.int64, device="cuda")
    rows = torch.full((), 77, dtype=torch.int64, device="cuda")
    lane_init.lane_init_cuda(s, r.inline, service.service_params(fr), totals,
                             rows, first)
    want = persistent.init_lane_ctx(
        4, 1, torch.arange(first, first + lanes, device="cuda"), cam, w, h,
        r.cfg, with_tstash=True)
    assert list(s) == list(want)
    bad = [k for k in want if not torch.equal(_bits(s[k]), _bits(want[k]))]
    assert not bad
    assert chip_smoke.guard_bytes_changed(buf, spans) == 0
    assert totals.tolist() == [lanes, 0, 0, 0] and int(rows) == 0


@pytest.mark.cuda
def test_cuda_step_equals_the_cpu_and_launches_lane_init_once_a_wave():
    _need_card()
    w, h = 64, 48
    arrays = _arrays(True)
    cfg = RenderConfig(width=w, height=h)
    cam = _camera(0.0, w, h)
    card = Renderer(arrays, cfg=cfg, device="cuda")
    cpu = Renderer(arrays, cfg=cfg, device="cpu")
    before = lane_init.lane_init_cuda.launches
    for _ in range(2):
        card.step(cam)
        cpu.step(cam)
    assert lane_init.lane_init_cuda.launches == before + 2
    assert card.state.accum.cpu().numpy().tobytes() == \
        cpu.state.accum.numpy().tobytes()
    for key in ("n_traced", "n_shadow", "rows_fetched"):
        assert int(card.last_stats[key]) == int(cpu.last_stats[key]), key
    card.reset()
    card.step_tiled(cam, 4)
    card.step_tiled(cam, 4)
    assert lane_init.lane_init_cuda.launches == before + 10
    assert card.state.accum.cpu().numpy().tobytes() == \
        cpu.state.accum.numpy().tobytes()


@pytest.mark.cuda
def test_cuda_step_makes_no_sync_before_the_wave_kernel_read(monkeypatch):
    """From Renderer.step to the wave kernel's one read of its counters,
    nothing synchronizes with the card."""
    _need_card()
    w, h = 64, 48
    r = Renderer(_arrays(True), cfg=RenderConfig(width=w, height=h),
                 device="cuda")
    cam = _camera(0.0, w, h)
    r.step(cam)    # builds the kernels and the launch plan
    read = wave.read_counters

    def counters(ctl):
        torch.cuda.set_sync_debug_mode(0)
        return read(ctl)

    monkeypatch.setattr(wave, "read_counters", counters)
    with contextlib.ExitStack() as stack:
        stack.callback(torch.cuda.set_sync_debug_mode, 0)
        torch.cuda.set_sync_debug_mode("error")
        r.step(cam)
    r.block_until_ready()
    assert r.spp() == 2
