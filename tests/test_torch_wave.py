"""The persistent engine's wave loop on the card (ops/wave.py).

  - its plain version, ``wave_advance_plain`` (rounds of ``walk_plain``
    and ``service_plain`` over every lane, no compaction), against the
    engine's CPU round loop (``Wave.advance``, which compacts): sums,
    completed samples, the four totals, rows and rounds, equal bit for
    bit, on three small scenes: the default Baldwin-Weber leaves with a
    texture; "mt" leaves, smooth normals and a textured UV sphere; 17
    lights;
  - budgets of 1, 3 and 8 rounds, advanced in calls, equal one call;
    each call runs at most its budget, and the calls' rounds add up;
  - the most rounds a lane ran equals ``Wave.rounds``;
  - lanes advanced apart equal the wave advanced at once: disjoint
    subsets of a wave's lanes, each run by the plain version at budgets
    of 1, 3, 8 rounds and none, give every field of the whole wave, its
    path and shadow rays and rows summed and its rounds as the most of
    theirs (the rule that lets the kernel run a sparse tail's lanes by
    warps on their own rounds);
  - the dispatch: a ``Wave`` on the CPU runs the round loop and never
    loads the wave kernel; the wrapper refuses CPU tensors and bad
    budgets before it loads any library;
  - the kernel library's name changes with an edit to a device-code
    header (ops/_build.py);
  - on a card (``cuda``-marked, skipped elsewhere): the kernel against
    the plain version and the two-kernel round loop, also on a wave
    with most lanes DONE in calls that end at and inside the switch to
    the kernel's sparse tail; one launch per ``Wave.advance``
    with work and none of the walk or service kernels, and the
    wrapper's refusals.

Tolerance: 0.  The plain version and the round loop run the same eager
code on the same lanes in another order; the kernel against the plain
version is compared as numbers (-0.0 == 0.0, NaN == NaN; ops/walk.py),
against the two-kernel round loop bit for bit.  No JAX program is
compiled here.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine import persistent
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.ops import _build, service, walk, wave
from tryraytrace_tpu_torch.ops._build import KernelLibrary

torch.set_num_threads(1)

W, H = 24, 16          # 384 lanes
SPP, FRAME = 2, 3
COMPACT_WIDTH = 64     # the round loop compacts waves wider than this here
# name -> (scene, config fields): chip_smoke.py's small scenes.
SCENES = {
    "bw": (None, {}),
    "mt_smooth_textured": ("smooth", dict(smooth_shading=True,
                                          leaf_isect="mt")),
    "17_lights": ("lights", {}),
}
# The walk kernel leaves the skip registers in the thread.
NOT_WRITTEN = ("reg_e", "reg_s")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA wave kernel runs only on a CUDA device")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("scenes"))
    out = {}
    for name, (kind, knobs) in SCENES.items():
        arrays = (chip_smoke.cube256_arrays() if kind is None
                  else chip_smoke._feature_scene(tmp, kind)[0])
        out[name] = (arrays, RenderConfig(width=W, height=H, spp=SPP,
                                          **knobs))
    return out


def _wave(arrays, cfg, device="cpu", round_fn=None):
    w, h = cfg.width, cfg.height
    r = Renderer(arrays, cfg=cfg, device=device)
    cam = CameraController().get_params(w, h)
    return persistent.Wave(r.scene, r.inline, cam, FRAME, w, h, cfg,
                           torch.arange(w * h, device=device), SPP, SPP,
                           round_fn)


def _plain(wv, budgets, lane_rounds=None):
    """Advance a copy of ``wv``'s fresh state with wave_advance_plain, in
    calls of ``budgets``; returns (state, totals, rows, rounds of each
    call, lanes live after each call)."""
    s = {key: val.clone() for key, val in wv.state.items()}
    totals, rows = wv.totals.clone(), wv.rows_fetched.clone()
    ran, lives, done = [], [], 0
    for budget in budgets:
        n, live = wave.wave_advance_plain(
            s, wv._fr.inline, wv._fr, totals, rows, budget,
            rounds_before=done, lane_rounds=lane_rounds)
        done += n
        ran.append(n)
        lives.append(live)
    return s, totals, rows, ran, lives


@pytest.fixture(scope="module")
def round_loops(scenes):
    """Each scene's wave run to its end by the CPU round loop (with
    compaction) and by the plain version (state, totals, rows, rounds,
    each lane's rounds)."""
    out = {}
    saved = persistent.MIN_COMPACT_WIDTH
    persistent.MIN_COMPACT_WIDTH = COMPACT_WIDTH
    try:
        for name, (arrays, cfg) in scenes.items():
            loop = _wave(arrays, cfg)
            fresh = _wave(arrays, cfg)
            loop.advance()
            lane_rounds = torch.zeros(W * H, dtype=torch.int64)
            plain = _plain(fresh, [None], lane_rounds)
            out[name] = (loop, fresh, plain, lane_rounds)
    finally:
        persistent.MIN_COMPACT_WIDTH = saved
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_equals_the_round_loop_with_compaction(name, round_loops):
    loop, _, (s, totals, rows, ran, lives), _ = round_loops[name]
    assert loop.state["mode"].shape[0] < W * H  # the round loop compacted
    sums, samples = loop.read()
    assert torch.equal(s["out"].view(torch.int32), sums.view(torch.int32))
    assert torch.equal(s["sample"], samples)
    assert (samples == SPP).all() and float(sums.sum()) > 0
    assert totals.tolist() == loop.totals.tolist()
    assert totals[service.LIVE:].tolist() == [0, 0]
    assert int(rows) == int(loop.rows_fetched)
    assert ran == [loop.rounds] and lives == [0]
    assert loop.rounds > 8


@pytest.mark.parametrize("name", list(SCENES))
def test_most_rounds_of_a_lane_are_the_waves_rounds(name, round_loops):
    loop, _, _, lane_rounds = round_loops[name]
    assert int(lane_rounds.max()) == loop.rounds
    assert int(lane_rounds.min()) >= 1
    # Lanes differ: the wave's rounds are set by its longest lanes.
    assert int(lane_rounds.min()) < loop.rounds


@pytest.mark.parametrize("budget", [1, 3, 8, None])
def test_lanes_advanced_apart_equal_the_wave_advanced_at_once(budget,
                                                              round_loops):
    _, fresh, _, _ = round_loops["bw"]
    want, want_totals, want_rows, want_ran, want_live = _plain(fresh,
                                                               [budget])
    # Three disjoint subsets of the lanes, in a seed-made order.
    order = torch.from_numpy(np.random.RandomState(7).permutation(W * H))
    got = {key: torch.empty_like(val) for key, val in fresh.state.items()}
    totals = fresh.totals.clone()
    rows, ran, live = fresh.rows_fetched.clone(), [], 0
    for lanes in (order[:50], order[50:200], order[200:]):
        s = {key: val[lanes].clone() for key, val in fresh.state.items()}
        t = torch.zeros_like(totals)
        n, left = wave.wave_advance_plain(s, fresh._fr.inline, fresh._fr, t,
                                          rows, budget)
        for key in s:
            got[key][lanes] = s[key]
        totals[:service.LIVE] += t[:service.LIVE]
        ran.append(n)
        live += left
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert totals[:service.LIVE].tolist() == \
        want_totals[:service.LIVE].tolist()
    assert int(rows) == int(want_rows)
    assert max(ran) == want_ran[0] and [live] == want_live
    assert budget is None or max(ran) == budget


@pytest.mark.parametrize("budget", [1, 3, 8])
def test_budgets_in_calls_equal_one_call(budget, round_loops):
    _, fresh, (want, want_totals, want_rows, want_ran, _), _ = \
        round_loops["bw"]
    calls = -(-want_ran[0] // budget)
    s, totals, rows, ran, lives = _plain(fresh, [budget] * calls)
    assert sum(ran) == want_ran[0]
    assert ran == [min(budget, want_ran[0] - budget * i)
                   for i in range(calls)]
    assert lives[-1] == 0 and all(n > 0 for n in lives[:-1])
    for key in want:
        assert torch.equal(s[key], want[key]), key
    assert totals.tolist() == want_totals.tolist()
    assert int(rows) == int(want_rows)


def test_a_call_leaves_the_live_count_in_its_last_rounds_slot(round_loops):
    _, fresh, _, _ = round_loops["bw"]
    s, totals, _, ran, lives = _plain(fresh, [3, 2])
    # Rounds 0-2, then 3-4: the last round, 4, is even.
    assert ran == [3, 2] and lives[1] > 0
    assert totals[service.LIVE:].tolist() == [lives[1], 0]
    assert lives[1] == int((s["mode"] != walk.DONE).sum())


def test_a_wave_on_the_cpu_never_loads_the_wave_kernel(monkeypatch, scenes):
    def refuse(self):
        raise AssertionError(f"{self.name} kernel loaded on the CPU")

    monkeypatch.setattr(KernelLibrary, "load", refuse)
    arrays, cfg = scenes["bw"]
    wv = _wave(arrays, cfg)
    before = wave.wave_advance_cuda.launches
    assert wv.advance(2) is False and wv.rounds == 2
    assert wave.wave_advance_cuda.launches == before
    fr = wv._fr
    params = service.service_params(fr)
    run = lambda **kw: wave.wave_advance_cuda(
        wv.state, fr.inline, params, wv.totals, wv.rows_fetched,
        k=fr.scene.leaf_size, fmt=fr.scene.leaf_fmt, **kw)
    with pytest.raises(ValueError, match="needs CUDA"):
        run()
    with pytest.raises(ValueError, match="max_rounds"):
        run(max_rounds=0)
    with pytest.raises(ValueError, match="rounds_before"):
        run(rounds_before=-1)


def test_a_header_edit_changes_the_library_path(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "k_device.cuh"\n')
    header = src / "k_device.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    lib = KernelLibrary("k", {})
    assert lib.source == str(src / "k.cu")
    before = lib._target()
    assert lib._target() == before
    header.write_text("// two\n")
    assert lib._target() != before
    # The port's own libraries hash its headers too.
    monkeypatch.undo()
    assert {os.path.basename(p) for p in _build.headers()} >= {
        "quad_walk_device.cuh", "service_device.cuh"}


# -- on a card ---------------------------------------------------------------

def _same(a, b):
    eq = a == b
    if a.is_floating_point():
        eq = eq | (a.isnan() & b.isnan())
    return bool(eq.all())


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_cuda_kernel_matches_plain_version_and_round_loop(name, scenes):
    """The kernel, in calls of 1, 3 and 8 rounds and then to the end,
    against the plain version (as numbers) and the two-kernel round loop
    without compaction (bit for bit) on the card."""
    _need_card()
    arrays, cfg = scenes[name]
    kern = _wave(arrays, cfg, "cuda")
    loop = _wave(arrays, cfg, "cuda", persistent._round_quad)
    plain = {key: val.clone() for key, val in kern.state.items()}
    totals, rows = kern.totals.clone(), kern.rows_fetched.clone()
    fr = kern._fr
    saved = persistent.MIN_COMPACT_WIDTH
    persistent.MIN_COMPACT_WIDTH = W * H  # the round loop keeps every lane
    try:
        for budget in (1, 3, 8, None):
            before = wave.wave_advance_cuda.launches
            n0 = kern.rounds
            kern.advance(budget)
            assert wave.wave_advance_cuda.launches == before + 1
            loop.advance(budget)
            ran, live = wave.wave_advance_plain(
                plain, fr.inline, fr, totals, rows, budget, rounds_before=n0)
            assert kern.rounds - n0 == ran == loop.rounds - n0 > 0
            assert kern.totals.tolist() == totals.tolist()
            assert kern.totals.tolist() == loop.totals.tolist()
            assert int(kern.rows_fetched) == int(rows)
            assert int(loop.rows_fetched) == int(rows)
            for key in kern.state:
                assert torch.equal(_bits(kern.state[key]),
                                   _bits(loop.state[key])), key
                if key not in NOT_WRITTEN:
                    assert _same(kern.state[key], plain[key]), key
            assert kern.done == (live == 0)
    finally:
        persistent.MIN_COMPACT_WIDTH = saved
    assert kern.done and loop.done


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_cuda_kernel_matches_round_loop_in_the_sparse_tail(name, scenes):
    """A wave wider than the card's grid (81,920 lanes: the tail starts
    only once a round leaves at most TRT_WAVE_TAIL_WARP_LANES live lanes
    a warp of the grid), most of whose lanes end in its early rounds: a
    call of two rounds and calls of one until the live lanes fit the
    tail (calls that end before the kernel's switch to its sparse tail),
    then calls of one round (a call's first round is grid-wide, over
    every lane: it ends at the switch), of two and five (inside the tail)
    and to the end, against the plain version and the two-kernel round
    loop."""
    _need_card()
    arrays, cfg = scenes[name]
    cfg = cfg.with_size(320, 256)
    kern = _wave(arrays, cfg, "cuda")
    loop = _wave(arrays, cfg, "cuda", persistent._round_quad)
    plain = {key: val.clone() for key, val in kern.state.items()}
    totals, rows = kern.totals.clone(), kern.rows_fetched.clone()
    fr = kern._fr

    def call(budget):
        n0 = kern.rounds
        kern.advance(budget)
        loop.advance(budget)
        ran, live = wave.wave_advance_plain(
            plain, fr.inline, fr, totals, rows, budget, rounds_before=n0)
        assert kern.rounds - n0 == ran == loop.rounds - n0 > 0
        assert kern.totals.tolist() == totals.tolist()
        assert kern.totals.tolist() == loop.totals.tolist()
        assert int(kern.rows_fetched) == int(rows)
        assert int(loop.rows_fetched) == int(rows)
        for key in kern.state:
            assert torch.equal(_bits(kern.state[key]),
                               _bits(loop.state[key])), key
            if key not in NOT_WRITTEN:
                assert _same(kern.state[key], plain[key]), key
        assert kern.done == (live == 0)
        return live

    saved = persistent.MIN_COMPACT_WIDTH
    persistent.MIN_COMPACT_WIDTH = cfg.width * cfg.height  # keep every lane
    try:
        live = call(2)
        tail_lanes = wave.wave_advance_cuda.plan["tail_lanes"]
        assert live > tail_lanes > 0
        while live > tail_lanes:
            live = call(1)
        for budget in (1, 2, 5, None):
            if live:
                live = call(budget)
    finally:
        persistent.MIN_COMPACT_WIDTH = saved
    assert live == 0 and kern.done and loop.done


@pytest.mark.cuda
def test_cuda_a_step_is_one_launch_of_the_wave_kernel(scenes):
    _need_card()
    arrays, cfg = scenes["bw"]
    r = Renderer(arrays, cfg=cfg)
    counted = (wave.wave_advance_cuda, walk.quad_walk_cuda,
               service.service_pass_cuda)
    before = [f.launches for f in counted]
    r.step(CameraController().get_params(W, H))
    assert [f.launches - b for f, b in zip(counted, before)] == [1, 0, 0]
    assert r.last_stats["iterations"] > 1


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_cannot_take(scenes):
    _need_card()
    arrays, cfg = scenes["bw"]
    wv = _wave(arrays, cfg, "cuda")
    fr = wv._fr
    params = service.service_params(fr)
    s = wv.state
    run = lambda st=s, rows=wv.rows_fetched, **kw: wave.wave_advance_cuda(
        st, fr.inline, params, wv.totals, rows, 1, k=fr.scene.leaf_size,
        fmt=fr.scene.leaf_fmt, **kw)
    with pytest.raises(ValueError, match="'mode'"):
        run({**s, "mode": s["mode"].to(torch.int32)})
    with pytest.raises(ValueError, match="'o'"):
        run({**s, "o": s["o"][:-1]})
    with pytest.raises(ValueError, match="'d'"):
        run({**s, "d": s["d"].t().contiguous().t()})
    with pytest.raises(ValueError, match="skip registers"):
        run({**s, "reg_e": s["reg_e"][:, :2].contiguous()})
    with pytest.raises(ValueError, match="rows"):
        run(rows=torch.zeros(2, dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError, match="cannot hold"):
        wave.wave_advance_cuda(s, fr.inline, params, wv.totals,
                               wv.rows_fetched, 1, k=fr.scene.leaf_size + 9,
                               fmt=fr.scene.leaf_fmt)
    assert wv.rounds == 0
