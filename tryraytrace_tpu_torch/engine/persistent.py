"""Persistent-wave path tracer with path regeneration.

The counterpart of tryraytrace_tpu/engine/persistent.py on its default
path: owner schedule (one lane per pixel renders that pixel's samples
in order), quad traversal, inline shading and inline texturing.  Each
lane runs the JAX engine's state machine

  TRAVERSE --(closest hit found)--> SHADEG --(shade)-->
      SHADOW (diffuse, NEE) -> TRAVERSE      (path continues)
    | TRAVERSE                               (spec/refr continue)
    | TEXG (textured hit: fetch the texture tile row, then shade)
    | REFILL --(next sample's camera ray)--> TRAVERSE | DONE

and every step fetches ONE row per lane from the unified table
(quad rows, then trimat rows, then texture tile rows): a tree row for
a walking lane, its hit's material row for a SHADEG lane, its texture
tile row for a TEXG lane.

``render_frame_persistent`` runs it in rounds: in a round, every
TRAVERSE and SHADOW lane's walk runs to its end, then one service pass
serves every SHADEG, TEXG and REFILL lane once (a row fetch, shade,
texture, refill).  Rounds repeat until every lane is DONE.  The loop is
a ``Wave``: its lane state lives across calls, it advances by a given
number of rounds and is read without being consumed, so the progressive
engine (engine/progressive.py) and tiled steps (a wave over a pixel
subset) run the same code as a batch frame.  On a card a
``Wave.advance`` is one launch of a hand-written kernel
(ops/wave.py ``wave_advance_cuda``: the call's rounds, each the walks,
a grid-wide barrier and the services, over the lanes still live), and
the host reads the rounds run and the live count at its end; the
wave's fresh state is one launch of another (ops/lane_init.py
``lane_init_cuda``), with nothing copied to the card or read back
before the wave kernel's launch.  On the CPU it is the round loop: one
call of ``quad_walk`` (ops/walk.py; ``walk_plain``) runs every walk to
its end, then ``service_plain``, the eager service block of this
module, serves every lane; ``_round_quad`` is that round, which on a
card launches the walk and service kernels (ops/walk.py,
ops/service.py), a route the tests and the smoke run take by passing it
as ``round_fn``.

``render_frame_interleaved`` is the plain version of the whole: a Python
``while`` over eager tensor steps, each of which advances every walking
lane by one row (ops/walk.py ``walk_step``) and runs the eager service
block on the same row fetch, as the JAX engine does once per unrolled
body.  Nothing but the tests and the smoke run calls it.  It gives every
lane the same state as the round loop, so the same per-pixel sums, ray
counts and row counts: a lane's draws are addressed by (sample seed,
pixel, depth, slot) and a walk draws nothing, so when a lane is
serviced cannot change what it draws.

Two further liberties are exact too: the interleaved loop checks for a
live lane every ``LIVE_CHECK_EVERY`` steps (a DONE lane's step changes
nothing), and once at most half the lanes are live both loops keep only
the live ones (a lane permutation, the eager counterpart of the JAX
spill ladder).  The card's wave kernel keeps the state in place and
lists the live lanes on the device each round instead.

The ray counters are int64.  A wave keeps them, with the live-lane
count of its last round, in one device tensor (ops/service.py
``TOTALS``) that every round adds to where it runs: on a card the wave
kernel (or the service kernel) does, so nothing is launched for the
counts.
"""

from __future__ import annotations

import dataclasses

import torch

from tryraytrace_tpu_torch.accel.bvh import walk_order_table
from tryraytrace_tpu_torch.config import RenderConfig, check_supported
from tryraytrace_tpu_torch.core import rng, vec
from tryraytrace_tpu_torch.engine.camera_rays import generate_rays
from tryraytrace_tpu_torch.engine.wavefront import _sanitize
from tryraytrace_tpu_torch.ops import shade
from tryraytrace_tpu_torch.ops.lane_init import lane_init_cuda, new_lane_state
from tryraytrace_tpu_torch.ops.service import (LIVE, TOTALS, service_params,
                                               service_pass_cuda)
from tryraytrace_tpu_torch.ops.texture import (TEX_ROW, TEX_TILE,
                                               build_texture_tiles,
                                               tile_bilinear, tile_coords)
from tryraytrace_tpu_torch.ops.traverse import MISS_T
from tryraytrace_tpu_torch.ops.walk import (DONE, REFILL, SHADEG, SHADOW,
                                            TEXG, TRAVERSE, quad_walk,
                                            walk_index, walk_step)
from tryraytrace_tpu_torch.ops.wave import wave_advance_cuda

# Steps between checks for a live lane (each check waits for the
# device); DONE lanes are no-ops, so overshooting is exact.
LIVE_CHECK_EVERY = 8
# Narrowest wave the loop compacts to; below it a step costs the same
# at any width.
MIN_COMPACT_WIDTH = 1024


@dataclasses.dataclass
class InlineTable:
    """The unified gather table and its layout (build_inline_table)."""

    table: torch.Tensor   # [quad rows; packed trimat rows; tile rows]
    sentinel: int         # quad rows (the walk's done sentinel)
    pack: int             # trimat rows per table row (1 or 2)
    tex0: int | None      # first texture tile row, None without textures
    metas: list           # per-texture tile layout (build_texture_tiles)
    walk: torch.Tensor    # the quad rows in walk order (walk_order_table)
    walk_levels: tuple    # rows per tree level of ``walk``
    # What the service and wave kernels read besides the table
    # (ops/service.py ServiceParams), built once per table: the lights'
    # trimat rows [max(lights, 1), 37] f32 and the texture layout
    # [max(textures, 1), 4] int64 (offset, tiles_x, w, h).
    light_rows: torch.Tensor
    meta_rows: torch.Tensor


def build_inline_table(scene, textures) -> InlineTable:
    """Assemble the unified gather table in the JAX package's layout and
    row ids: quad rows first (traversal ids and the done sentinel are
    unchanged), then the trimat rows packed two per row when the quad
    width is at least 74, then the texture tile rows.

    The JAX engine leaves the tile rows out when they pass its 2 MB
    gather budget and then shades textured hits on its tick path; the
    port has no tick path and always appends them, which gives the
    same image.

    The round loop's walks read a second copy of the quad rows, in
    breadth-first order with 16-byte rows (accel/bvh.py
    ``walk_order_table``); the service fetches and the interleaved loop
    read the unified table.  The lights' trimat rows and the texture
    layout, which the kernels' parameters point at, are built here too,
    once per table (``Renderer.refit`` builds a new table)."""
    table = scene.quad_table
    nw = table.shape[1]
    pack = 2 if nw >= 74 else 1
    tex_on = bool(textures)
    wu = max(nw, 37 * pack, TEX_ROW if tex_on else 0)
    tm = scene.trimat
    if pack == 2 and tm.shape[0] % 2:
        tm = torch.nn.functional.pad(tm, (0, 0, 0, 1))
    packed = tm.reshape(-1, 37 * pack)
    pad = torch.nn.functional.pad
    parts = [pad(table, (0, wu - nw)), pad(packed, (0, wu - 37 * pack))]
    sentinel = int(table.shape[0])
    tex0, metas = None, []
    if tex_on:
        rows, metas, _ = build_texture_tiles(textures)
        rows = torch.as_tensor(rows, device=table.device)
        parts.append(pad(rows, (0, wu - TEX_ROW)))
        tex0 = sentinel + int(packed.shape[0])
    walk, levels = walk_order_table(table.cpu().numpy(), scene.leaf_size,
                                    scene.leaf_fmt)
    dev = table.device
    n_lights = int(scene.num_lights)
    if n_lights:
        lights = scene.trimat[scene.light_indices[:n_lights]].contiguous()
    else:
        lights = torch.zeros((1, scene.trimat.shape[1]), device=dev)
    meta_rows = torch.tensor(
        [[m["offset"], m["tiles_x"], m["w"], m["h"]] for m in metas]
        or [[0, 0, 0, 0]], dtype=torch.int64, device=dev)
    return InlineTable(torch.cat(parts, 0), sentinel, pack, tex0, metas,
                       torch.as_tensor(walk, device=dev), tuple(levels),
                       lights, meta_rows)


@dataclasses.dataclass
class _Frame:
    """Per-frame constants the service block reads."""

    scene: object
    inline: InlineTable
    cfg: RenderConfig
    cam: object  # CameraParams: host arrays, or tensors for plain rounds
    frame_seed: int
    width: int
    height: int
    spp_cap: int   # a lane retires once its pixel has this many samples
    seed_spp: int  # the spp of the seed schedule (core/rng.py sample_seed)
    sample_offset: int = 0  # the seed schedule's number of sample 0
    service: object = None  # the service kernel's ServiceParams, packed once


def init_lane_ctx(frame_seed: int, seed_spp: int, pix0, cam, width: int,
                  height: int, cfg: RenderConfig, with_tstash: bool,
                  sample_offset: int = 0) -> dict:
    """Fresh per-lane wave state: lane i renders pixel ``pix0[i]``,
    starting with its sample 0, whose seed is
    ``sample_seed(frame_seed, seed_spp, sample_offset)``.

    The plain version of the lane set-up kernel (ops/lane_init.py
    ``lane_init_cuda``): a ``Wave`` on the CPU, or given a ``round_fn``,
    fills its state here; a ``Wave`` on a card launches the kernel."""
    w = int(pix0.shape[0])
    dev = pix0.device
    f3 = lambda: torch.zeros((w, 3), device=dev)
    sample0 = torch.zeros((w,), dtype=torch.int64, device=dev)
    seed0 = rng.sample_seed(frame_seed, seed_spp,
                            sample0 + sample_offset if sample_offset
                            else sample0)
    r_o, r_d = generate_rays(cam, width, height, seed0, pix0)
    st = {}
    if cfg.quad_regs > 0:
        st["reg_e"] = torch.full((w, cfg.quad_regs), -1, dtype=torch.int64,
                                 device=dev)
        st["reg_s"] = st["reg_e"].clone()
    if with_tstash:
        # TEXG material stash (albedo, metallic, roughness, ior,
        # transmission, fx, fy, front-face bit).
        st["tstash"] = torch.zeros((w, 10), device=dev)
    st.update(
        mode=torch.full((w,), TRAVERSE, dtype=torch.int64, device=dev),
        cur=torch.zeros((w,), dtype=torch.int64, device=dev),
        d_min=torch.full((w,), MISS_T, device=dev),
        hit_id=torch.full((w,), -1, dtype=torch.int64, device=dev),
        o=r_o, d=r_d,
        tp=torch.ones((w, 3), device=dev),
        rad=f3(),                 # current sample's radiance
        sample=sample0,           # the pixel's samples completed so far
        seed=seed0,
        pix=pix0,
        depth=torch.zeros((w,), dtype=torch.int64, device=dev),
        prev_spec=torch.ones((w,), dtype=torch.bool, device=dev),
        so=f3(), sd=f3(),
        smax=torch.zeros((w,), device=dev),
        pend=f3(),
        cont_after_shadow=torch.zeros((w,), dtype=torch.bool, device=dev),
        out=f3(),                 # the pixel's radiance sum
    )
    return st


def render_frame_persistent(scene, inline: InlineTable, cam, frame_seed: int,
                            width: int, height: int, cfg: RenderConfig,
                            spp: int, pixels=None, sample_offset: int = 0,
                            seed_spp: int | None = None):
    """All ``spp`` samples of one frame in one regenerating wave on the
    scene's device, one lane per pixel, in rounds: every walk run to its
    end, then one service pass (on a CUDA device, all of them in one
    launch of the wave kernel).
    ``inline`` is the scene's ``build_inline_table``; ``cam`` a
    CameraParams (NumPy or tensors); ``pixels`` the pixel ids to render:
    a ``range`` of step 1 or an int64 tensor on the scene's device (all
    ``width * height`` by default).  The samples are numbers
    ``sample_offset + s``, s in [0, spp), of the seed schedule with
    ``seed_spp`` (default ``spp``): a sample-parallel shard's slice of
    the frame's sample set.

    Returns (radiance sum [len(pixels), 3] in the order of ``pixels``,
    stats) with stats ``n_traced`` and ``n_shadow`` (int64 tensors: path
    rays started, camera rays included, and NEE shadow rays fired),
    ``iterations`` (rounds) and ``rows_fetched`` (int64 tensor: quad
    rows the walks fetched)."""
    return _render_frame(scene, inline, cam, frame_seed, width, height, cfg,
                         spp, pixels, None, 1, sample_offset,
                         spp if seed_spp is None else seed_spp)


def render_frame_interleaved(scene, inline: InlineTable, cam, frame_seed: int,
                             width: int, height: int, cfg: RenderConfig,
                             spp: int):
    """The plain version of ``render_frame_persistent`` over every
    pixel: one row per walking lane per step, the service block in
    every step.  Same result; ``iterations`` counts steps."""
    return _render_frame(scene, inline, cam, frame_seed, width, height, cfg,
                         spp, None, _step_quad, LIVE_CHECK_EVERY, 0, spp)


def _render_frame(scene, inline: InlineTable, cam, frame_seed: int,
                  width: int, height: int, cfg: RenderConfig, spp: int,
                  pixels, round_fn, check_every: int, sample_offset: int,
                  seed_spp: int):
    """One wave over ``pixels`` run until every lane is DONE."""
    if pixels is None:
        pixels = range(width * height)
    wave = Wave(scene, inline, cam, frame_seed, width, height, cfg, pixels,
                spp, seed_spp, round_fn, check_every, sample_offset)
    wave.advance()
    return wave.read()[0], wave.stats()


class Wave:
    """A regenerating wave that lives across calls: lane i renders the
    samples of pixel ``pixels[i]`` in order (seeds
    ``sample_seed(frame_seed, seed_spp, sample_offset + sample)``) and
    retires once the pixel has ``spp_cap`` of them.  ``pixels`` is a
    ``range`` of step 1 or an int64 tensor of pixel ids; ``cam`` a
    CameraParams of host arrays (or of tensors, which are read back).

    On a card, by default, the fresh state is one launch of the lane
    set-up kernel (ops/lane_init.py ``lane_init_cuda``) into state
    allocated unfilled, with the kernels' parameters packed on the host
    from ``cam`` (ops/service.py ``service_params``): the camera is not
    copied to the card, and nothing is read back before the wave
    kernel's launch.  ``advance`` is one launch of the wave kernel
    (ops/wave.py ``wave_advance_cuda``), which runs the rounds in place
    and adds their rays to ``totals`` (ops/service.py ``TOTALS``) and
    their rows to ``rows_fetched``; the host reads the rounds run and
    the live count, and the state keeps every lane in its place.  A
    failed build or launch raises.  Otherwise (on the CPU, or given a
    ``round_fn``) ``init_lane_ctx`` fills the state on the device, with
    the camera moved there for the plain rounds' camera rays, and
    ``advance`` runs rounds of ``round_fn``
    (``_round_quad``, the CPU's default: the walks, then a service pass,
    a kernel launch each on a card; or ``_step_quad``, the interleaved
    loop's step), looking for a live lane every ``check_every`` of them;
    once at most half the lanes are live and the wave is wider than
    ``MIN_COMPACT_WIDTH`` it keeps only the live ones and holds the
    retired lanes' sums and counts itself.  A round leaves its live-lane
    count in the totals' slot of its parity, which is all the host reads
    of it.  ``read`` gives the per-pixel sums and completed-sample
    counts and leaves the wave as it was, so a wave advanced in several
    calls ends where one call takes it."""

    def __init__(self, scene, inline: InlineTable, cam, frame_seed: int,
                 width: int, height: int, cfg: RenderConfig, pixels,
                 spp_cap: int, seed_spp: int, round_fn=None,
                 check_every: int = 1, sample_offset: int = 0):
        check_supported(cfg)
        dev = scene.quad_table.device
        frame_seed = int(frame_seed) & rng.MASK32
        # None: the wave kernel, one launch an advance (the card's default).
        self._round = (round_fn if round_fn is not None
                       else _round_quad if dev.type == "cpu" else None)
        if self._round is not None:
            cam = cam.to(dev)
        self._check_every = check_every
        self._fr = _Frame(scene, inline, cfg, cam, frame_seed, width, height,
                          int(spp_cap), int(seed_spp), int(sample_offset))
        ranged = isinstance(pixels, range)
        if ranged and pixels.step != 1:
            raise ValueError(f"pixels {pixels} is not a range of step 1")
        n = len(pixels) if ranged else int(pixels.shape[0])
        self.rounds = 0
        self.done = n == 0
        textured = inline.tex0 is not None
        if self._round is None:
            # The lane set-up kernel writes the state, the totals
            # ([n, 0, 0, 0]) and the rows (0); nothing compacts here.
            self._fr.service = service_params(self._fr)
            self.totals = torch.empty(len(TOTALS), dtype=torch.int64,
                                      device=dev)
            self.rows_fetched = torch.empty((), dtype=torch.int64, device=dev)
            self.state = new_lane_state(n, cfg.quad_regs, textured, dev,
                                        None if ranged else pixels)
            lane_init_cuda(self.state, inline, self._fr.service, self.totals,
                           self.rows_fetched,
                           pixels.start if ranged else None)
            self._pos = self._out = self._count = None
            return
        if ranged:
            pixels = torch.arange(pixels.start, pixels.stop, device=dev)
        self.totals = torch.tensor([n] + [0] * (len(TOTALS) - 1),
                                   dtype=torch.int64, device=dev)
        self.rows_fetched = torch.zeros((), dtype=torch.int64, device=dev)
        self.state = init_lane_ctx(frame_seed, seed_spp, pixels, cam, width,
                                   height, cfg, with_tstash=textured,
                                   sample_offset=int(sample_offset))
        self._pos = torch.arange(n, device=dev)  # lane -> place in pixels
        # Sums and counts of the lanes retired by compaction, by place.
        self._out = torch.zeros((n, 3), device=dev)
        self._count = torch.zeros((n,), dtype=torch.int64, device=dev)

    def advance(self, max_rounds: int | None = None) -> bool:
        """Run rounds until every lane is DONE, or at most ``max_rounds``
        of them.  Returns whether every lane is DONE."""
        fr = self._fr
        passes = max(1, fr.cfg.quad_redirect_passes)
        if self._round is None:
            if self.done or (max_rounds is not None and max_rounds < 1):
                return self.done
            ran, live = wave_advance_cuda(
                self.state, fr.inline, fr.service, self.totals,
                self.rows_fetched, max_rounds, k=fr.scene.leaf_size,
                fmt=fr.scene.leaf_fmt, passes=passes,
                rounds_before=self.rounds)
            self.rounds += ran
            self.done = live == 0
            return self.done
        ran = 0
        while not self.done and (max_rounds is None or ran < max_rounds):
            slot = self.rounds % 2
            s, rows = self._round(self.state, fr.inline, fr.scene.leaf_size,
                                  fr, passes, self.totals, slot)
            self.state = s
            self.rows_fetched = self.rows_fetched + rows
            self.rounds += 1
            ran += 1
            if self.rounds % self._check_every:
                continue
            n_live = int(self.totals[LIVE + slot])
            w = int(s["mode"].shape[0])
            if n_live == 0:
                self.done = True
            elif n_live <= w // 2 and w > MIN_COMPACT_WIDTH:
                # Retire the DONE lanes: their sums are final.
                live = s["mode"] != DONE
                gone = ~live
                self._out[self._pos[gone]] = s["out"][gone]
                self._count[self._pos[gone]] = s["sample"][gone]
                keep = live.nonzero()[:, 0]
                self.state = {key: val[keep] for key, val in s.items()}
                self._pos = self._pos[keep]
        return self.done

    def read(self):
        """(radiance sums [n, 3], completed samples [n] int64) of the
        wave's pixels, in the order of ``pixels``; the wave is left as
        it was."""
        if self._pos is None:  # the wave kernel keeps every lane in place
            return self.state["out"].clone(), self.state["sample"].clone()
        out = self._out.clone()
        out[self._pos] = self.state["out"]
        count = self._count.clone()
        count[self._pos] = self.state["sample"]
        return out, count

    @property
    def n_traced(self) -> torch.Tensor:
        """Path rays started so far, camera rays included (int64)."""
        return self.totals[0].clone()

    @property
    def n_shadow(self) -> torch.Tensor:
        """Shadow rays fired so far (int64)."""
        return self.totals[1].clone()

    def stats(self) -> dict:
        """Rays and rows so far (int64 tensors, copies: the wave kernel
        adds to the wave's own) and rounds run."""
        return dict(n_traced=self.n_traced, n_shadow=self.n_shadow,
                    iterations=self.rounds,
                    rows_fetched=self.rows_fetched.clone())


def _step_quad(s, inline: InlineTable, k: int, fr: _Frame,
               redirect_passes: int, totals, slot: int):
    """One step of the interleaved loop: one quad-row step for TRAVERSE
    and SHADOW lanes plus the service block for SHADEG, TEXG and REFILL
    lanes, sharing one row fetch; its rays and live lanes go to
    ``totals`` as a round's do.  Returns (state', quad rows fetched)."""
    idx, stepping = walk_index(s, inline.sentinel)
    idx, live_g, live_x = _service_select(s, idx, inline)
    row = inline.table[idx]
    out = walk_step(s, row, inline.sentinel, k, redirect_passes,
                    fmt=fr.scene.leaf_fmt)
    out, cont, sh, start = _service_shade(out, s, row, live_g, live_x, fr)
    _add_totals(totals, slot, cont + start, sh, out["mode"])
    return out, stepping.sum()


def _round_quad(s, inline: InlineTable, k: int, fr: _Frame,
                redirect_passes: int, totals, slot: int):
    """One round of the round loop: every TRAVERSE and SHADOW lane's walk
    run to its end over the walk-order rows, then one service pass (on a
    card each is one kernel launch), which adds the round's rays and
    live lanes to ``totals`` (ops/service.py ``TOTALS``; ``slot`` the
    round's live-lane slot).  A lane the pass sends to TEXG is shaded by
    the next round's pass.  Returns (state', quad rows fetched)."""
    s, rows = quad_walk(s, inline.walk, inline.sentinel, k, redirect_passes,
                        inline.walk_levels, fmt=fr.scene.leaf_fmt)
    if inline.table.device.type == "cpu":
        s = service_plain(s, inline, fr, totals, slot)
    else:
        if fr.service is None:
            fr.service = service_params(fr)
        s = service_pass_cuda(s, inline, fr.service, totals, slot)
    return s, rows


def service_plain(s, inline: InlineTable, fr: _Frame, totals, slot: int):
    """The plain version of the service kernel (ops/service.py): the
    material or tile row fetch of the SHADEG and TEXG lanes, then the
    eager service block, over a state whose walks have ended; the pass's
    rays and live lanes go to ``totals`` as the kernel's do.  Returns
    the new state."""
    idx, live_g, live_x = _service_select(s, torch.zeros_like(s["cur"]),
                                          inline)
    out, cont, sh, start = _service_shade(s, s, inline.table[idx], live_g,
                                          live_x, fr)
    _add_totals(totals, slot, cont + start, sh, out["mode"])
    return out


def _add_totals(totals, slot: int, path, shadow, mode) -> None:
    """The plain version of the kernel's totals (ops/service.py
    ``TOTALS``): add the path and shadow rays, add the lanes not DONE to
    the slot ``slot`` and zero the other."""
    totals[:LIVE] += torch.stack([path, shadow])
    totals[LIVE + slot] += (mode != DONE).sum()
    totals[LIVE + 1 - slot] = 0


def _service_select(s, idx, inline: InlineTable):
    """Route the service fetches into the step's row fetch: SHADEG lanes
    take their hit triangle's packed material row, TEXG lanes the tile
    row index stashed in ``cur``.  Returns (idx, live_g, live_x)."""
    live_g = s["mode"] == SHADEG
    sid = torch.clamp(s["hit_id"], min=0)
    shade_idx = inline.sentinel + (sid >> 1 if inline.pack == 2 else sid)
    idx = torch.where(live_g, shade_idx, idx)
    live_x = None
    if inline.tex0 is not None:
        live_x = s["mode"] == TEXG
        idx = torch.where(live_x, s["cur"], idx)
    return idx, live_g, live_x


def _service_shade(out, s, row, live_g, live_x, fr: _Frame):
    """The in-step shade / texture / regenerate block.  ``row`` is this
    step's fetched row, ``s`` the pre-step state (hit_id, so, sd, pend
    and tstash carry the TEXG stash across steps).  Returns (state',
    paths continued, shadow rays fired, camera rays started)."""
    if fr.inline.pack == 2:
        trow = torch.where(((s["hit_id"] & 1) == 1)[:, None],
                           row[:, 37:74], row[:, 0:37])
    else:
        trow = row[:, 0:37]
    out, ready_u, qq = _shade_prepare(out, trow, live_g, fr)
    m_all = ready_u
    if live_x is not None:
        ts = out["tstash"]
        hid = torch.clamp(s["hit_id"], min=0)
        offx = hid % TEX_TILE
        offy = hid // TEX_TILE % TEX_TILE
        factor = tile_bilinear(row, offx, offy, ts[:, 7], ts[:, 8])
        lx3 = live_x[:, None]
        front3 = (ts[:, 9] > 0.0)[:, None]
        nl_x = out["so"]
        qq = dict(qq)
        qq["nl"] = torch.where(lx3, nl_x, qq["nl"])
        qq["nrm"] = torch.where(lx3, torch.where(front3, nl_x, -nl_x),
                                qq["nrm"])
        qq["nl_off"] = torch.where(lx3, out["sd"], qq["nl_off"])
        qq["albedo"] = torch.where(lx3, ts[:, 0:3] * factor, qq["albedo"])
        qq["emission"] = torch.where(lx3, out["pend"], qq["emission"])
        qq["metallic"] = torch.where(live_x, ts[:, 3], qq["metallic"])
        qq["roughness"] = torch.where(live_x, ts[:, 4], qq["roughness"])
        qq["ior"] = torch.where(live_x, ts[:, 5], qq["ior"])
        qq["transmission"] = torch.where(live_x, ts[:, 6],
                                         qq["transmission"])
        m_all = ready_u | live_x
    out, cont, sh = _shade_finish(out, m_all, qq, fr.scene, fr.cfg)
    out, start = _refill(out, fr)
    return out, cont, sh, start


def _shade_prepare(s, hitrow, mask, fr: _Frame):
    """Geometry/material half of the shading block: normals (the
    interpolated vertex normal for shading directions with smooth
    shading on), and for textured hits the texture coordinates (planar,
    or interpolated per-corner UVs with UV mapping on) and the TEXG
    transition with the material stashed.  Returns (s, ready, q):
    ``ready`` the lanes to shade now."""
    textured = fr.inline.tex0 is not None
    scene, cfg = fr.scene, fr.cfg
    ready = mask
    if textured:
        # Out-of-range texture slots sample as factor 1: shade them now.
        tex_f = hitrow[:, 19]
        deferred = (ready & (s["hit_id"] >= 0) & (tex_f >= 0.0)
                    & (tex_f < len(fr.inline.metas)))
        ready = ready & ~deferred

    d = s["d"]
    q, uv = shade.surface(hitrow, s["o"] + d * s["d_min"][:, None], d, scene,
                          cfg, textured)
    if textured:
        # TEXG transition: stash what the finish body needs (the tile
        # row takes the row fetch next step); nrm is rebuilt from nl and
        # the front-face bit, negation being exact.
        front = vec.dot(q["nrm"], d) < 0.0
        trow_i, offx, offy, fx, fy = tile_coords(
            fr.inline.metas, hitrow[:, 19].to(torch.int64), *uv)
        t3 = deferred[:, None]
        s = dict(s)
        s["so"] = torch.where(t3, q["nl"], s["so"])
        s["sd"] = torch.where(t3, q["nl_off"], s["sd"])
        s["pend"] = torch.where(t3, q["emission"], s["pend"])
        stash = torch.cat(
            [q["albedo"], q["metallic"][:, None], q["roughness"][:, None],
             q["ior"][:, None], q["transmission"][:, None], fx[:, None],
             fy[:, None], front[:, None].to(torch.float32)], dim=1)
        s["tstash"] = torch.where(t3, stash, s["tstash"])
        s["mode"] = torch.where(deferred, TEXG, s["mode"])
        s["cur"] = torch.where(deferred, fr.inline.tex0 + trow_i, s["cur"])
        s["hit_id"] = torch.where(deferred, offy * TEX_TILE + offx,
                                  s["hit_id"])
    return s, ready, q


def _shade_finish(s, ready, q, scene, cfg: RenderConfig):
    """RNG/branch/NEE half of the shading block (ops/shade.py
    ``scatter``) for the lanes ``ready``, and the mode transitions: the
    NEE segment is stashed for the SHADOW walk.  Returns (s', path rays
    continued, shadow rays fired)."""
    tp, depth = s["tp"], s["depth"]
    alive = ready & (s["hit_id"] >= 0)  # miss -> path ends (renderer.cu:427)

    # All seven per-bounce draws in one hash: slots 0..6 of this depth.
    base = rng.CAMERA_DRAWS + depth * rng.DRAWS_PER_BOUNCE
    slots = torch.arange(rng.SLOT_LIGHT_R2 + 1, device=depth.device)
    u = rng.uniform(s["seed"][:, None], s["pix"][:, None],
                    base[:, None] + slots)
    b = shade.scatter(q, s["d"], tp, s["rad"], alive, s["prev_spec"], u,
                      depth > cfg.rr_threshold, scene, cfg)

    has_shadow = torch.zeros_like(ready)
    pend = torch.zeros_like(tp)
    so, sd, smax = s["so"], s["sd"], s["smax"]
    if b["nee"] is not None:
        has_shadow, nee_o, nee_d, nee_max, contrib = b["nee"]
        g3 = has_shadow[:, None]
        pend = torch.where(g3, contrib, pend)
        so = torch.where(g3, nee_o, so)
        sd = torch.where(g3, nee_d, sd)
        smax = torch.where(has_shadow, nee_max, smax)

    # Depth cap (renderer.cu:367): NEE still fires at the final depth.
    next_depth = depth + 1
    alive = b["alive"] & (next_depth < cfg.max_depth)
    shadow_fire = ready & has_shadow  # implies a diffuse branch

    mode = s["mode"]
    mode = torch.where(ready, REFILL, mode)  # default: path over
    cont = ready & alive
    mode = torch.where(cont & ~has_shadow, TRAVERSE, mode)
    mode = torch.where(shadow_fire, SHADOW, mode)
    r3 = ready[:, None]
    out = dict(s)
    out.update(
        mode=mode,
        cur=torch.where(ready, 0, s["cur"]),
        d_min=torch.where(ready, MISS_T, s["d_min"]),
        hit_id=torch.where(ready, -1, s["hit_id"]),
        o=torch.where(r3, b["o"], s["o"]),
        d=torch.where(r3, b["d"], s["d"]),
        tp=torch.where(r3, b["tp"], tp),
        rad=b["rad"],
        depth=torch.where(ready, next_depth, depth),
        prev_spec=torch.where(ready, b["prev_spec"], s["prev_spec"]),
        so=so, sd=sd, smax=smax,
        pend=torch.where(r3, pend, s["pend"]),
        cont_after_shadow=torch.where(shadow_fire, alive,
                                      s["cont_after_shadow"]),
    )
    return out, cont.sum(), shadow_fire.sum()


def _refill(s, fr: _Frame):
    """Path regeneration, owner schedule: flush the finished sample's
    radiance through the reference's sanitation (renderer.cu:737-759)
    into the lane's pixel sum, then start the pixel's next sample or
    retire the lane.  Returns (s', camera rays started)."""
    refill = s["mode"] == REFILL
    r3 = refill[:, None]
    flushed = _sanitize(s["rad"], fr.cfg)
    next_sample = s["sample"] + 1
    exhausted = next_sample >= fr.spp_cap
    new_sample = torch.where(refill, next_sample, s["sample"])
    start = refill & ~exhausted
    new_seed = rng.sample_seed(fr.frame_seed, fr.seed_spp,
                               new_sample + fr.sample_offset
                               if fr.sample_offset else new_sample)
    r_o, r_d = generate_rays(fr.cam, fr.width, fr.height, new_seed, s["pix"])

    st3 = start[:, None]
    res = dict(s)
    res.update(
        out=s["out"] + torch.where(r3, flushed, 0.0),
        mode=torch.where(refill, torch.where(exhausted, DONE, TRAVERSE),
                         s["mode"]),
        cur=torch.where(start, 0, s["cur"]),
        d_min=torch.where(start, MISS_T, s["d_min"]),
        hit_id=torch.where(start, -1, s["hit_id"]),
        o=torch.where(st3, r_o, s["o"]),
        d=torch.where(st3, r_d, s["d"]),
        tp=torch.where(st3, 1.0, s["tp"]),
        rad=torch.where(r3, 0.0, s["rad"]),
        sample=new_sample,
        seed=torch.where(refill, new_seed, s["seed"]),
        depth=torch.where(start, 0, s["depth"]),
        prev_spec=torch.where(start, True, s["prev_spec"]),
    )
    return res, start.sum()
