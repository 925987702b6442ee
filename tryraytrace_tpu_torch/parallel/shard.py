"""Sharded rendering over a (dp, sp) mesh (the counterpart of
tryraytrace_tpu/parallel/shard.py).

A frame over the mesh:

  - pixel rows are split along ``dp``: shard row i renders the i-th
    contiguous block of pixels (RNG streams are keyed by absolute pixel,
    so the sharded image is bit-identical to one device's);
  - the frame's samples are split along ``sp``: shard (i, j) renders
    samples [j * spp / sp, (j + 1) * spp / sp) of the frame's sample
    set with the frame's global streams (engine/wavefront.py
    ``render_frame``'s ``sample_offset`` and ``seed_spp``);
  - the sp partial sums of a block are added in shard order: in the
    process that holds them, then across the processes of the block's
    sp group with one all-gather (summed in rank order, so the sum does
    not depend on the collective's own order);
  - the exact int64 ray totals are summed over both axes.

Either engine renders the shards (``cfg.engine``): the persistent
engine's round loop with its walk kernel, or the bounce engine with its
threaded walk kernel.  Shards on one device run one after another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tryraytrace_tpu_torch.config import RenderConfig, check_supported
from tryraytrace_tpu_torch.engine.device_scene import (DeviceScene,
                                                       upload_scene)
from tryraytrace_tpu_torch.engine.state import RenderState
from tryraytrace_tpu_torch.engine.wavefront import engine_tables, render_frame
from tryraytrace_tpu_torch.io.snapshot import tonemap_accum
from tryraytrace_tpu_torch.ops.tonemap import tonemap, tonemap_cuda
from tryraytrace_tpu_torch.parallel import distributed
from tryraytrace_tpu_torch.parallel.mesh import (SAMPLE_AXIS, TILE_AXIS,
                                                 make_mesh)

# The sp groups of each mesh, made once (every process makes every
# group, in the same order).
_GROUPS: dict = {}


def _sp_groups(mesh) -> dict:
    """{dp row: process group of the row's processes} for the rows that
    span more than one process."""
    if mesh not in _GROUPS:
        groups = {}
        for i, ranks in enumerate(mesh.ranks):
            if len(set(ranks)) > 1:
                groups[i] = distributed.new_group(set(ranks))
        _GROUPS[mesh] = groups
    return _GROUPS[mesh]


def replicate(scene: DeviceScene, textures, cfg: RenderConfig,
              devices) -> dict:
    """{device: (scene, inline table, texture tensors, bounce tables)}
    on each of ``devices``: the scene's tables copied there, and what the
    engine reads besides them (wavefront.py ``engine_tables``)."""
    out = {}
    for dev in devices:
        if dev in out:
            continue
        s = dataclasses.replace(scene, **{
            name: getattr(scene, name).to(dev) for name in DeviceScene.ARRAYS})
        out[dev] = (s, *engine_tables(s, textures, cfg))
    return out


def render_frame_sharded(replicas: dict, cam, frame_seed: int, width: int,
                         height: int, cfg: RenderConfig, spp: int, mesh,
                         with_stats: bool = False,
                         shard_iterations: dict | None = None):
    """One frame's radiance sums over ``mesh``: {dp row i: sums of pixel
    block i [N / dp, 3]} for the rows this process renders, on the
    device of its first shard of the row.  ``replicas`` is ``replicate``
    over the process's devices.  With ``with_stats`` also the frame's
    (path rays, shadow rays), int64 totals over both mesh axes and every
    process.  A ``shard_iterations`` dict receives {(i, j): the engine's
    ``iterations``} for this process's shards: rounds (one walk-kernel
    launch each) or bounces (two threaded-walk launches each).  Requires
    width * height % dp == 0 and spp % sp == 0."""
    n = width * height
    dp, sp = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    if n % dp:
        raise ValueError(f"{n} pixels not divisible by dp={dp}")
    if spp % sp:
        raise ValueError(f"spp={spp} not divisible by sp={sp}")
    local_spp, nb = spp // sp, n // dp
    parts: dict = {}
    counts = torch.zeros(2, dtype=torch.int64)
    for i, j, dev in mesh.local(distributed.process_index()):
        scene, inline, textures, tables = replicas[dev]
        acc, st = render_frame(scene, inline, textures, cam, frame_seed,
                               width, height, cfg, spp=local_spp,
                               pixels=range(i * nb, (i + 1) * nb),
                               sample_offset=j * local_spp, seed_spp=spp,
                               tables=tables)
        parts.setdefault(i, []).append(acc)
        counts += torch.stack([st["n_traced"], st["n_shadow"]]).cpu()
        if shard_iterations is not None:
            shard_iterations[(i, j)] = st["iterations"]
    blocks = {}
    for i, accs in parts.items():
        total = accs[0]
        for acc in accs[1:]:
            total = total + acc.to(total.device)
        blocks[i] = total
    for i, group in _sp_groups(mesh).items():
        if i in blocks:
            gathered = distributed.all_gather(blocks[i], group)
            total = gathered[0]
            for part in gathered[1:]:
                total = total + part
            blocks[i] = total
    if not with_stats:
        return blocks
    tr, sh = distributed.all_reduce_sum(counts).tolist()
    return blocks, (tr, sh)


class ShardedRenderer:
    """Progressive renderer over a (dp, sp) mesh: the scene replicated on
    every device, the image's pixel rows split, the samples of a frame
    split and their sums added.  The API mirrors engine/renderer.py
    ``Renderer``; ``accum_host`` and ``image`` are collectives when the
    mesh spans processes (every process calls them)."""

    def __init__(self, arrays, cfg: RenderConfig, mesh=None):
        check_supported(cfg)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.cfg = cfg
        self.width, self.height = cfg.width, cfg.height
        rank = distributed.process_index()
        local = self.mesh.local(rank)
        devices = list(dict.fromkeys(dev for _, _, dev in local))
        scene, self.textures, self.bvh = upload_scene(
            arrays, leaf_size=cfg.bvh_leaf_size, method=cfg.bvh_method,
            quad_collapse=cfg.quad_collapse, device=devices[0],
            leaf_fmt=cfg.leaf_isect)
        self.replicas = replicate(scene, self.textures, cfg, devices)
        self.scene = scene
        _sp_groups(self.mesh)
        dp = self.mesh.shape[TILE_AXIS]
        self._nb = self.width * self.height // dp
        # The first local shard's device of each row holds its block.
        self._home = {}
        for i, _, dev in local:
            self._home.setdefault(i, dev)
        # The rows whose blocks this process contributes to a gather.
        self._owned = [i for i in self._home
                       if self.mesh.ranks[i][0] == rank]
        self.blocks = {}
        self.reset()
        self.last_stats = None

    def step(self, cam, spp: int | None = None) -> None:
        spp = self.cfg.spp if spp is None else spp
        # The seed schedule (core/rng.py) needs a constant spp per
        # accumulation, as in Renderer.step.
        if self._step_spp is not None and spp != self._step_spp:
            raise ValueError(
                f"spp changed {self._step_spp} -> {spp} mid-accumulation; "
                "call reset() first (RNG streams would alias)")
        self._step_spp = spp
        iterations = {}
        add, (tr, sh) = render_frame_sharded(
            self.replicas, cam, self.frame, self.width, self.height,
            self.cfg, spp, self.mesh, with_stats=True,
            shard_iterations=iterations)
        for i, block in add.items():
            self.blocks[i] = self.blocks[i] + block
        self._spp += spp
        self.frame += 1
        self.last_stats = dict(n_traced=torch.tensor(tr),
                               n_shadow=torch.tensor(sh),
                               shard_iterations=iterations)

    def reset(self) -> None:
        self.blocks = {i: torch.zeros((self._nb, 3), device=dev)
                       for i, dev in self._home.items()}
        self._spp = 0
        self.frame = 1
        self._step_spp = None

    def restore(self, state: RenderState) -> None:
        """Take over a whole-image accumulation (a loaded checkpoint's
        [N, 3] sums and spp, on any device): each local row keeps its
        block."""
        accum = state.accum.reshape(-1, 3)
        for i, dev in self._home.items():
            self.blocks[i] = accum[i * self._nb:(i + 1) * self._nb].to(
                dev).clone()
        self._spp = int(state.spp)

    def spp(self) -> int:
        return self._spp

    def accum_host(self) -> np.ndarray:
        """The whole [H, W, 3] accumulator on every process."""
        blocks = {i: self.blocks[i] for i in self._owned}
        return distributed.gather_accum_host(
            blocks, self.mesh.shape[TILE_AXIS]).reshape(
                self.height, self.width, 3)

    def image(self, on_device: bool | None = None) -> np.ndarray:
        """Tonemapped uint8 [H, W, 3] on every process, as
        Renderer.image: on the device of the process's first shard (the
        tonemap kernel on a card, its plain version on the CPU), or with
        ``on_device=False`` on the host."""
        spp = max(self._spp, 1)
        if on_device is False:
            return tonemap_accum(self.accum_host(), spp)
        home = next(iter(self.replicas))
        if distributed.is_distributed():
            accum = torch.from_numpy(
                self.accum_host().reshape(-1, 3)).to(home)
        else:
            accum = torch.cat([self.blocks[i].to(home)
                               for i in range(self.mesh.shape[TILE_AXIS])])
        img = tonemap_cuda(accum, spp) if on_device else tonemap(accum, spp)
        return img.cpu().numpy().reshape(self.height, self.width, 3)

    def block_until_ready(self) -> None:
        for dev in self.replicas:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
