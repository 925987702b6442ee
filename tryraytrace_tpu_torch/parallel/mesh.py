"""Device meshes for sharded rendering (the counterpart of
tryraytrace_tpu/parallel/mesh.py).

The reference renders on one GPU in one process.  The port maps its
two parallel axes onto a 2-D grid of devices:

  - ``dp`` (tile parallel): the image's pixel rows are split; the scene
    is replicated, so tracing needs no communication;
  - ``sp`` (sample parallel): each shard renders its slice of a frame's
    sample set with the frame's global RNG streams, and the slices' sums
    are added, the one reduction of a frame.

A ``Mesh`` is that grid of ``torch.device``s with the process that owns
each one.  By default it takes every process's devices
(parallel/distributed.py ``global_devices``: each process's card, once
``init_distributed`` has run, else every card of this process).  A
device may appear more than once: each entry is a shard, rendered one
after another on that device, which is how N shards share one card or
the CPU (the counterpart of the JAX package's virtual CPU devices).
"""

from __future__ import annotations

import dataclasses

import torch

from tryraytrace_tpu_torch.parallel import distributed

TILE_AXIS = "dp"
SAMPLE_AXIS = "sp"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) grid: ``devices[i][j]`` renders pixel block i, sample
    slice j, in process ``ranks[i][j]``."""

    devices: tuple  # dp rows of sp torch.devices
    ranks: tuple    # the owning process of each entry, same shape

    @property
    def shape(self) -> dict:
        return {TILE_AXIS: len(self.devices),
                SAMPLE_AXIS: len(self.devices[0])}

    def local(self, rank: int) -> list:
        """(i, j, device) of the shards process ``rank`` renders, in
        row-major order."""
        return [(i, j, dev) for i, row in enumerate(self.devices)
                for j, dev in enumerate(row) if self.ranks[i][j] == rank]


def make_mesh(devices=None, tile: int | None = None,
              sample: int | None = None) -> Mesh:
    """A (dp, sp) mesh over ``devices`` (this process's; entries may
    repeat) or, by default, every process's devices.  With no split
    every device goes to the tile axis (the layout with no
    communication); with one axis given the other takes the rest."""
    if devices is None:
        entries = distributed.global_devices()
    else:
        rank = distributed.process_index()
        entries = [(rank, torch.device(d)) for d in devices]
    n = len(entries)
    if tile is None and sample is None:
        tile, sample = n, 1
    elif tile is None:
        tile = n // sample
    elif sample is None:
        sample = n // tile
    if tile * sample != n:
        raise ValueError(f"mesh {tile}x{sample} != {n} devices")
    rows = [entries[i * sample:(i + 1) * sample] for i in range(tile)]
    return Mesh(tuple(tuple(dev for _, dev in row) for row in rows),
                tuple(tuple(rank for rank, _ in row) for row in rows))
