"""Which tree levels the walks' row fetches hit, counted on the CPU.

    python3 scripts/walk_levels_torch.py [--width 240 --height 160]

Renders one 1-spp step of chip_smoke.py's main-path scene (Cornell box
+ icosphere(5), 20,487 triangles) with the port on the CPU and counts
every row the round loop's walks fetch, by its level in the walk-order
copy of the quad rows (accel/bvh.py ``walk_order_table``).  Prints the
rows per level, the fetches per level and the cumulative share of
fetches that staging the top levels in shared memory would serve, with
the bytes those levels take.  A count, not a time: it needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tryraytrace_tpu_torch.camera.controller import CameraController  # noqa: E402
from tryraytrace_tpu_torch.config import RenderConfig  # noqa: E402
from tryraytrace_tpu_torch.engine import persistent  # noqa: E402
from tryraytrace_tpu_torch.engine.renderer import Renderer  # noqa: E402
from tryraytrace_tpu_torch.ops import walk  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=240)
    ap.add_argument("--height", type=int, default=160)
    args = ap.parse_args()
    w, h = args.width, args.height
    r = Renderer(chip_smoke.main_path_arrays(),
                 cfg=RenderConfig(width=w, height=h, spp=1), device="cpu")
    inline = r.inline
    counts = torch.zeros(inline.sentinel, dtype=torch.int64)

    def counting_walk(s, table, sentinel, k, passes=1, levels=(), *, fmt):
        """walk_plain, counting the rows it fetches."""
        rows = torch.zeros((), dtype=torch.int64)
        while True:
            idx, stepping = walk.walk_index(s, sentinel)
            n = stepping.sum()
            if int(n) == 0:
                return s, rows
            counts.add_(torch.bincount(idx[stepping], minlength=sentinel))
            rows = rows + n
            s = walk.walk_step(s, table[idx], sentinel, k, passes, fmt=fmt)

    persistent.quad_walk = counting_walk
    r.step(CameraController().get_params(w, h))
    st = r.last_stats
    total = int(counts.sum())
    assert total == int(st["rows_fetched"])
    levels = np.asarray(inline.walk_levels)
    ends = np.cumsum(levels)
    per_level = np.add.reduceat(counts.numpy(), ends - levels)
    row_bytes = inline.walk.shape[1] * 4
    print(f"[levels] {w}x{h}, 1 spp: {st['iterations']} rounds, {total} "
          f"row fetches ({total / (w * h):.2f} per pixel); {row_bytes} B "
          f"rows")
    for lv, (n_rows, end, fetched) in enumerate(zip(levels, ends,
                                                   per_level)):
        print(f"[levels] level {lv}: {n_rows} rows, {fetched} fetches; "
              f"levels 0-{lv}: {end} rows, {end * row_bytes} B, "
              f"{100.0 * per_level[:lv + 1].sum() / total:.1f}% of fetches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
