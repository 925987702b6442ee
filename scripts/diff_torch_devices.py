"""Where the port's render on a CUDA card departs from its render on the
CPU: the same wave on both devices, advanced one round at a time (on
the card one wave-kernel launch a round, on the CPU the round loop
without compaction), each lane-state field compared after every
round.

    python3 scripts/diff_torch_devices.py [--width 64 --height 48]
        [--keys w] [--frames 2]

The scene is the Cornell box without a mesh and a 16x16 checker
texture (tests/test_torch_display.py), the camera the default one moved
by ``--keys`` (CameraController.update).  For each frame seed it prints
the first round and fields at which the two devices' states differ
(-0.0 == 0.0 and NaN == NaN), a few lanes' values there, and how many
floats of the frame's sums differ at the end, by how many ulps.  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tryraytrace_tpu_torch.camera.controller import CameraController  # noqa: E402
from tryraytrace_tpu_torch.config import RenderConfig  # noqa: E402
from tryraytrace_tpu_torch.engine import persistent  # noqa: E402
from tryraytrace_tpu_torch.engine.renderer import Renderer  # noqa: E402
from tryraytrace_tpu_torch.scene.assets import checker_texture  # noqa: E402
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box  # noqa: E402
from tryraytrace_tpu_torch.scene.model import flatten_scene  # noqa: E402


def _differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.cpu(), b.cpu()
    ne = a != b
    if a.is_floating_point():
        ne = ne & ~(a.isnan() & b.isnan())
    return ne.reshape(ne.shape[0], -1).any(dim=1) if ne.dim() else ne


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def frame(renderers, params, frame_seed: int, cfg: RenderConfig) -> None:
    n = cfg.width * cfg.height
    waves = [persistent.Wave(r.scene, r.inline, params, frame_seed,
                             cfg.width, cfg.height, cfg,
                             torch.arange(n, device=r.device), cfg.spp,
                             cfg.spp) for r in renderers]
    first = None
    rnd = 0
    while True:
        states = [w.state for w in waves]
        if states[0]["mode"].shape != states[1]["mode"].shape:
            print(f"  round {rnd}: lane counts differ "
                  f"{[s['mode'].shape[0] for s in states]}")
            break
        bad = {k: _differ(states[0][k], states[1][k]) for k in states[0]}
        bad = {k: v for k, v in bad.items() if bool(v.any())}
        if bad and first is None:
            first = rnd
            lanes = sorted(set().union(*(v.nonzero()[:, 0].tolist()[:3]
                                         for v in bad.values())))[:3]
            print(f"  first difference after round {rnd}: fields "
                  f"{ {k: int(v.sum()) for k, v in bad.items()} } "
                  f"(lanes differing)")
            for lane in lanes:
                for k in bad:
                    print(f"    lane {lane} {k}: card "
                          f"{states[0][k][lane].cpu().tolist()} cpu "
                          f"{states[1][k][lane].cpu().tolist()}")
        if all(w.done for w in waves):
            break
        for w in waves:
            w.advance(1)
        rnd += 1
    if first is None:
        print(f"  states equal in all {rnd} rounds")
    sums = [w.read()[0].cpu().numpy() for w in waves]
    ulps = _ulps(sums[0], sums[1])
    stats = [(int(w.n_traced), int(w.n_shadow), int(w.rows_fetched))
             for w in waves]
    print(f"  frame {frame_seed}: {int((ulps > 0).sum())} of {ulps.size} "
          f"floats of the sums differ, max {int(ulps.max())} ulps; (path, "
          f"shadow, rows) card {stats[0]} cpu {stats[1]}; MSE "
          f"{float(((sums[0] - sums[1]) ** 2).mean())!r}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--keys", default="w")
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("diff_torch_devices: no CUDA device", file=sys.stderr)
        return 2
    arrays = flatten_scene(create_cornell_box(mesh=None),
                           textures=[checker_texture(16)])
    cfg = RenderConfig(width=args.width, height=args.height, spp=1)
    cam = CameraController()
    if args.keys:
        cam.update(1.0, set(args.keys))
    params = cam.get_params(args.width, args.height)
    renderers = [Renderer(arrays, cfg=cfg, device=d) for d in ("cuda", "cpu")]
    # The card's wave kernel keeps every lane in place; the CPU's round
    # loop here does too, so the states compare lane for lane.
    persistent.MIN_COMPACT_WIDTH = args.width * args.height
    print(f"{torch.cuda.get_device_name(0)}; {args.width}x{args.height}, "
          f"camera keys {args.keys!r}")
    for f in range(1, args.frames + 1):
        frame(renderers, params, f, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
