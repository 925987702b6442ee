"""Multi-process rendering over ``torch.distributed`` (the counterpart
of tryraytrace_tpu/parallel/distributed.py).

The same (dp, sp) mesh as parallel/mesh.py spans every process's
devices; tracing stays free of communication (the scene is replicated,
pixel rows are split), and a frame's only collectives are the sp
reduction and the ray totals' sum (parallel/shard.py).

Usage (the same command in every process):

    tpurt-torch render --coordinator host0:1234 --num-processes 2 \\
        --process-id $RANK ...

The backend follows the devices: NCCL for one process per card (process
p renders on card p modulo the cards it sees), gloo for the CPU.  A
caller may name gloo on a card: that is how two processes share one
card.  ``tests/test_torch_parallel.py`` runs two CPU processes over
gloo through the CLI and holds the image to a single process's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tryraytrace_tpu_torch.engine.state import resolve_device

# This process's devices and the backend, set by init_distributed.
_LOCAL: dict = {}


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     cpu_devices_per_process: int | None = None, *,
                     device="cuda", backend: str | None = None) -> None:
    """Join the process group at ``coordinator`` (``host:port``, a TCP
    rendezvous that process 0 serves) as process ``process_id`` of
    ``num_processes``.

    The process renders on card ``process_id % device_count`` of
    ``device="cuda"`` (raises without one), or, with
    ``cpu_devices_per_process`` (or ``device="cpu"``), on that many CPU
    shards (one by default).  ``backend`` defaults to NCCL on a card and
    gloo on the CPU; gloo may be named on a card."""
    if cpu_devices_per_process is not None:
        device = "cpu"
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        local = [dev]
    else:
        local = [torch.device("cpu")] * (cpu_devices_per_process or 1)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _LOCAL.update(devices=local, backend=backend)


def shutdown() -> None:
    """Leave the process group (nothing to do without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL.clear()


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every process (nothing to do without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def local_devices() -> list:
    """This process's devices: those init_distributed chose, else every
    card (raises without one)."""
    if dist.is_initialized():
        return list(_LOCAL["devices"])
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_devices() -> list:
    """(process, device) of every process's devices, process by process."""
    mine = [str(d) for d in local_devices()]
    if not is_distributed():
        return [(process_index(), torch.device(d)) for d in mine]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return [(rank, torch.device(d)) for rank, devs in enumerate(every)
            for d in devs]


def collective_device() -> torch.device:
    """Where a collective's tensors live: the process's card under NCCL,
    the CPU under gloo."""
    if _LOCAL.get("backend") == "nccl":
        return _LOCAL["devices"][0]
    return torch.device("cpu")


def new_group(ranks):
    """A process group of ``ranks`` (every process must make every
    group, in the same order)."""
    return dist.new_group(sorted(ranks))


def all_gather(tensor: torch.Tensor, group) -> list:
    """Every group member's ``tensor`` (same shape and type in each), in
    rank order, on the tensor's device."""
    t = tensor.to(collective_device()).contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return [x.to(tensor.device) for x in out]


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum over every process of an integer ``tensor`` (exact)."""
    if not is_distributed():
        return tensor
    t = tensor.to(collective_device()).clone()
    dist.all_reduce(t)
    return t.to(tensor.device)


def gather_accum_host(blocks: dict, n_blocks: int) -> np.ndarray:
    """The full [N, 3] accumulator on every process: the dp blocks
    ``{block index: [N / n_blocks, 3] tensor}`` this process owns, with
    every other process's (an all-gather); a single process's blocks
    are copied out as they are."""
    mine = {i: b.cpu().numpy() for i, b in blocks.items()}
    if is_distributed():
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        mine = {i: b for part in every for i, b in part.items()}
    if sorted(mine) != list(range(n_blocks)):
        raise RuntimeError(f"dp blocks {sorted(mine)} of {n_blocks}")
    return np.concatenate([mine[i] for i in range(n_blocks)], axis=0)
