"""Process-group set-up and per-host data sharding (the torch.distributed
counterpart of ``satpu.parallel.multihost``).

satpu runs one SPMD program over every chip: ``jax.distributed.initialize``
connects the hosts and each host feeds its slice of the global batch. Here
each rank is one process (``torchrun --nproc-per-node N``): rank r drives
``cuda:LOCAL_RANK`` and joins an NCCL group, or a gloo group with
``--device cpu``. Single-process runs degenerate to no-ops, so drivers call
these unconditionally.
"""
from __future__ import annotations

import contextlib
import logging
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _world_from_env():
    """(init_method, world size, rank) from torchrun's RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT, else satpu's SATPU_COORDINATOR ("host:port") /
    SATPU_NUM_PROCESSES / SATPU_PROCESS_ID; None when neither names a world."""
    env = os.environ
    if env.get("WORLD_SIZE") and env.get("RANK"):
        addr, port = env.get("MASTER_ADDR", "localhost"), env.get("MASTER_PORT", "29500")
        return f"tcp://{addr}:{port}", int(env["WORLD_SIZE"]), int(env["RANK"])
    coord = env.get("SATPU_COORDINATOR", "")
    nproc = int(env.get("SATPU_NUM_PROCESSES", "0"))
    pid = int(env.get("SATPU_PROCESS_ID", "-1"))
    if coord and nproc > 0 and pid >= 0:
        return f"tcp://{coord}", nproc, pid
    return None


def configured_world_size() -> int:
    """The world size the environment names (1 when none), before joining
    it: drivers check their batch sizes against it first."""
    world = _world_from_env()
    return world[1] if world is not None else 1


def init_distributed(device, coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Join the process group that the arguments or the environment name
    (``_world_from_env``), with NCCL for a CUDA ``device`` and gloo for the
    CPU, and return the world size. With no world configured it does
    nothing and returns 1; a group that is already up is kept."""
    if dist.is_initialized():
        return dist.get_world_size()
    if coordinator_address and num_processes and process_id is not None:
        world = (f"tcp://{coordinator_address}", num_processes, process_id)
    else:
        world = _world_from_env()
    if world is None or world[1] <= 1:
        return 1
    init_method, size, rank = world
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank)
    logging.info("torch.distributed: rank %d/%d over %s (%s)", rank, size, init_method,
                 backend)
    return size


def local_device(device) -> torch.device:
    """The device this rank drives: ``cuda:LOCAL_RANK`` for an unindexed
    CUDA ``device`` under a launcher that sets LOCAL_RANK, else ``device``.
    An indexed card is made the current device: NCCL builds its
    communicators and runs ``barrier`` on the current device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return device


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_and_count(process_index, process_count):
    up = dist.is_initialized()
    p = process_index if process_index is not None else (dist.get_rank() if up else 0)
    n = process_count if process_count is not None else (dist.get_world_size() if up else 1)
    return p, n


def host_shard_list(items: Sequence, process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> list:
    """Deterministic per-process slice of a work list: process k takes
    items[k::P]. Identity in single-process runs."""
    p, n = _rank_and_count(process_index, process_count)
    return list(items)[p::n] if n > 1 else list(items)


def host_local_batch_size(global_batch: int, process_count: Optional[int] = None) -> int:
    """global_batch / P; raises ValueError when P does not divide it."""
    _, n = _rank_and_count(None, process_count)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    return global_batch // n


@contextlib.contextmanager
def distributed(device):
    """``init_distributed(device)`` for the run of a block (yields the world
    size), and the group's teardown after it when the block started it."""
    owned = not dist.is_initialized()
    world = init_distributed(device)
    try:
        yield world
    finally:
        if owned:
            shutdown()
