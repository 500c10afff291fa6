"""Data parallelism with satpu's global-batch semantics (the torch.distributed
counterpart of ``satpu.parallel.mesh``).

satpu's training steps run under a ``data`` mesh axis: GSPMD computes
exactly the step of the global batch, batch statistics included, and device
k holds rows ``[k B/n, (k+1) B/n)`` (``P("data")``). Here each rank holds
that contiguous block (``local_batch_slice``) and the layers whose result
depends on the whole batch (batch norm, the VQ codebook's EMA counts, the
chain objective's frame count, NG-SGD's statistics) sum their statistics
over the ranks. Each rank's loss is its rows' sum over the global count, so
the SUM of the ranks' gradients is the gradient of the global loss.

Only ``all_reduce`` and ``broadcast`` are used: they are the two collectives
that gloo carries for CUDA tensors as well as NCCL does. Inside autograd the
sum is ``torch.distributed.nn.functional.all_reduce``, whose backward sums
the ranks' gradients.

Serving (``--serve-mesh``) has no process group: one process replicates the
model on each local device and runs each contiguous block of a batch on its
own device (``split_rows`` / ``gather_rows``), each replica drawing its
block's rows of the batch's random values (``row_block``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def world() -> int:
    """The process group's size (1 without one)."""
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def active() -> bool:
    """Whether a process group is up: the data-parallel code paths run
    then, at any world size (a world of one sums over itself)."""
    return dist.is_available() and dist.is_initialized()


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if active():
        dist.barrier()


def pad_batch_to_devices(batch_size: int, n_data: int) -> int:
    """Smallest multiple of n_data >= batch_size."""
    return ((batch_size + n_data - 1) // n_data) * n_data


def check_batch_divisible(batch_size: int, n: int, what: str = "minibatch size") -> None:
    """satpu's refusal of a minibatch the device count does not divide (a
    silent single-device fallback would be the real bug)."""
    if n > 1 and batch_size % n:
        raise ValueError(
            f"{what} {batch_size} must be divisible by the device count {n} for "
            f"data-parallel training (pad to {pad_batch_to_devices(batch_size, n)})")


def local_batch_slice(batch_size: int, rank_: int, world_: int) -> slice:
    """The contiguous block of a global batch that rank ``rank_`` of
    ``world_`` takes: rows [r B/n, (r+1) B/n)."""
    check_batch_divisible(batch_size, world_, "global batch")
    b = batch_size // world_
    return slice(rank_ * b, (rank_ + 1) * b)


def repeat_pad_rows(n_rows: int, n_data: int):
    """Row selection that repeat-pads a batch of ``n_rows`` to a multiple of
    ``n_data`` (satpu's padding of a short tail bucket), or None when it
    divides already."""
    if n_rows % n_data == 0:
        return None
    return [i % n_rows for i in range(pad_batch_to_devices(n_rows, n_data))]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable (its backward sums
    the ranks' gradients); ``t`` itself without a process group."""
    if not active():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


@torch.no_grad()
def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum of ``t`` over the ranks (no autograd); returns ``t``."""
    if active():
        dist.all_reduce(t)
    return t


@torch.no_grad()
def all_reduce_tensors_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum every tensor of ``tensors`` over the ranks in place, in one
    collective per dtype."""
    if not active():
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _flatten_dense_tensors(group)
        dist.all_reduce(flat)
        for t, s in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(s)


@torch.no_grad()
def sum_grads_(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the parameters' gradients over the ranks. Every rank runs the
    same graph, so the same parameters hold a gradient (the others keep
    none, and the optimizer skips them as it does in one process)."""
    all_reduce_tensors_([p.grad for p in params if p.grad is not None])


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` from rank ``src`` (the
    replicated state of satpu's mesh step)."""
    if not active():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)


def sum_metrics(metrics: dict, replicated: Sequence[str] = ()) -> dict:
    """Each metric's sum over the ranks (a rank reports its share), in one
    collective; the names in ``replicated`` hold one value on every rank
    and pass through."""
    keys = [k for k, v in metrics.items()
            if k not in replicated and isinstance(v, torch.Tensor)]
    if not active() or not keys:
        return metrics
    vals = torch.stack([metrics[k].detach().double().reshape(()) for k in keys])
    all_reduce_(vals)
    return {**metrics, **dict(zip(keys, vals.unbind()))}


_row_block = contextvars.ContextVar("satpu_row_block", default=(0, 1))


@contextlib.contextmanager
def row_block(index: int, count: int):
    """Within the block, ``global_rows`` without a process group draws for
    block ``index`` of ``count`` equal row blocks: a serving-mesh replica's
    share of the batch, whose generator is in the state of every other
    replica's."""
    token = _row_block.set((index, count))
    try:
        yield
    finally:
        _row_block.reset(token)


def global_rows(draw, shape) -> torch.Tensor:
    """A random draw for this rank's block of rows of the global batch:
    ``draw(global shape)`` (every rank's generator in the same state draws
    the same values) cut to the block, so that a data-parallel run draws
    the one-process run's values. ``shape[0]`` is the block's row count.
    Without a process group the block is ``row_block``'s (all rows by
    default)."""
    k, n = (rank(), world()) if active() else _row_block.get()
    if n == 1:
        return draw(tuple(shape))
    b = shape[0]
    full = draw((b * n,) + tuple(shape[1:]))
    return full[k * b:(k + 1) * b]


def serve_devices(device) -> List[torch.device]:
    """The serving mesh's devices: every local card for a CUDA ``device``
    (satpu's ``jax.devices()``), else ``device`` alone."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def split_rows(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Contiguous row blocks of the host tensor ``x`` (the last ones shorter
    when the row count does not divide), block k on ``devices[k]``; empty
    blocks are dropped. A block goes to a card through pinned memory: a
    copy from pageable memory first waits for the device's queue to drain."""
    blocks = torch.tensor_split(x, len(devices)) if len(devices) > 1 else (x,)
    return [b.pin_memory().to(d, non_blocking=True) if torch.device(d).type == "cuda"
            else b.to(d) for b, d in zip(blocks, devices) if b.shape[0]]


def gather_rows(blocks: Sequence[torch.Tensor], device: Optional[torch.device] = None
                ) -> torch.Tensor:
    """The blocks back in order on ``device`` (the first block's by default)."""
    device = device if device is not None else blocks[0].device
    return torch.cat([b.to(device) for b in blocks])
