"""Data parallelism over ranks: one process per GPU, launched with
``torchrun`` (the port's counterpart of the JAX package's
``parallel/mesh.py``).

The JAX package shards each batch over the ``data`` axis of a mesh and lets
XLA make every batch reduction global.  Here rank r of N holds rows
``[r B/N, (r+1) B/N)`` of each global batch of ``TRAIN.BATCH_SIZE`` = B, and
every place where the step reduces over the batch calls a collective, so
that N ranks compute what one process computes at batch B, up to the order
of the sums.

The convention: every rank computes the same global loss from replicated
values, and a parameter's gradient is the sum over ranks of each rank's
part (:func:`all_reduce_grads_` before each optimizer step).  Three
differentiable collectives keep it:

* :func:`reduce`: the sum over ranks.  Its consumers are the same on every
  rank (a loss), so each rank's gradient is already the whole: the
  backward passes it through;
* :func:`gather`: the ranks' tensors concatenated along a dim; the backward
  keeps this rank's slice, for the same reason;
* :func:`share`: the identity.  Its backward sums the gradient over ranks:
  it marks a replicated value that feeds this rank's own share of the work
  (the BatchNorm statistics of the local rows, every text's words against
  the local images), whose gradient is the sum of every rank's part.

A row gather is an all_reduce of a zero buffer in which each rank fills its
slot, so one code path runs on NCCL and on gloo, on the CPU and on CUDA
tensors (gloo offers only broadcast and all_reduce for CUDA tensors).
Host tensors (the lengths of the captions) go over a gloo group beside an
NCCL one, so they cost no wait on the device.

One process without a ``torchrun`` environment is world size 1 with no
process group: every collective is the identity and the code computes
exactly what it computed before.  At world size 1 with a group (NCCL on one
card) each collective is an exact copy, so the step is bit-identical to the
one without.

The collectives are library calls (NCCL, gloo): on the TPU, XLA inserts
them; no Pallas kernel computes them.  There is no fallback: a failed init,
a rank without its GPU, or a collective its backend cannot do raises.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as tdist

from sba_gan_tpu_torch.utils.platform import resolve_device

_LOW = (torch.bfloat16, torch.float16)  # carried as float32 through collectives
_host_group = None  # the gloo group for host tensors beside an NCCL default group


def active() -> bool:
    """A process group exists."""
    return tdist.is_available() and tdist.is_initialized()


def world_size() -> int:
    return tdist.get_world_size() if active() else 1


def rank() -> int:
    return tdist.get_rank() if active() else 0


def is_main() -> bool:
    """Rank 0, the one that writes checkpoints, images and logs."""
    return rank() == 0


def check_mesh(cfg, world: int) -> None:
    """``JAX.MESH_DATA`` (-1: the world size) and ``JAX.MESH_MODEL`` against
    the world."""
    if cfg is None:
        return
    if cfg.JAX.MESH_MODEL > 1:
        raise NotImplementedError(
            f"JAX.MESH_MODEL={cfg.JAX.MESH_MODEL}: the tensor-parallel Inception of "
            "the JAX package's model axis (parallel/mesh.py tensor_constraint) is not "
            "ported (ROADMAP.md, queue 1, item 7)")
    if cfg.JAX.MESH_DATA not in (-1, world):
        raise ValueError(f"JAX.MESH_DATA={cfg.JAX.MESH_DATA} differs from the world "
                         f"size {world} (-1 takes the world size)")


def local_batch_size(global_batch: int, n: int) -> int:
    """Rows of each rank; the global batch must divide over the ranks."""
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data-axis size {n}")
    return global_batch // n


def rows(local: int) -> slice:
    """This rank's rows of a global batch of ``local`` rows a rank."""
    r = rank()
    return slice(r * local, (r + 1) * local)


def init_distributed(cfg=None, device="cuda", backend: Optional[str] = None
                     ) -> torch.device:
    """This process's device, after joining the world that ``torchrun``
    describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  Without ``WORLD_SIZE`` it is one process and no group.

    ``device`` "cuda" is ``cuda:LOCAL_RANK``; an explicit index is kept (the
    check that puts two ranks on one card).  The backend is NCCL for CUDA
    and gloo for the CPU; ``backend="gloo"`` on CUDA only when asked.  A
    group that exists already is joined as it is."""
    env = os.environ
    if "WORLD_SIZE" not in env and not active():
        check_mesh(cfg, 1)
        return resolve_device(device)
    dev = resolve_device(device)
    if active():
        world, r, local = world_size(), rank(), int(env.get("LOCAL_RANK", rank()))
    else:
        world, r = int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", r))
    check_mesh(cfg, world)
    if dev.type == "cuda":
        index = local if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {r}: cuda:{index} does not exist "
                               f"({torch.cuda.device_count()} visible)")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    if active():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL carries CUDA tensors: pass a CUDA device")
    tdist.init_process_group(backend, rank=r, world_size=world)
    global _host_group
    _host_group = tdist.new_group(backend="gloo") if backend == "nccl" else None
    return dev


def shutdown() -> None:
    """Leaves the world (every group)."""
    global _host_group
    if active():
        tdist.destroy_process_group()
    _host_group = None


@contextlib.contextmanager
def distributed(cfg=None, device="cuda", backend: Optional[str] = None
                ) -> Iterator[torch.device]:
    """:func:`init_distributed` for an entry point; leaves the world on exit
    if it joined it."""
    joined = not active()
    dev = init_distributed(cfg, device, backend)
    try:
        yield dev
    finally:
        if joined:
            shutdown()


def _group(x: torch.Tensor):
    return _host_group if x.device.type == "cpu" and _host_group is not None else None


def barrier() -> None:
    if active():
        tdist.barrier(group=_host_group)


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank."""
    if not active():
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=0, group=_host_group)
    return box[0]


def _sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x``, a new tensor (no autograd)."""
    buf = x.detach().to(torch.float32 if x.dtype in _LOW else x.dtype, copy=True)
    tdist.all_reduce(buf, group=_group(x))
    return buf.to(x.dtype)


def _gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * world_size()
    buf = torch.zeros(shape, dtype=torch.float32 if x.dtype in _LOW else x.dtype,
                      device=x.device)
    buf.narrow(dim, rank() * n, n).copy_(x.detach())
    tdist.all_reduce(buf, group=_group(x))
    return buf.to(x.dtype)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return _gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, rank() * ctx.n, ctx.n), None


def reduce(x: torch.Tensor) -> torch.Tensor:
    """Σ over ranks of ``x``, on every rank; the backward passes the
    gradient through."""
    return _Reduce.apply(x) if active() else x


def share(x: torch.Tensor) -> torch.Tensor:
    """``x``; the backward sums the gradient over ranks."""
    return _Share.apply(x) if active() else x


def gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (the global
    batch's rows for dim 0); the backward keeps this rank's slice.  Every
    rank's ``x`` has one shape."""
    return _Gather.apply(x, dim) if active() else x


def batch_mean(x: torch.Tensor, total: Optional[int] = None) -> torch.Tensor:
    """The mean of the entries of every rank's ``x``, ``total`` of them (by
    default ``x.numel()`` times the world size), on every rank."""
    if not active():
        return x.mean()
    total = x.numel() * world_size() if total is None else total
    return reduce(x.mean() * (x.numel() / total) if x.numel() else x.sum())


def batch_moments(moments: torch.Tensor, count: int) -> torch.Tensor:
    """Per-channel means (k, C) over this rank's ``count`` entries -> the
    means over every rank's entries (the counts may differ), on every rank;
    differentiable, and exact at world size 1."""
    if not active():
        return moments
    # filled on the device: a host tensor copied in would wait for the stream
    total = _sum(torch.full((1,), float(count), dtype=moments.dtype, device=moments.device))
    if count == 0:  # no rows here (the wrong pairs of a last rank of one row)
        moments = torch.zeros_like(moments)
    return share(reduce(moments * (count / total)))


def next_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows ``g + 1`` of the global batch for this rank's rows ``g``, up to
    the global last row: ``x[1:]`` in one process, and one row fewer than
    ``x`` on the last rank."""
    if not active():
        return x[1:]
    b = x.shape[0]
    start = rank() * b + 1
    return share(gather(x))[start:start + b]


def all_reduce_grads_(grads: Sequence[torch.Tensor]) -> None:
    """Sums each gradient over ranks, in place, in one collective a dtype."""
    if not active() or not grads:
        return
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        tdist.all_reduce(flat, group=_group(flat))
        torch._foreach_copy_(same, [v.view_as(g) for v, g in
                                    zip(flat.split([g.numel() for g in same]), same)])
