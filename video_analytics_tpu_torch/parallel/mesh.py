"""Processes, record shards and collectives: the port's communication layer.

Port of ``video_analytics_tpu/parallel/mesh.py`` for one process per
device.  The reference expresses parallelism as a ``jax.sharding.Mesh``
and leaves the collectives to XLA; here each process drives one device
and joins a ``torch.distributed`` group (NCCL between CUDA devices, gloo
on the CPU), and the few collectives the loops need are called by name.
Without a group every function below is the one-process identity.

The reference's functions and their counterparts:

- ``jax.distributed.initialize`` → ``init_distributed`` (a TCP rendezvous at
  process 0's ``host:port``, a finite timeout) and ``shutdown``;
- ``jax.process_index`` / ``jax.process_count`` → ``process_index`` /
  ``process_count``;
- ``process_local_records``, ``pad_to_multiple``: the same functions;
- ``global_batch_size``: the same rounding with one device per process, so
  the mesh's data axis is the world size;
- ``make_mesh``, ``data_sharding``, ``replicated``, ``shard_batch``,
  ``assemble_global_batch``: no counterpart.  A process holds only its own
  rows of a batch and a copy of the weights (of its block of an ``fc``
  split over the model axis); there is no mesh to build and no global
  array to assemble;
- XLA's psum of a sharded reduction → ``all_reduce_sum`` (differentiable:
  the BatchNorm statistics of a training batch are sums over the group);
- ``runtime/train.shard_train_inputs`` (parameters replicated, the batch
  sharded, the gradient psum inserted by XLA) → ``broadcast_from_first``
  once at the start and ``average_gradients`` after each backward pass;
- the mesh's ``model`` axis → ``model_parallel_groups``: the reference's
  mesh is ``devices.reshape(n // mp, mp)``, so a model group is `mp`
  consecutive ranks and a rank's data index is ``rank // mp``;
- ``model_sharding`` → ``model_sharding``: this rank's block of a tensor
  along one dimension;
- ``shard_dense_over_model`` (a placement that XLA partitions) →
  ``shard_dense_over_model``: every ``fc`` ``nn.Linear`` whose width
  divides becomes a ``ColumnParallelLinear``, which computes its block of
  the outputs and all-gathers them over the model group.  No command
  takes a flag for it, as none of the reference's does.
"""

from __future__ import annotations

import datetime
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from video_analytics_tpu_torch.ops.layers import linear
from video_analytics_tpu_torch.utils.device import require_cuda

# How long a collective or the rendezvous waits for the other processes
# before it raises.
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: str) -> torch.device:
    """Join the group of `num_processes` processes whose process 0 listens
    at `coordinator` (``host:port``) as process `process_id`, and return
    this process's device.  A CUDA `device` without an index is
    ``cuda:{process_id % device_count}``, one card per process on a host;
    a named index is taken as it is.  NCCL joins CUDA devices, gloo CPUs."""
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside "
                         f"[0, {num_processes})")
    dev = require_cuda(device)
    backend = "gloo"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=TIMEOUT,
        **({"device_id": dev} if backend == "nccl" else {}))
    return dev


def shutdown() -> None:
    """Leave the group (nothing without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return _rank()


def process_count() -> int:
    """The number of processes in the group (1 without one)."""
    return _world()


def process_local_records(records: Sequence,
                          process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> List:
    """This process's shard of a global record list: round-robin, so shard
    sizes differ by at most one.  Each process decodes only its own
    records."""
    if process_index is None:
        process_index = _rank()
    if process_count is None:
        process_count = _world()
    return list(records)[process_index::process_count]


def global_batch_size(requested: int,
                      process_count: Optional[int] = None) -> int:
    """Round a requested global batch up so that it splits evenly over the
    processes (the reference's two constraints, the mesh's data axis and
    the process count, are one with a device per process)."""
    if process_count is None:
        process_count = _world()
    return ((requested + process_count - 1) // process_count) * process_count


def pad_to_multiple(x: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis up to a multiple by repeating the last row;
    returns (padded, original_length)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = np.repeat(x[-1:], rem, axis=0)
    return np.concatenate([x, pad], axis=0), n


class _SumOverGroup(torch.autograd.Function):
    """Out-of-place all-reduce (sum).  Every process's loss depends on the
    sum, so the gradient reaching a process's input is the sum over the
    group of the gradients at the output: the backward pass is the same
    all-reduce."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the group, the same tensor on every process
    (`t` itself without a group).  Differentiable."""
    if not dist.is_initialized():
        return t
    return _SumOverGroup.apply(t)


def broadcast_from_first(tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite each tensor in place with process 0's (a module's
    parameters and buffers, so that every process starts from the same
    weights and statistics)."""
    if process_count() == 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.detach(), src=0)


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each parameter's gradient by its mean over the group, in one
    all-reduce of the gradients laid end to end.  After a backward pass of
    each process's mean loss over its own rows (the same row count on
    every process), this is the gradient of the mean loss over the global
    batch."""
    world = process_count()
    if world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    with torch.no_grad():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def global_mean(values: torch.Tensor) -> torch.Tensor:
    """The mean over the group of each process's `values` (the same
    tensor on every process; `values` itself without a group)."""
    if not dist.is_initialized():
        return values
    return all_reduce_sum(values) / dist.get_world_size()



# -- the model axis -----------------------------------------------------------

def model_parallel_groups(model_parallel: int
                          ) -> Optional[dist.ProcessGroup]:
    """Split the processes into model groups of `model_parallel`
    consecutive ranks (the reference's ``(data, model)`` mesh: rank r sits
    at data index ``r // model_parallel``) and return this rank's group.
    Every rank creates every group, in one order, as ``new_group``
    requires.  None without a process group."""
    world = _world()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} processes not divisible by "
                         f"model_parallel={model_parallel}")
    if not dist.is_initialized():
        return None
    groups = [dist.new_group(list(range(first, first + model_parallel)))
              for first in range(0, world, model_parallel)]
    return groups[_rank() // model_parallel]


def _group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def model_sharding(t: torch.Tensor, group: Optional[dist.ProcessGroup],
                   dim: int = -1) -> torch.Tensor:
    """This rank's block of `t` along `dim`: the i-th of `group`'s size
    equal blocks for the rank at index i of the group (a view)."""
    size = _group_size(group)
    if t.shape[dim] % size:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {size} model ranks")
    block = t.shape[dim] // size
    index = 0 if group is None else dist.get_rank(group)
    return t.narrow(dim, index * block, block)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group, since each rank's output block reaches the input through
    its own columns of the weight only."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the ranks' output blocks along the last dimension;
    the backward is this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(_group_size(group))]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return model_sharding(grad, ctx.group).contiguous(), None


class ColumnParallelLinear(nn.Module):
    """An ``nn.Linear`` split by output columns over a model group: it
    holds this rank's block of ``weight`` (out, in) and ``bias``, computes
    its block of the outputs and all-gathers the whole row.  Forward and
    gradients equal the whole layer's (each rank's gradient is that of its
    own block).  It computes in the dtype of the layer it replaces
    (``ops/layers.Linear``), with float32 parameters."""

    def __init__(self, linear: nn.Linear, group: dist.ProcessGroup):
        super().__init__()
        self.group = group
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        self.dtype = getattr(linear, "dtype", torch.float32)
        self.weight = nn.Parameter(
            model_sharding(linear.weight.detach(), group, 0).clone())
        self.bias = (None if linear.bias is None else nn.Parameter(
            model_sharding(linear.bias.detach(), group, 0).clone()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.group)
        return _GatherFromModel.apply(
            linear(x, self.weight, self.bias, self.dtype), self.group)


def shard_dense_over_model(model: nn.Module,
                           group: Optional[dist.ProcessGroup]) -> nn.Module:
    """Split every ``fc`` ``nn.Linear`` of `model` whose ``out_features``
    divides by the model group's size into a ``ColumnParallelLinear``, in
    place, and return `model`.  An ``fc`` whose width does not divide (an
    odd class count) stays whole, as the reference's rule leaves it
    replicated; so does every ``fc`` with a group of one or none."""
    size = _group_size(group)
    if size == 1:
        return model
    for parent in list(model.modules()):
        fc = getattr(parent, "fc", None)
        if isinstance(fc, nn.Linear) and fc.out_features % size == 0:
            parent.fc = ColumnParallelLinear(fc, group)
    return model
