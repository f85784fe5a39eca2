"""Process groups and the batch layout of data- and tensor-parallel runs
(the JAX package's parallel/mesh.py, on torch.distributed).

The JAX package runs one process over every local chip and lets GSPMD
insert the collectives.  The port runs one process per device, as a
`torchrun` launch does (RANK, WORLD_SIZE and LOCAL_RANK in the
environment): NCCL between CUDA devices, gloo between CPU processes.  A
`Mesh` is one process's view of the launch: the world size and its rank,
the data- and tensor-parallel sizes, its index in each, the two process
groups it belongs to, and its device.

The rank layout is JAX's grid reshape `(n // tp, tp)`, row major: rank
`d * tp + t` sits at data index d and model index t, so consecutive ranks
form one tensor-parallel group, and the ranks of one model index form a
data-parallel group.  A data-parallel run is a change of layout, not of
numbers: the collectives below are what GSPMD inserts for the same step.
"""

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: str = "gloo",
                           init_method: Optional[str] = None):
    """Join this process to a launch of `num_processes` (JAX's
    `jax.distributed.initialize`): `init_process_group` with
    `init_method` (e.g. `file://<path>`, which needs no port), else
    `tcp://<coordinator_address>`.  A no-op for one process or none, as in
    JAX.  A failed rendezvous raises."""
    if num_processes is None or num_processes <= 1:
        return
    if init_method is None:
        if not coordinator_address:
            raise ValueError("initialize_distributed needs a "
                             "coordinator_address or an init_method")
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def launch_world_size() -> int:
    """The launch's world size: the process group's if one is up, else
    torchrun's WORLD_SIZE, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_device(device) -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` (made current) for a CUDA
    launch, else the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    index = (device.index if device.index is not None
             else int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def init_from_env(device):
    """Bring up the default process group for a run on `device`, once:
    from torchrun's environment (`env://`) where RANK and WORLD_SIZE are
    set, else as a world of one rank (an in-process store, no port)."""
    if dist.is_initialized():
        return
    backend = backend_for(device)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


@dataclass
class Mesh:
    """One rank's place in a (dp x tp) launch.  `dp_group` holds the ranks
    of this model index (the batch is split over them); `tp_group` those of
    this data index (the transformer blocks are split over them), or None
    when tp is 1."""

    world: int
    rank: int
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: object
    tp_group: object
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(model_parallelism: int = 1, device="cpu") -> Mesh:
    """This rank's Mesh over the default process group (which must be up):
    tp = `model_parallelism`, dp = world // tp.  Every rank creates every
    group, in one order, as `new_group` requires."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed or init_from_env first")
    n, rank = dist.get_world_size(), dist.get_rank()
    tp = int(model_parallelism)
    if tp < 1 or n % tp:
        raise ValueError(f"model_parallelism {tp} does not divide the world "
                         f"of {n} ranks")
    dp = n // tp
    if tp == 1:
        dp_group, tp_group = dist.group.WORLD, None
    else:
        tp_group = dp_group = None
        for d in range(dp):  # consecutive ranks: one tp group
            g = dist.new_group(list(range(d * tp, (d + 1) * tp)))
            if rank // tp == d:
                tp_group = g
        for t in range(tp):  # one model index: one dp group
            g = dist.new_group(list(range(t, n, tp)))
            if rank % tp == t:
                dp_group = g
    return Mesh(world=n, rank=rank, dp=dp, tp=tp, dp_rank=rank // tp,
                tp_rank=rank % tp, dp_group=dp_group, tp_group=tp_group,
                device=torch.device(device))


@dataclass(frozen=True)
class RowShard:
    """Rows `[index * n / count, (index + 1) * n / count)` of a leading
    axis of n rows."""

    index: int
    count: int

    def rows(self, x):
        n = x.shape[0]
        per, rem = divmod(n, self.count)
        if rem:
            raise ValueError(f"global batch size {n} must divide evenly "
                             f"across {self.count} processes")
        return x[self.index * per:(self.index + 1) * per]


def data_sharding(mesh: Mesh) -> RowShard:
    """This rank's contiguous rows of the leading (batch) axis."""
    return RowShard(mesh.dp_rank, mesh.dp)


def replicated_sharding(mesh: Mesh) -> RowShard:
    """Every row on every rank."""
    return RowShard(0, 1)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every leaf (numpy array or tensor) of a batch of
    nested dicts."""
    from ..data.pipeline import _tree_map

    return _tree_map(data_sharding(mesh).rows, batch)


# -------------------------------------------------------------- collectives
def all_reduce_(x, group, op=dist.ReduceOp.SUM):
    """`dist.all_reduce` in place; a 16-bit float sums in f32 (a bf16
    partial sum rounded twice would not be the one-device sum)."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        dist.all_reduce(x, op=op, group=group)
        return x
    wide = x.float()
    dist.all_reduce(wide, op=op, group=group)
    return x.copy_(wide)


def sum_partials(partials, device):
    """The partials summed on `device` in rank order, the in-process
    all-reduce of tensor-parallel serving (no process group): a 16-bit
    partial sums in f32 and the sum is cast back, as `all_reduce_`."""
    dtype = partials[0].dtype
    wide = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
    total = partials[0].to(device, wide)
    for p in partials[1:]:
        total = total + p.to(device, wide)
    return total.to(dtype)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group, with autograd: every rank uses the sum, so
    its gradient is the sum of the ranks' upstream gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward, the all-reduce backward (each
    rank's shard of the next product sends back its part of the input's
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the all-reduce forward (the partial products of a
    row-split product summed), the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x, group):
    """Differentiable sum of x over `group`."""
    return _AllReduceSum.apply(x, group)


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def collective_device() -> torch.device:
    """Where a small collective's tensor lives: the current CUDA device
    under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s `obj` on every rank (a pickled object)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier():
    """Every rank waits here; under NCCL on its current device."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
