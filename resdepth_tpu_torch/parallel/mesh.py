"""Process groups for data-parallel training and tiled inference, and the
all-reduces over them.

Port of ``resdepth_tpu/parallel/mesh.py``. A JAX mesh over devices becomes
a ``torch.distributed`` group over processes, one process per GPU
(``parallel.bootstrap``). The steps shard batches over the group's ranks
and all-reduce gradients, BatchNorm statistics, loss denominators and
scene canvases over it. ``None`` stands for one process without a group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

DATA_AXIS = "data"
DCN_AXIS = "dcn"


def device_count() -> int:
    """The world size: 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def data_mesh(n_devices: int | None = None):
    """A group over the first ``n_devices`` ranks (all by default): the
    world itself when that is all of it. Without a process group, ``None``
    (one process, nothing to reduce). Every rank must call it."""
    world = device_count()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a group of {n} ranks in a world of {world}")
    if not dist.is_initialized():
        return None
    return dist.group.WORLD if n == world else dist.new_group(ranks=list(range(n)))


def data_mesh_2d(n_slices: int, n_devices: int | None = None):
    """The JAX package's (slices x per-slice) mesh. Its steps shard batches
    over both axes and reduce over both, which over ranks is one flat
    all-reduce: the same group as ``data_mesh``, after the same check."""
    n = device_count() if n_devices is None else n_devices
    if n % n_slices != 0:
        raise ValueError(f"{n} devices not divisible into {n_slices} slices")
    return data_mesh(n)


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def size(group) -> int:
    """Ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place, outside autograd; returns it."""
    if group is not None:
        dist.all_reduce(tensor, group=group)
    return tensor


def _p2p_device(device, group) -> torch.device:
    """Where a point-to-point tensor must lie: NCCL sends device tensors,
    gloo host ones (its send and recv take no CUDA tensor, unlike its
    all-reduce and broadcast)."""
    return torch.device(device) if dist.get_backend(group) == "nccl" else torch.device("cpu")


def send(tensor: torch.Tensor, dst: int, group) -> None:
    """Send ``tensor`` to rank ``dst`` of ``group`` (through host memory
    under gloo)."""
    dist.send(tensor.to(_p2p_device(tensor.device, group)).contiguous(), dst=dst,
              group=group)


def recv(shape, src: int, group, device) -> torch.Tensor:
    """A float32 tensor of ``shape`` from rank ``src`` of ``group``, on
    ``device`` under NCCL and on the host under gloo."""
    out = torch.empty(tuple(shape), dtype=torch.float32,
                      device=_p2p_device(device, group))
    dist.recv(out, src=src, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """A differentiable sum over the group. Each rank's output is the sum
    of every rank's input, so a rank's input reaches every rank's loss: its
    gradient is the sum of all ranks' output gradients, the transpose of
    the JAX ``psum``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, with gradients (``x`` itself for None)."""
    return x if group is None else _AllReduceSum.apply(x, group)
