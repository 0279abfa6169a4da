"""Device mesh over ``torch.distributed`` ranks, and the collectives the
port's sharded paths use (port of ``tdspa/parallel/mesh.py``).

JAX expresses its parallelism as a named mesh of devices with XLA-inserted
collectives. The port runs one process per GPU (``torchrun
--nproc_per_node=N``), and a mesh is a 2-D
``torch.distributed.device_mesh.DeviceMesh`` over their ranks:

* ``data`` — batch-parallel (DP): every rank keeps the whole, replicated
  parameters and the gradients are summed over the ranks.
* ``seq`` — set-parallel over the model's long axes: the N support tracks
  (each rank encodes its own; the readout tokens are gathered before the
  latents' cross-attention) and the Q query points (each rank decodes its
  own against the latents).

Every collective runs over a process group of the mesh: NCCL on the GPU,
gloo on the CPU. There is no fallback from one to the other, and a mesh
needs an initialised process group. Gathers are the ``_c10d_functional``
ops, which ``torch.export`` keeps in a traced program.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tdspa_torch.utils.device import resolve_device


def _require_process_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs an initialised torch.distributed process group: launch under "
            "torchrun (the CLIs call maybe_initialize_distributed) or call "
            "torch.distributed.init_process_group first")


def make_mesh(data: int | None = None, seq: int = 1, devices=None,
              axis_names: tuple[str, str] = ("data", "seq")) -> DeviceMesh:
    """Build a 2-D ('data', 'seq') mesh over the process group's ranks.

    Args:
      data: size of the data axis; defaults to n_ranks // seq.
      seq: size of the set-parallel axis.
      devices: explicit list of ranks (defaults to every rank of the group).
      axis_names: mesh axis names.

    Every rank of the process group calls it (it creates the axes' groups).
    The mesh's device type follows the group's backend: "cuda" under NCCL,
    "cpu" under gloo.
    """
    _require_process_group()
    devices = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    n = len(devices)
    if data is None:
        if n % seq:
            raise ValueError(f"{n} devices not divisible by seq={seq}")
        data = n // seq
    if data * seq > n:
        raise ValueError(f"mesh {data}x{seq} needs {data * seq} devices, have {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(devices[: data * seq], dtype=torch.int64).reshape(data, seq)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))


def default_mesh(seq: int = 1) -> DeviceMesh:
    """All ranks, data-parallel-major."""
    return make_mesh(seq=seq)


def maybe_initialize_distributed(device="cuda") -> bool:
    """Initialise the default process group when launched under ``torchrun``
    (``RANK`` and ``WORLD_SIZE`` set; ``MASTER_ADDR``/``MASTER_PORT`` give the
    rendezvous): NCCL for ``device="cuda"``, on GPU ``LOCAL_RANK``; gloo for
    ``device="cpu"``. Otherwise, or when a group exists already, it does
    nothing. Returns whether a process group is initialised.
    """
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position along ``axis``: its rank in the axis's group,
    which is the order gathers over that group concatenate in."""
    return dist.get_rank(mesh.get_group(axis))


def world_group(mesh: DeviceMesh):
    """The group of every rank, for the paths that shard over ('data', 'seq')
    jointly. Such a mesh must hold every rank in rank order, so that a rank's
    joint position ``data_index * seq + seq_index`` is its rank."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"a mesh over ('data', 'seq') jointly must hold every rank in order "
                         f"(0..{dist.get_world_size() - 1}); this one holds {ranks}")
    return dist.group.WORLD


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in the group's rank order
    (the ``_c10d_functional`` all-gather, which ``torch.export`` traces). A
    group of one rank runs it too: the one-GPU check exercises the same
    collectives as a multi-GPU run."""
    out = torch.ops._c10d_functional.all_gather_into_tensor(
        x.movedim(dim, 0).contiguous(), dist.get_world_size(group), group.group_name)
    return torch.ops._c10d_functional.wait_tensor(out).movedim(0, dim)


class _DifferentiableGather(torch.autograd.Function):
    """``gather`` whose backward sums each rank's share of the output's
    gradient over the ranks (a reduce-scatter): the gradient of the sum of
    every rank's loss."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        group, dim = ctx.group, ctx.dim
        out = torch.ops._c10d_functional.reduce_scatter_tensor(
            grad.movedim(dim, 0).contiguous(), "sum", dist.get_world_size(group),
            group.group_name)
        return torch.ops._c10d_functional.wait_tensor(out).movedim(0, dim), None, None


def gather_differentiable(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``gather`` under autograd (training's ``seq`` axis)."""
    return _DifferentiableGather.apply(x, group, dim)


def mesh_sum(tensors: list[torch.Tensor], mesh: DeviceMesh) -> list[torch.Tensor]:
    """The sums over every rank of ``mesh`` of each of ``tensors`` (new f32
    tensors; no autograd): one all-reduce per axis of their concatenation."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    for axis in mesh.mesh_dim_names:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset : offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


@torch.no_grad()
def replicate(tensors, mesh: DeviceMesh) -> None:
    """Overwrite ``tensors`` (e.g. the parameters) on every rank of ``mesh``
    with those of its first rank, in place: along ``seq`` from each row's
    first rank, then along ``data`` from the first row."""
    grid = mesh.mesh
    row, col = (grid == dist.get_rank()).nonzero()[0].tolist()
    for axis, src in (("seq", grid[row, 0]), ("data", grid[0, col])):
        for t in tensors:
            dist.broadcast(t, src=int(src), group=mesh.get_group(axis))
