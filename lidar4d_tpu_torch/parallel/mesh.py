"""Ray-parallel layouts of a torch.distributed process group.

Port of `lidar4d_tpu/parallel/mesh.py`. The reference runs one process over
many devices and lets GSPMD partition its jitted step from sharding
annotations. Here, as is usual in PyTorch, every device has a process of its
own (a rank, on the device `rank_device` names), and the collectives are
explicit:

  * `init_distributed` starts the process group from the same
    LIDAR4D_COORDINATOR / LIDAR4D_NUM_PROCS / LIDAR4D_PROC_ID variables (or
    arguments): NCCL for CUDA devices, gloo for the CPU, or the backend
    named;
  * a `Mesh` is a layout of the group's ranks: 1-D over "data"
    (`make_mesh`), or (dcn, ici) with hosts as rows
    (`make_hierarchical_mesh`), whose sums are reduced among each host's
    ranks first and across hosts after;
  * `shard_rays` gives a rank its contiguous block of the leading (ray)
    axis; the blocks follow the ranks row-major over the layout, so on the
    (dcn, ici) layout rays split over both axes jointly, as the reference's
    `_ray_spec` splits them;
  * `gather_rays` is an all-gather whose backward sums the ranks'
    cotangents and keeps the rank's own rows (the gather's adjoint): a term
    that every rank computes from gathered operands and weights by 1 / size
    then gets its whole gradient once the gradients are summed;
  * `replicate` broadcasts a tree's tensors from rank 0.

Each takes `mesh=None` for one process and then returns its input unchanged.
The gather is an all-reduce of a zero-filled buffer in which each rank writes
its own slot (x + 0 is exact), and its backward the same all-reduce: the
all-reduce is the one collective that every backend documents for every
device (gloo's documented CUDA collectives are broadcast and all-reduce),
and the step's and the render's gathered operands are small (a few
thousand rays' outputs).
"""

import math
import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from lidar4d_tpu_torch.interop import tree_leaves

DATA_AXIS = "data"
DCN_AXIS = "dcn"  # across hosts
ICI_AXIS = "ici"  # among one host's devices


@dataclass(frozen=True)
class Mesh:
    """A layout of the process group's ranks.

    axis_names / shape: the axes and the ranks along each; rank: this
    process's place, row-major over `shape` (its rank in the group); groups:
    the process groups a sum is reduced over, in turn (None: the whole
    group).
    """

    axis_names: tuple
    shape: tuple
    rank: int
    groups: tuple = (None,)

    @property
    def size(self):
        return math.prod(self.shape)


def default_backend(device):
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank=None):
    """The device of a rank: for CUDA without an index, the card at the
    rank's place among its host's cards (rank modulo the card count, ranks
    numbered host by host); any other device as it is given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(coordinator=None, num_processes=None, process_id=None, backend=None,
                     device="cuda"):
    """Join a process group: this process is rank `process_id` of
    `num_processes`, meeting the others at `coordinator` ("host:port", or a
    tcp:// or file:// address). Missing arguments come from
    LIDAR4D_COORDINATOR / LIDAR4D_NUM_PROCS / LIDAR4D_PROC_ID; with neither
    a coordinator nor a process count this is a no-op. The backend follows
    `device` (`default_backend`) unless named, and a CUDA rank's card
    (`rank_device`) becomes the current one.

    Returns True iff a process group was started.
    """
    coordinator = coordinator or os.environ.get("LIDAR4D_COORDINATOR")
    if num_processes is None and os.environ.get("LIDAR4D_NUM_PROCS"):
        num_processes = int(os.environ["LIDAR4D_NUM_PROCS"])
    if process_id is None and os.environ.get("LIDAR4D_PROC_ID"):
        process_id = int(os.environ["LIDAR4D_PROC_ID"])
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs a coordinator, a process count and a process "
                         "id (LIDAR4D_COORDINATOR, LIDAR4D_NUM_PROCS, LIDAR4D_PROC_ID); got "
                         f"{coordinator!r}, {num_processes!r}, {process_id!r}")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device, process_id))
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or default_backend(device), init_method=init,
                            world_size=num_processes, rank=process_id)
    return True


def world_and_rank():
    """(size, rank) of the process group; raises without one."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: init_distributed (LIDAR4D_* "
                           "variables) or torch.distributed.init_process_group")
    return dist.get_world_size(), dist.get_rank()


def make_mesh(n_devices=0):
    """1-D data layout over the group's ranks, one rank per device;
    `n_devices` is 0 (every rank) or the group's size."""
    world, rank = world_and_rank()
    if n_devices and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} ranks, one a device; "
                         f"the process group has {world}")
    return Mesh((DATA_AXIS,), (world,), rank)


def make_hierarchical_mesh(n_hosts=0, per_host=0):
    """(dcn, ici) layout: rows are hosts, columns a host's ranks. n_hosts 0:
    the hosts the ranks run on (their host names, which must come host by
    host); per_host 0: the group's size over n_hosts. A sum is reduced over
    each host's ranks, then across the hosts."""
    world, rank = world_and_rank()
    if n_hosts <= 0:
        names = [None] * world
        dist.all_gather_object(names, socket.gethostname())
        hosts = [n for i, n in enumerate(names) if i == 0 or n != names[i - 1]]
        if len(hosts) != len(set(hosts)):
            raise ValueError(f"ranks are not numbered host by host: {names}")
        n_hosts = len(hosts)
    if per_host <= 0:
        per_host = world // n_hosts
    if n_hosts * per_host != world:
        raise ValueError(f"a {n_hosts} x {per_host} mesh does not cover the group's {world} "
                         "ranks")
    # every rank makes every group, in the same order
    ici = [dist.new_group(list(range(h * per_host, (h + 1) * per_host))) for h in range(n_hosts)]
    dcn = [dist.new_group(list(range(c, world, per_host))) for c in range(per_host)]
    return Mesh((DCN_AXIS, ICI_AXIS), (n_hosts, per_host), rank,
                (ici[rank // per_host], dcn[rank % per_host]))


def all_reduce(mesh, tensor):
    """Sum `tensor` over the mesh's ranks, in place; returns it."""
    if mesh is not None:
        for group in mesh.groups:
            dist.all_reduce(tensor, group=group)
    return tensor


def barrier(mesh):
    """Wait for every rank of the mesh."""
    if mesh is not None:
        dist.barrier()


def _one_or_tuple(out):
    return tuple(out) if len(out) > 1 else out[0]


def shard_rays(mesh, *tensors):
    """Each tensor's (or sequence's) rows of this rank: the rank's
    contiguous block of the leading axis, which must split evenly over the
    mesh."""
    if mesh is None:
        return _one_or_tuple(tensors)
    out = []
    for t in tensors:
        n = len(t)
        if n % mesh.size:
            raise ValueError(f"{n} rows do not split evenly over {mesh.size} ranks")
        block = n // mesh.size
        out.append(t[mesh.rank * block:(mesh.rank + 1) * block])
    return _one_or_tuple(out)


class _GatherRays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        n = x.shape[0]
        out = x.new_zeros((mesh.size * n, *x.shape[1:]))
        out[mesh.rank * n:(mesh.rank + 1) * n] = x
        return all_reduce(mesh, out)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        grad = all_reduce(mesh, grad.clone(memory_format=torch.contiguous_format))
        n = grad.shape[0] // mesh.size
        return grad[mesh.rank * n:(mesh.rank + 1) * n], None


def gather_rays(mesh, *tensors):
    """Every rank's blocks of each tensor, in rank order (the inverse of
    `shard_rays`); differentiable, see the module docstring."""
    if mesh is None:
        return _one_or_tuple(tensors)
    return _one_or_tuple([_GatherRays.apply(t, mesh) for t in tensors])


@torch.no_grad()
def replicate(mesh, tree):
    """Rank 0's values of every tensor of `tree`, broadcast in place (other
    leaves are left as they are); returns the tree."""
    if mesh is not None:
        for t in tree_leaves(tree):
            if torch.is_tensor(t):
                dist.broadcast(t, src=0)
    return tree


def broadcast_object(mesh, obj):
    """Rank 0's `obj` (any picklable object) on every rank."""
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
