"""The (data, edge) mesh on ``torch.distributed``: the port of
``dpvo_tpu/parallel/shard.py``.

The JAX package lays a ``(data, edge)`` mesh over one process's devices
and annotates arrays: ``data`` shards a training batch's clips, ``edge``
the patch graph's edges, and XLA inserts the collectives. The port runs
one process per device: every rank runs the same program on the same
replicated inputs, takes its own slice of what a mesh axis shards
(``local_clips`` for ``data``, ``edge_range`` for ``edge``) and sums
partial results over that axis's process group with ``all_reduce``
(``dist_ba_delta``, ``ba/gba_sparse.dist_gba``, the train step's
gradients). A mesh reaches the code that uses it as an explicit ``mesh=``
argument: the JAX package's ``mesh_context`` switches on its layout
annotations, which the port does not have.

Training splits each clip's unroll over the edge axis (``edge_split``):
each rank computes the edges of the patches it owns (``owned_edges``), and
what crosses ranks goes through ``all_sum`` (differentiable) or
``all_max`` (a softmax's shift, no gradient).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from dpvo_tpu_torch.parallel.multihost import process_local_batch

def make_mesh(n_data: int = 1, n_edge: Optional[int] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """The (data, edge) ``DeviceMesh`` over the process group's ranks (one
    device each): rank r sits at (r // n_edge, r % n_edge). n_edge defaults
    to the world size over n_data; n_data * n_edge must be the world size.
    device_type: ``cuda`` for an NCCL group, else ``cpu`` (a gloo group may
    still reduce CUDA tensors)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (parallel.multihost.init_distributed, "
                           "or run under torchrun)")
    world = dist.get_world_size()
    if n_edge is None:
        n_edge = world // n_data
    if n_data * n_edge != world:
        raise ValueError(f"make_mesh: a ({n_data}, {n_edge}) mesh needs {n_data * n_edge} "
                         f"processes, the group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_edge), mesh_dim_names=("data", "edge"))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> Tuple[int, int]:
    """(this rank's index on a mesh axis, the axis's size); (0, 1) without
    a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def edge_rank(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """``axis_rank`` of the edge axis."""
    return axis_rank(mesh, "edge")


def edge_range(n: int, mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """This rank's contiguous [start, stop) of n edge-side items: the edge
    axis's k ranks split them in order, sizes differing by at most one.
    Without a mesh, all of them. (The JAX package's ``edge_shard`` only
    hints a layout; here each rank computes on its slice.)"""
    r, k = edge_rank(mesh)
    return n * r // k, n * (r + 1) // k


def local_clips(batch: Dict[str, object], mesh: Optional[DeviceMesh]) -> Dict[str, object]:
    """This data rank's clips of a global batch (arrays with the clip axis
    first): the JAX package's ``data_sharding``. The batch must split evenly
    over the data axis."""
    if mesh is None:
        return batch
    r, k = axis_rank(mesh, "data")
    n = process_local_batch(len(next(iter(batch.values()))), k)
    return {name: v[r * n:(r + 1) * n] for name, v in batch.items()}


@torch.no_grad()
def replicate(nets: torch.nn.Module, mesh: Optional[DeviceMesh]) -> torch.nn.Module:
    """Every parameter and buffer of nets broadcast from global rank 0, in
    place (the JAX package's ``replicated`` placement)."""
    if mesh is not None:
        for t in nets.state_dict().values():
            dist.broadcast(t, src=0)
    return nets


class _AllSum(torch.autograd.Function):
    """all_reduce SUM over a process group, whose adjoint is the same
    all_reduce of the gradient: where each rank's loss is its share of the
    whole, the gradient of a sum that every rank holds is the sum of the
    ranks' gradients (``torch.distributed.nn.functional.all_reduce``
    computes the same and is deprecated)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return None, g


def all_sum(mesh: DeviceMesh, axis: str):
    """(x1, ..., xn) -> (their sums over the mesh axis's ranks): the port's
    ``psum``, one ``all_reduce`` of the tensors' concatenation (of the one
    tensor), differentiable (``_AllSum``). The ``allsum`` of
    ``ba/solver.assemble_normal_eqs`` and ``ba/gba_sparse.gba``, whose
    default ``no_sum`` is one rank's."""
    group = mesh.get_group(axis)

    def allsum(*xs):
        if len(xs) == 1:
            return (_AllSum.apply(group, xs[0]),)
        flat = _AllSum.apply(group, torch.cat([x.reshape(-1) for x in xs]))
        return tuple(f.reshape(x.shape) for f, x in zip(flat.split([x.numel() for x in xs]), xs))

    return allsum


def all_max(mesh: DeviceMesh, axis: str):
    """x -> its elementwise maximum over the mesh axis's ranks, without a
    gradient (a softmax's shift, on which the softmax does not depend)."""
    group = mesh.get_group(axis)

    def allmax(x):
        x = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
        return x

    return allmax


def owned_edges(kk: np.ndarray, rank: int, size: int) -> np.ndarray:
    """The edges (indices into kk, in order) that rank ``rank`` of an edge
    axis of ``size`` ranks owns in a split training unroll: those of the
    patches kk with kk % size == rank. A patch's edges then stay on one rank
    (the update operator's temporal neighbours, SoftAgg by patch and BA's
    depth blocks need no other rank), and since every patch of a frame has
    the same edges in ``models/vonet.build_schedule``, a rank holds the
    same share of every step's edges once PATCHES_PER_FRAME is a multiple
    of ``size``. The JAX package's ``edge_shard`` splits the edge axis into
    contiguous blocks; the values do not depend on the split, only the
    order of the sums that cross ranks."""
    return np.nonzero(np.asarray(kk) % size == rank)[0]


class EdgeSplit(NamedTuple):
    """A rank's part in a training unroll split over the mesh's edge axis:
    its index on the axis, the axis's size, and the axis's ``all_sum``
    (differentiable) and ``all_max`` (no gradient)."""

    rank: int
    size: int
    sum: Callable
    max: Callable


def edge_split(mesh: Optional[DeviceMesh]) -> Optional[EdgeSplit]:
    """The split of the mesh's edge axis; None without a mesh or with one
    rank on the axis (the unsplit unroll)."""
    r, k = edge_rank(mesh)
    if k == 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(f"edge_split: an edge axis of {k} ranks needs a process group")
    return EdgeSplit(r, k, all_sum(mesh, "edge"), all_max(mesh, "edge"))
