"""Device meshes over the ranks of torch.distributed, and the placement
of ciphertext batches on them: the port's counterpart of
`bgn_tpu/parallel/mesh.py`.

The JAX package runs one process over many devices and lets XLA insert
the collectives.  The port runs one process per device (a rank of the
default process group, `parallel/multihost.py`) with explicit
collectives:
  - a mesh is a 1-D `DeviceMesh` over the first n ranks, its one
    dimension named after the axis ("data", or "stage" for the pipeline);
  - a sharded batch is each rank's own rows as plain tensors on its
    device (`shard_ciphertext`), so every scheme op and kernel wrapper
    runs on them unchanged; no DTensor carries a ciphertext, because its
    op dispatch would reach the kernels' ctypes launches;
  - `replicate` broadcasts every tensor of a key from the mesh's first
    rank, in place.
The JAX package's `batch_spec` builds a PartitionSpec; the port has no
PartitionSpec and leaves it out.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"


def _device_type() -> str:
    """The mesh's device type, from the default group's backend: the
    backend was chosen from the device (multihost.initialize)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS):
    """1-D DeviceMesh over the first n_devices ranks of the default process
    group (default: all of them).  Every rank of the group calls it."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "parallel.multihost.initialize first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    return DeviceMesh(_device_type(), torch.arange(n), mesh_dim_names=(axis,))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along the mesh axis; raises outside the mesh."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return mesh.get_local_rank(axis)


def mesh_ranks(mesh) -> list:
    """The global ranks of a 1-D mesh, in mesh order."""
    if mesh.ndim != 1:
        raise ValueError(f"a 1-D mesh, not {mesh}")
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def _local_rows(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    parts = torch.tensor_split(t, axis_size(mesh, axis), dim=dim)
    return parts[axis_rank(mesh, axis)].contiguous()


def shard_ciphertext(ct, mesh, axis: str = DATA_AXIS, batch_dim: int = 0):
    """This rank's contiguous slice of a Ciphertext batch along one batch
    axis (torch.tensor_split over the mesh size).

    L1 ciphertexts are AffinePoint(x[L,*batch], y[L,*batch], inf[*batch]);
    L2 are [2, L, *batch] GT arrays.  batch_dim indexes into the BATCH
    dims (negative ok): 0 shards the leading batch axis (plain DP
    batches); -1 the trailing axis (the poly axis of a (degree, B) polyct
    batch, whose coefficient axis must stay whole for the convolution)."""
    from ..ops.curve import AffinePoint
    from ..scheme import Ciphertext

    nb = len(ct.batch_shape)
    d = batch_dim % nb if nb else 0
    if ct.level2:
        return Ciphertext(_local_rows(ct.data, 2 + d, mesh, axis), True)
    x, y, inf = ct.data
    return Ciphertext(AffinePoint(_local_rows(x, 1 + d, mesh, axis),
                                  _local_rows(y, 1 + d, mesh, axis),
                                  _local_rows(inf, d, mesh, axis)), False)


def shard_poly_ciphertext(pct, mesh, axis: str = DATA_AXIS):
    """This rank's polys of a (degree, B) poly-ciphertext batch: the POLY
    axis is split, the coefficients of a poly stay on one rank (the
    MultPoly convolution's gathers stay local)."""
    from ..polyct import PolyCiphertext
    return PolyCiphertext(shard_ciphertext(pct.ct, mesh, axis=axis,
                                           batch_dim=-1),
                          pct.degree, pct.scale_factor)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.buffers()
        yield from (p.data for p in tree.parameters())
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate(tree, mesh):
    """Broadcast every tensor of a tree (a tensor, an nn.Module's buffers
    and parameters, or lists and tuples of them) from the first rank of a
    1-D mesh to the others, in place; returns the tree."""
    src = mesh_ranks(mesh)[0]
    group = mesh.get_group()
    for t in _tensors(tree):
        buf = t if t.is_contiguous() else t.contiguous()
        dist.broadcast(buf, src=src, group=group)
        if buf is not t:
            t.copy_(buf)
    return tree
