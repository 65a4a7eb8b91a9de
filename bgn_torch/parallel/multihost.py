"""Multi-process start-up and process-aware meshes and batches: the
port's counterpart of `bgn_tpu/parallel/multihost.py`.

The JAX package joins every host to one runtime
(jax.distributed.initialize) and builds global arrays over the global
device list.  The port runs one process per device:

  1. every process calls `initialize()`, which starts the default
     process group: NCCL for device="cuda", gloo for device="cpu" (the
     argument decides, never what is installed), and for "cuda" binds the
     process to its card;
  2. `make_global_mesh()` lays all ranks on a DeviceMesh;
  3. each rank keeps its own rows of a batch as plain tensors
     (`global_ciphertext_from_local`), on which every scheme op and the
     giant-step-sharded BSGS of parallel/sharded.py run.  A DTensor view
     of a plain array (`global_array_from_local`, `local_values`) is
     available where no kernel reads it.

Nothing here picks an address or a rank: pass them, or run under
torchrun (env://).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, _device_type, axis_size

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               device: str = "cuda") -> None:
    """Start the default process group for this process.

    coordinator_address: "host:port" of rank 0 (a tcp:// store), a URL
    with its own scheme ("tcp://...", "file://...") used as it is, or
    None for env:// (torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK).  device: "cuda" (NCCL; the card is local_device_ids[0], else
    LOCAL_RANK, else 0) or "cpu" (gloo)."""
    if device not in _BACKENDS:
        raise ValueError(f"device={device!r}: \"cuda\" or \"cpu\"")
    if device == "cuda":
        if local_device_ids:
            card = int(local_device_ids[0])
        else:
            card = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(card)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        _BACKENDS[device], init_method=init_method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id))


def process_info() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def make_global_mesh(shape: Optional[Tuple[int, ...]] = None,
                     axis_names: Tuple[str, ...] = (DATA_AXIS,)):
    """DeviceMesh over every rank (default: one 'data' axis), rank-major,
    so the FIRST axis crosses hosts: shard the batch along it."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call initialize "
                           "first")
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh shape {shape} != {world} global ranks")
    return init_device_mesh(_device_type(), shape,
                            mesh_dim_names=tuple(axis_names))


def global_array_from_local(mesh, local: torch.Tensor,
                            batch_axis_pos: int = 0,
                            axis: str = DATA_AXIS):
    """This rank's rows of a batch -> one DTensor sharded along
    batch_axis_pos over `axis` (the rows of every rank, concatenated in
    rank order, are the global batch; each rank holds as many)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    placements = [Shard(batch_axis_pos) if name == axis else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements, run_check=False)


def local_values(arr, batch_axis_pos: int = 0) -> torch.Tensor:
    """This rank's rows of a batch-sharded DTensor (the inverse of
    global_array_from_local); a plain tensor is its own rows."""
    from torch.distributed.tensor import DTensor
    return arr.to_local() if isinstance(arr, DTensor) else arr


def _rest_shape(shape, batch_axis_pos: int) -> tuple:
    return tuple(s for i, s in enumerate(shape) if i != batch_axis_pos)


def global_ciphertext_from_local(pk, mesh, local_ct, axis: str = DATA_AXIS):
    """This rank's Ciphertext rows as the rank's share of one global batch:
    the rows on the key's device, after a check across the ranks of
    `axis` that every rank holds the same level and the same dimensions
    but the batch axis.  Each process encrypts its own rows (its host
    CSPRNG stays its own, as a reference caller's would)."""
    from ..ops.curve import AffinePoint
    from ..scheme import Ciphertext

    device = pk.dev.n_bits.device
    if local_ct.level2:
        rest = ("L2",) + _rest_shape(local_ct.data.shape, 2)
    else:
        rest = ("L1",) + _rest_shape(local_ct.data.x.shape, 1)
    seen = [None] * axis_size(mesh, axis)
    dist.all_gather_object(seen, rest, group=mesh.get_group(axis))
    if any(r != rest for r in seen):
        raise ValueError(f"the ranks' ciphertext batches differ beyond "
                         f"the batch axis: {seen}")
    if local_ct.level2:
        return Ciphertext(local_ct.data.to(device), True)
    return Ciphertext(AffinePoint(*(t.to(device) for t in local_ct.data)),
                      False)
