"""Mesh/sharding layer on torch.distributed: data-parallel batches,
giant-step-sharded BSGS and the pipelined pairing."""
from .mesh import make_mesh, shard_ciphertext, replicate, DATA_AXIS  # noqa
