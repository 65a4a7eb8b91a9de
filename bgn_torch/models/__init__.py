"""Application-level encrypted workloads built on the scheme primitives."""
from . import aggregation, encrypted_dot  # noqa: F401
