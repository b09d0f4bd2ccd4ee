"""Data-parallel sharding of the sample axis over several devices."""

from .mesh import (replicate, sample_mesh, shard_samples, sharded_batch_fn,
                   sharded_call)

__all__ = ["replicate", "sample_mesh", "shard_samples", "sharded_batch_fn",
           "sharded_call"]
