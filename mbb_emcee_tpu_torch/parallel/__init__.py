"""Multi-device scaling: walker-axis and source-axis sharding over a 1-D
device mesh.

Torch twin of mbb_emcee_tpu/parallel. One process drives every device of
the mesh (the JAX package's single-controller model): a mesh is an ordered
list of torch devices, each shard's tensors live on its device, and the
stretch move's cross-half dependency -- the other half-ensemble, nhalf x
ndim fp32 per half-step -- is gathered by copying the shards' blocks
device to device (peer copies over NVLink on a multi-card host). A mesh may
repeat one device: the shards then keep separate tensors on it and take
the same code path, which is how the tests run a mesh on the CPU.
"""

from mbb_emcee_tpu_torch.parallel.mesh import walker_mesh
from mbb_emcee_tpu_torch.parallel.sharded_sampler import (
    ShardedEnsembleSampler)

__all__ = ["walker_mesh", "ShardedEnsembleSampler"]
