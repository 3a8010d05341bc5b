"""Mesh runtime on torch.distributed (all_reduce/all_gather instead of MPI).

Counterpart of the reference package's parallel/: one rank of a process
group per mesh device. MpiTaskDistributor's dynamic work-dealing becomes a
static even sharding of the particle axis over the ranks; the chunked
MPI_Reduce of Fourier volumes becomes one all_reduce; gatherMetadatas
becomes an all_gather of fixed-shape result rows; only rank 0 writes files.
"""
from xmipp3_tpu_torch.parallel.mesh import (data_mesh, shard_particles,
                                            replicate, local_batch_size)
from xmipp3_tpu_torch.parallel.reconstruct import parallel_reconstruct
from xmipp3_tpu_torch.parallel.match import parallel_match

__all__ = ["data_mesh", "shard_particles", "replicate", "local_batch_size",
           "parallel_reconstruct", "parallel_match"]
