"""Multi-slice topology (PyTorch port of
``distributed_kfac_pytorch_tpu/multislice``): the slice / rank arithmetic
of a world split into ``num_slices`` contiguous runs of ranks.

The JAX package nests its mesh under an outer slice axis. The port has no
mesh: ``parallel.distributed.make_kfac_groups`` makes one process group
per slice and one cross-slice group per in-slice index, beside the KAISA
row and column groups, and ``parallel.DistributedKFAC(num_slices=)``
places work over the global row space of ``num_slices x rows_per_slice``
rows, so inverse groups never span slices. ``KFAC(hierarchical_reduce=
True)`` then averages the factor contributions within each slice on every
factor step and across slices once per cadence window.
"""

from distributed_kfac_pytorch_tpu_torch.multislice.mesh import (  # noqa: F401
    slice_count,
    slice_of_rank,
    slice_rank_groups,
)
