"""Slice / rank arithmetic of a multi-slice world (the JAX
``multislice.mesh`` functions, as plain functions of the world size and
the rank).

Slices are contiguous runs of ranks: slice ``s`` of ``num_slices`` owns
ranks ``[s * world / num_slices, (s + 1) * world / num_slices)``.
"""

from __future__ import annotations


def slice_rank_groups(world: int, num_slices: int
                      ) -> tuple[tuple[int, ...], ...]:
    """Per-slice contiguous rank groups; raises when ``num_slices`` is
    below 1 or does not divide ``world``."""
    if num_slices < 1:
        raise ValueError(f'{num_slices=} must be >= 1')
    if world % num_slices:
        raise ValueError(f'{num_slices=} does not divide world size '
                         f'{world}')
    per = world // num_slices
    return tuple(tuple(range(s * per, (s + 1) * per))
                 for s in range(num_slices))


def slice_of_rank(rank: int, world: int, num_slices: int) -> int:
    """The slice that owns ``rank``."""
    if not 0 <= rank < world:
        raise ValueError(f'{rank=} out of range for world {world}')
    if num_slices <= 1:
        return 0
    if world % num_slices:
        raise ValueError(f'{num_slices=} does not divide world size '
                         f'{world}')
    return rank // (world // num_slices)


def slice_count(dkfac=None) -> int:
    """Number of slices of a ``parallel.DistributedKFAC`` (the JAX
    ``slice_count`` of its mesh): 1 for a flat one, and for None (a
    single-device ``KFAC``)."""
    return 1 if dkfac is None else int(getattr(dkfac, 'num_slices', 1))
