"""Static work placement for distributed K-FAC (PyTorch port of
``distributed_kfac_pytorch_tpu/parallel/placement.py``).

Host-side logic only: the assignments are computed once, in Python, when
``DistributedKFAC`` is built, and never touch a device. The values match
the JAX package's exactly (the golden tests pin both): greedy LPT work
balancing, the strided gradient-broadcast and contiguous
inverse-broadcast rank groups of KAISA, and the diagonal block split.
``parallel.distributed.make_kfac_groups`` turns the groups into
``torch.distributed`` process groups.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


def load_balance(n_workers: int, work: Sequence[float]) -> list[int]:
    """Greedy longest-processing-time assignment of work items to workers.

    Items are taken in decreasing order of cost (ties keep their original
    order); each goes to the least-loaded worker (ties go to the lowest
    worker id). Returns one worker index per item, in ``work``'s order.
    """
    if n_workers < 1:
        raise ValueError(f'n_workers must be >= 1, got {n_workers}')
    if len(work) == 0:
        raise ValueError('work list must be non-empty')
    order = sorted(range(len(work)), key=lambda i: (-work[i], i))
    loads = [0.0] * n_workers
    assignment = [0] * len(work)
    for i in order:
        worker = loads.index(min(loads))  # lowest id wins ties
        assignment[i] = worker
        loads[worker] += work[i]
    return assignment


def partition_grad_ranks(size: int, grad_workers: int) -> list[list[int]]:
    """Strided partition of ``range(size)`` into gradient-broadcast groups:
    group ``i`` is ``[i, i + grad_workers, i + 2*grad_workers, ...]``, one
    rank of each inverse group."""
    return [list(range(i, size, grad_workers)) for i in range(grad_workers)]


def partition_inv_ranks(size: int, grad_workers: int) -> list[list[int]]:
    """Contiguous partition of ``range(size)`` into inverse-broadcast
    groups of ``grad_workers`` ranks: the ranks that share a layer's
    factor inverses."""
    return [list(range(i, min(i + grad_workers, size)))
            for i in range(0, size, grad_workers)]


def get_block_boundary(index: int, n_blocks: int,
                       shape: Sequence[int]) -> tuple[list[int], list[int]]:
    """Start/end coordinates of the ``index``-th diagonal block of a
    matrix: each dimension splits into ``n_blocks`` floor-sized blocks,
    the last absorbing the remainder."""
    if index >= n_blocks:
        raise ValueError(f'block index {index} out of range for '
                         f'{n_blocks} blocks')
    if n_blocks > min(shape):
        raise ValueError(f'cannot split shape {tuple(shape)} into '
                         f'{n_blocks} blocks')
    start = [index * (dim // n_blocks) for dim in shape]
    end = [dim if index == n_blocks - 1 else (index + 1) * (dim // n_blocks)
           for dim in shape]
    return start, end


@dataclasses.dataclass(frozen=True)
class WorkerAllocator:
    """KAISA grad-worker-fraction topology over ``size`` ranks.

    ``bcast_inv_ranks`` are contiguous groups of ``grad_workers`` ranks
    (the rows of :attr:`grid`): they precondition the same layers and so
    share those layers' inverses. ``bcast_grad_ranks`` are the strided
    groups (the columns): one rank per row, over which a layer's
    preconditioned gradient is delivered.
    """

    size: int
    compute_grad_fraction: float

    def __post_init__(self):
        if not (0.0 <= self.compute_grad_fraction <= 1.0):
            raise ValueError('compute_grad_fraction must be in [0, 1], got '
                             f'{self.compute_grad_fraction}')
        if self.size % self.grad_workers != 0:
            raise ValueError(
                'compute_grad_fraction must produce equally sized groups: '
                f'world size {self.size} is not divisible by '
                f'{self.grad_workers} grad workers')

    @property
    def grad_workers(self) -> int:
        return max(1, round(self.size * self.compute_grad_fraction))

    @property
    def bcast_grad_ranks(self) -> list[list[int]]:
        return partition_grad_ranks(self.size, self.grad_workers)

    @property
    def bcast_inv_ranks(self) -> list[list[int]]:
        return partition_inv_ranks(self.size, self.grad_workers)

    @property
    def grad_groups(self) -> int:
        return len(self.bcast_grad_ranks)

    @property
    def inv_groups(self) -> int:
        return len(self.bcast_inv_ranks)

    @property
    def grid(self):
        """The ``(inv_groups, grad_workers)`` rank grid as an ndarray:
        rank ``grid[row, col]`` is ``row * grad_workers + col``."""
        import numpy as np
        return np.asarray(self.bcast_inv_ranks)

    @classmethod
    def from_grid(cls, rows: int, cols: int) -> 'WorkerAllocator':
        """Allocator of an explicit ``rows x cols`` grid (fraction
        ``cols / (rows * cols)``)."""
        if rows < 1 or cols < 1:
            raise ValueError(f'grid must be positive, got {rows}x{cols}')
        return cls(rows * cols, cols / (rows * cols))

    def get_grad_ranks(self, rank: int) -> list[int]:
        """Gradient-broadcast group containing ``rank``."""
        return self.bcast_grad_ranks[rank % self.grad_workers]

    def get_inv_ranks(self, rank: int) -> list[int]:
        """Inverse-broadcast group containing ``rank``."""
        return self.bcast_inv_ranks[rank // self.grad_workers]

    def grad_group_index(self, rank: int) -> int:
        return rank % self.grad_workers

    def inv_group_index(self, rank: int) -> int:
        return rank // self.grad_workers
