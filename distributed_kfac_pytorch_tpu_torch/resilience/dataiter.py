"""Data-stream state for deterministic mid-epoch resume (PyTorch port of
``distributed_kfac_pytorch_tpu/resilience/dataiter.py``).

The pipelines in ``training.datasets`` are seeded and epoch-indexed:
``epoch_batches(seed=s, epoch=e)`` draws its permutation and its
augmentation from ``SeedSequence([s, e])``, and ``bptt_batches`` draws its
window offset once per epoch from the same. The stream position is three
integers, ``(seed, epoch, step_in_epoch)``, and resuming replays: rebuild
the epoch's iterator and skip the first ``step_in_epoch`` batches while
consuming the random draws the skipped batches would have consumed
(``skip_batches=``), so the rest of the epoch equals the uninterrupted
run's batch for batch.

:class:`DataStreamState` is the bundle's form of it: the int scalars
``data_seed``, ``epoch`` and ``step_in_epoch`` of
``training.checkpoint.bundle_state``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DataStreamState:
    """Position of a seeded training stream (see module docstring)."""
    seed: int
    epoch: int
    step_in_epoch: int

    def scalars(self) -> dict:
        """The checkpoint-bundle scalar fields for this position."""
        return {'data_seed': int(self.seed), 'epoch': int(self.epoch),
                'step_in_epoch': int(self.step_in_epoch)}

    @classmethod
    def from_scalars(cls, scalars: dict, *,
                     default_seed: int = 0) -> 'DataStreamState':
        """Rebuild from a restored bundle's ``scalars`` (ints, or 0-dim
        tensors, coerce through ``int()``)."""
        return cls(seed=int(scalars.get('data_seed', default_seed)),
                   epoch=int(scalars.get('epoch', 0)),
                   step_in_epoch=int(scalars.get('step_in_epoch', 0)))


def resume_offset(state: DataStreamState | None, epoch: int) -> int:
    """Batches to skip when starting ``epoch``: the saved offset for the
    interrupted epoch, 0 for every later one."""
    if state is not None and epoch == state.epoch:
        return state.step_in_epoch
    return 0
