"""Checkpoint topology metadata: the saving world, recorded in scalars
(PyTorch port of ``distributed_kfac_pytorch_tpu/elastic/topology.py``).

Elastic resume makes the world a resume-time parameter: a run saved on N
ranks restores onto M, with the K-FAC row stacks re-sharded on the way in
(:mod:`elastic.reshard`). Every bundle records the world that saved it;
this module is that record.

The K-FAC state layout depends on the KAISA grid, not on the rank list:
``parallel.distributed.assign_work`` is a deterministic function of
``(layer shapes, n_rows, n_cols, distribute_layer_factors)``, so those
numbers pin the slot of every factor in every bucket stack. Process and
device counts ride along for diagnostics and the ``topology_change``
event. In the port a rank is a process, so both are the world size.

The scalars are plain ints (``topo_*`` keys) in the bundle's ``scalars``
(``training.checkpoint.bundle_state(topology=)``); a bundle without them
restores on its own world only.
"""

from __future__ import annotations

import dataclasses

#: Bumped if the meaning of the recorded fields ever changes; readers
#: treat unknown future formats as same-topology-only.
TOPOLOGY_FORMAT = 1

#: Scalar keys this module owns inside a bundle's ``scalars``.
SCALAR_KEYS = ('topo_format', 'topo_processes', 'topo_devices',
               'topo_rows', 'topo_cols', 'topo_seq', 'topo_slices',
               'topo_dist_factors')


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The world a checkpoint was saved on (or the live world).

    ``rows`` / ``cols`` are the KAISA grid of one slice (inverse groups and
    ranks per group); ``slices`` counts the slices, so the global row space
    is ``slices * rows``. ``distribute_layer_factors`` is the effective
    A/G-on-different-columns flag of the ``DistributedKFAC``.
    """
    processes: int
    devices: int
    rows: int
    cols: int
    seq: int = 1
    slices: int = 1
    distribute_layer_factors: bool = True

    def __post_init__(self):
        if self.slices < 1:
            raise ValueError(f'inconsistent topology: slices '
                             f'{self.slices} must be >= 1')
        if self.rows * self.cols * self.seq * self.slices != self.devices:
            raise ValueError(
                f'inconsistent topology: rows {self.rows} x cols '
                f'{self.cols} x seq {self.seq} x slices {self.slices} '
                f'!= devices {self.devices}')

    @property
    def layout_key(self) -> tuple:
        """The part of the spec the K-FAC state layout depends on: worlds
        with equal keys place every factor in the same slot of the same
        global row (``assign_work`` runs over ``slices * rows`` rows)."""
        return (self.slices * self.rows, self.cols,
                self.distribute_layer_factors)

    def needs_reshard(self, other: 'TopologySpec') -> bool:
        return self.layout_key != other.layout_key

    def scalars(self) -> dict:
        """``topo_*`` int scalars to merge into a bundle's scalars."""
        return {'topo_format': TOPOLOGY_FORMAT,
                'topo_processes': int(self.processes),
                'topo_devices': int(self.devices),
                'topo_rows': int(self.rows),
                'topo_cols': int(self.cols),
                'topo_seq': int(self.seq),
                'topo_slices': int(self.slices),
                'topo_dist_factors': int(self.distribute_layer_factors)}

    @classmethod
    def from_scalars(cls, scalars: dict) -> 'TopologySpec | None':
        """Rebuild from a bundle's ``scalars`` (None when it records no
        topology, or a future format: both mean same-topology-only)."""
        if not scalars or 'topo_format' not in scalars:
            return None
        if int(scalars['topo_format']) != TOPOLOGY_FORMAT:
            return None
        return cls(processes=int(scalars['topo_processes']),
                   devices=int(scalars['topo_devices']),
                   rows=int(scalars['topo_rows']),
                   cols=int(scalars['topo_cols']),
                   seq=int(scalars.get('topo_seq', 1)),
                   slices=int(scalars.get('topo_slices', 1)),
                   distribute_layer_factors=bool(
                       int(scalars['topo_dist_factors'])))

    @classmethod
    def of_world(cls, dkfac=None) -> 'TopologySpec':
        """The live world: a ``parallel.DistributedKFAC``'s grid over the
        process group's ranks; without one, a process alone (the
        single-device ``KFAC``, or no K-FAC) is ``1/1``, grid 1x1, and a
        group without K-FAC is the comm-opt grid ``1 x world``."""
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
        if dkfac is not None and hasattr(dkfac, 'assignment'):
            return cls(processes=world, devices=world,
                       rows=int(dkfac.rows_per_slice),
                       cols=int(dkfac.n_cols),
                       seq=int(dkfac.seq_parallel),
                       slices=int(dkfac.num_slices),
                       distribute_layer_factors=bool(
                           dkfac.distribute_layer_factors))
        return cls(processes=world, devices=world, rows=1, cols=world,
                   distribute_layer_factors=world > 1)

    def describe(self) -> str:
        return (f'{self.devices} device(s) / {self.processes} '
                f'process(es), KAISA grid {self.rows}x{self.cols}'
                + (f' x seq {self.seq}' if self.seq > 1 else '')
                + (f', {self.slices} slice(s)'
                   if self.slices > 1 else ''))
