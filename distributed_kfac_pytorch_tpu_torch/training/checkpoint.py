"""Checkpoint bundles on disk: save, retention, quarantine and restore
(PyTorch port of ``distributed_kfac_pytorch_tpu/training/checkpoint.py``;
``metadata_tree`` and ``restore_replicated`` belong to elastic resume and
are not ported).

A bundle is a directory ``<directory>/<label>/`` of ``torch.save`` files,
read back with ``torch.load(weights_only=True)``, so a bundle holds only
tensors, dicts, lists, ints, floats, strings, bools and None:

  - alone (no process group): ``bundle.pt``, the whole tree;
  - under a process group: ``bundle.pt`` (written once, by rank 0) holds
    the replicated groups (``params``, ``opt_state``, ``schedulers``,
    ``scalars``), and every rank ``r`` writes its own ``kfac`` and
    ``extra_vars`` (a ``DistributedKFAC`` rank's row stacks, deferred
    accumulator and grid position; an LM rank's dropout generator) into
    ``kfac_rank<r>.pt``. The directory must be shared by the ranks.

:meth:`CheckpointManager.save` stamps each file it writes with its own
content digest in its ``scalars`` (``resilience.integrity``) when the tree
it is given carries the field (``bundle_state(integrity='template')`` is
enough: the manager computes the digest), and
:meth:`CheckpointManager.restore` verifies every file it reads.

Saves are atomic: the files are written into ``<label>.partial`` and the
directory is then renamed onto ``<label>`` (under a group, by rank 0 after
a barrier that every rank's file is written). A scan sees integer names
only, so a torn write is never a bundle. Saves are synchronous (the JAX
package writes asynchronously with orbax); ``wait_until_finished`` and
``close`` have nothing to wait for.
"""

from __future__ import annotations

import os
import shutil
import warnings
from typing import Any, Callable

import torch
import torch.distributed as dist

from distributed_kfac_pytorch_tpu_torch.resilience import \
    integrity as integrity_lib

#: File recording why a bundle was moved to ``<label>.quarantined``.
QUARANTINE_REASON_FILE = 'QUARANTINE_REASON'
BUNDLE_FILE = 'bundle.pt'
RANK_FILE = 'kfac_rank{}.pt'
#: The groups of a bundle that each rank of a process group writes itself.
RANK_KEYS = ('kfac', 'extra_vars')
PARTIAL_SUFFIX = '.partial'


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _to(tree, device):
    """``tree`` with every tensor on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return type(tree)((k, _to(v, device)) for k, v in tree.items())
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree


class CheckpointManager:
    """Integer-labelled bundles under ``directory`` (epochs or global
    steps), the newest ``max_to_keep`` kept (None: all)."""

    #: :meth:`restore` verifies every file it reads (the resume walk does
    #: not hash the tree again).
    verifies_on_restore = True

    def __init__(self, directory: str, max_to_keep: int | None = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, label: int) -> str:
        return os.path.join(self.directory, str(int(label)))

    def save(self, label: int, tree: dict, *, force: bool = False,
             before_commit: Callable[[], Any] | None = None) -> None:
        """Write ``tree`` as bundle ``label`` (collective under a process
        group: every rank calls it with its own tree).

        ``force=True`` replaces a bundle that exists at ``label``; without
        it that raises ``FileExistsError``. ``before_commit`` runs on every
        rank after the files are written and before the rename (the
        ``crash-in-save`` fault). Every save blocks. When ``tree``'s
        ``scalars`` carry the checksum field, each file written is stamped
        with its own digest (``tree`` itself is left as it is).
        """
        rank, world = _world()
        final = self._path(label)
        tmp = final + PARTIAL_SUFFIX
        if rank == 0:
            if os.path.exists(final) and not force:
                raise FileExistsError(
                    f'checkpoint {label} exists under {self.directory} '
                    '(pass force=True to replace it)')
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        if world > 1:
            dist.barrier()
        scalars = dict(tree.get('scalars', {}))
        stamped = integrity_lib.CHECKSUM_KEY in scalars

        def write(part: dict, name: str) -> None:
            if stamped:
                integrity_lib.stamp(part)
            torch.save(part, os.path.join(tmp, name))

        if world == 1:
            write({**tree, 'scalars': scalars}, BUNDLE_FILE)
        else:
            local = {k: tree[k] for k in RANK_KEYS if k in tree}
            local['scalars'] = {'step': scalars.get('step')}
            if rank == 0:
                write({**{k: v for k, v in tree.items()
                          if k not in RANK_KEYS}, 'scalars': scalars},
                      BUNDLE_FILE)
            write(local, RANK_FILE.format(rank))
            dist.barrier()
        if before_commit is not None:
            before_commit()
        if rank == 0:
            self._commit(tmp, final)
            self._retain()
        if world > 1:
            dist.barrier()

    @staticmethod
    def _commit(tmp: str, final: str) -> None:
        """Rename ``tmp`` onto ``final``, replacing a bundle there."""
        if os.path.exists(final):
            old = final + '.replaced'
            shutil.rmtree(old, ignore_errors=True)
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)

    def _retain(self) -> None:
        if not self.max_to_keep:
            return
        for label in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(label))

    def wait_until_finished(self) -> None:
        """Nothing to wait for: every save is synchronous."""

    def latest_epoch(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        """Every committed label on disk, ascending."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def quarantine(self, label: int,
                   reason: str | None = None) -> str | None:
        """Move a corrupt bundle aside to ``<label>.quarantined[.N]``
        (kept for forensics, invisible to the integer scan) with
        ``reason`` in its ``QUARANTINE_REASON`` file. Returns the new
        path (None if it was already gone)."""
        src = self._path(label)
        dst = f'{src}.quarantined'
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f'{src}.quarantined.{n}'
        try:
            os.replace(src, dst)
        except FileNotFoundError:
            return None
        if reason:
            try:
                with open(os.path.join(dst, QUARANTINE_REASON_FILE),
                          'w') as f:
                    f.write(str(reason) + '\n')
            except OSError:
                pass  # forensics metadata must never fail the walk
        return dst

    def quarantined_paths(self, label: int) -> list[str]:
        """Quarantined copies of ``label``, oldest first."""
        src = self._path(label)
        out = []
        dst = f'{src}.quarantined'
        n = 0
        while os.path.exists(dst):
            out.append(dst)
            n += 1
            dst = f'{src}.quarantined.{n}'
        return out

    def quarantine_info(self, label: int) -> tuple[str, str] | None:
        """``(path, reason)`` of the newest quarantined copy of ``label``
        when no live bundle exists at that label, else None."""
        if os.path.exists(self._path(label)):
            return None
        paths = self.quarantined_paths(label)
        if not paths:
            return None
        newest = paths[-1]
        reason = 'no recorded reason'
        try:
            with open(os.path.join(newest, QUARANTINE_REASON_FILE)) as f:
                reason = f.read().strip() or reason
        except OSError:
            pass
        return newest, reason

    def restore(self, label: int | None = None, *, map_location=None,
                all_ranks: bool = False) -> dict:
        """Read bundle ``label`` (the latest when None), every tensor on
        ``map_location`` (default: where it was saved from).

        Every file read is verified against its recorded digest:
        ``integrity.ChecksumMismatch`` names the first that fails. A
        bundle of a process group gives this rank's ``kfac`` and
        ``extra_vars``; ``all_ranks`` also reads and verifies the other
        ranks' files (rank 0's resume walk). A bundle written by another
        world size raises ``ValueError``.
        """
        if label is None:
            label = self.latest_epoch()
        if label is None:
            raise FileNotFoundError(
                f'no checkpoints found under {self.directory}')
        steps = self.all_steps()
        if label not in steps:
            raise FileNotFoundError(
                f'no checkpoint for step {label} under '
                f'{self.directory}; steps on disk: '
                f'{sorted(steps) if steps else "none"}')
        root = self._path(label)
        tree = self._load(os.path.join(root, BUNDLE_FILE), map_location)
        n_ranks = sum(1 for n in os.listdir(root)
                      if n.startswith('kfac_rank'))
        rank, world = _world()
        if n_ranks != (world if world > 1 else 0):
            raise ValueError(
                f'checkpoint {label} was written by '
                f'{n_ranks or 1} rank(s); this world has {world}')
        ranks = range(n_ranks) if all_ranks else [rank] if n_ranks else []
        for r in ranks:
            part = self._load(os.path.join(root, RANK_FILE.format(r)),
                              map_location if r == rank else 'cpu')
            if part['scalars'].get('step') != tree['scalars'].get('step'):
                raise ValueError(
                    f'checkpoint {label}: {RANK_FILE.format(r)} is of '
                    f'step {part["scalars"].get("step")}, the bundle of '
                    f'step {tree["scalars"].get("step")}')
            if r == rank:
                tree.update({k: part[k] for k in RANK_KEYS if k in part})
        return tree

    @staticmethod
    def _load(path: str, map_location) -> dict:
        """One file, verified on the host, then moved to
        ``map_location``."""
        tree = torch.load(path, map_location='cpu', weights_only=True)
        ok, recorded, actual = integrity_lib.verify_tree(tree)
        if ok is False:
            raise integrity_lib.ChecksumMismatch(
                f'{os.path.basename(path)}: '
                f'{integrity_lib.describe_mismatch(recorded, actual)}')
        if ok is None:
            warnings.warn(
                f'checkpoint file {path} restored UNVERIFIED '
                f'({integrity_lib.describe_mismatch(recorded, actual)})',
                RuntimeWarning)
        if map_location is not None and torch.device(map_location) \
                != torch.device('cpu'):
            tree = _to(tree, map_location)
        return tree

    def close(self) -> None:
        """Nothing to release: every save is synchronous."""


def bundle_state(params, opt_state, kfac_state_dict, extra_vars,
                 schedulers: dict[str, Any] | None = None,
                 integrity: bool | str = True, **scalars) -> dict:
    """Assemble the checkpoint tree: ``params`` (the model's
    ``state_dict()``, buffers included), ``opt_state`` (the optimizer's),
    ``kfac`` (``KFAC`` / ``DistributedKFAC.state_dict``), ``extra_vars``,
    ``scalars`` and, when given, ``schedulers`` (their ``state_dict()``).

    ``scalars`` carries the resume point: ``step`` (global optimizer
    step), ``epoch`` (the epoch to (re)enter), ``step_in_epoch`` and
    ``data_seed`` (``resilience.dataiter.DataStreamState``); epoch
    bundles record ``step_in_epoch=0``.

    ``integrity=True`` stamps the tree's content digest into
    ``scalars['integrity_checksum']``; ``'template'`` records the field
    with the unverified sentinel without hashing (a ``CheckpointManager``
    computes each file's digest as it saves); ``False`` omits it.
    """
    tree = {'params': params,
            'opt_state': opt_state,
            'kfac': kfac_state_dict,
            'extra_vars': extra_vars,
            'scalars': dict(scalars)}
    if schedulers:
        tree['schedulers'] = {k: v.state_dict()
                              for k, v in schedulers.items()}
    if integrity:
        integrity_lib.stamp(tree, compute=integrity != 'template')
    return tree
