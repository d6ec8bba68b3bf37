"""Re-shard K-FAC state between worlds at resume time (PyTorch port of
``distributed_kfac_pytorch_tpu/elastic/reshard.py``).

The topology-dependent part of ``parallel.DistributedKFAC`` state is the
row stacks: each same-size factor group is a ``(slots_per_row, dim, dim)``
stack per row, whose slots come from the deterministic placement
(``assign_work``), and every rank of a row holds its whole row (the
masked-sum gather of a firing). The reshard is a permutation:

  1. **gather** -- with the SAVED world's ``WorkAssignment`` (rebuilt from
     the bundle's ``topo_*`` scalars, :mod:`elastic.topology`), take each
     ``(layer, 'A'|'G')`` factor's entries (``Q`` / ``d`` / ``inv``) from
     the row stacks of any saved rank of its row into a canonical
     per-factor form; a single-device bundle's per-layer ``inverses`` map
     to the same form;
  2. **repack** -- write the live rank's row stacks at the live slots,
     padding slots zero (what a firing leaves there), or, for a
     single-device ``KFAC``, its per-layer ``inverses``.

gather and repack copy bytes, so an N -> M -> N round trip is lossless:
resuming on the original world continues bit for bit. Replicated groups
(step, factors, ``diag_inv``, ``grouped_inv``, ``frozen_factors``,
``inv_chunk_phase``) pass through. Each rank's deferred accumulator
(``factor_accum`` with ``accum_decay``) holds its own batch shard's
statistics, so across a change of world size it is dropped back to its
seed: at most one window of statistics is lost, as in the JAX package,
whose per-device accumulator cannot transfer either. A bundle saved
without inverses needs none of this: ``load_state_dict`` rebuilds them
from the factors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from distributed_kfac_pytorch_tpu_torch.capture import CONV2D_GROUPED, \
    EMBEDDING
from distributed_kfac_pytorch_tpu_torch.elastic.topology import TopologySpec

#: The K-FAC state's inverse groups, in either representation.
INVERSE_KEYS = ('inv_stacks', 'diag_inv', 'grouped_inv', 'inverses',
                'inv_layout')
#: Per-rank accumulator of the deferred reduction and its decay product.
ACCUM_KEYS = ('factor_accum', 'accum_decay')
#: ``extra_vars`` entries that belong to one rank (the LM CLI's dropout
#: generator): a rank the saving world did not have starts without them.
RANK_EXTRA_KEYS = ('dropout_generator',)


def _inner(kfac):
    """The single-device ``KFAC`` of a ``KFAC`` or ``DistributedKFAC``."""
    return getattr(kfac, 'kfac', kfac)


def _distributed(kfac) -> bool:
    return hasattr(kfac, 'assignment')


def saved_assignment(kfac, topo: TopologySpec):
    """The saved world's ``WorkAssignment``, rebuilt with the port's
    ``assign_work`` over ``slices * rows`` global rows (``kfac``: the live
    ``KFAC`` or ``DistributedKFAC``: the placement depends on the layer
    shapes and the grid only)."""
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        assign_work
    from distributed_kfac_pytorch_tpu_torch.parallel.placement import \
        WorkerAllocator
    # The recorded grid must be a legal KAISA partition.
    alloc = WorkerAllocator.from_grid(topo.rows, topo.cols)
    assert (alloc.inv_groups, alloc.grad_workers) == (topo.rows, topo.cols)
    return assign_work(_inner(kfac), topo.slices * topo.rows, topo.cols,
                       distribute_layer_factors=topo.distribute_layer_factors)


def gather_canonical(rank_sds: list[dict], assignment) -> dict:
    """Saved row stacks -> canonical ``{(layer, 'A'|'G'): {key: matrix}}``.

    ``rank_sds`` are the saved ranks' ``DistributedKFAC.state_dict``s;
    row ``r``'s stacks come from the first of them whose
    ``inv_layout['row']`` is ``r``. ``assignment`` must be the saved
    world's (:func:`saved_assignment`): a stack whose slot count or a
    layout whose grid disagrees with it raises ``ValueError``."""
    rows: dict[int, dict] = {}
    for sd in rank_sds:
        layout = sd.get('inv_layout') or {}
        if (layout.get('n_rows'), layout.get('n_cols')) != (
                assignment.n_rows, assignment.n_cols):
            raise ValueError(
                f'checkpoint row stacks of grid {layout.get("n_rows")}x'
                f'{layout.get("n_cols")} but the recorded topology implies '
                f'{assignment.n_rows}x{assignment.n_cols}: the bundle does '
                'not match its own topo_* scalars (corrupt or hand-edited '
                'checkpoint)')
        rows.setdefault(int(layout['row']), sd['inv_stacks'])
    canon: dict[tuple, dict] = {}
    for dim, plan in assignment.buckets.items():
        for r, stacks in rows.items():
            for key, stack in stacks[str(dim)].items():
                if stack.shape[0] != plan.slots_per_row:
                    raise ValueError(
                        f'checkpoint inv_stacks[{dim}][{key!r}] of row {r} '
                        f'has {stack.shape[0]} slots but the recorded '
                        f'topology implies {plan.slots_per_row} -- the '
                        'bundle does not match its own topo_* scalars '
                        '(corrupt or hand-edited checkpoint)')
        for (name, which), slot in plan.slot.items():
            r = assignment.layer_row[name]
            if r not in rows:
                raise ValueError(f'checkpoint holds no rank of row {r} '
                                 f'(layer {name!r})')
            canon[(name, which)] = {k: v[slot]
                                    for k, v in rows[r][str(dim)].items()}
    return canon


def canonical_of_inverses(inverses: dict, kfac) -> tuple[dict, dict, dict]:
    """A single-device ``KFAC`` state's per-layer ``inverses`` ->
    ``(canonical, diag_inv, grouped_inv)`` in the distributed form: a
    side's ``Q{s}`` / ``d{s}`` / ``{s}_inv`` become ``Q`` / ``d`` /
    ``inv`` of ``(layer, s)``, an embedding's diagonal ``A_inv`` its
    ``diag_inv`` and a grouped conv's block stacks its ``grouped_inv``."""
    specs = _inner(kfac).specs
    canon, diag, grouped = {}, {}, {}
    for name, entry in inverses.items():
        kind = specs[name].kind if name in specs else None
        if kind == CONV2D_GROUPED:
            grouped[name] = dict(entry)
            continue
        for side in 'AG':
            if kind == EMBEDDING and side == 'A':
                diag[name] = entry['A_inv']
                continue
            e = {k: entry[src] for k, src in (('Q', f'Q{side}'),
                                              ('d', f'd{side}'),
                                              ('inv', f'{side}_inv'))
                 if src in entry}
            if e:
                canon[(name, side)] = e
    return canon, diag, grouped


def repack_canonical(canon: dict, dk) -> dict | None:
    """Canonical entries -> the live ``DistributedKFAC`` rank's row stacks
    (padding slots zero, in the canonical entries' dtype). None when an
    entry the live config needs is missing or of another shape (a change
    of configuration: rebuild from the factors). A non-mixed layer's
    baked ``inv`` in a mixed bucket, which a single-device bundle does not
    hold, is left zero: only a mixed layer reads it."""
    dtype = next((t.dtype for e in canon.values() for t in e.values()),
                 _inner(dk).inv_dtype)
    stacks = {}
    for dim, plan in dk.assignment.buckets.items():
        keys = dk._stack_keys(dim)
        entry = {k: torch.zeros((plan.slots_per_row,
                                 *dk._slot_shape(dim, k)), dtype=dtype)
                 for k in keys}
        for (name, which), slot in plan.slot.items():
            if dk.assignment.layer_row[name] != dk.row:
                continue
            have = canon.get((name, which), {})
            for k in keys:
                t = have.get(k)
                if t is None:
                    if k == 'inv' and not dk._layer_is_mixed(name):
                        continue
                    return None
                if tuple(t.shape) != tuple(entry[k].shape[1:]):
                    return None
                entry[k][slot] = t
        stacks[str(dim)] = entry
    return stacks


def inverses_of_canonical(canon: dict, diag: dict, grouped: dict,
                          kfac) -> dict | None:
    """Canonical entries -> a single-device ``KFAC``'s per-layer
    ``inverses`` (the keys and shapes of its ``init_state``); None when an
    entry is missing or of another shape."""
    template = kfac.init_state()['inverses']
    specs = kfac.specs
    out = {}
    for name, entry in template.items():
        if specs[name].kind == CONV2D_GROUPED:
            src = grouped.get(name, {})
        else:
            src = {}
            for key in entry:
                side = key[1] if key[0] in 'Qd' else key[0]
                if key == 'A_inv' and specs[name].kind == EMBEDDING:
                    if name in diag:
                        src[key] = diag[name]
                    continue
                ck = key[0] if key[0] in 'Qd' else 'inv'
                t = canon.get((name, side), {}).get(ck)
                if t is not None:
                    src[key] = t
        if set(src) != set(entry) or any(
                tuple(src[k].shape) != tuple(entry[k].shape) for k in entry):
            return None
        out[name] = dict(src)
    return out


def _stacks_match_config(inv_stacks: dict, dk) -> bool:
    """Do the saved stacks carry exactly the entry keys the live config's
    dispatch produces, with bases of the live rank? Bucket dims and
    per-dim key sets are functions of the model and the K-FAC config, not
    of the world, so a mismatch is a change of configuration."""
    kfac = _inner(dk)
    for dim in dk.assignment.buckets:
        entry = inv_stacks.get(str(dim))
        if not entry or 'Q' not in entry:
            continue
        rank = kfac.lowrank_rank_for(dim) or dim
        if tuple(entry['Q'].shape)[-2:] != (dim, rank):
            return False
    expected = {str(dim): set(dk._stack_keys(dim))
                for dim in dk.assignment.buckets}
    return {k: set(v) for k, v in inv_stacks.items()} == expected


def reshard_state_dict(rank_sds: list[dict], saved_topo: TopologySpec,
                       kfac, rank: int = 0) -> dict:
    """The K-FAC ``state_dict`` of live rank ``rank`` of ``kfac`` (a
    ``KFAC`` or ``DistributedKFAC``) from the saved ranks' state dicts
    (one for a single-device bundle), re-sharded for the live world.

    Raises ``ValueError`` when the layer sets differ or the saved stacks
    disagree with ``saved_topo``. The replicated groups come from saved
    rank ``rank`` when it existed, else from rank 0. Across a change of
    world size the deferred accumulator is dropped; a bundle without
    inverses passes through; one whose inverse representation does not
    match the live configuration drops its inverse groups, so
    ``load_state_dict`` rebuilds them from the factors.
    """
    base = rank_sds[rank] if rank < len(rank_sds) else rank_sds[0]
    specs = _inner(kfac).specs
    if set(base.get('factors', {})) != set(specs):
        raise ValueError(
            'cannot reshard: checkpoint layers do not match registered '
            f'layers: {sorted(base.get("factors", {}))} vs {sorted(specs)}')
    live = TopologySpec.of_world(kfac)
    out = {k: v for k, v in base.items() if k not in INVERSE_KEYS}
    if saved_topo.devices != live.devices:
        out = {k: v for k, v in out.items() if k not in ACCUM_KEYS}
    if 'inv_stacks' in base:
        if _distributed(kfac) and not _stacks_match_config(
                base['inv_stacks'], kfac):
            return out
        canon = gather_canonical(rank_sds,
                                 saved_assignment(kfac, saved_topo))
        diag = base.get('diag_inv', {})
        grouped = base.get('grouped_inv', {})
    elif 'inverses' in base:
        canon, diag, grouped = canonical_of_inverses(base['inverses'], kfac)
    else:
        return out           # factors only: rebuilt from them on load
    if not _distributed(kfac):
        inverses = inverses_of_canonical(canon, diag, grouped, kfac)
        if inverses is not None:
            out['inverses'] = inverses
        return out
    stacks = repack_canonical(canon, kfac)
    if stacks is None or set(diag) != set(kfac.assignment.diag_layers) \
            or set(grouped) != set(kfac.assignment.grouped_layers):
        return out
    out.update(inv_stacks=stacks, diag_inv=diag, grouped_inv=grouped,
               inv_layout=kfac._layout())
    return out


@dataclasses.dataclass
class ElasticResume:
    """What the elastic resume needs of the live world: its K-FAC (a
    ``KFAC``, a ``DistributedKFAC`` or None for SGD)."""
    kfac: Any = None

    @property
    def topology(self) -> TopologySpec:
        return TopologySpec.of_world(self.kfac)

    def reshard_tree(self, tree: dict, saved_topo: TopologySpec,
                     device=None) -> dict:
        """A bundle restored for another world
        (``CheckpointManager.restore(elastic=True)``: ``tree['ranks']``
        holds every saved rank's ``kfac`` and ``extra_vars``) -> the live
        rank's tree, every tensor on ``device``. The rank's ``extra_vars``
        are its saved ones, or for a rank the saving world did not have,
        saved rank 0's without :data:`RANK_EXTRA_KEYS`."""
        import torch.distributed as dist

        from distributed_kfac_pytorch_tpu_torch.training.checkpoint import \
            tree_to
        rank = dist.get_rank() if dist.is_initialized() else 0
        parts = tree['ranks']
        out = {k: v for k, v in tree.items() if k != 'ranks'}
        sds = [p.get('kfac') or {} for p in parts]
        if self.kfac is not None and sds[0]:
            out['kfac'] = reshard_state_dict(sds, saved_topo, self.kfac,
                                             rank)
        else:
            out['kfac'] = sds[rank] if rank < len(sds) else sds[0]
        out['extra_vars'] = (
            parts[rank].get('extra_vars', {}) if rank < len(parts) else
            {k: v for k, v in parts[0].get('extra_vars', {}).items()
             if k not in RANK_EXTRA_KEYS})
        return tree_to(out, device)
