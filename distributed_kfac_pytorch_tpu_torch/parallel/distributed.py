"""Distributed K-FAC over ``torch.distributed`` (PyTorch port of
``distributed_kfac_pytorch_tpu/parallel/distributed.py``): the KAISA
strategies COMM_OPT, MEM_OPT and HYBRID_OPT.

The world of ``W`` ranks is a ``(n_rows, n_cols)`` grid
(``placement.WorkerAllocator.grid``; rank ``row * n_cols + col``). A row
is an *inverse group*: its ranks hold and precondition the same layers.
A column is a *gradient-broadcast group*: one rank of each row, over which
the preconditioned gradients are delivered. COMM_OPT is ``1 x W`` (every
rank holds every inverse), MEM_OPT ``W x 1`` (each layer's inverses on one
rank), HYBRID_OPT ``W / gw x gw`` for ``gw = grad_worker_fraction * W``.

One step on every rank, with its own batch shard's captures and the
world-averaged gradients:

  1. factors: each rank contracts its captures into local covariance
     contributions (K1 in its contraction-only form, K2 for conv A, plus
     a tied embedding's attend-site parts), one ``all_reduce`` SUM over
     the world averages them (the output-grad-quadratic parts ``G`` and
     ``A_g2`` times ``1/W^2``: the captured output-grads come from the
     rank's local-mean loss), and every rank applies the EMA;
  2. inverses, on firing steps: every same-size factor forms a *bucket*;
     each row owns ``slots_per_row`` slots of it, and each rank decomposes
     the assigned slots of its own ``slots_per_col`` (warm polish or
     library eigh, K5 under ``'jacobi'``, K4 or Cholesky for baked
     inverses). Each rank writes its slots into a zeroed row stack and
     one ``all_reduce`` SUM over its row gathers the row's stacks. An
     embedding's diagonal A is not placed: every rank computes its
     elementwise inverse (``diag_inv``, replicated); nor are a grouped
     conv's block stacks: every rank computes their damped Cholesky
     inverses (``grouped_inv``, replicated; the blocks are tiny);
  3. preconditioning: per gradient shape, each rank runs K3 on its row's
     layers only, its row's embeddings one by one (the diagonal A
     inverse with the G inverse of the G bucket) and its row's grouped
     convs (``G_inv @ V @ A_inv`` over their block stacks); the KL-clip ``v.g``
     partial and the preconditioned matrices (zero where the row does not
     own the layer) ride one ``all_reduce`` SUM over the rank's column.

Sequence parallelism (``seq_parallel = sp > 1``, the JAX mesh's third,
innermost axis): world rank ``r`` is K-FAC rank ``r // sp`` at sequence
index ``r % sp``, and the grid above is built over the ``W / sp`` K-FAC
ranks. Each row and column group exists once per sequence index (``{k *
sp + j}`` over the K-FAC ranks ``k`` of the row or column), so the ``sp``
ranks of one K-FAC rank do the same decomposition and preconditioning
work, as JAX's stacks are replicated over the sequence axis. The factor
average and the gradient mean span the whole world of ``W`` ranks (JAX's
``data_axes``), and the grad-quadratic parts take ``1/W^2``.

Reduced precision (the ``KFAC`` knobs): factors are stored in
``factor_dtype`` and the row stacks and ``diag_inv`` in ``inv_dtype``.
Every collective moves fp32: the factor contributions, and the row stacks
of a firing, which are cast to ``inv_dtype`` after the sum (as JAX casts
its gathered fp32 stack). The EMA widens the stored factor, blends in fp32
and rounds once, as the single-device ``KFAC`` does, so a world's factors
stay the single-device step's bits up to the order of the fp32 sums.

Only ``all_reduce`` and ``broadcast`` are used, so one code path serves
NCCL and gloo (which runs both on CUDA tensors). A group of one rank runs
no collective.

Work placement (:func:`assign_work`) is the JAX package's, exactly: the
two-level LPT of layers onto rows and of factors onto a row's columns.
The firing schedule (the ``KFAC`` knobs): under ``inv_pipeline_chunks`` /
``inv_staleness`` a chunk firing decomposes the slot offsets the chunk
plan gives it (:func:`plan_firing_chunks`; the unit is a
within-column slot offset, one decomposition per rank) into a zeroed stack
of the row's fired slots, one masked-sum ``all_reduce`` over the row
assembles it, and the result is written into the stored row stacks;
slots that did not fire keep their bits. Under
``deferred_factor_reduction`` each rank folds its own contributions into a
local accumulator (K1's fused blend, no collective) and the window head
runs one flat fp32 ``all_reduce`` of the accumulators; ``inv_staleness``
fires from the replicated ``frozen_factors``; ``factor_batch_fraction``
thins each rank's own captures.

The randomized low-rank inverse (``KFAC(inv_lowrank_rank=r)``): a bucket
whose dim takes the ``'lowrank'`` method holds ``(slots_per_row, dim, r)``
bases and ``(slots_per_row, r)`` eigenvalues, decomposed by
``linalg.batched_lowrank_eigh`` warm from the stored bases, gathered by the
same masked-sum ``all_reduce``; the chunk planner costs it ``r dim^2``, and
a shape group with such a side is preconditioned by stock torch, not K3.

Multi-slice (``num_slices = S > 1``, the JAX package's outer slice axis):
slice ``s`` is the contiguous run of ranks ``[s W/S, (s+1) W/S)``, and the
grid above is built within each slice. Work is placed over the global row
space of ``S x rows_per_slice`` rows (global row ``s * rows_per_slice +
r``), so a row's inverse group never leaves its slice; a column group
spans every slice (one rank of each global row), so only the delivery of
preconditioned gradients crosses slices. ``KFAC(hierarchical_reduce=True)``
averages each factor step's contributions within the slice (one flat
``all_reduce`` over the slice) into a per-slice accumulator, and the window
head averages the accumulators across slices (one flat fp32 ``all_reduce``
over the ranks of the same in-slice index), then blends as the deferred
head does. ``num_slices=1`` is the flat path.

On-device metrics (``KFAC(collect_metrics=True)``): the same
``state['metrics']`` as the single-device ``KFAC``, replicated on every
rank. The norms are taken after the delivery, where every rank holds
every preconditioned matrix; ``eig_clipped`` counts, on each row, only the
slots of its row stacks that hold a layer of the row (after a firing the
padding slots and those of layers placed on other rows hold zeros), and
the rows' counts are summed by riding the delivery's ``all_reduce`` over
the column (one rank of each row), so the metrics add no collective.

Not ported: the quarantine gates.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from distributed_kfac_pytorch_tpu_torch import layers as L
from distributed_kfac_pytorch_tpu_torch.capture import CONV2D_GROUPED, \
    EMBEDDING
from distributed_kfac_pytorch_tpu_torch.multislice import mesh as slices
from distributed_kfac_pytorch_tpu_torch.observability import \
    metrics as obs_metrics
from distributed_kfac_pytorch_tpu_torch.observability import profiling
from distributed_kfac_pytorch_tpu_torch.ops import factors as F
from distributed_kfac_pytorch_tpu_torch.ops import kernels, linalg
from distributed_kfac_pytorch_tpu_torch.parallel.placement import (
    WorkerAllocator,
    load_balance,
)
from distributed_kfac_pytorch_tpu_torch.preconditioner import (
    KFAC,
    OVERLAP_KEYS,
    CommMethod,
    comm_method_of,
    _same_layout,
    eigen_family,
    gate_blend,
    grouped_block_inverses,
    grouped_cost,
    grouped_init,
    measured_unit_scale,
    precond_scope,
    overlay_overlap_state,
    plan_inverse_chunks,
    truncated_entry,
)


#: The state's inverse entries: the row stacks, the embeddings' diagonal
#: inverses and the grouped convs' block stacks (the last two replicated).
INVERSE_KEYS = ('inv_stacks', 'diag_inv', 'grouped_inv')


def resolve_grad_workers(size: int, comm_method: CommMethod,
                         grad_worker_fraction: float) -> int:
    """Ranks per inverse group: COMM_OPT the world, MEM_OPT one,
    HYBRID_OPT ``round(size * grad_worker_fraction)``, which must divide
    ``size``."""
    if comm_method is CommMethod.COMM_OPT:
        return size
    if comm_method is CommMethod.MEM_OPT:
        return 1
    gw = max(1, round(size * grad_worker_fraction))
    if size % gw != 0:
        raise ValueError(
            f'grad_worker_fraction {grad_worker_fraction} gives '
            f'{gw} grad workers, which does not divide world size {size}')
    return gw


# ---------------------------------------------------------------------------
# Host-side static work assignment
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Layout of every factor of one size as a stacked workload.

    Each row owns ``slots_per_row = slots_per_col * n_cols`` slots; the
    rank in column ``c`` decomposes slots ``[c * slots_per_col, (c + 1) *
    slots_per_col)`` of its row. ``slot`` maps ``(layer, 'A'|'G')`` to
    its slot within the owning row.
    """
    dim: int
    slots_per_col: int
    n_cols: int
    slot: dict[tuple[str, str], int]

    @property
    def slots_per_row(self) -> int:
        return self.slots_per_col * self.n_cols


@dataclasses.dataclass(frozen=True)
class WorkAssignment:
    """Static placement: ``layer_row[name]`` is the row that stores,
    decomposes and preconditions with layer ``name``'s inverses;
    ``buckets`` lay out the decompositions by factor size;
    ``diag_layers`` are the embeddings, whose diagonal A is inverted on
    every rank (outside the buckets); ``grouped_layers`` the grouped
    convs, whose block stacks are inverted on every rank (outside the
    buckets) and preconditioned by their row."""
    n_rows: int
    n_cols: int
    layer_row: dict[str, int]
    buckets: dict[int, BucketPlan]
    diag_layers: tuple[str, ...]
    grouped_layers: tuple[str, ...] = ()


def factor_dims(kfac: KFAC) -> dict[str, tuple[int, int]]:
    """``{layer: (A dim, G dim)}`` of a KFAC's registered layers."""
    params = dict(kfac.model.named_parameters())
    return {name: L.factor_shapes(spec, kfac._layer_params(name, params))
            for name, spec in kfac.specs.items()}


def assign_work(kfac: KFAC, n_rows: int, n_cols: int, *,
                distribute_layer_factors: bool | None = None
                ) -> WorkAssignment:
    """LPT-place layers onto rows and factors onto a row's columns.

    The cost of a factor is ``n^3`` (``assignment_strategy='compute'``)
    or ``n^2`` (``'memory'``). Layers go to rows (a layer's A and G stay
    in one row), then the row's factors to its columns;
    ``distribute_layer_factors`` (default: ``n_cols > 1``) lets A and G
    of one layer land on different columns, else whole layers are placed.
    An embedding's diagonal A is no work item: only its G is placed and
    costed. A grouped conv places no factor (its block stacks are
    inverted on every rank) but takes a row, which preconditions it, at
    the cost ``G (da^e + dg^e)``.
    """
    if distribute_layer_factors is None:
        distribute_layer_factors = n_cols > 1
    exp = 3 if kfac.assignment_strategy == 'compute' else 2
    names = list(kfac.specs)
    shapes = factor_dims(kfac)
    diag = tuple(n for n in names if kfac.specs[n].kind == EMBEDDING)
    grouped = tuple(n for n in names
                    if kfac.specs[n].kind == CONV2D_GROUPED)

    def factor_entries(name):
        if name in grouped:
            return []
        a_dim, g_dim = shapes[name]
        g_item = ((name, 'G'), g_dim, g_dim ** exp)
        if name in diag:
            return [g_item]
        return [((name, 'A'), a_dim, a_dim ** exp), g_item]

    layer_cost = {n: sum(c for _, _, c in factor_entries(n)) for n in names}
    for n in grouped:
        a_dim, g_dim = shapes[n]
        layer_cost[n] = kfac.specs[n].feature_group_count * (
            a_dim ** exp + g_dim ** exp)
    row_of = dict(zip(names, load_balance(
        n_rows, [layer_cost[n] for n in names])))

    cell: dict[tuple[int, int, int], list] = collections.defaultdict(list)
    for r in range(n_rows):
        row_names = [n for n in names if row_of[n] == r]
        if not row_names:
            continue
        if distribute_layer_factors:
            items = [e for n in row_names for e in factor_entries(n)]
        else:
            items = [((n, '*'), 0, layer_cost[n]) for n in row_names
                     if factor_entries(n)]
        if not items:
            continue          # a row of grouped convs only: no buckets
        cols = load_balance(n_cols, [c for _, _, c in items])
        for (key, dim, _), col in zip(items, cols):
            if key[1] == '*':
                for sub_key, sub_dim, _ in factor_entries(key[0]):
                    cell[(r, col, sub_dim)].append(sub_key)
            else:
                cell[(r, col, dim)].append(key)

    buckets = {}
    for dim in sorted({d for (_, _, d) in cell}):
        s = max(len(cell[(r, c, dim)])
                for r in range(n_rows) for c in range(n_cols))
        slot = {}
        for r in range(n_rows):
            for c in range(n_cols):
                for k, key in enumerate(cell[(r, c, dim)]):
                    slot[key] = c * s + k
        buckets[dim] = BucketPlan(dim=dim, slots_per_col=s, n_cols=n_cols,
                                  slot=slot)
    return WorkAssignment(n_rows=n_rows, n_cols=n_cols, layer_row=row_of,
                          buckets=buckets, diag_layers=diag,
                          grouped_layers=grouped)


def plan_precond_groups(kfac: KFAC, assignment: WorkAssignment
                        ) -> list[dict]:
    """Shape groups of the row-sharded preconditioning.

    Dense layers are grouped by gradient-matrix shape ``(g_dim, a_dim)``
    (embeddings and grouped convs are preconditioned one by one); in a group of
    ``S`` slots per row, row ``r``'s layers take the global slots ``r * S + k``
    (``slot_of``), and ``a_idx`` / ``g_idx`` give each global slot's in-row
    slot in the A / G factor buckets (0 for padding). The JAX package's plan,
    in its order.
    """
    dims = factor_dims(kfac)
    by_shape: dict[tuple[int, int], dict[int, list[str]]] = {}
    for name, spec in kfac.specs.items():
        if spec.kind in (EMBEDDING, CONV2D_GROUPED):
            continue
        a_dim, g_dim = dims[name]
        rows = by_shape.setdefault((g_dim, a_dim), {})
        rows.setdefault(assignment.layer_row[name], []).append(name)
    groups = []
    for (g_dim, a_dim), rows in by_shape.items():
        s = max(len(v) for v in rows.values())
        slot_of = {}
        a_idx = [0] * (assignment.n_rows * s)
        g_idx = [0] * (assignment.n_rows * s)
        for r, names in rows.items():
            for k, name in enumerate(names):
                gslot = r * s + k
                slot_of[name] = gslot
                a_idx[gslot] = assignment.buckets[a_dim].slot[(name, 'A')]
                g_idx[gslot] = assignment.buckets[g_dim].slot[(name, 'G')]
        groups.append({'shape': (g_dim, a_dim), 'S': s, 'slot_of': slot_of,
                       'a_idx': a_idx, 'g_idx': g_idx})
    return groups


def plan_firing_chunks(kfac: KFAC, assignment: WorkAssignment
                       ) -> dict | None:
    """The chunk plan of a pipelined firing on a grid's ``assignment``
    (the JAX ``DistributedKFAC._plan_firing_chunks``), None while the
    ``KFAC``'s firings are not pipelined.

    The work unit is a within-column slot offset ``('slot', dim, m)`` of a
    bucket (cost ``dim^3``, ``r dim^2`` for a low-rank bucket): firing it
    costs each rank of a row the one slot at ``col * slots_per_col + m``,
    so a chunk's load per rank is what the
    pipelining spreads. An embedding's diagonal A is an item ``('diag',
    layer)`` and a grouped conv's block stacks one ``('grouped', layer)``
    (cost ``G (da^3 + dg^3)``). The items are packed onto
    ``inv_pipeline_chunks`` chunks by ``preconditioner.plan_inverse_chunks``
    (global and deterministic: every rank gets the same plan). Returns
    ``{'offsets': {dim: {chunk: (m, ...)}}, 'diag': {layer: chunk},
    'grouped': {layer: chunk}}``.
    """
    k = kfac.inv_pipeline_chunks
    if not kfac.pipelined_firing:
        return None
    measured = kfac.inv_pipeline_costs or {}
    buckets = assignment.buckets
    dims = factor_dims(kfac)
    proxy_scale = measured_unit_scale(
        measured, {dim: plan.slots_per_col for dim, plan in buckets.items()},
        'inverse bucket dim of this mesh layout')
    items: list[tuple[tuple, float]] = []
    for dim in sorted(buckets):
        plan = buckets[dim]
        unit = (float(measured[dim]) / plan.slots_per_col
                if dim in measured else linalg.decomposition_cost(
                    dim, rank=kfac.lowrank_rank_for(dim)))
        for m in range(plan.slots_per_col):
            items.append((('slot', dim, m), unit))
    for name in assignment.diag_layers:
        items.append((('diag', name), proxy_scale * float(dims[name][0])))
    for name in assignment.grouped_layers:
        items.append((('grouped', name), proxy_scale * grouped_cost(
            kfac.specs[name], *dims[name])))
    if k > len(items):
        raise ValueError(
            f'inv_pipeline_chunks={k} exceeds the {len(items)} '
            'inverse work items of this mesh layout (bucket slot '
            'offsets + grouped/diagonal layers); lower it to at '
            f'most {len(items)}')
    offsets: dict[int, dict[int, list]] = {dim: {} for dim in buckets}
    singles: dict[str, dict[str, int]] = {'diag': {}, 'grouped': {}}
    for key, j in plan_inverse_chunks(items, k).items():
        if key[0] == 'slot':
            offsets[key[1]].setdefault(j, []).append(key[2])
        else:
            singles[key[0]][key[1]] = j
    return {'offsets': {dim: {j: tuple(sorted(ms)) for j, ms in per.items()}
                        for dim, per in offsets.items()},
            **singles}


def item_chunk_plan(assignment: WorkAssignment, chunk_plan: dict
                    ) -> dict[tuple, int]:
    """A grid's chunk plan (:func:`plan_firing_chunks`) in the items of
    the single-device ``KFAC.inverse_chunk_plan``: ``{('mat', layer,
    'A'|'G'): chunk, ('diag', layer): chunk, ('grouped', layer): chunk}``,
    each matrix in the chunk of its slot offset. A single-device ``KFAC``
    firing this plan fires, at each chunk, the matrices the grid fires."""
    out = {}
    for dim, plan in assignment.buckets.items():
        s = plan.slots_per_col
        chunk_of = {m: j for j, offs in chunk_plan['offsets'][dim].items()
                    for m in offs}
        for (name, side), slot in plan.slot.items():
            out[('mat', name, side)] = chunk_of[slot % s]
    for kind in ('diag', 'grouped'):
        for name, j in chunk_plan[kind].items():
            out[(kind, name)] = j
    return out


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KFACGroups:
    """This rank's place in the grid and its process groups (``None``
    where the group is this rank alone: no collective runs there). The
    ranks are world ranks; ``row`` is the global row (``slice *
    rows_per_slice`` + the row within the slice). ``slice_ranks`` /
    ``cross_ranks`` are this rank's slice and the ranks of its in-slice
    index in every slice (both groups exist only with more than one
    slice)."""
    row: int
    col: int
    inv_ranks: tuple[int, ...]      # this rank's row
    grad_ranks: tuple[int, ...]     # this rank's column (strided)
    inv_group: Any
    grad_group: Any
    slice: int = 0
    slice_ranks: tuple[int, ...] = ()
    cross_ranks: tuple[int, ...] = ()
    slice_group: Any = None
    cross_group: Any = None


def make_kfac_groups(allocator: WorkerAllocator,
                     seq_parallel: int = 1,
                     num_slices: int = 1) -> KFACGroups:
    """Create the grid's process groups and return this rank's.

    The world is ``num_slices`` contiguous slices of ``P = W /
    num_slices`` ranks (``multislice.slice_rank_groups``). ``allocator``
    places the ``P / seq_parallel`` K-FAC ranks of one slice; world rank
    ``s P + l`` is K-FAC rank ``l // seq_parallel`` of slice ``s`` at
    sequence index ``l % seq_parallel``. Row groups exist once per slice
    and sequence index, column groups once per sequence index and span
    every slice. With more than one slice there is also one group per
    slice and one cross-slice group per in-slice index.
    ``dist.new_group`` is collective: every rank creates every group of
    more than one rank (row groups, column groups, slice groups, then
    cross-slice groups), in the same order, whether or not it is a member.
    """
    if not dist.is_initialized():
        raise RuntimeError('make_kfac_groups needs an initialized process '
                           'group (launch.initialize_distributed)')
    rank, world = dist.get_rank(), dist.get_world_size()
    slice_groups = slices.slice_rank_groups(world, num_slices)
    per = world // num_slices
    if allocator.size * seq_parallel != per:
        raise ValueError(f'allocator of {allocator.size} ranks x '
                         f'{seq_parallel} sequence ranks x {num_slices} '
                         f'slices for a world of {world}')
    slice_id, local = divmod(rank, per)
    kfac_rank, seq_index = divmod(local, seq_parallel)

    def world_ranks(ranks, j, in_slices):
        return tuple(s * per + k * seq_parallel + j
                     for s in in_slices for k in ranks)

    made = {}

    def make(key):
        if len(key) > 1 and key not in made:
            made[key] = dist.new_group(list(key))

    for s in range(num_slices):
        for ranks in allocator.bcast_inv_ranks:
            for j in range(seq_parallel):
                make(world_ranks(ranks, j, (s,)))
    every = range(num_slices)
    for ranks in allocator.bcast_grad_ranks:
        for j in range(seq_parallel):
            make(world_ranks(ranks, j, every))
    cross = tuple(tuple(s * per + i for s in every) for i in range(per))
    if num_slices > 1:
        for key in slice_groups + cross:
            make(key)
    inv_ranks = world_ranks(allocator.get_inv_ranks(kfac_rank), seq_index,
                            (slice_id,))
    grad_ranks = world_ranks(allocator.get_grad_ranks(kfac_rank),
                             seq_index, every)
    many = num_slices > 1
    return KFACGroups(row=(slice_id * allocator.inv_groups
                           + allocator.inv_group_index(kfac_rank)),
                      col=allocator.grad_group_index(kfac_rank),
                      inv_ranks=inv_ranks, grad_ranks=grad_ranks,
                      inv_group=made.get(inv_ranks),
                      grad_group=made.get(grad_ranks),
                      slice=slice_id,
                      slice_ranks=slice_groups[slice_id] if many else (),
                      cross_ranks=cross[local] if many else (),
                      slice_group=made.get(slice_groups[slice_id])
                      if many else None,
                      cross_group=made.get(cross[local]) if many else None)


def _all_reduce_sum(tensors: list[torch.Tensor], group) -> list:
    """SUM ``tensors`` over ``group`` as one flat ``all_reduce``; returns
    the reduced tensors in their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [v.view(t.shape)
            for v, t in zip(flat.split([t.numel() for t in tensors]),
                            tensors)]


# ---------------------------------------------------------------------------
# The distributed preconditioner
# ---------------------------------------------------------------------------

class DistributedKFAC:
    """A :class:`KFAC` whose second-order work is spread over the ranks of
    the initialized ``torch.distributed`` world.

    ``comm_method`` / ``grad_worker_fraction`` default to the wrapped
    ``KFAC``'s; ``distribute_layer_factors`` (default: more than one rank
    per row) lets a layer's A and G be decomposed by different ranks.
    Every rank must build it, and call :meth:`step` (a collective) with
    its own batch shard's captures and the world-averaged gradients.
    Embeddings (tied or not) and every ``kfac_approx`` of the wrapped
    ``KFAC`` run as they do there.

    ``num_slices`` (default 1): contiguous slices of the world, each with
    its own grid, placed over the global row space (module docstring);
    ``KFAC(hierarchical_reduce=True)`` needs more than one.

    ``seq_parallel`` (default 1): ranks per sequence group, which must
    divide a slice; the grid is laid over the slice's ``P / seq_parallel``
    K-FAC ranks. Each rank then captures its ``(batch, sequence)`` tile
    (``launch.process_local_tile``; the ring makes its captures those of
    the whole sequence's loss). Under ``'reduce'`` each rank reduces over
    its own positions, as each JAX device does, so its local length must
    exceed 1 for a layer to count as shared.
    """

    def __init__(self, kfac: KFAC, *,
                 comm_method: CommMethod | str | None = None,
                 grad_worker_fraction: float | None = None,
                 distribute_layer_factors: bool | None = None,
                 seq_parallel: int = 1,
                 num_slices: int = 1):
        if not dist.is_initialized():
            raise RuntimeError('DistributedKFAC needs an initialized process '
                               'group (launch.initialize_distributed)')
        self.kfac = kfac
        self.capture = kfac.capture
        self.specs = kfac.specs
        self.device = kfac.device
        self.comm_method = comm_method_of(
            kfac.comm_method if comm_method is None else comm_method)
        fraction = (kfac.grad_worker_fraction if grad_worker_fraction is None
                    else grad_worker_fraction)
        # The whole world averages the factors and the gradients.
        self.world_size = dist.get_world_size()
        per = len(slices.slice_rank_groups(self.world_size,
                                           num_slices)[0])
        if kfac.hierarchical_reduce and num_slices == 1:
            raise ValueError(
                'hierarchical_reduce=True requires num_slices > 1: on a '
                'flat world there is no slice boundary to defer over')
        if per % seq_parallel:
            raise ValueError(f'{seq_parallel=} does not divide the {per} '
                             'ranks of each slice')
        self.seq_parallel = seq_parallel
        self.num_slices = num_slices
        dp = per // seq_parallel
        gw = resolve_grad_workers(dp, self.comm_method, fraction)
        self.allocator = WorkerAllocator(dp, gw / dp)
        self.groups = make_kfac_groups(self.allocator, seq_parallel,
                                       num_slices)
        # Rows are global: num_slices x the rows of one slice.
        self.rows_per_slice = self.allocator.inv_groups
        self.n_rows, self.n_cols = num_slices * self.rows_per_slice, gw
        self.row, self.col = self.groups.row, self.groups.col
        self.distribute_layer_factors = (
            self.n_cols > 1 if distribute_layer_factors is None
            else bool(distribute_layer_factors))
        self.assignment = assign_work(
            kfac, self.n_rows, self.n_cols,
            distribute_layer_factors=self.distribute_layer_factors)
        self._factor_dims = factor_dims(kfac)
        self._bucket_mixed = {
            dim: any(self._layer_is_mixed(name) for name, _ in plan.slot)
            for dim, plan in self.assignment.buckets.items()
            if eigen_family(kfac.method_for_dim(dim))}
        # This rank's decomposition work: {dim: [(in-row slot, key)]},
        # and the slots as a device index (built once: a host-to-device
        # copy per step would stall the host on the device).
        self._cells, self._cell_idx = {}, {}
        for dim, plan in self.assignment.buckets.items():
            lo = self.col * plan.slots_per_col
            self._cells[dim] = sorted(
                (slot, key) for key, slot in plan.slot.items()
                if self.assignment.layer_row[key[0]] == self.row
                and lo <= slot < lo + plan.slots_per_col)
            self._cell_idx[dim] = torch.tensor(
                [slot for slot, _ in self._cells[dim]], device=self.device)
        # The slots of this row's eigen stacks that hold a layer of the
        # row (the metrics' clip count reads only these).
        self._held_slots = {
            str(dim): torch.tensor(sorted(
                slot for key, slot in plan.slot.items()
                if self.assignment.layer_row[key[0]] == self.row),
                dtype=torch.long, device=self.device)
            for dim, plan in self.assignment.buckets.items()
            if eigen_family(kfac.method_for_dim(dim))}
        # This row's layers per shape group: (names, A slots, G slots).
        self._row_groups = []
        for grp in plan_precond_groups(kfac, self.assignment):
            s = grp['S']
            mine = sorted((gslot, name) for name, gslot
                          in grp['slot_of'].items() if gslot // s == self.row)
            if mine:
                self._row_groups.append((
                    grp['shape'], [name for _, name in mine],
                    torch.tensor([grp['a_idx'][g] for g, _ in mine],
                                 device=self.device),
                    torch.tensor([grp['g_idx'][g] for g, _ in mine],
                                 device=self.device)))
        # Pipelined firing: the chunk plan over within-column slot offsets
        # and this rank's share of each chunk.
        self._chunk_plan = plan_firing_chunks(kfac, self.assignment)
        self._chunk_cells, self._chunk_rows = self._plan_chunk_work()
        #: The KL-clip scale of the last :meth:`step` (a device scalar).
        self.last_nu = None

    def _plan_chunk_work(self) -> tuple[dict, dict]:
        """This rank's share of each chunk: ``({dim: {chunk: (cells,
        slots)}}, {chunk: {dim: (cells, slots, positions, row slots)}})``.
        ``cells`` are the ``(in-row slot, key)`` this rank decomposes in
        the chunk, ``slots`` their slots (a device index); ``row slots``
        (a device index) the in-row slots of its row that
        the chunk fires and that hold a layer, the same on every rank of
        the row (padding slots are never fired); ``positions`` (a device
        index) are the cells' places among them. A bucket whose row
        slots are empty in a chunk is left out, on every rank of the row
        alike. Empty without a chunk plan."""
        if self._chunk_plan is None:
            return {}, {}
        dev = self.device

        def index(values):
            return torch.tensor(values, dtype=torch.long, device=dev)

        groups: dict[int, dict[int, tuple]] = {}
        work: dict[int, dict] = {j: {} for j in
                                 range(self.kfac.inv_pipeline_chunks)}
        for dim, plan in self.assignment.buckets.items():
            s = plan.slots_per_col
            row_slots = sorted(
                slot for key, slot in plan.slot.items()
                if self.assignment.layer_row[key[0]] == self.row)
            groups[dim] = {}
            for j, offs in sorted(self._chunk_plan['offsets'][dim].items()):
                cells = [c for c in self._cells[dim] if c[0] % s in offs]
                slots = index([slot for slot, _ in cells])
                if cells:
                    groups[dim][j] = (cells, slots)
                fired = [slot for slot in row_slots if slot % s in offs]
                if fired:
                    pos = [fired.index(slot) for slot, _ in cells]
                    work[j][dim] = (cells, slots, index(pos), index(fired))
        return groups, work

    def item_chunk_plan(self) -> dict[tuple, int] | None:
        """This grid's chunk plan in the single-device ``KFAC``'s items
        (:func:`item_chunk_plan`); None while firings are not
        pipelined."""
        if self._chunk_plan is None:
            return None
        return item_chunk_plan(self.assignment, self._chunk_plan)

    def firing_launches(self, chunk: int | None = None) -> int:
        """Decomposition launches (K4 or K5, under ``'newton'`` or
        ``'jacobi'``) of one firing on this rank: one per bucket it holds
        slots of, and while firings are pipelined one per bucket and
        chunk; with ``chunk``, one per bucket it holds a slot of in that
        chunk. Low-rank buckets launch neither."""
        def exact(dim):
            return self.kfac.method_for_dim(dim) != 'lowrank'
        if chunk is not None:
            return sum(bool(work[0]) for dim, work
                       in self._chunk_rows[chunk].items() if exact(dim))
        if self._chunk_plan is None:
            return sum(bool(cell) for dim, cell in self._cells.items()
                       if exact(dim))
        return sum(len(g) for dim, g in self._chunk_cells.items()
                   if exact(dim))

    def _layer_is_mixed(self, name: str) -> bool:
        if self.specs[name].kind == EMBEDDING:
            return False        # a diagonal A is neither eigen nor baked
        a_dim, g_dim = self._factor_dims[name]
        return (eigen_family(self.kfac.method_for_dim(a_dim))
                != eigen_family(self.kfac.method_for_dim(g_dim)))

    def local_work(self) -> dict:
        """What this rank launches (the same on every rank of its K-FAC
        rank): ``'decompose'``, the bucket dims it decomposes at a firing
        (it holds an assigned slot), ``'precondition'``, the gradient
        shapes its row preconditions through K3, and
        ``'stock_precondition'``, those it preconditions by stock torch
        (a low-rank side beside an eigen one)."""
        kfac = self.kfac
        stock = [shape for shape, *_ in self._row_groups
                 if all(eigen_family(kfac.method_for_dim(d)) for d in shape)
                 and any(kfac.method_for_dim(d) == 'lowrank'
                         for d in shape)]
        return {'decompose': [d for d, cell in self._cells.items() if cell],
                'precondition': [shape for shape, *_ in self._row_groups
                                 if shape not in stock],
                'stock_precondition': stock}

    # -- state ---------------------------------------------------------

    def init_state(self) -> dict:
        """Fresh state: identity factors (an embedding's diagonal A: ones;
        a grouped conv: stacks of identity blocks; replicated on every
        rank), a zero ``diag_inv`` per embedding and zero ``grouped_inv``
        block stacks per grouped conv (replicated) and this rank's row of
        each bucket, ``(slots_per_row, dim, dim)``: identity ``Q`` and unit
        ``d`` for eigen buckets (a low-rank bucket: ``r`` identity columns
        and ``r`` unit eigenvalues; plus a zero ``inv`` where a mixed layer
        bakes its eigen side), zero ``inv`` for baked ones; and the
        firing-schedule state of the ``KFAC``'s knobs (as
        ``KFAC.init_state``: this rank's zero accumulator,
        ``frozen_factors``) and, under ``collect_metrics``, fresh
        ``metrics``."""
        dev = self.device
        fdt, idt = self.kfac.storage_dtype, self.kfac.inv_dtype
        diag = self.assignment.diag_layers
        factors, grouped_inv = {}, {}
        for name in self.specs:
            if name in self.assignment.grouped_layers:
                factors[name], grouped_inv[name] = grouped_init(
                    self.specs[name], *self._factor_dims[name], fdt, idt,
                    dev)
                continue
            factors[name] = {
                side: (torch.ones(dim, dtype=fdt, device=dev)
                       if side == 'A' and name in diag else
                       torch.eye(dim, dtype=fdt, device=dev))
                for side, dim in zip('AG', self._factor_dims[name])}
        diag_inv = {name: torch.zeros(self._factor_dims[name][0],
                                      dtype=idt, device=dev)
                    for name in diag}
        stacks = {}
        for dim, plan in self.assignment.buckets.items():
            n = plan.slots_per_row
            entry = {}
            for key in self._stack_keys(dim):
                shape = (n, *self._slot_shape(dim, key))
                entry[key] = (
                    torch.eye(*shape[1:], dtype=idt, device=dev).repeat(
                        n, 1, 1) if key == 'Q' else
                    torch.ones(shape, dtype=idt, device=dev) if key == 'd'
                    else torch.zeros(shape, dtype=idt, device=dev))
            stacks[str(dim)] = entry
        return self.kfac._seed_metrics(self.kfac._seed_overlap_state(
            {'step': 0, 'factors': factors, 'inv_stacks': stacks,
             'diag_inv': diag_inv, 'grouped_inv': grouped_inv,
             'inv_chunk_phase': 0}))

    # -- factors -------------------------------------------------------

    def local_factor_contribs(self, captures: dict) -> dict:
        """This rank's covariance contributions (``KFAC.
        local_factor_contribs``: K1 in its contraction-only form, K2 for
        conv A, a tied embedding's attend-site parts kept apart until
        :meth:`update_factors` has scaled them)."""
        return self.kfac.local_factor_contribs(captures)

    def _flat_mean(self, parts: list, group, size: int,
                   scope: str) -> list:
        """The mean of fp32 ``parts`` over the ``size`` ranks of ``group``
        (None: the world) as one flat ``all_reduce`` under the profiler
        scope ``scope``, each 2-D part triangle-packed with
        ``symmetry_aware_comm``; a group of one rank runs no
        collective."""
        packed = self.kfac.symmetry_aware_comm
        wire = [F.pack_symmetric(t) if packed and t.ndim == 2 else t
                for t in parts]
        sizes = [t.numel() for t in wire]
        flat = torch.cat([t.reshape(-1) for t in wire])
        if size > 1:
            with profiling.annotate(scope):
                dist.all_reduce(flat, group=group)
            flat /= size
        return [F.unpack_symmetric(v.view(sent.shape), t.shape[-1])
                if sent is not t else v.view(t.shape)
                for v, sent, t in zip(flat.split(sizes), wire, parts)]

    @profiling.scope('kfac/factors')
    def update_factors(self, state: dict, contribs: dict,
                       factor_decay=None) -> dict:
        """Average the ranks' contributions (one ``all_reduce`` over the
        world, each 2-D part triangle-packed with ``symmetry_aware_comm``;
        the output-grad-quadratic parts, ``layers.GRAD_QUADRATIC_KEYS``,
        times ``1/W^2``), fold a tied embedding's ``A_g2`` into its A and
        ``G_a`` into its G, and EMA them into the factors (the stored
        factors widened, blended in fp32 and rounded to their dtype)."""
        kfac = self.kfac
        alpha = kfac.factor_decay if factor_decay is None else factor_decay
        w = self.world_size
        packed = kfac.symmetry_aware_comm
        # The grad-quadratic parts last, so one slice takes their scale.
        keys = sorted(((n, k) for n in self.specs for k in contribs[n]),
                      key=lambda nk: nk[1] in L.GRAD_QUADRATIC_KEYS)
        n_plain = sum(k not in L.GRAD_QUADRATIC_KEYS for _, k in keys)
        parts = [contribs[n][k] for n, k in keys]
        wire = [F.pack_symmetric(t) if packed and t.ndim == 2 else t
                for t in parts]
        sizes = [t.numel() for t in wire]
        flat = torch.cat([t.reshape(-1) for t in wire])
        with profiling.annotate('kfac/comm/factor_allreduce'):
            dist.all_reduce(flat)
        if w > 1:
            flat /= w                                    # the mean
            flat[sum(sizes[:n_plain]):] /= w ** 2        # G, A_g2: 1/W^2
        means = {}
        for key, v, sent, t in zip(keys, flat.split(sizes), wire, parts):
            v = v.view(sent.shape)
            means[key] = (F.unpack_symmetric(v, t.shape[-1])
                          if sent is not t else v)
        news = []
        for n in self.specs:
            for side, extra in (('A', 'A_g2'), ('G', 'G_a')):
                new = means[n, side]
                news.append(new if (n, extra) not in means
                            else new + means[n, extra])
        olds = [state['factors'][n][s] for n in self.specs for s in 'AG']
        # F.update_running_avg over the whole list at once, rounded as
        # kernels.ema_blend (so a one-rank world gives the single-device
        # step's bits, K1's fused blend included).
        ema = torch._foreach_mul([o.float() for o in olds], alpha)
        torch._foreach_add_(ema, news, alpha=kernels.ema_new_weight(alpha))
        ema = [e.to(o.dtype) for e, o in zip(ema, olds)]
        return {n: {'A': a, 'G': g}
                for n, a, g in zip(self.specs, ema[0::2], ema[1::2])}

    @profiling.scope('kfac/factors')
    def accumulate_factors(self, state: dict, captures: dict | None,
                           factor_decay=None, *,
                           contribs: dict | None = None
                           ) -> tuple[dict, Any]:
        """Deferred-reduction factor step, with no collective: this rank
        folds its own contributions into its local accumulator, ``acc <-
        alpha acc + (1 - alpha) c``, and ``decay <- alpha decay``
        (``KFAC.blend_factors``: K1's fused blend with the accumulator as
        ``old`` where it applies; precomputed ``contribs``, such as an
        accumulated step's micro-batch mean, through ``KFAC.
        blend_contribs``). ``c`` takes the scale :meth:`update_factors`
        gives the world's mean (the output-grad-quadratic parts times
        ``1/W^2``), so that the window head's mean of the accumulators is
        the eager recursion's value. Returns ``(new_accum, new_decay)``.

        Under ``hierarchical_reduce`` the contributions are first averaged
        over this rank's slice (one flat fp32 ``all_reduce``), so every rank
        of a slice folds the slice's mean into the same accumulator (through
        ``KFAC.blend_contribs``)."""
        kfac = self.kfac
        alpha = kfac.factor_decay if factor_decay is None else factor_decay
        if kfac.hierarchical_reduce:
            if contribs is None:
                contribs = self.local_factor_contribs(captures)
            keys = [(n, k) for n in self.specs for k in contribs[n]]
            means = self._flat_mean([contribs[n][k].float() for n, k in keys],
                                    self.groups.slice_group,
                                    len(self.groups.slice_ranks),
                                    'kfac/comm/factor_allreduce_intra')
            contribs = {n: {} for n in self.specs}
            for (n, k), m in zip(keys, means):
                contribs[n][k] = m
        quad = 1.0 / self.world_size ** 2
        acc = (kfac.blend_contribs(state['factor_accum'], contribs, alpha,
                                   quad_scale=quad)
               if contribs is not None else
               kfac.blend_factors(state['factor_accum'], captures, alpha,
                                  quad_scale=quad))
        return acc, alpha * state['accum_decay']

    @profiling.scope('kfac/factors')
    def reduce_factors(self, state: dict, acc: dict, decay) -> dict:
        """Window head of the deferred reduction: one flat fp32
        ``all_reduce`` of every rank's accumulator over the world (each 2-D
        part triangle-packed with ``symmetry_aware_comm``), then ``F <-
        decay F + mean(acc)``, blended in fp32 and rounded once to the
        storage dtype. Under ``hierarchical_reduce`` the accumulators hold
        slice means, and the ``all_reduce`` runs over the ranks of this
        rank's in-slice index across the slices."""
        parts = [acc[n][s].float() for n in self.specs for s in 'AG']
        if self.kfac.hierarchical_reduce:
            means = self._flat_mean(parts, self.groups.cross_group,
                                    self.num_slices,
                                    'kfac/comm/factor_reduce_dcn')
        else:
            means = self._flat_mean(parts, None, self.world_size,
                                    'kfac/comm/factor_reduce')
        olds = [state['factors'][n][s] for n in self.specs for s in 'AG']
        new = [(decay * o.float() + m).to(o.dtype)
               for o, m in zip(olds, means)]
        return {n: {'A': a, 'G': g}
                for n, a, g in zip(self.specs, new[0::2], new[1::2])}

    # -- inverses ------------------------------------------------------

    @profiling.scope('kfac/inverses')
    def update_inverses(self, factors: dict, damping=None,
                        prev_stacks: dict | None = None, *,
                        chunk: int | None = None,
                        prev_diag: dict | None = None,
                        prev_grouped: dict | None = None) -> dict:
        """A firing, ``{'inv_stacks', 'diag_inv', 'grouped_inv'}``.

        Monolithic (``chunk`` None): this rank decomposes its assigned slots of
        every bucket, then one ``all_reduce`` SUM over its row assembles the
        row's stacks (a masked-sum gather: each slot is nonzero on one rank
        only); every rank inverts every embedding's diagonal A elementwise at
        ``damping`` and every grouped conv's block stacks
        (``preconditioner.grouped_block_inverses``). While firings are
        pipelined (and ``prev_stacks`` are given) the slots are decomposed
        chunk group by chunk group, as the chunk firings stack them, so that a
        window of chunk firings over frozen factors gives the monolithic
        firing's bits.

        ``chunk=j`` (with ``prev_stacks``, ``prev_diag`` and ``prev_grouped``):
        only the slot offsets, diagonal inverses and grouped block stacks the
        chunk plan gives chunk ``j``. Each rank decomposes its fired slots into
        a zeroed stack of the row's fired slots alone, one ``all_reduce`` SUM
        over the row assembles it (every rank of a row joins, whether it holds
        a fired slot or not; a row with no fired slot runs none), and the
        result is written into the stored row stacks at those slots; every
        other slot, padding included, keeps its value bit for bit.

        Eigen buckets: the warm polish seeded from ``prev_stacks``' bases
        of the same slots (``eigh_method`` 'auto'/'warm'; without
        ``prev_stacks`` the library eigh), the library eigh (``'xla'``) or
        K5 (``'jacobi'``); a mixed layer's eigen side is also baked into
        ``inv`` at ``damping``. Other buckets: damped inverses by K4
        (``'newton'``) or Cholesky. Every decomposition runs in fp32 on
        the widened factors (the polish from the stored bases widened), the
        row gather sums fp32 stacks, and the results are cast to
        ``inv_dtype`` after it.
        """
        kfac = self.kfac
        damping = kfac.damping if damping is None else damping
        pipelined = self._chunk_plan is not None and prev_stacks is not None
        if chunk is not None:
            if not pipelined:
                raise ValueError(
                    'inv_chunk requires inv_pipeline_chunks > 1 (or '
                    'inv_staleness=1) and stored inverse stacks')
            return self._fire_chunk(factors, damping, prev_stacks,
                                    prev_diag, prev_grouped, chunk)
        dev = self.device
        stacks = {}
        for dim, plan in self.assignment.buckets.items():
            n = plan.slots_per_row
            entry = {key: torch.zeros((n, *self._slot_shape(dim, key)),
                                      device=dev)
                     for key in self._stack_keys(dim)}
            groups = (list(self._chunk_cells[dim].values()) if pipelined
                      else [(self._cells[dim], self._cell_idx[dim])]
                      if self._cells[dim] else [])
            for cells, idx in groups:
                out = self._decompose(dim, cells, idx, factors, damping,
                                      prev_stacks)
                for key, t in out.items():
                    entry[key][idx] = t
            stacks[str(dim)] = entry
        group = self.groups.inv_group
        if group is not None:
            keys = [(d, k) for d, e in stacks.items() for k in e]
            with profiling.annotate('kfac/comm/inverse_allgather'):
                reduced = _all_reduce_sum([stacks[d][k] for d, k in keys],
                                          group)
            for (d, k), t in zip(keys, reduced):
                stacks[d][k] = t
        idt = kfac.inv_dtype
        stacks = {d: {k: t.to(idt) for k, t in e.items()}
                  for d, e in stacks.items()}
        diag_inv = {name: self._diag_inverse(factors, name, damping)
                    for name in self.assignment.diag_layers}
        grouped_inv = {name: grouped_block_inverses(factors[name], damping,
                                                    idt)
                       for name in self.assignment.grouped_layers}
        return {'inv_stacks': stacks, 'diag_inv': diag_inv,
                'grouped_inv': grouped_inv}

    def _stack_keys(self, dim: int) -> tuple[str, ...]:
        """The row-stack keys of a bucket: ``Q`` and ``d`` for eigen
        (with ``inv`` where a mixed layer bakes its eigen side), ``inv``
        for baked ones."""
        if not eigen_family(self.kfac.method_for_dim(dim)):
            return ('inv',)
        return ('Q', 'd', 'inv') if self._bucket_mixed.get(dim) else ('Q', 'd')

    def _slot_shape(self, dim: int, key: str) -> tuple[int, ...]:
        """The shape of one slot of a bucket's stack ``key``: ``(dim, r)``
        bases and ``(r,)`` eigenvalues (``r = dim`` unless the bucket is
        low-rank), ``(dim, dim)`` baked inverses."""
        r = self.kfac.lowrank_rank_for(dim) or dim
        return {'Q': (dim, r), 'd': (r,), 'inv': (dim, dim)}[key]

    def _decompose(self, dim: int, cells: list, idx, factors: dict,
                   damping, prev_stacks: dict | None) -> dict:
        """Decompose the factors of ``cells`` (``(in-row slot, key)``) as
        one stack: ``{stack key: (len(cells), ...) fp32}``; ``idx`` (their
        slots, a device index) picks the warm polish's previous bases. A
        low-rank bucket runs ``linalg.batched_lowrank_eigh``, warm from
        the stored bases whatever ``eigh_method`` says."""
        kfac = self.kfac
        method = linalg.resolve_eigh_method(kfac.eigh_method)
        bucket_method = kfac.method_for_dim(dim)
        local = torch.stack([factors[name][side].float()
                             for _, (name, side) in cells])
        if not eigen_family(bucket_method):
            return {'inv': kernels.damped_inverse_stack(
                local, damping, bucket_method, iters=kfac.newton_iters)}
        q_prev = None
        lowrank = bucket_method == 'lowrank'
        if prev_stacks is not None and (lowrank or method == 'auto'):
            q_prev = prev_stacks[str(dim)]['Q'][idx].float()
        if lowrank:
            q, d = linalg.batched_lowrank_eigh(
                local, kfac.inv_lowrank_rank, q_prev=q_prev,
                polish_iters=kfac.eigh_polish_iters)
        else:
            q, d = linalg.batched_eigh(local, method, clip=0.0,
                                       q_prev=q_prev,
                                       polish_iters=kfac.eigh_polish_iters)
        out = {'Q': q, 'd': d}
        if self._bucket_mixed.get(dim):
            out['inv'] = linalg.eigen_side_inverse(q, d, damping)
        return out

    def _diag_inverse(self, factors: dict, name: str, damping):
        return linalg.get_elementwise_inverse(
            factors[name]['A'].float(), damping).to(self.kfac.inv_dtype)

    def _fire_chunk(self, factors: dict, damping, prev_stacks: dict,
                    prev_diag: dict, prev_grouped: dict, chunk: int
                    ) -> dict:
        """Chunk ``chunk`` of a pipelined firing (:meth:`update_inverses`):
        the row's fired slots on a zeroed fp32 stack, one masked-sum
        ``all_reduce`` over the row, written into copies of the stored
        stacks at the fired slots."""
        dev = self.device
        parts, targets = [], []
        for dim, (cells, idx, pos, fired) in self._chunk_rows[chunk].items():
            sub = {key: torch.zeros((len(fired), *self._slot_shape(dim, key)),
                                    device=dev)
                   for key in self._stack_keys(dim)}
            if cells:
                out = self._decompose(dim, cells, idx, factors, damping,
                                      prev_stacks)
                for key, t in out.items():
                    sub[key][pos] = t
            for key, t in sub.items():
                parts.append(t)
                targets.append((dim, key, fired))
        group = self.groups.inv_group
        if group is not None and parts:
            with profiling.annotate('kfac/comm/inverse_allgather'):
                parts = _all_reduce_sum(parts, group)
        idt = self.kfac.inv_dtype
        stacks = {d: dict(e) for d, e in prev_stacks.items()}
        for (dim, key, fired), t in zip(targets, parts):
            stored = stacks[str(dim)][key].clone()
            stored[fired] = t.to(idt)
            stacks[str(dim)][key] = stored
        diag_inv = {
            name: (self._diag_inverse(factors, name, damping)
                   if self._chunk_plan['diag'][name] == chunk
                   else prev_diag[name])
            for name in self.assignment.diag_layers}
        grouped_inv = {
            name: (grouped_block_inverses(factors[name], damping, idt)
                   if self._chunk_plan['grouped'][name] == chunk
                   else prev_grouped[name])
            for name in self.assignment.grouped_layers}
        return {'inv_stacks': stacks, 'diag_inv': diag_inv,
                'grouped_inv': grouped_inv}

    # -- preconditioning -----------------------------------------------

    @profiling.scope('kfac/precond')
    def precondition(self, state: dict, grads: dict, damping, lr,
                     with_stats: bool = False, gates: dict | None = None):
        """Precondition this row's layers (K3 per shape group, stock torch
        for a group with a low-rank side; each embedding with its diagonal
        A inverse from ``state['diag_inv']``; each grouped conv with its
        block stacks from ``state['grouped_inv']``),
        deliver every layer's result over the column, and apply the KL-clip
        scale ``nu = min(1, sqrt(kl_clip / |sum lr^2 v.g|))``;
        unregistered gradients pass through. ``with_stats`` returns
        ``(out, stats)``: ``observability.metrics.precond_stats`` of the
        delivered matrices and, under ``'eig_clipped'``, the clip count of
        the whole grid's stacks (this row's held slots, summed over the
        rows in the delivery's ``all_reduce``).

        ``gates`` (the self-healing quarantine, ``KFAC.precondition``):
        each row blends its own layers (``preconditioner.gate_blend``)
        before its ``v.g`` partial, which rides the delivery's column
        ``all_reduce`` as before (no collective added); with gates every
        layer's ``v.g`` is the full-tensor reduction."""
        kfac = self.kfac
        dev = self.device
        inv_stacks = state['inv_stacks']
        grad_mats = {
            name: L.grads_to_matrix(spec, kfac._layer_params(name, grads))
            for name, spec in self.specs.items()}
        cdt = kfac.precond_compute_dtype
        mats, vg = {}, {}
        for (g_dim, a_dim), names, a_idx, g_idx in self._row_groups:
            gstack = torch.stack([grad_mats[n].float() for n in names])
            a_stack, g_stack = inv_stacks[str(a_dim)], inv_stacks[str(g_dim)]
            if (eigen_family(kfac.method_for_dim(a_dim))
                    and eigen_family(kfac.method_for_dim(g_dim))):
                entry = {'QA': a_stack['Q'][a_idx], 'dA': a_stack['d'][a_idx],
                         'QG': g_stack['Q'][g_idx], 'dG': g_stack['d'][g_idx]}
            else:
                entry = {'A_inv': a_stack['inv'][a_idx],
                         'G_inv': g_stack['inv'][g_idx]}
            if kfac.fused_precondition and not truncated_entry(entry):
                with profiling.annotate(precond_scope(entry)):
                    vs, vgs = kernels.bucket_precond(gstack, entry, damping,
                                                     compute_dtype=cdt)
                for i, n in enumerate(names):
                    vg[n] = vgs[i]
            else:
                vs = linalg.precondition_dispatch(gstack, entry, damping,
                                                  compute_dtype=cdt)
            for i, n in enumerate(names):
                mats[n] = vs[i]
        for name in self.assignment.diag_layers:
            if self.assignment.layer_row[name] != self.row:
                continue
            g_dim = self._factor_dims[name][1]
            g_stack = inv_stacks[str(g_dim)]
            slot = self.assignment.buckets[g_dim].slot[(name, 'G')]
            entry = ({'QG': g_stack['Q'][slot], 'dG': g_stack['d'][slot]}
                     if eigen_family(kfac.method_for_dim(g_dim))
                     else {'G_inv': g_stack['inv'][slot]})
            mats[name] = linalg.precondition_dispatch(
                grad_mats[name], entry, damping,
                diag_a=state['diag_inv'][name], compute_dtype=cdt)
        for name in self.assignment.grouped_layers:
            if self.assignment.layer_row[name] == self.row:
                mats[name] = linalg.precondition_dispatch(
                    grad_mats[name], state['grouped_inv'][name], damping,
                    compute_dtype=cdt)
        if gates is not None:
            mats = gate_blend(mats, grad_mats, gates)
        # This row's v.g partial, in registration order.
        vg_sum = torch.zeros((), dtype=torch.float32, device=dev)
        if kfac.kl_clip is not None:
            for name in self.specs:
                if gates is None and name in vg:
                    vg_sum = vg_sum + vg[name] * lr ** 2
                elif name in mats:
                    vg_sum = vg_sum + torch.sum(
                        mats[name] * grad_mats[name].float() * lr ** 2)
        clipped = (obs_metrics.count_clipped_eigvals_stacks(
            inv_stacks, dev, self._held_slots).float().reshape(1)
                   if with_stats else None)
        group = self.groups.grad_group
        if group is not None:
            parts = [vg_sum] + [
                mats[n] if n in mats else torch.zeros(
                    grad_mats[n].shape, dtype=torch.float32, device=dev)
                for n in self.specs]
            with profiling.annotate('kfac/comm/grad_psum'):
                if with_stats:
                    # Exact in fp32: the counts stay far below 2**24.
                    *parts, clipped = _all_reduce_sum([*parts, clipped],
                                                      group)
                    vg_sum, *delivered = parts
                else:
                    vg_sum, *delivered = _all_reduce_sum(parts, group)
            mats = dict(zip(self.specs, delivered))
        if kfac.kl_clip is not None:
            nu = torch.clamp(torch.sqrt(
                kfac.kl_clip / (vg_sum.abs() + 1e-30)), max=1.0)
        else:
            nu = torch.ones((), dtype=torch.float32, device=dev)
        self.last_nu = nu
        out = dict(grads)
        for name, spec in self.specs.items():
            like = kfac._layer_params(name, grads)
            new = L.matrix_to_grads(spec, nu * mats[name], like)
            for key, t in new.items():
                out[f'{name}.{key}'] = t.to(like[key].dtype)
        if with_stats:
            stats = obs_metrics.precond_stats(grad_mats, mats, nu,
                                              kfac.stats_cache)
            stats['eig_clipped'] = clipped.reshape(()).to(torch.int32)
            return out, stats
        return out

    # -- the step ------------------------------------------------------

    def step(self, state: dict, grads: dict, captures: dict | None = None,
             *, contribs: dict | None = None,
             damping=None, lr=None, factor_decay=None,
             factor_update_freq=None, inv_update_freq=None,
             factor_update: bool | None = None,
             inv_update: bool | None = None,
             inv_chunk: int | None = None,
             factor_reduce: bool = False,
             factor_snapshot: bool = False,
             gates: dict | None = None) -> tuple[dict, dict]:
        """One distributed K-FAC update, ``(preconditioned_grads,
        new_state)``, with ``KFAC.step``'s cadence semantics and flags
        (``inv_chunk``, ``factor_reduce``, ``factor_snapshot``). ``grads``
        must already be averaged over the world; ``captures`` are this
        rank's own, or ``contribs`` its precomputed contributions
        (:meth:`local_factor_contribs`; an accumulated step's micro-batch
        mean, whose ``1/N`` and ``1/N^2`` compose with the world's ``1/W``
        and ``1/W^2``) in their place."""
        kfac = self.kfac
        damping = kfac.damping if damping is None else damping
        lr = kfac.lr if lr is None else lr
        f_freq = (kfac.factor_update_freq if factor_update_freq is None
                  else factor_update_freq)
        i_freq = (kfac.inv_update_freq if inv_update_freq is None
                  else inv_update_freq)
        step = state['step']
        if captures is None and contribs is None:
            raise ValueError('pass captures or contribs')
        overlap = {}
        if kfac.window_reduce:
            if factor_update is None:
                raise ValueError(
                    'deferred_factor_reduction requires static cadence '
                    'flags (Python-bool factor_update/factor_reduce) — '
                    'the window-boundary reduce is static program '
                    'structure, like inv_chunk')
            acc, decay = state['factor_accum'], state['accum_decay']
            if factor_update:
                acc, decay = self.accumulate_factors(
                    state, captures, factor_decay, contribs=contribs)
            finite = None
            if factor_reduce:
                # The guard checks the post-all_reduce candidate: the same
                # on every rank, so a non-finite window is skipped
                # everywhere (and the accumulator resets either way).
                factors, finite = kfac.guard_factors(
                    self.reduce_factors(state, acc, decay), state['factors'])
                acc = {n: {k: torch.zeros_like(t) for k, t in e.items()}
                       for n, e in acc.items()}
                decay = torch.ones((), dtype=torch.float32,
                                   device=self.device)
            else:
                factors = state['factors']
            overlap = {'factor_accum': acc, 'accum_decay': decay}
        else:
            if factor_reduce:
                raise ValueError('factor_reduce requires '
                                 'deferred_factor_reduction=True or '
                                 'hierarchical_reduce=True')
            if factor_update is None:
                factor_update = step % f_freq == 0
            if factor_update and contribs is None:
                contribs = self.local_factor_contribs(captures)
            factors, finite = (kfac.guard_factors(
                self.update_factors(state, contribs, factor_decay),
                state['factors'])
                               if factor_update else (state['factors'], None))
        fire_factors = factors
        if kfac.inv_staleness:
            if inv_update is None:
                raise ValueError(
                    'inv_staleness=1 requires static cadence flags '
                    '(the frozen-snapshot firing schedule is static '
                    'program structure, like inv_chunk)')
            fire_factors = (factors if factor_snapshot or inv_update
                            else state['frozen_factors'])
            overlap['frozen_factors'] = fire_factors
        elif factor_snapshot:
            raise ValueError('factor_snapshot requires inv_staleness=1')
        if inv_chunk is not None:
            k = kfac.inv_pipeline_chunks
            if inv_update:
                raise ValueError(
                    'inv_chunk is mutually exclusive with '
                    'inv_update=True (a monolithic firing already '
                    'covers every chunk)')
            if not 0 <= inv_chunk < k:
                raise ValueError(f'{inv_chunk=} out of range for '
                                 f'inv_pipeline_chunks={k}')
            with profiling.annotate(f'kfac/inverse/chunk{inv_chunk}'):
                inverses = self.update_inverses(
                    fire_factors, damping, state['inv_stacks'],
                    chunk=inv_chunk, prev_diag=state['diag_inv'],
                    prev_grouped=state['grouped_inv'])
            chunk_phase = (inv_chunk + 1) % k
        else:
            if inv_update is None:
                inv_update = step % i_freq == 0
            inverses = (self.update_inverses(fire_factors, damping,
                                             state['inv_stacks'])
                        if inv_update else {k: state[k] for k in
                                            INVERSE_KEYS})
            chunk_phase = 0 if inv_update else state['inv_chunk_phase']
        new_state = {'step': step + 1, 'factors': factors, **inverses,
                     'inv_chunk_phase': chunk_phase, **overlap}
        if not kfac.collect_metrics:
            return (self.precondition(new_state, grads, damping, lr,
                                      gates=gates), new_state)
        precond, stats = self.precondition(new_state, grads, damping, lr,
                                           with_stats=True, gates=gates)
        new_state['metrics'] = obs_metrics.update_metrics(
            state['metrics'], damping=damping, stats=stats,
            did_factor=bool(factor_update),
            did_inv=inv_chunk is None and bool(inv_update),
            did_chunk=inv_chunk is not None, factor_finite=finite,
            eig_clipped=stats['eig_clipped'])
        return precond, new_state

    # -- straggler probe ----------------------------------------------

    def build_barrier_probe(self):
        """``probe() -> wait_ms``: a warmed 0-dim fp32 ``all_reduce`` over
        the world (every K-FAC collective's ranks) on this rank's device,
        timed between two synchronizes
        (``observability.stragglers.build_barrier_probe``)."""
        from distributed_kfac_pytorch_tpu_torch.observability import \
            stragglers
        return stragglers.build_barrier_probe(None, self.device)

    # -- checkpointing -------------------------------------------------

    def _layout(self) -> dict:
        """The grid position a rank's row stacks belong to (with more than
        one slice, also the slice count and this rank's slice)."""
        out = {'row': self.row, 'n_rows': self.n_rows,
               'n_cols': self.n_cols, 'seq_parallel': self.seq_parallel}
        if self.num_slices > 1:
            out.update(num_slices=self.num_slices, slice=self.groups.slice)
        return out

    def state_dict(self, state: dict, include_inverses: bool = True
                   ) -> dict:
        """Checkpointable state: step and factors (the same on every
        rank), the firing-schedule state where its knob is on (this
        rank's own accumulator, ``frozen_factors``) and, with
        ``include_inverses``, this rank's row stacks with
        the grid position they belong to (and ``seq_parallel``) and the
        embeddings' diagonal inverses and the grouped convs' block
        stacks."""
        out = {'step': state['step'], 'factors': state['factors'],
               'inv_chunk_phase': state.get('inv_chunk_phase', 0)}
        for key in OVERLAP_KEYS:
            if key in state:
                out[key] = state[key]
        if include_inverses:
            for key in INVERSE_KEYS:
                out[key] = state[key]
            out['inv_layout'] = self._layout()
        return out

    def load_state_dict(self, sd: dict, *, damping=None) -> dict:
        """Rebuild the state from :meth:`state_dict` output (collective).

        The layer sets must match. Saved row stacks, diagonal inverses and
        grouped block stacks are used when the stacks were written for this
        rank's row of the same grid and ``seq_parallel``, with the same keys
        and shapes, and every slot this rank decomposes holds a nonzero basis;
        otherwise every rank recomputes its inverses from the factors
        (:meth:`recompute_inverses`). Factors and inverses take the ``KFAC``'s
        storage dtypes; the firing-schedule state is restored as
        ``KFAC.load_state_dict`` restores it.
        """
        state = self.init_state()
        if set(sd['factors']) != set(state['factors']):
            raise ValueError(
                'checkpoint layers do not match registered layers: '
                f'{sorted(sd["factors"])} vs {sorted(state["factors"])}')
        fdt, idt = self.kfac.storage_dtype, self.kfac.inv_dtype
        factors = {n: {k: t.to(self.device, fdt) for k, t in f.items()}
                   for n, f in sd['factors'].items()}
        state = {**state, 'step': int(sd['step']), 'factors': factors,
                 'inv_chunk_phase': int(sd.get('inv_chunk_phase', 0))}
        state = overlay_overlap_state(state, sd)
        saved = sd.get('inv_stacks')
        ok = (saved is not None and sd.get('inv_layout') == self._layout()
              and set(sd.get('diag_inv', ())) == set(state['diag_inv'])
              and _same_layout(sd.get('grouped_inv', {}),
                               state['grouped_inv'])
              and all(set(saved.get(d, ())) == set(e)
                      and all(tuple(saved[d][k].shape) == tuple(t.shape)
                              for k, t in e.items())
                      for d, e in state['inv_stacks'].items()))
        ok = ok and self._holds_bases(saved)
        # Every rank must take the same branch: recomputing is collective.
        flag = torch.tensor([0.0 if ok else 1.0], device=self.device)
        dist.all_reduce(flag)
        if flag.item() == 0.0:
            state['inv_stacks'] = {d: {k: t.to(self.device, idt)
                                       for k, t in e.items()}
                                   for d, e in saved.items()}
            state['diag_inv'] = {n: t.to(self.device, idt)
                                 for n, t in sd['diag_inv'].items()}
            state['grouped_inv'] = {
                n: {k: t.to(self.device, idt) for k, t in e.items()}
                for n, e in sd.get('grouped_inv', {}).items()}
            return state
        return self.recompute_inverses(state, damping=damping)

    def _holds_bases(self, stacks: dict) -> bool:
        """Whether every eigen slot this rank decomposes holds a nonzero
        basis. Other slots of a row stack may be zero: padding, and the
        slots of layers placed on other rows."""
        for dim, cell in self._cells.items():
            q = stacks[str(dim)].get('Q')
            if cell and q is not None:
                mine = q.to(self.device)[self._cell_idx[dim]].flatten(1)
                if not bool(mine.any(dim=1).all()):
                    return False
        return True

    def recompute_inverses(self, state: dict, damping=None) -> dict:
        """Every rank's row stacks, diagonal inverses and grouped block
        stacks rebuilt from the current factors (a collective; eigen buckets by
        the library eigh
        under 'auto')."""
        return {**state, **self.update_inverses(state['factors'], damping)}
