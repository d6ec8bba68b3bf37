"""Straggler attribution: per-rank sink shards, the barrier probe and
the readers (PyTorch port of
``distributed_kfac_pytorch_tpu/observability/stragglers.py``).

  - **Rank shards** (:func:`make_rank_shard_sink`): every rank of a run
    with ``--straggler-shards`` writes its own stream ``<path>.rank<r>``
    next to the rank-0 stream (a ``JsonlMetricsSink`` enabled for its
    rank), each step record carrying that rank's host step time, its
    fired stage and, on sampled steps, its pre-collective barrier wait
    (``host/barrier_wait_ms``).
  - **Barrier probe** (:func:`build_barrier_probe`, surfaced as
    ``DistributedKFAC.build_barrier_probe``): a 0-dim fp32 ``all_reduce``
    over the K-FAC world, timed between two ``torch.cuda.synchronize``
    calls. The first synchronize drains this rank's own queue, so the
    timed span is the wait for the slowest rank to arrive at the
    collective (plus the collective itself): the wait this rank's next
    K-FAC collective would pay. A fast rank measures large waits, the
    straggler ~0. Synchronizing costs the step its overlap of host and
    device, so the probe is opt-in and sampled
    (``--straggler-sample-every``).
  - **Readers** (:func:`merge_shards`, :func:`straggler_summary`):
    torn- and fault-tolerant; per-host skew, slowest-rank frequency and
    barrier-wait attribution, which ``observability.report`` prints. They
    read shards of either package.
"""

from __future__ import annotations

import os
import re

from distributed_kfac_pytorch_tpu_torch.observability import sink as obs_sink
from distributed_kfac_pytorch_tpu_torch.observability.sink import (
    percentile as _percentile,
    to_float as _num,
)

# Metrics key carrying the probe measurement inside shard step records.
BARRIER_WAIT_KEY = 'host/barrier_wait_ms'


def rank_shard_path(path: str, rank: int) -> str:
    """``run.jsonl`` -> ``run.jsonl.rank<r>`` (one shard per host)."""
    return f'{path}.rank{int(rank)}'


def make_rank_shard_sink(path: str, process_index: int, *,
                         rotate_bytes: int | None = 4 * 1024 * 1024,
                         drain_every: int = 64,
                         meta: dict | None = None
                         ) -> obs_sink.JsonlMetricsSink:
    """A writing sink at ``rank_shard_path(path, rank)`` on every rank
    (the shard path itself is the rank gate); its meta record pins the
    rank, so the merger can check the file name against the content."""
    shard_meta = {'rank': int(process_index), **(meta or {})}
    return obs_sink.JsonlMetricsSink(
        rank_shard_path(path, process_index), process_index=0,
        rotate_bytes=rotate_bytes, drain_every=drain_every,
        meta=shard_meta)


def sampled(step: int, every: int) -> bool:
    """Whether the barrier probe runs at global ``step`` (every rank
    samples the same steps: a pure function of the step)."""
    return every <= 1 or step % every == 0


def build_barrier_probe(group=None, device=None):
    """Warm a 0-dim fp32 ``all_reduce`` barrier over ``group`` (None: the
    world) on ``device`` and return ``probe() -> wait_ms``: synchronize
    the card, time one ``all_reduce`` and the synchronize after it (see
    the module docstring). The warm-up collective runs here, so the
    first measured probe pays no set-up."""
    import time

    import torch
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch.observability import profiling

    device = torch.device(device if device is not None else 'cpu')
    cuda = device.type == 'cuda'
    x = torch.zeros((), dtype=torch.float32, device=device)

    def reduce() -> None:
        with profiling.annotate('kfac/comm/barrier_probe'):
            dist.all_reduce(x, group=group)
        if cuda:
            torch.cuda.synchronize(device)

    if cuda:
        torch.cuda.synchronize(device)
    reduce()

    def probe() -> float:
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        reduce()
        return (time.perf_counter() - t0) * 1000.0

    return probe


def find_shards(path: str) -> dict[int, str]:
    """Rank shards written next to a stream: ``{rank: shard_path}``.

    Matches exactly ``<basename>.rank<digits>`` in the stream's
    directory — rotated shard segments (``.rank0.1``) and incarnations
    (``.rank0.prev.1``) belong to their shard's own reader, not here.
    """
    parent = os.path.dirname(os.path.abspath(path)) or '.'
    base = os.path.basename(path)
    pat = re.compile(re.escape(base) + r'\.rank(\d+)$')
    out = {}
    try:
        names = os.listdir(parent)
    except FileNotFoundError:
        return {}
    for name in names:
        m = pat.match(name)
        if m:
            out[int(m.group(1))] = os.path.join(parent, name)
    return dict(sorted(out.items()))


def merge_shards(path: str, validate: bool = True
                 ) -> tuple[dict[int, list[dict]], int, dict[int, str]]:
    """Read every rank shard of a stream (torn- and fault-tolerant).

    Returns ``({rank: records}, total_torn_lines, {rank: error})``.
    Each shard is a full ``read_jsonl`` stream (rotated segments
    stitch in), read with the tolerant tail. A shard that fails to
    read ANYWAY (mid-file corruption, schema-invalid line — e.g. an
    NFS half-write from a sick host) is skipped and reported in the
    errors map rather than raised: one bad host must not make the
    whole mesh's telemetry — or the intact rank-0 report — unreadable.
    """
    shards, torn, errors = {}, 0, {}
    for rank, shard in find_shards(path).items():
        try:
            records, t = obs_sink.read_jsonl_tolerant(shard, validate)
        except (OSError, ValueError) as e:
            errors[rank] = str(e)
            continue
        shards[rank] = records
        torn += t
    return shards, torn, errors


def stage_class(fired) -> str:
    """Comm-wait attribution class of a step's ``fired`` label.

    'dcn' = steps that pay the inter-slice factor reduce
    (hierarchical runs relabel the window-boundary 'reduce' to
    'dcn_reduce' — its wait is slow-interconnect wait, the number the
    flat-vs-hierarchical decision rule reads, so it gets its own
    bucket rather than folding into 'factor'); 'factor' = steps that
    pay a factor-statistics collective (the eager per-step mean,
    the deferred window-boundary 'reduce', and compound
    firing+reduce labels); 'firing' = collective-free inverse/chunk
    decomposition steps; 'compile' = first-call compile steps (their
    timing is compile wall, not steady state); 'plain' = everything
    else. The factor-vs-plain wait split is how an overlap win
    (deferred reduce / staleness) reads directly from the JSONL,
    without a profile timeline.
    """
    if isinstance(fired, str) and 'dcn' in fired:
        # Must precede the generic 'reduce' match: 'dcn_reduce' (and
        # compound 'inverse+dcn_reduce') contain 'reduce' too.
        return 'dcn'
    if isinstance(fired, str) and 'reduce' in fired:
        # 'reduce' alone, or a compound 'inverse+reduce'/'chunkJ+reduce'
        # firing step: the step pays the per-window factor collective,
        # which is the wait the factor class exists to attribute.
        return 'factor'
    if fired == 'factor':
        return 'factor'
    if fired == 'inverse' or (isinstance(fired, str)
                              and fired.startswith('chunk')):
        return 'firing'
    if fired == 'compile':
        return 'compile'
    return 'plain'


def wait_attribution(shards: dict[int, list[dict]]) -> dict | None:
    """Barrier-wait stats per stage class, over every rank's shard.

    ``{class: {'n', 'mean_wait_ms', 'max_wait_ms'}}`` for the classes
    that recorded any wait (sampled probes — ``--straggler-sample-every``
    — simply contribute fewer points; steps without a wait field are
    skipped, so sparse shards merge cleanly). None when no step
    carried a wait.
    """
    buckets: dict[str, list[float]] = {}
    for records in shards.values():
        for r in records:
            if r.get('kind') != 'step':
                continue
            w = _num(r.get('metrics', {}).get(BARRIER_WAIT_KEY))
            if w != w:  # NaN: no wait recorded on this step
                continue
            buckets.setdefault(stage_class(r.get('fired')),
                               []).append(w)
    if not buckets:
        return None
    return {cls: {'n': len(vals),
                  'mean_wait_ms': sum(vals) / len(vals),
                  'max_wait_ms': max(vals)}
            for cls, vals in sorted(buckets.items())}


def straggler_summary(shards: dict[int, list[dict]]) -> dict | None:
    """Cross-host skew analysis over merged rank shards.

    Per rank: step count, p50/p95 dispatch ms, mean/max barrier-wait
    ms. Across ranks (over steps every shard recorded): how often each
    rank was the slowest (``slowest_counts`` — the straggler
    attribution: a uniform spread is jitter, one dominant rank is a
    sick host), and the mean/max per-step skew (slowest minus fastest
    dispatch). Wait-time inverts the picture — the rank that waits
    LEAST at the barrier is the one everyone else waits FOR.

    Multi-slice runs: shards whose meta record carries a
    ``slice`` id (the CLIs stamp ``slice_of_rank(...)`` into the shard
    meta) additionally aggregate into ``per_slice`` rows — per-slice
    rank list, p50/p95 over the slice's pooled dispatch times and
    slowest-rank share, so inter-slice skew (a slow inter-slice link, a sick
    slice) reads directly from the report without eyeballing N rank
    rows.
    """
    per_rank: dict[int, dict] = {}
    step_times: dict[int, dict[int, float]] = {}
    rank_slice: dict[int, int] = {}
    rank_times: dict[int, list[float]] = {}
    for rank, records in shards.items():
        times, waits = [], []
        for r in records:
            if (r.get('kind') == 'meta'
                    and isinstance(r.get('meta'), dict)
                    and r['meta'].get('slice') is not None):
                rank_slice[rank] = int(r['meta']['slice'])
            if r.get('kind') != 'step':
                continue
            ms = r.get('host_step_ms')
            if isinstance(ms, (int, float)):
                times.append(float(ms))
                step_times.setdefault(int(r['step']), {})[rank] = float(
                    ms)
            w = _num(r.get('metrics', {}).get(BARRIER_WAIT_KEY))
            if w == w:  # not NaN
                waits.append(w)
        if not times:
            continue
        rank_times[rank] = times
        svals = sorted(times)
        per_rank[rank] = {
            'n_steps': len(times),
            'p50_ms': _percentile(svals, 50),
            'p95_ms': _percentile(svals, 95),
            'mean_wait_ms': (sum(waits) / len(waits) if waits else None),
            'max_wait_ms': (max(waits) if waits else None),
        }
    if not per_rank:
        return None
    slowest: dict[int, int] = {r: 0 for r in per_rank}
    skews = []
    common = [s for s, by_rank in step_times.items()
              if len(by_rank) == len(per_rank)]
    for s in common:
        by_rank = step_times[s]
        worst = max(by_rank, key=by_rank.get)
        slowest[worst] += 1
        skews.append(max(by_rank.values()) - min(by_rank.values()))
    per_slice = None
    if rank_slice and any(rank in per_rank for rank in rank_slice):
        groups: dict[int, list[int]] = {}
        for rank in per_rank:
            if rank in rank_slice:
                groups.setdefault(rank_slice[rank], []).append(rank)
        per_slice = {}
        for sl, ranks in sorted(groups.items()):
            pooled = sorted(t for r in ranks for t in rank_times[r])
            per_slice[sl] = {
                'ranks': sorted(ranks),
                'n_steps': len(pooled),
                'p50_ms': _percentile(pooled, 50),
                'p95_ms': _percentile(pooled, 95),
                'slowest_count': sum(slowest[r] for r in ranks),
            }
    return {
        'n_ranks': len(per_rank),
        'per_rank': per_rank,
        'n_common_steps': len(common),
        'slowest_counts': slowest,
        'mean_skew_ms': (sum(skews) / len(skews) if skews else None),
        'max_skew_ms': (max(skews) if skews else None),
        # Comm-wait attribution by fired-stage class: how much
        # of the barrier wait sits on factor-collective steps vs plain
        # steps — the number the deferred-reduce overlap moves.
        'wait_by_stage': wait_attribution(shards),
        # Per-slice skew rows — None on flat runs (no slice ids
        # in the shard meta).
        'per_slice': per_slice,
    }
