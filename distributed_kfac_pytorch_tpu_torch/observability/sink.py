"""Schema-versioned JSONL metrics sink, rank-0 gated, atomic and rotating
(PyTorch port of ``distributed_kfac_pytorch_tpu/observability/sink.py``:
the same schema, record kinds, event names and file layout, so either
package's ``report`` reads either package's stream).

Design constraints:

  - **No host syncs in the step path.** ``step_record`` snapshots the
    step's device scalars and reads nothing: the scalars of one dtype are
    stacked into one new tensor, which on a CUDA device is copied to
    pinned host memory with ``non_blocking=True`` behind a recorded CUDA
    event (on the CPU the stack is the copy). A record therefore keeps
    its step's values even if a tensor it was given changes later. The
    drain (every ``drain_every`` kept records, and at epoch ends) waits
    on each event and converts to floats, by which point the host has
    dispatched well past the step.
  - **Rank-0 gating.** Every process constructs the sink with its rank;
    only rank 0 ever touches the filesystem, so a world produces exactly
    one stream.
  - **Atomic write-then-rename.** The current segment's lines are
    rewritten to ``<path>.tmp.<pid>`` and ``os.replace``d over the
    target on every drain — a reader (or a crashed run) never observes
    a torn/interleaved line. Rotation bounds the rewrite cost:
    a full segment is renamed to ``<path>.<n>`` and a fresh one starts.

Record schema (``schema`` = :data:`SCHEMA_VERSION`; the reader accepts
v1-v3 files too — v2 only *added* the ``event`` kind, v3 only adds the
optional step ``fired`` field, v4 only adds the ``memory`` kind):

  {"schema": 4, "kind": "step",  "step": int, "wall_time": float,
   "host_step_ms": float?, "fired": str?,
   "metrics": {flat name -> float}}
                     # "fired": the heaviest K-FAC stage this step ran
                     # ('factor' / 'inverse' / 'chunk<j>' / 'reduce',
                     # or 'compile' for a plain step that built or
                     # loaded the kernels); absent on plain steps. The
                     # report's step-time outlier attribution keys on it.
  {"schema": 4, "kind": "epoch", "epoch": int, "wall_time": float,
   "metrics": {...averaged epoch metrics...}, "trace": {stage: {...}}}
  {"schema": 4, "kind": "meta",  "wall_time": float, "meta": {...}}
  {"schema": 4, "kind": "event", "event": str, "wall_time": float,
   "data": {...}}    # resilience: preemption / checkpoint_save (with
                     # latency_ms) / restore — always kept (no
                     # interval thinning) and flushed immediately,
                     # because the runs that emit them tend to die next;
                     # compile: the kernels' first-use build or load
                     # (data: variant, first_call_ms).
  {"schema": 4, "kind": "memory", "step": int, "wall_time": float,
   "device": {bytes_in_use, peak_bytes_in_use, ...}?,
   "state": {total_bytes, by_group, by_dtype, ...}?}
                     # memory telemetry: device allocator watermarks
                     # and the resident K-FAC state footprint (the
                     # report and the health monitor read these).

``validate_record`` / ``read_jsonl`` are the single schema authority,
shared by the report CLI and the tests. ``read_jsonl_tolerant`` is the
crash-forensics reader: a process killed mid-append can leave a torn
FINAL line (the per-rank straggler shards append without the atomic
rewrite of the rank-0 stream); the tolerant reader skips-and-counts a
trailing undecodable line instead of refusing the whole stream.
"""

from __future__ import annotations

import json
import math
import os
import re
import time
from typing import Any

SCHEMA_VERSION = 4
ACCEPTED_SCHEMAS = (1, 2, 3, 4)
RECORD_KINDS = ('meta', 'step', 'epoch', 'event', 'memory')
# The one registry of event names a ``kind='event'`` record may carry:
# the report and gate key on these strings, so every emitter draws from
# here. The same tuple as the JAX package's, so the two packages' streams
# stay interchangeable; 'retrace' and 'pallas_fallback' are registered
# but never emitted here (no program variants, and no fallback: a kernel
# launches or raises).
EVENT_KINDS = (
    'compile',              # first use of a compiled program: here the
                            # kernels' build or load
    'retrace',              # a program variant re-traced
    'preemption',           # resilience drain began
    'checkpoint_save',      # step checkpoint written
    'restore',              # resume restored a checkpoint
    'topology_change',      # elastic resume changed the world
    'autotune_apply',       # --tuned-config overlay applied
    'autotune_fallback',    # --tuned-config rejected, fail-closed
    'autotune_backoff',     # cadence-backoff stretch/relax
    'selfheal_escalate',    # self-healing: damping multiplier raised
    'selfheal_deescalate',  # damping multiplier decayed one notch
    'selfheal_quarantine',  # bucket gated to the SGD direction
    'selfheal_readmit',     # bucket re-admitted
    'selfheal_rollback',    # in-process last-good restore
    'ckpt_quarantine',      # corrupt/torn bundle skipped by the
                            # verified resume walk
    'supervisor_restart',   # supervision (the <path>.supervisor
    'supervisor_failover',  # sidecar stream): relaunch, shrink,
    'supervisor_growback',  # grow back, hang, crash loop, torn
    'hang_detected',        # capacity file
    'crash_loop',
    'capacity_degraded',
    'fleet_admit',          # fleet scheduling (the fleet's own stream)
    'fleet_preempt',
    'fleet_regrow',
    'fleet_quarantine',
    'fleet_complete',
    'pallas_fallback',      # a fused kernel fell back to a stock path
)
# Dead incarnations kept per metrics path (<path>.prev.1 newest ..
# .prev.N oldest); older ones are pruned on relaunch.
PREV_INCARNATIONS_KEPT = 5
# Where the failure supervisor's event stream lives relative to the
# run's metrics path: ``<path>.supervisor``. ONE constant for
# the writer (resilience.supervisor) and both readers (report, gate) —
# the sidecar is found by convention, so a suffix drift would silently
# orphan the supervision trail.
SUPERVISOR_SIDECAR_SUFFIX = '.supervisor'


def to_float(x) -> float:
    """Best-effort scalar coercion (device arrays, numbers, 'nan'/'inf'
    strings); anything non-numeric degrades to NaN instead of raising.
    Single point of truth shared with :mod:`health` and :mod:`report`.
    """
    try:
        return float(x)
    except (TypeError, ValueError):
        return float('nan')


def percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated percentile of an ascending-sorted list.

    Single implementation shared by :mod:`report` (step-time
    distribution, hence :mod:`gate`'s baseline metrics) and
    :mod:`stragglers` (per-rank tables) — the gate compares report
    numbers against baseline numbers, so the math must not fork.
    """
    if not sorted_vals:
        return float('nan')
    pos = (len(sorted_vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (
        pos - lo)


def peak_hbm_bytes(records: list[dict]) -> float | None:
    """Highest device watermark across a stream's ``memory`` records
    (``peak_bytes_in_use``, falling back to ``bytes_in_use``); None
    when no record carries allocator stats. Shared by :mod:`report`
    and :mod:`gate` — one place to learn a new allocator key.
    """
    peak = None
    for r in records:
        if r.get('kind') != 'memory':
            continue
        dev = r.get('device', {})
        b = dev.get('peak_bytes_in_use', dev.get('bytes_in_use'))
        if isinstance(b, (int, float)):
            peak = b if peak is None else max(peak, b)
    return peak


def validate_record(rec: Any) -> None:
    """Raise ValueError unless ``rec`` is a schema-valid record dict."""
    if not isinstance(rec, dict):
        raise ValueError(f'record is not an object: {type(rec).__name__}')
    if rec.get('schema') not in ACCEPTED_SCHEMAS:
        raise ValueError(f'unknown schema version {rec.get("schema")!r} '
                         f'(accepted {ACCEPTED_SCHEMAS})')
    kind = rec.get('kind')
    if kind not in RECORD_KINDS:
        raise ValueError(f'unknown record kind {kind!r}')
    if not isinstance(rec.get('wall_time'), (int, float)):
        raise ValueError('missing/invalid wall_time')
    if kind == 'step':
        if not isinstance(rec.get('step'), int):
            raise ValueError('step record missing integer step')
        if 'fired' in rec and not isinstance(rec['fired'], str):
            raise ValueError('step record fired is not a string')
    if kind == 'epoch' and not isinstance(rec.get('epoch'), int):
        raise ValueError('epoch record missing integer epoch')
    if kind == 'event':
        if not isinstance(rec.get('event'), str) or not rec['event']:
            raise ValueError('event record missing event name')
        if 'data' in rec and not isinstance(rec['data'], dict):
            raise ValueError('event record data is not an object')
    if kind == 'memory':
        if not isinstance(rec.get('step'), int):
            raise ValueError('memory record missing integer step')
        for sub in ('device', 'state'):
            if sub in rec and not isinstance(rec[sub], dict):
                raise ValueError(f'memory record {sub} is not an object')
    if kind in ('step', 'epoch'):
        metrics = rec.get('metrics')
        if not isinstance(metrics, dict):
            raise ValueError(f'{kind} record missing metrics object')
        for k, v in metrics.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                continue
            if isinstance(v, str):
                # Non-finite values ride as 'nan'/'inf'/'-inf' strings
                # (JSON has no literals for them); float() round-trips.
                try:
                    float(v)
                    continue
                except ValueError:
                    pass
            raise ValueError(f'metric {k!r} is not a number: {v!r}')


def _rotated_segments(path: str) -> list[str]:
    """Existing rotated segments ``<path>.1 .. .N``, oldest first."""
    out = []
    n = 1
    while os.path.exists(f'{path}.{n}'):
        out.append(f'{path}.{n}')
        n += 1
    return out


def incarnation_paths(path: str) -> list[str]:
    """Surviving dead incarnations ``<path>.prev.1 .. .N``, newest
    first (``.prev.1`` is the most recently deceased run). Legacy
    single-slot ``<path>.prev`` files (older layout) are listed last.
    Read entries with :func:`read_incarnation` — chained entries are
    complete ``read_jsonl`` streams (rotated segments ride along as
    ``<path>.prev.<n>.<m>``), but a legacy ``.prev`` entry must be
    read as a single file (see ``read_incarnation``).
    """
    out = []
    n = 1
    while os.path.exists(f'{path}.prev.{n}'):
        out.append(f'{path}.prev.{n}')
        n += 1
    if os.path.exists(f'{path}.prev'):
        out.append(f'{path}.prev')
    return out


def _move_incarnation(src: str, dst: str) -> None:
    """Move one incarnation (live file + its rotated segments)."""
    for seg in _rotated_segments(dst):
        os.unlink(seg)
    for seg in _rotated_segments(src):
        m = re.match(re.escape(src) + r'\.(\d+)$', seg)
        os.replace(seg, f'{dst}.{m.group(1)}')
    os.replace(src, dst)


def _unlink_incarnation(path: str) -> None:
    for seg in _rotated_segments(path):
        os.unlink(seg)
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def _chain_incarnation(path: str) -> None:
    """Push the existing stream at ``path`` onto the incarnation chain.

    ``<path>.prev.n`` shifts to ``.prev.n+1`` (newest-first chain, each
    with its rotated segments), the live ``path`` (+ its segments)
    becomes ``.prev.1``, and incarnations beyond
    :data:`PREV_INCARNATIONS_KEPT` are pruned oldest-first. A legacy
    single-slot ``<path>.prev`` (older layout) is folded into the
    chain first so a second relaunch can no longer destroy the first
    dead incarnation's tail (the older layout overwrote it with one
    ``os.replace``).
    """
    if os.path.exists(f'{path}.prev'):
        # Legacy slot: adopt it as the newest chained incarnation
        # before the live file claims .prev.1.
        n = 1
        while os.path.exists(f'{path}.prev.{n}'):
            n += 1
        for i in range(n - 1, 0, -1):
            _move_incarnation(f'{path}.prev.{i}', f'{path}.prev.{i + 1}')
        os.replace(f'{path}.prev', f'{path}.prev.1')
    segs = _rotated_segments(path)
    if not os.path.exists(path) and not segs:
        return
    n = 1
    while os.path.exists(f'{path}.prev.{n}'):
        n += 1
    for i in range(n - 1, 0, -1):
        _move_incarnation(f'{path}.prev.{i}', f'{path}.prev.{i + 1}')
    if os.path.exists(path):
        for seg in segs:
            m = re.match(re.escape(path) + r'\.(\d+)$', seg)
            os.replace(seg, f'{path}.prev.1.{m.group(1)}')
        os.replace(path, f'{path}.prev.1')
    else:
        # Crash window: the dead run rotated its live segment away
        # (flush() renames live -> <path>.N before republishing a
        # fresh live file) and died in between, leaving rotated
        # segments with no live file. Those segments alone ARE the
        # dead incarnation — chain them (newest segment becomes the
        # chained live slot so read order stays oldest-segments-then-
        # live) instead of leaving them behind, where the new run's
        # ``read_jsonl`` would stitch them into a chimeric stream.
        for seg in segs[:-1]:
            m = re.match(re.escape(path) + r'\.(\d+)$', seg)
            os.replace(seg, f'{path}.prev.1.{m.group(1)}')
        os.replace(segs[-1], f'{path}.prev.1')
    n = PREV_INCARNATIONS_KEPT + 1
    while os.path.exists(f'{path}.prev.{n}'):
        _unlink_incarnation(f'{path}.prev.{n}')
        n += 1


def read_jsonl(path: str, validate: bool = True) -> list[dict]:
    """Load (and by default schema-validate) every record of a run.

    Rotated segments ``<path>.1 .. .N`` are read first (oldest-first),
    then the live file — one call reconstructs the full stream.
    """
    paths = _rotated_segments(path)
    if os.path.exists(path):
        paths.append(path)
    if not paths:
        raise FileNotFoundError(path)
    records = []
    for p in paths:
        records.extend(_read_jsonl_file(p, validate))
    return records


def read_jsonl_tolerant(path: str, validate: bool = True
                        ) -> tuple[list[dict], int]:
    """:func:`read_jsonl`, but tolerant of a torn FINAL line per file.

    A process killed mid-append (the per-rank straggler shards, or any
    external writer without the atomic rewrite) leaves at most one
    truncated trailing line per physical file. That line is skipped and
    counted — returns ``(records, n_torn)`` so the report can surface
    the skip instead of refusing the whole stream. An undecodable line
    anywhere *else* is still corruption and raises: only the crash
    window at the tail is a known-benign failure mode.
    """
    paths = _rotated_segments(path)
    if os.path.exists(path):
        paths.append(path)
    if not paths:
        raise FileNotFoundError(path)
    records, torn = [], 0
    for p in paths:
        recs, t = _read_jsonl_file(p, validate, tolerate_torn_tail=True)
        records.extend(recs)
        torn += t
    return records, torn


def _read_jsonl_file(p: str, validate: bool,
                     tolerate_torn_tail: bool = False
                     ) -> list[dict] | tuple[list[dict], int]:
    # Streaming with one deferred failure: a decode error is only
    # "torn" if no further non-empty line follows it (the crash
    # window is the tail by construction) — O(1) extra memory even on
    # unrotated multi-GB streams.
    records, torn = [], 0
    deferred: tuple[int, Exception] | None = None
    with open(p) as f:
        for i, raw in enumerate(f):
            line = raw.strip()
            if not line:
                continue
            if deferred is not None:
                di, de = deferred
                raise ValueError(f'{p}:{di + 1}: torn/invalid JSON '
                                 f'line: {de}') from de
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                if tolerate_torn_tail:
                    deferred = (i, e)
                    continue
                raise ValueError(f'{p}:{i + 1}: torn/invalid JSON '
                                 f'line: {e}') from e
            if validate:
                validate_record(rec)
            records.append(rec)
    if deferred is not None:
        torn += 1
    if tolerate_torn_tail:
        return records, torn
    return records


def read_incarnation(path: str, validate: bool = False) -> list[dict]:
    """Read one entry of :func:`incarnation_paths`.

    Chained incarnations (``<path>.prev.<n>``) read like any run —
    their ``.prev.<n>.<m>`` rotated segments stitch in oldest-first. A
    LEGACY single-slot ``<path>.prev`` (older layout) must read the
    exact file only: that layout never preserved rotated segments, and its
    ``<path>.prev.<n>`` *neighbors* are chain entries — different
    runs — that ``read_jsonl``'s segment stitching would wrongly
    concatenate into the legacy stream.
    """
    if path.endswith('.prev'):
        return _read_jsonl_file(path, validate)
    return read_jsonl(path, validate)


def _snapshot(metrics: dict) -> tuple[dict, list]:
    """``(plain, parts)``: the non-tensor entries of ``metrics`` as they
    are, and a snapshot of the tensor ones that reads nothing on the host.

    The 0-dim tensors of one device and dtype are stacked into one new
    tensor (one launch); on a CUDA device it is copied into pinned host
    memory with ``non_blocking=True`` and a CUDA event is recorded after
    the copy, on the CPU the stack is the copy. Each part is ``(keys,
    host tensor, event or None)``; :func:`_read_snapshot` waits on the
    event and reads."""
    plain, groups = {}, {}
    for k, v in metrics.items():
        if hasattr(v, 'detach') and hasattr(v, 'dtype'):
            groups.setdefault((v.device, v.dtype), []).append((k, v))
        else:
            plain[k] = v
    if not groups:
        return plain, []
    import torch

    parts = []
    for (device, dtype), items in groups.items():
        stacked = torch.stack([v.detach().reshape(()) for _, v in items])
        event = None
        if device.type == 'cuda':
            host = torch.empty(stacked.shape, dtype=dtype, pin_memory=True)
            host.copy_(stacked, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        else:
            host = stacked
        parts.append(([k for k, _ in items], host, event))
    return plain, parts


def _read_snapshot(parts: list) -> dict:
    """``{key: number}`` of a :func:`_snapshot` snapshot (waits on
    each part's CUDA event first)."""
    out = {}
    for keys, host, event in parts:
        if event is not None:
            event.synchronize()
        out.update(zip(keys, host.tolist()))
    return out


class JsonlMetricsSink:
    """Asynchronous JSONL writer for per-step K-FAC metrics.

    Args:
      path: target ``.jsonl`` file (parent dirs are created).
      interval: keep every Nth step record (``metrics_interval``; epoch
        and meta records are always kept).
      process_index: this process's rank; non-zero ranks become no-op
        sinks (safe to call unconditionally from SPMD code).
      rotate_bytes: rotate the live segment past this size. Bounds both
        segment size and the atomic-rewrite cost *per drain* (each
        drain republishes the current segment — crash-durable at drain
        granularity). None disables.
      drain_every: drain-and-publish after this many enqueued records
        (keeps host memory flat, bounds telemetry loss on a crash, and
        sets the health monitor's reaction latency — all while staying
        far behind the dispatch frontier).
      monitor: optional :class:`observability.health.HealthMonitor`;
        every drained record is fed to it (its action — warn / skip /
        raise — fires at drain time, off the step path, and always
        AFTER the drained records are persisted).
      meta: optional run-config dict written once as the leading
        ``kind='meta'`` record.
    """

    def __init__(self, path: str, *, interval: int = 1,
                 process_index: int = 0,
                 rotate_bytes: int | None = 4 * 1024 * 1024,
                 drain_every: int = 64,
                 monitor=None,
                 meta: dict | None = None):
        if interval < 1:
            raise ValueError(f'{interval=} must be >= 1')
        self.path = path
        self.interval = interval
        self.enabled = process_index == 0
        self.rotate_bytes = rotate_bytes
        self.drain_every = drain_every
        self.monitor = monitor
        self._pending: list[dict] = []    # records not yet written
        self._lines: list[str] = []       # serialized current segment
        self._bytes = 0
        self._segments = 0
        self._step_seen = 0
        if not self.enabled:
            return
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        # A fresh sink owns its path: the previous run's stream must
        # not be stitched into this one (``read_jsonl`` would build a
        # chimeric stream from two runs' individually-valid records —
        # e.g. on the CLIs' default <log-dir> path), but it must not be
        # destroyed either: a relaunch after preemption reuses the same
        # path, and the dead incarnation's tail holds its final records
        # — preemption and forced-save events included — exactly the
        # telemetry a post-mortem needs. The whole prior stream
        # (live segment + rotations) therefore moves onto the
        # incarnation chain ``<path>.prev.1`` (newest) .. ``.prev.N``,
        # bounded at PREV_INCARNATIONS_KEPT with the oldest pruned —
        # the older single-slot ``<path>.prev`` let a SECOND relaunch
        # silently overwrite the first incarnation.
        # ``observability.report`` lists the surviving incarnations.
        _chain_incarnation(path)
        if meta is not None:
            self._pending.append({'schema': SCHEMA_VERSION,
                                  'kind': 'meta',
                                  'wall_time': time.time(),
                                  'meta': dict(meta)})

    # -- enqueue (step path: no syncs) ---------------------------------

    def step_record(self, step: int, metrics: dict,
                    host_step_ms: float | None = None,
                    fired: str | None = None) -> None:
        """Enqueue one step's metrics (every ``interval``-th kept).

        ``metrics`` values may be device tensors: a kept record holds a
        snapshot of them (:func:`_snapshot`), read at drain time,
        never now. ``fired`` labels the heaviest K-FAC stage the step ran
        (``engine.fired_stage``; 'compile' for a plain step that built the
        kernels) — the report's step-time outlier attribution keys on it.
        """
        self._step_seen += 1
        if not self.enabled or (self._step_seen - 1) % self.interval:
            return
        plain, parts = _snapshot(metrics)
        rec = {'schema': SCHEMA_VERSION, 'kind': 'step',
               'step': int(step), 'wall_time': time.time(),
               'metrics': plain}
        if host_step_ms is not None:
            rec['host_step_ms'] = float(host_step_ms)
        if fired is not None:
            rec['fired'] = str(fired)
        rec['_snapshot'] = parts          # popped at drain
        self._pending.append(rec)
        if len(self._pending) >= self.drain_every:
            # Full flush, not just an in-memory drain: a crash between
            # drains must not lose the run's telemetry, and the health
            # monitor must see records at drain cadence (not only at
            # epoch end). The atomic segment rewrite is bounded by
            # rotate_bytes.
            self.flush()

    def epoch_record(self, epoch: int, metrics: dict,
                     trace: dict | None = None) -> None:
        """Record epoch-level averages plus a host trace-table snapshot."""
        if not self.enabled:
            return
        rec = {'schema': SCHEMA_VERSION, 'kind': 'epoch',
               'epoch': int(epoch), 'wall_time': time.time(),
               'metrics': dict(metrics)}
        if trace:
            rec['trace'] = trace
        self._pending.append(rec)

    def meta_record(self, meta: dict) -> None:
        """Append a ``kind='meta'`` record mid-stream.

        For run provenance that only exists AFTER sink construction —
        e.g. the per-layer K-FAC approximation map, resolved at layer
        registration (the CLIs build the sink before the model). The
        reader treats every meta record as provenance; multiple are
        fine (the leading constructor meta stays the run header).
        Flushed immediately like events: provenance must survive an
        early crash.
        """
        if not self.enabled:
            return
        self._pending.append({'schema': SCHEMA_VERSION, 'kind': 'meta',
                              'wall_time': time.time(),
                              'meta': dict(meta)})
        self.flush()

    def event_record(self, name: str, **data) -> None:
        """Record a resilience/lifecycle event (preemption, checkpoint
        save + latency, restore). Events bypass interval thinning
        and are flushed IMMEDIATELY: they mark moments where the
        process is about to exit (preemption) or just came back
        (restore), exactly when pending telemetry must not be lost.
        ``data`` values must be JSON-serializable scalars/strings.
        """
        if not self.enabled:
            return
        self._pending.append({'schema': SCHEMA_VERSION, 'kind': 'event',
                              'event': str(name),
                              'wall_time': time.time(),
                              'data': dict(data)})
        self.flush()

    def memory_record(self, step: int, device: dict | None = None,
                      state: dict | None = None) -> None:
        """Record one memory-telemetry sample.

        ``device``: allocator watermarks from
        ``observability.memory.device_memory_stats`` (bytes_in_use /
        peak_bytes_in_use; omit on backends without stats). ``state``:
        the host-side K-FAC state footprint breakdown from
        ``state_footprint``. Bypasses interval thinning (the engine
        already samples on its own ``memory_interval`` cadence) but
        drains with the normal flush cadence — watermarks are periodic
        telemetry, not last-words events.
        """
        if not self.enabled:
            return
        rec: dict = {'schema': SCHEMA_VERSION, 'kind': 'memory',
                     'step': int(step), 'wall_time': time.time()}
        if device:
            rec['device'] = dict(device)
        if state:
            rec['state'] = dict(state)
        self._pending.append(rec)

    # -- drain / write (off the step path) -----------------------------

    def _drain(self) -> list[dict]:
        """Serialize pending records into the current segment.

        Pending is cleared up front and every record is serialized
        before any monitor sees it — a raising health action can then
        neither lose nor duplicate records (see the callers: the
        segment is written before the exception propagates).
        """
        drained, self._pending = self._pending, []
        for rec in drained:
            if 'metrics' in rec:
                values = dict(rec['metrics'])
                values.update(_read_snapshot(rec.pop('_snapshot', [])))
                cleaned = {}
                for k, v in values.items():
                    f = to_float(v)
                    # JSON has no inf/nan literals; stringify so the
                    # reader sees the signal instead of a parse error.
                    cleaned[k] = f if math.isfinite(f) else repr(f)
                rec['metrics'] = cleaned
            self._lines.append(json.dumps(rec, sort_keys=True))
        return drained

    def _observe(self, drained: list[dict]) -> None:
        if self.monitor is None:
            return
        for rec in drained:
            self.monitor.observe(rec)

    def _write_segment(self) -> None:
        data = '\n'.join(self._lines) + ('\n' if self._lines else '')
        tmp = f'{self.path}.tmp.{os.getpid()}'
        with open(tmp, 'w') as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._bytes = len(data)

    def flush(self) -> None:
        """Drain pending records and atomically publish the segment.

        The health monitor runs AFTER the write: an action='raise'
        propagates with the full stream already on disk (the run that
        dies on a health event needs its telemetry most).
        """
        if not self.enabled:
            return
        drained = self._drain()
        self._write_segment()
        if self.rotate_bytes and self._bytes >= self.rotate_bytes:
            self._segments += 1
            os.replace(self.path, f'{self.path}.{self._segments}')
            self._lines = []
            self._write_segment()
        self._observe(drained)

    def close(self) -> None:
        self.flush()
