"""Failure supervision: launch, watch leases, classify, recover (PyTorch
port of ``distributed_kfac_pytorch_tpu/resilience/supervisor.py``).

    python -m distributed_kfac_pytorch_tpu_torch.resilience.supervisor \\
        --workdir ./sup --devices 4 -- \\
        python -m distributed_kfac_pytorch_tpu_torch.train_cifar10_resnet \\
        --dist-backend gloo ...

The chaos harness (``resilience.chaos``) relaunches only after a
cooperative drain. The supervisor turns the other failures into
relaunches, with no person in the loop:

  ============  ============================  =========================
  failure       signal                        response
  ============  ============================  =========================
  crash         a rank exits nonzero (not the relaunch with exponential
                relaunch code); the other      backoff, under
                ranks are killed               ``--max-restarts``
  graceful      every rank exits               immediate relaunch (the
  drain         RELAUNCH_EXIT_CODE (bundle     bundle is fresh; no
                durable)                       backoff, no budget)
  hang          every heartbeat lease stale    ``hang_detected``, kill
                past ``--hang-timeout`` (or    (TERM then KILL), then
                no lease within                relaunch like a crash
                ``--startup-grace``)
  dead worker   a SUBSET of rank leases        ``supervisor_failover``:
                stale past                     kill the rest, relaunch
                ``--failover-grace`` while     on the survivors (a
                others stay fresh              smaller world: elastic
                                               resume)
  lost/         ``--capacity-file`` count      drain via the preemption
  returned      differs from the running       sentinel, relaunch at the
  capacity      world                          new world
                                               (``supervisor_failover``
                                               on shrink,
                                               ``supervisor_growback``
                                               on grow)
  persistent    one rank slowest on >= 80%     graceful drain + shrink,
  straggler     of recent common steps with    like a dead worker
                mean skew >=                   (opt-in:
                ``--straggler-skew-ms``        ``--straggler-skew-ms``)
                (the rank shards)
  crash loop    the SAME global step failing   ``crash_loop`` event +
                ``--crash-loop-after``         diagnostic bundle + exit
                consecutive relaunches         :data:`CRASH_LOOP_EXIT`
  ============  ============================  =========================

The child is a world of ``--devices N`` rank processes
(``launch.spawn_world``: the ``torchrun`` environment for each; without
``--devices`` the command runs alone, as the launcher owns its world).
The JAX package's child is one process whose device count rides in
``XLA_FLAGS``. Failover and grow-back relaunch at the new world size, and
the relaunched ranks resume through the elastic reshard
(``elastic.reshard``: N -> M -> N continues bit for bit).

Exit codes: the final world's code when training completes or the
supervisor is told to stop; :data:`EXHAUSTED_EXIT` (76) when the restart
budget runs out; :data:`CRASH_LOOP_EXIT` (77) on a crash loop. The
relaunch code is ``KFAC_RELAUNCH_EXIT`` (default 75).

Every decision is an event (``supervisor_restart`` /
``supervisor_failover`` / ``supervisor_growback`` / ``hang_detected`` /
``crash_loop`` / ``capacity_degraded``) in a sidecar JSONL (default
``<metrics>.supervisor`` next to the child's ``--kfac-metrics`` stream
when ``--metrics`` is given, else ``<workdir>/supervisor.<instance>.jsonl``)
that ``observability.report`` and ``observability.gate`` read. Default
artifact paths (the lease subdirectory, the event stream, the drain
sentinel) carry a per-instance token, so supervisors sharing a workdir
do not collide.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import random
import signal
import sys
import time

from distributed_kfac_pytorch_tpu_torch import launch as launch_lib
from distributed_kfac_pytorch_tpu_torch.resilience import faults as faults_lib
from distributed_kfac_pytorch_tpu_torch.resilience import (
    heartbeat as hb_lib,
)
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import (
    RELAUNCH_EXIT_CODE,
)

#: Restart budget exhausted: the job keeps dying and the supervisor is
#: out of relaunches — a human (or a higher-level scheduler) must look.
#: 76 collides with sysexits EX_PROTOCOL (README, the port's section).
EXHAUSTED_EXIT = 76
#: Crash-loop detected: the SAME global step failed --crash-loop-after
#: consecutive relaunches — relaunching again cannot help (poison
#: batch, deterministic bug). 77 collides with sysexits EX_NOPERM; see
#: the README. A diagnostic bundle is written next to the leases.
CRASH_LOOP_EXIT = 77

DIAGNOSTIC_NAME = 'crash_loop_diagnostic.json'

#: Per-process supervisor counter: combined with the pid it tokens the
#: default artifact namespace (heartbeat subdirectory, event-stream
#: and drain-sentinel names) so concurrent supervisors — separate
#: processes OR several in one fleet process — sharing a scratch
#: workdir cannot collide.
_INSTANCES = itertools.count(1)


class RestartBackoff:
    """Exponential relaunch backoff with a cap and decorrelation jitter.

    ``next_delay()`` returns 0, then the exponential schedule
    base, base*factor, ... capped at ``cap`` (the first restart after a
    healthy stretch is free — the checkpoint is fresh and most faults
    are transient); ``reset()`` re-arms after progress.

    Each nonzero delay is drawn uniformly from
    ``[d*(1-jitter), d]`` (``d`` = the deterministic schedule value):
    a pool-wide fault that kills many supervised jobs at once would
    otherwise relaunch them all on the SAME schedule and thundering-
    herd the pool every base*factor^n seconds forever.
    ``jitter=0`` restores the deterministic schedule; ``seed`` makes
    the draw reproducible for tests (and lets a fleet give every job
    its own decorrelated stream).
    """

    def __init__(self, base: float = 1.0, factor: float = 2.0,
                 cap: float = 60.0, jitter: float = 0.5,
                 seed: int | None = None):
        if base < 0 or factor < 1.0 or cap < 0:
            raise ValueError(
                f'bad backoff ({base=}, {factor=}, {cap=}): need '
                'base >= 0, factor >= 1, cap >= 0')
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f'backoff jitter must be in [0, 1], '
                             f'got {jitter}')
        self.base = float(base)
        self.factor = float(factor)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._failures = 0

    def next_delay(self) -> float:
        n = self._failures
        self._failures += 1
        if n == 0:
            return 0.0
        d = min(self.cap, self.base * self.factor ** (n - 1))
        if self.jitter and d > 0:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    def reset(self) -> None:
        self._failures = 0


class CapacityFile:
    """Torn-read-tolerant poll of a resource manager's capacity file.

    The file is a plain overwrite (not an atomic rename), so a poll
    can catch it mid-write: empty, truncated, or non-integer.
    ``read()`` returns ``(value, error)`` — ``value`` is the newest
    good integer, or the LAST known one while degraded (None before
    any good read, and while the file simply does not exist yet);
    ``error`` is the exception string exactly ONCE at the start of
    each degradation episode (the caller emits one
    ``capacity_degraded`` event per episode, never per poll). Shared
    by the supervisor's per-job channel and the fleet scheduler's
    pool view so the degradation protocol cannot fork.
    """

    def __init__(self, path: str):
        self.path = path
        self.last: int | None = None
        self._degraded = False

    def read(self) -> tuple[int | None, str | None]:
        try:
            with open(self.path) as f:
                value = int(f.read().strip())
        except FileNotFoundError:
            # Absence is not degradation: capacity tracking may not
            # have started yet (and must not trigger a resize).
            return self.last, None
        except (OSError, ValueError) as e:
            if self._degraded:
                return self.last, None
            self._degraded = True
            return self.last, str(e)
        self._degraded = False
        self.last = value
        return value, None


class CrashLoopDetector:
    """Consecutive-failures-at-the-same-step counter.

    ``observe(step)`` records one failure with the global step training
    had reached (from the newest lease; None when it died before any
    heartbeat — repeated None IS a loop: failing before the first step
    every time). Returns True when the same step has now failed
    ``after`` consecutive times. Any progress — a failure at a LATER
    step — resets the count to 1 (pinned by tests/test_supervisor.py):
    the job is moving, however painfully, and the budget is the right
    limiter for that.
    """

    def __init__(self, after: int = 3):
        if after < 1:
            raise ValueError(f'crash-loop threshold must be >= 1, '
                             f'got {after}')
        self.after = int(after)
        self._step: int | None = None
        self._count = 0

    @property
    def count(self) -> int:
        return self._count

    @property
    def step(self) -> int | None:
        return self._step

    def observe(self, step: int | None) -> bool:
        if self._count and step == self._step:
            self._count += 1
        else:
            self._step = step
            self._count = 1
        return self._count >= self.after

    def reset(self) -> None:
        self._step = None
        self._count = 0


def classify_stragglers(shards: dict[int, list[dict]], *,
                        skew_ms: float, min_steps: int = 8,
                        frac: float = 0.8
                        ) -> tuple[int, float] | None:
    """Persistent-straggler verdict over the rank shards
    (``observability.stragglers``).

    A rank is a *persistent* straggler when, over the newest
    ``min_steps`` steps common to every LIVE shard, it is the slowest
    rank on at least ``frac`` of them AND the mean (slowest - fastest)
    dispatch skew on those steps is ``>= skew_ms``. One slow step is
    jitter; the supervisor only acts on sustained, attributable skew.
    Returns ``(rank, mean_skew_ms)`` or None.

    Shards whose newest recorded step trails the freshest shard by
    more than a sink-flush-sized margin are FROZEN — a rank removed by
    an earlier failover shrink, whose file stays on disk forever.
    They are dropped before the common-step intersection: keeping them
    would pin the intersection to the pre-shrink era and permanently
    blind the classifier for the rest of the session.
    """
    if len(shards) < 2 or skew_ms <= 0:
        return None
    per_rank: dict[int, dict[int, float]] = {}
    for rank, records in shards.items():
        steps = {r['step']: float(r['host_step_ms'])
                 for r in records
                 if r.get('kind') == 'step' and 'host_step_ms' in r}
        if steps:
            per_rank[rank] = steps
    if len(per_rank) < 2:
        return None
    head = max(max(m) for m in per_rank.values())
    # Live shards can trail by up to one flush window (drain_every=64
    # records) plus the comparison window itself; anything further
    # behind is a dead rank's frozen file.
    stale_before = head - (64 + 8 * min_steps)
    per_rank = {r: m for r, m in per_rank.items()
                if max(m) >= stale_before}
    if len(per_rank) < 2:
        return None
    common = set.intersection(*(set(m) for m in per_rank.values()))
    if len(common) < min_steps:
        return None
    window = sorted(common)[-min_steps:]
    slowest_counts: dict[int, int] = {}
    skews: dict[int, list[float]] = {}
    for step in window:
        times = {rank: per_rank[rank][step] for rank in per_rank}
        slowest = max(times, key=times.get)
        slowest_counts[slowest] = slowest_counts.get(slowest, 0) + 1
        skews.setdefault(slowest, []).append(
            times[slowest] - min(times.values()))
    rank, hits = max(slowest_counts.items(), key=lambda kv: kv[1])
    if hits < frac * len(window):
        return None
    mean_skew = sum(skews[rank]) / len(skews[rank])
    if mean_skew < skew_ms:
        return None
    return rank, mean_skew


class Supervisor:
    """One supervised training command: launch, watch, classify, recover.

    All timing knobs are in seconds; ``clock``/``sleep`` are injectable
    for the unit matrix. See the module docstring for the failure
    table and :func:`main` for the CLI surface.
    """

    def __init__(self, cmd: list[str], *, workdir: str,
                 instance: str | None = None,
                 heartbeat_dir: str | None = None,
                 events_path: str | None = None,
                 metrics_path: str | None = None,
                 extra_env: dict | None = None,
                 devices: int | None = None,
                 start_devices: int | None = None,
                 min_devices: int = 1,
                 slices: int = 1,
                 capacity_file: str | None = None,
                 hang_timeout: float = 300.0,
                 startup_grace: float = 900.0,
                 failover_grace: float = 0.0,
                 straggler_skew_ms: float = 0.0,
                 max_restarts: int = 5,
                 crash_loop_after: int = 3,
                 backoff: RestartBackoff | None = None,
                 poll_secs: float = 0.5,
                 drain_grace: float = 300.0,
                 term_grace: float = 10.0,
                 keep_faults: bool = False,
                 clock=time.time, sleep=time.sleep):
        if not cmd:
            raise ValueError('supervisor: no command to supervise')
        if hang_timeout <= 0:
            raise ValueError('--hang-timeout must be > 0 (hang '
                             'detection is the point of the leases)')
        if RELAUNCH_EXIT_CODE in (EXHAUSTED_EXIT, CRASH_LOOP_EXIT):
            raise ValueError(
                f'KFAC_RELAUNCH_EXIT={RELAUNCH_EXIT_CODE} collides '
                f'with a supervisor verdict code (budget-exhausted '
                f'{EXHAUSTED_EXIT} / crash-loop {CRASH_LOOP_EXIT}) — '
                'the exit statuses would be ambiguous')
        if devices is not None and not min_devices <= devices:
            raise ValueError(f'{devices=} below {min_devices=}')
        if slices < 1:
            raise ValueError(f'{slices=} must be >= 1')
        self.cmd = list(cmd)
        self.workdir = os.path.abspath(workdir)
        # Per-launch artifact namespace: two concurrent
        # supervisors pointed at ONE scratch workdir (a fleet packing
        # several jobs onto a shared filesystem) must not mix heartbeat
        # leases — each other's ranks would read as a dead subset — or
        # clobber each other's event stream (the sink's atomic rewrite
        # is last-writer-wins on a shared path). Defaults therefore
        # land under a unique per-supervisor token; explicit
        # --heartbeat-dir / --events / --metrics paths are honored
        # verbatim (the <metrics>.supervisor sidecar convention the
        # report/gate readers rely on is unchanged).
        self.instance = (str(instance) if instance
                         else f'{os.getpid()}.{next(_INSTANCES)}')
        self.heartbeat_dir = (os.path.abspath(heartbeat_dir)
                              if heartbeat_dir
                              else os.path.join(self.workdir,
                                                'heartbeats',
                                                self.instance))
        from distributed_kfac_pytorch_tpu_torch.observability.sink import (
            SUPERVISOR_SIDECAR_SUFFIX,
        )
        self.metrics_path = metrics_path
        if events_path is None:
            events_path = (metrics_path + SUPERVISOR_SIDECAR_SUFFIX
                           if metrics_path
                           else os.path.join(
                               self.workdir,
                               f'supervisor.{self.instance}.jsonl'))
        self.events_path = events_path
        self.extra_env = dict(extra_env or {})
        self.sentinel = os.path.join(
            self.workdir, f'drain.{self.instance}.sentinel')
        self.devices = devices
        self.world = (start_devices if start_devices is not None
                      else devices)
        self.min_devices = int(min_devices)
        # Live slice count (multi-slice): the slice-failure
        # classifier keys rank groups off it, the child env exports it
        # (KFAC_NUM_SLICES -> the CLIs' --num-slices default), and a
        # committed slice failover decrements it.
        self.slices = int(slices)
        self.capacity_file = capacity_file
        self.hang_timeout = float(hang_timeout)
        self.startup_grace = float(startup_grace)
        self.failover_grace = float(failover_grace)
        self.straggler_skew_ms = float(straggler_skew_ms)
        self.max_restarts = int(max_restarts)
        self.crash_loop = CrashLoopDetector(crash_loop_after)
        self.backoff = backoff or RestartBackoff()
        self.poll_secs = float(poll_secs)
        self.drain_grace = float(drain_grace)
        self.term_grace = float(term_grace)
        self.keep_faults = bool(keep_faults)
        self._clock = clock
        self._sleep = sleep
        self.launches = 0
        self.restarts = 0          # failure-driven (budgeted)
        self.history: list[dict] = []
        self._stop: str | None = None
        self._straggler_handled: set[int] = set()
        self._next_straggler_check = 0.0
        self._capacity = (CapacityFile(capacity_file)
                          if capacity_file else None)
        os.makedirs(self.workdir, exist_ok=True)
        os.makedirs(self.heartbeat_dir, exist_ok=True)
        from distributed_kfac_pytorch_tpu_torch.observability.sink import (
            JsonlMetricsSink,
        )
        self.events = JsonlMetricsSink(
            events_path, process_index=0,
            meta={'supervisor': True, 'cmd': ' '.join(self.cmd),
                  'devices': devices, 'start_devices': self.world,
                  'max_restarts': max_restarts,
                  'hang_timeout_s': self.hang_timeout,
                  'relaunch_exit': RELAUNCH_EXIT_CODE})

    # -- event plumbing -------------------------------------------------

    def _event(self, name: str, **data) -> None:
        self.events.event_record(name, **data)
        detail = ' '.join(f'{k}={v}' for k, v in sorted(data.items()))
        print(f'supervisor: {name} {detail}', file=sys.stderr,
              flush=True)

    # -- child lifecycle ------------------------------------------------

    def _child_env(self) -> dict:
        env = dict(os.environ)
        # Per-job overrides (the fleet's KFAC_CHAOS / tuned paths ride
        # here): merged BEFORE the one-shot fault clearing below so an
        # injected fault spec obeys the same relaunch discipline.
        env.update({str(k): str(v)
                    for k, v in self.extra_env.items()})
        env[hb_lib.ENV_DIR] = self.heartbeat_dir
        env[hb_lib.ENV_INCARNATION] = str(self.launches)
        env['KFAC_PREEMPT_FILE'] = self.sentinel
        if self.slices > 1:
            # The CLIs' --num-slices defaults from this, so a slice
            # failover's shrunken slice count propagates to the
            # relaunched child without editing its argv.
            env['KFAC_NUM_SLICES'] = str(self.slices)
        if self.launches > 0 and not self.keep_faults:
            # Faults are one-shot, exactly like the chaos harness: a
            # relaunch must not re-trip the injected failure (pass
            # --keep-faults to re-inject — the crash-loop legs do).
            env.pop(faults_lib.ENV_VAR, None)
        return env

    def _launch(self) -> launch_lib.World:
        try:
            os.unlink(self.sentinel)
        except FileNotFoundError:
            pass
        hb_lib.clear_leases(self.heartbeat_dir)
        env = self._child_env()
        self.launches += 1
        print(f'supervisor: launch {self.launches} '
              f'(world={self.world if self.world is not None else "-"})'
              f': {" ".join(self.cmd)}', file=sys.stderr, flush=True)
        # The world size is the number of rank processes (the JAX
        # package's child is one process with a device count).
        return launch_lib.spawn_world(self.cmd, self.world or 1, env)

    def _kill(self, proc: launch_lib.World) -> None:
        """TERM, grace, KILL — the hang/dead-rank escalation (a wedged
        process may have a preemption handler that eats the first
        TERM, which is fine: the KILL is the backstop)."""
        if proc.poll() is not None:
            return
        proc.terminate()
        deadline = self._clock() + self.term_grace
        while proc.poll() is None and self._clock() < deadline:
            self._sleep(min(0.1, self.poll_secs))
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    def _drain(self, proc: launch_lib.World) -> int:
        """Graceful drain: touch the preemption sentinel, wait for the
        child to save-and-exit (it polls once per step, so the wait
        budget must cover a full step INCLUDING a possible compile),
        escalate to kill past ``drain_grace``. Returns the exit code."""
        with open(self.sentinel, 'w') as f:
            f.write('supervisor drain\n')
        deadline = self._clock() + self.drain_grace
        while proc.poll() is None and self._clock() < deadline:
            self._sleep(self.poll_secs)
        if proc.poll() is None:
            self._kill(proc)
        return proc.returncode

    # -- watching -------------------------------------------------------

    def _capacity_target(self) -> int | None:
        """The world size the capacity file currently allows (clamped
        to [min_devices, devices]), or None when capacity tracking is
        off / the file has never been readable.

        A torn/empty/non-integer read keeps the LAST known target and
        emits exactly one ``capacity_degraded`` warning event per
        degradation episode (:class:`CapacityFile`): a momentarily
        unreadable resource view must neither crash the supervision
        loop nor trigger a spurious resize."""
        if self._capacity is None or self.devices is None:
            return None
        cap, error = self._capacity.read()
        if error is not None:
            self._event('capacity_degraded', path=self.capacity_file,
                        error=error, last_target=cap)
        if cap is None:
            return None
        return max(self.min_devices, min(self.devices, cap))

    def _check_stragglers(self) -> tuple[int, float] | None:
        if self.straggler_skew_ms <= 0 or not self.metrics_path:
            return None
        # Throttled well below the lease poll: merge_shards re-reads
        # every rank shard in FULL (rotated segments included), an
        # O(stream length) parse — at the 0.5 s poll cadence a long
        # run would spend its supervisor re-parsing megabytes per
        # second to re-derive a verdict about the newest ~8 steps.
        # Persistence is the point of the classifier anyway; a
        # 10-second-class look rate loses nothing.
        now = self._clock()
        if now < self._next_straggler_check:
            return None
        self._next_straggler_check = now + max(10.0,
                                               20.0 * self.poll_secs)
        from distributed_kfac_pytorch_tpu_torch.observability import (
            stragglers as straggler_mod,
        )
        try:
            shards, _torn, _errors = straggler_mod.merge_shards(
                self.metrics_path)
        except (OSError, ValueError):
            return None
        verdict = classify_stragglers(
            shards, skew_ms=self.straggler_skew_ms)
        if verdict is not None and verdict[0] in self._straggler_handled:
            return None
        return verdict

    def _watch(self, proc: launch_lib.World, launch_time: float):
        """Block until something needs a decision. Returns one of
        ``('exit', rc)`` / ``('hang', detail)`` /
        ``('dead_rank', dead, live)`` / ``('resize', target)`` /
        ``('straggler', rank, skew_ms)`` / ``('stop', reason)`` —
        the child is still running for every kind except 'exit'."""
        while True:
            rc = proc.poll()
            if rc is not None:
                return ('exit', rc)
            if self._stop is not None:
                return ('stop', self._stop)
            now = self._clock()
            # Incarnation-filtered: a lease left behind by an earlier
            # incarnation (or a quarantined job that shared the dir)
            # is that run's last words, not a live rank — counting it
            # here would fire an instant false hang/dead-rank verdict
            # on its stale timestamp.
            leases, _errors = hb_lib.scan_leases(
                self.heartbeat_dir, incarnation=self.launches - 1)
            if leases:
                ages = {r: hb_lib.lease_age(lease, now)
                        for r, lease in leases.items()}
                if min(ages.values()) > self.hang_timeout:
                    return ('hang',
                            {'newest_age_s': round(min(ages.values()), 3),
                             'ranks': sorted(leases)})
                if self.failover_grace > 0 and len(ages) > 1:
                    dead = sorted(r for r, a in ages.items()
                                  if a > self.failover_grace)
                    live = sorted(r for r, a in ages.items()
                                  if a <= self.failover_grace)
                    if dead and live:
                        return ('dead_rank', dead, live)
            elif now - launch_time > self.startup_grace:
                return ('hang', {'newest_age_s': None,
                                 'ranks': [],
                                 'detail': 'no heartbeat lease within '
                                           'the startup grace'})
            target = self._capacity_target()
            if target is not None and self.world is not None \
                    and target != self.world:
                return ('resize', target)
            straggler = self._check_stragglers()
            if straggler is not None:
                return ('straggler', straggler[0],
                        round(straggler[1], 3))
            self._sleep(self.poll_secs)

    # -- failure bookkeeping --------------------------------------------

    def _last_step(self) -> int | None:
        """The newest global step any rank's lease recorded — the
        incarnation's last words, read BEFORE the next launch clears
        the lease dir. The crash-loop detector keys on it."""
        leases, _ = hb_lib.scan_leases(self.heartbeat_dir)
        if not leases:
            return None
        return max(int(lease.get('step', 0))
                   for lease in leases.values())

    def _note(self, outcome: str, rc, last_step,
              launch_time: float) -> None:
        self.history.append({
            'launch': self.launches, 'outcome': outcome,
            'rc': rc, 'last_step': last_step,
            'world': self.world,
            'duration_s': round(self._clock() - launch_time, 3)})

    def _budgeted_restart(self, reason: str, *, last_step,
                          rc=None, **extra) -> int | None:
        """One failure-driven relaunch: crash-loop check, budget check,
        backoff. Returns an exit code to stop with, or None to
        relaunch."""
        looping = self.crash_loop.observe(last_step)
        if looping:
            diag = self._write_diagnostic(last_step)
            self._event('crash_loop', failure_step=last_step,
                        consecutive=self.crash_loop.count,
                        reason=reason, diagnostic=diag)
            print(f'supervisor: crash loop — global step {last_step} '
                  f'failed {self.crash_loop.count} consecutive '
                  f'launches; relaunching cannot help. Diagnostic '
                  f'bundle: {diag}', file=sys.stderr, flush=True)
            return CRASH_LOOP_EXIT
        self.restarts += 1
        if self.restarts > self.max_restarts:
            print(f'supervisor: restart budget exhausted '
                  f'({self.max_restarts}) — giving up with exit '
                  f'{EXHAUSTED_EXIT}', file=sys.stderr, flush=True)
            return EXHAUSTED_EXIT
        delay = self.backoff.next_delay()
        self._event('supervisor_restart', reason=reason, rc=rc,
                    restart=self.restarts, budget=self.max_restarts,
                    backoff_s=round(delay, 3), last_step=last_step,
                    **extra)
        if delay > 0:
            self._sleep(delay)
        return None

    def _write_diagnostic(self, last_step) -> str:
        """The crash-loop post-mortem bundle: launch history, last
        leases, the fault spec — everything a human needs before
        touching the budget again."""
        leases, lease_errors = hb_lib.scan_leases(self.heartbeat_dir)
        path = os.path.join(self.workdir, DIAGNOSTIC_NAME)
        with open(path, 'w') as f:
            json.dump({
                'failure_step': last_step,
                'consecutive_failures': self.crash_loop.count,
                'cmd': self.cmd,
                'world': self.world,
                'chaos_spec': os.environ.get(faults_lib.ENV_VAR),
                'history': self.history[-20:],
                'leases': {str(r): lease
                           for r, lease in leases.items()},
                'lease_errors': lease_errors,
            }, f, indent=1, sort_keys=True)
            f.write('\n')
        return path

    def _resize(self, target: int, reason: str, **extra) -> None:
        """Commit a world change and emit the matching event (shrink =
        failover, grow = grow-back). The relaunch itself resumes
        through the elastic path — lossless by the pinned N→M→N
        bit-identity."""
        name = ('supervisor_growback' if target > (self.world or 0)
                else 'supervisor_failover')
        self._event(name, reason=reason, from_devices=self.world,
                    to_devices=target, **extra)
        self.world = target
        # Rank indices renumber on the resized relaunch: a handled
        # straggler's old index may now name a healthy survivor, so
        # the suppression latch must not outlive the topology.
        self._straggler_handled.clear()

    # -- the loop -------------------------------------------------------

    def _install_signals(self) -> None:
        def handler(signum, frame):
            self._stop = f'signal {signal.Signals(signum).name}'

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, handler)

    def run(self, install_signals: bool = True) -> int:
        """Supervise until the command succeeds, the budget runs out,
        a crash loop is detected, or the supervisor is told to stop.
        Returns the process exit code.

        ``install_signals=False`` skips the SIGTERM/SIGINT handlers —
        required when the supervisor runs off the main thread (the
        fleet scheduler runs one per job); the embedding process owns
        the signals and requests a stop by setting ``request_stop``.
        """
        if install_signals:
            self._install_signals()
        try:
            return self._run()
        finally:
            self.events.close()

    def request_stop(self, reason: str = 'stop requested') -> None:
        """Ask the supervision loop to drain the child and return
        (thread-safe: the watcher polls the flag every ``poll_secs``).
        The fleet's preempt-to-queue and shutdown paths use this."""
        self._stop = str(reason)

    def _run(self) -> int:
        while True:
            proc = self._launch()
            launch_time = self._clock()
            kind, *info = self._watch(proc, launch_time)
            last_step = self._last_step()
            if kind == 'exit':
                rc = info[0]
                self._note('exit', rc, last_step, launch_time)
                if rc == 0:
                    return 0
                if rc == RELAUNCH_EXIT_CODE:
                    # Cooperative drain: checkpoint durable, no budget.
                    # A capacity change lands at this boundary (the
                    # drain may even have been OUR sentinel).
                    self.crash_loop.reset()
                    self.backoff.reset()
                    target = self._capacity_target()
                    if target is not None and self.world is not None \
                            and target != self.world:
                        self._resize(target, 'capacity')
                    else:
                        self._event('supervisor_restart',
                                    reason='drain', rc=rc,
                                    restart=self.restarts,
                                    budget=self.max_restarts,
                                    backoff_s=0.0,
                                    last_step=last_step)
                    continue
                stop = self._budgeted_restart('crash', rc=rc,
                                              last_step=last_step)
                if stop is not None:
                    return stop
                continue
            if kind == 'stop':
                print(f'supervisor: {info[0]} — draining the child and '
                      'stopping', file=sys.stderr, flush=True)
                rc = self._drain(proc)
                self._note('stop', rc, self._last_step(), launch_time)
                if rc is None:
                    return 1
                # A drain that escalated to kill leaves a NEGATIVE
                # returncode (-signum); propagating it through
                # sys.exit would wrap mod 256 into an undocumented
                # status — report it the shell way (128 + signum).
                return 128 - rc if rc < 0 else rc
            if kind == 'hang':
                self._event('hang_detected', last_step=last_step,
                            **info[0])
                self._kill(proc)
                self._note('hang', proc.returncode, last_step,
                           launch_time)
                stop = self._budgeted_restart('hang', rc=proc.returncode,
                                              last_step=last_step)
                if stop is not None:
                    return stop
                continue
            if kind == 'dead_rank':
                dead, live = info
                # The survivors are wedged on collectives with the dead
                # rank — no graceful drain is possible; kill and resume
                # the whole job from the last durable checkpoint on the
                # survivor world.
                self._kill(proc)
                self._note('dead_rank', proc.returncode, last_step,
                           launch_time)
                n = len(dead) + len(live)
                # Slice-failure classification: ALL ranks of
                # exactly one slice stale while every other slice's
                # ranks are live = that slice died (power, network
                # partition), not a sick host — fail over to the
                # survivor slices and shrink the slice count so the
                # relaunched child builds an (S-1)-slice world.
                slice_idx = None
                if self.slices > 1 and n % self.slices == 0:
                    from distributed_kfac_pytorch_tpu_torch.multislice.mesh \
                        import slice_rank_groups
                    for i, group in enumerate(
                            slice_rank_groups(n, self.slices)):
                        if list(group) == dead:
                            slice_idx = i
                            break
                reason = ('slice_failure' if slice_idx is not None
                          else 'dead_rank')
                target = self.world
                if self.world is not None:
                    target = max(self.min_devices,
                                 self.world * len(live) // n)
                if target == self.world:
                    # No survivor world to shrink onto (launcher owns
                    # the topology, or already at --min-devices): the
                    # relaunch is a plain failure-recovery attempt and
                    # MUST stay bounded — a host that keeps wedging
                    # would otherwise drive an infinite free
                    # kill/relaunch loop outside the budget and the
                    # crash-loop detector.
                    stop = self._budgeted_restart(
                        reason, rc=proc.returncode,
                        last_step=last_step,
                        dead_ranks=','.join(map(str, dead)))
                    if stop is not None:
                        return stop
                    continue
                extra = ({'slice': slice_idx}
                         if slice_idx is not None else {})
                self._event('supervisor_failover', reason=reason,
                            dead_ranks=','.join(map(str, dead)),
                            live_ranks=','.join(map(str, live)),
                            from_devices=self.world, to_devices=target,
                            **extra)
                self.world = target
                if slice_idx is not None:
                    # Commit the shrink AFTER the event so the trail
                    # records the pre-failover slice count.
                    self.slices -= 1
                self._straggler_handled.clear()  # ranks renumber
                self.crash_loop.reset()
                continue
            if kind == 'resize':
                target = info[0]
                rc = self._drain(proc)
                self._note('resize', rc, self._last_step(), launch_time)
                self._resize(target, 'capacity')
                self.crash_loop.reset()
                continue
            if kind == 'straggler':
                rank, skew = info
                self._straggler_handled.add(rank)
                rc = self._drain(proc)
                self._note('straggler', rc, self._last_step(),
                           launch_time)
                target = self.world
                if self.world is not None:
                    leases, _ = hb_lib.scan_leases(self.heartbeat_dir)
                    n = max(2, len(leases))
                    target = max(self.min_devices,
                                 self.world * (n - 1) // n)
                self._event('supervisor_failover', reason='straggler',
                            rank=rank, mean_skew_ms=skew,
                            from_devices=self.world, to_devices=target)
                self.world = target
                continue
            raise AssertionError(f'unhandled watch outcome {kind!r}')


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog='python -m distributed_kfac_pytorch_tpu_torch.resilience'
             '.supervisor',
        description='Launch a training command under failure '
                    'supervision: heartbeat-lease hang detection, '
                    'crash relaunch with backoff, survivor-world '
                    'failover and grow-back, crash-loop escalation. '
                    f'Exit: the final child code, {EXHAUSTED_EXIT} = '
                    f'restart budget exhausted, {CRASH_LOOP_EXIT} = '
                    'crash loop detected.')
    p.add_argument('--workdir', default='./supervisor',
                   help='supervisor state dir (heartbeat leases, drain '
                        'sentinel, event stream, crash-loop diagnostic)')
    p.add_argument('--instance', default=None, metavar='NAME',
                   help='artifact namespace token for the default '
                        'heartbeat subdirectory / event stream / drain '
                        'sentinel (default: a pid-unique token, so '
                        'concurrent supervisors sharing a workdir '
                        'cannot mix leases or clobber streams; set a '
                        'stable name for predictable paths)')
    p.add_argument('--heartbeat-dir', default=None,
                   help='lease directory (default <workdir>/heartbeats/'
                        '<instance>; exported to the child as '
                        'KFAC_HEARTBEAT_DIR)')
    p.add_argument('--events', default=None, metavar='PATH',
                   help='supervisor event JSONL (default '
                        '<metrics>.supervisor when --metrics is given, '
                        'else <workdir>/supervisor.<instance>.jsonl)')
    p.add_argument('--metrics', default=None, metavar='PATH',
                   help="the child's --kfac-metrics path: names the "
                        'event sidecar the report/gate merge, and '
                        'locates the rank shards the straggler '
                        'classifier reads')
    p.add_argument('--hang-timeout', type=float, default=300.0,
                   metavar='S',
                   help='every lease stale past S seconds = hang: '
                        'kill and relaunch. Budget ABOVE the worst '
                        'step + eval + checkpoint gap (leases are only '
                        'written from the train loop)')
    p.add_argument('--startup-grace', type=float, default=900.0,
                   metavar='S',
                   help='hang budget before the FIRST lease of an '
                        'incarnation (model build + compile happen '
                        'before any step runs)')
    p.add_argument('--failover-grace', type=float, default=0.0,
                   metavar='S',
                   help='a SUBSET of ranks stale past S seconds while '
                        'others stay fresh = dead worker: kill and '
                        'relaunch on the survivor world (0 = lease '
                        'failover off; needs >= 2 heartbeating ranks)')
    p.add_argument('--straggler-skew-ms', type=float, default=0.0,
                   help='treat a rank as a persistent straggler (drain '
                        '+ shrink) when it is slowest on >= 80%% of '
                        'recent common steps with mean skew above this '
                        '(reads the rank shards next to --metrics; '
                        '0 = off)')
    p.add_argument('--max-restarts', type=int, default=5, metavar='N',
                   help='failure-driven (crash/hang) relaunch budget; '
                        f'past it exit {EXHAUSTED_EXIT}. Graceful '
                        'drains (preemption/resize) are free')
    p.add_argument('--crash-loop-after', type=int, default=3,
                   metavar='K',
                   help='the same global step failing K consecutive '
                        'relaunches = crash loop: write a diagnostic '
                        f'bundle and exit {CRASH_LOOP_EXIT} instead of '
                        'burning the budget')
    p.add_argument('--backoff', type=float, default=1.0, metavar='S',
                   help='exponential backoff base for crash/hang '
                        'relaunches (0, S, 2S, 4S, ... capped)')
    p.add_argument('--backoff-cap', type=float, default=60.0,
                   metavar='S')
    p.add_argument('--backoff-jitter', type=float, default=0.5,
                   metavar='F',
                   help='decorrelation jitter fraction in [0, 1]: each '
                        'nonzero delay is drawn uniformly from '
                        '[d*(1-F), d] so many jobs relaunching after a '
                        'pool-wide fault do not thundering-herd on the '
                        'same schedule (0 = deterministic)')
    p.add_argument('--poll', type=float, default=0.5, metavar='S',
                   help='lease/capacity poll interval')
    p.add_argument('--drain-grace', type=float, default=300.0,
                   metavar='S',
                   help='wait budget for a sentinel-requested graceful '
                        'drain before escalating to kill (the child '
                        'polls once per STEP — cover a compile)')
    p.add_argument('--term-grace', type=float, default=10.0,
                   metavar='S',
                   help='SIGTERM-to-SIGKILL escalation window')
    p.add_argument('--devices', type=int, default=None, metavar='N',
                   help='full/target world size: the command runs as '
                        'N rank processes (the torchrun environment for '
                        'each; ranks sharing one card need --dist-backend '
                        'gloo); leave unset to run it alone when the '
                        'launcher owns the world')
    p.add_argument('--start-devices', type=int, default=None,
                   metavar='M',
                   help='initial world size when resuming a previously '
                        'shrunken job (default: --devices); with '
                        'capacity at N the first relaunch grows back')
    p.add_argument('--min-devices', type=int, default=1, metavar='M',
                   help='never shrink below this world size')
    p.add_argument('--slices', type=int, default=1, metavar='S',
                   help='multi-slice job: the child trains an '
                        'S-slice world (KFAC_NUM_SLICES is exported so '
                        '--num-slices follows). With --failover-grace, '
                        'all-ranks-of-one-slice-stale classifies as a '
                        'slice failure: fail over to the survivor '
                        'slices and relaunch with S-1')
    p.add_argument('--capacity-file', default=None, metavar='PATH',
                   help='file holding the currently-available device '
                        'count (the resource manager\'s live view); '
                        'polled — a drop below the running world '
                        'drains and relaunches shrunken '
                        '(supervisor_failover), a recovery grows back '
                        '(supervisor_growback)')
    p.add_argument('--keep-faults', action='store_true',
                   help='re-inject KFAC_CHAOS on every relaunch '
                        '(default: faults fire on the first launch '
                        'only, like the chaos harness)')
    if argv is None:
        argv = sys.argv[1:]
    cmd: list[str] = []
    if '--' in argv:
        split = argv.index('--')
        argv, cmd = argv[:split], argv[split + 1:]
    args = p.parse_args(argv)
    if not cmd:
        p.error('no command given (append: -- python -m ...)')
    sup = Supervisor(
        cmd, workdir=args.workdir, instance=args.instance,
        heartbeat_dir=args.heartbeat_dir,
        events_path=args.events, metrics_path=args.metrics,
        devices=args.devices, start_devices=args.start_devices,
        min_devices=args.min_devices, slices=args.slices,
        capacity_file=args.capacity_file,
        hang_timeout=args.hang_timeout,
        startup_grace=args.startup_grace,
        failover_grace=args.failover_grace,
        straggler_skew_ms=args.straggler_skew_ms,
        max_restarts=args.max_restarts,
        crash_loop_after=args.crash_loop_after,
        backoff=RestartBackoff(base=args.backoff,
                               cap=args.backoff_cap,
                               jitter=args.backoff_jitter),
        poll_secs=args.poll, drain_grace=args.drain_grace,
        term_grace=args.term_grace, keep_faults=args.keep_faults)
    return sup.run()


if __name__ == '__main__':
    sys.exit(main())
